"""The port's CUDA kernels (bulletproofs_tpu_torch/ops/ec_kernels.py) held
against the JAX package's TPU kernels they replace.

On the CPU the wrappers run their plain PyTorch versions; those are compared
with the Pallas kernels run in interpret mode (BP_PALLAS_INTERPRET=1, as
tests/test_pallas_chunk.py and tests/test_pallas_mixed.py run them) and, for
`ec_add_pallas`, which has no interpret mode, with the XLA `ec_add` of the
same math.  Inputs are made with numpy from a seed and given to both
packages.  Every comparison is exact limb equality: all versions return
canonical Montgomery limbs.  The kernels themselves are held against their
plain versions on the card by tests/test_torch_cuda.py.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofs_tpu.config import BLS381 as JBLS381, BN254 as JBN254
from bulletproofs_tpu.ops import ec_jax as ej
from bulletproofs_tpu.ops.ec_host import G1 as JG1

from bulletproofs_tpu_torch.config import BLS381, BN254
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import ec_kernels as ek
from bulletproofs_tpu_torch.ops.ec_host import G1

# One torch thread: the suite runs several test processes at once, and
# each process's own thread pool would oversubscribe the cores.
torch.set_num_threads(1)

CURVES = {"bls381": (BLS381, JBLS381), "bn254": (BN254, JBN254)}


def _jax_points(jcv, seed, m):
    """m random points of the JAX package as a (3, L, m) numpy array, and
    the same points affine (Z == 1)."""
    jctx = ej.CurveCtx(jcv)
    rnd = random.Random(seed)
    pts = [JG1.random(rnd, jcv) for _ in range(m)]
    proj = np.asarray(ej.to_device_points(pts, jctx))
    aff, is_aff = ej.to_device_points_affine(pts, jctx)
    assert is_aff
    return proj, np.asarray(aff)


def _round_inputs(jcv, seed, S, R_c, width):
    """Accumulators (half identity, half random), rows gathered from a
    16-point table (affine (X, Y) rows for width 2, projective for 3), a
    ~70% occupancy mask, and a forced doubling in slot 0."""
    L = jcv.fp.n_limbs
    rs = np.random.default_rng(seed)
    proj, aff = _jax_points(jcv, seed, 16)
    table = aff[:2] if width == 2 else proj
    rows_all = np.transpose(table, (2, 0, 1)).reshape(16, width * L)
    ident = np.asarray(ej.CurveCtx(jcv).identity)
    acc = np.concatenate(
        [np.broadcast_to(ident, (3, L, S // 2)),
         proj[:, :, rs.integers(0, 16, S - S // 2)]], axis=2)
    pid = rs.integers(0, 16, (R_c, S))
    pid[1, 0] = pid[0, 0]
    found = (rs.random((R_c, S)) < 0.7).astype(np.int32)
    found[0, 0] = found[1, 0] = 1
    return (np.ascontiguousarray(acc), rows_all[pid.reshape(-1)], found)


@pytest.mark.parametrize("width", [2, 3], ids=["mixed", "proj"])
def test_bucket_rounds_plain_match_pallas_interpret(width, monkeypatch):
    monkeypatch.setenv("BP_PALLAS_INTERPRET", "1")
    from bulletproofs_tpu.ops.ec_pallas import (
        bucket_rounds_chunk_pallas, bucket_rounds_chunk_pallas_mixed)

    S, R_c = 512, 4
    jctx = ej.CurveCtx(JBLS381)
    acc, rows, found = _round_inputs(JBLS381, 11 + width, S, R_c, width)
    jax_kernel = (bucket_rounds_chunk_pallas_mixed if width == 2
                  else bucket_rounds_chunk_pallas)
    want = np.asarray(jax_kernel(jnp.asarray(acc), jnp.asarray(rows),
                                 jnp.asarray(found), jctx))

    ctx = E.CurveCtx(BLS381)
    port = ek.bucket_rounds_mixed if width == 2 else ek.bucket_rounds_proj
    got = port(E.from_jax_points(acc, "cpu"),
               torch.as_tensor(rows.astype(np.int64)),
               torch.as_tensor(found), ctx)
    np.testing.assert_array_equal(E.to_jax_points(got), want)


def test_mixed_rounds_equal_general_rounds_as_group_elements():
    """The mixed add (Z2 == 1 rows) and the general add of the same affine
    rows give different projective representatives of the same points."""
    S, R_c = 64, 3
    acc, rows_xy, found = _round_inputs(JBN254, 5, S, R_c, 2)
    L = JBN254.fp.n_limbs
    ctx = E.CurveCtx(BN254)
    one = np.asarray(ctx.fp.one_m).reshape(1, L)
    rows_xyz = np.concatenate(
        [rows_xy, np.broadcast_to(one, (R_c * S, L))], axis=1)
    t = lambda a: torch.as_tensor(np.asarray(a).astype(np.int64))
    mixed = ek.bucket_rounds_mixed(t(acc), t(rows_xy), t(found), ctx)
    general = ek.bucket_rounds_proj(t(acc), t(rows_xyz), t(found), ctx)
    assert E.from_device_points(mixed, ctx) == \
        E.from_device_points(general, ctx)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_ec_add_plain_matches_xla(curve):
    """`ec_add_pallas` cannot run off the TPU; its math is `ec_jax.ec_add`.
    Ragged n, identity operands and P == Q included."""
    cv, jcv = CURVES[curve]
    n = 37
    proj, _ = _jax_points(jcv, 21, 8)
    rs = np.random.default_rng(3)
    P = proj[:, :, rs.integers(0, 8, n)]
    Q = proj[:, :, rs.integers(0, 8, n)]
    ident = np.asarray(ej.CurveCtx(jcv).identity)[:, :, 0]
    P[:, :, 0] = ident
    Q[:, :, 1] = ident
    P[:, :, 2] = Q[:, :, 2] = ident
    Q[:, :, 3:n:5] = P[:, :, 3:n:5]
    want = np.asarray(ej.ec_add(jnp.asarray(P), jnp.asarray(Q),
                                ej.CurveCtx(jcv)))
    ctx = E.CurveCtx(cv)
    got = ek.ec_add(E.from_jax_points(P, "cpu"), E.from_jax_points(Q, "cpu"),
                    ctx)
    np.testing.assert_array_equal(E.to_jax_points(got), want)


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    ctx = E.CurveCtx(BN254)
    ek.reset_launches()
    pts = E.to_device_points([G1.random(random.Random(1), BN254)], ctx,
                             "cpu")
    out = ek.ec_add(pts, pts, ctx)
    assert torch.equal(out, E.ec_add(pts, pts, ctx))
    assert ek.launches == {k: 0 for k in ek.launches}


def test_wrappers_reject_mismatched_shapes():
    ctx = E.CurveCtx(BLS381)
    L = ctx.fp.L
    buckets = torch.zeros((3, L, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        ek.bucket_rounds_mixed(buckets, torch.zeros((16, 3 * L),
                                                    dtype=torch.int64),
                               torch.zeros((2, 8), dtype=torch.int32), ctx)
    with pytest.raises(ValueError):
        ek.ec_add(buckets, buckets[:, :, :4], ctx)


@pytest.mark.parametrize("kernel", ["mixed", "proj", "ec_add", "round",
                                    "round_mxu"])
def test_packed_launches_refuse_cpu_tensors(kernel):
    """The `*32` functions only launch: given CPU tensors they raise and
    count nothing, with no plain version to fall back to."""
    ctx = E.CurveCtx(BLS381)
    L = ctx.fp.L
    width = 2 if kernel == "mixed" else 3
    acc32, rows32, found32 = ek.pack_rounds(
        torch.zeros((3, L, 8), dtype=torch.int64),
        torch.zeros((16, width * L), dtype=torch.int64),
        torch.ones((2, 8), dtype=torch.int32))
    assert acc32.shape == (3, L // 2, 8)
    assert rows32.shape == (16, width * L // 2)
    ek.reset_launches()
    with pytest.raises(ValueError):
        if kernel == "ec_add":
            ek.ec_add32(acc32, acc32, ctx)
        elif kernel == "round":
            ek.bucket_round_add32(acc32, rows32, found32[0], ctx)
        elif kernel == "round_mxu":
            ek.bucket_round_add_mxu32(acc32, rows32, found32[0], ctx)
        elif kernel == "mixed":
            ek.bucket_rounds_mixed32(acc32, rows32, found32, ctx)
        else:
            ek.bucket_rounds_proj32(acc32, rows32, found32, ctx)
    assert ek.launches == {k: 0 for k in ek.launches}


# ---------------------------------------------------------------------------
# Kernel 5: the int8-Toeplitz REDC (`bucket_round_add_pallas_mxu`).  Its
# Pallas body is not run in interpret mode here: the plain Pallas round
# kernel alone compiles for minutes on the CPU.  The product is held
# against `field_jax.mont_mul_mxu` (XLA), the round against kernel 4's
# plain version.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mxu_tables_match_field_jax(curve):
    from bulletproofs_tpu.ops import field_jax as fj
    from bulletproofs_tpu_torch.ops import field as F
    cv, jcv = CURVES[curve]
    got = F.mxu_tables(F.FieldCtx(cv.fp))
    want = fj._mxu_tables(fj.FieldCtx(jcv.fp))
    for (Ts, const), (jTs, jconst) in zip(got, want):
        assert Ts.dtype == np.int8 and const.dtype == np.int32
        np.testing.assert_array_equal(Ts, jTs)
        np.testing.assert_array_equal(const, jconst)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mont_mul_mxu_matches_field_jax_and_cios(curve):
    """Seeded operands with 0, 1 and p - 1 among them."""
    from bulletproofs_tpu.ops import field_jax as fj
    from bulletproofs_tpu_torch.ops import field as F
    cv, jcv = CURVES[curve]
    p = cv.p
    rs = np.random.default_rng(17)
    vals = [0, 1, p - 1, p - 2] + [
        int.from_bytes(rs.bytes(cv.modbytes), "big") % p for _ in range(28)]
    ctx = F.FieldCtx(cv.fp)
    A = F.ints_to_limbs(vals, ctx.L)
    B = F.ints_to_limbs(vals[::-1], ctx.L)
    got = F.mont_mul_mxu(torch.as_tensor(A), torch.as_tensor(B), ctx)
    assert torch.equal(got, F.mont_mul(torch.as_tensor(A),
                                       torch.as_tensor(B), ctx))
    want = fj.mont_mul_mxu(jnp.asarray(A.astype(np.uint32)),
                           jnp.asarray(B.astype(np.uint32)),
                           fj.FieldCtx(jcv.fp))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def test_bucket_round_add_mxu_plain_matches_kernel4_plain():
    """S = 512 slots: half the accumulators at the identity, ~70% occupied,
    one slot doubling; the kernel-5 wrapper on the CPU runs its plain
    version and counts no launch."""
    S = 512
    acc, rows, found = _round_inputs(JBLS381, 23, S, 2, 3)
    rows = rows[:S]
    L = JBLS381.fp.n_limbs
    acc[:, :, -1] = rows[-1].reshape(3, L)             # P + P
    found[0, -1] = 1
    ctx = E.CurveCtx(BLS381)
    args = (E.from_jax_points(acc, "cpu"),
            torch.as_tensor(rows.astype(np.int64)),
            torch.as_tensor(found[0]), ctx)
    ek.reset_launches()
    got = ek.bucket_round_add_mxu(*args)
    assert torch.equal(got, ek.bucket_round_add_mxu_plain(*args))
    assert torch.equal(got, ek.bucket_round_add_plain(*args))
    assert ek.launches == {k: 0 for k in ek.launches}


def test_mxu_table_words_layout():
    """The packed words the CUDA kernel reads: entry 4w + j of a table row
    in byte j of word w, then the row constants and the modulus."""
    ctx = E.CurveCtx(BN254)
    nl = ctx.fp.L // 2
    from bulletproofs_tpu_torch.ops import field as F
    (tm, cm), (tn, cn) = F.mxu_tables(ctx.fp)
    w = ek._mxu_words(ctx)
    assert w.dtype == np.uint32 and w.shape == (12 * nl * nl + 13 * nl,)
    k = 4 * nl * nl
    np.testing.assert_array_equal(w[:k].view(np.int8).reshape(tm.shape), tm)
    np.testing.assert_array_equal(
        w[k:3 * k].view(np.int8).reshape(tn.shape), tn)
    np.testing.assert_array_equal(w[3 * k:3 * k + 4 * nl].view(np.int32),
                                  cm[:, 0])
    np.testing.assert_array_equal(
        w[3 * k + 4 * nl:3 * k + 12 * nl].view(np.int32), cn[:, 0])
    assert sum(int(x) << (32 * i) for i, x in
               enumerate(w[-nl:])) == BN254.p


def test_chip_smoke_mxu_race_rehearses_on_cpu(capsys):
    """chip_smoke.py's race of kernels 5 and 4 over the bucket rounds of
    the n = 16 IPA's first MSM, on the CPU (plain versions, no launch):
    the buckets agree at the end."""
    import importlib
    import json
    chip_smoke = importlib.import_module("chip_smoke")
    ek.reset_launches()
    chip_smoke.phase_mxu_race("cpu", 16, 5)
    assert ek.launches == {k: 0 for k in ek.launches}
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "mxu_race" and line["buckets_identical"]
    assert set(line["us_per_round"]) == {"bucket_round_add",
                                         "bucket_round_add_mxu"}
