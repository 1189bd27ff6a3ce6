"""The port's device Pippenger MSM (bulletproofs_tpu_torch/ops/msm.py)
against the JAX package's (bulletproofs_tpu/ops/msm.py) piece by piece, and
end to end against exact-int host sums; the port's import isolation; and a
CPU rehearsal of chip_smoke.py's phases.

Inputs are made from a seed and passed as numpy arrays to both packages.
The JAX side runs its XLA bucket path on the CPU (the Pallas kernels are
covered in tests/test_torch_kernels.py).
"""

import importlib
import json
import random
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofs_tpu import config as jconfig
from bulletproofs_tpu.ops import ec_jax as ej
from bulletproofs_tpu.ops import field_jax as fj
from bulletproofs_tpu.ops import msm as jmsm
from bulletproofs_tpu.ops.ec_host import G1 as JG1

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import ec_kernels as ek
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops import msm as M

# One torch thread: the suite runs several test processes at once, and
# each process's own thread pool would oversubscribe the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("c", [4, 6, 8])
@pytest.mark.parametrize("curve", ["bls381", "bn254"])
def test_window_plan_and_round_guess_match(curve, c):
    ctx, jctx = E.CurveCtx(config.CURVES[curve]), \
        ej.CurveCtx(jconfig.CURVES[curve])
    for n_sets in (1, 2):
        assert all(np.array_equal(a, b) for a, b in zip(
            M.window_plan(ctx, c, n_sets), jmsm.window_plan(jctx, c, n_sets)))
        got = M.window_plan(ctx, c, n_sets, dup=True)
        want = jmsm.window_plan(jctx, c, n_sets, dup=True)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert got[2] == want[2]
    for n in (256, 1024, 1 << 16):
        assert M.occupancy_guess(n, ctx, c) == \
            jmsm.occupancy_guess(n, jctx, c, dup=True)
    assert [M.pick_window(n) for n in (32, 64, 600, 5000)] == \
        [jmsm.pick_window(n) for n in (32, 64, 600, 5000)]


def _msm_input(n, seed, cv, n_base=16):
    """n points (a repeated random base) and n uniform scalars with the
    adversarial values 0, 1 and r - 1 among them."""
    rnd = random.Random(seed)
    base = [bt.G1.random(rnd, cv) for _ in range(n_base)]
    pts = [base[i % n_base] for i in range(n)]
    ks = [rnd.randrange(cv.r) for _ in range(n)]
    ks[0], ks[1], ks[2] = 0, 1, cv.r - 1
    return pts, ks


def _jax_arrays(pts, ks, jcv):
    """The same input as JAX package arrays (numpy)."""
    jctx = ej.CurveCtx(jcv)
    jpts = [JG1(p.X, p.Y, p.Z, jcv) for p in pts]
    return (np.asarray(ej.to_device_points(jpts, jctx)),
            np.asarray(ej.to_device_scalars(ks, jctx)), jctx)


@pytest.mark.parametrize("n", [256, 1024])
def test_digits_slot_grid_and_occupancy_match(n):
    cv = config.BLS381
    ctx = E.CurveCtx(cv)
    c = M.pick_window(n)
    B, W = 1 << c, -(-cv.fr.n_bits // c)
    _, ks = _msm_input(n, n, cv)
    s = F.ints_to_limbs(ks, cv.fr.n_limbs)
    digits = F.get_digits(torch.as_tensor(s), c, W)
    np.testing.assert_array_equal(
        digits.numpy(),
        np.asarray(fj.get_digits(jnp.asarray(s, jnp.uint32), c, W)))
    R = M.occupancy_guess(n, ctx, c)
    for dup in (False, True):
        plan = M.window_plan(ctx, c, dup=dup)
        d = M._spread_dup_rows(digits, plan[2]) if dup else digits
        grid, found, occ = M._slot_grid(d, B, R, plan[0], plan[1])
        jgrid, jfound, jocc = jax.jit(
            partial(jmsm._slot_grid, B=B, R=R, ranges=plan[0],
                    splits=plan[1]))(jnp.asarray(d.numpy(), jnp.int32))
        np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
        np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
        assert occ == int(jocc) <= R


@pytest.mark.parametrize("curve,n,pre_reduce", [
    ("bls381", 256, 0), ("bls381", 256, 1), ("bls381", 1024, 0)])
def test_bucket_arrays_match_jax(curve, n, pre_reduce):
    """Bucket arrays after the rounds, the sub-bucket fold and the
    duplicate-row fold (packed words, unpacked here): projective rows,
    chunked or one round per launch (`ec_kernel="round"`), give the JAX
    package's limbs exactly; the mixed-add path gives the same points."""
    cv, jcv = config.CURVES[curve], jconfig.CURVES[curve]
    ctx = E.CurveCtx(cv)
    c = M.pick_window(n)
    W = -(-cv.fr.n_bits // c)
    pts, ks = _msm_input(n, 3 * n + pre_reduce, cv)
    P, s, jctx = _jax_arrays(pts, ks, jcv)
    rounds = M.occupancy_guess(n, ctx, c)

    @jax.jit
    def jax_buckets(P, s):
        plan = jmsm.window_plan(jctx, c, dup=True)
        return jmsm.bucket_accumulate(P, fj.get_digits(s, c, W), jctx, c,
                                      rounds, plan=plan,
                                      pre_reduce=pre_reduce)

    want, jocc = jax_buckets(P, s)
    Pt = E.from_jax_points(P, "cpu")
    digits = F.get_digits(E.from_jax_scalars(s, "cpu"), c, W)
    plan = M.window_plan(ctx, c, dup=True)
    got, occ = M.bucket_accumulate(Pt, digits, ctx, c, rounds, plan=plan,
                                   pre_reduce=pre_reduce)
    assert occ == int(jocc) and got.dtype == torch.int32
    got = F.unpack32(got, 1)
    np.testing.assert_array_equal(E.to_jax_points(got), np.asarray(want))
    per_round, occ_r = M.bucket_accumulate(Pt, digits, ctx, c, rounds,
                                           plan=plan, pre_reduce=pre_reduce,
                                           ec_kernel="round")
    assert occ_r == occ
    np.testing.assert_array_equal(
        E.to_jax_points(F.unpack32(per_round, 1)), np.asarray(want))
    if pre_reduce == 0 and n == 256:
        Pa, affine = E.to_device_points_affine(pts, ctx, "cpu")
        assert affine
        mixed, _ = M.bucket_accumulate(Pa, digits, ctx, c, rounds,
                                       plan=plan, affine=True)
        # an affine table still takes projective rows one round a launch
        round_affine, _ = M.bucket_accumulate(Pa, digits, ctx, c, rounds,
                                              plan=plan, affine=True,
                                              ec_kernel="round")
        flat = lambda b: E.from_device_points(
            F.unpack32(b, 1).reshape(3, ctx.fp.L, -1), ctx)
        assert flat(mixed) == flat(F.pack32(got, 1)) == flat(round_affine)


def test_overflowing_schedule_adds_nothing():
    cv = config.BN254
    ctx = E.CurveCtx(cv)
    pts, _ = _msm_input(64, 4, cv)
    P = E.to_device_points(pts, ctx, "cpu")
    digits = torch.ones((2, 64), dtype=torch.int64)     # 64 in one bucket
    buckets, occ = M.bucket_accumulate(P, digits, ctx, 2, 16)
    assert buckets is None and occ == 64
    assert M._escalate(occ, 16, 0) == (16, 2)
    assert M._escalate(20, 16, 0) == (32, 0)


def test_mixed_table_is_checked_against_the_points():
    """The bucket kernels read table rows by point id without bounds, so
    `bucket_accumulate` refuses a packed table that is not (n, 2NL) int32
    on the points' device where the pass runs kernel 1, or (n, 3NL) where
    it runs kernel 2 or 4; `point_table` packs the one the pass reads."""
    cv = config.BN254
    ctx = E.CurveCtx(cv)
    L = ctx.fp.L
    pts, ks = _msm_input(64, 4, cv)
    P, affine = E.to_device_points_affine(pts, ctx, "cpu")
    digits = F.get_digits(E.to_device_scalars(ks, ctx, "cpu"), 4,
                          M._n_windows(ctx, 4))
    table = M.point_table(P, ctx, affine)
    assert table.shape == (64, L) and table.dtype == torch.int32
    proj = M.point_table(P, ctx, affine, ec_kernel="round")
    assert torch.equal(proj, ek.proj_rows32(P))
    assert torch.equal(proj, ek.proj_rows32(F.pack32(P, 1)))
    assert proj.shape == (64, 3 * L // 2) and proj.dtype == torch.int32
    assert torch.equal(F.unpack32(proj[5], 0).reshape(3, L), P[:, :, 5])
    assert torch.equal(M.point_table(P, ctx, False), proj)
    assert not M.uses_mixed(ctx, affine, pre_reduce=1)
    for kernel, good, bads in (
            ("chunk", table, (table[:-1], table.long(), table[:, :-1],
                              proj)),
            ("round", proj, (proj[:-1], proj[:, :-1], table))):
        want, _ = M.bucket_accumulate(P, digits, ctx, 4, 64, affine=True,
                                      ec_kernel=kernel)
        got, _ = M.bucket_accumulate(P, digits, ctx, 4, 64, affine=True,
                                     ec_kernel=kernel, table32=good)
        assert torch.equal(got, want)
        for bad in bads:
            with pytest.raises(ValueError, match="table32"):
                M.bucket_accumulate(P, digits, ctx, 4, 64, affine=True,
                                    ec_kernel=kernel, table32=bad)


def _pre_reduce_rows_int64(points, sorted_d, rank, perm, ctx, pre_reduce):
    """The pre-reduction as it ran on int64 limbs before it ran on packed
    words (the JAX package's `_pre_reduce_rows`): -> (W*n, 3L) rows."""
    W, n = sorted_d.shape
    L = points.shape[1]
    P = points[:, :, perm]
    ident = ctx.identity_like((W, 1), points.device)
    for p in range(pre_reduce):
        shift = 1 << p
        d_next = torch.cat([sorted_d[:, shift:],
                            torch.full_like(sorted_d[:, :shift], -1)], dim=1)
        P_next = torch.cat([P[..., shift:], ident.expand(3, L, W, shift)],
                           dim=-1)
        mergeable = ((rank & ((2 << p) - 1)) == 0) & \
            (d_next == sorted_d) & (sorted_d != 0)
        P = torch.where(mergeable[None, None], E.ec_add(P, P_next, ctx), P)
    return P.permute(2, 3, 0, 1).reshape(W * n, 3 * L)


@pytest.mark.parametrize("curve", ["bls381", "bn254"])
def test_pre_reduced_table_is_the_packed_int64_table(curve):
    """`_pre_reduce_rows` runs its passes on packed words and returns
    kernel 2's packed (W*n, 3NL) table: `pack32` of the int64 limb rows
    the passes gave before, word for word (bit-vector scalars, n = 64,
    c = 4, 3 passes)."""
    cv = config.CURVES[curve]
    ctx = E.CurveCtx(cv)
    pts, _ = _msm_input(64, 8, cv)
    P = E.to_device_points(pts, ctx, "cpu")
    rnd = random.Random(9)
    ks = [rnd.randrange(2) for _ in range(64)]
    digits = F.get_digits(E.to_device_scalars(ks, ctx, "cpu"), 4,
                          M._n_windows(ctx, 4))
    sorted_d, rank, perm = M._sorted_ranks(digits)
    got = M._pre_reduce_rows(P, sorted_d, rank, perm, ctx, 3)
    want = _pre_reduce_rows_int64(P, sorted_d, rank, perm, ctx, 3)
    assert got.dtype == torch.int32
    assert got.shape == (digits.numel(), 3 * ctx.fp.L // 2)
    assert torch.equal(got, F.pack32(want, 1))


def _pre_reduce_digits(kind, W, n, gen, ctx, seed):
    """Digits (W, n) of one kind: "bits" (window 0 from bit scalars, every
    other window all zeros), "runs" (window 0 all zeros, window 1 short
    runs of {0, 1, 2, 3} that cross 2^p boundaries, window 2 a long run of
    5 to the row's last entry), "uniform" (c = 4 digits of uniform
    scalars)."""
    if kind == "bits":
        rnd = random.Random(seed)
        ks = [rnd.randrange(2) for _ in range(n)]
        d = F.get_digits(E.to_device_scalars(ks, ctx, "cpu"), 4,
                         M._n_windows(ctx, 4))
        return d[:W]
    if kind == "uniform":
        _, ks = _msm_input(n, seed, ctx.cv)
        d = F.get_digits(E.to_device_scalars(ks, ctx, "cpu"), 4,
                         M._n_windows(ctx, 4))
        return d[:W]
    d = torch.randint(0, 4, (W, n), generator=gen)
    d[0] = 0
    d[2] = torch.where(torch.rand(n, generator=gen) < 0.8, 5, 0)
    return d


def _jax_pre_reduced_table(points, sorted_d, rank, perm, jctx, passes):
    """The JAX package's pass loop (`bulletproofs_tpu/ops/msm.py:325-357`,
    in `bucket_accumulate`) on its `ec_add`, from the same sorted digits,
    ranks and permutation: -> its (W*n, 3L) rows, numpy."""
    @jax.jit
    def run(points, sorted_d, rank, perm):
        W, n = sorted_d.shape
        L = points.shape[1]
        rows = jnp.transpose(points, (2, 0, 1)).reshape(n, 3 * L)
        P = jnp.transpose(rows[perm.reshape(-1)].reshape(W, n, 3, L),
                          (2, 3, 0, 1))
        id_col = jctx.identity.reshape(3, L, 1, 1)
        for p in range(passes):
            shift = 1 << p
            d_next = jnp.concatenate(
                [sorted_d[:, shift:], jnp.full((W, shift), -1, jnp.int32)],
                axis=1)
            P_next = jnp.concatenate(
                [P[..., shift:], jnp.broadcast_to(id_col, (3, L, W, shift))],
                axis=-1)
            mergeable = ((rank & ((2 << p) - 1)) == 0) & \
                (d_next == sorted_d) & (sorted_d != 0)
            P = jnp.where(mergeable[None, None], ej.ec_add(P, P_next, jctx),
                          P)
        return jnp.transpose(P, (2, 3, 0, 1)).reshape(W * n, 3 * L)
    return np.asarray(run(jnp.asarray(E.to_jax_points(points)),
                          *(jnp.asarray(x.numpy(), jnp.int32)
                            for x in (sorted_d, rank, perm))))


@pytest.mark.parametrize("curve,kind,n,passes", [
    ("bls381", "bits", 64, 5), ("bls381", "runs", 45, 4),
    ("bn254", "runs", 45, 4), ("bn254", "uniform", 64, 2),
    ("ed25519", "bits", 45, 5), ("ed25519", "runs", 45, 4)])
def test_pre_reduce_form_is_the_pass_loop_and_jax(curve, kind, n, passes):
    """Kernel 3's pre-reduction form (`ec_pre_reduce`; its plain version
    adds only the merging pairs) and `_pre_reduce_rows`, which the MSM
    calls, give the whole (W*n, 3NL) table of the pass loop over every
    entry (`_pre_reduce_rows_int64`, packed) and of the JAX package's pass
    loop, word for word: bit scalars (one window of nonzero digits, the
    others all zeros), short runs across 2^p boundaries, a run to the
    row's last entry, an all-zero window, uniform c = 4 digits, odd n, on
    BLS12-381, BN254 and ed25519 (RCB16 algorithm 1).  Every pass merges
    some pairs, each merge one entry of a nonzero digit into another."""
    cv, jcv = config.CURVES[curve], jconfig.CURVES[curve]
    ctx = E.CurveCtx(cv)
    gen = torch.Generator().manual_seed(n + passes)
    pts, _ = _msm_input(n, 40 + n, cv)
    Pj, _, jctx = _jax_arrays(pts, [0] * n, jcv)
    P = E.from_jax_points(Pj, "cpu")
    digits = _pre_reduce_digits(kind, 3, n, gen, ctx, 50 + n)
    sorted_d, rank, perm = M._sorted_ranks(digits)
    rows32 = ek.proj_rows32(P)
    got = ek.ec_pre_reduce(rows32, perm, sorted_d, rank, passes, ctx)
    assert got.dtype == torch.int32 and got.shape == (3 * n, 3 * ctx.fp.L // 2)
    assert torch.equal(got, M._pre_reduce_rows(P, sorted_d, rank, perm, ctx,
                                               passes))
    old = _pre_reduce_rows_int64(P, sorted_d, rank, perm, ctx, passes)
    assert torch.equal(got, F.pack32(old, 1))
    want = _jax_pre_reduced_table(P, sorted_d, rank, perm, jctx, passes)
    np.testing.assert_array_equal(
        F.unpack32(got, 1).numpy().astype(np.uint32), want)
    merged = [int(ek._merging(sorted_d, rank, p).sum())
              for p in range(passes)]
    assert min(merged) > 0 and sum(merged) < int((digits != 0).sum())


def test_pre_reducing_bucket_pass_matches_jax():
    """A bit-vector bucket pass with 3 pre-reduction passes (n = 64,
    c = 4: every point in bucket 1 of window 0) gives the JAX package's
    pre-reducing `bucket_accumulate`'s buckets, limb for limb."""
    cv, jcv = config.BN254, jconfig.BN254
    ctx = E.CurveCtx(cv)
    n, c, pre = 64, 4, 3
    W = M._n_windows(ctx, c)
    rnd = random.Random(61)
    pts, _ = _msm_input(n, 62, cv)
    ks = [rnd.randrange(2) for _ in range(n)]
    P, s, jctx = _jax_arrays(pts, ks, jcv)
    rounds = M.occupancy_guess(n, ctx, c)
    plan = M.window_plan(ctx, c, dup=True)
    digits = F.get_digits(E.from_jax_scalars(s, "cpu"), c, W)
    got, occ = M.bucket_accumulate(E.from_jax_points(P, "cpu"), digits, ctx,
                                   c, rounds, plan=plan, pre_reduce=pre)
    want, jocc = jax.jit(lambda P, s: jmsm.bucket_accumulate(
        P, fj.get_digits(s, c, W), jctx, c, rounds,
        plan=jmsm.window_plan(jctx, c, dup=True), pre_reduce=pre))(P, s)
    assert got is not None and occ == int(jocc)
    np.testing.assert_array_equal(E.to_jax_points(F.unpack32(got, 1)),
                                  np.asarray(want))


def test_msm_hybrid_matches_host():
    """One uniform set (scalars 0, 1, r-1 included; mixed-add rounds) and
    then the same set beside a bit vector, which escalates to pre-reduction
    (projective rounds and the batched add)."""
    cv = config.BLS381
    ctx = E.CurveCtx(cv)
    n = 256
    pts, ks = _msm_input(n, 17, cv)
    rb = random.Random(18)
    bits = [rb.randrange(2) for _ in range(n)]
    P, affine = E.to_device_points_affine(pts, ctx, "cpu")
    assert affine
    one = E.to_device_scalars(ks, ctx, "cpu")[None]
    key = (n, 1, M.pick_window(n), cv.name, None)
    M._escalation_memo.pop(key, None)
    (got,) = M.msm_hybrid(P, one, ctx, affine=True)
    assert got.to_bytes() == bt.msm_host(pts, ks).to_bytes()
    assert M._escalation_memo[key][1] == 0

    two = torch.stack([one[0], E.to_device_scalars(bits, ctx, "cpu")])
    key2 = (n, 2, M.pick_window(n), cv.name, None)
    M._escalation_memo.pop(key2, None)
    got2 = M.msm_hybrid(P, two, ctx, affine=True)
    assert [g.to_bytes() for g in got2] == \
        [bt.msm_host(pts, ks).to_bytes(), bt.msm_host(pts, bits).to_bytes()]
    assert M._escalation_memo[key2][1] > 0


def test_msm_entry_matches_host():
    """`bulletproofs_tpu_torch.msm` (device combine and Horner) with
    projective input points, on BN254 to keep the CPU run short."""
    cv = config.BN254
    pts, ks = _msm_input(64, 23, cv)
    pts = [p + p for p in pts]                     # Z != 1
    assert bt.msm(pts, ks, device="cpu") == bt.msm_host(pts, ks)
    with pytest.raises(ValueError):
        bt.msm(pts, ks[:3], device="cpu")


def test_port_imports_no_jax():
    """Importing the port, every module under it and chip_smoke.py loads
    neither jax nor anything of bulletproofs_tpu."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import bulletproofs_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'bulletproofs_tpu' or "
        "m.startswith('bulletproofs_tpu.'))\n"
        "print(json.dumps({'mods': mods, 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"bulletproofs_tpu_torch.ops.msm",
            "bulletproofs_tpu_torch.ops.poseidon_device",
            "bulletproofs_tpu_torch.utils.hash_db",
            "bulletproofs_tpu_torch.models.poseidon_hash",
            "bulletproofs_tpu_torch.models.sparse_merkle_tree_4_ary",
            "bulletproofs_tpu_torch.models.sparse_merkle_tree_8_ary",
            "bulletproofs_tpu_torch.ops.torch_backend",
            "bulletproofs_tpu_torch.backend",
            "bulletproofs_tpu_torch.models.randomizer",
            "bulletproofs_tpu_torch.models.hamming_distance",
            "bulletproofs_tpu_torch.parallel",
            "bulletproofs_tpu_torch.parallel.sharded_msm",
            "bulletproofs_tpu_torch.parallel.sharded_prover",
            "bulletproofs_tpu_torch.utils.metrics",
            "bulletproofs_tpu_torch.utils.roofline"} \
        <= set(res["mods"])
    assert res["bad"] == []


def test_chip_smoke_phases_rehearse_on_cpu(capsys):
    """chip_smoke.py's phases at n = 256 on the CPU, where the wrappers run
    their plain versions: the control flow, shapes and host checks."""
    chip_smoke = importlib.import_module("chip_smoke")

    records, check_msms = chip_smoke.phase_kernels("cpu", 256, 5, reps=1,
                                                   r1cs_msm_n=64)
    assert set(records) == set(chip_smoke.REPLACES)
    assert all(r["max_abs_err"] == 0 for r in records.values())
    # phase 2 holds the pre-reduction form at the bit-vector MSM's shape
    pre = [f for f in records["ec_add"]["forms"]
           if f["shape"]["form"] == "pre_reduce"]
    assert len(pre) == 1 and pre[0]["max_abs_err"] == 0
    assert pre[0]["shape"]["passes"] > 0 and min(pre[0]["shape"]["merges"])
    # after a path: kernel 2 at a pre-reduced 3-set MSM's shape, kernel 1
    # at a 1-set one's, with their combine forms and the pre-reduction
    forms = len(records["ec_add"]["forms"])
    check_msms("smt", [(24, 3, 2, 4, 1), (24, 1, 2, 4, 0)])
    for name, sets in (("bucket_rounds_proj", 3), ("bucket_rounds_mixed", 1)):
        sub = records[name]["other_shapes"][-1]
        assert sub["shape"]["path"] == "smt" and sub["max_abs_err"] == 0
        assert sub["shape"]["sets"] == sets
    assert len(records["ec_add"]["forms"]) == forms + 2 * 4 + 1
    assert records["ec_add"]["forms"][forms + 4]["shape"]["form"] == \
        "pre_reduce"
    # the batch verifiers' `msm_device`: a projective table without
    # pre-reduction (kernel 2 from n rows), the Horner on the card
    check_msms("batch", [(24, 1, 2, 4, 0, False, True)])
    sub = records["bucket_rounds_proj"]["other_shapes"][-1]
    assert sub["shape"]["path"] == "batch" and sub["max_abs_err"] == 0
    assert (sub["shape"]["table_rows"], sub["shape"]["affine"]) == (24, False)
    assert records["ec_add"]["forms"][-1]["shape"]["form"] == "horner"
    # its folds, sums and totals have the smt path's 1-set shapes, checked
    # there: each form shape is checked once a run
    assert len(records["ec_add"]["forms"]) == forms + 2 * 4 + 2
    # a sharded pass (no duplicate rows): kernel 1 at its slots, the split
    # fold, sums and totals of its plan, and no duplicate-row fold
    check_msms("sharded", [(24, 2, 2, 4, 0, True, False, False)])
    sub = records["bucket_rounds_mixed"]["other_shapes"][-1]
    assert sub["shape"]["path"] == "sharded" and sub["max_abs_err"] == 0
    assert sub["shape"]["dup"] is False
    new = [f["shape"]["form"] for f in records["ec_add"]["forms"]
           if f["shape"].get("path") == "sharded"]
    assert new == ["split_fold", "rowcol", "window_totals"]
    sub = records["ec_add"]["other_shapes"][-1]        # the butterfly's add
    assert sub["shape"] == {"path": "sharded", "n": 256 << 2,
                            "packed": True} and sub["max_abs_err"] == 0
    ek.reset_launches()
    chip_smoke.phase_msm("cpu", 256, 6, bits=False, reps=0)
    chip_smoke.phase_msm("cpu", 256, 7, bits=True, reps=0)
    assert ek.launches == {k: 0 for k in ek.launches}   # no card, no kernel
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    phases = {x["phase"]: x for x in lines}
    assert phases["msm_bitvector"]["pre_reduce"] > 0
    assert phases["msm_uniform"]["pre_reduce"] == 0


@pytest.mark.parametrize("curve", ["bls381", "bn254", "secp256k1",
                                   "ed25519"])
def test_combine_matches_jax(curve):
    """`bucket_rowcol`, `window_totals` and `combine_from_rowcol` (packed
    words, kernel 3's sequential forms, their plain versions on the CPU)
    equal the JAX package's (`bulletproofs_tpu/ops/msm.py:518-570`) limb
    for limb from the same bucket array, on every curve (ed25519: RCB16
    algorithm 1): W = 4 windows of c = 4, one bucket in 5 the identity,
    the Horner over 2 sets of 2 windows."""
    cv, jcv = config.CURVES[curve], jconfig.CURVES[curve]
    ctx, jctx = E.CurveCtx(cv), ej.CurveCtx(jcv)
    c, W, B = 4, 4, 16
    rnd = random.Random(71)
    base = [JG1.random(rnd, jcv) for _ in range(10)]
    pts = np.asarray(ej.to_device_points([p + p for p in base], jctx))
    pick = np.random.default_rng(71).integers(0, 10, W * B)
    buckets = pts[:, :, pick]
    buckets[:, :, ::5] = np.asarray(jctx.identity)[:, :, :1]
    buckets = np.ascontiguousarray(buckets.reshape(3, -1, W, B))

    @jax.jit
    def jax_combine(bk):
        rowsum, colsum = jmsm.bucket_rowcol(bk, jctx, c)
        return (rowsum, colsum, jmsm.window_totals(rowsum, colsum, jctx, c),
                jmsm.combine_from_rowcol(rowsum, colsum, jctx, c,
                                         wins_per_set=2))

    want = [np.asarray(x) for x in jax_combine(jnp.asarray(buckets))]
    bk32 = F.pack32(E.from_jax_points(buckets, "cpu"), 1)
    rowsum, colsum = M.bucket_rowcol(bk32, ctx, c)
    got = [rowsum, colsum, M.window_totals(rowsum, colsum, ctx, c),
           M.combine_from_rowcol(rowsum, colsum, ctx, c, wins_per_set=2)]
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(E.to_jax_points(F.unpack32(g, 1)), w)


@pytest.mark.parametrize("kind", ["uniform", "bits", "imbalanced"])
def test_max_occupancy_and_combine_buckets_match_jax(kind):
    """`_max_occupancy` equals the JAX package's, and a bucket pass at that
    many rounds under `window_plan(ctx, c)` needs no more; `combine_buckets`
    of its buckets equals the JAX package's limb for limb and the host
    MSM.  n = 64, c = 4: uniform scalars, bits (every point in bucket 1 of
    window 0, split over its sub-buckets), and all the non-zero scalars in
    the first eighth (the sharded MSM's imbalanced shard)."""
    cv, jcv = config.BLS381, jconfig.BLS381
    ctx = E.CurveCtx(cv)
    n, c = 64, 4
    pts, ks = _msm_input(n, 91, cv)
    rnd = random.Random(92)
    if kind == "bits":
        ks = [rnd.randrange(2) for _ in range(n)]
    elif kind == "imbalanced":
        ks = [k if i < n // 8 else 0 for i, k in enumerate(ks)]
    P, s, jctx = _jax_arrays(pts, ks, jcv)
    st = E.from_jax_scalars(s, "cpu")
    occ = M._max_occupancy(st, ctx, c)
    assert occ.ndim == 0
    assert int(occ) == int(jmsm._max_occupancy(jnp.asarray(s), jctx, c))
    W = -(-cv.fr.n_bits // c)
    buckets, got_occ = M.bucket_accumulate(
        E.from_jax_points(P, "cpu"), F.get_digits(st, c, W), ctx, c,
        int(occ), plan=M.window_plan(ctx, c))
    assert got_occ == int(occ)
    total = M.combine_buckets(buckets, ctx, c)
    assert total.dtype == torch.int32 and total.shape == (3, ctx.fp.L // 2,
                                                          1)
    want = jax.jit(partial(jmsm.combine_buckets, ctx=jctx, c=c))(
        jnp.asarray(E.to_jax_points(F.unpack32(buckets, 1))))
    np.testing.assert_array_equal(E.to_jax_points(F.unpack32(total, 1)),
                                  np.asarray(want))
    assert E.from_device_points(F.unpack32(total, 1), ctx)[0] == \
        bt.msm_host(pts, ks)


def test_msm_calls_kernel3_a_few_times(monkeypatch):
    """`msm_hybrid` at n = 256 on the CPU calls kernel 3's wrappers (the
    pre-reduction and the sequential forms) at most 10 times: the split
    fold, the row and column sums and the window totals; `msm_device`
    adds the Horner.  Counted by wrapping the wrappers, since `launches`
    counts card launches only."""
    calls = []
    for name in ("ec_pre_reduce", "ec_gather_sum", "ec_window_totals",
                 "ec_horner"):
        def counted(*a, _fn=getattr(M, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(M, name, counted)
    cv = config.BLS381
    ctx = E.CurveCtx(cv)
    n = 256
    pts, ks = _msm_input(n, 29, cv)
    P, affine = E.to_device_points_affine(pts, ctx, "cpu")
    s = E.to_device_scalars(ks, ctx, "cpu")
    # a bit-vector input of this shape may have left a pre-reduction plan
    M._escalation_memo.pop((n, 1, M.pick_window(n), cv.name, None), None)
    (got,) = M.msm_hybrid(P, s[None], ctx, affine=affine)
    assert got == bt.msm_host(pts, ks)
    assert calls == ["ec_gather_sum"] * 2 + ["ec_window_totals"]
    calls.clear()
    dev = M.msm_device(P, s, ctx, M.pick_window(n), affine=affine)
    assert E.from_device_points(dev, ctx)[0] == got
    assert calls == ["ec_gather_sum"] * 2 + ["ec_window_totals",
                                             "ec_horner"]
    assert len(calls) <= 10
