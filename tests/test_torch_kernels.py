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
from bulletproofs_tpu_torch.ops.field import pack32, unpack32

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


def _round_inputs(jcv, seed, S, R_c, width, with_table=False):
    """Accumulators (half identity, half random), rows gathered from a
    16-point table (affine (X, Y) rows for width 2, projective for 3), a
    ~70% occupancy mask, and a forced doubling in slot 0.  with_table:
    also the table's rows (16, width*L) and the point ids (R_c, S)."""
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
    out = (np.ascontiguousarray(acc), rows_all[pid.reshape(-1)], found)
    return out + (rows_all, pid) if with_table else out


def _table32(rows_all):
    """Limb rows (n, 2L) affine (X, Y) or (n, 3L) projective -> the packed
    table (n, 2NL) of kernel 1 or (n, 3NL) of kernels 2 and 4, int32 (L is
    even, so no word straddles two coordinates)."""
    return pack32(torch.as_tensor(rows_all.astype(np.int64)),
                  1).contiguous()


def _ids(pid):
    return torch.as_tensor(np.ascontiguousarray(pid).astype(np.int32))


@pytest.mark.parametrize("width", [2, 3], ids=["mixed", "proj"])
def test_bucket_rounds_plain_match_pallas_interpret(width, monkeypatch):
    """The Pallas kernel is fed the gathered rows table[pid]; the port's
    kernels 1 and 2 the packed accumulators, the packed table and the
    point ids (their slot grid)."""
    monkeypatch.setenv("BP_PALLAS_INTERPRET", "1")
    from bulletproofs_tpu.ops.ec_pallas import (
        bucket_rounds_chunk_pallas, bucket_rounds_chunk_pallas_mixed)

    S, R_c = 512, 4
    jctx = ej.CurveCtx(JBLS381)
    acc, rows, found, rows_all, pid = _round_inputs(
        JBLS381, 11 + width, S, R_c, width, with_table=True)
    jax_kernel = (bucket_rounds_chunk_pallas_mixed if width == 2
                  else bucket_rounds_chunk_pallas)
    want = np.asarray(jax_kernel(jnp.asarray(acc), jnp.asarray(rows),
                                 jnp.asarray(found), jctx))

    ctx = E.CurveCtx(BLS381)
    kernel = ek.bucket_rounds_mixed if width == 2 else ek.bucket_rounds_proj
    got32 = kernel(pack32(E.from_jax_points(acc, "cpu"), 1),
                   _table32(rows_all), _ids(pid), torch.as_tensor(found), ctx)
    assert got32.dtype == torch.int32
    np.testing.assert_array_equal(E.to_jax_points(unpack32(got32, 1)), want)


def test_mixed_rounds_equal_general_rounds_as_group_elements():
    """The mixed add (Z2 == 1 rows) and the general add of the same affine
    rows give different projective representatives of the same points."""
    S, R_c = 64, 3
    acc, _, found, rows_all, pid = _round_inputs(JBN254, 5, S, R_c, 2,
                                                 with_table=True)
    L = JBN254.fp.n_limbs
    ctx = E.CurveCtx(BN254)
    one = np.asarray(ctx.fp.one_m).reshape(1, L)
    rows_all_xyz = np.concatenate(
        [rows_all, np.broadcast_to(one, (16, L))], axis=1)
    acc32 = pack32(torch.as_tensor(acc.astype(np.int64)), 1)
    found_t = torch.as_tensor(found)
    mixed = ek.bucket_rounds_mixed(acc32, _table32(rows_all), _ids(pid),
                                   found_t, ctx)
    general = ek.bucket_rounds_proj(acc32, _table32(rows_all_xyz),
                                    _ids(pid), found_t, ctx)
    assert E.from_device_points(unpack32(mixed, 1), ctx) == \
        E.from_device_points(unpack32(general, 1), ctx)


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
    acc32 = pack32(buckets, 1)
    table32 = torch.zeros((16, L), dtype=torch.int32)
    ids = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):                   # limb accumulators
        ek.bucket_rounds_mixed(buckets, table32, ids, ids, ctx)
    with pytest.raises(ValueError):                   # ids of another S
        ek.bucket_rounds_mixed(acc32, table32, ids[:, :4], ids, ctx)
    with pytest.raises(ValueError):                   # int64 ids
        ek.bucket_rounds_mixed(acc32, table32, ids.long(), ids, ctx)
    with pytest.raises(ValueError):                   # a projective table
        ek.bucket_rounds_mixed(acc32, torch.zeros((16, 3 * L // 2),
                                                  dtype=torch.int32),
                               ids, ids, ctx)
    with pytest.raises(ValueError):
        ek.ec_add(buckets, buckets[:, :, :4], ctx)
    with pytest.raises(ValueError):                   # mixed forms
        ek.ec_add(buckets, acc32, ctx)
    with pytest.raises(ValueError):                   # limb points
        ek.ec_gather_sum(buckets, ids, True, ctx)
    with pytest.raises(ValueError):                   # 5 totals, sets of 2
        ek.ec_horner(acc32[:, :, :5], 2, 4, ctx)


@pytest.mark.parametrize("kernel", ["proj", "round", "mxu"])
def test_table_wrappers_reject_bad_tables(kernel):
    """Kernels 2, 4 and 5 read rows by id without bounds, from a packed
    projective table: their wrappers refuse a table of short rows, an
    affine (2NL-wide) or int64 one, limb accumulators, and ids or found of
    the other kernels' form or of int64."""
    ctx = E.CurveCtx(BLS381)
    L = ctx.fp.L
    acc32 = pack32(torch.zeros((3, L, 8), dtype=torch.int64), 1)
    table32 = torch.zeros((16, 3 * L // 2), dtype=torch.int32)
    ids = torch.zeros((2, 8), dtype=torch.int32)
    wrapper = {"proj": ek.bucket_rounds_proj, "round": ek.bucket_round_add,
               "mxu": ek.bucket_round_add_mxu}[kernel]
    good, other = (ids, ids[0]) if kernel == "proj" else (ids[0], ids)
    assert wrapper(acc32, table32, good, good, ctx).shape == acc32.shape
    for bad in (table32[:, :-1], table32[:, :L], table32.long(),
                table32.reshape(-1)):
        with pytest.raises(ValueError, match="table"):
            wrapper(acc32, bad, good, good, ctx)
    with pytest.raises(ValueError):                   # limb accumulators
        wrapper(unpack32(acc32, 1), table32, good, good, ctx)
    with pytest.raises(ValueError):
        wrapper(acc32, table32, other, other, ctx)
    with pytest.raises(ValueError):
        wrapper(acc32, table32, good.long(), good, ctx)
    with pytest.raises(ValueError):                   # ids of another S
        wrapper(acc32, table32, good[..., :4], good, ctx)


def _rows_loop(acc, rows, found, ctx):
    """The bucket rounds on gathered rows, as kernels 2 and 4 ran before
    they read a table: round r adds rows[r*S:(r+1)*S], or the identity
    where found is 0, by the complete add (`ec.ec_add`)."""
    S, L = acc.shape[2], ctx.fp.L
    ident = ctx.identity_like((1,), "cpu")
    for r in range(found.shape[0]):
        delta = rows[r * S:(r + 1) * S].reshape(S, 3, L).permute(1, 2, 0)
        delta = torch.where((found[r] != 0)[None, None], delta, ident)
        acc = E.ec_add(acc, delta, ctx)
    return acc


@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("kernel", ["proj", "round", "round_mxu"])
def test_table_plain_versions_match_row_loops(kernel, curve):
    """Kernels 2, 4 and 5's plain versions, fed the packed projective
    table and the point ids, equal the old loop on the rows gathered from
    the limb table (kernel 5's also kernel 4's plain version): 96 slots (12
    warps of 8 groups), ~70% occupied, a warp whose slots are all empty, a
    warp with one live slot, the table's last row read, a slot doubling,
    and out-of-range ids in empty slots (not read)."""
    cv, jcv = CURVES[curve]
    S = 96
    acc, _, found, rows_all, pid = _round_inputs(jcv, 37, S, 3, 3,
                                                 with_table=True)
    if kernel != "proj":                              # one round
        found, pid = found[:1], pid[:1]
    found[:, 8:16] = 0                                # an empty warp
    found[:, 16:24] = 0
    found[:, 19] = 1                                  # one live slot
    pid[:, -1] = 15                                   # the last row
    found[:, -1] = 1
    L = jcv.fp.n_limbs
    acc[:, :, 2] = rows_all[pid[0, 2]].reshape(3, L)  # P + P
    found[0, 2] = 1
    rows = rows_all[pid.reshape(-1)]
    pid = np.where(found != 0, pid, 1 << 30)          # never read
    ctx = E.CurveCtx(cv)
    acc_t = torch.as_tensor(acc.astype(np.int64))
    want = _rows_loop(acc_t, torch.as_tensor(rows.astype(np.int64)),
                      torch.as_tensor(found), ctx)
    args = (pack32(acc_t, 1), _table32(rows_all), _ids(pid),
            torch.as_tensor(found))
    if kernel == "round":
        args = args[:2] + (args[2][0], args[3][0])
        got = ek.bucket_round_add(*args, ctx)
        assert torch.equal(got, ek.bucket_round_add_plain(*args, ctx))
    elif kernel == "round_mxu":
        args = args[:2] + (args[2][0], args[3][0])
        got = ek.bucket_round_add_mxu(*args, ctx)
        assert torch.equal(got, ek.bucket_round_add_mxu_plain(*args, ctx))
        assert torch.equal(got, ek.bucket_round_add_plain(*args, ctx))
    else:
        got = ek.bucket_rounds_proj(*args, ctx)
        assert torch.equal(got, ek.bucket_rounds_proj_plain(*args, ctx))
    assert torch.equal(unpack32(got, 1), want)


@pytest.mark.parametrize("kernel", ["mixed", "proj", "ec_add", "round",
                                    "round_mxu", "gather_sum",
                                    "window_totals", "horner"])
def test_packed_launches_refuse_cpu_tensors(kernel):
    """The `*32` functions only launch: given CPU tensors they raise and
    count nothing, with no plain version to fall back to."""
    ctx = E.CurveCtx(BLS381)
    L = ctx.fp.L
    width = 2 if kernel == "mixed" else 3
    acc32 = pack32(torch.zeros((3, L, 8), dtype=torch.int64), 1)
    rows32 = torch.zeros((16, width * L // 2), dtype=torch.int32)
    found32 = torch.ones((2, 8), dtype=torch.int32)
    ek.reset_launches()
    with pytest.raises(ValueError):
        if kernel == "ec_add":
            ek.ec_add32(acc32, acc32, ctx)
        elif kernel == "round":
            ek.bucket_round_add32(acc32.clone(), acc32, rows32, found32[0],
                                  found32[0], ctx)
        elif kernel == "round_mxu":
            ek.bucket_round_add_mxu32(acc32.clone(), acc32, rows32,
                                      found32[0], found32[0], ctx)
        elif kernel == "mixed":
            ek.bucket_rounds_mixed32(acc32.clone(), acc32, rows32, found32,
                                     found32, ctx)
        elif kernel == "gather_sum":
            ek.ec_gather_sum32(acc32.clone(), acc32, found32, True, ctx)
        elif kernel == "window_totals":
            ek.ec_window_totals32(acc32[:, :, :2].clone(),
                                  acc32.reshape(3, L // 2, 2, 4),
                                  acc32.reshape(3, L // 2, 2, 4), 2, ctx)
        elif kernel == "horner":
            ek.ec_horner32(acc32[:, :, :2].clone(), acc32, 4, 2, ctx)
        else:
            ek.bucket_rounds_proj32(acc32.clone(), acc32, rows32, found32,
                                    found32, ctx)
    assert ek.launches == {k: 0 for k in ek.launches}
    assert ek.form_launches == {k: 0 for k in ek.form_launches}


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
    """S = 512 slots on kernel 4's operands (the packed table, the point
    ids): half the accumulators at the identity, ~70% occupied, one slot
    doubling; the kernel-5 wrapper on the CPU runs its plain version and
    counts no launch."""
    S = 512
    acc, _, found, rows_all, pid = _round_inputs(JBLS381, 23, S, 2, 3,
                                                 with_table=True)
    L = JBLS381.fp.n_limbs
    acc[:, :, -1] = rows_all[pid[0, -1]].reshape(3, L)  # P + P
    found[0, -1] = 1
    ctx = E.CurveCtx(BLS381)
    args = (pack32(E.from_jax_points(acc, "cpu"), 1), _table32(rows_all),
            _ids(pid[0]), torch.as_tensor(found[0]), ctx)
    ek.reset_launches()
    got = ek.bucket_round_add_mxu(*args)
    assert got.dtype == torch.int32
    assert torch.equal(got, ek.bucket_round_add_mxu_plain(*args))
    assert torch.equal(got, ek.bucket_round_add(*args))
    assert ek.launches == {k: 0 for k in ek.launches}


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mxu_table_words_layout(curve):
    """The A fragments the CUDA kernel reads: m's blocks, then m*N's, each
    (m-tile, k-tile) block 32 lanes of 4 words, lane 4g + j holding A's
    rows g (words 0, 2) and g + 8 (words 1, 3) at columns 4j + b (words 0,
    1) and 16 + 4j + b (words 2, 3), byte b of a word (the PTX ISA's
    m16n8k32 A fragment); A's row r of m-tile mt is output byte 16 mt + r
    and its column kp the input byte `mxu_in_byte(kt, kp)`, which gives
    every input byte one column, in the words of the lane that holds it."""
    from bulletproofs_tpu_torch.ops import field as F
    cv, _ = CURVES[curve]
    ctx = E.CurveCtx(cv)
    nl = ctx.fp.L // 2
    K, L8 = nl // 4, 4 * nl
    k_tiles = (K + 1) // 2
    w = ek._mxu_fragments(ctx)
    assert w.dtype == np.uint32
    assert w.shape == (k_tiles * 6 * K * 64,)
    frag = w.view(np.uint8).reshape(-1, 32, 4, 4)     # block, lane, reg, b
    ins = [ek.mxu_in_byte(kt, kp, nl) for kt in range(k_tiles)
           for kp in range(32)]
    assert sorted(i for i in ins if i >= 0) == list(range(L8))
    for kt in range(k_tiles):
        for kp in range(32):
            i = ek.mxu_in_byte(kt, kp, nl)
            assert i < 0 or i // 4 // K == kp % 16 // 4   # lane j's words
    block = 0
    for (ts, _), m_tiles in zip(F.mxu_tables(ctx.fp), (K, 2 * K)):
        table = ts.astype(np.int64) + 128
        assert table.shape[0] == 16 * m_tiles
        for mt in range(m_tiles):
            for kt in range(k_tiles):
                A = np.zeros((16, 32), np.int64)
                for lane in range(32):
                    g, j = divmod(lane, 4)
                    for reg in range(4):
                        row, col = g + 8 * (reg % 2), 16 * (reg // 2) + 4 * j
                        A[row, col:col + 4] = frag[block, lane, reg]
                for kp in range(32):
                    i = ek.mxu_in_byte(kt, kp, nl)
                    want = table[16 * mt:16 * mt + 16, max(i, 0)]
                    np.testing.assert_array_equal(A[:, kp],
                                                  want if i >= 0 else 0)
                block += 1
    assert block == frag.shape[0]


def _mma_m16n8k32(a_regs, b_regs):
    """One mma.sync.m16n8k32 on unsigned bytes, from the PTX ISA's fragment
    tables: a_regs (32, 4) and b_regs (32, 2) uint32 per lane -> D's
    registers (32, 4) int64.  A: row g (lane // 4) in a0 and a2, g + 8 in
    a1 and a3; columns 4j + i (a0, a1) and 16 + 4j + i (a2, a3) for byte i,
    j = lane % 4.  B: rows 4j + i (b0) and 16 + 4j + i (b1), column g.
    D: row g (d0, d1) and g + 8 (d2, d3), columns 2j and 2j + 1."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    byte = lambda v, i: (int(v) >> (8 * i)) & 0xFF
    for lane in range(32):
        g, j = divmod(lane, 4)
        for i in range(4):
            A[g, 4 * j + i] = byte(a_regs[lane, 0], i)
            A[g + 8, 4 * j + i] = byte(a_regs[lane, 1], i)
            A[g, 16 + 4 * j + i] = byte(a_regs[lane, 2], i)
            A[g + 8, 16 + 4 * j + i] = byte(a_regs[lane, 3], i)
            B[4 * j + i, g] = byte(b_regs[lane, 0], i)
            B[16 + 4 * j + i, g] = byte(b_regs[lane, 1], i)
    D = A @ B
    return np.array([[D[l // 4, 2 * (l % 4)], D[l // 4, 2 * (l % 4) + 1],
                      D[l // 4 + 8, 2 * (l % 4)],
                      D[l // 4 + 8, 2 * (l % 4) + 1]] for l in range(32)])


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mxu_fragments_reproduce_toeplitz_products(curve):
    """The kernel's two REDC products emulated in numpy over the
    host-packed words: 8 slots of seeded byte vectors x (a warp's 8
    groups), lane j of group g holding words j*K .. j*K + K - 1 of slot
    g's x, slot 2t of them in the register of k-tile t that spans k
    positions 4j .. 4j + 3, slot 2t + 1 in the one that spans 16 + 4j ..
    They are B's b0, b1, the table A; each m-tile's D goes to slot rows in
    shared memory, (row 2j, 16 mt + g) for d0, (2j + 1, 16 mt + g) for d1,
    8 columns on for d2, d3, and each slot reads its row in byte order.
    Every slot's columns are `field.mxu_tables`' T @ x, for m's table and
    m*N's."""
    from bulletproofs_tpu_torch.ops import field as F
    cv, _ = CURVES[curve]
    ctx = E.CurveCtx(cv)
    nl = ctx.fp.L // 2
    K, L8 = nl // 4, 4 * nl
    k_tiles = (K + 1) // 2
    words = ek._mxu_fragments(ctx).reshape(-1, 32, 4)
    x = np.random.default_rng(41).integers(0, 256, (8, L8))
    x[0] = 255                                         # the largest sums
    xw = (x.reshape(8, nl, 4) << (8 * np.arange(4))).sum(-1)   # (8, nl)
    regs = np.zeros((k_tiles, 32, 2), np.int64)        # the slots' words
    for kt in range(k_tiles):
        for lane in range(32):
            g, j = divmod(lane, 4)
            for half in range(2):
                if 2 * kt + half < K:
                    regs[kt, lane, half] = xw[g, j * K + 2 * kt + half]
    first = 0
    for (ts, _), tiles in zip(F.mxu_tables(ctx.fp), (K, 2 * K)):
        table = ts.astype(np.int64) + 128
        got = np.zeros((8, table.shape[0]), np.int64)
        for tile in range(tiles):
            d = np.zeros((32, 4), np.int64)
            for kt in range(k_tiles):
                d += _mma_m16n8k32(words[first + tile * k_tiles + kt],
                                   regs[kt])
            for lane in range(32):
                g, j = divmod(lane, 4)
                c = 16 * tile + g
                got[2 * j:2 * j + 2, c] = d[lane, :2]
                got[2 * j:2 * j + 2, c + 8] = d[lane, 2:]
        first += tiles * k_tiles
        np.testing.assert_array_equal(got, x @ table.T)
        assert got.max() < 1 << 22
    assert first == words.shape[0]


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


# ---------------------------------------------------------------------------
# Kernel 3's sequential forms: each plain version against the Python loop of
# `ec.ec_add` it replaces (the loops the MSM's combine ran before; the
# combine as a whole is held against the JAX package in test_torch_msm.py)
# ---------------------------------------------------------------------------

def _bucket_array(cv, seed, W, B):
    """(3, L, W, B) projective points from 12 random ones (sums P + P, so
    Z != 1), one in 7 the identity, and the same packed."""
    ctx = E.CurveCtx(cv)
    rnd = random.Random(seed)
    base = E.to_device_points([p + p for p in (G1.random(rnd, cv)
                                               for _ in range(12))],
                              ctx, "cpu")
    pick = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 12, W * B))
    pts = base[:, :, pick]
    pts[:, :, ::7] = ctx.identity_like((1,), "cpu")
    pts = pts.reshape(3, ctx.fp.L, W, B)
    return ctx, pts, pack32(pts, 1)


def _loop_sum(ctx, cols, from_identity):
    """The combine's loop: acc = identity (or the first column), then
    acc = ec_add(acc, column) for each further column."""
    acc = ctx.identity_like(cols[0].shape[2:], "cpu") if from_identity \
        else cols[0]
    for col in (cols if from_identity else cols[1:]):
        acc = E.ec_add(acc, col, ctx)
    return acc


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_sequential_forms_match_python_loops(curve):
    """W = 3 windows of B = 16 buckets (c = 4, G = K = 4): the row and
    column sums (from the identity), a split fold (window 1: range 5,
    split 3, from the first sub-bucket, the rest identities), a duplicate
    row folded into window 1, the weighted running sums with 2 doublings,
    and a Horner over 2 sets of 2 windows, each limb for limb."""
    from bulletproofs_tpu_torch.ops import msm as M
    cv = CURVES[curve][0]
    W, B, G, K = 3, 16, 4, 4
    ctx, bk, bk32 = _bucket_array(cv, 31, W + 1, B)
    ek.reset_launches()

    # row and column sums (`bucket_rowcol`), one gather-sum
    base, base32 = bk[:, :, :W], bk32[:, :, :W].contiguous()
    rowsum, colsum = M.bucket_rowcol(base32, ctx, 4)
    grid = base.reshape(3, ctx.fp.L, W, G, K)
    want_row = _loop_sum(ctx, [grid[..., k] for k in range(K)], True)
    want_col = _loop_sum(ctx, [grid[..., g, :] for g in range(G)], True)
    assert torch.equal(unpack32(rowsum, 1), want_row)
    assert torch.equal(unpack32(colsum, 1), want_col)

    # the split fold: window 1 has range 5 and split 3
    ranges = np.array([[B], [5], [B]], np.int32)
    splits = np.array([[1], [3], [1]], np.int32)
    got = unpack32(M.fold_split_buckets(base32, ctx, ranges, splits), 1)
    want = base.clone()
    col = base[:, :, 1]
    want[:, :, 1, :5] = _loop_sum(
        ctx, [col[..., j * 5:(j + 1) * 5] for j in range(3)], False)
    want[:, :, 1, 5:] = ctx.identity_like((B - 5,), "cpu")
    assert torch.equal(got, want)

    # the duplicate-row fold: row W is window 1's second row
    got = unpack32(M._fold_dup_rows(bk32, ctx, ((1, 2),), W), 1)
    want = base.clone()
    want[:, :, 1] = _loop_sum(ctx, [bk[:, :, 1], bk[:, :, W]], False)
    assert torch.equal(got, want)

    # a gather row with no column is the identity; from_identity adds
    # the first column to the identity (another representative)
    idx = torch.tensor([[-1, -1], [0, -1], [0, -1]], dtype=torch.int32)
    flat32 = base32.reshape(3, ctx.fp.L // 2, W * B)
    got = unpack32(ek.ec_gather_sum(flat32, idx[:2], False, ctx), 1)
    assert torch.equal(got[:, :, :1], ctx.identity_like((1,), "cpu"))
    assert torch.equal(got[:, :, 1], base[:, :, 0, 0])
    got = unpack32(ek.ec_gather_sum(flat32, idx[2:], True, ctx), 1)
    assert torch.equal(got, E.ec_add(ctx.identity_like((1,), "cpu"),
                                     base[:, :, 0, :1], ctx))

    # the window totals (`window_totals`): the weighted running sums
    def weighted(arr, m):
        running = total = ctx.identity_like((W,), "cpu")
        for t in range(m - 1):
            running = E.ec_add(running, arr[..., m - 1 - t], ctx)
            total = E.ec_add(total, running, ctx)
        return total
    wr, wc = weighted(want_row, G), weighted(want_col, K)
    for _ in range(2):
        wr = E.ec_add(wr, wr, ctx)
    totals = M.window_totals(rowsum, colsum, ctx, 4)
    assert torch.equal(unpack32(totals, 1), E.ec_add(wr, wc, ctx))

    # the Horner over 2 sets of 2 windows (`combine_from_rowcol`)
    t4 = bk[:, :, 0, :4]
    acc = ctx.identity_like((2,), "cpu")
    for w in (1, 0):
        for _ in range(4):
            acc = E.ec_add(acc, acc, ctx)
        acc = E.ec_add(acc, t4.reshape(3, ctx.fp.L, 2, 2)[..., w], ctx)
    got = ek.ec_horner(pack32(t4, 1).contiguous(), 2, 4, ctx)
    assert torch.equal(unpack32(got, 1), acc)
    assert ek.launches == {k: 0 for k in ek.launches}
