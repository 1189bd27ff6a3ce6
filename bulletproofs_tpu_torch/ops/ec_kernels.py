"""The five CUDA kernels of the port (`csrc/ec_kernels.cu`,
`csrc/mxu_kernels.cu`): their wrappers, their plain PyTorch versions and
their launch counts.

| wrapper                | replaces (bulletproofs_tpu/ops/ec_pallas.py)    |
|------------------------|-------------------------------------------------|
| `bucket_rounds_mixed`  | `bucket_rounds_chunk_pallas_mixed` (:425)       |
| `bucket_rounds_proj`   | `bucket_rounds_chunk_pallas` (:355)             |
| `ec_add`               | `ec_add_pallas` (:499)                          |
| `bucket_round_add`     | `bucket_round_add_pallas` (:469)                |
| `bucket_round_add_mxu` | `bucket_round_add_pallas_mxu` (:217)            |

Kernel 3 has, beside the pairwise `ec_add`, three sequential forms: the
loops of complete adds that the MSM's combine runs (the JAX package's
`fori_loop`s over `ec_add`), each in one launch: `ec_gather_sum` (axis
sums and folds, 4 groups of 4 lanes an output), `ec_window_totals` and
`ec_horner` (a warp a chain);
and the pre-reduction form `ec_pre_reduce`, the MSM's pass loop of
pairwise same-bucket merges (the JAX package's loop over `ec_add` in
`bucket_accumulate`), a launch a pass, an add only where two entries
merge.

The group law is RCB16's complete addition: algorithm 7 (algorithm 8 for
kernel 1's mixed add) for a = 0 curves, and for ed25519, the one curve
with a != 0, algorithm 1 (18 products an add), which kernels 2, 3 and 4
carry as a compile-time form beside algorithm 7 (`_consts` gives them a,
a^2 and 3b), built into a library of its own (`csrc/ec_kernels_a.cu`).
Kernels 1 and 5 take a = 0 only: their launchers refuse an a != 0 curve,
which the MSM never gives kernel 1 (`msm.uses_mixed`).

Kernel 5 computes what kernel 4 computes, on kernel 4's operands, with the
REDC of each Montgomery product as byte Toeplitz products on the int8
tensor cores; nothing in the JAX package calls its TPU kernel, and no path
of the port calls it either: chip_smoke.py races it against kernel 4.

Forms of the operands.  Points are the port's int64 16-bit limb tensors
(3, L, ...) or PACKED 32-bit words (3, NL, ...) int32, NL = L/2, the
kernels' own form (`field.pack32`).  The bucket kernels 1, 2, 4 and 5 and
kernel 3's sequential forms take packed points only.  The bucket kernels
gather their rows by point id from a packed point table, affine (n, 2NL)
for kernel 1 (`affine_rows32`), projective (n, 3NL) for kernels 2, 4 and
5 (`proj_rows32`), so the MSM packs its table once and keeps its buckets
packed to the end of the combine.  `ec_add` takes either form and returns
the one it was given.

For a tensor on the CPU a wrapper runs the plain version; for a CUDA
tensor it launches the kernel on PyTorch's current stream, or raises.
There is no fallback from the kernel to the plain version.  The `*32`
functions launch a kernel on operands already packed, with no checks, so
the kernel can be timed alone.  `launches[name]` counts kernel launches,
and only those, also of the fused IPA's `bp_ipa_challenge`
(`ops/transcript_kernels.py`) and of the roofline harness's chain kernel
(`utils/roofline.py`), launched through `_launch`;
`form_launches` splits kernel 3's by form, and `a_nonzero_launches`
counts, of each, those of the a != 0 build (algorithm 1).
"""

import functools

import numpy as np
import torch

from . import build
from .ec import CurveCtx, ec_add as ec_add_plain, ec_madd
from .field import mont_mul, mont_mul_mxu, mxu_tables, pack32, unpack32

launches = {"bucket_rounds_mixed": 0, "bucket_rounds_proj": 0, "ec_add": 0,
            "bucket_round_add": 0, "bucket_round_add_mxu": 0,
            "ipa_challenge": 0, "chain": 0}
# kernel 3's launches by form (they sum to launches["ec_add"])
form_launches = {"pairwise": 0, "gather_sum": 0, "window_totals": 0,
                 "horner": 0, "pre_reduce": 0}
# the launches of the a != 0 builds (RCB16 algorithm 1), a part of the
# counts above: by kernel, and kernel 3's also by form (`ec_add:<form>`)
a_nonzero_launches = {"bucket_rounds_proj": 0, "ec_add": 0,
                      "bucket_round_add": 0, "chain": 0,
                      **{f"ec_add:{form}": 0 for form in form_launches}}


def reset_launches():
    for counts in (launches, form_launches, a_nonzero_launches):
        for name in counts:
            counts[name] = 0


def _on_card(t, name):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


@functools.cache
def _consts(ctx: CurveCtx):
    """Host uint32 words, the group kernels' curve constants (copied into
    the launch's parameters; `csrc/ec_common.cuh` make_field, then
    make_curve_a): p, Montgomery one, -p^-1 mod 2^32 and 3b as one word
    for a = 0 (0 for a != 0), then a, a^2 and 3b in Montgomery form,
    NL words each, for a != 0 (all 0 for a = 0).  The kernels take the
    a != 0 form (RCB16 algorithm 1) where a is not 0."""
    fp = ctx.fp
    nl = fp.L // 2
    words = lambda v: [(v >> (32 * k)) & 0xFFFFFFFF for k in range(nl)]
    n0inv = (-pow(fp.mod_int, -1, 1 << 32)) % (1 << 32)
    p, mont_r = ctx.cv.p, ctx.cv.fp.mont_r
    mont = lambda v: words(v % p * mont_r % p)
    if ctx.a_is_zero:
        small_b3, general = ctx.b3, [0] * (3 * nl)
    else:
        a = ctx.cv.a
        small_b3, general = 0, mont(a) + mont(a * a) + mont(ctx.b3)
    return np.array(words(fp.mod_int) + words(fp.fp.mont_one)
                    + [n0inv, small_b3] + general, dtype=np.uint32)


# what a launcher returns for a field it does not build
_CUDA_ERROR_INVALID_VALUE = 1


def _launch(fn_name, key, *args, form=None, ctx=None):
    """Call the C launcher `fn_name` with `args` and PyTorch's current
    stream; count the launch under `key`, kernel 3's also under `form`.
    `ctx`: the curve of a kernel whose build depends on it.  For an a != 0
    curve the launch goes to the a != 0 library's launcher, `fn_name` +
    "_a", where it has one, and counts in `a_nonzero_launches` too; a
    launcher that does not build the curve's field refuses it (kernels 1
    and 5, or a != 0 at another width): NotImplementedError."""
    lib = build.load()
    general = ctx is not None and not ctx.a_is_zero
    fn = getattr(lib, f"{fn_name}_a", None) if general else None
    rc = (fn or getattr(lib, fn_name))(
        *args, torch.cuda.current_stream().cuda_stream)
    if rc == _CUDA_ERROR_INVALID_VALUE and general:
        raise NotImplementedError(
            f"{fn_name}: no CUDA kernel for {ctx.cv.name} (a != 0, "
            f"{ctx.fp.L // 2} words): RCB16 algorithm 1 is built into "
            "kernels 2, 3 and 4 for 8-word fields")
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at launch")
    launches[key] += 1
    if form is not None:
        form_launches[form] += 1
    if general:
        a_nonzero_launches[key] += 1
        if form is not None:
            a_nonzero_launches[f"ec_add:{form}"] += 1


def _is_packed(points, ctx, name):
    """True for packed points (3, NL, ...) int32, False for limb tensors
    (3, L, ...) int64; raises for anything else."""
    L = ctx.fp.L
    if points.dtype == torch.int32 and points.shape[:2] == (3, L // 2):
        return True
    if points.dtype == torch.int64 and points.shape[:2] == (3, L):
        return False
    raise ValueError(f"{name}: points must be (3, {L}, ...) int64 or "
                     f"(3, {L // 2}, ...) int32, got {tuple(points.shape)} "
                     f"{points.dtype}")


def _require_packed(points, ctx, name, ndim=None):
    if not _is_packed(points, ctx, name) or (ndim and points.ndim != ndim):
        raise ValueError(f"{name}: needs packed (3, {ctx.fp.L // 2}"
                         f"{', ...' if ndim is None else ''}) int32 points, "
                         f"got {tuple(points.shape)} {points.dtype}")


def _same_device(name, *tensors):
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: operands on different devices")


def _require_contiguous(name, *tensors):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: CUDA operands must be contiguous")


def affine_rows32(points):
    """Affine points (3, L, n) int64 (Z == 1) -> kernel 1's point table
    (n, 2NL) int32: row i holds point i's X words, then its Y words."""
    n = points.shape[2]
    return pack32(points[:2], 1).permute(2, 0, 1).reshape(n, -1).contiguous()


def proj_rows32(points):
    """Points (3, L, n) int64 or packed (3, NL, n) int32 -> kernels 2 and
    4's point table (n, 3NL) int32: row i holds point i's X, Y, then Z
    words."""
    if points.dtype != torch.int32:
        points = pack32(points, 1)
    n = points.shape[2]
    return points.permute(2, 0, 1).reshape(n, -1).contiguous()


def _check_buckets(name, acc32, table32, ids, found, ctx, width,
                   rounds=True):
    """The bucket kernels' operands: packed accumulators (3, NL, S); ids
    and found int32, (R_c, S) for kernels 1 and 2 (`rounds`), (S,) for
    kernel 4; a packed (rows, width*NL) int32 table; all on one device.
    The ids are not held against the table's rows: the kernels read by id
    without bounds, and a check on the card would wait for it."""
    _require_packed(acc32, ctx, name, ndim=3)
    S = acc32.shape[2]
    if (found.ndim != (2 if rounds else 1) or found.shape[-1] != S
            or ids.shape != found.shape
            or found.dtype != torch.int32 or ids.dtype != torch.int32):
        raise ValueError(f"{name}: ids {tuple(ids.shape)} {ids.dtype} / "
                         f"found {tuple(found.shape)} {found.dtype} must be "
                         f"{'(R_c, S)' if rounds else '(S,)'} int32, "
                         f"S = {S}")
    words = width * ctx.fp.L // 2
    if table32.dtype != torch.int32 or table32.ndim != 2 \
            or table32.shape[1] != words:
        raise ValueError(f"{name}: table must be (rows, {words}) int32, "
                         f"got {tuple(table32.shape)} {table32.dtype}")
    _same_device(name, acc32, table32, ids, found)


def _run_buckets(name, plain, bare, acc32, table32, ids, found, ctx):
    """A bucket kernel's wrapper after its checks: the plain version for
    CPU tensors, else one launch into a new accumulator tensor."""
    if not _on_card(acc32, name):
        return plain(acc32, table32, ids, found, ctx)
    _require_contiguous(name, acc32, table32, ids, found)
    out = torch.empty_like(acc32)
    bare(out, acc32, table32, ids, found, ctx)
    return out


def _gather_rows(table32, ids, found):
    """Rows table32[ids] as 16-bit limbs (..., 2 * words) int64; an empty
    slot's id (found 0) is not read, row 0 stands in."""
    return unpack32(table32[torch.where(found != 0, ids, 0).long()], -1)


def packed_identity(ctx: CurveCtx, shape, device):
    """(3, NL, *shape) packed identities (0 : 1 : 0)."""
    return pack32(ctx.identity_like(shape, device), 1)


def _require_card(key, *tensors):
    if not all(_on_card(t, key) for t in tensors):
        raise ValueError(f"{key}: packed operands must be CUDA tensors")


def bucket_rounds_mixed32(out32, acc32, table32, ids, found, ctx: CurveCtx):
    """Kernel 1 on packed CUDA operands, unchecked: writes `out32`
    (3, NL, S), which may be `acc32` itself."""
    _require_card("bucket_rounds_mixed", out32, acc32, table32, ids, found)
    R_c, S = found.shape
    _launch("bp_bucket_rounds_mixed", "bucket_rounds_mixed",
            out32.data_ptr(), acc32.data_ptr(), table32.data_ptr(),
            ids.data_ptr(), found.data_ptr(), S, R_c, ctx.fp.L // 2,
            _consts(ctx).ctypes.data, ctx=ctx)


def bucket_rounds_proj32(out32, acc32, table32, ids, found, ctx: CurveCtx):
    """Kernel 2 on packed CUDA operands, unchecked: writes `out32`
    (3, NL, S), which may be `acc32` itself."""
    _require_card("bucket_rounds_proj", out32, acc32, table32, ids, found)
    R_c, S = found.shape
    _launch("bp_bucket_rounds_proj", "bucket_rounds_proj",
            out32.data_ptr(), acc32.data_ptr(), table32.data_ptr(),
            ids.data_ptr(), found.data_ptr(), S, R_c, ctx.fp.L // 2,
            _consts(ctx).ctypes.data, ctx=ctx)


def bucket_round_add32(out32, acc32, table32, ids, found, ctx: CurveCtx):
    """Kernel 4 on packed CUDA operands, unchecked: writes `out32`
    (3, NL, S), which may be `acc32` itself."""
    _require_card("bucket_round_add", out32, acc32, table32, ids, found)
    _launch("bp_bucket_round_add", "bucket_round_add", out32.data_ptr(),
            acc32.data_ptr(), table32.data_ptr(), ids.data_ptr(),
            found.data_ptr(), found.shape[0], ctx.fp.L // 2,
            _consts(ctx).ctypes.data, ctx=ctx)


def ec_add32(P32, Q32, ctx: CurveCtx):
    """Kernel 3, pairwise, on packed (3, NL, n) int32 operands -> packed
    P + Q."""
    _require_card("ec_add", P32, Q32)
    out = torch.empty_like(P32)
    _launch("bp_ec_add", "ec_add", out.data_ptr(), P32.data_ptr(),
            Q32.data_ptr(), P32.shape[2], ctx.fp.L // 2,
            _consts(ctx).ctypes.data, form="pairwise", ctx=ctx)
    return out


def ec_gather_sum32(out32, P32, idx, from_identity, ctx: CurveCtx):
    """Kernel 3's gather-sum form on packed CUDA operands, unchecked."""
    _require_card("ec_add", out32, P32, idx)
    n_out, m = idx.shape
    _launch("bp_ec_gather_sum", "ec_add", out32.data_ptr(), P32.data_ptr(),
            idx.data_ptr(), n_out, m, P32.shape[2], int(bool(from_identity)),
            ctx.fp.L // 2, _consts(ctx).ctypes.data, form="gather_sum",
            ctx=ctx)


def ec_pre_reduce32(table32, rows32, perm, sorted_d, rank, p,
                    ctx: CurveCtx):
    """Pass p of kernel 3's pre-reduction form on CUDA operands, unchecked:
    writes table32 (W*n, 3NL) from rows32 (n, 3NL) by perm in pass 0,
    updates it in place after; perm, sorted_d, rank (W, n) int64,
    contiguous."""
    _require_card("ec_add", table32, rows32, perm, sorted_d, rank)
    W, n = sorted_d.shape
    _launch("bp_ec_pre_reduce", "ec_add", table32.data_ptr(),
            rows32.data_ptr(), perm.data_ptr(), sorted_d.data_ptr(),
            rank.data_ptr(), W, n, p, ctx.fp.L // 2,
            _consts(ctx).ctypes.data, form="pre_reduce", ctx=ctx)


def ec_window_totals32(out32, rowsum32, colsum32, dbl, ctx: CurveCtx):
    """Kernel 3's window-totals form on packed CUDA operands, unchecked:
    rowsum32 (3, NL, W, G), colsum32 (3, NL, W, K), out32 (3, NL, W)."""
    _require_card("ec_add", out32, rowsum32, colsum32)
    _, _, W, G = rowsum32.shape
    _launch("bp_ec_window_totals", "ec_add", out32.data_ptr(),
            rowsum32.data_ptr(), colsum32.data_ptr(), W, G,
            colsum32.shape[3], dbl, ctx.fp.L // 2, _consts(ctx).ctypes.data,
            form="window_totals", ctx=ctx)


def ec_horner32(out32, totals32, wps, c, ctx: CurveCtx):
    """Kernel 3's Horner form on packed CUDA operands, unchecked:
    totals32 (3, NL, n_sets*wps), out32 (3, NL, n_sets)."""
    _require_card("ec_add", out32, totals32)
    _launch("bp_ec_horner", "ec_add", out32.data_ptr(), totals32.data_ptr(),
            out32.shape[2], wps, c, ctx.fp.L // 2, _consts(ctx).ctypes.data,
            form="horner", ctx=ctx)


# ---------------------------------------------------------------------------
# Kernel 1: R_c bucket rounds, affine rows gathered from a packed table,
# mixed add
# ---------------------------------------------------------------------------

def bucket_rounds_mixed_plain(acc32, table32, ids, found, ctx: CurveCtx):
    """acc32 (3, NL, S) packed Montgomery accumulators; table32 (n, 2NL)
    packed affine rows (`affine_rows32`); ids, found (R_c, S): the point
    added to slot s in round r (an id < n wherever found is set; the
    caller's slot grid, not checked on the card, which would wait for it),
    and whether one is -> the accumulators after the R_c rounds, packed.
    Each occupied slot gets the complete mixed add (RCB16 algorithm 8) of
    its point; an empty slot keeps its accumulator (its id is not read)."""
    L = ctx.fp.L
    acc = unpack32(acc32, 1)
    for r in range(found.shape[0]):
        live = torch.nonzero(found[r]).squeeze(1)   # only these slots add
        rows = table32[ids[r, live].long()].reshape(-1, 2, L // 2)
        delta = unpack32(rows, 2).permute(1, 2, 0)  # (2, L, live)
        acc[:, :, live] = ec_madd(acc[:, :, live], delta, ctx)
    return pack32(acc, 1)


def bucket_rounds_mixed(acc32, table32, ids, found, ctx: CurveCtx):
    """Kernel 1 (`bp_bucket_rounds_mixed`): the new accumulators (3, NL, S)
    after R_c rounds; see `bucket_rounds_mixed_plain` for the function and
    the operands (ids and found int32, all on one device)."""
    name = "bucket_rounds_mixed"
    _check_buckets(name, acc32, table32, ids, found, ctx, 2)
    return _run_buckets(name, bucket_rounds_mixed_plain,
                        bucket_rounds_mixed32, acc32, table32, ids, found,
                        ctx)


# ---------------------------------------------------------------------------
# Kernel 2: R_c bucket rounds, projective rows gathered from a packed table,
# complete add
# ---------------------------------------------------------------------------

def bucket_rounds_proj_plain(acc32, table32, ids, found, ctx: CurveCtx):
    """acc32 (3, NL, S) packed Montgomery accumulators; table32 (n, 3NL)
    packed projective rows (`proj_rows32`, or the MSM's pre-reduced
    table); ids, found (R_c, S): the point added to slot s in round r (an
    id < n wherever found is set; not checked on the card) and whether
    one is -> the accumulators after R_c rounds of the complete add (RCB16
    algorithm 7), packed.  Empty slots add the identity (0 : 1 : 0), as
    the TPU kernel does (their ids are not read)."""
    L = ctx.fp.L
    S = acc32.shape[2]
    rows = _gather_rows(table32, ids, found)        # (R_c, S, 3L)
    ident = ctx.identity_like((1,), acc32.device)
    acc = unpack32(acc32, 1)
    for r in range(found.shape[0]):
        delta = rows[r].reshape(S, 3, L).permute(1, 2, 0)
        delta = torch.where((found[r] != 0)[None, None], delta, ident)
        acc = ec_add_plain(acc, delta, ctx)
    return pack32(acc, 1)


def bucket_rounds_proj(acc32, table32, ids, found, ctx: CurveCtx):
    """Kernel 2 (`bp_bucket_rounds_proj`): the new accumulators (3, NL, S)
    after R_c rounds; see `bucket_rounds_proj_plain` for the function and
    the operands (ids and found int32, all on one device)."""
    name = "bucket_rounds_proj"
    _check_buckets(name, acc32, table32, ids, found, ctx, 3)
    return _run_buckets(name, bucket_rounds_proj_plain,
                        bucket_rounds_proj32, acc32, table32, ids, found,
                        ctx)


# ---------------------------------------------------------------------------
# Kernel 3: batched complete add, and its sequential forms
# ---------------------------------------------------------------------------

def ec_add(P, Q, ctx: CurveCtx):
    """Kernel 3 (`bp_ec_add`): P + Q elementwise, P and Q (3, L, *batch)
    limb tensors or (3, NL, *batch) packed, of one shape and form (any
    batch size; the kernel masks the ragged tail) -> the same form.  The
    plain version is `ops/ec.py:ec_add`."""
    packed = _is_packed(P, ctx, "ec_add")
    if P.shape != Q.shape or P.dtype != Q.dtype:
        raise ValueError(f"ec_add: shapes {tuple(P.shape)} and "
                         f"{tuple(Q.shape)} ({P.dtype}, {Q.dtype}) must "
                         "match")
    _same_device("ec_add", P, Q)
    if not _on_card(P, "ec_add"):
        if packed:
            return pack32(ec_add_plain(unpack32(P, 1), unpack32(Q, 1), ctx),
                          1)
        return ec_add_plain(P, Q, ctx)
    n = P[0, 0].numel()
    if n == 0:
        return torch.empty_like(P)
    if packed:
        nl = P.shape[1]
        return ec_add32(P.reshape(3, nl, n).contiguous(),
                        Q.reshape(3, nl, n).contiguous(), ctx).reshape(P.shape)
    out = ec_add32(pack32(P.reshape(3, ctx.fp.L, n), 1).contiguous(),
                   pack32(Q.reshape(3, ctx.fp.L, n), 1).contiguous(), ctx)
    return unpack32(out, 1).reshape(P.shape)


def ec_gather_sum_plain(P32, idx, from_identity, ctx: CurveCtx):
    """P32 (3, NL, ncols) packed points; idx (n_out, m) int32 column ids,
    -1 for none -> (3, NL, n_out) packed: output o is the columns of row o
    added left to right by the complete add (`ec.ec_add`), starting from
    the identity when `from_identity` (identity + P[first] + ...), else
    from the row's first column itself; a row with no column gives the
    identity."""
    P = unpack32(P32, 1)
    n_out, m = idx.shape
    acc = ctx.identity_like((n_out,), P.device)
    started = torch.full((n_out,), bool(from_identity), device=P.device)
    for j in range(m):
        col = idx[:, j].long()
        valid = col >= 0
        add = torch.nonzero(valid & started).squeeze(1)
        first = torch.nonzero(valid & ~started).squeeze(1)
        if add.numel():
            acc[:, :, add] = ec_add_plain(acc[:, :, add], P[:, :, col[add]],
                                          ctx)
        acc[:, :, first] = P[:, :, col[first]]
        started = started | valid
    return pack32(acc, 1)


def ec_gather_sum(P32, idx, from_identity, ctx: CurveCtx):
    """Kernel 3's gather-sum form (`bp_ec_gather_sum`): one chain of
    complete adds per output, over a list of columns; see
    `ec_gather_sum_plain`.  The MSM's axis sums and folds.  On the card
    every shape runs one layout, 4 groups of 4 lanes an output, each add's
    6 products 2 at once on each group (`SplitLevels`): ~2.5x less latency
    an add than one group, and 2 outputs a warp, which keeps issue slots
    for 2048 outputs where a warp an output runs short of them (NVIDIA
    H100, BLS12-381, `scripts/pre_reduce_sums.py`: 0.0843 ms at 1024 x 16
    and 0.1108 ms at 2048 x 16, against 0.0837 and 0.1565 for a warp an
    output); on the folds' short chains it ties one group an output, or
    beats it (PERF.md section 6)."""
    name = "ec_gather_sum"
    _require_packed(P32, ctx, name, ndim=3)
    if idx.dtype != torch.int32 or idx.ndim != 2:
        raise ValueError(f"{name}: idx must be (n_out, m) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    _same_device(name, P32, idx)
    if not _on_card(P32, name):
        return ec_gather_sum_plain(P32, idx, from_identity, ctx)
    _require_contiguous(name, P32, idx)
    out = torch.empty((3, P32.shape[1], idx.shape[0]), dtype=torch.int32,
                      device=P32.device)
    ec_gather_sum32(out, P32, idx, from_identity, ctx)
    return out


def _check_pre_reduce(name, rows32, perm, sorted_d, rank, passes, ctx):
    if passes < 1:
        raise ValueError(f"{name}: {passes} passes; the form runs 1 or more")
    words = 3 * ctx.fp.L // 2
    if rows32.dtype != torch.int32 or rows32.ndim != 2 \
            or rows32.shape[1] != words:
        raise ValueError(f"{name}: rows must be (n, {words}) int32, got "
                         f"{tuple(rows32.shape)} {rows32.dtype}")
    if sorted_d.ndim != 2 or perm.shape != sorted_d.shape \
            or rank.shape != sorted_d.shape \
            or sorted_d.shape[1] != rows32.shape[0]:
        raise ValueError(f"{name}: perm {tuple(perm.shape)}, digits "
                         f"{tuple(sorted_d.shape)} and rank "
                         f"{tuple(rank.shape)} must be (W, n), n = "
                         f"{rows32.shape[0]} rows")
    _same_device(name, rows32, perm, sorted_d, rank)


def _merging(sorted_d, rank, p):
    """(W, n) bool: the entries pass p adds into -- rank a multiple of
    2^(p+1), digit nonzero and equal to the digit 2^p places on in the
    window's row (-1 past its end)."""
    shift = 1 << p
    d_next = torch.cat([sorted_d[:, shift:],
                        torch.full_like(sorted_d[:, :shift], -1)], dim=1)
    return ((rank & ((2 << p) - 1)) == 0) & (d_next == sorted_d) & \
        (sorted_d != 0)


def ec_pre_reduce_plain(rows32, perm, sorted_d, rank, passes,
                        ctx: CurveCtx):
    """rows32 (n, 3NL) packed projective rows (`proj_rows32`); perm,
    sorted_d, rank (W, n): each window's digit-sorted order, its digits
    and each entry's rank within its digit (`msm._sorted_ranks`) -> the
    pre-reduced table (W*n, 3NL) int32, row w*n + i the point at sorted
    position i of window w after `passes` passes: pass p sets
    P[i] = P[i] + P[i + 2^p] (`ec.ec_add`, that operand order) for every
    entry that merges (`_merging`), and leaves every other row as it is,
    so a bucket's occupancy halves a pass.  The adds run on the merging
    entries only; their words are those of the pass loop over all W*n
    entries that keeps the sum where an entry merges."""
    L = ctx.fp.L
    table = rows32[perm.reshape(-1)]
    for p in range(passes):
        e = torch.nonzero(_merging(sorted_d, rank, p).reshape(-1)) \
            .squeeze(1)
        if not e.numel():
            continue
        P, Q = (unpack32(table[k], -1).reshape(-1, 3, L).permute(1, 2, 0)
                for k in (e, e + (1 << p)))
        table[e] = pack32(ec_add_plain(P, Q, ctx), 1).permute(2, 0, 1) \
            .reshape(e.numel(), -1)
    return table


def ec_pre_reduce(rows32, perm, sorted_d, rank, passes, ctx: CurveCtx):
    """Kernel 3's pre-reduction form (`bp_ec_pre_reduce`): the MSM's
    `passes` passes of same-bucket merging; see `ec_pre_reduce_plain` for
    the function and the operands.  On the card each pass is one launch
    that adds only the merging pairs (a warp a tile of 32 entries, a
    ballot finds them), the first also writing the table from `rows32` by
    `perm`, the later ones in place; no host synchronisation."""
    name = "ec_pre_reduce"
    _check_pre_reduce(name, rows32, perm, sorted_d, rank, passes, ctx)
    if not _on_card(rows32, name):
        return ec_pre_reduce_plain(rows32, perm, sorted_d, rank, passes, ctx)
    perm, sorted_d, rank = (x.to(torch.int64) for x in (perm, sorted_d,
                                                        rank))
    _require_contiguous(name, rows32, perm, sorted_d, rank)
    if rows32.data_ptr() % 16:      # pass 0 copies rows 16 bytes at a time
        raise ValueError(f"{name}: rows must start on a 16-byte boundary")
    table = torch.empty((perm.numel(), rows32.shape[1]), dtype=torch.int32,
                        device=rows32.device)
    for p in range(passes):
        ec_pre_reduce32(table, rows32, perm, sorted_d, rank, p, ctx)
    return table


def _weighted_sum_plain(arr, ctx):
    """arr (3, L, W, m) -> sum_j j * arr[..., j] by the descending running
    sum (sum of suffixes), from the identity."""
    m = arr.shape[-1]
    running = ctx.identity_like(arr.shape[2:-1], arr.device)
    total = ctx.identity_like(arr.shape[2:-1], arr.device)
    for t in range(m - 1):
        running = ec_add_plain(running, arr[..., m - 1 - t], ctx)
        total = ec_add_plain(total, running, ctx)
    return total


def ec_window_totals_plain(rowsum32, colsum32, dbl, ctx: CurveCtx):
    """rowsum32 (3, NL, W, G), colsum32 (3, NL, W, K) packed -> per-window
    totals (3, NL, W) packed: wr = sum_g g*rowsum and wc = sum_k k*colsum
    by descending running sums, `dbl` doublings of wr (wr + wr), then
    wr + wc."""
    wr = _weighted_sum_plain(unpack32(rowsum32, 1), ctx)
    wc = _weighted_sum_plain(unpack32(colsum32, 1), ctx)
    for _ in range(dbl):
        wr = ec_add_plain(wr, wr, ctx)
    return pack32(ec_add_plain(wr, wc, ctx), 1)


def ec_window_totals(rowsum32, colsum32, dbl, ctx: CurveCtx):
    """Kernel 3's window-totals form (`bp_ec_window_totals`), one group per
    window; see `ec_window_totals_plain`."""
    name = "ec_window_totals"
    _require_packed(rowsum32, ctx, name, ndim=4)
    _require_packed(colsum32, ctx, name, ndim=4)
    W = rowsum32.shape[2]
    if colsum32.shape[2] != W:
        raise ValueError(f"{name}: {W} and {colsum32.shape[2]} windows")
    _same_device(name, rowsum32, colsum32)
    if not _on_card(rowsum32, name):
        return ec_window_totals_plain(rowsum32, colsum32, dbl, ctx)
    _require_contiguous(name, rowsum32, colsum32)
    out = torch.empty((3, rowsum32.shape[1], W), dtype=torch.int32,
                      device=rowsum32.device)
    ec_window_totals32(out, rowsum32, colsum32, dbl, ctx)
    return out


def ec_horner_plain(totals32, wps, c, ctx: CurveCtx):
    """totals32 (3, NL, n_sets*wps) packed window totals, set-major ->
    (3, NL, n_sets) packed: per set, from the identity, for w = wps-1 .. 0
    c doublings (acc + acc), then acc + totals[set, w]."""
    t = unpack32(totals32, 1)
    n_sets = t.shape[2] // wps
    t = t.reshape(t.shape[:2] + (n_sets, wps))
    acc = ctx.identity_like((n_sets,), t.device)
    for w in range(wps - 1, -1, -1):
        for _ in range(c):
            acc = ec_add_plain(acc, acc, ctx)
        acc = ec_add_plain(acc, t[..., w], ctx)
    return pack32(acc, 1)


def ec_horner(totals32, wps, c, ctx: CurveCtx):
    """Kernel 3's Horner form (`bp_ec_horner`), one group per set; see
    `ec_horner_plain`."""
    name = "ec_horner"
    _require_packed(totals32, ctx, name, ndim=3)
    if wps <= 0 or totals32.shape[2] % wps:
        raise ValueError(f"{name}: {totals32.shape[2]} totals are not sets "
                         f"of {wps}")
    if not _on_card(totals32, name):
        return ec_horner_plain(totals32, wps, c, ctx)
    _require_contiguous(name, totals32)
    out = torch.empty((3, totals32.shape[1], totals32.shape[2] // wps),
                      dtype=torch.int32, device=totals32.device)
    ec_horner32(out, totals32, wps, c, ctx)
    return out


# ---------------------------------------------------------------------------
# Kernel 4: one bucket round, projective rows gathered from a packed table,
# complete add
# ---------------------------------------------------------------------------

def _round_add_rows(buckets, rows, found, ctx: CurveCtx, mul=mont_mul):
    """buckets (3, L, S); rows (S, 3L) projective; found (S,) -> buckets
    after one round of the complete add (RCB16 algorithm 7): every slot
    adds its row, or the identity (0 : 1 : 0) where found is 0 -- the
    function of `ec_pallas._round_kernel`.  `mul`: the Montgomery product
    (`mont_mul_mxu` for kernel 5's plain version; the limbs are the same).

    Algorithm 7 (and algorithm 1) with (X2, Y2, Z2) = (0, 1, 0) reduces to
    (X1*Y1 : Y1*Y1 : Z1*Y1): every other product is zero, and the field ops
    are exact.  So the empty slots, most of them in a sparse round, take
    one product instead of the whole add, with the same limbs."""
    S = buckets.shape[2]
    delta = rows.reshape(S, 3, ctx.fp.L).permute(1, 2, 0)
    live = torch.nonzero(found).squeeze(1)
    idle = torch.nonzero(found == 0).squeeze(1)
    out = torch.empty_like(buckets)
    out[:, :, live] = ec_add_plain(buckets[:, :, live], delta[:, :, live],
                                   ctx, mul=mul)
    P = buckets[:, :, idle].transpose(0, 1)          # (L, 3, k)
    out[:, :, idle] = mul(P, P[:, 1:2], ctx.fp).transpose(0, 1)
    return out


def bucket_round_add_plain(acc32, table32, ids, found, ctx: CurveCtx):
    """acc32 (3, NL, S) packed accumulators; table32 (n, 3NL) packed
    projective rows (`proj_rows32`); ids, found (S,) -> the accumulators
    after one round, packed: slot s adds point ids[s] (an id < n where
    found is set; not checked on the card), or the identity where found is
    0 (its id is not read); see `_round_add_rows` for the function."""
    return pack32(_round_add_rows(unpack32(acc32, 1),
                                  _gather_rows(table32, ids, found), found,
                                  ctx), 1)


def bucket_round_add(acc32, table32, ids, found, ctx: CurveCtx):
    """Kernel 4 (`bp_bucket_round_add`): the new accumulators (3, NL, S)
    after one round; see `bucket_round_add_plain` for the function and the
    operands (ids and found int32, all on one device)."""
    name = "bucket_round_add"
    _check_buckets(name, acc32, table32, ids, found, ctx, 3, rounds=False)
    return _run_buckets(name, bucket_round_add_plain, bucket_round_add32,
                        acc32, table32, ids, found, ctx)


# ---------------------------------------------------------------------------
# Kernel 5: kernel 4's round, the REDC's fixed-operand products on the int8
# tensor cores
# ---------------------------------------------------------------------------

def mxu_in_byte(kt, kp, nl):
    """Kernel 5's K order: the input byte at k position kp of k-tile kt, or
    -1 (padding).  Lane j of a group holds its words j*K .. j*K + K - 1
    (K = nl / 4), word slot 2t in the fragment register of k-tile t that
    spans kp = 4j .. 4j + 3 (b0) and slot 2t + 1 in the one that spans
    kp = 16 + 4j .. (b1)."""
    K = nl // 4
    half, rest = divmod(kp, 16)
    lane, byte = divmod(rest, 4)
    slot = 2 * kt + half
    return np.where(slot < K, 4 * (lane * K + slot) + byte, -1)


def _mxu_fragments(ctx: CurveCtx):
    """Kernel 5's tables (`csrc/mxu_kernels.cu`) as uint32 words in the
    PTX ISA's m16n8k32 fragment order: m's table (L8 x L8), then m*N's
    (2 L8 x L8), the unbiased byte Toeplitz tables of `field.mxu_tables`
    (entries + 128) at (output byte, input byte `mxu_in_byte`), 0 for
    padding.  The kernel's mapping: the table is A, blocks (m-tile of 16
    output bytes in order, k-tile), 32 lanes of 4 words; lane 4g + j holds
    A's rows g (words 0, 2) and g + 8 (words 1, 3) at columns 4j + b
    (words 0, 1) and 16 + 4j + b (words 2, 3), byte b of each word."""
    nl = ctx.fp.L // 2
    K = nl // 4
    k_tiles = (K + 1) // 2
    lane = np.arange(32)
    g, j = lane // 4, lane % 4
    reg = np.arange(4)
    # (lane, reg, byte): the k position, then the output byte
    kp = 16 * (reg // 2)[None, :, None] + 4 * j[:, None, None] \
        + np.arange(4)[None, None, :]
    blocks = []
    for (ts, _), m_tiles in zip(mxu_tables(ctx.fp), (K, 2 * K)):
        table = ts.astype(np.int64) + 128
        for tile in range(m_tiles):
            out = 16 * tile + g[:, None, None] + 8 * (reg % 2)[:, None]
            for kt in range(k_tiles):
                ins = mxu_in_byte(kt, kp, nl)
                entry = table[np.broadcast_to(out, kp.shape),
                              np.maximum(ins, 0)]
                blocks.append(np.where(ins >= 0, entry, 0).astype(np.uint8))
    return np.stack(blocks).reshape(-1).view("<u4")


_mxu_device = {}


def _mxu_fragments_on(ctx: CurveCtx, device):
    """`_mxu_fragments` on `device`, made once per curve and card."""
    key = (ctx.cv.name, str(device))
    if key not in _mxu_device:
        _mxu_device[key] = torch.as_tensor(
            _mxu_fragments(ctx).view(np.int32), device=device)
    return _mxu_device[key]


def bucket_round_add_mxu_plain(acc32, table32, ids, found, ctx: CurveCtx):
    """Kernel 4's round (`bucket_round_add_plain`, same operands) with every
    Montgomery product through `field.mont_mul_mxu` (separated REDC, the
    fixed-operand halves as byte Toeplitz products): the same words, the
    function of `ec_pallas._round_kernel_mxu`."""
    return pack32(_round_add_rows(unpack32(acc32, 1),
                                  _gather_rows(table32, ids, found), found,
                                  ctx, mul=mont_mul_mxu), 1)


def bucket_round_add_mxu32(out32, acc32, table32, ids, found,
                           ctx: CurveCtx):
    """Kernel 5 on packed CUDA operands, unchecked: writes `out32`
    (3, NL, S), which may be `acc32` itself."""
    _require_card("bucket_round_add_mxu", out32, acc32, table32, ids, found)
    frags = _mxu_fragments_on(ctx, acc32.device)
    _launch("bp_bucket_round_add_mxu", "bucket_round_add_mxu",
            out32.data_ptr(), acc32.data_ptr(), table32.data_ptr(),
            ids.data_ptr(), found.data_ptr(), found.shape[0], ctx.fp.L // 2,
            _consts(ctx).ctypes.data, frags.data_ptr(), ctx=ctx)


def bucket_round_add_mxu(acc32, table32, ids, found, ctx: CurveCtx):
    """Kernel 5 (`bp_bucket_round_add_mxu`): kernel 4's function on kernel
    4's operands; see `bucket_round_add_mxu_plain`."""
    name = "bucket_round_add_mxu"
    _check_buckets(name, acc32, table32, ids, found, ctx, 3, rounds=False)
    return _run_buckets(name, bucket_round_add_mxu_plain,
                        bucket_round_add_mxu32, acc32, table32, ids, found,
                        ctx)
