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

Kernel 5 computes what kernel 4 computes, with the REDC of each Montgomery
product as int8 Toeplitz dot products; nothing in the JAX package calls
its TPU kernel, and no path of the port calls it either: chip_smoke.py
races it against kernel 4.

A wrapper takes and returns the port's int64 16-bit limb tensors.  For a
tensor on the CPU it runs the plain version; for a CUDA tensor it packs the
limbs into 32-bit words, launches the kernel on PyTorch's current stream and
unpacks the result, or raises.  The `*32` functions launch a kernel on
operands already packed, so the kernel can be timed without the packing.  There is no fallback from the kernel to the
plain version.  `launches[name]` counts kernel launches, and only those.
"""

import functools

import numpy as np
import torch

from . import build
from .ec import CurveCtx, ec_add as ec_add_plain, ec_madd
from .field import mont_mul, mont_mul_mxu, mxu_tables, pack32, unpack32

launches = {"bucket_rounds_mixed": 0, "bucket_rounds_proj": 0, "ec_add": 0,
            "bucket_round_add": 0, "bucket_round_add_mxu": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _on_card(t, name, ctx):
    """True for a CUDA tensor, False for a CPU one; raises otherwise or when
    the kernels do not cover the curve (they implement a = 0)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    if not ctx.a_is_zero:
        raise NotImplementedError(
            f"{name}: the CUDA kernels cover a = 0 curves, not {ctx.cv.name}")
    return True


@functools.cache
def _consts(ctx: CurveCtx):
    """Host uint32 words [p, Montgomery one, -p^-1 mod 2^32, 3b], the
    kernels' field constants (copied into the launch's parameters)."""
    fp = ctx.fp
    nl = fp.L // 2
    words = lambda v: [(v >> (32 * k)) & 0xFFFFFFFF for k in range(nl)]
    n0inv = (-pow(fp.mod_int, -1, 1 << 32)) % (1 << 32)
    return np.array(words(fp.mod_int) + words(fp.fp.mont_one)
                    + [n0inv, ctx.b3], dtype=np.uint32)


def _launch(fn_name, key, *args):
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(build.load(), fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at launch")
    launches[key] += 1


def _check_rounds(buckets, rows, found, width, ctx):
    L = ctx.fp.L
    if buckets.dtype != torch.int64 or buckets.shape[:2] != (3, L) \
            or buckets.ndim != 3:
        raise ValueError(f"buckets must be (3, {L}, S) int64, got "
                         f"{tuple(buckets.shape)} {buckets.dtype}")
    S = buckets.shape[2]
    R_c = found.shape[0]
    if found.shape != (R_c, S) or rows.shape != (R_c * S, width * L):
        raise ValueError(f"rows {tuple(rows.shape)} / found "
                         f"{tuple(found.shape)} do not fit S = {S}")
    if rows.device != buckets.device or found.device != buckets.device:
        raise ValueError("buckets, rows and found must share a device")


def _check_round(buckets, rows, found, ctx):
    L = ctx.fp.L
    if buckets.dtype != torch.int64 or buckets.shape[:2] != (3, L) \
            or buckets.ndim != 3:
        raise ValueError(f"buckets must be (3, {L}, S) int64, got "
                         f"{tuple(buckets.shape)} {buckets.dtype}")
    S = buckets.shape[2]
    if found.shape != (S,) or rows.shape != (S, 3 * L):
        raise ValueError(f"rows {tuple(rows.shape)} / found "
                         f"{tuple(found.shape)} do not fit S = {S}")
    if rows.device != buckets.device or found.device != buckets.device:
        raise ValueError("buckets, rows and found must share a device")


def pack_rounds(buckets, rows, found):
    """The bucket-round kernels' operands in their own layout: 32-bit
    words (`pack32`), contiguous, and `found` as int32."""
    return (pack32(buckets, 1).contiguous(), pack32(rows, 1).contiguous(),
            found.to(torch.int32).contiguous())


def _require_card(key, ctx, *tensors):
    if not all(_on_card(t, key, ctx) for t in tensors):
        raise ValueError(f"{key}: packed operands must be CUDA tensors")


def _launch_rounds(fn_name, key, acc32, rows32, found32, ctx):
    """Launch one bucket-rounds kernel on packed CUDA operands; `acc32`
    (3, NL, S) is updated in place."""
    _require_card(key, ctx, acc32, rows32, found32)
    R_c, S = found32.shape
    _launch(fn_name, key, acc32.data_ptr(), rows32.data_ptr(),
            found32.data_ptr(), S, R_c, ctx.fp.L // 2,
            _consts(ctx).ctypes.data)


def bucket_rounds_mixed32(acc32, rows32, found32, ctx: CurveCtx):
    """Kernel 1 on operands already packed by `pack_rounds`."""
    _launch_rounds("bp_bucket_rounds_mixed", "bucket_rounds_mixed", acc32,
                   rows32, found32, ctx)


def bucket_rounds_proj32(acc32, rows32, found32, ctx: CurveCtx):
    """Kernel 2 on operands already packed by `pack_rounds`."""
    _launch_rounds("bp_bucket_rounds_proj", "bucket_rounds_proj", acc32,
                   rows32, found32, ctx)


def bucket_round_add32(acc32, rows32, found32, ctx: CurveCtx):
    """Kernel 4 on operands already packed by `pack_rounds`: acc32
    (3, NL, S) is updated in place by one round."""
    _require_card("bucket_round_add", ctx, acc32, rows32, found32)
    _launch("bp_bucket_round_add", "bucket_round_add", acc32.data_ptr(),
            rows32.data_ptr(), found32.data_ptr(), found32.shape[0],
            ctx.fp.L // 2, _consts(ctx).ctypes.data)


def ec_add32(P32, Q32, ctx: CurveCtx):
    """Kernel 3 on packed (3, NL, n) int32 operands -> packed P + Q."""
    _require_card("ec_add", ctx, P32, Q32)
    out = torch.empty_like(P32)
    _launch("bp_ec_add", "ec_add", out.data_ptr(), P32.data_ptr(),
            Q32.data_ptr(), P32.shape[2], ctx.fp.L // 2,
            _consts(ctx).ctypes.data)
    return out


# ---------------------------------------------------------------------------
# Kernel 1: R_c bucket rounds, affine rows, mixed add
# ---------------------------------------------------------------------------

def bucket_rounds_mixed_plain(buckets, rows, found, ctx: CurveCtx):
    """buckets (3, L, S) Montgomery accumulators; rows (R_c*S, 2L) affine
    (X, Y) rows, round-major; found (R_c, S) occupancy -> buckets after the
    R_c rounds.  Each occupied slot gets the complete mixed add (RCB16
    algorithm 8); an empty slot keeps its accumulator."""
    L = ctx.fp.L
    S = buckets.shape[2]
    acc = buckets.clone()
    for r in range(found.shape[0]):
        live = torch.nonzero(found[r]).squeeze(1)   # only these slots add
        delta = rows[r * S + live].reshape(-1, 2, L).permute(1, 2, 0)
        acc[:, :, live] = ec_madd(acc[:, :, live], delta, ctx)
    return acc


def bucket_rounds_mixed(buckets, rows, found, ctx: CurveCtx):
    """Kernel 1 (`bp_bucket_rounds_mixed`); see `bucket_rounds_mixed_plain`
    for the function it computes."""
    _check_rounds(buckets, rows, found, 2, ctx)
    if not _on_card(buckets, "bucket_rounds_mixed", ctx):
        return bucket_rounds_mixed_plain(buckets, rows, found, ctx)
    acc32, rows32, found32 = pack_rounds(buckets, rows, found)
    bucket_rounds_mixed32(acc32, rows32, found32, ctx)
    return unpack32(acc32, 1)


# ---------------------------------------------------------------------------
# Kernel 2: R_c bucket rounds, projective rows, complete add
# ---------------------------------------------------------------------------

def bucket_rounds_proj_plain(buckets, rows, found, ctx: CurveCtx):
    """buckets (3, L, S); rows (R_c*S, 3L) projective rows, round-major;
    found (R_c, S) -> buckets after R_c rounds of the complete add (RCB16
    algorithm 7).  Empty slots add the identity (0 : 1 : 0)."""
    L = ctx.fp.L
    S = buckets.shape[2]
    ident = ctx.identity_like((1,), buckets.device)
    acc = buckets
    for r in range(found.shape[0]):
        delta = rows[r * S:(r + 1) * S].reshape(S, 3, L).permute(1, 2, 0)
        delta = torch.where((found[r] != 0)[None, None], delta, ident)
        acc = ec_add_plain(acc, delta, ctx)
    return acc


def bucket_rounds_proj(buckets, rows, found, ctx: CurveCtx):
    """Kernel 2 (`bp_bucket_rounds_proj`); see `bucket_rounds_proj_plain`."""
    _check_rounds(buckets, rows, found, 3, ctx)
    if not _on_card(buckets, "bucket_rounds_proj", ctx):
        return bucket_rounds_proj_plain(buckets, rows, found, ctx)
    acc32, rows32, found32 = pack_rounds(buckets, rows, found)
    bucket_rounds_proj32(acc32, rows32, found32, ctx)
    return unpack32(acc32, 1)


# ---------------------------------------------------------------------------
# Kernel 3: batched complete add
# ---------------------------------------------------------------------------

def ec_add(P, Q, ctx: CurveCtx):
    """Kernel 3 (`bp_ec_add`): P + Q elementwise, P and Q (3, L, *batch) of
    one shape (any batch size; the kernel masks the ragged tail).  The plain
    version is `ops/ec.py:ec_add`."""
    if P.shape != Q.shape or P.shape[:2] != (3, ctx.fp.L):
        raise ValueError(f"ec_add: shapes {tuple(P.shape)} and "
                         f"{tuple(Q.shape)} must match (3, {ctx.fp.L}, ...)")
    if P.device != Q.device:
        raise ValueError("ec_add: operands on different devices")
    if not _on_card(P, "ec_add", ctx):
        return ec_add_plain(P, Q, ctx)
    n = P[0, 0].numel()
    if n == 0:
        return torch.empty_like(P)
    out = ec_add32(pack32(P.reshape(3, ctx.fp.L, n), 1).contiguous(),
                   pack32(Q.reshape(3, ctx.fp.L, n), 1).contiguous(), ctx)
    return unpack32(out, 1).reshape(P.shape)


# ---------------------------------------------------------------------------
# Kernel 4: one bucket round, projective rows, complete add
# ---------------------------------------------------------------------------

def bucket_round_add_plain(buckets, rows, found, ctx: CurveCtx,
                           mul=mont_mul):
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


def bucket_round_add(buckets, rows, found, ctx: CurveCtx):
    """Kernel 4 (`bp_bucket_round_add`); see `bucket_round_add_plain`."""
    _check_round(buckets, rows, found, ctx)
    if not _on_card(buckets, "bucket_round_add", ctx):
        return bucket_round_add_plain(buckets, rows, found, ctx)
    acc32, rows32, found32 = pack_rounds(buckets, rows, found)
    bucket_round_add32(acc32, rows32, found32, ctx)
    return unpack32(acc32, 1)


# ---------------------------------------------------------------------------
# Kernel 5: one bucket round, the REDC products as int8 Toeplitz products
# ---------------------------------------------------------------------------

def _mxu_words(ctx: CurveCtx):
    """Kernel 5's tables as uint32 words, the layout of
    `csrc/mxu_kernels.cu`: the N' and N tables (int8 entries, 4 a word,
    little-endian), their int32 row constants, then the modulus words."""
    (tm, cm), (tn, cn) = mxu_tables(ctx.fp)
    words = lambda t: np.ascontiguousarray(t).view(np.uint8).view("<u4")
    nl = ctx.fp.L // 2
    return np.concatenate([words(tm).ravel(), words(tn).ravel(),
                           cm.ravel().view(np.uint32),
                           cn.ravel().view(np.uint32), _consts(ctx)[:nl]])


_mxu_device = {}


def _mxu_tables_on(ctx: CurveCtx, device):
    """`_mxu_words` on `device`, made once per curve and card."""
    key = (ctx.cv.name, str(device))
    if key not in _mxu_device:
        _mxu_device[key] = torch.as_tensor(
            _mxu_words(ctx).view(np.int32), device=device)
    return _mxu_device[key]


def bucket_round_add_mxu_plain(buckets, rows, found, ctx: CurveCtx):
    """`bucket_round_add_plain` with every Montgomery product through
    `field.mont_mul_mxu` (separated REDC, the fixed-operand halves as
    Toeplitz products in int64): the same limbs, the function of
    `ec_pallas._round_kernel_mxu`."""
    return bucket_round_add_plain(buckets, rows, found, ctx,
                                  mul=mont_mul_mxu)


def bucket_round_add_mxu32(acc32, rows32, found32, ctx: CurveCtx):
    """Kernel 5 on operands already packed by `pack_rounds`: acc32
    (3, NL, S) is updated in place by one round."""
    _require_card("bucket_round_add_mxu", ctx, acc32, rows32, found32)
    tables = _mxu_tables_on(ctx, acc32.device)
    _launch("bp_bucket_round_add_mxu", "bucket_round_add_mxu",
            acc32.data_ptr(), rows32.data_ptr(), found32.data_ptr(),
            found32.shape[0], ctx.fp.L // 2, _consts(ctx).ctypes.data,
            tables.data_ptr())


def bucket_round_add_mxu(buckets, rows, found, ctx: CurveCtx):
    """Kernel 5 (`bp_bucket_round_add_mxu`); see
    `bucket_round_add_mxu_plain`."""
    _check_round(buckets, rows, found, ctx)
    if not _on_card(buckets, "bucket_round_add_mxu", ctx):
        return bucket_round_add_mxu_plain(buckets, rows, found, ctx)
    acc32, rows32, found32 = pack_rounds(buckets, rows, found)
    bucket_round_add_mxu32(acc32, rows32, found32, ctx)
    return unpack32(acc32, 1)
