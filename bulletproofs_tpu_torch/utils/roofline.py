"""The H100 roofline: the port's counterpart of
`bulletproofs_tpu/utils/roofline.py`, and the one copy of the card's
speed-of-light model that chip_smoke.py's bounds read.

The model (NVIDIA H100 SXM data sheet, at its 700 W limit):
- HBM3 at 3.35 TB/s (`HBM_BYTES_PER_S`);
- 32-bit integer multiply-adds: the float32 rate of 67 TFLOP/s counts an
  FMA as 2 operations on 128 lanes an SM; an IMAD issues on 64 lanes an
  SM, so 67e12 / 2 / 2 IMADs a second (`IMAD_PER_S`);
- dense int8 tensor cores: 1979e12 operations a second, a multiply-add
  counted as 2 (`INT8_MAC_PER_S`).
The group law is bound by its Montgomery products: a CIOS product over NL
32-bit words is 2*NL^2 + NL multiply-adds, a low and a high IMAD each
(`imad_per_mont_mul`); a complete add is 12 of them for a = 0 (RCB16
algorithm 7) and 18 for a != 0 (algorithm 1, ed25519) (`mont_muls_per_add`).
Additions, subtractions, shuffles and carries are not counted, so the
speed of light is optimistic.

`roofline_report` measures the in-loop throughput of the group law and of
the product on the card: one launch of the chain kernel
(`csrc/roofline_kernels.cu`) runs `iters` dependent `ec_add_l` (or
`mont_mul_l`) steps for each of `batch` points, one group of 4 lanes a
point, the device functions the bucket kernels run.  It is the counterpart
of the JAX package's jitted `fori_loop` chains (`_ec_add_chain`,
`_mont_mul_chain`); the plain versions here are Python loops over
`ops.ec.ec_add` and `ops.field.mont_mul`.  For a CPU tensor a chain's
wrapper runs its plain version; for a CUDA tensor it launches the kernel
(`ec_kernels.launches["chain"]`) or raises.  The report itself is a
measurement of the card and raises without one.
"""

import numpy as np
import torch

from ..config import curve
from ..ops.ec import CurveCtx, ec_add, ec_dbl_plain
from ..ops.ec_kernels import _consts, _launch, _on_card, _require_contiguous
from ..ops.field import ints_to_limbs, mont_mul, pack32, unpack32

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
INT8_MAC_PER_S = 1979e12 / 2
MODEL_NOTE = ("NVIDIA H100 SXM data sheet at 700 W: 67e12 / 4 = 1.675e13 "
              "32-bit IMAD/s (an IMAD on 64 lanes an SM, float32's 128), "
              "3.35 TB/s HBM3; a CIOS product over NL words is "
              "2 (2 NL^2 + NL) IMADs, an ec_add 12 products (a = 0) or 18 "
              "(a != 0); adds, subs, shuffles and carries are not counted")


def imad_per_mont_mul(ctx: CurveCtx):
    """32-bit IMAD instructions of one CIOS Montgomery product on NL = L/2
    words: 2*NL^2 + NL multiply-adds, each a low and a high IMAD."""
    nl = ctx.fp.L // 2
    return 2 * (2 * nl * nl + nl)


def mont_muls_per_add(ctx: CurveCtx):
    """Montgomery products of one complete add: 12 (RCB16 algorithm 7,
    a = 0) or 18 (algorithm 1, a != 0)."""
    return 12 if ctx.a_is_zero else 18


def mont_muls_per_dbl(ctx: CurveCtx):
    """Montgomery products of one dedicated doubling (`ec_dbl_l`): 8 (RCB16
    algorithm 9, a = 0) or 17 (algorithm 3, a != 0, its a*(X^2 - aZ^2) as
    two products by constants)."""
    return 8 if ctx.a_is_zero else 17


def imad_per_ec_add(ctx: CurveCtx):
    return mont_muls_per_add(ctx) * imad_per_mont_mul(ctx)


def bound(n_bytes, n_imad):
    """The least time in ms the card takes for work that moves `n_bytes`
    and issues `n_imad` IMADs, and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_imad / IMAD_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else
                                 "operations")


# ---------------------------------------------------------------------------
# The chain kernel (`csrc/roofline_kernels.cu`) and its plain versions
# ---------------------------------------------------------------------------

# The chain kernel's group-law forms (`bp_ec_chain`'s `form`): the add
# acc + P or the doubling 2 acc, one group of 4 lanes a point (the bucket
# kernels' layout) or one warp a point (the lone chains' `WarpLevels`)
CHAIN_FORMS = ("add", "dbl", "add_warp", "dbl_warp")


def ec_chain_plain(P32, iters, form, ctx: CurveCtx):
    """P32 (3, NL, n) packed projective Montgomery points -> packed acc
    after acc = P, then `iters` times acc = acc + P (`ops.ec.ec_add`; forms
    "add" and "add_warp") or acc = 2 acc (`ops.ec.ec_dbl_plain`; "dbl" and
    "dbl_warp")."""
    if form not in CHAIN_FORMS:
        raise ValueError(f"ec_chain: form {form!r} not in {CHAIN_FORMS}")
    P = unpack32(P32, 1)
    acc = P
    for _ in range(iters):
        acc = ec_dbl_plain(acc, ctx) if form.startswith("dbl") \
            else ec_add(acc, P, ctx)
    return pack32(acc, 1)


def ec_add_chain_plain(P32, iters, ctx: CurveCtx):
    """`ec_chain_plain`'s "add" form: `iters` times acc = acc + P."""
    return ec_chain_plain(P32, iters, "add", ctx)


def mont_mul_chain_plain(a32, iters, ctx: CurveCtx):
    """a32 (NL, n) packed Montgomery field elements -> packed acc after
    acc = a, then `iters` times acc = acc * a (`ops.field.mont_mul`)."""
    a = unpack32(a32, 0)
    acc = a
    for _ in range(iters):
        acc = mont_mul(acc, a, ctx.fp)
    return pack32(acc, 0)


def ec_chain32(out32, P32, iters, form, ctx: CurveCtx):
    """The chain kernel's group-law form `form` (`CHAIN_FORMS`) on packed
    CUDA operands, unchecked: writes out32 (3, NL, n).  Its build follows
    the curve: an a != 0 curve runs (and counts as) algorithm 1's (and 3's
    for the doubling)."""
    _launch("bp_ec_chain", "chain", out32.data_ptr(), P32.data_ptr(),
            P32.shape[2], iters, CHAIN_FORMS.index(form), ctx.fp.L // 2,
            _consts(ctx).ctypes.data, ctx=ctx)


def ec_add_chain32(out32, P32, iters, ctx: CurveCtx):
    """`ec_chain32`'s "add" form: the roofline report's."""
    ec_chain32(out32, P32, iters, "add", ctx)


def mont_mul_chain32(out32, a32, iters, ctx: CurveCtx):
    """The chain kernel's product form on packed CUDA operands, unchecked:
    writes out32 (NL, n).  Its build depends on the width alone: an
    a != 0 curve runs (and counts as) the a = 0 build of its width."""
    _launch("bp_mont_mul_chain", "chain", out32.data_ptr(), a32.data_ptr(),
            a32.shape[1], iters, ctx.fp.L // 2, _consts(ctx).ctypes.data)


def _check_chain(name, x32, iters, shape):
    if x32.dtype != torch.int32 or tuple(x32.shape[:-1]) != shape \
            or x32.ndim != len(shape) + 1 or x32.shape[-1] == 0:
        raise ValueError(f"{name}: needs ({', '.join(map(str, shape))}, n) "
                         f"int32, n > 0, got {tuple(x32.shape)} {x32.dtype}")
    if iters < 0:
        raise ValueError(f"{name}: iters must be >= 0, got {iters}")


def ec_chain(P32, iters, form, ctx: CurveCtx):
    """The chain kernel (`bp_ec_chain`), group-law form `form`: see
    `ec_chain_plain`."""
    name = "ec_chain"
    _check_chain(name, P32, iters, (3, ctx.fp.L // 2))
    if form not in CHAIN_FORMS:
        raise ValueError(f"{name}: form {form!r} not in {CHAIN_FORMS}")
    if not _on_card(P32, name):
        return ec_chain_plain(P32, iters, form, ctx)
    _require_contiguous(name, P32)
    out = torch.empty_like(P32)
    ec_chain32(out, P32, iters, form, ctx)
    return out


def ec_add_chain(P32, iters, ctx: CurveCtx):
    """`ec_chain`'s "add" form: see `ec_add_chain_plain`."""
    return ec_chain(P32, iters, "add", ctx)


def mont_mul_chain(a32, iters, ctx: CurveCtx):
    """The chain kernel (`bp_mont_mul_chain`), product form: see
    `mont_mul_chain_plain`."""
    name = "mont_mul_chain"
    _check_chain(name, a32, iters, (ctx.fp.L // 2,))
    if not _on_card(a32, name):
        return mont_mul_chain_plain(a32, iters, ctx)
    _require_contiguous(name, a32)
    out = torch.empty_like(a32)
    mont_mul_chain32(out, a32, iters, ctx)
    return out


def chain_elements(ctx: CurveCtx, count, seed=3, device="cuda"):
    """count distinct canonical field elements mod p from a seeded numpy
    generator, packed (NL, count) int32 on `device`: random 16-bit limbs
    reduced mod p (the kernels take canonical values, so the JAX harness's
    raw limbs, which may exceed p, are reduced here)."""
    p = ctx.cv.p
    L = ctx.fp.L
    limbs = np.random.default_rng(seed).integers(0, 1 << 16, (count, L))
    vals = [int.from_bytes(row.astype("<u2").tobytes(), "little") % p
            for row in limbs]
    if len(set(vals)) != count:
        raise ValueError("chain_elements: values repeat; take another seed")
    return pack32(torch.as_tensor(ints_to_limbs(vals, L), device=device), 0)


def chain_points(ctx: CurveCtx, batch, seed=3, device="cuda"):
    """`batch` projective triples (X : Y : Z) of distinct canonical field
    elements, packed (3, NL, batch) int32 on `device`.  They are not
    points of the curve: the complete formulas are branch-free and
    data-independent, so a chain's throughput is that of curve points."""
    nl = ctx.fp.L // 2
    return chain_elements(ctx, 3 * batch, seed, device).reshape(
        nl, 3, batch).permute(1, 0, 2).contiguous()


def _kernel_seconds(launch):
    """Seconds of one launch by CUDA events, after a warm launch."""
    launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def roofline_report(ctx=None, batch=8192, iters=100, device="cuda"):
    """Measure the in-loop throughput of the complete add and of the
    Montgomery product on the card against the speed-of-light model: one
    warm launch of the chain kernel, then one timed by CUDA events, each
    over `batch` distinct canonical inputs and `iters` dependent steps.
    Returns the JAX function's keys (`limbs` is the 16-bit limb count L,
    as the JAX package reports it) and `device`, the card's name.  Raises
    for a device that is not a CUDA card: the numbers are the card's."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"roofline_report measures a CUDA card, not "
                         f"{device}")
    ctx = ctx or CurveCtx(curve())
    P32 = chain_points(ctx, batch, device=device)
    a32 = chain_elements(ctx, batch, device=device)
    out_p, out_a = torch.empty_like(P32), torch.empty_like(a32)
    t_add = _kernel_seconds(
        lambda: ec_add_chain32(out_p, P32, iters, ctx)) / iters
    t_mul = _kernel_seconds(
        lambda: mont_mul_chain32(out_a, a32, iters, ctx)) / iters
    adds_per_s = batch / t_add
    muls_per_s = batch / t_mul
    sol_adds = IMAD_PER_S / imad_per_ec_add(ctx)
    sol_muls = IMAD_PER_S / imad_per_mont_mul(ctx)
    return {
        "limbs": ctx.fp.L,
        "batch": batch,
        "ec_add_per_s": adds_per_s,
        "ec_add_speed_of_light_per_s": sol_adds,
        "ec_add_utilization": adds_per_s / sol_adds,
        "mont_mul_per_s": muls_per_s,
        "mont_mul_speed_of_light_per_s": sol_muls,
        "mont_mul_utilization": muls_per_s / sol_muls,
        "model_note": MODEL_NOTE,
        "device": torch.cuda.get_device_name(device),
    }


def chain_latency(ctx=None, iters=64, device="cuda", warm=20, reps=5):
    """The latency of one step of each chain on the card, in microseconds:
    one point (one warp) through `iters` dependent steps; `warm` launches
    first (a lone warp's short launches leave the clocks where an idle
    card keeps them), then the least of `reps` launches timed by CUDA
    events, divided by `iters`: the product (`mont_mul`), and the group
    law's forms of `CHAIN_FORMS` (the add and the dedicated doubling on one
    group of 4 lanes, the layout of the bucket kernels, whose doubling
    `ec_add_l(P, P)` takes the add's time; both on a warp, the lone
    chains' layout).  A lone chain of depth d takes at least d times
    these (PERF.md).  Raises for a device that is not a CUDA card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"chain_latency measures a CUDA card, not {device}")
    ctx = ctx or CurveCtx(curve())
    P32 = chain_points(ctx, 1, device=device)
    a32 = chain_elements(ctx, 1, device=device)
    out_p, out_a = torch.empty_like(P32), torch.empty_like(a32)
    launches = {"mont_mul": lambda: mont_mul_chain32(out_a, a32, iters, ctx)}
    for form in CHAIN_FORMS:
        launches[form] = (lambda form=form: ec_chain32(out_p, P32, iters,
                                                       form, ctx))
    for launch in launches.values():
        for _ in range(warm):
            launch()
    us = {name: min(_kernel_seconds(launch) for _ in range(reps))
          / iters * 1e6 for name, launch in launches.items()}
    return {"limbs": ctx.fp.L, "iters": iters, "us": us,
            "device": torch.cuda.get_device_name(device)}
