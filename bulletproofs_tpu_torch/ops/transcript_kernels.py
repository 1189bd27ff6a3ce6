"""The fused IPA's Fiat-Shamir kernel (`csrc/transcript_kernels.cu`
`bp_ipa_challenge`): its wrapper, its plain PyTorch version and its launch
count (`ec_kernels.launches["ipa_challenge"]`).

One launch does one IPA round's transcript step on the device: serialize
the round's combined points L and R, absorb them into the STROBE state,
squeeze the challenge u, reduce it mod r and invert it.  It replaces no
Pallas kernel: the JAX package runs these steps as XLA code inside its
fused IPA program (`bulletproofs_tpu/ops/transcript_device.py`,
`ops/keccak_jax.py`).  The plain version is the port of those functions
(`ops/transcript_device.py`, `ops/keccak.py`), composed; as a torch
program it would be thousands of launches a round.

For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches the kernel, or raises (no fallback).  `ipa_challenge_split`
launches the kernel's timed form (`bp_ipa_challenge_timed`, the same
kernel writing lane 0's clock stamps) for the split of its time; it is a
measurement, not counted in `launches`.
"""

import functools

import numpy as np
import torch

from . import build, field as fd
from .ec import CurveCtx
from .ec_kernels import _launch, _on_card, _require_contiguous
from .field import unpack32
from .transcript_device import DeviceTranscript, schedule_positions, \
    serialize_points


def round_schedule(ctx: CurveCtx):
    """One IPA round's transcript ops (`replay_positions` form): commit L,
    commit R (2*mb + 1 bytes each), challenge u (mb bytes)."""
    mb = ctx.cv.modbytes
    return [("msg", b"L", 2 * mb + 1), ("msg", b"R", 2 * mb + 1),
            ("challenge", b"u", mb)]


def round_registers(regs, ctx: CurveCtx):
    """The STROBE registers after one IPA round started at `regs`."""
    return schedule_positions(regs, round_schedule(ctx))


def ipa_challenge_plain(pts32, state, regs, ctx: CurveCtx):
    """pts32 (3, NL, 2) packed projective Montgomery points L and R;
    state (200,) int64 byte values; regs the round's starting (pos,
    pos_begin, cur_flags) -> (L and R bytes (2, 2*mb + 1) int64, the new
    state (200,) int64, u and u^-1 in Montgomery form (2, Lr, 1) int64).
    The transcript ops of one IPA round (`transcript.rs:51-60`):
    commit_point L, commit_point R, challenge_scalar u."""
    pb = serialize_points(unpack32(pts32, 1), ctx)
    t = DeviceTranscript.from_snapshot(state, *regs)
    t.commit_point_bytes(b"L", pb[0])
    t.commit_point_bytes(b"R", pb[1])
    u_m = t.challenge_scalar_mont(b"u", ctx)
    return pb, t.strobe.st, torch.stack([u_m, fd.inv_mont(u_m, ctx.fr)])


@functools.cache
def _kernel_consts(fctx):
    """Host uint32 words [m, R mod m, -m^-1 mod 2^32, 0, R^2 mod m,
    R^3 mod m] of one field (Fp or Fr): the kernel's constants, R^3 for
    its inversions' return to Montgomery form."""
    m = fctx.mod_int
    nl = fctx.L // 2
    words = lambda v: [(v >> (32 * k)) & 0xFFFFFFFF for k in range(nl)]
    n0inv = (-pow(m, -1, 1 << 32)) % (1 << 32)
    r3 = fctx.fp.mont_r2 * fctx.fp.mont_one % m
    return np.array(words(m) + words(fctx.fp.mont_one) + [n0inv, 0]
                    + words(fctx.fp.mont_r2) + words(r3), dtype=np.uint32)


def _operands(out_bytes, out_state, out_u, pts32, state, regs, ctx):
    return (out_bytes.data_ptr(), out_state.data_ptr(), out_u.data_ptr(),
            pts32.data_ptr(), state.data_ptr(), regs[0], regs[1],
            ctx.fp.L // 2, ctx.fr.L // 2, ctx.cv.modbytes,
            _kernel_consts(ctx.fp).ctypes.data,
            _kernel_consts(ctx.fr).ctypes.data)


def ipa_challenge32(out_bytes, out_state, out_u, pts32, state, regs,
                    ctx: CurveCtx):
    """The kernel on CUDA operands, unchecked: writes out_bytes (2, PB),
    out_state (200,) and out_u (2, Lr, 1), all int64."""
    _launch("bp_ipa_challenge", "ipa_challenge",
            *_operands(out_bytes, out_state, out_u, pts32, state, regs, ctx))


# the spans between the kernel's clock64() stamps (`bp_ipa_challenge_timed`)
SPLIT = ("fp_inversion", "serialize", "absorb_keccak_squeeze", "reduce_u",
         "fr_inversion", "write_u")


def ipa_challenge_split(out_bytes, out_state, out_u, pts32, state, regs,
                        ctx: CurveCtx):
    """One launch of the kernel's timed form on CUDA operands, for
    measurement only (not counted in `launches`): -> lane 0's clock
    cycles in each span of `SPLIT`."""
    stamps = torch.zeros(7, dtype=torch.int64, device=pts32.device)
    stream = torch.cuda.current_stream().cuda_stream
    rc = build.load().bp_ipa_challenge_timed(
        *_operands(out_bytes, out_state, out_u, pts32, state, regs, ctx),
        stamps.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"bp_ipa_challenge_timed: CUDA error {rc} at "
                           "launch")
    t = stamps.tolist()
    return dict(zip(SPLIT, (b - a for a, b in zip(t, t[1:]))))


def ipa_challenge(pts32, state, regs, ctx: CurveCtx):
    """Kernel `bp_ipa_challenge`: one IPA round's Fiat-Shamir step; see
    `ipa_challenge_plain` for the operands and results."""
    name = "ipa_challenge"
    nl = ctx.fp.L // 2
    if pts32.dtype != torch.int32 or tuple(pts32.shape) != (3, nl, 2):
        raise ValueError(f"{name}: points must be (3, {nl}, 2) int32, got "
                         f"{tuple(pts32.shape)} {pts32.dtype}")
    if state.dtype != torch.int64 or tuple(state.shape) != (200,):
        raise ValueError(f"{name}: state must be (200,) int64, got "
                         f"{tuple(state.shape)} {state.dtype}")
    if state.device != pts32.device:
        raise ValueError(f"{name}: operands on different devices")
    if ctx.cv.ed_d is not None:
        raise ValueError(f"{name}: {ctx.cv.name} serializes Edwards "
                         "coordinates")
    if not _on_card(pts32, name):
        return ipa_challenge_plain(pts32, state, regs, ctx)
    _require_contiguous(name, pts32, state)
    dev = pts32.device
    out_bytes = torch.empty((2, 2 * ctx.cv.modbytes + 1), dtype=torch.int64,
                            device=dev)
    out_state = torch.empty(200, dtype=torch.int64, device=dev)
    out_u = torch.empty((2, ctx.fr.L, 1), dtype=torch.int64, device=dev)
    ipa_challenge32(out_bytes, out_state, out_u, pts32, state, regs, ctx)
    return out_bytes, out_state, out_u

