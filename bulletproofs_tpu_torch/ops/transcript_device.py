"""The merlin/STROBE-128 transcript on tensors: the port of
`bulletproofs_tpu/ops/transcript_device.py`.

The host transcript (`transcript/{strobe,merlin,protocol}.py`) needs the
device's L and R bytes on the host every IPA round.  This module runs the
same byte-exact STROBE-128 state machine on a (200,) tensor, so a round's
Fiat-Shamir step stays on the device.

The STROBE position registers (pos, pos_begin, cur_flags) depend only on
the schedule of operations (labels and lengths), never on the absorbed
data, so they stay Python ints: every state update is an XOR into a static
slice, and only the absorbed bytes and the keccak permutations are tensor
work.  `replay_positions` gives the registers after a schedule without
touching a state.

These functions are the plain version of the `bp_ipa_challenge` kernel
(`ops/transcript_kernels.py`), which runs one IPA round of them in one
launch; the fused IPA (`ops/prover_device.py: create_ipp_implicit_fused`)
launches the kernel.  Byte-exact against the host `ProofTranscript` and
the JAX package's `DeviceTranscript` (tests/test_torch_transcript_device.py).
"""

import struct

import numpy as np
import torch

from ..transcript.strobe import (FLAG_A, FLAG_C, FLAG_I, FLAG_K, FLAG_M,
                                 FLAG_T, STROBE_R)
from . import field as fd
from .keccak import keccak_f1600_device

I64 = torch.int64


def _bytes_on(data: bytes, device):
    return torch.as_tensor(np.frombuffer(data, np.uint8).astype(np.int64),
                           device=device)


class _Registers:
    """The STROBE position registers and the schedule logic of
    `transcript/strobe.py`, op for op, with no state: the dry replay of
    `schedule_positions`, and the base of `DeviceStrobe`, which adds the
    state's updates."""

    def __init__(self, pos, pos_begin, cur_flags):
        self.pos = pos
        self.pos_begin = pos_begin
        self.cur_flags = cur_flags

    def regs(self):
        return self.pos, self.pos_begin, self.cur_flags

    def _run_f(self):
        self.pos = 0
        self.pos_begin = 0

    def _walk(self, k, span=None):
        """k bytes absorbed or squeezed: span(start, stop, i) for each run
        of state positions that bytes i.. touch, keccak-f at the rate."""
        i = 0
        while i < k:
            take = min(k - i, STROBE_R - self.pos)
            if span is not None:
                span(self.pos, self.pos + take, i)
            self.pos += take
            i += take
            if self.pos == STROBE_R:
                self._run_f()

    def _absorb_const(self, data: bytes):
        self._walk(len(data))

    def begin_op(self, flags: int, more: bool):
        if more:
            if self.cur_flags != flags:
                raise ValueError("strobe: cannot change flags mid-op")
            return
        if flags & FLAG_T:
            raise ValueError("strobe: transport not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb_const(bytes([old_begin, flags]))
        if flags & (FLAG_C | FLAG_K) and self.pos != 0:
            self._run_f()


class DeviceStrobe(_Registers):
    """STROBE-128 over a (200,) int64 byte-valued state tensor `st`; the
    registers are Python ints.  Mirrors `transcript/strobe.py` op for op."""

    def __init__(self, state, pos, pos_begin, cur_flags):
        super().__init__(pos, pos_begin, cur_flags)
        self.st = state

    # ---- merlin surface ----
    def meta_ad_const(self, data: bytes, more: bool):
        self.begin_op(FLAG_M | FLAG_A, more)
        self._absorb_const(data)

    def ad_const(self, data: bytes, more: bool):
        self.begin_op(FLAG_A, more)
        self._absorb_const(data)

    def ad_var(self, dev_bytes, more: bool):
        """dev_bytes: (k,) int64 byte values."""
        self.begin_op(FLAG_A, more)
        self._xor_in(dev_bytes)

    def prf(self, n: int, more: bool):
        self.begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        outs = []

        def squeeze(start, stop, i):
            outs.append(self.st[start:stop].clone())
            self.st = self.st.clone()
            self.st[start:stop] = 0
        self._walk(n, squeeze)
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    # ---- internals (the host's order of state updates) ----
    def _run_f(self):
        st = self.st.clone()
        st[self.pos] ^= self.pos_begin
        st[self.pos + 1] ^= 0x04
        st[STROBE_R + 1] ^= 0x80
        self.st = keccak_f1600_device(st)
        super()._run_f()

    def _xor_in(self, dev_bytes):
        def xor(start, stop, i):
            self.st = self.st.clone()
            self.st[start:stop] ^= dev_bytes[i:i + stop - start]
        self._walk(int(dev_bytes.shape[0]), xor)

    def _absorb_const(self, data: bytes):
        self._xor_in(_bytes_on(data, self.st.device))


class DeviceTranscript:
    """merlin v1 and the Bulletproofs TranscriptProtocol over a
    `DeviceStrobe`.  Start it from a host `ProofTranscript`'s `snapshot`;
    `writeback` puts the device state into a host transcript that then
    continues byte-identically."""

    def __init__(self, strobe: DeviceStrobe):
        self.strobe = strobe

    @staticmethod
    def snapshot(host_transcript):
        """Host ProofTranscript -> (state (200,) int64 numpy byte values,
        pos, pos_begin, cur_flags)."""
        s = host_transcript.strobe
        return (np.frombuffer(bytes(s.state), np.uint8).astype(np.int64),
                s.pos, s.pos_begin, s.cur_flags)

    @classmethod
    def from_snapshot(cls, state, pos, pos_begin, cur_flags):
        return cls(DeviceStrobe(state, pos, pos_begin, cur_flags))

    @staticmethod
    def writeback(host_transcript, final_state, pos, pos_begin, cur_flags):
        """Overwrite a host transcript's strobe with a device state (numpy
        or tensor byte values) and the registers of `replay_positions`."""
        if isinstance(final_state, torch.Tensor):
            final_state = final_state.cpu().numpy()
        s = host_transcript.strobe
        s.state = bytearray(np.asarray(final_state).astype(np.uint8)
                            .tobytes())
        s.pos = pos
        s.pos_begin = pos_begin
        s.cur_flags = cur_flags

    # ---- merlin ----
    def append_message_var(self, label: bytes, dev_bytes):
        """append_message with device message bytes (k,) int64."""
        self.strobe.meta_ad_const(label, False)
        self.strobe.meta_ad_const(struct.pack("<I", dev_bytes.shape[0]),
                                  True)
        self.strobe.ad_var(dev_bytes, False)

    def append_message_const(self, label: bytes, message: bytes):
        self.strobe.meta_ad_const(label, False)
        self.strobe.meta_ad_const(struct.pack("<I", len(message)), True)
        self.strobe.ad_const(message, False)

    def challenge_bytes(self, label: bytes, n: int):
        self.strobe.meta_ad_const(label, False)
        self.strobe.meta_ad_const(struct.pack("<I", n), True)
        return self.strobe.prf(n, False)

    # ---- TranscriptProtocol (transcript/protocol.py) ----
    def commit_point_bytes(self, label: bytes, pt_bytes):
        """pt_bytes: (2*modbytes + 1,) int64 from `serialize_points`."""
        self.append_message_var(label, pt_bytes)

    def challenge_scalar_mont(self, label: bytes, ctx):
        """modbytes challenge bytes reduced mod r, in Montgomery form
        (Lr, 1): `protocol.py: challenge_scalar` on the device."""
        return reduce_bytes_mod_r(
            self.challenge_bytes(label, ctx.cv.modbytes), ctx)


# ---------------------------------------------------------------------------
# Byte codecs (device counterparts of G1.to_bytes and Scalar.from_bytes)
# ---------------------------------------------------------------------------

_pow_tables = {}


def _byte_pow_table(ctx, device):
    """(Lr, mb) Montgomery constants 256^(mb-1-i) * R mod r: the product of
    plain byte i with column i is byte * 256^(mb-1-i) mod r, plain."""
    key = (ctx.cv.name, str(device))
    if key not in _pow_tables:
        r, mb = ctx.cv.r, ctx.cv.modbytes
        R = 1 << (16 * ctx.fr.L)
        vals = [pow(256, mb - 1 - i, r) * R % r for i in range(mb)]
        _pow_tables[key] = torch.as_tensor(fd.ints_to_limbs(vals, ctx.fr.L),
                                           device=device)
    return _pow_tables[key]


def reduce_bytes_mod_r(raw_bytes, ctx):
    """(mb,) int64 big-endian byte values -> (Lr, 1) Montgomery scalar mod
    r, the `Scalar.from_bytes` reduction: byte-weighted products, a halving
    tree of modular adds, then to Montgomery form."""
    fr = ctx.fr
    mb = int(raw_bytes.shape[0])
    bl = torch.cat([raw_bytes[None], raw_bytes.new_zeros((fr.L - 1, mb))])
    acc = fd.mont_mul(bl, _byte_pow_table(ctx, raw_bytes.device), fr)
    m = mb
    while m > 1:
        half = (m + 1) // 2
        right = acc[:, half:m]
        if right.shape[1] < half:
            right = torch.cat([right, right.new_zeros((fr.L, 1))], dim=1)
        acc = fd.add_mod(acc[:, :half], right, fr)
        m = half
    return fd.to_mont(acc, fr)


def _limb_byte_plan(ctx):
    """Big-endian byte j of an Fp element -> (16-bit limb index, shift,
    whether the limb exists)."""
    mb, L = ctx.cv.modbytes, ctx.fp.L
    pos = mb - 1 - np.arange(mb)                   # little-endian byte no.
    li = pos // 2
    return np.minimum(li, L - 1), 8 * (pos % 2), li < L


def serialize_points(pts_mont, ctx):
    """(3, L, k) Montgomery projective points -> (k, 2*mb + 1) int64 bytes,
    exactly `G1.to_bytes`: 0x04 || x_be || y_be, the identity as (0, 1).
    One batched Fermat inversion of Z (0 stays 0)."""
    if ctx.cv.ed_d is not None:
        raise ValueError("serialize_points emits Weierstrass bytes; "
                         f"{ctx.cv.name} serializes Edwards coordinates "
                         "and takes the host transcript")
    fp = ctx.fp
    X, Y, Z = pts_mont[0], pts_mont[1], pts_mont[2]
    z_inv = fd.inv_mont(Z, fp)
    xy = fd.from_mont(fd.mont_mul(torch.stack([X, Y], dim=1),
                                  z_inv[:, None], fp), fp)   # (L, 2, k)
    is_id = (Z == 0).all(dim=0)
    one = torch.zeros_like(xy[:, 1])
    one[0] = 1
    x_p = torch.where(is_id, 0, xy[:, 0])
    y_p = torch.where(is_id, one, xy[:, 1])
    idx, sh, valid = (torch.as_tensor(a, device=pts_mont.device)
                      for a in _limb_byte_plan(ctx))

    def to_be(limbs):
        return torch.where(valid[:, None], (limbs[idx] >> sh[:, None]) & 0xFF,
                           0)                      # (mb, k)

    four = torch.full((1, X.shape[1]), 4, dtype=I64, device=X.device)
    return torch.cat([four, to_be(x_p), to_be(y_p)], dim=0).T


def replay_positions(host_transcript, schedule):
    """The (pos, pos_begin, cur_flags) after an op schedule run from a host
    transcript's registers, without touching its state: the data-independent
    half of a device run, for `DeviceTranscript.writeback`.

    schedule: list of ("msg", label, length) | ("challenge", label,
    length)."""
    s = host_transcript.strobe
    return schedule_positions((s.pos, s.pos_begin, s.cur_flags), schedule)


def schedule_positions(regs, schedule):
    """`replay_positions` from a (pos, pos_begin, cur_flags) triple."""
    r = _Registers(*regs)
    for kind, label, length in schedule:
        r.begin_op(FLAG_M | FLAG_A, False)
        r._walk(len(label))
        r.begin_op(FLAG_M | FLAG_A, True)
        r._walk(4)
        r.begin_op(FLAG_A if kind == "msg" else FLAG_I | FLAG_A | FLAG_C,
                   False)
        r._walk(length)
    return r.regs()
