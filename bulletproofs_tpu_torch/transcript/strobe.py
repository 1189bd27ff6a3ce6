"""STROBE-128 lite (the port's own copy of
`bulletproofs_tpu/transcript/strobe.py`), exactly the subset merlin v1
implements (strobe128.rs in the merlin crate): `meta_AD`, `AD`, `PRF` plus
`KEY` (for transcript RNG).

Byte-exact behavior matters: every Fiat-Shamir challenge in the protocol flows
through this state machine (reference dependency `Cargo.toml:11`).  Held byte
for byte against the JAX package's copy (tests/test_torch_ipa.py).
"""

from .keccak import keccak_f1600

STROBE_R = 166  # = 200 - (2*128)/8 - 2, security 128

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


def _initial_state() -> bytearray:
    st = bytearray(200)
    st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
    st[6:18] = b"STROBEv1.0.2"
    keccak_f1600(st)
    return bytes(st)


_INIT = _initial_state()


class Strobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        self.state = bytearray(_INIT)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # ---- public ops (merlin strobe128.rs) ----
    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool):
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)

    def clone(self) -> "Strobe128":
        c = object.__new__(Strobe128)
        c.state = bytearray(self.state)
        c.pos = self.pos
        c.pos_begin = self.pos_begin
        c.cur_flags = self.cur_flags
        return c

    # ---- internals ----
    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes):
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            if self.cur_flags != flags:
                raise ValueError("strobe: cannot change flags mid-op")
            return
        if flags & FLAG_T:
            raise ValueError("strobe: transport not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()
