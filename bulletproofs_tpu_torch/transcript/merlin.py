"""merlin v1 transcript (byte-exact reimplementation of the `merlin` crate's
`Transcript`), the Fiat-Shamir engine behind every challenge in the protocol;
the port's own copy of `bulletproofs_tpu/transcript/merlin.py`.

API: `new(label)`, `append_message`, `append_u64`, `challenge_bytes` — the
exact surface the reference consumes (SURVEY.md section 2.1, `merlin v1`).
"""

import struct

from .strobe import Strobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


class Transcript:
    __slots__ = ("strobe",)

    def __init__(self, label: bytes):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        data_len = struct.pack("<I", len(message))
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int):
        self.append_message(label, struct.pack("<Q", x))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        data_len = struct.pack("<I", n)
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        return self.strobe.prf(n, False)

    def clone(self) -> "Transcript":
        t = object.__new__(Transcript)
        t.strobe = self.strobe.clone()
        return t
