"""TranscriptProtocol: the Bulletproofs label schema over a merlin Transcript.

The port's own copy of `bulletproofs_tpu/transcript/protocol.py`,
byte for byte the schema of the Rust reference's `src/transcript.rs:29-61`:
domain separators, scalar/point commitments (MODBYTES big-endian scalars,
uncompressed points), and MODBYTES-wide challenge reduction mod r.
"""

import struct

from ..config import curve
from ..ops.field_host import Scalar
from .merlin import Transcript


class ProofTranscript(Transcript):
    """Transcript extended with the reference's TranscriptProtocol methods."""

    def innerproduct_domain_sep(self, n: int):
        # transcript.rs:30-33
        self.append_message(b"dom-sep", b"ipp v1")
        self.append_message(b"n", struct.pack("<Q", n))

    def r1cs_domain_sep(self):
        self.append_message(b"dom-sep", b"r1cs v1")

    def r1cs_1phase_domain_sep(self):
        self.append_message(b"dom-sep", b"r1cs-1phase")

    def r1cs_2phase_domain_sep(self):
        self.append_message(b"dom-sep", b"r1cs-2phase")

    def commit_scalar(self, label: bytes, scalar):
        # transcript.rs:47-49 — MODBYTES big-endian
        self.append_message(label, scalar.to_bytes())

    def commit_point(self, label: bytes, point):
        # transcript.rs:51-53 — uncompressed 0x04 || x || y
        self.append_message(label, point.to_bytes())

    def challenge_scalar(self, label: bytes) -> Scalar:
        # transcript.rs:55-60 — MODBYTES bytes reduced mod r
        buf = self.challenge_bytes(label, curve().modbytes)
        return Scalar.from_bytes(buf)
