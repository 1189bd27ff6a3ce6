"""R1CSProof and its serialization (the Rust reference's
`src/r1cs/proof.rs:26-58`): the port's own copy of
`bulletproofs_tpu/r1cs/proof.py`, byte for byte the same layout.

T_2 is omitted: its commitment is derived from the V commitments
(t_2_blinding = <wV, v_blinding>, `prover.rs:511-513`).
"""

import json
from dataclasses import dataclass

from ..config import curve
from ..ipp import InnerProductArgumentProof
from ..ops.ec_host import G1
from ..ops.field_host import Scalar
from ..utils.errors import FormatError


@dataclass
class R1CSProof:
    A_I1: G1
    A_O1: G1
    S1: G1
    A_I2: G1
    A_O2: G1
    S2: G1
    T_1: G1
    T_3: G1
    T_4: G1
    T_5: G1
    T_6: G1
    t_x: Scalar
    t_x_blinding: Scalar
    e_blinding: Scalar
    ipp_proof: InnerProductArgumentProof

    _POINTS = ("A_I1", "A_O1", "S1", "A_I2", "A_O2", "S2",
               "T_1", "T_3", "T_4", "T_5", "T_6")
    _SCALARS = ("t_x", "t_x_blinding", "e_blinding")

    def to_bytes(self) -> bytes:
        """lg n (one byte) || 11 points || 3 scalars || L || R || a || b."""
        out = bytearray([len(self.ipp_proof.L)])
        for name in self._POINTS:
            out += getattr(self, name).to_bytes()
        for name in self._SCALARS:
            out += getattr(self, name).to_bytes()
        for pt in self.ipp_proof.L + self.ipp_proof.R:
            out += pt.to_bytes()
        out += self.ipp_proof.a.to_bytes()
        out += self.ipp_proof.b.to_bytes()
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "R1CSProof":
        cv = curve()
        pb, sb = cv.point_bytes, cv.modbytes
        try:
            lgn = data[0]
            pos = 1

            def take(n):
                nonlocal pos
                chunk = data[pos:pos + n]
                if len(chunk) != n:
                    raise FormatError("truncated proof")
                pos += n
                return chunk

            kwargs = {name: G1.from_bytes(take(pb)) for name in cls._POINTS}
            for name in cls._SCALARS:
                kwargs[name] = Scalar.from_bytes(take(sb))
            L = [G1.from_bytes(take(pb)) for _ in range(lgn)]
            R = [G1.from_bytes(take(pb)) for _ in range(lgn)]
            a = Scalar.from_bytes(take(sb))
            b = Scalar.from_bytes(take(sb))
            if pos != len(data):
                raise FormatError("trailing bytes in proof")
        except (AssertionError, IndexError) as e:
            raise FormatError(f"malformed proof encoding: {e}") from e
        return cls(ipp_proof=InnerProductArgumentProof(L=L, R=R, a=a, b=b),
                   **kwargs)

    def to_json(self) -> str:
        return json.dumps({"proof": self.to_bytes().hex(),
                           "curve": curve().name})

    @classmethod
    def from_json(cls, s: str) -> "R1CSProof":
        obj = json.loads(s)
        if obj.get("curve") != curve().name:
            raise FormatError("proof encoded for a different curve")
        return cls.from_bytes(bytes.fromhex(obj["proof"]))
