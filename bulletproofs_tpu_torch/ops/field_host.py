"""Host scalar field F_r: the port's own copy of `Scalar` from
`bulletproofs_tpu/ops/field_host.py`, over exact Python integers.

Only what the MSM, the IPA, the R1CS prover and verifier and their tests
need is kept: construction, reduction, byte conversion, the ring operations
and the vector helpers `random_scalars`, `inner_product`,
`hadamard_product` and `batch_invert`.
"""

import hashlib
import secrets

from ..config import curve


class Scalar:
    """Element of F_r for the active (or given) curve."""

    __slots__ = ("v", "cv")

    def __init__(self, v=0, cv=None):
        self.cv = cv or curve()
        if isinstance(v, Scalar):
            v = v.v
        self.v = v % self.cv.r

    @classmethod
    def _new(cls, v, cv):
        """Fast internal constructor: `v` MUST already be reduced mod cv.r.
        Skips the coercion/validation of __init__ — the constraint-synthesis
        hot loop (LinearCombination algebra) constructs millions of these."""
        s = object.__new__(cls)
        s.v = v
        s.cv = cv
        return s

    # ---- constructors mirroring amcl_wrapper::FieldElement ----
    @classmethod
    def zero(cls, cv=None):
        return cls(0, cv)

    @classmethod
    def one(cls, cv=None):
        return cls(1, cv)

    @classmethod
    def minus_one(cls, cv=None):
        c = cv or curve()
        return cls(c.r - 1, c)

    @classmethod
    def random(cls, rng=None, cv=None):
        c = cv or curve()
        if rng is not None:
            return cls(rng.randrange(c.r), c)
        return cls(secrets.randbelow(c.r), c)

    @classmethod
    def from_bytes(cls, b, cv=None):
        """Big-endian bytes reduced mod r (amcl `FieldElement::from(&buf)`)."""
        c = cv or curve()
        return cls(int.from_bytes(b, "big") % c.r, c)

    @classmethod
    def from_msg_hash(cls, msg, cv=None):
        c = cv or curve()
        h = hashlib.shake_256(msg).digest(c.modbytes)
        return cls(int.from_bytes(h, "big") % c.r, c)

    @classmethod
    def from_hex(cls, s, cv=None):
        return cls(int(s, 16), cv)

    # ---- conversion ----
    def to_bytes(self):
        return self.v.to_bytes(self.cv.modbytes, "big")

    def __int__(self):
        return self.v

    # ---- arithmetic ----
    # Unknown operand types return NotImplemented so LinearCombination /
    # Variable reflected operators can take over (Scalar +- Variable -> LC).
    def __add__(self, o):
        v = _val(o)
        if v is NotImplemented:
            return NotImplemented
        return Scalar._new((self.v + v) % self.cv.r, self.cv)

    __radd__ = __add__

    def __sub__(self, o):
        v = _val(o)
        if v is NotImplemented:
            return NotImplemented
        return Scalar._new((self.v - v) % self.cv.r, self.cv)

    def __rsub__(self, o):
        v = _val(o)
        if v is NotImplemented:
            return NotImplemented
        return Scalar._new((v - self.v) % self.cv.r, self.cv)

    def __mul__(self, o):
        v = _val(o)
        if v is NotImplemented:
            return NotImplemented
        return Scalar._new(self.v * v % self.cv.r, self.cv)

    __rmul__ = __mul__

    def __neg__(self):
        return Scalar._new(-self.v % self.cv.r, self.cv)

    def negation(self):
        return -self

    def square(self):
        return Scalar._new(self.v * self.v % self.cv.r, self.cv)

    def inverse(self):
        return Scalar._new(pow(self.v, -1, self.cv.r), self.cv)

    def __pow__(self, e):
        return Scalar._new(pow(self.v, int(e), self.cv.r), self.cv)

    # ---- bit probing (positive_no gadget: `positive_no.rs:19-20`) ----
    def shift_right(self, i):
        return Scalar(self.v >> i, self.cv)

    def is_odd(self):
        return bool(self.v & 1)

    def is_zero(self):
        return self.v == 0

    # ---- comparisons / hashing ----
    def __eq__(self, o):
        return isinstance(o, Scalar) and self.v == o.v and self.cv.r == o.cv.r

    def __hash__(self):
        return hash((self.v, self.cv.r))

    def __repr__(self):
        return f"Scalar(0x{self.v:x})"


def _val(o):
    if isinstance(o, Scalar):
        return o.v
    if isinstance(o, int):
        return o
    return NotImplemented


def random_scalars(n, rng=None, cv=None):
    return [Scalar.random(rng, cv) for _ in range(n)]


def inner_product(a, b):
    """<a, b> over F_r. Mirrors FieldElementVector::inner_product."""
    if len(a) != len(b):
        raise ValueError("inner_product of vectors of unequal length")
    if not a:
        return Scalar.zero()
    r = a[0].cv.r
    return Scalar(sum(x.v * y.v for x, y in zip(a, b)) % r, a[0].cv)


def hadamard_product(a, b):
    if len(a) != len(b):
        raise ValueError("hadamard_product of vectors of unequal length")
    return [x * y for x, y in zip(a, b)]


def batch_invert(elems):
    """Montgomery batched inversion.

    Returns (inverses, product_of_all_inverses) -- the same pair as
    amcl_wrapper's `FieldElement::batch_invert` consumed at `ipp.rs:295`.
    """
    if not elems:
        # Empty product convention: no inverses, product == 1
        # (n == 1 IPA has zero rounds and s == [1]).
        return [], Scalar.one()
    cv = elems[0].cv
    r = cv.r
    n = len(elems)
    prefix = [1] * (n + 1)
    for i, e in enumerate(elems):
        if e.v == 0:
            raise ZeroDivisionError("batch_invert of zero")
        prefix[i + 1] = (prefix[i] * e.v) % r
    inv_all = pow(prefix[n], -1, r)
    out = [None] * n
    acc = inv_all
    for i in range(n - 1, -1, -1):
        out[i] = Scalar(acc * prefix[i], cv)
        acc = (acc * elems[i].v) % r
    return out, Scalar(inv_all, cv)
