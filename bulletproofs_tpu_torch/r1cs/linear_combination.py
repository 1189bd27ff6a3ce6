"""Variable / LinearCombination algebra (the Rust reference's
`src/r1cs/linear_combination.rs`): the port's own copy of
`bulletproofs_tpu/r1cs/linear_combination.py`.

`Variable` is a frozen (kind, index) record with the reference enum's kinds
(`linear_combination.rs:12-23`): Committed, MultiplierLeft,
MultiplierRight, MultiplierOutput, One.  A LinearCombination holds
[(Variable, int)] terms, coefficients as plain ints reduced mod the curve
order, with the +/-/* operators of `linear_combination.rs:113-237`.
"""

from dataclasses import dataclass

from ..config import curve
from ..ops.field_host import Scalar

# Variable kinds
COMMITTED = 0
MULT_LEFT = 1
MULT_RIGHT = 2
MULT_OUTPUT = 3
ONE = 4


class Variable:
    """Frozen (kind, index) record with a precomputed hash (Variables key
    dicts in the constraint-synthesis loop)."""

    __slots__ = ("kind", "index", "_h")

    def __init__(self, kind, index=0):
        self.kind = kind
        self.index = index
        self._h = hash((kind, index))

    def __eq__(self, other):
        return (isinstance(other, Variable) and other.kind == self.kind
                and other.index == self.index)

    def __hash__(self):
        return self._h

    def __repr__(self):
        return f"Variable(kind={self.kind}, index={self.index})"

    @staticmethod
    def committed(i):
        return Variable(COMMITTED, i)

    @staticmethod
    def multiplier_left(i):
        return Variable(MULT_LEFT, i)

    @staticmethod
    def multiplier_right(i):
        return Variable(MULT_RIGHT, i)

    @staticmethod
    def multiplier_output(i):
        return Variable(MULT_OUTPUT, i)

    @staticmethod
    def one():
        return ONE_VAR

    # arithmetic produces LinearCombinations
    def __add__(self, other):
        return LinearCombination.from_var(self) + other

    def __radd__(self, other):
        return _coerce(other) + LinearCombination.from_var(self)

    def __sub__(self, other):
        return LinearCombination.from_var(self) - other

    def __rsub__(self, other):
        return _coerce(other) - LinearCombination.from_var(self)

    def __mul__(self, scalar):
        return LinearCombination._new([(self, _as_int(scalar))])

    __rmul__ = __mul__

    def __neg__(self):
        return -LinearCombination.from_var(self)


ONE_VAR = Variable(ONE, 0)


@dataclass
class AllocatedQuantity:
    """`linear_combination.rs:26-29`: variable plus optional assignment."""
    variable: Variable
    assignment: object = None  # Optional[Scalar]


def _as_int(x):
    """Coefficient as a plain int reduced mod the curve order."""
    if isinstance(x, Scalar):
        return x.v
    if isinstance(x, int):
        return x % curve().r
    raise TypeError(f"cannot use {type(x)} as scalar coefficient")


def _coerce(x):
    if isinstance(x, LinearCombination):
        return x
    if isinstance(x, Variable):
        return LinearCombination.from_var(x)
    if isinstance(x, (Scalar, int)):
        return LinearCombination._new([(ONE_VAR, _as_int(x))])
    raise TypeError(f"cannot coerce {type(x)} to LinearCombination")


class LinearCombination:
    """Ordered [(Variable, coeff)] with the reference's duplicate-keeping
    semantics (`linear_combination.rs:30-111`).  Public constructors take
    Scalar or int coefficients; `.terms` holds (Variable, int)."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        if terms:
            r = curve().r
            self.terms = [
                (v, c.v if isinstance(c, Scalar) else int(c) % r)
                for v, c in terms]
        else:
            self.terms = []

    @classmethod
    def _new(cls, terms):
        """Internal constructor: terms already [(Variable, int)] with ints
        reduced mod r."""
        lc = object.__new__(cls)
        lc.terms = terms
        return lc

    @staticmethod
    def from_var(v: Variable):
        return LinearCombination._new([(v, 1)])

    @staticmethod
    def coerce(x):
        return _coerce(x)

    def simplify(self):
        """Combine duplicate variables (`linear_combination.rs:53-67`)."""
        acc = {}
        for var, coeff in self.terms:
            acc[var] = acc.get(var, 0) + coeff
        r = curve().r
        return LinearCombination._new([(v, c % r) for v, c in acc.items()])

    def __len__(self):
        return len(self.terms)

    def __add__(self, other):
        other = _coerce(other)
        return LinearCombination._new(self.terms + other.terms)

    __radd__ = __add__

    def __sub__(self, other):
        other = _coerce(other)
        r = curve().r
        return LinearCombination._new(
            self.terms + [(v, -c % r) for v, c in other.terms])

    def __rsub__(self, other):
        return _coerce(other) - self

    def __neg__(self):
        r = curve().r
        return LinearCombination._new([(v, -c % r) for v, c in self.terms])

    def __mul__(self, scalar):
        s = _as_int(scalar)
        r = curve().r
        return LinearCombination._new(
            [(v, c * s % r) for v, c in self.terms])

    __rmul__ = __mul__

    def __repr__(self):
        return f"LC({self.terms!r})"
