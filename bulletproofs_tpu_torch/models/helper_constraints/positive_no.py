"""Binary-decomposition range constraint (`helper_constraints/
positive_no.rs`): v in [0, 2^n).  The port's own copy of
`bulletproofs_tpu/models/helper_constraints/positive_no.py`."""

from ...ops.field_host import Scalar
from ...r1cs.linear_combination import ONE_VAR, LinearCombination


def positive_no_gadget(cs, v, n: int):
    """n bit gadgets plus sum(b_i * 2^i) == v, with the constraints and
    their order of the reference loop (`positive_no.rs:8-40`)."""
    one = Scalar.one()
    zero = Scalar.zero()
    r = one.cv.r
    minus_1 = r - 1
    constraint_v = [(v.variable, minus_1)]
    av = v.assignment.v if v.assignment is not None else None
    for i in range(n):
        assignment = None
        if av is not None:
            assignment = (zero, one) if (av >> i) & 1 else (one, zero)
        a, b, o = cs.allocate_multiplier(assignment)

        # a * b = 0
        cs.constrain(LinearCombination.from_var(o))
        # a = 1 - b  (the terms of `a + (b - one)`)
        cs.constrain(LinearCombination._new(
            [(a, 1), (b, 1), (ONE_VAR, minus_1)]))

        constraint_v.append((b, (1 << i) % r))

    # -v + sum(b_i * 2^i) = 0
    cs.constrain(LinearCombination._new(constraint_v))
