"""Pinocchio-style x != 0 constraint (`helper_constraints/non_zero.rs:12-32`):
x*(1-y) = 0 and x*x_inv = y with y fixed to 1.  The port's own copy of
`bulletproofs_tpu/models/helper_constraints/non_zero.py`."""

from ...ops.field_host import Scalar
from ...r1cs.linear_combination import LinearCombination, Variable


def is_nonzero_gadget(cs, x, x_inv):
    x_lc = LinearCombination.from_var(x)
    y_lc = LinearCombination([(Variable.one(), Scalar.one())])
    one_minus_y = LinearCombination.from_var(Variable.one()) - y_lc

    # x * (1 - y) = 0
    _, _, o1 = cs.multiply(x_lc, one_minus_y)
    cs.constrain(LinearCombination.from_var(o1))

    # x * x_inv = y
    inv_lc = LinearCombination([(x_inv, Scalar.one())])
    _, _, o2 = cs.multiply(x_lc, inv_lc)
    cs.constrain(o2 - y_lc)
