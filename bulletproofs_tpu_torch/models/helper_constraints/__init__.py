"""Helper constraints: sub-circuits composed by the gadgets (the Rust
reference's `src/r1cs/gadgets/helper_constraints/`).  The port's own copy
of what `bound_check` uses from
`bulletproofs_tpu/models/helper_constraints/__init__.py`."""

from ...r1cs.linear_combination import LinearCombination


def constrain_lc_with_scalar(cs, lc, scalar):
    """lc == scalar (`helper_constraints/mod.rs:16-22`)."""
    cs.constrain(LinearCombination.coerce(lc)
                 - LinearCombination.coerce(scalar))
