"""Helper constraints: sub-circuits composed by the gadgets (the Rust
reference's `src/r1cs/gadgets/helper_constraints/`).  The port's own copy
of what its gadgets use from
`bulletproofs_tpu/models/helper_constraints/__init__.py`."""

from ...config import curve
from ...r1cs.linear_combination import LinearCombination


def constrain_lc_with_scalar(cs, lc, scalar):
    """lc == scalar (`helper_constraints/mod.rs:16-22`)."""
    cs.constrain(LinearCombination.coerce(lc)
                 - LinearCombination.coerce(scalar))


def get_bit_count(num_digits: int, base: int) -> int:
    """Bits of num_digits digits of a power-of-two base
    (`helper_constraints/mod.rs:36-41`)."""
    assert base & (base - 1) == 0, "base must be a power of two"
    return num_digits * (base.bit_length() - 1)


def get_byte_size(num_digits: int, base: int) -> int:
    """Bytes that hold those bits (`helper_constraints/mod.rs:25-33`)."""
    num_bits = get_bit_count(num_digits, base)
    return num_bits // 8 + (1 if num_bits % 8 else 0)


def allocated_leaf_index_to_bytes(leaf_index):
    """Little-endian MODBYTES encoding of an allocated index's assignment,
    None without one (`helper_constraints/mod.rs:43-51`: big-endian
    `tobytes`, then reversed)."""
    if leaf_index.assignment is None:
        return None
    return leaf_index.assignment.v.to_bytes(curve().modbytes, "little")
