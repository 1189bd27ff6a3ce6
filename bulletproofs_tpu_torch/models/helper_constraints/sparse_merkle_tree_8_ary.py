"""8-ary sparse Merkle tree: the native tree over a HashDb and the
leaf-inclusion verification gadget (the Rust reference's
`src/r1cs/gadgets/helper_constraints/sparse_merkle_tree_8_ary.rs`).  The
port's own copy of
`bulletproofs_tpu/models/helper_constraints/sparse_merkle_tree_8_ary.py`.

Per level: 3 index bits and a one-of-8 arithmetic mux (the algebra is
documented at `sparse_merkle_tree_8_ary.rs:227-277`; shared sub-products are
reused so several c_i terms come free as N_i minus an existing product),
then Poseidon_hash_8 constraints (width 9).
"""

from ...ops.field_host import Scalar
from ...ops.poseidon_device import poseidon_hash_8_batch
from ...r1cs.linear_combination import LinearCombination, Variable
from . import constrain_lc_with_scalar, get_bit_count
from .poseidon import (PoseidonParams, Poseidon_hash_8,
                       Poseidon_hash_8_constraints, SboxType)
from .sparse_merkle_tree import VanillaSparseMerkleTree, get_base_repr

ARITY = 8


def get_base_8_repr(scalar: Scalar, num_digits: int):
    """Big-endian base-8 digits (`sparse_merkle_tree_8_ary.rs:23-45`)."""
    return get_base_repr(scalar, num_digits, ARITY)


class VanillaSparseMerkleTree_8(VanillaSparseMerkleTree):
    """`sparse_merkle_tree_8_ary.rs:48-225`: Poseidon_hash_8 nodes."""

    arity = ARITY

    def _hash(self, children):
        return Poseidon_hash_8(children, self.hash_params, SboxType.Quint)

    def _hash_batch(self, child_lists, device):
        return poseidon_hash_8_batch(child_lists, self.hash_params,
                                     SboxType.Quint, device=device)


def vanilla_merkle_merkle_tree_8_verif_gadget(
        cs, depth: int, expected_root: Scalar, leaf_val, leaf_index,
        proof_nodes, zero, poseidon_params: PoseidonParams, sbox_type):
    """`sparse_merkle_tree_8_ary.rs:278-487`"""
    prev_hash = LinearCombination.from_var(leaf_val)
    proof_nodes = list(proof_nodes)
    zero_lc = LinearCombination.coerce(zero)

    constraint_leaf_index = [(leaf_index.variable, Scalar.minus_one())]
    exp_8 = Scalar.one()
    two, four, eight = Scalar(2), Scalar(4), Scalar(8)
    one = Scalar.one()

    octets = None
    if leaf_index.assignment is not None:
        octets = get_base_8_repr(leaf_index.assignment, depth)
        octets.reverse()                       # LSB-first

    def fv(v):
        return LinearCombination.from_var(v)

    for i in range(0, get_bit_count(depth, 8), 3):
        if not proof_nodes:
            break

        def bit_alloc(shift):
            assignment = None
            if octets is not None:
                bit = (octets[i // 3] >> shift) & 1
                assignment = (Scalar(bit), Scalar(1 - bit))
            b, b_1, o = cs.allocate_multiplier(assignment)
            cs.constrain(fv(o))
            cs.constrain(b + (b_1 - one))
            return b, b_1

        b0, b0_1 = bit_alloc(0)
        b1, b1_1 = bit_alloc(1)
        b2, b2_1 = bit_alloc(2)

        constraint_leaf_index.append((b0, exp_8))
        constraint_leaf_index.append((b1, two * exp_8))
        constraint_leaf_index.append((b2, four * exp_8))

        N7 = fv(proof_nodes.pop())
        N6 = fv(proof_nodes.pop())
        N5 = fv(proof_nodes.pop())
        N4 = fv(proof_nodes.pop())
        N3 = fv(proof_nodes.pop())
        N2 = fv(proof_nodes.pop())
        N1 = fv(proof_nodes.pop())

        _, _, b0_1_b1_1 = cs.multiply(fv(b0_1), fv(b1_1))
        _, _, b1_1_b2_1 = cs.multiply(fv(b1_1), fv(b2_1))
        _, _, b0_b1 = cs.multiply(fv(b0), fv(b1))
        _, _, b1_b2 = cs.multiply(fv(b1), fv(b2))
        _, _, b0_b1_b2 = cs.multiply(fv(b0_b1), fv(b2))
        _, _, b0_1_b1_1_b2_1 = cs.multiply(fv(b0_1_b1_1), fv(b2_1))
        _, _, b01_1_b2_1 = cs.multiply(Variable.one() - b0_b1, fv(b2_1))

        _, _, c0_1 = cs.multiply(fv(b0_1_b1_1_b2_1), prev_hash)
        _, _, c0_2 = cs.multiply(Variable.one() - b0_1_b1_1_b2_1, N1)
        c0 = c0_1 + c0_2

        _, _, c1_1 = cs.multiply(Variable.one() - b1_1_b2_1, N2)
        _, _, c1_2 = cs.multiply(fv(b1_1_b2_1), fv(b0))
        _, _, c1_3 = cs.multiply(fv(c1_2), prev_hash)
        c1_4 = N1 - c0_2
        c1 = c1_1 + c1_3 + c1_4

        c2_1 = N2 - c1_1
        _, _, c2_2 = cs.multiply(fv(b0_1), fv(b2_1))
        _, _, c2_3 = cs.multiply(fv(c2_2), fv(b1))
        _, _, c2_4 = cs.multiply(fv(c2_3), prev_hash)
        _, _, c2_5 = cs.multiply(Variable.one() - b01_1_b2_1, N3)
        c2 = c2_1 + fv(c2_4) + c2_5

        c3_1 = N3 - c2_5
        _, _, c3_2 = cs.multiply(fv(b2_1), fv(b0_b1))
        _, _, c3_3 = cs.multiply(fv(c3_2), prev_hash)
        _, _, c3_4 = cs.multiply(fv(b2), N4)
        c3 = c3_1 + fv(c3_3) + c3_4

        c4_1 = N4 - c3_4
        _, _, c4_2 = cs.multiply(fv(b2), fv(b0_1_b1_1))
        _, _, c4_3 = cs.multiply(fv(c4_2), prev_hash)
        _, _, c4_4 = cs.multiply(fv(b2), Variable.one() - b0_1_b1_1)
        _, _, c4_5 = cs.multiply(fv(c4_4), N5)
        c4 = c4_1 + fv(c4_3) + c4_5

        c5_1 = N5 - c4_5
        _, _, c5_2 = cs.multiply(fv(b1_b2), N6)
        _, _, c5_3 = cs.multiply(fv(b2), fv(b1_1))
        _, _, c5_4 = cs.multiply(fv(c5_3), fv(b0))
        _, _, c5_5 = cs.multiply(fv(c5_4), prev_hash)
        c5 = c5_1 + c5_2 + fv(c5_5)

        _, _, c6_1 = cs.multiply(fv(b0_b1_b2), N7)
        _, _, c6_2 = cs.multiply(fv(b1_b2), fv(b0_1))
        _, _, c6_3 = cs.multiply(fv(c6_2), prev_hash)
        c6_4 = N6 - c5_2
        c6 = fv(c6_1) + fv(c6_3) + c6_4

        _, _, c7_1 = cs.multiply(fv(b0_b1_b2), prev_hash)
        c7_2 = N7 - c6_1
        c7 = fv(c7_1) + c7_2

        prev_hash = Poseidon_hash_8_constraints(
            cs, [LinearCombination.coerce(c)
                 for c in (c0, c1, c2, c3, c4, c5, c6, c7)],
            zero_lc, poseidon_params, sbox_type)
        prev_hash = prev_hash.simplify()

        exp_8 = exp_8 * eight

    cs.constrain(LinearCombination(constraint_leaf_index))
    constrain_lc_with_scalar(cs, prev_hash, expected_root)
