"""4-ary sparse Merkle tree: the native tree over a HashDb and the
leaf-inclusion verification gadget (the Rust reference's
`src/r1cs/gadgets/helper_constraints/sparse_merkle_tree_4_ary.rs`).  The
port's own copy of
`bulletproofs_tpu/models/helper_constraints/sparse_merkle_tree_4_ary.py`.

Per level the gadget allocates 2 index bits and selects the hidden node's
position among the 3 proof nodes with the arithmetic mux documented at
`sparse_merkle_tree_4_ary.rs:215-253`, then hashes the 4 children with
Poseidon_hash_4 constraints.
"""

from ...ops.field_host import Scalar
from ...ops.poseidon_device import poseidon_hash_4_batch
from ...r1cs.linear_combination import LinearCombination, Variable
from . import (allocated_leaf_index_to_bytes, constrain_lc_with_scalar,
               get_byte_size)
from .poseidon import (PoseidonParams, Poseidon_hash_4,
                       Poseidon_hash_4_constraints, SboxType)
from .sparse_merkle_tree import VanillaSparseMerkleTree, get_base_repr

# DBVal_4_ary = [Scalar; 4], ProofNode_4_ary = [Scalar; 3] (lists here)


def get_base_4_repr(scalar: Scalar, num_digits: int):
    """Big-endian base-4 digits of `scalar`, exactly `num_digits` of them
    (`sparse_merkle_tree_4_ary.rs:21-43`)."""
    return get_base_repr(scalar, num_digits, 4)


class VanillaSparseMerkleTree_4(VanillaSparseMerkleTree):
    """`sparse_merkle_tree_4_ary.rs:48-209`: Poseidon_hash_4 nodes."""

    arity = 4

    def _hash(self, children):
        return Poseidon_hash_4(children, self.hash_params, SboxType.Quint)

    def _hash_batch(self, child_lists, device):
        return poseidon_hash_4_batch(child_lists, self.hash_params,
                                     SboxType.Quint, device=device)


def vanilla_merkle_merkle_tree_4_verif_gadget(
        cs, depth: int, expected_root: Scalar, leaf_val, leaf_index,
        proof_nodes, statics, poseidon_params: PoseidonParams, sbox_type):
    """Leaf-inclusion constraint circuit
    (`sparse_merkle_tree_4_ary.rs:254-381`).  `proof_nodes` are consumed from
    the END, 3 per level (leaf level last)."""
    prev_hash = LinearCombination.from_var(leaf_val)
    statics = [LinearCombination.coerce(s) for s in statics]
    proof_nodes = list(proof_nodes)

    constraint_leaf_index = [(leaf_index.variable, Scalar.minus_one())]
    exp_4 = Scalar.one()
    two = Scalar(2)
    four = Scalar(4)

    leaf_index_bytes = allocated_leaf_index_to_bytes(leaf_index)

    one = Scalar.one()
    for i in range(get_byte_size(depth, 4)):
        for j in range(4):
            if not proof_nodes:
                break

            def bit_alloc(shift):
                assignment = None
                if leaf_index_bytes is not None:
                    bit = (leaf_index_bytes[i] >> shift) & 1
                    assignment = (Scalar(bit), Scalar(1 - bit))
                b, b_1, o = cs.allocate_multiplier(assignment)
                cs.constrain(LinearCombination.from_var(o))
                cs.constrain(b + (b_1 - one))
                return b, b_1

            b0, b0_1 = bit_alloc(2 * j)
            b1, b1_1 = bit_alloc(2 * j + 1)

            constraint_leaf_index.append((b1, two * exp_4))
            constraint_leaf_index.append((b0, exp_4))

            N3 = LinearCombination.from_var(proof_nodes.pop())
            N2 = LinearCombination.from_var(proof_nodes.pop())
            N1 = LinearCombination.from_var(proof_nodes.pop())

            _, _, b0_1_b1_1 = cs.multiply(LinearCombination.from_var(b0_1),
                                          LinearCombination.from_var(b1_1))
            _, _, b0_1_b1 = cs.multiply(LinearCombination.from_var(b0_1),
                                        LinearCombination.from_var(b1))
            _, _, b0_b1_1 = cs.multiply(LinearCombination.from_var(b0),
                                        LinearCombination.from_var(b1_1))
            _, _, b0_b1 = cs.multiply(LinearCombination.from_var(b0),
                                      LinearCombination.from_var(b1))

            _, _, c0_1 = cs.multiply(LinearCombination.from_var(b0_1_b1_1),
                                     prev_hash)
            _, _, c0_2 = cs.multiply(Variable.one() - b0_1_b1_1, N1)
            c0 = c0_1 + c0_2

            c1_1 = N1 - c0_2
            _, _, c1_2 = cs.multiply(LinearCombination.from_var(b0_b1_1),
                                     prev_hash)
            _, _, c1_3 = cs.multiply(LinearCombination.from_var(b1), N2)
            c1 = c1_1 + LinearCombination.from_var(c1_2) + c1_3

            c2_1 = N2 - c1_3
            _, _, c2_2 = cs.multiply(LinearCombination.from_var(b0_1_b1),
                                     prev_hash)
            _, _, c2_3 = cs.multiply(LinearCombination.from_var(b0_b1), N3)
            c2 = c2_1 + LinearCombination.from_var(c2_2) + c2_3

            _, _, c3_1 = cs.multiply(LinearCombination.from_var(b0_b1),
                                     prev_hash)
            c3_2 = N3 - c2_3
            c3 = LinearCombination.from_var(c3_1) + c3_2

            prev_hash = Poseidon_hash_4_constraints(
                cs, [LinearCombination.coerce(c0), c1, c2, c3],
                statics, poseidon_params, sbox_type)
            prev_hash = prev_hash.simplify()

            exp_4 = exp_4 * four

    cs.constrain(LinearCombination(constraint_leaf_index))
    constrain_lc_with_scalar(cs, prev_hash, expected_root)
