"""8-ary sparse Merkle tree leaf-inclusion gadget (the Rust reference's
`src/r1cs/gadgets/sparse_merkle_tree_8_ary.rs`; the port's copy of
`bulletproofs_tpu/models/sparse_merkle_tree_8_ary.py`): the functions of
`sparse_merkle_tree.py` bound to the SMT-8 verification gadget, 7 proof
nodes per level; the gadget takes the one static, the zero-blinding ZERO
commitment (`sparse_merkle_tree_8_ary.rs:72,113`), on its own."""

from functools import partial

from .helper_constraints.sparse_merkle_tree_8_ary import (
    vanilla_merkle_merkle_tree_8_verif_gadget)
from .sparse_merkle_tree import (gen_proof_of_leaf_inclusion,
                                 prove_leaf_inclusion, verify_leaf_inclusion,
                                 verify_proof_of_leaf_inclusion)


def _gadget(cs, depth, root, leaf, leaf_index, proof_vars, statics,
            hash_params, sbox_type):
    vanilla_merkle_merkle_tree_8_verif_gadget(
        cs, depth, root, leaf, leaf_index, proof_vars, statics[0],
        hash_params, sbox_type)


prove_leaf_inclusion_8_ary_merkle_tree = partial(prove_leaf_inclusion,
                                                 _gadget)
verify_leaf_inclusion_8_ary_merkle_tree = partial(verify_leaf_inclusion,
                                                  _gadget)
gen_proof_of_leaf_inclusion_8_ary_merkle_tree = partial(
    gen_proof_of_leaf_inclusion, _gadget)
verify_proof_of_leaf_inclusion_8_ary_merkle_tree = partial(
    verify_proof_of_leaf_inclusion, _gadget)
