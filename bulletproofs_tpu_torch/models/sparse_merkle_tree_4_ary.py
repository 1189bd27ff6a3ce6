"""4-ary sparse Merkle tree leaf-inclusion gadget (the Rust reference's
`src/r1cs/gadgets/sparse_merkle_tree_4_ary.rs`; the port's copy of
`bulletproofs_tpu/models/sparse_merkle_tree_4_ary.py`): the functions of
`sparse_merkle_tree.py` bound to the SMT-4 verification gadget, 3 proof
nodes per level."""

from functools import partial

from .helper_constraints.sparse_merkle_tree_4_ary import (
    vanilla_merkle_merkle_tree_4_verif_gadget as _gadget)
from .sparse_merkle_tree import (gen_proof_of_leaf_inclusion,
                                 prove_leaf_inclusion, verify_leaf_inclusion,
                                 verify_proof_of_leaf_inclusion)

prove_leaf_inclusion_4_ary_merkle_tree = partial(prove_leaf_inclusion,
                                                 _gadget)
verify_leaf_inclusion_4_ary_merkle_tree = partial(verify_leaf_inclusion,
                                                  _gadget)
gen_proof_of_leaf_inclusion_4_ary_merkle_tree = partial(
    gen_proof_of_leaf_inclusion, _gadget)
verify_proof_of_leaf_inclusion_4_ary_merkle_tree = partial(
    verify_proof_of_leaf_inclusion, _gadget)
