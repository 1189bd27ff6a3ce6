"""Gadgets: statements written over the R1CS constraint system (the Rust
reference's `src/r1cs/gadgets/`).  The port carries the range-proof gadget
`bound_check`, the Poseidon preimage proofs `poseidon_hash`, the 4-ary and
8-ary sparse-Merkle-tree leaf-inclusion proofs (one module,
`sparse_merkle_tree`, bound to each arity's gadget) and the helper constraints
they use.

Gadget convention (reference `gadgets/README.md:1-5`):
 - `*_gadget`: adds the constraints to any ConstraintSystem
 - `prove_*` / `verify_*`: composable, take a live Prover/Verifier
 - `gen_proof_*` / `verify_proof_*`: one-shot, own the transcript
"""

from . import (bound_check, helper_constraints, poseidon_hash,
               sparse_merkle_tree, sparse_merkle_tree_4_ary,
               sparse_merkle_tree_8_ary)

__all__ = ["bound_check", "helper_constraints", "poseidon_hash",
           "sparse_merkle_tree", "sparse_merkle_tree_4_ary",
           "sparse_merkle_tree_8_ary"]
