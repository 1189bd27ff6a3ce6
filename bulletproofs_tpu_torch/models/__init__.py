"""Gadgets: statements written over the R1CS constraint system (the Rust
reference's `src/r1cs/gadgets/`).  The port carries the range-proof gadget
`bound_check` and the helper constraints it uses.

Gadget convention (reference `gadgets/README.md:1-5`):
 - `*_gadget`: adds the constraints to any ConstraintSystem
 - `prove_*` / `verify_*`: composable, take a live Prover/Verifier
 - `gen_proof_*` / `verify_proof_*`: one-shot, own the transcript
"""

from . import bound_check, helper_constraints

__all__ = ["bound_check", "helper_constraints"]
