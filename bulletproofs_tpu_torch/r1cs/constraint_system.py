"""ConstraintSystem interface (the Rust reference's
`src/r1cs/constraint_system.rs`): the port's own copy of
`bulletproofs_tpu/r1cs/constraint_system.py`.

Gadgets are written against this interface and run unchanged over the
Prover and the Verifier.  `specify_randomized_constraints` defers a
callback to the second protocol phase (`constraint_system.rs:60-136`).
"""

from ..utils.errors import FormatError
from .linear_combination import MULT_LEFT, MULT_RIGHT, Variable


class ConstraintSystem:
    def multiply(self, left, right):
        """Allocate (l, r, o) with o = l*r, constraining l/r to the given
        linear combinations. Returns (Variable, Variable, Variable)."""
        raise NotImplementedError

    def allocate(self, assignment=None):
        """Allocate a single wire; two consecutive calls share one
        multiplication gate (`pending_multiplier` pairing)."""
        raise NotImplementedError

    def allocate_multiplier(self, input_assignments=None):
        """Allocate an (l, r, o) triple with o = l*r, unconstrained."""
        raise NotImplementedError

    def constrain(self, lc):
        """Add the constraint lc == 0."""
        raise NotImplementedError

    def specify_randomized_constraints(self, callback):
        """Defer `callback(randomized_cs)` to phase 2 of the protocol."""
        raise NotImplementedError

    def evaluate_lc(self, lc):
        """Prover: evaluate lc over the witness; Verifier: None."""
        raise NotImplementedError

    def allocate_single(self, assignment=None):
        """`constraint_system.rs:96-111`: allocate one wire, returning the
        paired output variable when this allocation completed a gate."""
        var = self.allocate(assignment)
        if var.kind == MULT_LEFT:
            return var, None
        if var.kind == MULT_RIGHT:
            return var, Variable.multiplier_output(var.index)
        raise FormatError("allocate returned unexpected variable kind")


class RandomizedConstraintSystem(ConstraintSystem):
    def challenge_scalar(self, label: bytes):
        """Draw a transcript challenge bound to the phase-1 commitments
        (`constraint_system.rs:118-136`)."""
        raise NotImplementedError
