from .constraint_system import ConstraintSystem, RandomizedConstraintSystem
from .linear_combination import (AllocatedQuantity, LinearCombination,
                                 Variable)
from .proof import R1CSProof
from .prover import Prover, RandomizingProver
from .verifier import RandomizingVerifier, Verifier

__all__ = [
    "ConstraintSystem", "RandomizedConstraintSystem", "AllocatedQuantity",
    "LinearCombination", "Variable", "R1CSProof", "Prover",
    "RandomizingProver", "Verifier", "RandomizingVerifier",
]
