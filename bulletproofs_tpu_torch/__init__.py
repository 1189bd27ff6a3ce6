"""bulletproofs_tpu_torch: the PyTorch and CUDA port of bulletproofs_tpu.

It holds the device Pippenger MSM for G1 (`msm`, `msm_hybrid`), whose EC
work runs in hand-written CUDA kernels for Hopper (`ops/ec_kernels.py`,
`csrc/`), the standalone inner-product argument built on it (`create_ipp`,
`verify_ipp`), the R1CS prover and verifier (`Prover`, `Verifier`,
`R1CSProof`) with the gadgets of `models` (the range proof `bound_check`,
the Poseidon preimage proofs and the sparse-Merkle-tree leaf-inclusion
proofs), the batched device Poseidon (`ops/poseidon_device.py`) behind the
trees' bulk updates, their Fiat-Shamir transcript, and the exact-int host
types they are checked against.  The package imports neither JAX nor
bulletproofs_tpu.
"""

from .config import BLS381, BN254, curve, set_curve, using_curve
from .ipp import InnerProductArgumentProof, create_ipp, verify_ipp
from .ops.ec_host import G1, msm_host
from .ops.field_host import Scalar
from .ops.msm import msm, msm_hybrid
from .transcript import ProofTranscript
from .utils.generators import get_generators
from .r1cs import Prover, R1CSProof, Verifier
from . import models

__all__ = ["BLS381", "BN254", "G1", "InnerProductArgumentProof",
           "ProofTranscript", "Prover", "R1CSProof", "Scalar", "Verifier",
           "create_ipp", "curve", "get_generators", "models", "msm",
           "msm_host", "msm_hybrid", "set_curve", "using_curve",
           "verify_ipp"]
