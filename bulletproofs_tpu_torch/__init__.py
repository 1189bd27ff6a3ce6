"""bulletproofs_tpu_torch: the PyTorch and CUDA port of bulletproofs_tpu.

It holds the device Pippenger MSM for G1 (`msm`, `msm_hybrid`), whose EC
work runs in hand-written CUDA kernels for Hopper (`ops/ec_kernels.py`,
`csrc/`), the standalone inner-product argument built on it (`create_ipp`,
`verify_ipp`, `batch_verify_ipp`), the R1CS prover and verifier
(`Prover`, `Verifier`, `R1CSProof`, `batch_verify`) with the gadgets of
`models`, the backend interface of the batch verifiers (`get_backend`,
`set_backend`: `TorchBackend` on the device or the exact-int host), the
batched device Poseidon (`ops/poseidon_device.py`) behind the
trees' bulk updates, their Fiat-Shamir transcript, the sharded MSM and
prover over a mesh of devices (`parallel`), and the exact-int host types
they are checked against.  The package imports neither JAX nor
bulletproofs_tpu.
"""

from .config import BLS381, BN254, curve, set_curve, using_curve
from .backend import get_backend, set_backend
from .ipp import (InnerProductArgumentProof, batch_verify_ipp, create_ipp,
                  verify_ipp)
from .ops.ec_host import G1, msm_host
from .ops.field_host import Scalar
from .ops.msm import msm, msm_hybrid
from .transcript import ProofTranscript
from .utils.generators import get_generators
from .r1cs import Prover, R1CSProof, Verifier, batch_verify
from . import models

__all__ = ["BLS381", "BN254", "G1", "InnerProductArgumentProof",
           "ProofTranscript", "Prover", "R1CSProof", "Scalar", "Verifier",
           "batch_verify", "batch_verify_ipp", "create_ipp", "curve",
           "get_backend", "get_generators", "models", "msm", "msm_host",
           "msm_hybrid", "set_backend", "set_curve", "using_curve",
           "verify_ipp"]
