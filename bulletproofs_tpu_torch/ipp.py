"""Inner-product argument (IPA): the log2(n)-round recursive proof that
<a, b> = c relative to committed bases -- the port of
`bulletproofs_tpu/ipp.py`, with the transcript schedule of the Rust
reference's `src/ipp.rs`.

`create_ipp` and `verify_ipp` run the device paths (`ops/prover_device.py`,
`ops/verifier_device.py`) on `device`, the card unless the caller passes
another.  The JAX package's host and native branches are not ported.
"""

from dataclasses import dataclass
from typing import List

from .ops.ec_host import G1
from .ops.field_host import Scalar
from .ops.prover_device import create_ipp_device
from .ops.verifier_device import replay_challenges, verify_ipp_device


@dataclass
class InnerProductArgumentProof:
    """`ipp.rs:15-20`"""
    L: List[G1]
    R: List[G1]
    a: Scalar
    b: Scalar


def create_ipp(transcript, Q, G_factors, H_factors, G_vec, H_vec, a_vec,
               b_vec, device="cuda",
               ec_kernel="chunk") -> InnerProductArgumentProof:
    """Prover side (`ipp.rs:35-202`): the proof is for the bases
    G'_i = G_factors_i * G_i, H'_i = H_factors_i * H_i; all vectors share a
    power-of-two length.  ec_kernel: the MSM bucket pass's form, "chunk"
    or "round" (`ops/msm.py: bucket_accumulate`); the proofs are equal."""
    n = len(G_vec)
    if not n or n & (n - 1):
        raise ValueError(f"IPA length {n} is not a power of two")
    if not len(H_vec) == len(a_vec) == len(b_vec) == len(G_factors) \
            == len(H_factors) == n:
        raise ValueError("IPA vectors of unequal length")
    L_vec, R_vec, a, b = create_ipp_device(
        transcript, Q, G_factors, H_factors, G_vec, H_vec, a_vec, b_vec,
        device=device, ec_kernel=ec_kernel)
    return InnerProductArgumentProof(L=L_vec, R=R_vec, a=a, b=b)


def verification_scalars(L_vec, R_vec, n, transcript):
    """Replay the transcript and build the s-vector in Python ints
    (`ipp.rs:262-315`).  Returns (u_sq, u_inv_sq, s)."""
    challenges_sq, challenges_inv_sq, product_chal_inv = replay_challenges(
        L_vec, R_vec, n, transcript)
    lg_n = len(L_vec)

    # s[0] = prod(u_i^-1); s[i] = s[i - 2^lg(i)] * u_{lg_n-1-lg(i)}^2
    r = product_chal_inv.cv.r
    sq_int = [c.v for c in challenges_sq]
    s_int = [product_chal_inv.v]
    append = s_int.append
    for i in range(1, n):
        lg_i = i.bit_length() - 1
        append(s_int[i - (1 << lg_i)] * sq_int[(lg_n - 1) - lg_i] % r)
    cv = product_chal_inv.cv
    s = [Scalar._new(v, cv) for v in s_int]
    return challenges_sq, challenges_inv_sq, s


def verify_ipp(n, transcript, G_factors, H_factors, P, Q, G, H, a, b, L_vec,
               R_vec, device="cuda"):
    """Verifier side (`ipp.rs:204-260`): one mega-MSM of 2n + 2 lg n + 1
    points on `device`, checked against P; raises VerificationError."""
    verify_ipp_device(n, transcript, G_factors, H_factors, P, Q, G, H, a, b,
                      L_vec, R_vec, device=device)
