"""Inner-product argument (IPA): the log2(n)-round recursive proof that
<a, b> = c relative to committed bases -- the port of
`bulletproofs_tpu/ipp.py`, with the transcript schedule of the Rust
reference's `src/ipp.rs`.

`create_ipp` and `verify_ipp` run the device paths (`ops/prover_device.py`,
`ops/verifier_device.py`) on `device`, the card unless the caller passes
another; `batch_verify_ipp` checks k proofs in one combined equation
through `backend.get_backend(device)`.  The JAX package's host and native
branches are not ported.
"""

from dataclasses import dataclass
from typing import List

from .backend import get_backend
from .ops.ec_host import G1
from .ops.field_host import Scalar
from .ops.prover_device import create_ipp_device
from .ops.verifier_device import replay_challenges, verify_ipp_device
from .utils.errors import combined_batch_check


@dataclass
class InnerProductArgumentProof:
    """`ipp.rs:15-20`"""
    L: List[G1]
    R: List[G1]
    a: Scalar
    b: Scalar


def create_ipp(transcript, Q, G_factors, H_factors, G_vec, H_vec, a_vec,
               b_vec, device="cuda", ec_kernel="chunk",
               fused=None) -> InnerProductArgumentProof:
    """Prover side (`ipp.rs:35-202`): the proof is for the bases
    G'_i = G_factors_i * G_i, H'_i = H_factors_i * H_i; all vectors share a
    power-of-two length.  ec_kernel: the MSM bucket pass's form, "chunk"
    or "round" (`ops/msm.py: bucket_accumulate`); fused: every round and
    the transcript on the device (True; the default on a card, off for
    Edwards-serialized curves) or one MSM and one host transcript step a
    round (False; the default on the CPU)
    (`ops/prover_device.py: create_ipp_implicit`).  The proofs are
    equal."""
    n = len(G_vec)
    if not n or n & (n - 1):
        raise ValueError(f"IPA length {n} is not a power of two")
    if not len(H_vec) == len(a_vec) == len(b_vec) == len(G_factors) \
            == len(H_factors) == n:
        raise ValueError("IPA vectors of unequal length")
    L_vec, R_vec, a, b = create_ipp_device(
        transcript, Q, G_factors, H_factors, G_vec, H_vec, a_vec, b_vec,
        device=device, ec_kernel=ec_kernel, fused=fused)
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


def batch_verify_ipp(n, G, H, items, rng=None, localize=True,
                     device="cuda"):
    """Verify k standalone IPA proofs over the generator vectors G, H with
    one combined check (beyond the reference, whose `ipp.rs:204-260` runs
    one 2n + 2 lg n + 1 point MSM a proof).

    items: [(transcript, G_factors, H_factors, P, Q, a, b, L_vec, R_vec)],
    `verify_ipp`'s arguments a proof.  Proof i's equation expected_P_i ==
    P_i enters as rho_i * (expected_P_i - P_i) with rho_0 = 1 and rho_i =
    `Scalar.random(rng)`; the shared-generator MSM and the small fresh
    per-proof MSM run apart on `get_backend(device)`, so the generators'
    conversion stays cached.  The scalar combination is the JAX package's
    pure-int branch (`BP_IPA_NATIVE_COMB=0`); it multiplies in G_factors
    and H_factors where they are not all one.  On failure, localize=True
    finds the failing proofs by bisection over the kept s-vectors and
    raises `BatchVerificationError` with their indices; localize=False
    raises `VerificationError`."""
    if not items:
        raise ValueError("batch_verify_ipp of an empty batch")
    r = G[0].cv.r

    def _factors(fs):
        """[f_j] as ints, or None when every factor is one."""
        vals = [f.v if isinstance(f, Scalar) else int(f) % r for f in fs]
        return None if all(v == 1 for v in vals) else vals

    # per-proof terms (rho * a and rho * b weigh the s-vectors in the
    # combined check, so they recombine over the bisection's subsets)
    per = []
    for i, (transcript, G_factors, H_factors, P, Q, a, b, L_vec,
            R_vec) in enumerate(items):
        u_sq, u_inv_sq, s = verification_scalars(L_vec, R_vec, n, transcript)
        rho = 1 if i == 0 else Scalar.random(rng).v
        s_int = [si.v for si in s]
        g_vec, h_vec = s_int, s_int[::-1]
        gf, hf = _factors(G_factors), _factors(H_factors)
        if gf:
            g_vec = [sj * fj % r for sj, fj in zip(g_vec, gf)]
        if hf:
            h_vec = [sj * fj % r for sj, fj in zip(h_vec, hf)]
        head_pts = [Q] + list(L_vec) + list(R_vec) + [P]
        head_scals = [rho * (a.v * b.v % r) % r]
        head_scals += [(-(rho * u.v)) % r for u in u_sq]
        head_scals += [(-(rho * u.v)) % r for u in u_inv_sq]
        head_scals.append((-rho) % r)
        per.append((rho * a.v % r, g_vec, rho * b.v % r, h_vec, head_pts,
                    head_scals))
    combined_batch_check(per, G, H, n, get_backend(device), localize,
                         "IPA batch verification")
