"""Bound-check (range proof) gadget (the Rust reference's
`src/r1cs/gadgets/bound_check.rs`): the port's own copy of
`bulletproofs_tpu/models/bound_check.py`.

Proves a committed v lies in [min, max]: with a = v - min, b = max - v,
constrain a + b = max - min and a, b in [0, 2^n).  m such proofs on one
Prover make the aggregated range proof of the bench's config 2.  The
one-shot functions prove and verify on `device`, the card unless the caller
passes another.
"""

from ..ops.field_host import Scalar
from ..r1cs import Prover, Verifier
from ..r1cs.linear_combination import AllocatedQuantity
from ..transcript import ProofTranscript
from ..utils.errors import check_for_randomness_or_rng
from .helper_constraints import constrain_lc_with_scalar
from .helper_constraints.positive_no import positive_no_gadget


def bound_check_gadget(cs, v, a, b, max_val: int, min_val: int, n: int):
    """`bound_check.rs:13-39`"""
    # v - min - a == 0
    cs.constrain(v.variable - Scalar(min_val) - a.variable)
    # max - v - b == 0
    cs.constrain(Scalar(max_val) - v.variable - b.variable)
    # a + b == max - min
    constrain_lc_with_scalar(cs, a.variable + b.variable,
                             Scalar(max_val - min_val))
    # a, b in [0, 2^n)
    positive_no_gadget(cs, a, n)
    positive_no_gadget(cs, b, n)


def prove_bounded_num(val: int, randomness, lower: int, upper: int,
                      max_bits_in_val: int, rng, prover: Prover):
    """`bound_check.rs:41-92`; returns the three V commitments.  The
    blindings are drawn in the order of three sequential commits."""
    check_for_randomness_or_rng(randomness, rng)
    a = val - lower
    b = upper - val
    r_v = randomness if randomness is not None else Scalar.random(rng)
    r_a = Scalar.random(rng)
    r_b = Scalar.random(rng)
    (com_v, var_v), (com_a, var_a), (com_b, var_b) = prover.commit_many(
        [Scalar(val), Scalar(a), Scalar(b)], [r_v, r_a, r_b])
    bound_check_gadget(prover, AllocatedQuantity(var_v, Scalar(val)),
                       AllocatedQuantity(var_a, Scalar(a)),
                       AllocatedQuantity(var_b, Scalar(b)), upper, lower,
                       max_bits_in_val)
    return [com_v, com_a, com_b]


def verify_bounded_num(lower: int, upper: int, max_bits_in_val: int,
                       commitments, verifier: Verifier):
    """`bound_check.rs:94-129`"""
    var_v = verifier.commit(commitments[0])
    var_a = verifier.commit(commitments[1])
    var_b = verifier.commit(commitments[2])
    bound_check_gadget(verifier,
                       AllocatedQuantity(var_v), AllocatedQuantity(var_a),
                       AllocatedQuantity(var_b), upper, lower,
                       max_bits_in_val)


def gen_proof_of_bounded_num(val, randomness, lower, upper, max_bits_in_val,
                             rng, transcript_label: bytes, g, h, G, H,
                             device="cuda"):
    """One-shot prover (`bound_check.rs:133-161`) -> (proof, commitments)."""
    prover = Prover(g, h, ProofTranscript(transcript_label), rng=rng,
                    device=device)
    comms = prove_bounded_num(val, randomness, lower, upper, max_bits_in_val,
                              rng, prover)
    return prover.prove(G, H), comms


def verify_proof_of_bounded_num(lower, upper, max_bits_in_val, proof,
                                commitments, transcript_label: bytes,
                                g, h, G, H, device="cuda"):
    """One-shot verifier (`bound_check.rs:163-179`); raises
    VerificationError."""
    verifier = Verifier(ProofTranscript(transcript_label), device=device)
    verify_bounded_num(lower, upper, max_bits_in_val, commitments, verifier)
    verifier.verify(proof, g, h, G, H)
