"""Poseidon preimage-knowledge gadgets for the 2:1, 4:1 and 8:1 hashes (the
Rust reference's `src/r1cs/gadgets/poseidon_hash.rs`): the port's own copy
of `bulletproofs_tpu/models/poseidon_hash.py`.

The hash wrappers need "static" permutation inputs (ZERO_CONST and the
padding constant); these are committed with blinding zero so the verifier
can recompute the commitments itself (`poseidon_hash.rs:20-72`).  The
one-shot functions prove and verify on `device`, the card unless the caller
passes another.
"""

from ..ops.ec_host import commit_to_field_element
from ..ops.field_host import Scalar
from ..r1cs import Prover, Verifier
from ..transcript import ProofTranscript
from ..utils.errors import (check_for_input_and_randomness_length,
                            check_for_randomness_or_rng)
from .helper_constraints.poseidon import (PADDING_CONST, ZERO_CONST,
                                          Poseidon_hash_2_gadget,
                                          Poseidon_hash_4_gadget,
                                          Poseidon_hash_8_gadget)


def allocate_statics_for_prover(prover: Prover, num_statics: int):
    """`poseidon_hash.rs:20-37`: commit ZERO then PADDING then ZEROs, all
    with blinding zero."""
    statics = []
    _, var = prover.commit(Scalar(ZERO_CONST), Scalar.zero())
    statics.append(var)
    if num_statics > len(statics):
        _, var = prover.commit(Scalar(PADDING_CONST), Scalar.zero())
        statics.append(var)
    while len(statics) < num_statics:
        _, var = prover.commit(Scalar(ZERO_CONST), Scalar.zero())
        statics.append(var)
    return statics


def allocate_statics_for_verifier(verifier: Verifier, num_statics: int, g, h):
    """`poseidon_hash.rs:40-72`: recompute the zero-blinding commitments."""
    zero_comm = commit_to_field_element(g, h, Scalar(ZERO_CONST),
                                        Scalar.zero())
    statics = [verifier.commit(zero_comm)]
    if num_statics > len(statics):
        pad_comm = commit_to_field_element(g, h, Scalar(PADDING_CONST),
                                           Scalar.zero())
        statics.append(verifier.commit(pad_comm))
    while len(statics) < num_statics:
        statics.append(verifier.commit(zero_comm))
    return statics


def _commit_inputs(prover, inputs, randomness, rng, k):
    check_for_randomness_or_rng(randomness, rng)
    rands = randomness if randomness is not None else \
        [Scalar.random(rng) for _ in range(k)]
    check_for_input_and_randomness_length(inputs, rands, k)
    comms, vars_ = [], []
    for v, r in zip(inputs, rands):
        com, var = prover.commit(v, r)
        comms.append(com)
        vars_.append(var)
    return comms, vars_


# ---- 2:1 ----

def prove_knowledge_of_preimage_of_Poseidon_2(
        inputs, randomness, expected_output, hash_params, sbox_type, rng,
        prover: Prover):
    comms, (var_l, var_r) = _commit_inputs(prover, inputs, randomness, rng, 2)
    statics = allocate_statics_for_prover(prover, 1)
    Poseidon_hash_2_gadget(prover, var_l, var_r, statics, hash_params,
                           sbox_type, expected_output)
    return comms


def verify_knowledge_of_preimage_of_Poseidon_2(
        expected_output, hash_params, sbox_type, commitments, g, h,
        verifier: Verifier):
    lv = verifier.commit(commitments[0])
    rv = verifier.commit(commitments[1])
    statics = allocate_statics_for_verifier(verifier, 1, g, h)
    Poseidon_hash_2_gadget(verifier, lv, rv, statics, hash_params, sbox_type,
                           expected_output)


def gen_proof_of_knowledge_of_preimage_of_Poseidon_2(
        inputs, randomness, expected_output, hash_params, sbox_type, rng,
        transcript_label: bytes, g, h, G, H, device="cuda"):
    transcript = ProofTranscript(transcript_label)
    prover = Prover(g, h, transcript, rng=rng, device=device)
    comms = prove_knowledge_of_preimage_of_Poseidon_2(
        inputs, randomness, expected_output, hash_params, sbox_type, rng,
        prover)
    return prover.prove(G, H), comms


def verify_proof_of_knowledge_of_preimage_of_Poseidon_2(
        expected_output, hash_params, sbox_type, proof, commitments,
        transcript_label: bytes, g, h, G, H, device="cuda"):
    transcript = ProofTranscript(transcript_label)
    verifier = Verifier(transcript, device=device)
    verify_knowledge_of_preimage_of_Poseidon_2(
        expected_output, hash_params, sbox_type, commitments, g, h, verifier)
    verifier.verify(proof, g, h, G, H)


# ---- 4:1 ----

def prove_knowledge_of_preimage_of_Poseidon_4(
        inputs, randomness, expected_output, hash_params, sbox_type, rng,
        prover: Prover):
    comms, vars_ = _commit_inputs(prover, inputs, randomness, rng, 4)
    statics = allocate_statics_for_prover(prover, 1)
    Poseidon_hash_4_gadget(prover, vars_, statics, hash_params, sbox_type,
                           expected_output)
    return comms


def verify_knowledge_of_preimage_of_Poseidon_4(
        expected_output, hash_params, sbox_type, commitments, g, h,
        verifier: Verifier):
    vars_ = [verifier.commit(c) for c in commitments[:4]]
    statics = allocate_statics_for_verifier(verifier, 1, g, h)
    Poseidon_hash_4_gadget(verifier, vars_, statics, hash_params, sbox_type,
                           expected_output)


def gen_proof_of_knowledge_of_preimage_of_Poseidon_4(
        inputs, randomness, expected_output, hash_params, sbox_type, rng,
        transcript_label: bytes, g, h, G, H, device="cuda"):
    transcript = ProofTranscript(transcript_label)
    prover = Prover(g, h, transcript, rng=rng, device=device)
    comms = prove_knowledge_of_preimage_of_Poseidon_4(
        inputs, randomness, expected_output, hash_params, sbox_type, rng,
        prover)
    return prover.prove(G, H), comms


def verify_proof_of_knowledge_of_preimage_of_Poseidon_4(
        expected_output, hash_params, sbox_type, proof, commitments,
        transcript_label: bytes, g, h, G, H, device="cuda"):
    transcript = ProofTranscript(transcript_label)
    verifier = Verifier(transcript, device=device)
    verify_knowledge_of_preimage_of_Poseidon_4(
        expected_output, hash_params, sbox_type, commitments, g, h, verifier)
    verifier.verify(proof, g, h, G, H)


# ---- 8:1 ----

def prove_knowledge_of_preimage_of_Poseidon_8(
        inputs, randomness, expected_output, hash_params, sbox_type, rng,
        prover: Prover):
    comms, vars_ = _commit_inputs(prover, inputs, randomness, rng, 8)
    _, zero_var = prover.commit(Scalar(ZERO_CONST), Scalar.zero())
    Poseidon_hash_8_gadget(prover, vars_, zero_var, hash_params, sbox_type,
                           expected_output)
    return comms


def verify_knowledge_of_preimage_of_Poseidon_8(
        expected_output, hash_params, sbox_type, commitments, g, h,
        verifier: Verifier):
    vars_ = [verifier.commit(c) for c in commitments[:8]]
    zero_comm = commit_to_field_element(g, h, Scalar(ZERO_CONST),
                                        Scalar.zero())
    zero_var = verifier.commit(zero_comm)
    Poseidon_hash_8_gadget(verifier, vars_, zero_var, hash_params, sbox_type,
                           expected_output)


def gen_proof_of_knowledge_of_preimage_of_Poseidon_8(
        inputs, randomness, expected_output, hash_params, sbox_type, rng,
        transcript_label: bytes, g, h, G, H, device="cuda"):
    transcript = ProofTranscript(transcript_label)
    prover = Prover(g, h, transcript, rng=rng, device=device)
    comms = prove_knowledge_of_preimage_of_Poseidon_8(
        inputs, randomness, expected_output, hash_params, sbox_type, rng,
        prover)
    return prover.prove(G, H), comms


def verify_proof_of_knowledge_of_preimage_of_Poseidon_8(
        expected_output, hash_params, sbox_type, proof, commitments,
        transcript_label: bytes, g, h, G, H, device="cuda"):
    transcript = ProofTranscript(transcript_label)
    verifier = Verifier(transcript, device=device)
    verify_knowledge_of_preimage_of_Poseidon_8(
        expected_output, hash_params, sbox_type, commitments, g, h, verifier)
    verifier.verify(proof, g, h, G, H)
