"""Sparse Merkle tree leaf-inclusion proofs of either arity (the Rust
reference's `src/r1cs/gadgets/sparse_merkle_tree_{4,8}_ary.rs`; the port's
own copy of `bulletproofs_tpu/models/sparse_merkle_tree_{4,8}_ary.py`,
whose two modules differ only in the verification gadget they call).
Commit the leaf, the leaf index and arity - 1 proof nodes per level, then
run the arity's verification circuit with one static, the zero-blinding
ZERO commitment.  Each function takes the arity's `gadget`
(`sparse_merkle_tree_4_ary.py` and `_8_ary.py` bind it); the one-shot
functions prove and verify on `device`, the card unless the caller passes
another."""

from ..ops.field_host import Scalar
from ..r1cs import Prover, Verifier
from ..r1cs.linear_combination import AllocatedQuantity
from ..transcript import ProofTranscript
from ..utils.errors import GadgetError, check_for_randomness_or_rng
from .poseidon_hash import (allocate_statics_for_prover,
                            allocate_statics_for_verifier)


def prove_leaf_inclusion(gadget, leaf: Scalar, leaf_index: Scalar,
                         randomness, merkle_proof, root: Scalar,
                         tree_depth: int, hash_params, sbox_type, rng,
                         prover: Prover):
    """`sparse_merkle_tree_4_ary.rs:22-88`, `_8_ary.rs:22-87`: the
    randomness of the leaf and the index, then one `Scalar.random(rng)`
    per proof node, in that order."""
    check_for_randomness_or_rng(randomness, rng)
    rands = randomness if randomness is not None else \
        [Scalar.random(rng), Scalar.random(rng)]
    if len(rands) != 2:
        raise GadgetError("Provided randomness should have size 2")

    comms = []
    com_leaf, var_leaf = prover.commit(leaf, rands[0])
    comms.append(com_leaf)
    com_idx, var_idx = prover.commit(leaf_index, rands[1])
    comms.append(com_idx)

    proof_vars = []
    for node in merkle_proof:
        for elem in node:
            c, v = prover.commit(elem, Scalar.random(rng))
            comms.append(c)
            proof_vars.append(v)

    statics = allocate_statics_for_prover(prover, 1)
    gadget(prover, tree_depth, root, var_leaf,
           AllocatedQuantity(var_idx, leaf_index), proof_vars, statics,
           hash_params, sbox_type)
    return comms


def verify_leaf_inclusion(gadget, root: Scalar, tree_depth: int,
                          hash_params, sbox_type, commitments, g, h,
                          verifier: Verifier):
    """`sparse_merkle_tree_4_ary.rs:90-130`, `_8_ary.rs:89-128`."""
    var_leaf = verifier.commit(commitments[0])
    var_idx = verifier.commit(commitments[1])
    proof_vars = [verifier.commit(c) for c in commitments[2:]]
    statics = allocate_statics_for_verifier(verifier, 1, g, h)
    gadget(verifier, tree_depth, root, var_leaf, AllocatedQuantity(var_idx),
           proof_vars, statics, hash_params, sbox_type)


def gen_proof_of_leaf_inclusion(
        gadget, leaf, leaf_index, randomness, merkle_proof, root,
        tree_depth, hash_params, sbox_type, rng, transcript_label: bytes, g,
        h, G, H, device="cuda"):
    prover = Prover(g, h, ProofTranscript(transcript_label), rng=rng,
                    device=device)
    comms = prove_leaf_inclusion(
        gadget, leaf, leaf_index, randomness, merkle_proof, root,
        tree_depth, hash_params, sbox_type, rng, prover)
    return prover.prove(G, H), comms


def verify_proof_of_leaf_inclusion(
        gadget, root, tree_depth, hash_params, sbox_type, proof,
        commitments, transcript_label: bytes, g, h, G, H, device="cuda"):
    verifier = Verifier(ProofTranscript(transcript_label), device=device)
    verify_leaf_inclusion(gadget, root, tree_depth, hash_params, sbox_type,
                          commitments, g, h, verifier)
    verifier.verify(proof, g, h, G, H)
