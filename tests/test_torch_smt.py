"""The port's sparse Merkle trees and their leaf-inclusion proofs
(bulletproofs_tpu_torch: utils/hash_db.py, models/helper_constraints/
sparse_merkle_tree*.py, models/sparse_merkle_tree_{4,8}_ary.py) against the
JAX package, on the CPU.

Tree roots after sequential and batched updates (the batched ones through
the device Poseidon on the CPU, a duplicate index included) against the
JAX package's at depths 2-4; depth-2 SMT-4 and depth-1 SMT-8 inclusion
proofs with reduced-round Poseidon (n = 64; the SMT-4 one made by
chip_smoke.py's smt phase, rehearsed here at that size) byte for byte
against the JAX package's native `Prover._prove`, each side's verifier
accepting the other's proof and the port's rejecting a tampered root,
commitment and proof; the JAX package's depth-12 proof digest and update
roots of tests/vectors/torch_smt4_d12.json re-made.  Every comparison is
exact.
"""

import contextlib
import hashlib
import importlib
import inspect
import io
import json
import random
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import bulletproofs_tpu as jbp
from bulletproofs_tpu import backend as jbackend
from bulletproofs_tpu.models import sparse_merkle_tree_4_ary as jsmt4
from bulletproofs_tpu.models import sparse_merkle_tree_8_ary as jsmt8
from bulletproofs_tpu.models.helper_constraints import \
    sparse_merkle_tree_4_ary as jhelper4
from bulletproofs_tpu.models.helper_constraints import \
    sparse_merkle_tree_8_ary as jhelper8
from bulletproofs_tpu.models import helper_constraints as jhc
from bulletproofs_tpu.models.helper_constraints.poseidon import \
    PoseidonParams as JParams
from bulletproofs_tpu.r1cs.linear_combination import \
    AllocatedQuantity as JAllocatedQuantity
from bulletproofs_tpu.utils.hash_db import InMemoryHashDb as JDb

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch.models import sparse_merkle_tree_4_ary as smt4
from bulletproofs_tpu_torch.models import sparse_merkle_tree_8_ary as smt8
from bulletproofs_tpu_torch.models.helper_constraints import \
    sparse_merkle_tree_4_ary as helper4
from bulletproofs_tpu_torch.models.helper_constraints import \
    sparse_merkle_tree_8_ary as helper8
from bulletproofs_tpu_torch.models import helper_constraints as hc
from bulletproofs_tpu_torch.models.helper_constraints.poseidon import \
    PoseidonParams
from bulletproofs_tpu_torch.r1cs.linear_combination import AllocatedQuantity
from bulletproofs_tpu_torch.ops import ec_kernels as ek
from bulletproofs_tpu_torch.utils.errors import (HashNotFoundInDB,
                                                 VerificationError)
from bulletproofs_tpu_torch.utils.hash_db import InMemoryHashDb

# One torch thread: the suite runs several test processes at once, and
# each process's own thread pool would oversubscribe the cores.
torch.set_num_threads(1)

REFERENCE = Path(__file__).resolve().parent / "vectors" \
    / "torch_smt4_d12.json"
# The reference's tree hashes (`sparse_merkle_tree_4_ary.rs:242`,
# `_8_ary.rs`): width, full rounds at each end, partial rounds
FULL = {4: (5, 4, 4, 56), 8: (9, 4, 4, 57)}
# Reduced rounds for the proofs (one full round, one partial): n = 64 for
# a depth-2 SMT-4 and a depth-1 SMT-8
SMALL = {4: (5, 1, 0, 1), 8: (9, 1, 0, 1)}
PROOF_DEPTH = {4: 2, 8: 1}

PORT = SimpleNamespace(
    Scalar=bt.Scalar, G1=bt.G1, Params=PoseidonParams, Db=InMemoryHashDb,
    Tree={4: helper4.VanillaSparseMerkleTree_4,
          8: helper8.VanillaSparseMerkleTree_8},
    smt={4: smt4, 8: smt8}, Prover=bt.Prover, Verifier=bt.Verifier,
    Proof=bt.R1CSProof, Transcript=bt.ProofTranscript, gens=bt.get_generators)
JAX = SimpleNamespace(
    Scalar=jbp.Scalar, G1=jbp.G1, Params=JParams, Db=JDb,
    Tree={4: jhelper4.VanillaSparseMerkleTree_4,
          8: jhelper8.VanillaSparseMerkleTree_8},
    smt={4: jsmt4, 8: jsmt8}, Prover=jbp.Prover, Verifier=jbp.Verifier,
    Proof=jbp.R1CSProof, Transcript=jbp.ProofTranscript,
    gens=jbp.get_generators)


@contextlib.contextmanager
def _native():
    """The JAX package's native backend for its host proving and
    verifying: test modules that set another backend when imported (the
    pure-Python "host") would otherwise make its depth-12 proof take
    minutes in a worker that imported them.  Proof bytes are the same on
    every backend."""
    old = jbackend._mode
    jbackend.set_backend("cpp")
    try:
        yield
    finally:
        jbackend.set_backend(old)


def _tree(ns, arity, depth, params, **kw):
    db = ns.Db()
    return ns.Tree[arity](ns.Params(*params), depth, db, **kw), db


def _pairs(ns, ints):
    return [(ns.Scalar(k), ns.Scalar(v)) for k, v in ints]


# ---------------------------------------------------------------------------
# 1. The native trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arity,depth", [(4, 2), (4, 3), (4, 4), (8, 2),
                                         (8, 3)])
def test_tree_roots_match_jax(arity, depth):
    """Two batches of updates (the second rewrites an index of the first
    and holds a duplicate of its own): the port's batched roots (device
    Poseidon on the CPU for levels of 8 parents or more) equal its
    sequential ones and the JAX package's batched ones."""
    rnd = random.Random(arity * 100 + depth)
    r = bt.BLS381.r
    first = [(rnd.randrange(arity ** depth), rnd.randrange(r))
             for _ in range(12)]
    second = [(first[3][0], rnd.randrange(r))] + \
        [(rnd.randrange(arity ** depth), rnd.randrange(r)) for _ in range(8)]
    second.append((second[4][0], rnd.randrange(r)))
    seq, seq_db = _tree(PORT, arity, depth, FULL[arity], device="cpu")
    bat, bat_db = _tree(PORT, arity, depth, FULL[arity], device="cpu")
    ref, ref_db = _tree(JAX, arity, depth, FULL[arity])
    assert seq.root.v == ref.root.v
    for batch in (first, second):
        for k, v in _pairs(PORT, batch):
            seq.update(k, v, seq_db)
        bat.batch_update(_pairs(PORT, batch), bat_db)
        ref.batch_update(_pairs(JAX, batch), ref_db)
        assert bat.root == seq.root
        assert bat.root.v == ref.root.v
    k, v = _pairs(PORT, [second[-1]])[0]
    nodes = []
    assert bat.get(k, nodes, bat_db) == v
    assert bat.verify_proof(k, v, nodes)
    assert not bat.verify_proof(k, v + PORT.Scalar(1), nodes)


def test_digits_helpers_and_hash_db():
    assert helper4.get_base_4_repr(PORT.Scalar(27), 4) == [0, 1, 2, 3]
    assert helper8.get_base_8_repr(PORT.Scalar(0o1723), 4) == [1, 7, 2, 3]
    for d in (1, 5, 12):
        k = PORT.Scalar(random.Random(d).randrange(4 ** d))
        assert helper4.get_base_4_repr(k, d) == \
            jhelper4.get_base_4_repr(JAX.Scalar(k.v), d)
    for digits, base in ((12, 4), (5, 8), (3, 2)):
        assert (hc.get_bit_count(digits, base),
                hc.get_byte_size(digits, base)) == \
            (jhc.get_bit_count(digits, base), jhc.get_byte_size(digits, base))
    idx = PORT.Scalar(1234567)
    assert hc.allocated_leaf_index_to_bytes(AllocatedQuantity(None, idx)) \
        == jhc.allocated_leaf_index_to_bytes(
            JAllocatedQuantity(None, JAX.Scalar(idx.v)))
    assert hc.allocated_leaf_index_to_bytes(AllocatedQuantity(None)) is None
    db = InMemoryHashDb()
    with pytest.raises(HashNotFoundInDB):
        db.get(b"\x01" * 48)
    assert inspect.signature(helper4.VanillaSparseMerkleTree_4).parameters[
        "device"].default == "cuda"


# ---------------------------------------------------------------------------
# 2. Leaf-inclusion proofs, n = 64
# ---------------------------------------------------------------------------

LABEL = {4: b"smt", 8: b"SMT8"}


def _smt4_ref():
    """chip_smoke.py's smt phase at a CPU size, the shape of
    tests/vectors/torch_smt4_d12.json: reduced-round Poseidon, depth 2, two
    batches of 24 updates, the proof of one leaf of a fresh tree at n = 64;
    `proofs` adds the JAX package's root and proof digest."""
    sched = dict(zip(("width", "full_rounds_beginning", "full_rounds_end",
                      "partial_rounds"), SMALL[4]))
    return {"poseidon": {**sched, "sbox": "quint"}, "depth": PROOF_DEPTH[4],
            "updates": {"seed": 13, "batch": 24},
            "proof": {"key": 2, "value": 999, "rng_seed": 21,
                      "label": LABEL[4].decode(), "n": 64}}


def _statement(ns, arity):
    """A tree of reduced-round Poseidon with a few leaves -> (tree, leaf,
    index, proof nodes)."""
    tree, db = _tree(ns, arity, PROOF_DEPTH[arity], SMALL[arity],
                     **({"device": "cpu"} if ns is PORT else {}))
    for i in range(1, arity):
        tree.update(ns.Scalar(i), ns.Scalar(100 + i), db)
    idx = ns.Scalar(arity - 2)
    nodes = []
    leaf = tree.get(idx, nodes, db)
    return tree, leaf, idx, nodes


def _prove(ns, arity, gens, **kw):
    tree, leaf, idx, nodes = _statement(ns, arity)
    g, h = ns.G1.from_msg_hash(b"g"), ns.G1.from_msg_hash(b"h")
    proof, comms = getattr(
        ns.smt[arity],
        f"gen_proof_of_leaf_inclusion_{arity}_ary_merkle_tree")(
        leaf, idx, None, nodes, tree.root, tree.depth, tree.hash_params,
        "quint", random.Random(0x5A7 + arity), LABEL[arity], g, h,
        ns.gens("G", gens), ns.gens("H", gens), **kw)
    return {"bytes": proof.to_bytes(), "comms": comms, "root": tree.root,
            "params": tree.hash_params}


def _verify(ns, arity, rec, blob, root=None, comms=None, **kw):
    g, h = ns.G1.from_msg_hash(b"g"), ns.G1.from_msg_hash(b"h")
    getattr(ns.smt[arity],
            f"verify_proof_of_leaf_inclusion_{arity}_ary_merkle_tree")(
        root if root is not None else rec["root"], PROOF_DEPTH[arity],
        rec["params"], "quint", ns.Proof.from_bytes(blob),
        comms if comms is not None else rec["comms"], LABEL[arity], g, h,
        ns.gens("G", 64), ns.gens("H", 64), **kw)


@pytest.fixture(scope="module")
def proofs():
    """Per arity, the port's proof on the CPU and the JAX package's native
    `Prover._prove` proof (64 generators).  The port's SMT-4 proof is the
    one chip_smoke.py's smt phase makes in its CPU rehearsal (`_smt4_ref`,
    exactly n = 64 generators), the phase's output line and launch counts
    kept for the rehearsal's test; the SMT-8 proof is given 128
    generators."""
    ref = _smt4_ref()
    with _native():
        ref["updates"]["root_both_batches"] = _jax_update_roots(ref, None)
        jproof, jcomms, jroot, _ = _jax_proof(
            ref, ref["depth"], JParams(*SMALL[4]), ref["proof"]["n"])
        jax8 = _prove(JAX, 8, 64)
    ref["proof"]["sha256"] = hashlib.sha256(jproof.to_bytes()).hexdigest()
    ref["proof"]["tree_root"] = jroot.to_bytes().hex()
    chip_smoke = importlib.import_module("chip_smoke")
    out = io.StringIO()
    ek.reset_launches()
    with contextlib.redirect_stdout(out):
        phase = chip_smoke.phase_smt("cpu", ref, 16, 0)
    launches = dict(ek.launches)
    params4 = PoseidonParams(*SMALL[4])
    return {
        4: {"port": {"bytes": phase["proof"].to_bytes(),
                     "comms": phase["commitments"], "root": phase["root"],
                     "params": params4},
            "jax": {"bytes": jproof.to_bytes(), "comms": jcomms,
                    "root": jroot, "params": JParams(*SMALL[4])}},
        8: {"port": _prove(PORT, 8, 128, device="cpu"), "jax": jax8},
        "rehearsal": {"ref": ref, "launches": launches,
                      "line": json.loads(out.getvalue().splitlines()[-1]),
                      "msms": phase["msms"]}}


@pytest.mark.parametrize("arity", [4, 8])
def test_proof_bytes_match_jax_package(proofs, arity):
    """Byte-identical; for SMT-8 though the port was given 128 generators
    and the JAX package 64: the proof reads only the first n = 64."""
    port, jax_ = proofs[arity]["port"], proofs[arity]["jax"]
    assert port["bytes"] == jax_["bytes"]
    assert [c.to_bytes() for c in port["comms"]] == \
        [c.to_bytes() for c in jax_["comms"]]


@pytest.mark.parametrize("arity", [4, 8])
def test_port_verifier_accepts_jax_proof(proofs, arity):
    _verify(PORT, arity, proofs[arity]["port"],
            proofs[arity]["jax"]["bytes"], device="cpu")


@pytest.mark.parametrize("arity", [4, 8])
def test_jax_verifier_accepts_port_proof(proofs, arity):
    with _native():
        _verify(JAX, arity, proofs[arity]["jax"],
                proofs[arity]["port"]["bytes"])


@pytest.mark.parametrize("tamper", ["root", "commitment", "proof"])
def test_port_verifier_rejects_tampered(proofs, tamper):
    rec = proofs[4]["port"]
    blob, root, comms = rec["bytes"], None, None
    if tamper == "root":
        root = rec["root"] + PORT.Scalar(1)
    elif tamper == "commitment":
        comms = list(rec["comms"])
        comms[2] = comms[2] + PORT.G1.from_msg_hash(b"g")
    else:
        bad = PORT.Proof.from_bytes(blob)
        bad.t_x = bad.t_x + PORT.Scalar(1)
        blob = bad.to_bytes()
    with pytest.raises(VerificationError):
        _verify(PORT, 4, rec, blob, root=root, comms=comms, device="cpu")


def test_entry_points_default_to_the_card():
    """The one-shot proofs and the trees run on "cuda" unless asked:
    without a card (as here) proving, and a batch update with 8 parents on
    a level, raise instead of running on the CPU."""
    for mod, a in ((smt4, 4), (smt8, 8)):
        for kind in ("gen", "verify"):
            fn = getattr(mod, f"{kind}_proof_of_leaf_inclusion_{a}_ary_"
                         "merkle_tree")
            assert inspect.signature(fn).parameters["device"].default == \
                "cuda"
    if not torch.cuda.is_available():
        tree, db = _tree(PORT, 4, 3, SMALL[4])
        with pytest.raises((RuntimeError, AssertionError)):
            tree.batch_update(_pairs(PORT, [(k, k) for k in range(0, 64, 2)]),
                              db)
        tree, leaf, idx, nodes = _statement(PORT, 4)
        with pytest.raises((RuntimeError, AssertionError)):
            smt4.gen_proof_of_leaf_inclusion_4_ary_merkle_tree(
                leaf, idx, None, nodes, tree.root, tree.depth,
                tree.hash_params, "quint", random.Random(1), b"x",
                PORT.G1.from_msg_hash(b"g"), PORT.G1.from_msg_hash(b"h"),
                PORT.gens("G", 64), PORT.gens("H", 64))


# ---------------------------------------------------------------------------
# 3. The depth-12 reference of chip_smoke.py's smt phase
# ---------------------------------------------------------------------------

def _jax_params(ref):
    p = ref["poseidon"]
    return JParams(p["width"], p["full_rounds_beginning"],
                   p["full_rounds_end"], p["partial_rounds"])


def _jax_update_roots(ref, count):
    """The JAX package's roots after the first `count` pairs of the first
    batch on a fresh tree, and (count None) after both batches."""
    upd = ref["updates"]
    rnd = random.Random(upd["seed"])
    batches = [[(JAX.Scalar(rnd.randrange(4 ** ref["depth"])),
                 JAX.Scalar.random(rnd)) for _ in range(upd["batch"])]
               for _ in range(2)]
    db = JDb()
    tree = jhelper4.VanillaSparseMerkleTree_4(_jax_params(ref), ref["depth"],
                                              db)
    for pairs in ([batches[0][:count]] if count else batches):
        tree.batch_update(pairs, db)
    return tree.root.to_bytes().hex()


def _jax_proof(ref, depth, params, n):
    """The JAX package's native `Prover._prove` proof of `ref["proof"]`'s
    statement -> (proof, commitments, tree root, multipliers)."""
    pr = ref["proof"]
    db = JDb()
    tree = jhelper4.VanillaSparseMerkleTree_4(params, depth, db)
    key = JAX.Scalar(pr["key"])
    tree.update(key, JAX.Scalar(pr["value"]), db)
    nodes = []
    leaf = tree.get(key, nodes, db)
    rng = random.Random(pr["rng_seed"])
    p = JAX.Prover(JAX.G1.from_msg_hash(b"g"), JAX.G1.from_msg_hash(b"h"),
                   JAX.Transcript(pr["label"].encode()), rng=rng)
    comms = jsmt4.prove_leaf_inclusion_4_ary_merkle_tree(
        leaf, key, None, nodes, tree.root, depth, params,
        ref["poseidon"]["sbox"], rng, p)
    with _native():
        proof = p._prove(JAX.gens("G", n), JAX.gens("H", n))
    return proof, comms, tree.root, p.num_multipliers()


def test_smt4_d12_proof_reference_digest():
    """tests/vectors/torch_smt4_d12.json holds the JAX package's digest of
    chip_smoke.py's depth-12 proof (n = 4096)."""
    ref = json.loads(REFERENCE.read_text())
    pr = ref["proof"]
    assert (ref["depth"], pr["n"], ref["curve"]) == (12, 4096, "bls381")
    proof, _, root, multipliers = _jax_proof(ref, ref["depth"],
                                             _jax_params(ref), pr["n"])
    assert (hashlib.sha256(proof.to_bytes()).hexdigest(),
            root.to_bytes().hex(), multipliers) == \
        (pr["sha256"], pr["tree_root"], pr["multipliers"])


def test_smt4_d12_prefix_root():
    """The JAX package's root after the first 256 pairs of the first
    4096-pair batch (the whole batches are the slow test below)."""
    ref = json.loads(REFERENCE.read_text())
    upd = ref["updates"]
    assert _jax_update_roots(ref, upd["prefix"]) == upd["root_prefix"]


@pytest.mark.slow
def test_smt4_d12_update_root():
    """The JAX package's root after both 4096-pair batches (over a minute
    on one CPU core: each batch runs 12 levels of the device Poseidon)."""
    ref = json.loads(REFERENCE.read_text())
    assert _jax_update_roots(ref, None) == \
        ref["updates"]["root_both_batches"]


def test_chip_smoke_smt_phase_rehearses_on_cpu(proofs):
    """chip_smoke.py's smt phase on the CPU at a tiny size (`_smt4_ref`:
    16 hashes, two batches of 24 updates, the depth-2 proof at n = 64,
    made by the `proofs` fixture), its reference made by the JAX package:
    the root, the proof digest, the host check and the tampered proof,
    with no kernel launched; the MSM shapes it reports are the 3-set
    witness MSM, the IPA's two-set one and the verifier's."""
    chip_smoke = importlib.import_module("chip_smoke")
    rehearsal = proofs["rehearsal"]
    ref, line = rehearsal["ref"], rehearsal["line"]
    assert rehearsal["launches"] == {k: 0 for k in ek.launches}
    assert line["phase"] == "smt" and line["n"] == 64
    assert line["matches_reference"] and line["tampered_rejected"]
    assert {"phase1_msm", "zfold", "tpoly", "ipa_msm", "other"} <= \
        set(line["smt4_d12_prove_stage_seconds"])
    assert {sets for _, sets, _, _, _ in rehearsal["msms"]} == {1, 2, 3}
    with pytest.raises(AssertionError):
        chip_smoke.phase_smt("cpu", {**ref, "updates": {
            **ref["updates"], "root_both_batches": "00"}}, 16, 0)
