"""The port's sharded prover (bulletproofs_tpu_torch/parallel/
sharded_prover.py) against the JAX package's, on the CPU: the port on a
virtual mesh of 8 CPU shards, the JAX package on its 8 virtual devices.

The shapes are tests/test_sharded_prover.py's (the 2-set MSM at n = 64,
c = 4; the IPA at n = 32; the range proofs of 57 and 99 in 8 bits over 32
generators), so the JAX side's compiles are the ones that file makes.
IPA round scalars are compared limb for limb, MSM results as group
elements, proofs byte for byte; the JAX package's and the port's
verifiers accept the sharded proofs.
"""

import hashlib
import importlib
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import bulletproofs_tpu as jbp
from bulletproofs_tpu import ipp as jipp
from bulletproofs_tpu.config import BLS381 as JCV
from bulletproofs_tpu.ops import ec_jax as ej
from bulletproofs_tpu.parallel import make_mesh as jmake_mesh
from bulletproofs_tpu.parallel import sharded_prover as jsp
from bulletproofs_tpu.utils import get_generators as jget_generators

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.config import BLS381 as CV
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import ec_kernels as ek
from bulletproofs_tpu_torch.parallel import (create_ipp_sharded,
                                             msm_multi_sharded,
                                             prove_sharded)
from bulletproofs_tpu_torch.parallel import sharded_msm as SM
from bulletproofs_tpu_torch.parallel import sharded_prover as SP

# One torch thread: the suite runs several test processes at once.
torch.set_num_threads(1)

# the two-phase statement (`_prove_two_phase`) and its helpers
r1cs = importlib.import_module("test_torch_r1cs")


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8
    return SM.make_mesh(["cpu"] * 8), jmake_mesh(jax.devices()[:8])


def test_msm_multi_sharded_matches_jax_and_host(meshes):
    """Two uniform sets at n = 64, c = 4 (tests/test_sharded_prover.py's
    `test_sharded_multi_msm` inputs): the port's sets equal `msm_host` and
    the JAX package's `msm_multi_sharded` (the escalation to
    pre-reduction: chip_smoke.py's phase 12, rehearsed below)."""
    mesh, jmesh = meshes
    rng = random.Random(0xB1E55)
    ctx, jctx = E.CurveCtx(CV), ej.CurveCtx(JCV)
    n = 64
    jpts = [jbp.G1.random(rng) for _ in range(n)]
    k1 = [jbp.Scalar.random(rng) for _ in range(n)]
    k2 = [jbp.Scalar.random(rng) for _ in range(n)]
    want = jsp.msm_multi_sharded(
        ej.to_device_points(jpts, jctx),
        jnp.stack([ej.to_device_scalars(k1, jctx),
                   ej.to_device_scalars(k2, jctx)], axis=0), jctx, 4, jmesh)
    pts = E.from_jax_host(jpts, CV)
    Pt = E.to_device_points(pts, ctx, "cpu")
    ks = [[k.v for k in ks] for ks in (k1, k2)]
    got = msm_multi_sharded(
        Pt, torch.stack([E.to_device_scalars(k, ctx, "cpu") for k in ks]),
        ctx, 4, mesh)
    assert got == [bt.msm_host(pts, k) for k in ks]
    assert got == E.from_jax_host(want, CV)


def _ipa_state(n, seed):
    """Montgomery (Lr, n) A, B, rG, rH and a challenge's u, u^-1, as
    ints."""
    rnd = random.Random(seed)
    vecs = [[rnd.randrange(CV.r) for _ in range(n)] for _ in range(4)]
    u = rnd.randrange(1, CV.r)
    return vecs, u, pow(u, -1, CV.r)


@pytest.mark.parametrize("n_j", [32, 8, 4])
def test_rounds_a_and_b_match_jax(meshes, n_j):
    """Round A (the L and R scalar slices of every shard over its [G_s |
    H_s], c_L and c_R) and round B (the fold and the factors' update) at
    n = 32 over 8 shards (4 entries each): n_j = 32 and 8 exchange
    shards (partners 2 and 1 apart), n_j = 4 swaps within each shard.
    Limb for limb against `_round_a_jit` / `_round_b_jit` at the tiling
    n / n_j of that round."""
    mesh, jmesh = meshes
    n, d = 32, 8
    ns = n // d
    jctx = ej.CurveCtx(JCV)
    fr = E.CurveCtx(CV).fr
    vecs, u, u_inv = _ipa_state(n, 300 + n_j)
    tiles = n // n_j
    # the JAX arrays as `create_ipp_sharded` makes them
    sh = NamedSharding(jmesh, P(None, jsp.AXIS))
    jA, jB, jrG, jrH = (jax.device_put(jctx.fr.to_mont(v), sh) for v in vecs)
    inv_tiles = pow(tiles, -1, CV.r) * jctx.fr.fp.mont_r % CV.r \
        if tiles > 1 else jctx.fr.fp.mont_r % CV.r
    scal2, cL, cR = jsp._round_a_jit(jA, jB, jrG, jrH, jctx, n_j, jmesh,
                                     inv_tiles)
    u_m, u_inv_m = jctx.fr.to_mont([u]), jctx.fr.to_mont([u_inv])
    want_b = jsp._round_b_jit(jA, jB, jrG, jrH, u_m, u_inv_m, jctx, n_j,
                              jmesh)

    A, B, rG, rH = (SM.split_shards(fr.to_mont(v, "cpu"), mesh)
                    for v in vecs)
    sets, cLR = SP._round_a(A, B, rG, rH, n_j, ns, tiles, fr)
    assert all(s.shape == (2, fr.L, 2 * ns) for s in sets)
    np.testing.assert_array_equal(E.to_jax_points(torch.cat(sets, -1)),
                                  np.asarray(scal2))
    np.testing.assert_array_equal(E.to_jax_points(cLR[:, :1]),
                                  np.asarray(cL))
    np.testing.assert_array_equal(E.to_jax_points(cLR[:, 1:]),
                                  np.asarray(cR))
    cpu = torch.device("cpu")
    got_b = SP._round_b(A, B, rG, rH, {cpu: fr.to_mont([u], cpu)},
                        {cpu: fr.to_mont([u_inv], cpu)}, n_j, ns, fr)
    for g, w in zip(got_b, want_b):
        np.testing.assert_array_equal(E.to_jax_points(torch.cat(g, -1)),
                                      np.asarray(w))


def test_create_ipp_sharded_matches(meshes):
    """The sharded IPA at n = 32 on 8 shards (tests/test_sharded_prover.py's
    inputs) has the bytes of the JAX package's `create_ipp` and of the
    port's `create_ipp(device="cpu")`; n not a multiple of the mesh size
    raises."""
    mesh, _ = meshes
    rng = random.Random(0xB1E55)
    n = 32
    G, H = jget_generators("G", n), jget_generators("H", n)
    Q = jbp.G1.from_msg_hash(b"Q")
    a, b, Gf, Hf = ([jbp.Scalar.random(rng) for _ in range(n)]
                    for _ in range(4))
    want = jipp.create_ipp(jbp.ProofTranscript(b"ipa"), Q, Gf, Hf, G, H, a,
                           b)
    port = [E.from_jax_host(x, CV) for x in (G, H, a, b, Gf, Hf)]
    pG, pH, pa, pb, pGf, pHf = port
    pQ = E.from_jax_host(Q, CV)
    single = bt.create_ipp(bt.ProofTranscript(b"ipa"), pQ, pGf, pHf, pG, pH,
                           pa, pb, device="cpu")
    L, R, af, bf = create_ipp_sharded(bt.ProofTranscript(b"ipa"), pQ, pGf,
                                      pHf, pG, pH, pa, pb, mesh)
    got = ([p.to_bytes() for p in L], [p.to_bytes() for p in R],
           af.to_bytes(), bf.to_bytes())
    for ref in (want, single):
        assert got == ([p.to_bytes() for p in ref.L],
                       [p.to_bytes() for p in ref.R], ref.a.to_bytes(),
                       ref.b.to_bytes())
    with pytest.raises(ValueError, match="multiple of the mesh"):
        create_ipp_sharded(bt.ProofTranscript(b"ipa"), pQ, pGf[:4], pHf[:4],
                           pG[:4], pH[:4], pa[:4], pb[:4], mesh)


def _mesh_statement(ns, prove):
    """tests/test_sharded_prover.py's `test_sharded_full_proof` statement:
    57 and 99 in [0, 255], 8 bits each, seed 0x5EED, 32 generators.
    -> (proof, commitments, (G, H, g, h))."""
    rng = random.Random(0x5EED)
    G, H = ns.gens("G", 32), ns.gens("H", 32)
    g, h = ns.G1.from_msg_hash(b"g"), ns.G1.from_msg_hash(b"h")
    kw = {"device": "cpu"} if ns is r1cs.PORT else {}
    p = ns.Prover(g, h, ns.Transcript(b"mesh"), rng=rng, **kw)
    comms = [ns.bound_check.prove_bounded_num(v, None, 0, 255, 8, rng, p)
             for v in (57, 99)]
    return prove(p, G, H), comms, (G, H, g, h)


def _mesh_verify(ns, proof, comms, bases, **kw):
    G, H, g, h = bases
    v = ns.Verifier(ns.Transcript(b"mesh"), **kw)
    for cm in comms:
        ns.bound_check.verify_bounded_num(0, 255, 8, cm, v)
    v.verify(proof, g, h, G, H)


@pytest.mark.parametrize("statement", ["bound_pair", "two_phase"])
def test_prove_sharded_matches_jax(meshes, statement):
    """`prove_sharded` on 8 CPU shards: the bytes of the JAX package's
    `Prover._prove`, accepted by the port's verifier and the JAX
    package's.  The two-phase statement is tests/test_torch_r1cs.py's
    (phase-2 commitments on the mesh's first device)."""
    mesh, _ = meshes
    sharded = lambda p, G, H: prove_sharded(p, G, H, mesh)
    native = lambda p, G, H: p._prove(G, H)
    if statement == "bound_pair":
        proof, comms, bases = _mesh_statement(r1cs.PORT, sharded)
        want, jcomms, jbases = _mesh_statement(r1cs.JAX, native)
        _mesh_verify(r1cs.PORT, proof, comms, bases, device="cpu")
        _mesh_verify(r1cs.JAX, jbp.R1CSProof.from_bytes(proof.to_bytes()),
                     jcomms, jbases)
    else:
        proof, comms = r1cs._prove(r1cs.PORT, statement, sharded,
                                   device="cpu")
        want, jcomms = r1cs._prove(r1cs.JAX, statement, native)
        G, H, g, h = r1cs._bases(r1cs.PORT)
        r1cs._verifier(r1cs.PORT, statement, comms, device="cpu").verify(
            proof, g, h, G, H)
        G, H, g, h = r1cs._bases(r1cs.JAX)
        r1cs._verifier(r1cs.JAX, statement, jcomms).verify(
            jbp.R1CSProof.from_bytes(proof.to_bytes()), g, h, G, H)
    assert isinstance(proof, bt.R1CSProof)
    assert proof.to_bytes() == want.to_bytes()
    assert _flat(comms) == _flat(jcomms)


def _flat(comms):
    """Commitment bytes of a statement, its gadgets' lists flattened."""
    if isinstance(comms, (list, tuple)):
        return [b for c in comms for b in _flat(c)]
    return [comms.to_bytes()]


def test_chip_smoke_sharded_phase_rehearses_on_cpu(capsys):
    """Phase 12 on 2 CPU shards (the card runs 4), where the wrappers run
    their plain versions: the MSMs at n = 512 (the bit vector
    pre-reduces; a 2 x 1 mesh for `msm_sharded_2d`), the IPA at
    n = 16 (its bytes the single-device proof's), the r1cs statement at
    m = 1 value of 2 bits (its reference digest the port's own
    single-device proof), with no kernel launched."""
    chip_smoke = importlib.import_module("chip_smoke")
    with config.using_curve(CV):
        G, H = bt.get_generators("G", 4), bt.get_generators("H", 4)
        g, h = bt.G1.from_msg_hash(b"g", CV), bt.G1.from_msg_hash(b"h", CV)
        prover, _ = chip_smoke._agg_range_prover(1, 1, 2, g, h, "cpu")
        ref = {"seed": 1, "sha256": hashlib.sha256(
            prover.prove(G, H).to_bytes()).hexdigest()}
        ek.reset_launches()
        res = chip_smoke.phase_sharded("cpu", 512, 7, 0, ref, (1, 2),
                                       shards=2, ipa_n=16)
    assert ek.launches == {k: 0 for k in ek.launches}
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "sharded" and line["shards"] == 2
    assert line["matches_reference"] and line["tampered_rejected"]
    assert line["ipa_bytes_identical"] and line["bits_pre_reduce"] > 0
    assert {"phase1_msm", "sharded_passes", "sharded_butterfly",
            "sharded_combine", "ipa_scal", "ipa_msm", "ipa_fold", "zfold",
            "tpoly", "other"} <= set(line["r1cs_sharded_stage_seconds"])
    # per-shard shapes: the uniform MSM (Horner on the device), the bit
    # vector (pre-reduced), the IPA's and the proof's two-set and
    # three-set MSMs; no duplicate rows
    shapes = {(m[1], m[4] > 0, m[6]) for m in res["msms"]}
    assert {(1, False, True), (1, True, False), (2, False, False)} <= shapes
    assert {m[1] for m in res["msms"]} == {1, 2, 3}
    assert all(m[7] is False for m in res["msms"])
