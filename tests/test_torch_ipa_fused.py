"""The port's fused IPA (bulletproofs_tpu_torch/ops/prover_device.py:
create_ipp_implicit_fused, every round and its transcript on the device,
one fetch) against the JAX package's fused IPA, the port's per-round path
and the port's verifier, on the CPU, where every wrapper runs its plain
version.

The JAX package's fused proof comes from its `create_ipp` on its jax
backend with BP_IPA_FUSED=1 and DEVICE_IPA_MIN_N = 1, as
tests/test_ipa_fused.py makes it; its one compile (~1 minute on one core)
is made once per module.  Every comparison is exact: point bytes, a, b
and the transcript's next challenge.
"""

import inspect
import random

import pytest
import torch

from bulletproofs_tpu import backend as jbackend
from bulletproofs_tpu import config as jconfig
from bulletproofs_tpu import ipp as jipp
from bulletproofs_tpu.ops.ec_host import G1 as JG1
from bulletproofs_tpu.ops.field_host import Scalar as JScalar
from bulletproofs_tpu.transcript import ProofTranscript as JTranscript
from bulletproofs_tpu.utils import get_generators as jget_generators

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops import prover_device as PD
from bulletproofs_tpu_torch.ops.ec_host import msm_host
from bulletproofs_tpu_torch.ops.field_host import inner_product
from bulletproofs_tpu_torch.utils.errors import VerificationError

torch.set_num_threads(1)

CV, JCV = config.BLS381, jconfig.BLS381
N = 16
LABEL = b"torch-ipa-fused"


def _bytes(proof):
    return ([p.to_bytes() for p in proof.L], [p.to_bytes() for p in proof.R],
            proof.a.v, proof.b.v)


def _port_inputs(cv, n, seed):
    """(Q, G_factors, H_factors, G, H, a, b) of the port at n on cv."""
    rng = random.Random(seed)
    with config.using_curve(cv):
        G, H = bt.get_generators("G", n), bt.get_generators("H", n)
    rs = lambda: [bt.Scalar.random(rng, cv) for _ in range(n)]
    Q = bt.G1.from_msg_hash(b"Q", cv)
    a, b, Gf, Hf = rs(), rs(), rs(), rs()
    return Q, Gf, Hf, G, H, a, b


def _port_proof(cv, args, **kw):
    """The port's proof on the CPU and the transcript's next challenge."""
    with config.using_curve(cv):
        tr = bt.ProofTranscript(LABEL)
        proof = bt.create_ipp(tr, *args, device="cpu", **kw)
        return proof, tr.challenge_scalar(b"post").v


@pytest.fixture(scope="module")
def proofs():
    """At n = 16 on BLS12-381, random factors: the JAX package's fused
    proof, the port's fused proof (fused=True, its stages recorded) and
    the port's per-round proof (the default on the CPU, and fused=False),
    each with the next challenge."""
    rng = random.Random(0xF05E)
    G, H = jget_generators("G", N), jget_generators("H", N)
    Q = JG1.from_msg_hash(b"Q", JCV)
    rs = lambda: [JScalar.random(rng, JCV) for _ in range(N)]
    a, b, Gf, Hf = rs(), rs(), rs(), rs()
    jargs = (Q, Gf, Hf, G, H, a, b)
    old = jbackend._mode
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jipp, "DEVICE_IPA_MIN_N", 1)
        mp.setenv("BP_IPA_FUSED", "1")
        jbackend.set_backend("jax")
        try:
            tr = JTranscript(LABEL)
            jproof = jipp.create_ipp(tr, *jargs)
        finally:
            jbackend.set_backend(old)
    args = [E.from_jax_host(x, CV) for x in jargs]
    PD._prof.enabled = True
    PD._prof.take()
    try:
        fused = _port_proof(CV, args, fused=True)
    finally:
        PD._prof.enabled = False
    return {"args": args, "jax": (jproof, tr.challenge_scalar(b"post").v),
            "fused": fused, "stages": PD._prof.take(),
            "per_round": _port_proof(CV, args, fused=False),
            "default": _port_proof(CV, args)}


def test_fused_proof_matches_jax_fused(proofs):
    proof, post = proofs["fused"]
    want, want_post = proofs["jax"]
    assert len(proof.L) == N.bit_length() - 1
    assert _bytes(proof) == _bytes(want)
    assert post == want_post
    # the fused path ran, its launches and its one fetch timed as stages
    assert set(proofs["stages"]) == {"ipa_fused_kernel", "ipa_fused_fetch"}


def test_fused_matches_per_round_bls381(proofs):
    assert _bytes(proofs["fused"][0]) == _bytes(proofs["per_round"][0])
    assert proofs["fused"][1] == proofs["per_round"][1]


def test_fused_matches_per_round_bn254():
    args = _port_inputs(config.BN254, 4, 0xB254)
    fused, post = _port_proof(config.BN254, args, fused=True)
    per_round, post_r = _port_proof(config.BN254, args, fused=False)
    assert _bytes(fused) == _bytes(per_round) and post == post_r
    assert fused.a.cv is config.BN254


def _verify(args, proof, n, cv, **change):
    Q, Gf, Hf, G, H, a, b = args
    P = msm_host(G + H + [Q], [x * f for x, f in zip(a, Gf)]
                 + [x * f for x, f in zip(b, Hf)] + [inner_product(a, b)])
    kw = dict(a=proof.a, b=proof.b, L=proof.L, R=proof.R)
    kw.update(change)
    with config.using_curve(cv):
        bt.verify_ipp(n, bt.ProofTranscript(LABEL), Gf, Hf, P, Q, G, H,
                      kw["a"], kw["b"], kw["L"], kw["R"], device="cpu")


def test_fused_proof_verifies_and_a_plus_1_is_rejected(proofs):
    proof = proofs["fused"][0]
    _verify(proofs["args"], proof, N, CV)
    with pytest.raises(VerificationError):
        _verify(proofs["args"], proof, N, CV, a=proof.a + bt.Scalar.one(CV))


def test_escalation_reruns_to_the_same_bytes(monkeypatch):
    """With `_fused_memo` seeded at one bucket round, the first run's
    occupancy exceeds it: the IPA runs again from the same transcript
    state at the escalated shape, and the memo keeps that shape."""
    n = 2
    args = _port_inputs(CV, n, 0xE5C)
    key = (n, M.pick_window(2 * n + 2), CV.name)
    monkeypatch.setitem(PD._fused_memo, key, (1, 0))
    runs = []
    real = PD._ipa_fused_rounds
    monkeypatch.setattr(PD, "_ipa_fused_rounds", lambda *a, **k: (
        runs.append(a[8:10]), real(*a, **k))[1])
    fused, post = _port_proof(CV, args, fused=True)
    per_round, post_r = _port_proof(CV, args, fused=False)
    assert _bytes(fused) == _bytes(per_round) and post == post_r
    assert runs[0] == (1, 0) and len(runs) >= 2
    assert PD._fused_memo[key] == runs[-1] != (1, 0)


def test_edwards_curve_takes_the_per_round_path(monkeypatch):
    """ed25519 transcripts absorb Edwards coordinates, which the device
    serializer does not emit: its IPA runs per round, and verifies."""
    def refuse(*a, **k):
        raise AssertionError("the fused path ran for ed25519")
    monkeypatch.setattr(PD, "create_ipp_implicit_fused", refuse)
    cv = config.ED25519
    args = _port_inputs(cv, 2, 0xED)
    proof, _ = _port_proof(cv, args, fused=True)
    _verify(args, proof, 2, cv)


def test_fused_is_the_default_and_raises_without_fallback(monkeypatch,
                                                         proofs):
    """`fused` defaults to None: fused on a card (tests/test_torch_cuda.py
    holds that), per round on CPU tensors, which give the same bytes; a
    fused IPA whose device bytes are not a point raises, and no per-round
    run follows."""
    for fn in (bt.create_ipp, PD.create_ipp_device, PD.create_ipp_implicit):
        assert inspect.signature(fn).parameters["fused"].default is None
    assert proofs["default"] == proofs["per_round"]
    assert _bytes(proofs["default"][0]) == _bytes(proofs["fused"][0])
    fused_runs = []
    real_fused = PD.create_ipp_implicit_fused
    monkeypatch.setattr(PD, "create_ipp_implicit_fused", lambda *a, **k: (
        fused_runs.append(1), real_fused(*a, **k))[1])
    _port_proof(CV, _port_inputs(CV, 2, 0xDEF))
    assert not fused_runs
    per_round = []
    monkeypatch.setattr(PD, "_create_ipp_per_round", lambda *a, **k:
                        per_round.append(1))
    real = PD.ipa_challenge

    def corrupt(pts32, state, regs, ctx):
        pb, st, u = real(pts32, state, regs, ctx)
        return pb ^ 1, st, u              # every byte changed
    monkeypatch.setattr(PD, "ipa_challenge", corrupt)
    with pytest.raises(RuntimeError, match="fused IPA: bad L bytes"):
        _port_proof(CV, _port_inputs(CV, 2, 0xBAD), fused=True)
    assert not per_round
