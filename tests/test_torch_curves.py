"""The port's proofs on BN254 and secp256k1 against the JAX package's, on
the CPU: a standalone inner-product argument at n = 64 and a small
aggregated range proof (m = 2 values of 8 bits, n = 32; the bench's
config-2 statement, `chip_smoke._agg_range_prover`), each byte-identical
to the JAX package's native prover (`Prover._prove`, `ipp.create_ipp` on
its cpp backend; the bytes of its device prover, tests/test_torch_r1cs.py
and tests/test_torch_ipa.py) and accepted by both packages' verifiers.
Inputs are made from a seed on each side; proofs are integers, so every
comparison is exact.
"""

import contextlib
import random

import pytest
import torch

from bulletproofs_tpu import backend as jbackend
from bulletproofs_tpu import config as jconfig
from bulletproofs_tpu import ipp as jipp
import bulletproofs_tpu as jbp
from bulletproofs_tpu.models import bound_check as jbound_check
from bulletproofs_tpu.ops.field_host import inner_product as jinner
from bulletproofs_tpu.utils import get_generators as jget_generators

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.models import bound_check
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.utils.errors import VerificationError

# One torch thread: the suite runs several test processes at once, and
# each process's own thread pool would oversubscribe the cores.
torch.set_num_threads(1)

CURVES = ["bn254", "secp256k1"]
N_IPA = 64
M_VALUES, BITS = 2, 8
IPA_LABEL = b"curves-ipa"


@contextlib.contextmanager
def _on(curve):
    """Both packages on `curve`, the JAX package on its native backend
    (whatever an imported test module set)."""
    old = jbackend._mode
    jbackend.set_backend("cpp")
    try:
        with jconfig.using_curve(curve), config.using_curve(curve):
            yield config.CURVES[curve], jconfig.CURVES[curve]
    finally:
        jbackend.set_backend(old)


def _ipa_bytes(proof):
    return ([p.to_bytes() for p in proof.L], [p.to_bytes() for p in proof.R],
            proof.a.v, proof.b.v)


@pytest.fixture(scope="module", params=CURVES)
def ipa(request):
    """An IPA at n = 64 with random G and H factors: the JAX package's
    proof (native host path) and the port's (CPU), on one curve."""
    with _on(request.param) as (cv, jcv):
        rng = random.Random(0xC0 + N_IPA)
        G, H = jget_generators("G", N_IPA), jget_generators("H", N_IPA)
        Q = jbp.G1.from_msg_hash(b"Q")
        a, b, Gf, Hf = ([jbp.Scalar.random(rng) for _ in range(N_IPA)]
                        for _ in range(4))
        jargs = (Q, Gf, Hf, G, H, a, b)
        P = jbp.G1.identity(jcv)
        scal = ([x * f for x, f in zip(a, Gf)]
                + [x * f for x, f in zip(b, Hf)] + [jinner(a, b)])
        for pt, k in zip(G + H + [Q], scal):
            P = P + pt * k
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jipp, "DEVICE_IPA_MIN_N", 1 << 30)
            jproof = jipp.create_ipp(jbp.ProofTranscript(IPA_LABEL), *jargs)
        args = [E.from_jax_host(x, cv) for x in jargs]
        proof = bt.create_ipp(bt.ProofTranscript(IPA_LABEL), *args,
                              device="cpu")
        return {"curve": request.param, "jargs": jargs, "jP": P,
                "args": args, "P": E.from_jax_host(P, cv),
                "jproof": jproof, "proof": proof}


def test_ipa_bytes_match_jax_package(ipa):
    assert len(ipa["proof"].L) == N_IPA.bit_length() - 1
    assert _ipa_bytes(ipa["proof"]) == _ipa_bytes(ipa["jproof"])


@pytest.mark.parametrize("whose", ["port", "jax"])
def test_ipa_verifiers_accept_the_port_proof(ipa, whose):
    """The port's `verify_ipp` (CPU) and the JAX package's (native host
    path) accept the port's proof, handed to the JAX package as its own
    objects."""
    proof = ipa["proof"]
    with _on(ipa["curve"]) as (cv, jcv):
        if whose == "port":
            Q, Gf, Hf, G, H, _, _ = ipa["args"]
            bt.verify_ipp(N_IPA, bt.ProofTranscript(IPA_LABEL), Gf, Hf,
                          ipa["P"], Q, G, H, proof.a, proof.b, proof.L,
                          proof.R, device="cpu")
            return
        Q, Gf, Hf, G, H, _, _ = ipa["jargs"]
        conv = lambda p: jbp.G1(p.X, p.Y, p.Z, jcv)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jipp, "DEVICE_IPA_MIN_N", 1 << 30)
            jipp.verify_ipp(N_IPA, jbp.ProofTranscript(IPA_LABEL), Gf, Hf,
                            ipa["jP"], Q, G, H, jbp.Scalar(proof.a.v, jcv),
                            jbp.Scalar(proof.b.v, jcv),
                            [conv(p) for p in proof.L],
                            [conv(p) for p in proof.R])


def _agg_statement(ns, bc, seed, device=None):
    """The bench's config-2 statement at M_VALUES values of BITS bits over
    either package (`ns`: bt or the JAX package, `bc` its bound_check):
    -> (prover, commitments per value, n)."""
    rng = random.Random(seed)
    vs = [rng.randrange(1 << (BITS - 1)) for _ in range(M_VALUES)]
    g, h = ns.G1.from_msg_hash(b"g"), ns.G1.from_msg_hash(b"h")
    kw = {} if device is None else {"device": device}
    prover = ns.Prover(g, h, ns.ProofTranscript(b"AggRange"), rng=rng, **kw)
    comms = [bc.prove_bounded_num(v, None, 0, (1 << BITS) - 1, BITS, rng,
                                  prover) for v in vs]
    return prover, comms, M_VALUES * 2 * BITS


def _agg_verify(ns, bc, comms, proof, device=None):
    kw = {} if device is None else {"device": device}
    verifier = ns.Verifier(ns.ProofTranscript(b"AggRange"), **kw)
    for c in comms:
        bc.verify_bounded_num(0, (1 << BITS) - 1, BITS, c, verifier)
    n = M_VALUES * 2 * BITS
    verifier.verify(proof, ns.G1.from_msg_hash(b"g"),
                    ns.G1.from_msg_hash(b"h"), ns.get_generators("G", n),
                    ns.get_generators("H", n))


@pytest.fixture(scope="module", params=CURVES)
def agg(request):
    """The aggregated range proof of seed 3 by the port (CPU) and by the
    JAX package's native prover, on one curve."""
    with _on(request.param):
        prover, comms, n = _agg_statement(bt, bound_check, 3, device="cpu")
        proof = prover.prove(bt.get_generators("G", n),
                             bt.get_generators("H", n))
        jprover, jcomms, _ = _agg_statement(jbp, jbound_check, 3)
        jproof = jprover._prove(jget_generators("G", n),
                                jget_generators("H", n))
        return {"curve": request.param, "proof": proof, "comms": comms,
                "jproof": jproof, "jcomms": jcomms}


def test_aggregated_range_proof_bytes_match_jax_package(agg):
    as_bytes = lambda comms: [[c.to_bytes() for c in cs] for cs in comms]
    assert as_bytes(agg["comms"]) == as_bytes(agg["jcomms"])
    assert agg["proof"].to_bytes() == agg["jproof"].to_bytes()


@pytest.mark.parametrize("whose", ["port", "jax"])
def test_aggregated_range_verifiers_accept_the_port_proof(agg, whose):
    """`Verifier.verify` of the port (CPU) and of the JAX package (its
    native host path) accept the port's proof bytes; t_x + 1 is
    rejected by the port's."""
    blob = agg["proof"].to_bytes()
    with _on(agg["curve"]):
        if whose == "port":
            _agg_verify(bt, bound_check, agg["comms"],
                        bt.R1CSProof.from_bytes(blob), device="cpu")
            bad = bt.R1CSProof.from_bytes(blob)
            bad.t_x = bad.t_x + bt.Scalar.one()
            with pytest.raises(VerificationError):
                _agg_verify(bt, bound_check, agg["comms"], bad,
                            device="cpu")
        else:
            _agg_verify(jbp, jbound_check, agg["jcomms"],
                        jbp.R1CSProof.from_bytes(blob))
