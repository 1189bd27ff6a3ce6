"""ed25519 through the port on the CPU against the JAX package.

ed25519 is the one curve of config.py with a != 0 (its short Weierstrass
form; the reference's `ed25519` cargo feature): its group law is RCB16
algorithm 1, which kernels 2, 3 and 4 run on the card, and its
transcripts absorb Edwards coordinates, so its IPA runs per round.  Here
the wrappers run their plain versions.  The device MSM's bucket arrays,
window totals and result equal the JAX package's `msm_device` limb for
limb; an IPA at n = 16 and the gadget proofs of the JAX package's
tests/test_ed25519.py (a range proof at n = 32, set membership, a Poseidon
preimage at fewer rounds) are byte for byte the JAX package's native
proofs; the JAX package's digests of tests/vectors/torch_ed25519.json
(the full-width config 2 and the gadgets at their sizes, which
chip_smoke.py's ed25519 phase and the card tests hold the card to) are
re-made; the phase's control flow is rehearsed.  Every comparison is exact.
"""

import contextlib
import hashlib
import importlib
import json
import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bulletproofs_tpu as jbp
from bulletproofs_tpu import backend as jbackend
from bulletproofs_tpu import config as jconfig
from bulletproofs_tpu import ipp as jipp
from bulletproofs_tpu.models import bound_check as jbound_check
from bulletproofs_tpu.ops import ec_jax as ej
from bulletproofs_tpu.ops import field_jax as fj
from bulletproofs_tpu.ops import msm as jmsm
from bulletproofs_tpu.ops.ec_host import G1 as JG1

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import ec_kernels as ek
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops.field_host import inner_product
from bulletproofs_tpu_torch.utils.errors import VerificationError

# One torch thread: the suite runs several test processes at once, and
# each process's own thread pool would oversubscribe the cores.
torch.set_num_threads(1)

CV, JCV = config.ED25519, jconfig.ED25519
REFERENCE = Path(__file__).resolve().parent / "vectors" \
    / "torch_ed25519.json"
# the Poseidon preimage statement at a CPU size: 1 + 1 full and 2 partial
# rounds (the reference's 4 + 4 and 55 run on the card)
CPU_POSEIDON_ROUNDS = (1, 1, 2)


@contextlib.contextmanager
def _jax_native():
    """The JAX package on ed25519 with its native backend (the bytes are
    those of its device prover), whatever an imported test module set."""
    old = jbackend._mode
    jbackend.set_backend("cpp")
    try:
        with jconfig.using_curve(JCV):
            yield
    finally:
        jbackend.set_backend(old)


def test_msm_buckets_totals_and_result_match_jax():
    """n = 64 points (16 random bases repeated), uniform scalars with 0, 1
    and r - 1 among them: the bucket arrays after the rounds and both
    folds (kernel 2's plain version on projective rows: a != 0 never
    takes kernel 1), the window totals and `msm_device`'s result equal the
    JAX package's limb for limb, and the host sum."""
    ctx, jctx = E.CurveCtx(CV), ej.CurveCtx(JCV)
    assert not M.uses_mixed(ctx, affine=True)
    n = 64
    c = M.pick_window(n)
    W = -(-CV.fr.n_bits // c)
    rnd = random.Random(0xED64)
    base = [bt.G1.random(rnd, CV) for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    ks = [rnd.randrange(CV.r) for _ in range(n)]
    ks[0], ks[1], ks[2] = 0, 1, CV.r - 1
    jP = np.asarray(ej.to_device_points([JG1(p.X, p.Y, p.Z, JCV)
                                         for p in pts], jctx))
    js = np.asarray(ej.to_device_scalars(ks, jctx))
    rounds = M.occupancy_guess(n, ctx, c)

    @jax.jit
    def jax_side(P, s):
        """`msm_device`'s program (`_msm_device_jit`) with its
        intermediates: buckets, occupancy, window totals, the result."""
        plan = jmsm.window_plan(jctx, c, dup=True)
        buckets, occ = jmsm.bucket_accumulate(P, fj.get_digits(s, c, W),
                                              jctx, c, rounds, plan=plan)
        rowsum, colsum = jmsm.bucket_rowcol(buckets, jctx, c)
        return (buckets, occ, jmsm.window_totals(rowsum, colsum, jctx, c),
                jmsm.combine_from_rowcol(rowsum, colsum, jctx, c))

    want_buckets, jocc, want_totals, want = jax_side(jP, js)
    P = E.from_jax_points(jP, "cpu")
    s = E.from_jax_scalars(js, "cpu")
    buckets, occ = M.bucket_accumulate(P, F.get_digits(s, c, W), ctx, c,
                                       rounds, plan=M.window_plan(
                                           ctx, c, dup=True))
    assert occ == int(jocc) <= rounds
    np.testing.assert_array_equal(E.to_jax_points(F.unpack32(buckets, 1)),
                                  np.asarray(want_buckets))
    rowsum, colsum = M.bucket_rowcol(buckets, ctx, c)
    np.testing.assert_array_equal(
        E.to_jax_points(F.unpack32(M.window_totals(rowsum, colsum, ctx, c),
                                   1)), np.asarray(want_totals))
    got = M.msm_device(P, s, ctx, c, affine=True)
    np.testing.assert_array_equal(E.to_jax_points(got), np.asarray(want))
    assert E.from_device_points(got, ctx)[0] == bt.msm_host(pts, ks)


def test_ipa_matches_jax_package():
    """An IPA at n = 16 with random G/H factors, per round (the port's
    chunked and per-round bucket kernels' plain versions, its default on
    an Edwards curve): L, R, a, b and the transcript's next challenge are
    those of the JAX package's native `create_ipp`; the port's verifier
    accepts the proof and rejects a + 1."""
    n, label = 16, b"ed25519-ipa"
    rng = random.Random(0x1ED)
    with _jax_native():
        G, H = jbp.get_generators("G", n), jbp.get_generators("H", n)
        Q = JG1.from_msg_hash(b"Q", JCV)
        vecs = [[jbp.Scalar.random(rng, JCV) for _ in range(n)]
                for _ in range(4)]
        jargs = (Q, vecs[2], vecs[3], G, H, vecs[0], vecs[1])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jipp, "DEVICE_IPA_MIN_N", 1 << 30)
            tr = jbp.ProofTranscript(label)
            want = jipp.create_ipp(tr, *jargs)
        want_post = tr.challenge_scalar(b"post").v
    args = [E.from_jax_host(x, CV) for x in jargs]
    with config.using_curve(CV):
        for ec_kernel in ("chunk", "round"):
            tr = bt.ProofTranscript(label)
            proof = bt.create_ipp(tr, *args, device="cpu",
                                  ec_kernel=ec_kernel)
            assert [p.to_bytes() for p in proof.L] == \
                [p.to_bytes() for p in want.L]
            assert [p.to_bytes() for p in proof.R] == \
                [p.to_bytes() for p in want.R]
            assert (proof.a.v, proof.b.v) == (want.a.v, want.b.v)
            assert tr.challenge_scalar(b"post").v == want_post
        Q, Gf, Hf, G, H, a, b = args
        P = bt.msm_host(G + H + [Q], [x * f for x, f in zip(a, Gf)]
                        + [x * f for x, f in zip(b, Hf)]
                        + [inner_product(a, b)])
        verify = lambda a_fin: bt.verify_ipp(
            n, bt.ProofTranscript(label), Gf, Hf, P, Q, G, H, a_fin,
            proof.b, proof.L, proof.R, device="cpu")
        verify(proof.a)
        with pytest.raises(VerificationError):
            verify(proof.a + bt.Scalar(1, CV))


def _gadget_kw(name):
    return ({"poseidon_rounds": CPU_POSEIDON_ROUNDS}
            if name == "poseidon_preimage" else {})


@pytest.fixture(scope="module")
def gadget_proofs():
    """The three gadget statements (`chip_smoke.ed25519_gadget_case`,
    the Poseidon one at `CPU_POSEIDON_ROUNDS`) proved by the JAX package
    natively and by the port on the CPU, with 64 generators."""
    chip_smoke = importlib.import_module("chip_smoke")
    out = {}
    for name in chip_smoke.ED25519_GADGETS:
        with _jax_native():
            g, h = jbp.G1.from_msg_hash(b"g"), jbp.G1.from_msg_hash(b"h")
            prove, _ = chip_smoke.ed25519_gadget_case(jbp, name,
                                                      **_gadget_kw(name))
            jproof, _ = prove(g, h, jbp.get_generators("G", 64),
                              jbp.get_generators("H", 64))
        with config.using_curve(CV):
            g, h = bt.G1.from_msg_hash(b"g"), bt.G1.from_msg_hash(b"h")
            G, H = bt.get_generators("G", 64), bt.get_generators("H", 64)
            prove, verify = chip_smoke.ed25519_gadget_case(
                bt, name, device="cpu", **_gadget_kw(name))
            ek.reset_launches()
            proof, comms = prove(g, h, G, H)
            assert ek.launches == {k: 0 for k in ek.launches}
        out[name] = {"jax": jproof.to_bytes(), "port": proof,
                     "check": lambda pf, t, c=comms, v=verify, g=g, h=h,
                     G=G, H=H: v(pf, c, g, h, G, H, tampered=t)}
    return out


@pytest.mark.parametrize("name", ["bound_check", "set_membership",
                                  "poseidon_preimage"])
def test_gadget_proof_matches_jax_package(gadget_proofs, name):
    """Each gadget proof (the range proof: 42 in [0, 2^16], n = 32) is
    byte for byte the JAX package's native proof; the port's verifier
    accepts it and rejects the statement tampered."""
    case = gadget_proofs[name]
    assert case["port"].to_bytes() == case["jax"]
    with config.using_curve(CV):
        case["check"](case["port"], False)
        with pytest.raises(VerificationError):
            case["check"](case["port"], True)


def _jax_agg_digest(m, bits, seed):
    """sha256 of the JAX package's native proof of the bench's config-2
    statement (`bench.py:581-590`) on ed25519 at m values of `bits` bits."""
    n = m * 2 * bits
    with _jax_native():
        G, H = jbp.get_generators("G", n), jbp.get_generators("H", n)
        g, h = jbp.G1.from_msg_hash(b"g"), jbp.G1.from_msg_hash(b"h")
        rng = random.Random(seed)
        vs = [rng.randrange(1 << (bits - 1)) for _ in range(m)]
        p = jbp.Prover(g, h, jbp.ProofTranscript(b"AggRange"), rng=rng)
        for v in vs:
            jbound_check.prove_bounded_num(v, None, 0, (1 << bits) - 1,
                                           bits, rng, p)
        return hashlib.sha256(p._prove(G, H).to_bytes()).hexdigest()


def test_ed25519_reference_digests():
    """tests/vectors/torch_ed25519.json holds the JAX package's digests of
    chip_smoke.py's ed25519 statements: config 2 (m = 16, 64 bits,
    n = 2048, seed 2) and the three gadgets at their reference sizes."""
    ref = json.loads(REFERENCE.read_text())
    c2 = ref["config2"]
    assert (ref["curve"], c2["m"], c2["bits"], c2["n"]) == \
        ("ed25519", 16, 64, 2048)
    assert _jax_agg_digest(c2["m"], c2["bits"], c2["seed"]) == c2["sha256"]
    chip_smoke = importlib.import_module("chip_smoke")
    assert set(ref["gadgets"]) == set(chip_smoke.ED25519_GADGETS)
    n = chip_smoke.ED25519_GADGET_N
    with _jax_native():
        g, h = jbp.G1.from_msg_hash(b"g"), jbp.G1.from_msg_hash(b"h")
        G, H = jbp.get_generators("G", n), jbp.get_generators("H", n)
        for name, spec in ref["gadgets"].items():
            assert spec["seed"] == chip_smoke.ED25519_GADGETS[name][1]
            prove, _ = chip_smoke.ed25519_gadget_case(jbp, name)
            proof, _ = prove(g, h, G, H)
            assert 1 << len(proof.ipp_proof.L) == spec["n"]
            assert hashlib.sha256(proof.to_bytes()).hexdigest() == \
                spec["sha256"], name


def test_chip_smoke_ed25519_phase_rehearses_on_cpu(capsys, monkeypatch):
    """chip_smoke.py's ed25519 phase at n = 4 on the CPU: its IPA and its
    config 2 at m = 1 value of 4 bits against the JAX package's digest
    (made here) run in full (the host checks, the tampered proofs), with
    no kernel launched and no plain add on a CUDA tensor.  Its two MSM
    phases, which test_msm_buckets_totals_and_result_match_jax holds to
    the JAX package on ed25519, are only called, under ed25519 with the
    guard on; the gadgets (their full-size proofs run on the card) are
    left out; a wrong digest failing is phase_r1cs's own check
    (tests/test_torch_r1cs.py)."""
    chip_smoke = importlib.import_module("chip_smoke")
    msm_calls = []
    monkeypatch.setattr(
        chip_smoke, "phase_msm",
        lambda device, n, seed, bits, reps: msm_calls.append(
            (config.curve().name, E.ec_add.__name__, device, n, bits)))
    ref = json.loads(REFERENCE.read_text())
    digest = _jax_agg_digest(1, 4, 1)
    ref["config2"] = {"seed": 1, "sha256": digest}
    ek.reset_launches()
    out = chip_smoke.phase_ed25519("cpu", 4, 5, 0, ref, r1cs=(1, 4),
                                   gadgets=False)
    assert ek.launches == {k: 0 for k in ek.launches}
    assert msm_calls == [("ed25519", "guarded", "cpu", 4, False),
                         ("ed25519", "guarded", "cpu", 4, True)]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["phase"] for x in lines] == ["ipa", "r1cs", "ed25519"]
    assert all(x.get("curve", "ed25519") == "ed25519" for x in lines)
    assert lines[1]["matches_reference"] and lines[1]["tampered_rejected"]
    assert lines[1]["proof_sha256"] == digest
    assert lines[0]["round_kernel_proof_identical"]
    # the MSMs the phase ran, for `kernels_at`: the IPA's two-set MSMs,
    # the witness's and the bit vector's
    assert out["msms"] and {m[1] for m in out["msms"]} >= {1, 2}
    assert config.curve() == config.BLS381
    assert E.ec_add.__name__ == "ec_add"             # the guard is gone
