"""The port's R1CS prover and verifier (bulletproofs_tpu_torch: r1cs/,
models/bound_check.py, the R1CS parts of ops/prover_device.py and
ops/verifier_device.py) against the JAX package, on the CPU.

Three statements at the sizes of tests/test_prover_device.py (64
generators): the bound check 57 in [10, 100] with 8 bits (n = 16, the
masked-sum branch of the witness commitments), a chain of general products
(the 3-set MSM branch) and the same chain with a two-phase shuffle
(`specify_randomized_constraints`, phase-2 commitments).  For the same
`random.Random` seed the port's proof is byte-identical to the JAX
package's device prover (`prove_device` on its jax backend, XLA on the
CPU) and to its native `Prover._prove`.  The device functions are held
against the JAX functions limb for limb on seeded inputs, the verifiers
against each other's proofs, and the tampered proofs must be rejected.
Proofs are integers: every comparison is exact.
"""

import hashlib
import importlib
import json
import random
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bulletproofs_tpu as jbp
from bulletproofs_tpu import backend as jbackend
from bulletproofs_tpu.config import BLS381 as JCV
from bulletproofs_tpu.models import bound_check as jbound_check
from bulletproofs_tpu.ops import ec_jax as ej
from bulletproofs_tpu.ops import prover_device as jpd
from bulletproofs_tpu.ops import verifier_device as jvd
from bulletproofs_tpu.r1cs.linear_combination import \
    LinearCombination as JLC
from bulletproofs_tpu.utils import get_generators as jget_generators

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch.config import BLS381 as CV
from bulletproofs_tpu_torch.models import bound_check
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import ec_kernels as ek
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops import prover_device as PD
from bulletproofs_tpu_torch.ops import verifier_device as VD
from bulletproofs_tpu_torch.r1cs.linear_combination import \
    LinearCombination
from bulletproofs_tpu_torch.utils.errors import (FormatError,
                                                 VerificationError)

# One torch thread: the suite runs several test processes at once, and
# each process's own thread pool would oversubscribe the cores.
torch.set_num_threads(1)

REFERENCE = Path(__file__).resolve().parent / "vectors" \
    / "torch_r1cs_agg16.json"

PORT = SimpleNamespace(Scalar=bt.Scalar, G1=bt.G1, LC=LinearCombination,
                       bound_check=bound_check, Prover=bt.Prover,
                       Verifier=bt.Verifier, Transcript=bt.ProofTranscript,
                       gens=bt.get_generators)
JAX = SimpleNamespace(Scalar=jbp.Scalar, G1=jbp.G1, LC=JLC,
                      bound_check=jbound_check, Prover=jbp.Prover,
                      Verifier=jbp.Verifier, Transcript=jbp.ProofTranscript,
                      gens=jget_generators)


# ---------------------------------------------------------------------------
# The statements, written once over either package
# ---------------------------------------------------------------------------

def _chain(cs, v):
    """v[0] * v[1] * ... * v[-2] == v[-1] by general multiplications."""
    acc = v[0]
    for x in v[1:-1]:
        _, _, acc = cs.multiply(acc, x)
    cs.constrain(acc - v[-1])


def _shuffle(ns, cs, v):
    """The first half of v equals the second as multisets, through the
    phase-2 challenge z: prod (x_i - z) == prod (y_i - z)."""
    k = len(v) // 2

    def randomized(rcs):
        z = rcs.challenge_scalar(b"shuffle_z")
        sides = []
        for part in (v[:k], v[k:]):
            acc = part[0] - z
            for x in part[1:]:
                _, _, acc = rcs.multiply(acc, x - z)
            sides.append(acc)
        rcs.constrain(ns.LC.coerce(sides[0]) - sides[1])
    cs.specify_randomized_constraints(randomized)


def _commit_all(ns, p, vals, rng):
    out = [p.commit(v, ns.Scalar.random(rng)) for v in vals]
    return [c for c, _ in out], [v for _, v in out]


def _product_witness(ns, rng, k):
    vals = [ns.Scalar.random(rng) for _ in range(k + 1)]
    prod = vals[0]
    for x in vals[1:]:
        prod = prod * x
    return vals + [prod]


def _prove_general(ns, p, rng, k=16):
    comms, v = _commit_all(ns, p, _product_witness(ns, rng, k), rng)
    _chain(p, v)
    return comms


def _prove_two_phase(ns, p, rng):
    comms = _prove_general(ns, p, rng, k=8)
    xs = [ns.Scalar(x) for x in (17, 42, 5, 99, 3)]
    more, v = _commit_all(ns, p, xs + [xs[i] for i in (2, 0, 4, 1, 3)], rng)
    _shuffle(ns, p, v)
    return comms + more


def _verify_general(ns, ver, comms):
    _chain(ver, [ver.commit(c) for c in comms])


def _verify_two_phase(ns, ver, comms):
    v = [ver.commit(c) for c in comms]
    _chain(ver, v[:10])
    _shuffle(ns, ver, v[10:])


# Each statement has n = 16 multipliers, so the JAX prover's IPA and
# vector kernels compile once for all three: the bound check (n1 = 16,
# bit-structured), a chain of 16 general products (n1 = 16), and a chain
# of 8 with a 5-element shuffle in phase 2 (n1 = 8, n2 = 8).
STATEMENTS = {
    # name: (label, seed, prove(ns, prover, rng), verify(ns, verifier, comms))
    "bound": (b"devpath", 0xD07,
              lambda ns, p, rng: ns.bound_check.prove_bounded_num(
                  57, None, 10, 100, 8, rng, p),
              lambda ns, v, comms: ns.bound_check.verify_bounded_num(
                  10, 100, 8, comms, v)),
    "general": (b"general", 0x6E1, _prove_general, _verify_general),
    "two_phase": (b"twophase", 0x2F5, _prove_two_phase, _verify_two_phase),
}


def _bases(ns):
    return (ns.gens("G", 64), ns.gens("H", 64), ns.G1.from_msg_hash(b"g"),
            ns.G1.from_msg_hash(b"h"))


def _prove(ns, name, how, **kw):
    label, seed, prove, _ = STATEMENTS[name]
    G, H, g, h = _bases(ns)
    rng = random.Random(seed)
    p = ns.Prover(g, h, ns.Transcript(label), rng=rng, **kw)
    comms = prove(ns, p, rng)
    proof = how(p, G, H)
    return proof, comms


def _verifier(ns, name, comms, **kw):
    label, _, _, verify = STATEMENTS[name]
    v = ns.Verifier(ns.Transcript(label), **kw)
    verify(ns, v, comms)
    return v


def _jax_device_prove(p, G, H):
    """The JAX package's `Prover.prove` on its jax backend (`prove_device`
    in XLA on the CPU); the statement itself was built on its default
    backend, so only the prover's device path compiles."""
    old = jbackend._mode
    jbackend.set_backend("jax")
    try:
        return p.prove(G, H)
    finally:
        jbackend.set_backend(old)


@pytest.fixture(scope="module")
def proofs():
    """Per statement: the port's proof and commitments (CPU), and the JAX
    package's proof bytes from `prove_device` (its jax backend) and from
    `Prover._prove` (its cpp backend)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpd, "DEVICE_PROVER_MIN_N", 1)
        # the JAX prover's per-round IPA: the same bytes as its fused IPA
        # (tests/test_ipa_fused.py), and a shorter compile on the CPU
        mp.setenv("BP_IPA_FUSED", "0")
        for name in STATEMENTS:
            port, comms = _prove(PORT, name, lambda p, G, H: p.prove(G, H),
                                 device="cpu")
            jdev, jcomms = _prove(JAX, name, _jax_device_prove)
            jcpp, _ = _prove(JAX, name, lambda p, G, H: p._prove(G, H))
            out[name] = {"port": port, "comms": comms, "jcomms": jcomms,
                         "jax_device": jdev.to_bytes(),
                         "jax_cpp": jcpp.to_bytes()}
    return out


# ---------------------------------------------------------------------------
# 1. Whole proofs and verification
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref", ["jax_device", "jax_cpp"])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_proof_bytes_match_jax_package(proofs, name, ref):
    assert isinstance(proofs[name]["port"], bt.R1CSProof)
    assert proofs[name]["port"].to_bytes() == proofs[name][ref]


@pytest.mark.parametrize("whose", ["port", "jax"])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_port_verifier_accepts(proofs, name, whose):
    rec = proofs[name]
    proof = rec["port"] if whose == "port" else \
        bt.R1CSProof.from_bytes(rec["jax_device"])
    G, H, g, h = _bases(PORT)
    _verifier(PORT, name, rec["comms"], device="cpu").verify(proof, g, h,
                                                              G, H)


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_jax_verifier_accepts_port_proof(proofs, name):
    """The JAX package's `Verifier.verify` (its native host path) on the
    port's proof bytes."""
    rec = proofs[name]
    G, H, g, h = _bases(JAX)
    proof = jbp.R1CSProof.from_bytes(rec["port"].to_bytes())
    _verifier(JAX, name, rec["jcomms"]).verify(proof, g, h, G, H)


def test_host_check_accepts(proofs):
    """`Verifier._verify`, the port's host mega-MSM in Python ints."""
    rec = proofs["two_phase"]
    G, H, g, h = _bases(PORT)
    _verifier(PORT, "two_phase", rec["comms"])._verify(rec["port"], g, h,
                                                      G, H)


def _flip(blob, pos, bit=0):
    bad = bytearray(blob)
    bad[pos] ^= 1 << bit
    return bytes(bad)


# the bound check's proof: 1 + 11 points + 3 scalars + 2 x 4 points + 2
# scalars; a byte in the middle (test_serialization.py), in a point's x,
# in t_x, in the IPA's b, and bit flips fuzzed at fixed positions
CORRUPTIONS = {
    "t_x_plus_1": None,
    "middle_byte": lambda b: _flip(b, len(b) // 2),
    "A_I1_x": lambda b: _flip(b, 1 + 20),
    "t_x_byte": lambda b: _flip(b, 1 + 11 * 97 + 7, 3),
    "ipa_b_byte": lambda b: _flip(b, len(b) - 5, 6),
    "truncated": lambda b: b[:-1],
    "trailing": lambda b: b + b"\0",
}
CORRUPTIONS.update({f"fuzz_{k}": (lambda b, k=k: _flip(
    b, random.Random(0xF022 + k).randrange(len(b)),
    random.Random(0xF022 + k).randrange(8))) for k in range(4)})


@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
def test_port_verifier_rejects(proofs, corruption):
    rec = proofs["bound"]
    G, H, g, h = _bases(PORT)
    blob = rec["port"].to_bytes()
    with pytest.raises((VerificationError, FormatError)):
        if corruption == "t_x_plus_1":
            bad = bt.R1CSProof.from_bytes(blob)
            bad.t_x = bad.t_x + bt.Scalar(1)
        else:
            bad = bt.R1CSProof.from_bytes(CORRUPTIONS[corruption](blob))
        _verifier(PORT, "bound", rec["comms"], device="cpu").verify(
            bad, g, h, G, H)


def test_serialization_round_trips_as_jax_package(proofs):
    rec = proofs["two_phase"]
    blob = rec["port"].to_bytes()
    assert bt.R1CSProof.from_bytes(blob).to_bytes() == blob
    jproof = jbp.R1CSProof.from_bytes(blob)
    assert rec["port"].to_json() == jproof.to_json()
    assert bt.R1CSProof.from_json(jproof.to_json()).to_bytes() == blob


def test_entry_points_default_to_the_card():
    """`Prover`, `Verifier` and the one-shot range proof run on "cuda"
    unless asked: without a card (as here) proving raises instead of
    falling back to the CPU."""
    import inspect
    for fn in (bt.Prover, bt.Verifier, bound_check.gen_proof_of_bounded_num,
               bound_check.verify_proof_of_bounded_num):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        G, H, g, h = _bases(PORT)
        with pytest.raises((RuntimeError, AssertionError)):
            bound_check.gen_proof_of_bounded_num(
                57, None, 10, 100, 8, random.Random(1), b"x", g, h, G, H)


def test_one_shot_range_proof_round_trip():
    """`gen_proof_of_bounded_num` / `verify_proof_of_bounded_num` on the
    CPU, as the README's snippet drives them (9 in [2, 14], 4 bits, n = 8);
    the same proof fails for another range."""
    G, H, g, h = _bases(PORT)
    proof, comms = bound_check.gen_proof_of_bounded_num(
        9, None, 2, 14, 4, random.Random(7), b"oneshot", g, h, G, H,
        device="cpu")
    bound_check.verify_proof_of_bounded_num(2, 14, 4, proof, comms,
                                            b"oneshot", g, h, G, H,
                                            device="cpu")
    with pytest.raises(VerificationError):
        bound_check.verify_proof_of_bounded_num(
            3, 14, 4, proof, comms, b"oneshot", g, h, G, H, device="cpu")


# ---------------------------------------------------------------------------
# 2. The device functions, limb for limb against the JAX functions
# ---------------------------------------------------------------------------

def _mont_pair(vals):
    t = F.FieldCtx(CV.fr).to_mont(vals, "cpu")
    return t, jnp.asarray(t.numpy().astype(np.uint32))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


FR, JFR = E.CurveCtx(CV).fr, ej.CurveCtx(JCV).fr


def _rand(rnd, k):
    return [rnd.randrange(CV.r) for _ in range(k)]


# The JAX functions below run at the shapes its prover compiled for the
# bound check (the `proofs` fixture, in this process): q = 37 constraints,
# n = 16, the 33-point phase table.

@pytest.mark.parametrize("q", [1, 16, 37])
def test_pow_tables_match_jax(proofs, q):
    x, jx = _mont_pair(_rand(random.Random(q), 1))
    _eq(PD._pow_table(x, q, FR), jpd._pow_table(jx, q, JFR))
    _eq(PD._pow_shifted(x, q, FR), jpd._pow_shifted(jx, q, JFR))


def _synthesized(ns, name, **kw):
    """A prover of `name` after phase 2's constraints are added."""
    p = _prove(ns, name, lambda p, G, H: p, **kw)[0]
    p._create_randomized_constraints()
    return p


def test_zfold_matches_jax(proofs):
    """The prover's z-fold of the bound check against the JAX package's
    `build_zfold_tables` and `zfold_device`."""
    z = 0x1234567 * 0x89ABCDEF % CV.r
    port_p = _synthesized(PORT, "bound", device="cpu")
    jax_p = _synthesized(JAX, "bound")
    n, m, q = len(port_p.a_L), len(port_p.v), len(port_p.constraints)
    tables = PD.build_zfold_tables(port_p.constraints, n, m)
    jtables = jpd.build_zfold_tables(jax_p.constraints, n, m)
    for kind, (rows, valid, coeffs, T, width) in tables.items():
        jrows, jvalid, jcoeffs, jT, jwidth = jtables[kind]
        assert (T, width, coeffs) == (jT, jwidth, jcoeffs)
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(valid, jvalid == 1)
    got = PD.zfold_device(tables, bt.Scalar(z), q, FR, n, "cpu")
    want = jpd.zfold_device(jtables, jbp.Scalar(z), q, JFR, n)
    for g, w in zip(got[:4], want):
        _eq(g, w)
    assert got[4] is None


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_verifier_zfold_matches_host(name):
    """The verifier's z-fold, with the constant term wc, against its host
    `_flattened_constraints` in Python ints."""
    z = bt.Scalar(0x1234567 * 0x89ABCDEF % CV.r)
    m = len(_prove(PORT, name, lambda p, G, H: p, device="cpu")[1])
    ver = _verifier(PORT, name, [bt.G1.generator(CV)] * m)
    ver._create_randomized_constraints()
    n, q = ver.num_vars, len(ver.constraints)
    padded = 1 << (n - 1).bit_length()
    tables = PD.build_zfold_tables(ver.constraints, n, m, include_one=True)
    wL, wR, wO, wV, wc = PD.zfold_device(tables, z, q, FR, padded, "cpu")
    hL, hR, hO, hV, hc = ver._flattened_constraints(z)
    pad = [0] * (padded - n)
    assert FR.from_mont(wL) == hL + pad and FR.from_mont(wR) == hR + pad
    assert FR.from_mont(wO) == hO + pad and FR.from_mont(wV) == hV
    assert FR.from_mont(wc) == [hc]


def test_t_poly_and_lr_eval_match_jax(proofs):
    """`_t_poly_kernel` with y^-1 from the host against the JAX function,
    which takes the inverse on the device, and against the host
    `VecPoly3.special_inner_product`; then `_lr_eval_kernel` against the
    JAX function and `VecPoly3.eval`."""
    from bulletproofs_tpu_torch.utils.vector_poly import VecPoly3
    rnd = random.Random(8)
    N = 16
    ints = [_rand(rnd, N) for _ in range(8)]
    vecs = [_mont_pair(v) for v in ints]
    y = rnd.randrange(1, CV.r)
    x = rnd.randrange(CV.r)
    y_m, jy_m = _mont_pair([y])
    yi_m, _ = _mont_pair([pow(y, -1, CV.r)])
    got = PD._t_poly_kernel(*[t for t, _ in vecs], y_m, yi_m, FR)
    want = jpd._t_poly_kernel(*[j for _, j in vecs], jy_m, JFR)
    for g, w in zip(got, want):
        _eq(g, w)
    x_m, jx_m = _mont_pair([x])
    lr = PD._lr_eval_kernel(*got[1:7], x_m, FR)
    for g, w in zip(lr, jpd._lr_eval_kernel(*want[1:7], jx_m, JFR)):
        _eq(g, w)

    # the host polynomials of prover.rs:458-486 from the same vectors
    aL, aR, aO, sL, sR, wL, wR, wO = [[bt.Scalar(v) for v in vec]
                                      for vec in ints]
    l_poly, r_poly = VecPoly3(N), VecPoly3(N)
    yv, yi = bt.Scalar(y), bt.Scalar(y).inverse()
    for i in range(N):
        y_i, yi_i = yv ** i, yi ** i
        l_poly.c[1][i] = aL[i] + yi_i * wR[i]
        l_poly.c[2][i] = aO[i]
        l_poly.c[3][i] = sL[i]
        r_poly.c[0][i] = wO[i] - y_i
        r_poly.c[1][i] = y_i * aR[i] + wL[i]
        r_poly.c[3][i] = y_i * sR[i]
    t = VecPoly3.special_inner_product(l_poly, r_poly)
    assert FR.from_mont(got[0]) == [t.t1.v, t.t2.v, t.t3.v, t.t4.v, t.t5.v,
                                    t.t6.v]
    assert FR.from_mont(lr[0]) == [v.v for v in l_poly.eval(bt.Scalar(x))]
    assert FR.from_mont(lr[1]) == [v.v for v in r_poly.eval(bt.Scalar(x))]


def test_masked_sums_match_jax(proofs):
    """The tree of kernel-3 adds at n = 33 (padded to 64 with the
    identity), three masks, one of them empty."""
    n = 33
    rnd = random.Random(9)
    rs = np.random.default_rng(9)
    pts = [jbp.G1.random(rnd) for _ in range(n)]
    jctx = ej.CurveCtx(JCV)
    jpts = ej.to_device_points(pts, jctx)
    masks = (rs.random((3, n)) < 0.5).astype(np.uint8)
    masks[2] = 0
    want = jpd._masked_sums_jit(jpts, jnp.asarray(masks), jctx)
    ctx = E.CurveCtx(CV)
    ek.reset_launches()
    got = PD._masked_sums(E.from_jax_points(jpts, "cpu"),
                          torch.as_tensor(masks != 0), ctx)
    assert ek.launches["ec_add"] == 0                  # CPU: plain version
    np.testing.assert_array_equal(E.to_jax_points(got), np.asarray(want))
    sums = E.from_device_points(got, ctx)
    host = [bt.msm_host(E.from_jax_host(pts, CV), [int(k) for k in row])
            for row in masks]
    assert sums == host


def test_gh_scalars_match_jax():
    rnd = random.Random(10)
    N, n1 = 16, 11
    vecs = [_mont_pair(_rand(rnd, N)) for _ in range(5)]
    ones = [_mont_pair(_rand(rnd, 1)) for _ in range(4)]
    mask = np.r_[np.ones(n1, np.uint32), np.zeros(N - n1, np.uint32)]
    got = VD._gh_scalars_kernel(*[t for t, _ in vecs],
                                *[t for t, _ in ones],
                                torch.as_tensor(mask == 1), FR)
    want = jvd._gh_scalars_kernel(*[j for _, j in vecs],
                                  *[j for _, j in ones], mask, N, JFR)
    for g, w in zip(got, want):
        _eq(g, w)


# ---------------------------------------------------------------------------
# 3. chip_smoke.py's range-proof phase and its full-width reference
# ---------------------------------------------------------------------------

def _jax_agg_digest(m, bits, seed):
    """sha256 of the JAX package's native `Prover._prove` proof of the
    bench's config-2 statement (`bench.py:581-590`) at m values of `bits`
    bits, n = 2 m bits."""
    n = m * 2 * bits
    G, H = jget_generators("G", n), jget_generators("H", n)
    g, h = jbp.G1.from_msg_hash(b"g"), jbp.G1.from_msg_hash(b"h")
    rng = random.Random(seed)
    vs = [rng.randrange(1 << (bits - 1)) for _ in range(m)]
    # the native backend, whatever an imported test module set (some set
    # the pure-Python "host" one when imported); the bytes are the same
    old = jbackend._mode
    jbackend.set_backend("cpp")
    try:
        p = jbp.Prover(g, h, jbp.ProofTranscript(b"AggRange"), rng=rng)
        for v in vs:
            jbound_check.prove_bounded_num(v, None, 0, (1 << bits) - 1,
                                           bits, rng, p)
        return hashlib.sha256(p._prove(G, H).to_bytes()).hexdigest()
    finally:
        jbackend.set_backend(old)


def test_agg16_reference_digest():
    """tests/vectors/torch_r1cs_agg16.json holds the JAX package's proof
    digest of chip_smoke.py's phase-6 statement (m = 16, 64 bits,
    n = 2048, seed 2)."""
    ref = json.loads(REFERENCE.read_text())
    assert (ref["m"], ref["bits"], ref["n"], ref["curve"]) == \
        (16, 64, 2048, "bls381")
    assert _jax_agg_digest(ref["m"], ref["bits"], ref["seed"]) == \
        ref["sha256"]


def test_chip_smoke_r1cs_phase_rehearses_on_cpu(capsys):
    """Phase 6 at m = 2 values of 4 bits (n = 16) on the CPU, where the
    wrappers run their plain versions: the proof of seed 1 against the JAX
    package's digest (computed here), the staged proof, the host check,
    verification and the tampered proof, with no kernel launched."""
    chip_smoke = importlib.import_module("chip_smoke")
    ref = {"seed": 1, "sha256": _jax_agg_digest(2, 4, 1)}
    ek.reset_launches()
    chip_smoke.phase_r1cs("cpu", 2, 4, 0, ref)
    assert ek.launches == {k: 0 for k in ek.launches}
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "r1cs" and line["n"] == 16
    assert line["matches_reference"] and line["tampered_rejected"]
    assert {"phase1_convert", "phase1_msm", "zfold", "tpoly", "t_commits",
            "ipa_msm", "other"} <= set(line["r1cs_prove_stage_seconds"])
    with pytest.raises(AssertionError):
        chip_smoke.phase_r1cs("cpu", 2, 4, 0, {"seed": 1, "sha256": "0"})
