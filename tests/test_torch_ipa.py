"""The port's standalone inner-product argument (bulletproofs_tpu_torch:
transcript/, ipp.py, ops/prover_device.py, ops/verifier_device.py) and its
fourth kernel's plain version, against the JAX package at n = 16.

Both packages get the same inputs: host objects cross through
`ec.from_jax_host`, arrays as numpy.  The per-round bucket pass
(`ec_kernel="round"`) is held against the JAX package's bucket arrays in
tests/test_torch_msm.py::test_bucket_arrays_match_jax, beside the chunked
pass, so the JAX side compiles once.  The JAX prover runs its per-round
device path (`create_ipp_device` with BP_IPA_FUSED=0; XLA on the CPU) and
its native host path; every comparison is exact, bytes or limbs.  Each JAX
function is compiled once per shape: the proofs are made once per module.
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

from bulletproofs_tpu import backend as jbackend
from bulletproofs_tpu import config as jconfig
from bulletproofs_tpu import ipp as jipp
from bulletproofs_tpu.ops import ec_jax as ej
from bulletproofs_tpu.ops import prover_device as jpd
from bulletproofs_tpu.ops import verifier_device as jvd
from bulletproofs_tpu.ops.ec_host import G1 as JG1
from bulletproofs_tpu.ops.field_host import Scalar as JScalar
from bulletproofs_tpu.ops.field_host import inner_product as jinner
from bulletproofs_tpu.transcript import ProofTranscript as JTranscript
from bulletproofs_tpu.transcript import keccak_f1600 as jkeccak
from bulletproofs_tpu.utils import get_generators as jget_generators

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import ec_kernels as ek
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops import prover_device as PD
from bulletproofs_tpu_torch.ops import verifier_device as VD
from bulletproofs_tpu_torch.transcript import keccak_f1600
from bulletproofs_tpu_torch.utils.errors import VerificationError

# One torch thread: the suite runs several test processes at once, and
# each process's own thread pool would oversubscribe the cores.
torch.set_num_threads(1)

CV, JCV = config.BLS381, jconfig.BLS381
N = 16
LABEL = b"torch-ipa"


def _bytes(proof):
    return ([p.to_bytes() for p in proof.L], [p.to_bytes() for p in proof.R],
            proof.a.v, proof.b.v)


# ---------------------------------------------------------------------------
# 1. Transcript
# ---------------------------------------------------------------------------

def test_keccak_matches_jax_package():
    rs = np.random.default_rng(1)
    for _ in range(4):
        state = bytearray(rs.integers(0, 256, 200, dtype=np.uint8).tobytes())
        mine, theirs = bytearray(state), bytearray(state)
        keccak_f1600(mine)
        jkeccak(theirs)
        assert mine == theirs


def test_transcript_challenges_match_jax_package():
    """The same domain separators, point and scalar commits and challenges
    in both packages give the same challenge bytes at every step."""
    rnd = random.Random(2)
    pt = bt.G1.random(rnd, CV)
    ident = bt.G1.identity(CV)
    k = bt.Scalar.random(rnd, CV)
    mine, theirs = bt.ProofTranscript(b"tx"), JTranscript(b"tx")
    steps = [("innerproduct_domain_sep", (N,)), ("r1cs_domain_sep", ()),
             ("commit_point", (b"L", pt)), ("commit_point", (b"R", ident)),
             ("commit_scalar", (b"t_x", k)), ("append_u64", (b"m", 7)),
             ("challenge_scalar", (b"u",)), ("append_message",
                                            (b"msg", b"x" * 300)),
             ("challenge_bytes", (b"c", 200)), ("challenge_scalar", (b"w",))]
    for name, args in steps:
        jargs = [JG1(a.X, a.Y, a.Z, JCV) if isinstance(a, bt.G1) else
                 JScalar(a.v, JCV) if isinstance(a, bt.Scalar) else a
                 for a in args]
        got = getattr(mine, name)(*args)
        want = getattr(theirs, name)(*jargs)
        if name == "challenge_scalar":
            assert got.v == want.v
        else:
            assert got == want
    assert mine.clone().challenge_bytes(b"end", 64) == \
        theirs.clone().challenge_bytes(b"end", 64)


def test_field_host_vector_helpers_match_jax_package():
    from bulletproofs_tpu.ops import field_host as jfh
    from bulletproofs_tpu_torch.ops import field_host as fh
    rnd = random.Random(9)
    a = [bt.Scalar.random(rnd, CV) for _ in range(5)]
    b = [bt.Scalar.random(rnd, CV) for _ in range(5)]
    ja = [JScalar(x.v, JCV) for x in a]
    jb = [JScalar(x.v, JCV) for x in b]
    assert fh.inner_product(a, b).v == jfh.inner_product(ja, jb).v
    assert [x.v for x in fh.hadamard_product(a, b)] == \
        [x.v for x in jfh.hadamard_product(ja, jb)]
    inv, prod = fh.batch_invert(a)
    jinv, jprod = jfh.batch_invert(ja)
    assert [x.v for x in inv] + [prod.v] == [x.v for x in jinv] + [jprod.v]
    assert fh.batch_invert([]) == ([], bt.Scalar.one())
    with pytest.raises(ValueError):
        fh.inner_product(a, b[:2])


# ---------------------------------------------------------------------------
# 2. IPA scalar functions, limb for limb
# ---------------------------------------------------------------------------

def _mont_pair(vals):
    """Montgomery (Lr, n) limbs of `vals` as the port's tensor and as the
    JAX package's array."""
    t = F.FieldCtx(CV.fr).to_mont(vals, "cpu")
    return t, jnp.asarray(t.numpy().astype(np.uint32))


def _plain_pair(v):
    limbs = F.ints_to_limbs([v], CV.fr.n_limbs)
    return torch.as_tensor(limbs), jnp.asarray(limbs.astype(np.uint32))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


def test_ipa_round_functions_match_jax_package():
    """`_ipa_round_scalars`, then `_ipa_round_step` for every round and
    `_ipa_final_step`, on random state and challenges (the shapes and
    static arguments of `create_ipp_device` at n = 16)."""
    rnd = random.Random(3)
    r = CV.r
    fr, jfr = E.CurveCtx(CV).fr, ej.CurveCtx(JCV).fr
    A, jA = _mont_pair([rnd.randrange(r) for _ in range(N)])
    B, jB = _mont_pair([rnd.randrange(r) for _ in range(N)])
    rG, jrG = _mont_pair([rnd.randrange(r) for _ in range(N)])
    rH, jrH = _mont_pair([rnd.randrange(r) for _ in range(N)])
    _eq(PD._ipa_round_scalars(A, B, rG, rH, N, fr),
        jpd._ipa_round_scalars(jA, jB, jrG, jrH, N, jfr))
    n_j = N // 2
    while n_j >= 1:
        u = rnd.randrange(1, r)
        u_p, ju_p = _plain_pair(u)
        ui_p, jui_p = _plain_pair(pow(u, -1, r))
        if n_j == 1:
            got = PD._ipa_final_step(A, B, u_p, ui_p, fr)
            want = jpd._ipa_final_step(jA, jB, ju_p, jui_p, jfr)
        else:
            got = PD._ipa_round_step(A, B, rG, rH, u_p, ui_p, n_j, fr)
            want = jpd._ipa_round_step(jA, jB, jrG, jrH, ju_p, jui_p, n_j,
                                       jfr)
            _, A, B, rG, rH = got
            _, jA, jB, jrG, jrH = want
        for g, w in zip(got, want):
            _eq(g, w)
        n_j //= 2


def test_verifier_scalar_functions_match_jax_package():
    rnd = random.Random(4)
    r = CV.r
    lg_n = N.bit_length() - 1
    fr, jfr = E.CurveCtx(CV).fr, ej.CurveCtx(JCV).fr
    u_sq, ju_sq = _mont_pair([rnd.randrange(r) for _ in range(lg_n)])
    pinv, jpinv = _mont_pair([rnd.randrange(r)])
    s = VD._s_vector_kernel(u_sq, pinv, lg_n, fr)
    js = jvd._s_vector_kernel(ju_sq, jpinv, lg_n, jfr)
    _eq(s, js)
    Gf, jGf = _mont_pair([rnd.randrange(r) for _ in range(N)])
    Hf, jHf = _mont_pair([rnd.randrange(r) for _ in range(N)])
    a, ja = _mont_pair([rnd.randrange(r)])
    b, jb = _mont_pair([rnd.randrange(r)])
    for g, w in zip(VD._ipp_scalars_kernel(s, Gf, Hf, a, b, fr),
                    jvd._ipp_scalars_kernel(js, jGf, jHf, ja, jb, jfr)):
        _eq(g, w)


# ---------------------------------------------------------------------------
# 3. Kernel 4's plain version and the per-round bucket pass
# ---------------------------------------------------------------------------

def _round_xla(buckets, rows, found, jctx):
    """The function of `ec_pallas._round_kernel` in the JAX package's XLA
    ops, as its per-round bucket pass writes it (msm.py:440-450): rows to
    limbs-first, the identity in empty slots, one complete add.  (The
    kernel itself, in interpret mode, compiles for minutes on the CPU.)"""
    L, S = buckets.shape[1], buckets.shape[2]
    pts = rows.reshape(S, 3, L).transpose(1, 2, 0)
    delta = jnp.where(found[None, None] != 0, pts,
                      jctx.identity.reshape(3, L, 1))
    return ej.ec_add(buckets, delta, jctx)


def test_bucket_round_add_plain_matches_round_kernel_math():
    """Half the accumulators at the identity, rows from a 16-point table,
    ~70% occupancy, one slot doubling (accumulator == row)."""
    S = 512
    jctx = ej.CurveCtx(JCV)
    L = JCV.fp.n_limbs
    rnd = random.Random(5)
    rs = np.random.default_rng(5)
    pts = [JG1.random(rnd, JCV) for _ in range(16)]
    proj = np.asarray(ej.to_device_points([p + p for p in pts], jctx))
    ident = np.asarray(jctx.identity)
    acc = np.concatenate([np.broadcast_to(ident, (3, L, S // 2)),
                          proj[:, :, rs.integers(0, 16, S - S // 2)]],
                         axis=2)
    pid = rs.integers(0, 16, S)
    acc[:, :, -1] = proj[:, :, pid[-1]]
    found = (rs.random(S) < 0.7).astype(np.int32)
    found[-1] = 1
    rows_all = np.transpose(proj, (2, 0, 1)).reshape(16, 3 * L)
    run = jax.jit(lambda b, r, f: _round_xla(b, r, f, jctx))
    want = np.asarray(run(jnp.asarray(acc), jnp.asarray(rows_all[pid]),
                          jnp.asarray(found)))
    # kernel 4 reads the rows by point id from the packed table
    table32 = F.pack32(torch.as_tensor(rows_all.astype(np.int64)), 1)
    got = ek.bucket_round_add(
        F.pack32(E.from_jax_points(acc, "cpu"), 1), table32,
        torch.as_tensor(pid.astype(np.int32)), torch.as_tensor(found),
        E.CurveCtx(CV))
    np.testing.assert_array_equal(E.to_jax_points(F.unpack32(got, 1)),
                                  want)


def test_bucket_pass_rejects_unknown_kernel_form():
    ctx = E.CurveCtx(CV)
    P = E.to_device_points([bt.G1.generator(CV)] * 4, ctx, "cpu")
    digits = torch.ones((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        M.bucket_accumulate(P, digits, ctx, 2, 16, ec_kernel="pallas")


# ---------------------------------------------------------------------------
# 4-5. The slice: proofs byte-identical to the JAX package's; verification
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ipa():
    """One input at n = 16 with random G/H factors, the JAX package's
    proofs (per-round device path, native host path) and the port's
    (chunked and per-round bucket kernels), each with the transcript's next
    challenge."""
    rng = random.Random(0x1BA)
    G, H = jget_generators("G", N), jget_generators("H", N)
    Q = JG1.from_msg_hash(b"Q", JCV)
    a = [JScalar.random(rng, JCV) for _ in range(N)]
    b = [JScalar.random(rng, JCV) for _ in range(N)]
    Gf = [JScalar.random(rng, JCV) for _ in range(N)]
    Hf = [JScalar.random(rng, JCV) for _ in range(N)]
    jargs = (Q, Gf, Hf, G, H, a, b)
    P = JG1.identity(JCV)
    scal = ([x * f for x, f in zip(a, Gf)] + [x * f for x, f in zip(b, Hf)]
            + [jinner(a, b)])
    for pt, k in zip(G + H + [Q], scal):
        P = P + pt * k

    def jax_proof(mode):
        old = jbackend._mode
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jipp, "DEVICE_IPA_MIN_N",
                       1 if mode == "jax" else 1 << 30)
            mp.setenv("BP_IPA_FUSED", "0")
            jbackend.set_backend(mode)
            try:
                tr = JTranscript(LABEL)
                proof = jipp.create_ipp(tr, *jargs)
            finally:
                jbackend.set_backend(old)
        return proof, tr.challenge_scalar(b"post").v

    def port_proof(ec_kernel):
        tr = bt.ProofTranscript(LABEL)
        proof = bt.create_ipp(tr, *(E.from_jax_host(x, CV) for x in jargs),
                              device="cpu", ec_kernel=ec_kernel)
        return proof, tr.challenge_scalar(b"post").v

    return {"args": [E.from_jax_host(x, CV) for x in jargs], "jargs": jargs,
            "P": E.from_jax_host(P, CV), "jP": P,
            "jax_device": jax_proof("jax"), "jax_cpp": jax_proof("cpp"),
            "chunk": port_proof("chunk"), "round": port_proof("round")}


@pytest.mark.parametrize("ec_kernel", ["chunk", "round"])
@pytest.mark.parametrize("ref", ["jax_device", "jax_cpp"])
def test_proof_bytes_match_jax_package(ipa, ref, ec_kernel):
    proof, post = ipa[ec_kernel]
    want, want_post = ipa[ref]
    assert isinstance(proof, bt.InnerProductArgumentProof)
    assert len(proof.L) == N.bit_length() - 1
    assert _bytes(proof) == _bytes(want)
    assert post == want_post


def _verify(ipa, proof, **change):
    Q, Gf, Hf, G, H, _, _ = ipa["args"]
    kw = dict(P=ipa["P"], a=proof.a, b=proof.b, L=proof.L, R=proof.R)
    kw.update(change)
    bt.verify_ipp(N, bt.ProofTranscript(LABEL), Gf, Hf, kw["P"], Q, G, H,
                  kw["a"], kw["b"], kw["L"], kw["R"], device="cpu")


@pytest.mark.parametrize("whose", ["port", "jax"])
def test_port_verifier_accepts(ipa, whose):
    proof = ipa["chunk"][0] if whose == "port" else \
        E.from_jax_host(ipa["jax_device"][0], CV)
    _verify(ipa, proof)


def test_jax_verifier_accepts_port_proof(ipa, monkeypatch):
    """The JAX package's `verify_ipp` (its native host path) on the port's
    proof, handed over as JAX package objects."""
    proof = ipa["chunk"][0]
    monkeypatch.setattr(jipp, "DEVICE_IPA_MIN_N", 1 << 30)
    Q, Gf, Hf, G, H, _, _ = ipa["jargs"]
    conv = lambda p: JG1(p.X, p.Y, p.Z, JCV)
    jipp.verify_ipp(N, JTranscript(LABEL), Gf, Hf, ipa["jP"], Q, G, H,
                    JScalar(proof.a.v, JCV), JScalar(proof.b.v, JCV),
                    [conv(p) for p in proof.L], [conv(p) for p in proof.R])


CORRUPTIONS = {
    "a_plus_1": lambda p, ipa: dict(a=p.a + bt.Scalar.one(CV)),
    "b_plus_1": lambda p, ipa: dict(b=p.b + bt.Scalar.one(CV)),
    "L_R_swapped": lambda p, ipa: dict(L=p.R, R=p.L),
    "L_identity": lambda p, ipa: dict(
        L=[bt.G1.identity(CV)] + list(p.L[1:])),
    "wrong_P": lambda p, ipa: dict(P=ipa["P"] + ipa["args"][0]),
    "L_short": lambda p, ipa: dict(L=p.L[:-1]),
}


@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
def test_port_verifier_rejects(ipa, corruption):
    proof = ipa["chunk"][0]
    with pytest.raises(VerificationError):
        _verify(ipa, proof, **CORRUPTIONS[corruption](proof, ipa))


def test_entry_points_default_to_the_card():
    """`create_ipp` and `verify_ipp` run on "cuda" unless asked: without a
    card (as here) they raise instead of falling back to the CPU."""
    import inspect
    for fn in (bt.create_ipp, bt.verify_ipp):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        Q = bt.G1.from_msg_hash(b"Q", CV)
        one = [bt.Scalar.one(CV)] * 2
        with pytest.raises((RuntimeError, AssertionError)):
            bt.create_ipp(bt.ProofTranscript(LABEL), Q, one, one, [Q, Q],
                          [Q, Q], one, one)


def test_from_jax_host_and_generators_match_jax_package():
    jG = jget_generators("G", 4)
    G = bt.get_generators("G", 4)
    assert [p.to_bytes() for p in G] == [p.to_bytes() for p in jG]
    assert E.from_jax_host(jG, CV) == G
    assert E.from_jax_host(JScalar(5, JCV), CV) == bt.Scalar(5, CV)
    with pytest.raises(TypeError):
        E.from_jax_host(object(), CV)
    ctx = E.CurveCtx(CV)
    assert E.content_digest(G, ctx) == E.content_digest(list(G), ctx)
    assert E.content_digest(G, ctx) != E.content_digest(G[::-1], ctx)


# ---------------------------------------------------------------------------
# 6. chip_smoke.py's IPA phase, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_ipa_phase_rehearses_on_cpu(capsys):
    """The IPA phase at n = 16 on the CPU, where the wrappers run their
    plain versions: prove, the host check, verify, the tampered proof and
    the per-round proof, with no kernel launched."""
    chip_smoke = importlib.import_module("chip_smoke")
    ek.reset_launches()
    with config.using_curve(CV):
        chip_smoke.phase_ipa("cpu", N, 9, reps=0)
    assert ek.launches == {k: 0 for k in ek.launches}
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "ipa" and line["n"] == N
    assert line["tampered_rejected"] and line["round_kernel_proof_identical"]
    assert set(line["ipa_prove_stage_seconds"]) == {
        "ipa_scal", "ipa_msm", "ipa_transcript", "ipa_final"}


def test_chip_smoke_ipa_fused_phase_rehearses_on_cpu(capsys):
    """Phase 6b at n = 2 on the CPU: the fused and per-round IPA proofs and
    the r1cs statement's (m = 1 value of 2 bits; its reference digest the
    port's own per-round proof) agree, each path's stages are reported,
    and `check` holds the plain challenge round against itself at the
    proof's first L and R, with no kernel launched."""
    chip_smoke = importlib.import_module("chip_smoke")
    with config.using_curve(CV):
        G, H = bt.get_generators("G", 4), bt.get_generators("H", 4)
        g, h = bt.G1.from_msg_hash(b"g", CV), bt.G1.from_msg_hash(b"h", CV)
        prover, _ = chip_smoke._agg_range_prover(2, 1, 2, g, h, "cpu")
        ref = {"seed": 2, "sha256": hashlib.sha256(
            prover.prove(G, H, fused=False).to_bytes()).hexdigest()}
        records = {"ipa_challenge": {}}
        ek.reset_launches()
        res = chip_smoke.phase_ipa_fused("cpu", 2, 9, 0, records, (1, 2, ref))
        res["check"]()
    assert ek.launches == {k: 0 for k in ek.launches}
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    line = next(x for x in lines if x.get("phase") == "ipa_fused")
    assert line["proofs_identical"] and line["r1cs_matches_reference"]
    assert set(line["stage_seconds"]["fused"]) == {
        "ipa_fused_kernel", "ipa_fused_fetch", "other"}
    assert "ipa_transcript" in line["stage_seconds"]["per_round"]
    assert set(res["launches"]) == {"fused", "per_round"}
    rows = records["ipa_challenge"]["at_path"]
    assert len(rows) == 2 and all(r["max_abs_err"] == 0 for r in rows)
    assert rows[1]["regs"] == [CV.modbytes, 0, 7]
