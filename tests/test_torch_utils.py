"""The port's last two utils modules against the JAX package's, on the CPU:
`utils/metrics.py` (the counters and spans `Prover.prove` and
`Verifier.verify` record: equal to the JAX package's after the same proof
and verification) and `utils/roofline.py` (the H100 model that
chip_smoke.py's bounds read, and the chain kernel's plain versions: limb
for limb the JAX package's jitted `_ec_add_chain` and `_mont_mul_chain`
on the same canonical inputs).  The roofline's rates are the card's and
come from chip_smoke.py's roofline phase; here `roofline_report` refuses
the CPU.  Every comparison is exact.
"""

import contextlib
import importlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bulletproofs_tpu as jbp
from bulletproofs_tpu import backend as jbackend
from bulletproofs_tpu import config as jconfig
from bulletproofs_tpu.models import bound_check as jbound_check
from bulletproofs_tpu.ops import ec_jax as ej
from bulletproofs_tpu.utils import metrics as jmetrics_mod
from bulletproofs_tpu.utils import roofline as jroofline

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.models import bound_check
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import ec_kernels as ek
from bulletproofs_tpu_torch.ops.field import limbs_to_ints, pack32, unpack32
from bulletproofs_tpu_torch.utils import metrics as metrics_mod
from bulletproofs_tpu_torch.utils import roofline as R

torch.set_num_threads(1)


@contextlib.contextmanager
def _jax_native():
    old = jbackend._mode
    jbackend.set_backend("cpp")
    try:
        yield
    finally:
        jbackend.set_backend(old)


def _range_proof(ns, **kw):
    """57 in [10, 100] with 8 bits (n = 16) proved and verified with the
    package `ns` (the port with kw, or the JAX package)."""
    G, H = ns.get_generators("G", 16), ns.get_generators("H", 16)
    g, h = ns.G1.from_msg_hash(b"g"), ns.G1.from_msg_hash(b"h")
    rng = random.Random(5)
    mod = bound_check if ns is bt else jbound_check
    p = ns.Prover(g, h, ns.ProofTranscript(b"Metrics"), rng=rng, **kw)
    comms = mod.prove_bounded_num(57, None, 10, 100, 8, rng, p)
    proof = p.prove(G, H)
    v = ns.Verifier(ns.ProofTranscript(b"Metrics"), **kw)
    mod.verify_bounded_num(10, 100, 8, comms, v)
    v.verify(proof, g, h, G, H)
    return proof.to_bytes()


def test_metrics_match_jax_package():
    """After one range proof and its verification in each package, from
    reset: the same counters (`prove_calls`, `multipliers`, `constraints`,
    `verify_calls`), one call of each span, and the same proof bytes."""
    port, jax_ = metrics_mod.metrics, jmetrics_mod.metrics
    port.reset()
    jax_.reset()
    with config.using_curve(config.BLS381):
        port_bytes = _range_proof(bt, device="cpu")
    with _jax_native(), jconfig.using_curve(jconfig.BLS381):
        jax_bytes = _range_proof(jbp)
    assert port_bytes == jax_bytes
    assert dict(port.counters) == dict(jax_.counters)
    assert port.counters["prove_calls"] == port.counters["verify_calls"] \
        == 1
    assert port.counters["multipliers"] > 0
    assert dict(port.calls) == dict(jax_.calls) == {"prove": 1,
                                                    "verify": 1}
    assert all(t > 0 for t in port.timings.values())
    assert [x.split(":")[0] for x in port.report().splitlines()] == \
        [x.split(":")[0] for x in jax_.report().splitlines()]
    port.reset()
    assert port.report() == ""


def test_metrics_span_prints_under_bp_trace(monkeypatch, capsys):
    """`BP_TRACE=1` (read at import, `_PRINT`) prints each span as it
    closes, also when its body raises; the span is counted either way."""
    m = metrics_mod.Metrics()
    monkeypatch.setattr(metrics_mod, "_PRINT", True)
    with m.span("a"):
        pass
    with pytest.raises(KeyError):
        with m.span("b"):
            raise KeyError("b")
    m.incr("n", 3)
    out = capsys.readouterr().out.splitlines()
    assert [x.split(":")[0] for x in out] == ["[bp-trace] a",
                                              "[bp-trace] b"]
    assert dict(m.calls) == {"a": 1, "b": 1} and m.counters["n"] == 3


CHAINS = [("bls381", "ec_add"), ("bls381", "mont_mul"), ("bn254", "ec_add"),
          ("bn254", "mont_mul"), ("ed25519", "ec_add")]


@pytest.mark.parametrize("curve,op", CHAINS)
def test_chain_plain_matches_jax_chain(curve, op):
    """The chain kernel's plain version (8 lanes, 3 dependent steps) from
    distinct canonical inputs equals the JAX package's jitted
    `_ec_add_chain` / `_mont_mul_chain` on the same limbs, the wrapper
    (on the CPU: the plain version) too, with no launch."""
    ctx, jctx = E.CurveCtx(config.CURVES[curve]), \
        ej.CurveCtx(jconfig.CURVES[curve])
    if op == "ec_add":
        x32 = R.chain_points(ctx, 8, device="cpu")
        limbs = unpack32(x32, 1)
        want = jroofline._ec_add_chain(jnp.asarray(limbs.numpy(),
                                                   jnp.uint32), 3, jctx)
        dim = 1
    else:
        x32 = R.chain_elements(ctx, 8, device="cpu")
        limbs = unpack32(x32, 0)
        want = jroofline._mont_mul_chain(jnp.asarray(limbs.numpy(),
                                                     jnp.uint32), 3,
                                         jctx.fp)
        dim = 0
    assert len({tuple(c) for c in limbs.reshape(-1, 8).T.tolist()}) == 8
    ek.reset_launches()
    for fn in (getattr(R, f"{op}_chain_plain"), getattr(R, f"{op}_chain")):
        got = fn(x32, 3, ctx)
        assert got.dtype == torch.int32 and got.shape == x32.shape
        np.testing.assert_array_equal(
            unpack32(got, dim).numpy().astype(np.uint32), np.asarray(want))
    assert ek.launches["chain"] == 0


def test_chain_inputs_and_operand_checks():
    """The inputs are distinct and canonical (< p) and the same for a seed;
    a chain refuses a wrong shape, dtype or a negative count."""
    ctx = E.CurveCtx(config.ED25519)
    a = R.chain_elements(ctx, 64, device="cpu")
    vals = limbs_to_ints(unpack32(a, 0))
    assert len(set(vals)) == 64 and max(vals) < ctx.cv.p
    assert torch.equal(a, R.chain_elements(ctx, 64, device="cpu"))
    P = R.chain_points(ctx, 4, device="cpu")
    assert P.shape == (3, ctx.fp.L // 2, 4)
    for bad in (P[:2], P.to(torch.int64), P[..., :0]):
        with pytest.raises(ValueError):
            R.ec_add_chain(bad, 1, ctx)
    with pytest.raises(ValueError):
        R.mont_mul_chain(a, -1, ctx)
    with pytest.raises(ValueError):
        R.mont_mul_chain(P, 1, ctx)


def test_roofline_model_and_op_counts():
    """The H100 model: a CIOS product over NL words is 2 (2 NL^2 + NL)
    IMADs (BLS12-381 600, the 8-word fields 272); an add is 12 products
    for a = 0, as the JAX package's model counts (`ec_add_op_count`), and
    18 for ed25519 (RCB16 algorithm 1); a chain is bound by operations;
    chip_smoke.py reads this model and no copy of its own."""
    want = {"bls381": 600, "bn254": 272, "secp256k1": 272, "ed25519": 272}
    for name, cv in config.CURVES.items():
        ctx = E.CurveCtx(cv)
        nl = ctx.fp.L // 2
        assert R.imad_per_mont_mul(ctx) == 2 * (2 * nl * nl + nl) \
            == want[name]
        assert R.mont_muls_per_add(ctx) == (18 if name == "ed25519" else 12)
        assert R.imad_per_ec_add(ctx) == \
            R.mont_muls_per_add(ctx) * R.imad_per_mont_mul(ctx)
    L = config.BLS381.fp.n_limbs
    assert jroofline.ec_add_op_count(L) - 16 * 6 * L == \
        12 * jroofline.mont_mul_op_count(L)
    assert R.IMAD_PER_S == 67e12 / 4 and R.HBM_BYTES_PER_S == 3.35e12
    ms, by = R.bound(2 * 3 * 12 * 4 * 8192, 8192 * 100 * 7200)
    assert by == "operations" and ms == pytest.approx(
        8192 * 100 * 7200 / R.IMAD_PER_S * 1e3)
    assert R.bound(1e12, 1)[1] == "bytes"
    chip_smoke = importlib.import_module("chip_smoke")
    for name in ("HBM_BYTES_PER_S", "IMAD_PER_S", "INT8_MAC_PER_S", "bound",
                 "imad_per_mont_mul"):
        assert getattr(chip_smoke, name) is getattr(R, name)
    assert R.MODEL_NOTE.startswith("NVIDIA H100")


def test_roofline_report_needs_a_card():
    """A measurement of the card: no CPU numbers under its keys."""
    with pytest.raises(ValueError):
        R.roofline_report(E.CurveCtx(config.BLS381), batch=8, iters=1,
                          device="cpu")


def test_chain_forms_and_latency_on_cpu():
    """The chain kernel's group-law forms on the CPU (their plain
    versions): the warp add is the add, the doubling forms on points of
    the curve are the complete add of the point to itself (RCB16's
    dedicated doubling, 8 products for a = 0 and 17 for ed25519); an
    unknown form is refused, and the latency line measures a card only."""
    for name, cv in config.CURVES.items():
        ctx = E.CurveCtx(cv)
        assert R.mont_muls_per_dbl(ctx) == (17 if name == "ed25519" else 8)
        rnd = random.Random(3)
        P32 = pack32(E.to_device_points([bt.G1.random(rnd, cv)
                                         for _ in range(3)], ctx, "cpu"), 1)
        assert torch.equal(R.ec_chain(P32, 2, "add_warp", ctx),
                           R.ec_add_chain(P32, 2, ctx))
        want = unpack32(P32, 1)
        for _ in range(2):
            want = E.ec_add(want, want, ctx)
        for form in ("dbl", "dbl_warp"):
            assert torch.equal(unpack32(R.ec_chain(P32, 2, form, ctx), 1),
                               want)
    with pytest.raises(ValueError):
        R.ec_chain(P32, 1, "triple", ctx)
    with pytest.raises(ValueError):
        R.chain_latency(ctx, iters=1, device="cpu")
