"""The port's device transcript (bulletproofs_tpu_torch: ops/keccak.py,
ops/transcript_device.py) and the plain version of the fused IPA's
Fiat-Shamir kernel (ops/transcript_kernels.py: ipa_challenge_plain, what
the `ipa_challenge` wrapper runs for CPU tensors) against the JAX
package's keccak_jax and transcript_device and the host transcript.

Inputs are made from seeds (numpy and `random`), cross between the
packages as numpy arrays or host objects, and every comparison is exact:
bytes, registers and limbs.  The JAX side of an IPA round (serialize_points,
DeviceTranscript, reduce_bytes_mod_r, field_jax.inv_mont) runs as one
jitted function per curve and starting registers.  Each test of a curve
runs on BLS12-381 (modbytes 48) and BN254 (32).
"""

import random
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofs_tpu import config as jconfig
from bulletproofs_tpu.ops import ec_jax as ej
from bulletproofs_tpu.ops import field_jax as fj
from bulletproofs_tpu.ops import keccak_jax as jk
from bulletproofs_tpu.ops import transcript_device as jtd

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops import keccak as K
from bulletproofs_tpu_torch.ops import transcript_device as TD
from bulletproofs_tpu_torch.ops import transcript_kernels as TK
from bulletproofs_tpu_torch.transcript import keccak_f1600

torch.set_num_threads(1)

CURVES = ["bls381", "bn254"]


def _state(rs):
    return rs.integers(0, 256, 200, dtype=np.uint8)


@pytest.mark.parametrize("perms", [1, 2])
def test_keccak_matches_jax_and_host(perms):
    """Random states permuted once and twice: the port's lanes form
    against the JAX package's `keccak_f1600_device` and the host
    permutation; the lane packing against the JAX package's."""
    rs = np.random.default_rng(10 + perms)
    jax_perm = jax.jit(jk.keccak_f1600_device)
    for _ in range(3):
        st = _state(rs)
        mine = torch.as_tensor(st.astype(np.int64))
        theirs = jnp.asarray(st.astype(np.uint32))
        host = bytearray(st.tobytes())
        for _ in range(perms):
            mine = K.keccak_f1600_device(mine)
            theirs = jax_perm(theirs)
            keccak_f1600(host)
        assert bytes(mine.tolist()) == bytes(host)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    lo, hi = K.pack_lanes(torch.as_tensor(st.astype(np.int64)))
    jlo, jhi = jk.pack_lanes(jnp.asarray(st.astype(np.uint32)))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert torch.equal(K.unpack_lanes(lo, hi),
                       torch.as_tensor(st.astype(np.int64)))


def _points(cv, seed):
    """Random points, one with Z != 1 (a sum left projective), and the
    identity."""
    rng = random.Random(seed)
    pts = [bt.G1.random(rng, cv) for _ in range(4)] + [bt.G1.identity(cv)]
    pts[1] = pts[1] + pts[2]
    assert pts[1].Z != 1
    return pts


@pytest.mark.parametrize("curve", CURVES)
def test_serialize_points_matches_jax_and_to_bytes(curve):
    cv, jcv = config.CURVES[curve], jconfig.CURVES[curve]
    ctx = E.CurveCtx(cv)
    pts = _points(cv, 20)
    dev = E.to_device_points(pts, ctx, "cpu")
    got = TD.serialize_points(dev, ctx)
    assert got.shape == (len(pts), 2 * cv.modbytes + 1)
    for row, pt in zip(got, pts):
        assert bytes(row.tolist()) == pt.to_bytes()
    jctx = ej.CurveCtx(jcv)
    want = jax.jit(lambda p: jtd.serialize_points(p, jctx))(
        jnp.asarray(E.to_jax_points(dev)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serialize_points_refuses_edwards_curves():
    cv = config.ED25519
    ctx = E.CurveCtx(cv)
    dev = E.to_device_points([bt.G1.random(random.Random(1), cv)], ctx,
                             "cpu")
    with pytest.raises(ValueError, match="Edwards"):
        TD.serialize_points(dev, ctx)
    with pytest.raises(ValueError, match="Edwards"):
        TK.ipa_challenge(F.pack32(dev.expand(3, ctx.fp.L, 2), 1),
                         torch.zeros(200, dtype=torch.int64), (0, 0, 0), ctx)


@pytest.mark.parametrize("curve", CURVES)
def test_reduce_bytes_mod_r_matches_jax_and_from_bytes(curve):
    cv, jcv = config.CURVES[curve], jconfig.CURVES[curve]
    ctx, jctx = E.CurveCtx(cv), ej.CurveCtx(jcv)
    rs = np.random.default_rng(30)
    raws = [rs.integers(0, 256, cv.modbytes, dtype=np.uint8)
            for _ in range(3)]
    raws += [np.full(cv.modbytes, 255, np.uint8),
             np.zeros(cv.modbytes, np.uint8)]
    jreduce = jax.jit(lambda b: jtd.reduce_bytes_mod_r(b, jctx))
    for raw in raws:
        got = TD.reduce_bytes_mod_r(torch.as_tensor(raw.astype(np.int64)),
                                    ctx)
        assert got.shape == (ctx.fr.L, 1)
        assert F.limbs_to_ints(F.from_mont(got, ctx.fr))[0] == \
            bt.Scalar.from_bytes(raw.tobytes(), cv).v
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jreduce(jnp.asarray(raw.astype(
                np.uint32)))))


def _jax_round(jctx):
    """One IPA round composed from the JAX package's functions, jitted with
    the starting registers static: (points (3, L, 2), state) -> (L and R
    bytes, new state, u, u^-1 in Montgomery form)."""
    @partial(jax.jit, static_argnums=(2, 3, 4))
    def run(pts, state, pos, pos_begin, cur_flags):
        pb = jtd.serialize_points(pts, jctx)
        t = jtd.DeviceTranscript.from_snapshot(state, pos, pos_begin,
                                               cur_flags)
        t.commit_point_bytes(b"L", pb[0])
        t.commit_point_bytes(b"R", pb[1])
        u = t.challenge_scalar_mont(b"u", jctx)
        return pb, t.strobe.st, u, fj.inv_mont(u, jctx.fr)
    return run


@pytest.fixture(scope="module", params=CURVES)
def rounds(request):
    """Three IPA rounds from a transcript after `innerproduct_domain_sep`
    (each round's absorb crosses the STROBE rate): round 1's L is
    projective (Z != 1) and its R the identity, then random points.  Each
    round through the port's plain kernel (`ipa_challenge` on CPU
    tensors), the JAX package's composed round, and the host transcript."""
    curve = request.param
    cv, jcv = config.CURVES[curve], jconfig.CURVES[curve]
    ctx, jctx = E.CurveCtx(cv), ej.CurveCtx(jcv)
    pts = _points(cv, 40) + _points(cv, 41)[:3]
    pairs = [(pts[1], pts[4]), (pts[0], pts[2]), (pts[5], pts[6])]
    host = bt.ProofTranscript(b"torch-td")
    host.innerproduct_domain_sep(1 << 5)
    start = host.clone()
    snap, *regs = TD.DeviceTranscript.snapshot(host)
    state, jstate = torch.as_tensor(snap), jnp.asarray(snap.astype(
        np.uint32))
    jrun = _jax_round(jctx)
    out = {"ctx": ctx, "cv": cv, "start": start, "host": host,
           "pairs": pairs, "regs": [], "port": [], "jax": [], "host_u": [],
           "host_state": [], "host_regs": []}
    for L, R in pairs:
        dev = E.to_device_points([L, R], ctx, "cpu")
        out["regs"].append(tuple(regs))
        port = TK.ipa_challenge(F.pack32(dev, 1), state, tuple(regs), ctx)
        theirs = jrun(jnp.asarray(E.to_jax_points(dev)), jstate, *regs)
        out["port"].append(port)
        out["jax"].append([np.asarray(x) for x in theirs])
        host.commit_point(b"L", L)
        host.commit_point(b"R", R)
        with config.using_curve(cv):      # the host reads the active curve
            out["host_u"].append(host.challenge_scalar(b"u"))
        out["host_state"].append(bytes(host.strobe.state))
        s = host.strobe
        out["host_regs"].append((s.pos, s.pos_begin, s.cur_flags))
        state, jstate = port[1], theirs[1]
        regs = TK.round_registers(regs, ctx)
    return out


def test_ipa_challenge_plain_matches_jax_round(rounds):
    """The plain `bp_ipa_challenge` round, limb for limb and byte for byte
    the same steps composed from the JAX package's functions."""
    for (pb, st, u), (jpb, jst, ju, ju_inv) in zip(rounds["port"],
                                                   rounds["jax"]):
        assert pb.dtype == st.dtype == u.dtype == torch.int64
        np.testing.assert_array_equal(pb.numpy(), jpb)
        np.testing.assert_array_equal(st.numpy(), jst)
        np.testing.assert_array_equal(u[0].numpy(), ju)
        np.testing.assert_array_equal(u[1].numpy(), ju_inv)


def test_ipa_round_schedule_matches_host(rounds):
    """Each round's point bytes, challenge, its inverse, state and
    registers against the host `ProofTranscript`; the registers after
    round 1 are every later round's start (the fused IPA's invariant);
    a host transcript written back from the device state continues
    byte-identically."""
    ctx, cv = rounds["ctx"], rounds["cv"]
    fr = ctx.fr
    for j, ((pb, st, u), (L, R)) in enumerate(zip(rounds["port"],
                                                 rounds["pairs"])):
        assert [bytes(x.tolist()) for x in pb] == [L.to_bytes(),
                                                   R.to_bytes()]
        want = rounds["host_u"][j]
        assert F.limbs_to_ints(F.from_mont(u[:, :, 0].T, fr)) == [
            want.v, want.inverse().v]
        assert bytes(st.tolist()) == rounds["host_state"][j]
        assert TK.round_registers(rounds["regs"][j], ctx) == \
            rounds["host_regs"][j]
    assert rounds["regs"][1] == rounds["regs"][2] == rounds["host_regs"][0]
    assert rounds["host_regs"][0] == (cv.modbytes, 0, 7)

    cont = rounds["start"].clone()
    sched = TK.round_schedule(ctx) * len(rounds["pairs"])
    regs = TD.replay_positions(cont, sched)
    assert regs == rounds["host_regs"][-1]
    TD.DeviceTranscript.writeback(cont, rounds["port"][-1][1], *regs)
    host = rounds["host"].clone()
    assert cont.challenge_bytes(b"post", 64) == \
        host.challenge_bytes(b"post", 64)


@pytest.mark.parametrize("curve", CURVES)
def test_device_transcript_ops_match_host(curve):
    """The merlin ops on the port's `DeviceTranscript`: constant and device
    messages, one of 400 bytes that crosses the rate twice, challenge
    bytes and a challenge scalar, against the host transcript at every
    step."""
    cv = config.CURVES[curve]
    ctx = E.CurveCtx(cv)
    rs = np.random.default_rng(50)
    host = bt.ProofTranscript(b"torch-td-ops")
    snap, *regs = TD.DeviceTranscript.snapshot(host)
    dt = TD.DeviceTranscript.from_snapshot(torch.as_tensor(snap), *regs)
    blob = rs.integers(0, 256, 400, dtype=np.uint8)
    host.append_message(b"const", b"abc")
    dt.append_message_const(b"const", b"abc")
    host.append_message(b"blob", blob.tobytes())
    dt.append_message_var(b"blob", torch.as_tensor(blob.astype(np.int64)))
    assert bytes(dt.challenge_bytes(b"c", 70).tolist()) == \
        host.challenge_bytes(b"c", 70)
    u = dt.challenge_scalar_mont(b"u", ctx)
    with config.using_curve(cv):          # the host reads the active curve
        want = host.challenge_scalar(b"u").v
    assert F.limbs_to_ints(F.from_mont(u, ctx.fr))[0] == want
    s = host.strobe
    assert bytes(dt.strobe.st.tolist()) == bytes(s.state)
    assert dt.strobe.regs() == (s.pos, s.pos_begin, s.cur_flags)
    with pytest.raises(ValueError, match="mid-op"):
        dt.strobe.meta_ad_const(b"x", True)


def test_ipa_challenge_checks_operands():
    ctx = E.CurveCtx(config.BLS381)
    nl = ctx.fp.L // 2
    pts = torch.zeros((3, nl, 2), dtype=torch.int32)
    state = torch.zeros(200, dtype=torch.int64)
    for bad_pts, bad_state in ((pts.long(), state), (pts[:, :, :1], state),
                               (pts, state[:199]), (pts, state.int())):
        with pytest.raises(ValueError):
            TK.ipa_challenge(bad_pts, bad_state, (0, 0, 0), ctx)
