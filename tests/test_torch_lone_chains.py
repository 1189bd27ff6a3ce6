"""The lone chains' doubling and schedules on the CPU: RCB16's dedicated
doubling (`ops/ec.py: ec_dbl_plain`, algorithm 9 for a = 0 and algorithm
3 for ed25519, the plain counterpart of the kernels' `ec_dbl_l`) held limb
for limb against the complete add of a point to itself (`ec_add(P, P)`)
and the JAX package's `ec_double` on every curve; and the Horner with the
doublings of its opening identity skipped, as its kernel runs it, against
its plain version, which doubles by the complete add.  The kernels
themselves run on an emulated warp in tests/test_torch_lanes_emulated.py
and on the card in tests/test_torch_cuda.py.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofs_tpu import config as jconfig
from bulletproofs_tpu.ops import ec_jax as ej

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import ec_kernels as ek
from bulletproofs_tpu_torch.ops.field import pack32, unpack32

torch.set_num_threads(1)

CURVES = sorted(config.CURVES)


def _points(cv, seed):
    """(3, L, 12) Montgomery points of the curve from a seed: 4 random
    points, each with a random Z (X, Y, Z times a random non-zero lambda
    from numpy), the identity (0 : 1 : 0) and (0 : lambda : 0), and 6
    bucket sums of 2 to 4 of those by the complete add (one of them
    P + P, one P + O)."""
    ctx = E.CurveCtx(cv)
    p = cv.p
    rnd = random.Random(seed)
    rng = np.random.default_rng(seed)
    lam = [int.from_bytes(rng.bytes(64), "little") % (p - 1) + 1
           for _ in range(5)]
    base = [bt.G1.random(rnd, cv) for _ in range(4)]
    pts = [bt.G1(q.X * k % p, q.Y * k % p, q.Z * k % p, cv)
           for q, k in zip(base, lam)]
    pts += [bt.G1(0, 1, 0, cv), bt.G1(0, lam[4], 0, cv)]
    P = E.to_device_points(pts, ctx, "cpu")
    picks = [(0, 1), (2, 3, 1), (0, 0), (1, 4), (3, 2, 1, 0), (5, 2)]
    sums = []
    for pick in picks:
        acc = P[:, :, pick[:1]]
        for i in pick[1:]:
            acc = E.ec_add(acc, P[:, :, i:i + 1], ctx)
        sums.append(acc)
    return ctx, torch.cat([P] + sums, dim=2)


@pytest.mark.parametrize("curve", CURVES)
def test_dedicated_doubling_matches_complete_add_and_jax(curve):
    """`ec_dbl_plain` equals `ec_add(P, P)` and the JAX package's
    `ec_double` limb for limb on points with random Z, the identity (also
    scaled) and bucket sums; the identity doubles to (0 : 1 : 0) itself;
    the result is 2P on the host."""
    cv = config.CURVES[curve]
    ctx, P = _points(cv, 41)
    got = E.ec_dbl_plain(P, ctx)
    assert torch.equal(got, E.ec_add(P, P, ctx))
    jctx = ej.CurveCtx(jconfig.CURVES[curve])
    want = np.asarray(jax.jit(lambda x: ej.ec_double(x, jctx))(
        jnp.asarray(E.to_jax_points(P))))
    np.testing.assert_array_equal(E.to_jax_points(got), want)
    assert torch.equal(got[:, :, 4], ctx.identity_like((1,), "cpu")[:, :, 0])
    for q, d in zip(E.from_device_points(P, ctx),
                    E.from_device_points(got, ctx)):
        assert d == q + q


@pytest.mark.parametrize("curve", ["bn254", "ed25519"])
def test_dedicated_doubling_differs_off_the_curve(curve):
    """Off the curve the two doublings part: the precondition the kernels
    state (their operands are sums of curve points) is not idle."""
    cv = config.CURVES[curve]
    ctx = E.CurveCtx(cv)
    rng = np.random.default_rng(5)
    p = cv.p
    vals = [int.from_bytes(rng.bytes(48), "little") % p for _ in range(3)]
    Q = E.to_device_points([bt.G1(*vals, cv)], ctx, "cpu")
    assert not torch.equal(E.ec_dbl_plain(Q, ctx), E.ec_add(Q, Q, ctx))


def _horner_skipping(totals32, wps, c, ctx):
    """The Horner as its kernel runs it: the doublings of the opening
    identity skipped, the others by the dedicated doubling."""
    t = unpack32(totals32, 1)
    n_sets = t.shape[2] // wps
    t = t.reshape(t.shape[:2] + (n_sets, wps))
    acc = ctx.identity_like((n_sets,), "cpu")
    for w in range(wps - 1, -1, -1):
        if w < wps - 1:
            for _ in range(c):
                acc = E.ec_dbl_plain(acc, ctx)
        acc = E.ec_add(acc, t[..., w], ctx)
    return pack32(acc, 1)


@pytest.mark.parametrize("curve", CURVES)
def test_horner_skipping_opening_doublings_matches_plain(curve):
    """`ec_horner_plain` (c = 8, 2 sets of 3 windows, doubling by the
    complete add from the identity) equals the kernel's order, which
    skips the top window's doublings: on bucket sums, and with the first
    set's top window total the identity (its first add is not skipped:
    identity + O rescales nothing, identity + T gives (X*Y : Y*Y : Z*Y))."""
    cv = config.CURVES[curve]
    ctx, P = _points(cv, 43)
    totals = pack32(P[:, :, 6:12], 1).contiguous()
    want = ek.ec_horner_plain(totals, 3, 8, ctx)
    assert torch.equal(_horner_skipping(totals, 3, 8, ctx), want)
    totals[:, :, 2] = ek.packed_identity(ctx, (1,), "cpu")[:, :, 0]
    assert torch.equal(_horner_skipping(totals, 3, 8, ctx),
                       ek.ec_horner_plain(totals, 3, 8, ctx))
