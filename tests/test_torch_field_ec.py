"""The port's field and curve layers (bulletproofs_tpu_torch/ops/field.py,
ops/ec.py) against the JAX package's (ops/field_jax.py, ops/ec_jax.py,
ec_pallas._ec_madd_2d) and against the port's own exact-int host types.

Inputs are made with numpy or `random.Random` from a seed and passed as
numpy arrays to both packages.  All results are canonical Montgomery limbs,
so every comparison is exact equality.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproofs_tpu import config as jconfig
from bulletproofs_tpu.ops import ec_jax as ej
from bulletproofs_tpu.ops import field_jax as fj
from bulletproofs_tpu.ops.ec_host import G1 as JG1

from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops.ec_host import G1, msm_host
from bulletproofs_tpu_torch.ops.field_host import Scalar

# One torch thread: the suite runs several test processes at once, and
# each process's own thread pool would oversubscribe the cores.
torch.set_num_threads(1)

CURVES = ["bls381", "bn254"]


def _values(modulus, n, seed):
    rnd = random.Random(seed)
    edge = [0, 1, modulus - 1, modulus - 2]
    return edge + [rnd.randrange(modulus) for _ in range(n - len(edge))]


def _pair(curve, field, seed, n=40):
    """Two (L, n) limb arrays of canonical values of curve.fp or curve.fr."""
    fp = getattr(config.CURVES[curve], field)
    a = F.ints_to_limbs(_values(fp.modulus, n, seed), fp.n_limbs)
    b = F.ints_to_limbs(_values(fp.modulus, n, seed + 1)[::-1], fp.n_limbs)
    return fp, a, b


@pytest.mark.parametrize("curve", CURVES)
def test_limb_packing_round_trips(curve):
    fp, a, _ = _pair(curve, "fp", 1)
    t = torch.as_tensor(a)
    words = F.pack32(t, 0)
    assert words.dtype == torch.int32 and words.shape[0] == fp.n_limbs // 2
    assert torch.equal(F.unpack32(words, 0), t)
    # word k holds limbs 2k and 2k+1: the same integer in base 2^32
    u = words.to(torch.int64) & 0xFFFFFFFF
    ints = [sum(int(u[k, j]) << (32 * k) for k in range(u.shape[0]))
            for j in range(u.shape[1])]
    assert ints == F.limbs_to_ints(a)
    rows = t.T.contiguous()
    assert torch.equal(F.unpack32(F.pack32(rows, -1), -1), rows)


@pytest.mark.parametrize("field", ["fp", "fr"])
@pytest.mark.parametrize("curve", CURVES)
def test_field_ops_match_field_jax(curve, field):
    fp, a, b = _pair(curve, field, 7)
    jctx = fj.FieldCtx(getattr(jconfig.CURVES[curve], field))
    ctx = F.FieldCtx(fp)

    @jax.jit
    def jax_ops(x, y):
        return (fj.mont_mul(x, y, jctx), fj.add_mod(x, y, jctx),
                fj.sub_mod(x, y, jctx), fj.neg_mod(x, jctx),
                fj.mul_small(x, 12, jctx), fj.mul_small(y, 36, jctx),
                fj._to_mont_jit(x, jctx), fj._from_mont_jit(x, jctx))

    want = jax_ops(jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32))
    x, y = torch.as_tensor(a), torch.as_tensor(b)
    got = (F.mont_mul(x, y, ctx), F.add_mod(x, y, ctx), F.sub_mod(x, y, ctx),
           F.neg_mod(x, ctx), F.mul_small(x, 12, ctx),
           F.mul_small(y, 36, ctx), F.to_mont(x, ctx), F.from_mont(x, ctx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # and the exact-int meaning
    p, rinv = fp.modulus, pow(fp.mont_r, -1, fp.modulus)
    xs, ys = F.limbs_to_ints(a), F.limbs_to_ints(b)
    assert F.limbs_to_ints(got[0]) == [u * v * rinv % p
                                       for u, v in zip(xs, ys)]
    assert ctx.from_mont(ctx.to_mont(xs, "cpu")) == xs


def _chain_values(modulus, n_limbs):
    """Canonical values whose limbs make long carry and borrow chains:
    runs of 0xFFFF and of zeros, from the bottom and from the top, next to
    0, 1, p - 1 and p - 2^16."""
    vals = {0, 1, modulus - 1, modulus - 2, modulus - (1 << 16)}
    for k in range(1, n_limbs + 1):
        run = (1 << (16 * k)) - 1
        vals.update({run % modulus, (modulus - run) % modulus,
                     (modulus >> (16 * k)) << (16 * k), (1 << (16 * k))
                     % modulus})
    return sorted(vals)


@pytest.mark.parametrize("field", ["fp", "fr"])
@pytest.mark.parametrize("curve", CURVES)
def test_carry_chains_match_python_ints(curve, field):
    """The vectorized carry and borrow chains of add_mod, sub_mod and
    mont_mul on every pair of chain-heavy values, against Python ints."""
    fp = getattr(config.CURVES[curve], field)
    ctx = F.FieldCtx(fp)
    p, rinv = fp.modulus, pow(fp.mont_r, -1, fp.modulus)
    vals = _chain_values(p, fp.n_limbs)
    xs = [u for u in vals for _ in vals]
    ys = [v for _ in vals for v in vals]
    x = torch.as_tensor(F.ints_to_limbs(xs, fp.n_limbs))
    y = torch.as_tensor(F.ints_to_limbs(ys, fp.n_limbs))
    assert F.limbs_to_ints(F.add_mod(x, y, ctx)) == \
        [(u + v) % p for u, v in zip(xs, ys)]
    assert F.limbs_to_ints(F.sub_mod(x, y, ctx)) == \
        [(u - v) % p for u, v in zip(xs, ys)]
    assert F.limbs_to_ints(F.mont_mul(x, y, ctx)) == \
        [u * v * rinv % p for u, v in zip(xs, ys)]


@pytest.mark.parametrize("c", [3, 4, 6, 8])
@pytest.mark.parametrize("curve", CURVES)
def test_get_digits_match(curve, c):
    fr = config.CURVES[curve].fr
    s = F.ints_to_limbs(_values(fr.modulus, 64, c), fr.n_limbs)
    W = -(-fr.n_bits // c)
    want = np.asarray(fj.get_digits(jnp.asarray(s, jnp.uint32), c, W))
    got = F.get_digits(torch.as_tensor(s), c, W)
    np.testing.assert_array_equal(got.numpy(), want)


def _point_arrays(curve, seed, m=12):
    """(3, L, m) JAX-layout points: random ones, an identity, P == Q."""
    jcv = jconfig.CURVES[curve]
    jctx = ej.CurveCtx(jcv)
    rnd = random.Random(seed)
    A = [JG1.random(rnd, jcv) for _ in range(m - 1)] + [JG1.identity(jcv)]
    B = [JG1.random(rnd, jcv) for _ in range(m - 3)] + \
        [JG1.identity(jcv), A[0], A[1]]
    return (np.array(ej.to_device_points(A, jctx)),
            np.array(ej.to_device_points(B, jctx)), jctx)


@pytest.mark.parametrize("curve", CURVES + ["ed25519"])
def test_ec_add_matches_ec_jax(curve):
    """a = 0 curves (RCB16 algorithm 7) and ed25519 (the general-a tail)."""
    P, Q, jctx = _point_arrays(curve, 3)
    want = np.asarray(jax.jit(lambda p, q: ej.ec_add(p, q, jctx))(P, Q))
    ctx = E.CurveCtx(config.CURVES[curve])
    got = E.ec_add(E.from_jax_points(P, "cpu"), E.from_jax_points(Q, "cpu"),
                   ctx)
    np.testing.assert_array_equal(E.to_jax_points(got), want)


@pytest.mark.parametrize("curve", CURVES)
def test_ec_madd_matches_pallas_madd(curve):
    """The mixed add against ec_pallas._ec_madd_2d (RCB16 algorithm 8) on
    affine second operands, identity and doubling included."""
    from bulletproofs_tpu.ops.ec_pallas import _ec_madd_2d

    jcv = jconfig.CURVES[curve]
    P, _, jctx = _point_arrays(curve, 5)       # last column: the identity
    rnd = random.Random(6)
    pts = [JG1.random(rnd, jcv) for _ in range(P.shape[2] - 1)]
    aff = np.array(ej.to_device_points_affine(pts, jctx)[0])
    Qxy = np.concatenate([aff[:2], aff[:2, :, :1]], axis=2)
    P[:, :, 0] = aff[:, :, 0]                  # slot 0 doubles

    @jax.jit
    def jax_madd(p, q):
        return jnp.stack(_ec_madd_2d(jctx.fp, jctx.b3, p[0], p[1], p[2],
                                     q[0], q[1]))

    want = np.asarray(jax_madd(P, Qxy))
    ctx = E.CurveCtx(config.CURVES[curve])
    got = E.ec_madd(E.from_jax_points(P, "cpu"),
                    E.from_jax_points(Qxy, "cpu"), ctx)
    np.testing.assert_array_equal(E.to_jax_points(got), want)


@pytest.mark.parametrize("curve", CURVES + ["ed25519"])
def test_ec_add_matches_port_host(curve):
    cv = config.CURVES[curve]
    ctx = E.CurveCtx(cv)
    rnd = random.Random(8)
    A = [G1.random(rnd, cv) for _ in range(5)] + [G1.identity(cv)]
    B = [G1.random(rnd, cv) for _ in range(4)] + [A[4], A[0]]
    got = E.from_device_points(
        E.ec_add(E.to_device_points(A, ctx, "cpu"),
                 E.to_device_points(B, ctx, "cpu"), ctx), ctx)
    assert [(g.X, g.Y, g.Z) for g in got] == \
        [((a + b).X, (a + b).Y, (a + b).Z) for a, b in zip(A, B)]
    assert E.ec_double(E.to_device_points(A[:1], ctx, "cpu"), ctx).shape \
        == (3, ctx.fp.L, 1)


@pytest.mark.parametrize("curve", CURVES)
def test_conversions_match_jax_package(curve):
    """Host points/scalars -> device arrays agree with the JAX package's,
    and the JAX-array bridges round-trip."""
    cv, jcv = config.CURVES[curve], jconfig.CURVES[curve]
    ctx, jctx = E.CurveCtx(cv), ej.CurveCtx(jcv)
    rnd = random.Random(9)
    ks = [rnd.randrange(cv.r) for _ in range(6)]
    pts = [G1.generator(cv) * Scalar(k, cv) for k in ks]
    jpts = [JG1.generator(jcv) * k for k in ks]
    got, aff = E.to_device_points_affine(pts, ctx, "cpu")
    want, jaff = ej.to_device_points_affine(jpts, jctx)
    assert aff and jaff
    np.testing.assert_array_equal(E.to_jax_points(got), np.asarray(want))
    s = E.to_device_scalars(ks, ctx, "cpu")
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(ej.to_device_scalars(ks, jctx)))
    assert torch.equal(E.from_jax_scalars(np.asarray(
        ej.to_device_scalars(ks, jctx)), "cpu"), s)
    back = E.from_device_points(E.from_jax_points(np.asarray(want), "cpu"),
                                ctx)
    assert [b.to_bytes() for b in back] == [p.to_bytes() for p in jpts]


def test_host_types_match_jax_package_bytes():
    """The port's own G1 / msm_host copy gives the JAX package's bytes."""
    from bulletproofs_tpu.ops.ec_host import msm_host as jmsm_host

    rnd = random.Random(10)
    for name in ("bls381", "bn254", "ed25519"):
        cv, jcv = config.CURVES[name], jconfig.CURVES[name]
        msgs = [b"port%d" % i for i in range(4)]
        ks = [rnd.randrange(cv.r) for _ in msgs]
        pts = [G1.from_msg_hash(m, cv) for m in msgs]
        jpts = [JG1.from_msg_hash(m, jcv) for m in msgs]
        assert [p.to_bytes() for p in pts] == [p.to_bytes() for p in jpts]
        assert msm_host(pts, ks).to_bytes() == jmsm_host(jpts, ks).to_bytes()
        assert G1.from_bytes(pts[0].to_bytes(), cv) == pts[0]
