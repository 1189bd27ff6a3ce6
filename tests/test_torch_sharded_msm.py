"""The port's sharded MSM (bulletproofs_tpu_torch/parallel/sharded_msm.py)
against the JAX package's (bulletproofs_tpu/parallel/sharded_msm.py) on
the CPU: the port on a virtual mesh of 8 CPU shards, `make_mesh(["cpu"] *
8)`, the JAX package on its 8 virtual CPU devices (tests/conftest.py).

The butterfly's bucket arrays are compared limb for limb with the JAX
package's `_allreduce_buckets` under `shard_map`; the sharded MSMs are
compared as group elements with `msm_sharded_jit` / `msm_sharded_2d_jit`
and with `msm_host`, on the cases of tests/test_sharded_hardening.py cut
to n = 64 (uniform on both curves, skewed and degenerate, imbalanced
shards, n not divisible by 8, 2 x 4 and 4 x 2 meshes).  At n = 64 every
shard holds 8 entries, so every BLS12-381 case has the global round count
8 and the 1-D cases share one JAX compile.
"""

import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bulletproofs_tpu import config as jconfig
from bulletproofs_tpu.ops import ec_jax as ej
from bulletproofs_tpu.ops.ec_host import G1 as JG1
from bulletproofs_tpu.parallel import sharded_msm as jsm

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.parallel import sharded_msm as SM

# One torch thread: the suite runs several test processes at once.
torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8
    return jsm.make_mesh(jax.devices()[:8])


def _bucket_shards(jctx, seed, W=2, B=4):
    """8 bucket arrays (3, L, W, B) of projective points, one slot in 7 the
    identity, as numpy (8, 3, L, W, B) Montgomery limbs."""
    rnd = random.Random(seed)
    base = [JG1.random(rnd, jctx.cv) for _ in range(6)]
    pts = np.asarray(ej.to_device_points([p + p for p in base], jctx))
    pick = np.random.default_rng(seed).integers(0, 6, 8 * W * B)
    arr = pts[:, :, pick]
    arr[:, :, ::7] = np.asarray(jctx.identity)[:, :, :1]
    L = arr.shape[1]
    return np.ascontiguousarray(
        arr.reshape(3, L, 8, W, B).transpose(2, 0, 1, 3, 4))


def test_allreduce_buckets_matches_jax(jmesh):
    """Every shard's butterfly result equals the JAX package's limb for
    limb; root=0 gives shard 0's limbs with the adds shard 0 needs."""
    ctx, jctx = E.CurveCtx(config.BLS381), ej.CurveCtx(jconfig.BLS381)
    arr = _bucket_shards(jctx, 81)

    def body(b):
        return jsm._allreduce_buckets(b[0], jctx, jsm.AXIS)[None]

    want = np.asarray(jax.jit(jax.shard_map(
        body, mesh=jmesh, in_specs=P(jsm.AXIS), out_specs=P(jsm.AXIS),
        check_vma=False))(arr))
    shards = [F.pack32(E.from_jax_points(a, "cpu"), 1) for a in arr]
    got = SM._allreduce_buckets(shards, ctx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(E.to_jax_points(F.unpack32(g, 1)), w)
    root = SM._allreduce_buckets(shards, ctx, root=0)[0]
    np.testing.assert_array_equal(E.to_jax_points(F.unpack32(root, 1)),
                                  want[0])
    # and the sum is the sum
    flat = lambda a: E.from_device_points(
        torch.as_tensor(a.astype(np.int64)).reshape(3, ctx.fp.L, -1), ctx)
    total = [bt.G1.identity(config.BLS381)] * 8
    for a in arr:
        total = [t + p for t, p in zip(total, flat(a))]
    assert flat(want[0]) == total


def _input(case, cv, jcv):
    """A case of tests/test_sharded_hardening.py at n = 64 (61 where n is
    not divisible): the JAX package's host points and the scalars as ints,
    and the port's points."""
    seed, n = {"uniform": (41, 64), "skewed": (42, 64),
               "imbalanced": (43, 64), "non_divisible": (44, 61),
               "mesh_2x4": (45, 64), "mesh_4x2_non_divisible": (46, 61)}[case]
    rng = random.Random(seed)
    base = [JG1.random(rng, jcv) for _ in range(16)]
    jpts = [base[i % 16] for i in range(n)]
    if case == "skewed":                  # 0/1 bits and repeated constants
        ks = [rng.randrange(2) for _ in range(n)]
        ks[17], ks[40] = cv.r - 1, 1 << 200
    elif case == "imbalanced":            # the heavy scalars all in shard 0
        ks = [0] * n
        for i in range(n // 8):
            ks[i] = rng.randrange(cv.r)
        for i in range(n // 8, n, 9):
            ks[i] = 3
    else:
        ks = [rng.randrange(cv.r) for _ in range(n)]
    if case == "mesh_4x2_non_divisible":
        ks[0] = 0
    return jpts, ks, E.from_jax_host(jpts, cv)


CASES = [("uniform", "bls381"), ("uniform", "bn254"), ("skewed", "bls381"),
         ("imbalanced", "bls381"), ("non_divisible", "bls381"),
         ("mesh_2x4", "bls381"), ("mesh_4x2_non_divisible", "bls381")]


@pytest.mark.parametrize("case,curve", CASES)
def test_msm_sharded_matches_jax_and_host(jmesh, case, curve):
    """`msm_sharded` (`msm_sharded_2d` on the 2-D meshes) on 8 CPU shards
    equals `msm_host` and the JAX package's `msm_sharded_jit`
    (`msm_sharded_2d_jit`) on its 8 devices, as group elements."""
    cv, jcv = config.CURVES[curve], jconfig.CURVES[curve]
    ctx, jctx = E.CurveCtx(cv), ej.CurveCtx(jcv)
    c = 4
    jpts, ks, pts = _input(case, cv, jcv)
    Pj, sj = ej.to_device_points(jpts, jctx), ej.to_device_scalars(ks, jctx)
    Pt, affine = E.to_device_points_affine(pts, ctx, "cpu")
    st = E.to_device_scalars(ks, ctx, "cpu")
    if case.startswith("mesh_"):
        hosts, chips = (2, 4) if case == "mesh_2x4" else (4, 2)
        got = SM.msm_sharded_2d(Pt, st, ctx, c,
                                SM.make_mesh_2d(hosts, chips, CPU8),
                                affine=affine)
        want = jsm.msm_sharded_2d_jit(Pj, sj, jctx, c,
                                      jsm.make_mesh_2d(hosts, chips))
    else:
        got = SM.msm_sharded(Pt, st, ctx, c, SM.make_mesh(CPU8),
                             affine=affine)
        want = jsm.msm_sharded_jit(Pj, sj, jctx, c, jmesh)
    assert got.shape == (3, ctx.fp.L, 1)
    (point,) = E.from_device_points(got, ctx)
    assert point == bt.msm_host(pts, ks)
    assert point == E.from_jax_host(ej.from_device_points(want, jctx)[0], cv)


def test_pad_to_multiple_matches_jax():
    """The pad path: identity points and zero scalars up to a multiple of
    the mesh size, limb for limb as the JAX package pads."""
    ctx, jctx = E.CurveCtx(config.BLS381), ej.CurveCtx(jconfig.BLS381)
    jpts, ks, pts = _input("non_divisible", config.BLS381, jconfig.BLS381)
    Pj, sj = jsm._pad_to_multiple(ej.to_device_points(jpts, jctx),
                                  ej.to_device_scalars(ks, jctx), jctx, 8)
    Pt, st = SM._pad_to_multiple(E.to_device_points(pts, ctx, "cpu"),
                                 E.to_device_scalars(ks, ctx, "cpu"), ctx, 8)
    assert Pt.shape[2] == st.shape[1] == 64
    np.testing.assert_array_equal(E.to_jax_points(Pt), np.asarray(Pj))
    np.testing.assert_array_equal(E.to_jax_points(st), np.asarray(sj))


def test_mesh_needs_a_card_and_powers_of_two(monkeypatch):
    """No fallback: `make_mesh()` without a card raises; a mesh axis that
    is not a power of two raises, and so does a butterfly over 3 shards;
    the 2-D mesh lays shards out host-major, as `PartitionSpec((host,
    chip))` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SM.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SM.make_mesh_2d(2, 2)
    for d in (3, 6):
        with pytest.raises(ValueError, match="power of two"):
            SM.make_mesh(["cpu"] * d)
    with pytest.raises(ValueError, match="power of two"):
        SM.make_mesh_2d(3, 2, ["cpu"] * 6)
    with pytest.raises(ValueError, match="need 8 devices"):
        SM.make_mesh_2d(2, 4, ["cpu"] * 4)
    ctx = E.CurveCtx(config.BLS381)
    with pytest.raises(ValueError, match="power of two"):
        SM._allreduce_buckets([ctx.identity_like((4,), "cpu")] * 3, ctx)
    mesh = SM.make_mesh_2d(2, 4, CPU8)
    assert mesh.size == 8 and mesh.groups(SM.CHIP_AXIS) == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.groups(SM.HOST_AXIS) == [[0, 4], [1, 5], [2, 6], [3, 7]]
