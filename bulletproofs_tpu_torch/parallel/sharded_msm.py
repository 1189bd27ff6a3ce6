"""Sharded Pippenger MSM over a mesh of devices driven by one process: the
port of `bulletproofs_tpu/parallel/sharded_msm.py`.

The JAX package shards the point/scalar n-axis over a `jax.sharding.Mesh`
and runs one `shard_map` program: each chip's bucket pass, then a
butterfly of `ppermute` exchanges and complete EC adds (EC addition is not
an XLA psum), then the window/bucket combine replicated on every chip.
Here one Python process drives the same decomposition eagerly:

- a `Mesh` is a 1-D or 2-D grid of `torch.device`s, possibly repeated
  (four shards of one card, or eight of the CPU), with the JAX axis
  names; shard i of the n-axis lives on the i-th device of the grid in
  row-major order, as `PartitionSpec((host, chip))` lays it out;
- each shard's bucket pass is `ops/msm.py: bucket_accumulate` on that
  shard's device (the bucket kernels 1 or 2, kernel 3's folds), launched
  for every shard before anything is read back;
- `_allreduce_buckets` is the butterfly: step k moves partner i ^ k's
  packed buckets to shard i's device (`Tensor.to`, a peer copy between
  cards, a no-op on a repeated device) and adds them with kernel 3
  pairwise (`ec_add`); log2(d) steps of (3, NL, W, B) words, whatever n;
- the combine runs once, on the first shard's device: a single controller
  needs no replicated copy of it.

JAX name -> here:
  `make_mesh`, `make_mesh_2d`, `_pad_to_multiple`, `_allreduce_buckets`
      -> the same names (the butterfly takes the shards' bucket list);
  `msm_sharded` (shard_map body: digits, local bucket pass, butterfly,
      combine) -> `_shard_buckets` (one shard's pass) and the steps of
      `msm_sharded` below;
  `msm_sharded_jit` (pads, global round count, shard_map) -> `msm_sharded`;
  `msm_sharded_2d` (body) and `msm_sharded_2d_jit` -> `msm_sharded_2d`.

Shard tensors are never updated in place: on a repeated device an
exchange returns the very tensor of the partner shard.
"""

import contextlib

import numpy as np
import torch

from ..ops import field as fd
from ..ops import msm as msm_mod
from ..ops.ec_kernels import ec_add
from ..ops.field import unpack32

AXIS = "shard"
HOST_AXIS = "host"
CHIP_AXIS = "chip"


class Mesh:
    """A grid of devices with one name per axis.  `devices` is a numpy
    object array of `torch.device`s, which may repeat; every axis length
    is a power of two (the butterfly and the IPA's shard exchanges pair
    shard i with i ^ k)."""

    def __init__(self, devices, axis_names):
        if devices.ndim != len(axis_names) or devices.size == 0:
            raise ValueError(f"mesh: a {devices.shape} grid of devices for "
                             f"axes {axis_names}")
        for name, size in zip(axis_names, devices.shape):
            if size & (size - 1):
                raise ValueError(f"mesh axis {name!r} has {size} devices, "
                                 "not a power of two")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def size(self):
        return self.devices.size

    @property
    def flat(self):
        """The shards' devices in shard order (row-major)."""
        return list(self.devices.reshape(-1))

    def groups(self, axis):
        """The shard indices that reduce together over `axis`: one list per
        position on the other axes, in axis order."""
        a = self.axis_names.index(axis)
        idx = np.moveaxis(np.arange(self.size).reshape(self.devices.shape),
                          a, -1)
        return idx.reshape(-1, self.devices.shape[a]).tolist()


def _device_list(devices):
    """`devices` (names or `torch.device`s; default: every CUDA device,
    and none raises) as a 1-D object array of `torch.device`s."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(for example ['cpu'] * 8) for a mesh off "
                               "the card")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devices = [torch.device(d) for d in devices]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    return grid


def make_mesh(devices=None, axis=AXIS):
    """1-D mesh over `devices` (default: every CUDA device; raises when
    there is none).  A device may repeat: `make_mesh(["cuda:0"] * 4)` runs
    four shards, every exchange and pad included, on one card."""
    return Mesh(_device_list(devices), (axis,))


def make_mesh_2d(n_hosts, chips_per_host, devices=None):
    """2-D (host, chip) mesh, the multi-host topology of the JAX package:
    the first n_hosts * chips_per_host of `devices` (default: every CUDA
    device) in row-major order.  The reduction runs over the chip axis
    first, then over the host axis (`msm_sharded_2d`)."""
    grid = _device_list(devices)
    need = n_hosts * chips_per_host
    if len(grid) < need:
        raise ValueError(f"make_mesh_2d: need {need} devices, have "
                         f"{len(grid)}")
    return Mesh(grid[:need].reshape(n_hosts, chips_per_host),
                (HOST_AXIS, CHIP_AXIS))


def on_device(device):
    """Make `device` current for the block, so the kernels' wrappers launch
    on its stream (a no-op off the card)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _pad_to_multiple(points, scalars, ctx, d):
    """Pad the n axis of points (3, L, n) and scalars (..., n) with
    identity points and zero scalars to a multiple of d (zero scalars are
    never scheduled, so the padding costs no bucket work; an affine table
    stays fit for kernel 1: its identity rows are never read)."""
    n = scalars.shape[-1]
    if n % d == 0:
        return points, scalars
    pad = d - n % d
    points = torch.cat([points, ctx.identity_like((pad,), points.device)],
                       dim=2)
    scalars = torch.cat([scalars, scalars.new_zeros(scalars.shape[:-1]
                                                    + (pad,))], dim=-1)
    return points, scalars


def split_shards(x, mesh):
    """The mesh's shards of x's last axis (a multiple of the mesh size),
    each on its device."""
    ns = x.shape[-1] // mesh.size
    return [x[..., k * ns:(k + 1) * ns].to(dev, non_blocking=True)
            .contiguous() for k, dev in enumerate(mesh.flat)]


def _allreduce_buckets(buckets, ctx, root=None):
    """Butterfly all-reduce by complete EC adds over the shards of one mesh
    axis: buckets[i] (packed, on shard i's device) becomes the sum of all.
    Step k adds partner i ^ k's array to shard i's (kernel 3 pairwise),
    the order of the JAX package's `ppermute` + `ec_add`, so every shard's
    limbs equal its shard's there.  The number of shards must be a power
    of two.

    root: compute only the adds shard `root`'s sum depends on (step k:
    the shards i with (i ^ root) % 2k == 0, a tree of size - 1 adds in
    log2(size) steps) and return the list with only buckets[root] reduced.
    One controller that combines on one shard needs no other shard's sum,
    and that shard's limbs are the full butterfly's."""
    size = len(buckets)
    if size == 0 or size & (size - 1):
        raise ValueError(f"butterfly over {size} shards: the mesh axis "
                         "size must be a power of two")
    k = 1
    while k < size:
        nxt = list(buckets)
        for i, own in enumerate(buckets):
            if root is not None and (i ^ root) % (2 * k):
                continue
            with on_device(own.device):
                nxt[i] = ec_add(own, buckets[i ^ k].to(own.device,
                                                        non_blocking=True),
                                ctx)
        buckets = nxt
        k *= 2
    return buckets


def reduce_to_first(buckets, mesh, axes, ctx):
    """The sum of every shard's buckets on the first shard: the butterfly
    (`_allreduce_buckets` to each group's first shard) over each of
    `axes` in turn; the last axis reduces only the group holding shard 0.
    -> the first shard's reduced buckets."""
    buckets = list(buckets)
    for j, axis in enumerate(axes):
        for group in mesh.groups(axis):
            if j == len(axes) - 1 and group[0] != 0:
                continue
            buckets[group[0]] = _allreduce_buckets(
                [buckets[i] for i in group], ctx, root=0)[0]
    return buckets[0]


def _shard_buckets(points, scalars, ctx, c, n_rounds, affine=False):
    """One shard's bucket pass (the JAX shard_map body's local part):
    points (3, L, ns), scalars (Lr, ns) on one device -> its packed
    buckets (3, NL, W, B) under `window_plan(ctx, c)`, launched without a
    host synchronisation (`n_rounds` covers the shard's occupancy)."""
    with on_device(points.device):
        digits = fd.get_digits(scalars, c, msm_mod._n_windows(ctx, c))
        buckets, _ = msm_mod.bucket_accumulate(
            points, digits, ctx, c, n_rounds, plan=msm_mod.window_plan(ctx, c),
            affine=affine, sync=False)
    return buckets


def _global_rounds(scalar_shards, ctx, c):
    """The one round count of every shard: the largest
    `msm._max_occupancy` of the shards, read once, rounded up to 8."""
    occ = [msm_mod._max_occupancy(s, ctx, c) for s in scalar_shards]
    dev0 = occ[0].device
    rounds = int(torch.stack([o.to(dev0) for o in occ]).max())
    return (rounds + 7) // 8 * 8


def msm_sharded(points, scalars, ctx, c, mesh, affine=False):
    """points (3, L, n) Montgomery and scalars (Lr, n) plain, global (any
    device, any n: padded to the mesh size with identities and zeros) ->
    the MSM total (3, L, 1) on the first shard's device.

    The round count of every shard's bucket pass is one global number, the
    largest shard occupancy rounded up to 8, so imbalanced or degenerate
    shards raise the count for all and never drop points.  affine: the
    points have Z == 1 (the padding aside), so the passes run kernel 1.
    The buckets reduce over the mesh's last axis first (a 2-D mesh's chip
    axis, then its host axis)."""
    points, scalars = _pad_to_multiple(points, scalars, ctx, mesh.size)
    pts, scal = split_shards(points, mesh), split_shards(scalars, mesh)
    rounds = _global_rounds(scal, ctx, c)
    buckets = [_shard_buckets(p, s, ctx, c, rounds, affine)
               for p, s in zip(pts, scal)]
    b0 = reduce_to_first(buckets, mesh, mesh.axis_names[::-1], ctx)
    with on_device(b0.device):
        return unpack32(msm_mod.combine_buckets(b0, ctx, c), 1)


def msm_sharded_2d(points, scalars, ctx, c, mesh, affine=False):
    """`msm_sharded` on a (host, chip) mesh: n sharded over host x chip
    jointly, the buckets reduced over the chip axis first (within a host),
    then over the host axis, so the cross-host stage moves log2(hosts)
    bucket arrays a shard instead of log2(hosts * chips)."""
    if mesh.axis_names != (HOST_AXIS, CHIP_AXIS):
        raise ValueError(f"msm_sharded_2d needs a (host, chip) mesh, got "
                         f"{mesh.axis_names}")
    return msm_sharded(points, scalars, ctx, c, mesh, affine)
