"""Batched G1 group arithmetic in plain PyTorch: the port of
`bulletproofs_tpu/ops/ec_jax.py`, plus the mixed add of
`bulletproofs_tpu/ops/ec_pallas.py` (`_ec_madd_2d`).

Layout: a batch of points is ONE int64 tensor of shape (3, L, *batch):
projective (X : Y : Z) in Montgomery form, 16-bit limbs on axis 1, batch
trailing -- the JAX package's layout.  Identity is (0 : 1 : 0).

Group law: the branch-free COMPLETE projective addition of Renes-Costello-
Batina 2016 (algorithm 7 for a = 0, algorithm 1 for general a), the formulas
of `ops/ec_host.py`, so host, plain and kernel versions cross-check exactly.

These are the plain versions.  The MSM reaches them through the wrappers of
`ops/ec_kernels.py`, which launch the CUDA kernels for tensors on the card.
"""

import hashlib

import numpy as np
import torch

from ..config import CurveParams
from .ec_host import G1
from .field_host import Scalar
from .field import (FieldCtx, add_mod, from_mont, ints_to_limbs,
                    limbs_to_ints, mont_mul, mul_small, sub_mod)


class CurveCtx:
    """Constants for one curve's G1 (cached singleton per curve)."""

    _cache = {}

    def __new__(cls, cv: CurveParams):
        if cv.name in cls._cache:
            return cls._cache[cv.name]
        self = super().__new__(cls)
        cls._cache[cv.name] = self
        self.cv = cv
        self.fp = FieldCtx(cv.fp)
        self.fr = FieldCtx(cv.fr)
        self.b3 = 3 * cv.b
        self.a_is_zero = cv.a == 0
        # identity (0 : 1 : 0) in Montgomery form, shape (3, L, 1)
        self.identity = np.stack([self.fp.zero, self.fp.one_m, self.fp.zero])
        if not self.a_is_zero:
            # RCB16 algorithm 1 constants [a, a, a^2, a, 3b, 3b] (Montgomery)
            # multiplied against [xz, t2, t2, t0, t2, xz] in one 6-wide mul
            p = cv.p
            mont = lambda v: (v % p) * cv.fp.mont_r % p
            a_m, a2_m, b3_m = mont(cv.a), mont(cv.a * cv.a), mont(3 * cv.b)
            self.gen_consts = ints_to_limbs(
                [a_m, a_m, a2_m, a_m, b3_m, b3_m], self.fp.L).reshape(
                    self.fp.L, 6, 1)
        self._tensors = {}
        return self

    def identity_like(self, shape, device):
        """(3, L, *shape) batch of identities (a fresh tensor)."""
        key = str(device)
        if key not in self._tensors:
            self._tensors[key] = torch.as_tensor(self.identity, device=device)
        ident = self._tensors[key]
        return ident.reshape((3, self.fp.L) + (1,) * len(shape)).expand(
            (3, self.fp.L) + tuple(shape)).clone()


# ---------------------------------------------------------------------------
# Group law
# ---------------------------------------------------------------------------

def ec_add(P, Q, ctx: CurveCtx, mul=mont_mul):
    """Complete projective addition (RCB16), batched: P, Q (3, L, *batch).

    Independent field multiplies are stacked on an inner batch axis, as in
    the JAX function: two 6-wide Montgomery multiplies for a = 0.  `mul` is
    the Montgomery product (`field.mont_mul`, or `field.mont_mul_mxu`, which
    gives the same limbs: the plain version of kernel 5)."""
    f = ctx.fp
    b3 = ctx.b3
    X1, Y1, Z1 = P[0], P[1], P[2]
    X2, Y2, Z2 = Q[0], Q[1], Q[2]

    s1 = add_mod(torch.stack([X1, Y1, X1], dim=1),
                 torch.stack([Y1, Z1, Z1], dim=1), f)
    s2 = add_mod(torch.stack([X2, Y2, X2], dim=1),
                 torch.stack([Y2, Z2, Z2], dim=1), f)

    # t0 = X1X2, t1 = Y1Y2, t2 = Z1Z2 and the three sum products
    lhs = torch.cat([torch.stack([X1, Y1, Z1], dim=1), s1], dim=1)
    rhs = torch.cat([torch.stack([X2, Y2, Z2], dim=1), s2], dim=1)
    t = mul(lhs, rhs, f)
    t0, t1, t2 = t[:, 0], t[:, 1], t[:, 2]
    # xy = X1Y2+X2Y1, yz = Y1Z2+Y2Z1, xz = X1Z2+X2Z1
    d = sub_mod(sub_mod(t[:, 3:6], torch.stack([t0, t1, t0], dim=1), f),
                torch.stack([t1, t2, t2], dim=1), f)
    xy, yz, xz = d[:, 0], d[:, 1], d[:, 2]

    if not ctx.a_is_zero:
        return _ec_add_general_tail(t0, t1, t2, xy, yz, xz, ctx)

    b3_t2 = mul_small(t2, b3, f)
    m = sub_mod(t1, b3_t2, f)              # Y1Y2 - 3b Z1Z2
    n = add_mod(t1, b3_t2, f)              # Y1Y2 + 3b Z1Z2
    return _ec_add_a0_tail(xy, yz, xz, t0, m, n, ctx, mul)


def _ec_add_a0_tail(xy, yz, xz, t0, m, n, ctx, mul=mont_mul):
    """The shared end of RCB16 algorithms 7 and 8 (a = 0)."""
    f = ctx.fp
    b3 = ctx.b3
    # xy*m, yz*xz, n*m, t0*xz, yz*n, t0*xy: one stacked multiply
    u = mul(torch.stack([xy, yz, n, t0, yz, t0], dim=1),
                 torch.stack([m, xz, m, xz, n, xy], dim=1), f)
    w = mul_small(torch.stack([u[:, 1], u[:, 3]], dim=1), b3, f)
    v = mul_small(torch.stack([w[:, 1], u[:, 5]], dim=1), 3, f)
    X3 = sub_mod(u[:, 0], w[:, 0], f)      # xy*m - b3*yz*xz
    Y3 = add_mod(u[:, 2], v[:, 0], f)      # n*m + 3b3*t0*xz
    Z3 = add_mod(u[:, 4], v[:, 1], f)      # yz*n + 3*t0*xy
    return torch.stack([X3, Y3, Z3], dim=0)


def _ec_add_general_tail(t0, t1, t2, xy, yz, xz, ctx: CurveCtx):
    """RCB16 algorithm 1 tail (general a: ed25519's Weierstrass form).
    Plain PyTorch only: the CUDA kernels cover a = 0."""
    f = ctx.fp
    consts = torch.as_tensor(ctx.gen_consts, device=xz.device).reshape(
        (f.L, 6) + (1,) * (xz.ndim - 1))
    v = mont_mul(torch.stack([xz, t2, t2, t0, t2, xz], dim=1), consts, f)
    # v = [a*xz, a*t2, a^2*t2, a*t0, b3*t2, b3*xz]
    w = add_mod(v[:, 0], v[:, 4], f)                   # a*xz + b3*t2
    m = sub_mod(t1, w, f)
    n = add_mod(t1, w, f)
    u1 = add_mod(mul_small(t0, 3, f), v[:, 1], f)      # 3*t0 + a*t2
    u4 = add_mod(v[:, 5], sub_mod(v[:, 3], v[:, 2], f), f)
    u = mont_mul(torch.stack([xy, yz, m, u1, yz, xy], dim=1),
                 torch.stack([m, u4, n, u4, n, u1], dim=1), f)
    X3 = sub_mod(u[:, 0], u[:, 1], f)                  # xy*m - yz*u4
    Y3 = add_mod(u[:, 2], u[:, 3], f)                  # m*n + u1*u4
    Z3 = add_mod(u[:, 4], u[:, 5], f)                  # yz*n + xy*u1
    return torch.stack([X3, Y3, Z3], dim=0)


def ec_madd(P, Q, ctx: CurveCtx):
    """Complete MIXED addition (RCB16 algorithm 8, a = 0): P (3, L, *batch)
    projective plus Q (2, L, *batch) AFFINE (Z2 == 1 implicit), 11
    multiplies.  Complete for any projective P (the identity and P == Q
    included) and any affine on-curve Q.  Same math as
    `ec_pallas._ec_madd_2d`."""
    f = ctx.fp
    X1, Y1, Z1 = P[0], P[1], P[2]
    X2, Y2 = Q[0], Q[1]
    s = add_mod(torch.stack([X1, X2], dim=1), torch.stack([Y1, Y2], dim=1), f)
    # t0 = X1X2, t1 = Y1Y2, (X1+Y1)(X2+Y2), Y2Z1, X2Z1
    t = mont_mul(torch.stack([X1, Y1, s[:, 0], Y2, X2], dim=1),
                 torch.stack([X2, Y2, s[:, 1], Z1, Z1], dim=1), f)
    t0, t1 = t[:, 0], t[:, 1]
    xy = sub_mod(sub_mod(t[:, 2], t0, f), t1, f)
    e = add_mod(t[:, 3:5], torch.stack([Y1, X1], dim=1), f)
    yz, xz = e[:, 0], e[:, 1]
    b3_z1 = mul_small(Z1, ctx.b3, f)
    m = sub_mod(t1, b3_z1, f)
    n = add_mod(t1, b3_z1, f)
    return _ec_add_a0_tail(xy, yz, xz, t0, m, n, ctx)


def ec_double(P, ctx: CurveCtx):
    return ec_add(P, P, ctx)


# ---------------------------------------------------------------------------
# Host interop
# ---------------------------------------------------------------------------

def to_device_points(points, ctx: CurveCtx, device="cuda"):
    """list[G1] -> (3, L, n) Montgomery tensor on `device`."""
    coords = []
    for pt in points:
        coords.extend((pt.X, pt.Y, pt.Z))
    m = ctx.fp.to_mont(coords, device)                 # (L, 3n)
    return m.reshape(ctx.fp.L, len(points), 3).permute(2, 0, 1).contiguous()


def to_device_points_affine(points, ctx: CurveCtx, device="cuda"):
    """list[G1] -> ((3, L, n) Montgomery tensor, is_affine).

    Host-normalizes projective (Z != 1) points with one batched inversion so
    every row has Z == 1, the precondition of the mixed-add bucket kernel.
    A list holding the identity (no affine encoding) gives the plain
    projective conversion and is_affine False."""
    if any(pt.Z == 0 for pt in points):
        return to_device_points(points, ctx, device), False
    if all(pt.Z == 1 for pt in points):
        return to_device_points(points, ctx, device), True
    p = ctx.cv.p
    proj = [pt for pt in points if pt.Z != 1]
    n = len(proj)
    prefix = [1] * (n + 1)
    for i, pt in enumerate(proj):
        prefix[i + 1] = prefix[i] * pt.Z % p
    acc = pow(prefix[n], -1, p)
    zinv = [0] * n
    for i in range(n - 1, -1, -1):
        zinv[i] = prefix[i] * acc % p
        acc = acc * proj[i].Z % p
    norm = []
    j = 0
    for pt in points:
        if pt.Z == 1:
            norm.append(pt)
        else:
            norm.append(G1(pt.X * zinv[j] % p, pt.Y * zinv[j] % p, 1, pt.cv))
            j += 1
    return to_device_points(norm, ctx, device), True


def from_device_points(P, ctx: CurveCtx):
    """(3, L, n) Montgomery tensor -> list[G1] (projective, unreduced)."""
    L, n = P.shape[1], P.shape[2]
    flat = P.permute(1, 0, 2).reshape(L, 3 * n)
    ints = limbs_to_ints(from_mont(flat, ctx.fp))
    return [G1(ints[i], ints[n + i], ints[2 * n + i], ctx.cv)
            for i in range(n)]


def to_device_scalars(scalars, ctx: CurveCtx, device="cuda"):
    """list[Scalar | int] -> (Lr, n) plain-form limb tensor on `device`."""
    vals = [s.v if hasattr(s, "v") else int(s) % ctx.cv.r for s in scalars]
    return torch.as_tensor(ints_to_limbs(vals, ctx.fr.L), device=device)


def content_digest(points, ctx: CurveCtx):
    """Collision-resistant digest of a point vector's FULL projective
    content (curve, length, every X/Y/Z coordinate): the key of the
    point-table cache, so a table is never reused for different points
    (the JAX package's `ops/jax_backend.py: content_digest`)."""
    h = hashlib.blake2b(digest_size=16)
    nb = (ctx.cv.p.bit_length() + 7) // 8
    h.update(ctx.cv.name.encode())
    h.update(len(points).to_bytes(8, "little"))
    for p in points:
        h.update(p.X.to_bytes(nb, "little"))
        h.update(p.Y.to_bytes(nb, "little"))
        h.update(p.Z.to_bytes(nb, "little"))
    return h.digest()


# ---------------------------------------------------------------------------
# Objects and arrays of the JAX package <-> the port's
# ---------------------------------------------------------------------------

def from_jax_host(obj, cv: CurveParams):
    """The JAX package's host objects as the port's: a `G1` (read through
    X, Y, Z), a `Scalar` (v), an `InnerProductArgumentProof` (L, R, a, b)
    or a list or tuple of these.  Reads attributes only."""
    if isinstance(obj, (list, tuple)):
        return [from_jax_host(o, cv) for o in obj]
    if all(hasattr(obj, k) for k in ("L", "R", "a", "b")):
        from ..ipp import InnerProductArgumentProof
        return InnerProductArgumentProof(
            L=from_jax_host(obj.L, cv), R=from_jax_host(obj.R, cv),
            a=from_jax_host(obj.a, cv), b=from_jax_host(obj.b, cv))
    if all(hasattr(obj, k) for k in ("X", "Y", "Z")):
        return G1(obj.X, obj.Y, obj.Z, cv)
    if hasattr(obj, "v"):
        return Scalar(obj.v, cv)
    raise TypeError(f"from_jax_host: no port type for {type(obj).__name__}")


def from_jax_points(arr, device="cuda"):
    """JAX package point array (3, L, *batch) uint32 Montgomery limbs (as
    numpy) -> the port's int64 tensor on `device`."""
    return torch.as_tensor(np.asarray(arr).astype(np.int64), device=device)


# JAX package scalar limbs (Lr, n) uint32 convert the same way
from_jax_scalars = from_jax_points


def to_jax_points(t):
    """The port's (3, L, *batch) point or bucket tensor -> numpy uint32, the
    JAX package's layout."""
    return t.cpu().numpy().astype(np.uint32)
