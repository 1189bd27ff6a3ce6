"""Device inner-product argument prover with implicit basis folding: the
port of the IPA part of `bulletproofs_tpu/ops/prover_device.py`.

The reference folds the G/H bases every round (`ipp.rs:115-130`).  Here the
folded bases are never built: after j rounds the folded basis is
G'_i = sum_{k = i mod n_j} rG_k G_k, with rG_k a per-original-point running
product of challenges.  Each round's L and R commitments are then ONE
two-set MSM over the fixed table [G | H | Q | identity] with masked scalar
vectors, through the device Pippenger (`ops/msm.py: msm_hybrid`) and its
CUDA bucket kernels; the masked half of every vector is zero, so the
scheduler never adds it.  The Fiat-Shamir transcript stays on the host.

All scalar work is plain PyTorch on F_r limbs in Montgomery form
(`ops/field.py`), as the JAX package does it in XLA.  Values are canonical
at every step, so the port and the JAX package agree limb for limb and the
proofs are byte-identical.

`BP_PROFILE=1` (or `_prof.enabled = True`) accumulates the seconds of the
stages `ipa_scal`, `ipa_msm`, `ipa_transcript` and `ipa_final` in `_prof`
(read them with `_prof.take()`); on a card each timed stage synchronizes
before it reads the clock.
"""

import os
import time

import torch

from ..config import curve
from . import field as fd
from . import msm as msm_mod
from .ec import CurveCtx, content_digest, to_device_points_affine
from .field_host import Scalar


class _Prof:
    """Stage timers: seconds accumulated per label while `enabled`."""

    def __init__(self, enabled=False):
        self.enabled = enabled
        self.acc = {}

    def add(self, label, dt):
        self.acc[label] = self.acc.get(label, 0.0) + dt

    def take(self):
        """The accumulated seconds by label; clears them."""
        acc, self.acc = self.acc, {}
        return acc


_prof = _Prof(os.environ.get("BP_PROFILE", "") == "1")


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _timed:
    """`with _timed(label, device):` adds the block's seconds to `_prof`."""

    def __init__(self, label, device=None):
        self.label = label
        self.device = device

    def __enter__(self):
        if _prof.enabled:
            _sync(self.device)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if _prof.enabled:
            _sync(self.device)
            _prof.add(self.label, time.perf_counter() - self.t0)
        return False


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------

def _mont(fr, vals, device):
    """Host Scalars or ints -> (Lr, n) Montgomery tensor on `device`."""
    return fr.to_mont([v.v if hasattr(v, "v") else int(v) for v in vals],
                      device)


def _plain1(v, fr, device):
    """One host int -> (Lr, 1) plain-form limbs on `device`."""
    return torch.as_tensor(fd.ints_to_limbs([v], fr.L), device=device)


def _inner_mont(a, b, fr):
    """<a, b> over F_r along the last axis, Montgomery in and out: an
    elementwise product and a halving tree of modular adds."""
    prod = fd.mont_mul(a, b, fr)
    n = prod.shape[-1]
    while n > 1:
        half = (n + 1) // 2
        right = prod[..., half:n]
        if right.shape[-1] < half:
            right = torch.cat([right, right.new_zeros(
                right.shape[:-1] + (half - right.shape[-1],))], dim=-1)
        prod = fd.add_mod(prod[..., :half], right, fr)
        n = half
    return prod                                     # (Lr, ..., 1)


# ---------------------------------------------------------------------------
# Implicit-basis IPA rounds (ipp.rs:35-202, the same transcript)
# ---------------------------------------------------------------------------

def _swap_halves(A, n_j):
    """(Lr, n): exchange the two halves of every contiguous n_j block."""
    Lr, n = A.shape
    return A.reshape(Lr, n // n_j, 2, n_j // 2).flip(2).reshape(Lr, n)


def _upper_half(n, n_j, device):
    """(n,) bool: True on the upper half of every n_j block."""
    return (torch.arange(n, device=device) % n_j) >= n_j // 2


def _ipa_round_scalars(A, B, rG, rH, n_j, fr):
    """The round's L and R scalar sets over the table [G | H | Q | identity]:
    plain-form (2, Lr, 2n+2), the last two lanes [c, 0] of each set (c_L
    for L, c_R for R).  A, B, rG, rH: (Lr, n) Montgomery."""
    Lr, n = A.shape
    half = n_j // 2
    upper = _upper_half(n, n_j, A.device)

    # c_L = <a_lo, b_hi>, c_R = <a_hi, b_lo> of the first n_j block
    c = _inner_mont(torch.stack([A[:, :half], A[:, half:n_j]], dim=1),
                    torch.stack([B[:, half:n_j], B[:, :half]], dim=1),
                    fr)                             # (Lr, 2, 1)
    prod = fd.mont_mul(torch.stack([_swap_halves(A, n_j),
                                    _swap_halves(B, n_j)], dim=1),
                       torch.stack([rG, rH], dim=1), fr)   # (Lr, 2, n)
    prodG, prodH = prod[:, 0], prod[:, 1]
    zero = A.new_zeros((Lr, 1))
    L_scal = torch.cat([torch.where(upper, prodG, 0),
                        torch.where(upper, 0, prodH), c[:, 0], zero], dim=-1)
    R_scal = torch.cat([torch.where(upper, 0, prodG),
                        torch.where(upper, prodH, 0), c[:, 1], zero], dim=-1)
    both = fd.from_mont(torch.stack([L_scal, R_scal], dim=1), fr)
    return both.permute(1, 0, 2).contiguous()       # (2, Lr, 2n+2)


def _ipa_round_update(A, B, rG, rH, u_m, u_inv_m, n_j, fr):
    """Fold a, b with the challenge u (Montgomery (Lr, 1)) over blocks of
    n_j, and multiply the running factors rG, rH by u or u^-1; rG and rH
    may be None (the last fold).  Returns (A, B, rG, rH)."""
    n = A.shape[1]
    upper = _upper_half(n, n_j, A.device)
    swapA = _swap_halves(A, n_j)
    swapB = _swap_halves(B, n_j)
    u = u_m.expand(A.shape)
    u_inv = u_inv_m.expand(A.shape)
    lhs = [torch.where(upper, swapA, A), torch.where(upper, A, swapA),
           torch.where(upper, swapB, B), torch.where(upper, B, swapB)]
    rhs = [u, u_inv, u_inv, u]
    if rG is not None:
        lhs += [rG, rH]
        rhs += [torch.where(upper, u, u_inv), torch.where(upper, u_inv, u)]
    t = fd.mont_mul(torch.stack(lhs, dim=1), torch.stack(rhs, dim=1), fr)
    A2 = fd.add_mod(t[:, 0], t[:, 1], fr)     # lo*u + hi*u^-1
    B2 = fd.add_mod(t[:, 2], t[:, 3], fr)     # lo*u^-1 + hi*u
    if rG is None:
        return A2, B2, None, None
    return A2, B2, t[:, 4], t[:, 5]


def _ipa_round_step(A, B, rG, rH, u_p, u_inv_p, n_j, fr):
    """Apply round j's fold (blocks of 2*n_j), then build round j+1's L/R
    scalar sets.  u_p, u_inv_p: the previous challenge and its inverse as
    plain (Lr, 1) limbs.  Returns (scalars, A, B, rG, rH)."""
    u_m = fd.to_mont(u_p, fr)
    u_inv_m = fd.to_mont(u_inv_p, fr)
    A, B, rG, rH = _ipa_round_update(A, B, rG, rH, u_m, u_inv_m,
                                     2 * n_j, fr)
    return _ipa_round_scalars(A, B, rG, rH, n_j, fr), A, B, rG, rH


def _ipa_final_step(A, B, u_p, u_inv_p, fr):
    """Apply the last round's fold (blocks of 2) and return a, b as plain
    (Lr, 1) limbs."""
    A, B, _, _ = _ipa_round_update(A, B, None, None, fd.to_mont(u_p, fr),
                                   fd.to_mont(u_inv_p, fr), 2, fr)
    return fd.from_mont(A[:, :1], fr), fd.from_mont(B[:, :1], fr)


def _create_ipp_per_round(transcript, Gf_m, Hf_m, pts_dev, A, B, ctx,
                          window=None, affine=False, ec_kernel="chunk"):
    """The IPA prover, one MSM and one host transcript step per round.

    pts_dev: (3, L, 2n+2) table [G | H | Q | identity] (Montgomery); Gf_m,
    Hf_m: (Lr, n) Montgomery G/H factors (the reference's first-round
    fold-in becomes the running factors' start); A, B: (Lr, n) Montgomery
    a and b.  window: the MSM's c (default `pick_window(2n + 2)`);
    ec_kernel: the bucket pass's form (`msm.bucket_accumulate`).
    Returns (L_vec, R_vec, a, b)."""
    fr = ctx.fr
    dev = A.device
    n = A.shape[-1]
    lg_n = n.bit_length() - 1
    if (1 << lg_n) != n:
        raise ValueError(f"IPA length {n} is not a power of two")
    transcript.innerproduct_domain_sep(n)

    c = window or msm_mod.pick_window(2 * n + 2)
    rG, rH = Gf_m, Hf_m
    L_vec, R_vec = [], []
    u_p = u_inv_p = None          # previous challenge, plain limbs
    n_j = n
    while n_j != 1:
        with _timed("ipa_scal", dev):
            if u_p is None:       # first round: no pending fold
                scal2 = _ipa_round_scalars(A, B, rG, rH, n_j, fr)
            else:                 # fold round j-1, build round j
                scal2, A, B, rG, rH = _ipa_round_step(
                    A, B, rG, rH, u_p, u_inv_p, n_j, fr)
        with _timed("ipa_msm", dev):
            # each set has <= n+1 non-zero scalars (the masked half is 0)
            L, R = msm_mod.msm_hybrid(pts_dev, scal2, ctx, c, n_eff=n + 1,
                                      affine=affine, ec_kernel=ec_kernel)
        with _timed("ipa_transcript", dev):
            transcript.commit_point(b"L", L)
            transcript.commit_point(b"R", R)
            L_vec.append(L)
            R_vec.append(R)
            u = transcript.challenge_scalar(b"u")
            u_p = _plain1(u.v, fr, dev)
            u_inv_p = _plain1(u.inverse().v, fr, dev)
        n_j //= 2

    if u_p is None:               # n == 1: no rounds, nothing to fold
        a_p, b_p = fd.from_mont(A[:, :1], fr), fd.from_mont(B[:, :1], fr)
    else:
        with _timed("ipa_final", dev):
            a_p, b_p = _ipa_final_step(A, B, u_p, u_inv_p, fr)
    a = Scalar(fd.limbs_to_ints(a_p)[0], ctx.cv)
    b = Scalar(fd.limbs_to_ints(b_p)[0], ctx.cv)
    return L_vec, R_vec, a, b


def create_ipp_device(transcript, Q, G_factors, H_factors, G_vec, H_vec,
                      a_vec, b_vec, device="cuda", ec_kernel="chunk"):
    """Host lists in, (L_vec, R_vec, a, b) out: the implicit-basis IPA on
    `device`, with the transcript schedule of `ipp.rs:35-202`."""
    ctx = CurveCtx(curve())
    fr = ctx.fr
    Gd, affG = _pts_cache.get(G_vec, ctx, device)
    Hd, affH = _pts_cache.get(H_vec, ctx, device)
    Qd, affQ = to_device_points_affine([Q], ctx, device)
    # the identity column's scalars are always zero, so the scheduler never
    # adds it: the table stays fit for the mixed-add kernel
    pts = torch.cat([Gd, Hd, Qd, ctx.identity_like((1,), device)], dim=2)
    return _create_ipp_per_round(
        transcript, _mont(fr, G_factors, device),
        _mont(fr, H_factors, device), pts, _mont(fr, a_vec, device),
        _mont(fr, b_vec, device), ctx, affine=affG and affH and affQ,
        ec_kernel=ec_kernel)


class _PtsCache:
    """Converted point tables on the device, keyed by the full content of
    the points (`ec.content_digest`) and the device, so a table is never
    reused for other points."""

    def __init__(self, max_entries=8):
        self.entries = {}
        self.max = max_entries

    def get(self, points, ctx, device):
        """(3, L, n) Montgomery tensor on `device` and whether it is affine
        (fit for the mixed-add bucket kernel)."""
        key = (content_digest(points, ctx), str(torch.device(device)))
        hit = self.entries.get(key)
        if hit is None:
            if len(self.entries) >= self.max:
                self.entries.clear()
            hit = self.entries[key] = to_device_points_affine(
                list(points), ctx, device)
        return hit


_pts_cache = _PtsCache()
