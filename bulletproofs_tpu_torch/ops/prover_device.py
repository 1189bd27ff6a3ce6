"""Device provers: the port of `bulletproofs_tpu/ops/prover_device.py`,
the R1CS prover `prove_device` and the inner-product argument it ends in.

R1CS (`prover.rs:322-593`).  The host keeps circuit construction, the
Fiat-Shamir transcript, the rng draws and the few single-point Pedersen
commitments (host ladders on the port's `G1`, where the JAX package calls
its native library).  The O(n) work runs on the device: the witness
commitments (masked tree sums through kernel 3 for bit-structured
witnesses, else the device Pippenger `ops/msm.py: msm_hybrid`), the z-fold
of the constraint rows as a gather and a tree sum, the l(x), r(x) and
t(x) vector polynomials, and the IPA.

IPA.  The reference folds the G/H bases every round (`ipp.rs:115-130`).
Here the folded bases are never built: after j rounds the folded basis is
G'_i = sum_{k = i mod n_j} rG_k G_k, with rG_k a per-original-point running
product of challenges.  Each round's L and R commitments are then ONE
two-set MSM over the fixed table [G | H | Q | identity] with masked scalar
vectors, through the device Pippenger and its CUDA bucket kernels; the
masked half of every vector is zero, so the scheduler never adds it.

On a card the IPA runs fused by default (`create_ipp_implicit`): every
round on the device with no host synchronisation, the Fiat-Shamir step of
each round in one launch of `bp_ipa_challenge`
(`ops/transcript_kernels.py`), the transcript's state uploaded once and
the proof fetched once (`create_ipp_implicit_fused`).  `fused=False`, the
default on the CPU, and Edwards-serialized curves run one MSM
(`msm_hybrid`, its Horner on the host) and one host transcript step a
round (`_create_ipp_per_round`).  Both give the same bytes.

All scalar work is plain PyTorch on F_r limbs in Montgomery form
(`ops/field.py`), as the JAX package does it in XLA.  Values are canonical
at every step, so the port and the JAX package agree limb for limb and the
proofs are byte-identical.

`BP_PROFILE=1` (or `_prof.enabled = True`) accumulates the seconds of the
stages (`phase1_convert`, `phase1_msm`, `zfold`, `tpoly`, `t_commits`;
the fused IPA's `ipa_fused_kernel` (its launches) and `ipa_fused_fetch`;
the per-round IPA's `ipa_scal`, `ipa_msm`, `ipa_transcript`, `ipa_final`)
in `_prof` (read them with `_prof.take()`); a stage nested in another is
counted in its own label only, and on a card each timed stage
synchronizes before it reads the clock.
"""

import os
import time

import numpy as np
import torch

from ..config import curve
from . import field as fd
from . import msm as msm_mod
from .ec import (CurveCtx, content_digest, from_device_points,
                 to_device_points_affine, to_device_scalars)
from .ec_host import G1
from .ec_kernels import affine_rows32, ec_add
from .field import pack32, unpack32
from .field_host import Scalar
from .transcript_device import DeviceTranscript, replay_positions
from .transcript_kernels import ipa_challenge, round_registers, \
    round_schedule


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
    """`with _timed(label, device):` adds the block's seconds to `_prof`,
    less the seconds of the stages timed inside it."""

    _open = []                    # the enclosing timed blocks, innermost last

    def __init__(self, label, device=None):
        self.label = label
        self.device = device

    def __enter__(self):
        if _prof.enabled:
            _sync(self.device)
            self.inner = 0.0
            self._open.append(self)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if _prof.enabled:
            _sync(self.device)
            dt = time.perf_counter() - self.t0
            self._open.pop()
            if self._open:
                self._open[-1].inner += dt
            _prof.add(self.label, dt - self.inner)
        return False


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------

def _mont(fr, vals, device):
    """Host Scalars or ints -> (Lr, n) Montgomery tensor on `device`."""
    return fr.to_mont([v.v if hasattr(v, "v") else int(v) for v in vals],
                      device)


def _inner_mont(a, b, fr):
    """<a, b> over F_r along the last axis, Montgomery in and out: an
    elementwise product and a halving tree of modular adds."""
    return _tree_sum(fd.mont_mul(a, b, fr), fr)


def _tree_sum(prod, fr):
    """The sum over F_r along the last axis by a halving tree of modular
    adds: (Lr, ..., m) -> (Lr, ..., 1)."""
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

    # c_L = <a_lo, b_hi>, c_R = <a_hi, b_lo> of the first n_j block
    c = _inner_mont(torch.stack([A[:, :half], A[:, half:n_j]], dim=1),
                    torch.stack([B[:, half:n_j], B[:, :half]], dim=1),
                    fr)                             # (Lr, 2, 1)
    zero = A.new_zeros((Lr, 1))
    L_scal, R_scal = _lr_sets(_swap_halves(A, n_j), _swap_halves(B, n_j),
                              rG, rH, _upper_half(n, n_j, A.device), fr,
                              (c[:, 0], zero), (c[:, 1], zero))
    both = fd.from_mont(torch.stack([L_scal, R_scal], dim=1), fr)
    return both.permute(1, 0, 2).contiguous()       # (2, Lr, 2n+2)


def _lr_sets(swapA, swapB, rG, rH, upper, fr, L_tail=(), R_tail=()):
    """A round's L and R scalar sets over [G | H | tail], Montgomery
    (Lr, 2m + tail): G takes swap(a) * rG on the upper half of each block
    for L and on the lower for R, H takes swap(b) * rH on the other half.
    swapA, swapB, rG, rH: (Lr, m) Montgomery; upper: (m,) bool; the tails
    are (Lr, k) lanes appended to each set."""
    prod = fd.mont_mul(torch.stack([swapA, swapB], dim=1),
                       torch.stack([rG, rH], dim=1), fr)   # (Lr, 2, m)
    prodG, prodH = prod[:, 0], prod[:, 1]
    return (torch.cat([torch.where(upper, prodG, 0),
                       torch.where(upper, 0, prodH), *L_tail], dim=-1),
            torch.cat([torch.where(upper, 0, prodG),
                       torch.where(upper, prodH, 0), *R_tail], dim=-1))


def _ipa_round_update(A, B, rG, rH, u_m, u_inv_m, n_j, fr):
    """Fold a, b with the challenge u (Montgomery (Lr, 1)) over blocks of
    n_j, and multiply the running factors rG, rH by u or u^-1; rG and rH
    may be None (the last fold).  Returns (A, B, rG, rH)."""
    return _fold(A, B, _swap_halves(A, n_j), _swap_halves(B, n_j), rG, rH,
                 _upper_half(A.shape[1], n_j, A.device), u_m, u_inv_m, fr)


def _fold(A, B, swapA, swapB, rG, rH, upper, u_m, u_inv_m, fr):
    """`_ipa_round_update` given the halves' partners swapA, swapB (each
    entry's counterpart in the other half of its block) and the (m,) mask
    `upper` of the blocks' upper halves."""
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
                          window=None, affine=False, ec_kernel="chunk",
                          table32=None):
    """The IPA prover, one MSM and one host transcript step per round.

    pts_dev: (3, L, 2n+2) table [G | H | Q | identity] (Montgomery); Gf_m,
    Hf_m: (Lr, n) Montgomery G/H factors (the reference's first-round
    fold-in becomes the running factors' start); A, B: (Lr, n) Montgomery
    a and b.  window: the MSM's c (default `pick_window(2n + 2)`);
    ec_kernel: the bucket pass's form (`msm.bucket_accumulate`);
    table32: the packed table (`_ipa_table`), shared by the rounds.
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
                                      affine=affine, ec_kernel=ec_kernel,
                                      table32=table32)
        with _timed("ipa_transcript", dev):
            transcript.commit_point(b"L", L)
            transcript.commit_point(b"R", R)
            L_vec.append(L)
            R_vec.append(R)
            u = transcript.challenge_scalar(b"u")
            u_p = to_device_scalars([u], ctx, dev)
            u_inv_p = to_device_scalars([u.inverse()], ctx, dev)
        n_j //= 2

    if u_p is None:               # n == 1: no rounds, nothing to fold
        a_p, b_p = fd.from_mont(A[:, :1], fr), fd.from_mont(B[:, :1], fr)
    else:
        with _timed("ipa_final", dev):
            a_p, b_p = _ipa_final_step(A, B, u_p, u_inv_p, fr)
    a = Scalar(fd.limbs_to_ints(a_p)[0], ctx.cv)
    b = Scalar(fd.limbs_to_ints(b_p)[0], ctx.cv)
    return L_vec, R_vec, a, b


# (n, c, curve) -> the (rounds, pre) the fused IPA last settled on, where
# the next fused IPA of that shape starts
_fused_memo = {}


def _ipa_fused_rounds(state, pts_dev, A, B, rG, rH, ctx, c, rounds, pre,
                      regs, affine=False, ec_kernel="chunk", table32=None):
    """Launch every round of the IPA on the device, with no host
    synchronisation: per round the L and R scalar sets
    (`_ipa_round_scalars`), their two-set MSM (`msm.msm_sets_device` at
    (rounds, pre)), the round's Fiat-Shamir step (`ipa_challenge`: the
    point bytes, the new transcript state, u and u^-1) and the fold
    (`_ipa_round_update`).  state: the transcript's (200,) int64 state on
    the device; regs: (the first round's STROBE registers, every later
    round's).  Returns ONE int64 tensor on the device, [L/R bytes
    (lg n, 2, 2*mb + 1) | a (Lr) | b (Lr) plain limbs | final state (200) |
    the largest occupancy of the rounds (1)], so the caller fetches once."""
    fr = ctx.fr
    lr, u = [], None
    occ_max = torch.zeros((), dtype=torch.int64, device=A.device)
    n_j = A.shape[-1]
    while n_j != 1:
        if u is not None:         # fold round j-1 (blocks of 2 n_j)
            A, B, rG, rH = _ipa_round_update(A, B, rG, rH, u[0], u[1],
                                             2 * n_j, fr)
        scal2 = _ipa_round_scalars(A, B, rG, rH, n_j, fr)
        LR, occ = msm_mod.msm_sets_device(pts_dev, scal2, ctx, c, rounds,
                                          pre, affine, ec_kernel, table32)
        pb, state, u = ipa_challenge(LR, state, regs[1 if lr else 0], ctx)
        lr.append(pb.reshape(-1))
        occ_max = torch.maximum(occ_max, occ)
        n_j //= 2
    if u is not None:
        A, B, _, _ = _ipa_round_update(A, B, None, None, u[0], u[1], 2, fr)
    ab = fd.from_mont(torch.cat([A[:, :1], B[:, :1]], dim=1), fr)
    return torch.cat(lr + [ab.T.reshape(-1), state, occ_max.reshape(1)])


def create_ipp_implicit_fused(transcript, Gf_m, Hf_m, pts_dev, A, B, ctx,
                              window=None, affine=False, ec_kernel="chunk",
                              table32=None):
    """The fused IPA prover: the operands and results of
    `_create_ipp_per_round`, the same proof bytes and the same transcript
    continuation, with one upload of the transcript's state, the rounds'
    launches and one fetch (`_ipa_fused_rounds`).

    The STROBE registers of every round depend on the schedule only:
    round 1 starts at the host transcript's, and every later round at the
    registers round 1 ends on (a round ends on its challenge squeeze), which
    one dry replay checks here.  The bucket passes run at the (rounds, pre)
    of `_fused_memo`; when the fetched occupancy exceeds the rounds, the
    whole IPA runs again from the same state at the escalated shape
    (`msm._escalate`): nothing has been absorbed on the host.  The L and R
    points are decoded from the fetched bytes by `G1.from_bytes`, which
    checks each against the curve, and the host transcript takes the final
    state (`DeviceTranscript.writeback`)."""
    fr = ctx.fr
    dev = A.device
    n = A.shape[-1]
    lg_n = n.bit_length() - 1
    if (1 << lg_n) != n:
        raise ValueError(f"IPA length {n} is not a power of two")
    mb = ctx.cv.modbytes
    PB = 2 * mb + 1
    transcript.innerproduct_domain_sep(n)
    snap, *regs0 = DeviceTranscript.snapshot(transcript)
    regs1 = round_registers(regs0, ctx)
    if round_registers(regs1, ctx) != regs1:
        raise RuntimeError("fused IPA: the round's transcript schedule does "
                           f"not return to its registers {regs1}")
    c = window or msm_mod.pick_window(2 * n + 2)
    key = (n, c, ctx.cv.name)
    rounds, pre = _fused_memo.get(
        key, (msm_mod.occupancy_guess(n + 1, ctx, c), 0))
    if table32 is None and pre == 0:
        table32 = msm_mod.point_table(pts_dev, ctx, affine, ec_kernel)
    state = torch.as_tensor(snap, device=dev)
    while True:
        with _timed("ipa_fused_kernel", dev):
            out = _ipa_fused_rounds(state, pts_dev, A, B, Gf_m, Hf_m, ctx,
                                    c, rounds, pre, (regs0, regs1), affine,
                                    ec_kernel, table32)
        with _timed("ipa_fused_fetch", dev):
            host = out.cpu().numpy()
        occ = int(host[-1])
        if occ <= rounds:
            break
        rounds, pre = msm_mod._escalate(occ, rounds, pre)
    _fused_memo[key] = (rounds, pre)

    lr = host[:lg_n * 2 * PB].reshape(lg_n, 2, PB).astype(np.uint8)
    ab = fd.limbs_to_ints(host[lg_n * 2 * PB:-201].reshape(2, fr.L).T)
    vecs = ([], [])
    for j in range(lg_n):
        for side in (0, 1):
            raw = lr[j, side].tobytes()
            try:
                vecs[side].append(G1.from_bytes(raw, ctx.cv))
            except AssertionError as e:
                raise RuntimeError(
                    f"fused IPA: bad {'LR'[side]} bytes at round {j} of "
                    f"{lg_n} (n = {n}, c = {c}, rounds = {rounds}, pre = "
                    f"{pre}): {raw[:24].hex()}...: {e}") from None
    sched = round_schedule(ctx) * lg_n
    DeviceTranscript.writeback(transcript, host[-201:-1],
                               *replay_positions(transcript, sched))
    return (vecs[0], vecs[1], Scalar(ab[0], ctx.cv),
            Scalar(ab[1], ctx.cv))


def create_ipp_implicit(transcript, Gf_m, Hf_m, pts_dev, A, B, ctx,
                        window=None, affine=False, ec_kernel="chunk",
                        table32=None, fused=None):
    """The device IPA prover with implicit basis folding.

    pts_dev: (3, L, 2n+2) table [G | H | Q | identity] (Montgomery); Gf_m,
    Hf_m: (Lr, n) Montgomery G/H factors; A, B: (Lr, n) Montgomery a and
    b; window, ec_kernel, table32: as `_create_ipp_per_round`.  Returns
    (L_vec, R_vec, a, b).

    fused=True runs every round and the Fiat-Shamir transcript on the
    device (`create_ipp_implicit_fused`); fused=False runs one MSM and one
    host transcript step a round (`_create_ipp_per_round`).  The two give
    the same bytes.  The default, None, is fused on a card and per round
    on the CPU, where there is no host synchronisation to save and the
    plain versions of the fused path's kernels cost ~5x the host's Horner
    and transcript.  Edwards-serialized curves (ed25519) always take the
    per-round path: their transcripts absorb Edwards coordinates, which
    the device serializer does not emit.  A failing fused IPA raises."""
    kw = dict(window=window, affine=affine, ec_kernel=ec_kernel,
              table32=table32)
    if fused is None:
        fused = A.device.type == "cuda"
    if ctx.cv.ed_d is None and fused:
        return create_ipp_implicit_fused(transcript, Gf_m, Hf_m, pts_dev,
                                         A, B, ctx, **kw)
    return _create_ipp_per_round(transcript, Gf_m, Hf_m, pts_dev, A, B, ctx,
                                 **kw)


def create_ipp_device(transcript, Q, G_factors, H_factors, G_vec, H_vec,
                      a_vec, b_vec, device="cuda", ec_kernel="chunk",
                      fused=None):
    """Host lists in, (L_vec, R_vec, a, b) out: the implicit-basis IPA on
    `device` (`create_ipp_implicit`, fused by default on a card), with the
    transcript schedule of `ipp.rs:35-202`."""
    ctx = CurveCtx(curve())
    fr = ctx.fr
    pts, affine, table32 = _ipa_table(G_vec, H_vec, Q, ctx, device,
                                      ec_kernel)
    return create_ipp_implicit(
        transcript, _mont(fr, G_factors, device),
        _mont(fr, H_factors, device), pts, _mont(fr, a_vec, device),
        _mont(fr, b_vec, device), ctx, affine=affine, ec_kernel=ec_kernel,
        table32=table32, fused=fused)


def _ipa_table(G_vec, H_vec, Q, ctx, device, ec_kernel="chunk"):
    """The IPA's MSM table [G | H | Q | identity] on `device`: (points
    (3, L, 2n+2), whether affine, and the packed table its bucket passes
    read, made once a proof (`msm.point_table`)), the G and H parts from
    `_pts_cache`.  Kernel 1's affine table concatenates the cached packed
    rows; its identity row is zeros, never read: the identity column's
    scalars are always zero, so the scheduler never adds it, and the table
    stays fit for the mixed-add kernel."""
    Gd, affG, G32 = _pts_cache.get(G_vec, ctx, device)
    Hd, affH, H32 = _pts_cache.get(H_vec, ctx, device)
    Qd, affQ = to_device_points_affine([Q], ctx, device)
    pts = torch.cat([Gd, Hd, Qd, ctx.identity_like((1,), device)], dim=2)
    affine = affG and affH and affQ
    if not msm_mod.uses_mixed(ctx, affine, 0, ec_kernel):
        return pts, affine, msm_mod.point_table(pts, ctx, affine, ec_kernel)
    table32 = torch.cat([G32, H32, affine_rows32(Qd),
                         torch.zeros_like(G32[:1])], dim=0)
    return pts, True, table32


class _PtsCache:
    """Converted point tables on the device, keyed by the full content of
    the points (`ec.content_digest`) and the device, so a table is never
    reused for other points."""

    def __init__(self, max_entries=8):
        self.entries = {}
        self.max = max_entries

    def get(self, points, ctx, device):
        """(3, L, n) Montgomery tensor on `device`, whether it is affine
        (fit for the mixed-add bucket kernel), and then its kernel-1 rows
        packed (`affine_rows32`, made once per entry), else None."""
        key = (content_digest(points, ctx), str(torch.device(device)))
        hit = self.entries.get(key)
        if hit is None:
            if len(self.entries) >= self.max:
                self.entries.clear()
            pts, affine = to_device_points_affine(list(points), ctx, device)
            hit = self.entries[key] = (
                pts, affine, affine_rows32(pts) if affine else None)
        return hit


_pts_cache = _PtsCache()


# ---------------------------------------------------------------------------
# R1CS: powers, z-fold, vector polynomials (prover.rs:142-184, 458-488)
# ---------------------------------------------------------------------------

def _pow_table(x_m, q, fr):
    """x (Lr, 1) Montgomery -> (Lr, q) powers [x^1, x^2, ..., x^q]: log2(q)
    full-width passes, the power-of-two squarings of x combined per index
    bit."""
    n_bits = max(1, (q - 1).bit_length())
    out = x_m.expand(fr.L, q)
    iota = torch.arange(q, device=x_m.device)
    sq = x_m
    for k in range(n_bits):
        out = torch.where(((iota >> k) & 1) == 1, fd.mont_mul(out, sq, fr),
                          out)
        if k + 1 < n_bits:
            sq = fd.mont_mul(sq, sq, fr)
    return out


def _pow_shifted(x_m, n, fr):
    """[1, x, x^2, ..., x^{n-1}] (Lr, n) from x (Lr, 1) Montgomery."""
    one = fr.on("one_m", x_m.device)
    if n == 1:
        return one
    return torch.cat([one, _pow_table(x_m, n - 1, fr)], dim=-1)


def build_zfold_tables(constraints, n, m, include_one=False):
    """Host bookkeeping for the z-fold: per variable, its constraint rows
    and coefficients as a dense (width, T) table, T the most terms of one
    variable.  Returns {kind: (rows int64 (width, T), valid bool (width, T),
    coeffs (width*T ints), T, width)}, width n for the multiplier kinds, m
    for COMMITTED and 1 for ONE (include_one: the verifier's constant term,
    `verifier.rs:149-193`; the prover skips it)."""
    from ..r1cs.linear_combination import (COMMITTED, MULT_LEFT,
                                           MULT_OUTPUT, MULT_RIGHT, ONE)
    per = {MULT_LEFT: [[] for _ in range(n)],
           MULT_RIGHT: [[] for _ in range(n)],
           MULT_OUTPUT: [[] for _ in range(n)],
           COMMITTED: [[] for _ in range(m)]}
    if include_one:
        per[ONE] = [[]]
    for q_i, lc in enumerate(constraints):
        for var, coeff in lc.terms:
            table = per.get(var.kind)
            if table is not None:
                table[0 if var.kind == ONE else var.index].append(
                    (q_i, coeff))
    out = {}
    for kind, table in per.items():
        T = max(1, max((len(t) for t in table), default=1))
        width = len(table)
        rows = np.zeros((width, T), dtype=np.int64)
        valid = np.zeros((width, T), dtype=bool)
        coeffs = []
        for v_i, terms in enumerate(table):
            for t_i, (q_i, c) in enumerate(terms):
                rows[v_i, t_i] = q_i
                valid[v_i, t_i] = True
                coeffs.append(c)
            coeffs.extend([0] * (T - len(terms)))
        out[kind] = (rows, valid, coeffs, T, width)
    return out


def _zfold_kernel(zpow_rows, rows, valid, coeff_m, fr, T, width):
    """w[v] = sum_t z^(rows[v, t] + 1) * coeff[v, t] over the valid terms:
    zpow_rows (q, Lr) Montgomery z^1..z^q, rows/valid (width, T), coeff_m
    (Lr, width*T) Montgomery -> (Lr, width) Montgomery."""
    zp = zpow_rows[rows.reshape(-1)].transpose(0, 1)       # (Lr, width*T)
    prod = fd.mont_mul(zp, coeff_m, fr).reshape(fr.L, width, T)
    prod = torch.where(valid[None], prod, 0)
    t = T
    while t > 1:                       # tree sum over the (tiny) T axis
        half = (t + 1) // 2
        right = prod[..., half:t]
        if right.shape[-1] < half:
            right = torch.cat([right, right.new_zeros(
                right.shape[:-1] + (half - right.shape[-1],))], dim=-1)
        prod = fd.add_mod(prod[..., :half], right, fr)
        t = half
    return prod[..., 0]


def zfold_device(tables, z, q, fr, padded_n, device):
    """The z-fold of the constraint rows (`prover.rs:142-184`) on `device`:
    -> wL, wR, wO (Lr, padded_n) and wV (Lr, m) Montgomery, V terms
    negated, and wc (Lr, 1), the negated constant term, or None when the
    tables have no ONE kind."""
    from ..r1cs.linear_combination import (COMMITTED, MULT_LEFT,
                                           MULT_OUTPUT, MULT_RIGHT, ONE)
    zpow_rows = _pow_table(_mont(fr, [z], device), max(q, 1),
                           fr).transpose(0, 1)              # (q, Lr)
    outs = {}
    for kind, (rows, valid, coeffs, T, width) in tables.items():
        outs[kind] = _zfold_kernel(
            zpow_rows, torch.as_tensor(rows, device=device),
            torch.as_tensor(valid, device=device),
            fr.to_mont(coeffs, device), fr, T, width)

    def pad(w):
        return torch.cat([w, w.new_zeros((fr.L, padded_n - w.shape[-1]))],
                         dim=-1)

    wc = fd.neg_mod(outs[ONE], fr) if ONE in outs else None
    return (pad(outs[MULT_LEFT]), pad(outs[MULT_RIGHT]),
            pad(outs[MULT_OUTPUT]), fd.neg_mod(outs[COMMITTED], fr), wc)


def _t_poly_kernel(aL, aR, aO, sL, sR, wL, wR, wO, y_m, y_inv_m, fr):
    """t(x) = <l(x), r(x)> (`vector_poly.rs:79-97`): all vectors (Lr, N)
    Montgomery, y and its inverse (Lr, 1).  Returns (t1..t6 as (Lr, 6), the
    coefficient vectors l1, l2, l3, r0, r1, r3, and y^-i (Lr, N)).  y^-1
    comes from the host: the JAX function's Fermat ladder would cost ~500
    Montgomery products here, and the inverse is unique."""
    N = aL.shape[-1]
    y_pows = _pow_shifted(y_m, N, fr)                # [1, y, .., y^{N-1}]
    y_inv_pows = _pow_shifted(y_inv_m, N, fr)

    l1 = fd.add_mod(aL, fd.mont_mul(y_inv_pows, wR, fr), fr)
    l2 = aO
    l3 = sL
    r0 = fd.sub_mod(wO, y_pows, fr)
    r1 = fd.add_mod(fd.mont_mul(y_pows, aR, fr), wL, fr)
    r3 = fd.mont_mul(y_pows, sR, fr)

    # l0 = 0 and r2 = 0: 9 pairwise inner products in one stacked pass
    lhs = torch.stack([l1, l1, l2, l2, l3, l1, l3, l2, l3], dim=1)
    rhs = torch.stack([r0, r1, r0, r1, r0, r3, r1, r3, r3], dim=1)
    ips = _inner_mont(lhs, rhs, fr)[..., 0]          # (Lr, 9)
    t2_t4 = fd.add_mod(ips[:, [1, 3, 5]], ips[:, [2, 4, 6]], fr)
    t16 = torch.cat([ips[:, 0:1], t2_t4, ips[:, 7:9]], dim=1)
    return t16, l1, l2, l3, r0, r1, r3, y_inv_pows


def _lr_eval_kernel(l1, l2, l3, r0, r1, r3, x_m, fr):
    """l(x) = x(l1 + x(l2 + x l3)); r(x) = r0 + x(r1 + x^2 r3)."""
    mul, add = fd.mont_mul, fd.add_mod
    lx = mul(x_m, add(l1, mul(x_m, add(l2, mul(x_m, l3, fr), fr), fr), fr),
             fr)
    x2 = mul(x_m, x_m, fr)
    rx = add(r0, mul(x_m, add(r1, mul(x2, r3, fr), fr), fr), fr)
    return lx, rx


# ---------------------------------------------------------------------------
# R1CS: witness commitments (prover.rs:336-366)
# ---------------------------------------------------------------------------

def _masked_sums(points, masks, ctx):
    """points (3, L, n) Montgomery, masks (S, n) bool -> (3, L, S): the sum
    of the points each mask selects, by a log2(n) tree of complete adds,
    each level one call of kernel 3 (`ec_kernels.ec_add`) on points packed
    once before the tree.  Unselected points and the padding to a power of
    two are the identity."""
    S, n = masks.shape
    L = points.shape[1]
    ident = ctx.identity_like((1,), points.device)           # (3, L, 1)
    sel = torch.where(masks[:, None, None, :], points[None], ident[None])
    sel = sel.permute(1, 2, 0, 3)                            # (3, L, S, n)
    m = 1 << (n - 1).bit_length()
    if m != n:
        sel = torch.cat([sel, ident[:, :, None].expand(3, L, S, m - n)],
                        dim=3)
    sel = pack32(sel, 1)
    while m > 1:
        half = m // 2
        sel = ec_add(sel[..., :half].contiguous(),
                     sel[..., half:].contiguous(), ctx)
        m = half
    return unpack32(sel[..., 0], 1)


def _bit_structure(vals, r):
    """Classify a host scalar vector: 'bits' (all in {0, 1}), 'negbits'
    (all in {0, r-1}), or None (general)."""
    bits = negbits = True
    for v in vals:
        x = v.v if hasattr(v, "v") else int(v)
        if x not in (0, 1):
            bits = False
        if x != 0 and x != r - 1:
            negbits = False
        if not bits and not negbits:
            return None
    return "bits" if bits else "negbits"


def _phase_commitments(aL, aR, aO, blinds, s_L, s_R, pts, h, ctx,
                       affine=False):
    """A_I, A_O and S of one phase (`prover.rs:336-366`) over the device
    table pts (3, L, 2n+1) = [G_n | H_n | h].

    Bit-structured witnesses (a_L and a_O bit vectors, a_R a {0, 1} or
    {0, -1} vector: every bit-decomposition gadget) take masked tree sums
    for A_I and A_O, and the Pippenger only for the random S; a general
    witness takes one 3-set `msm_hybrid`.  The group elements, and so the
    transcript bytes, are the same either way."""
    dev = pts.device
    n = len(aL)
    i_blind, o_blind, s_blind = blinds
    r = ctx.cv.r
    sL_cls = _bit_structure(aL, r)
    sR_cls = _bit_structure(aR, r)
    sO_cls = _bit_structure(aO, r)
    if not (sL_cls == "bits" and sO_cls == "bits"
            and sR_cls in ("bits", "negbits")):
        zero_n = [0] * n
        sets = torch.stack([to_device_scalars(v, ctx, dev) for v in (
            aL + aR + [i_blind], aO + zero_n + [o_blind],
            s_L + s_R + [s_blind])], dim=0)
        return msm_mod.msm_hybrid(pts, sets, ctx, affine=affine)

    def bitmask(vals):
        return [(v.v if hasattr(v, "v") else int(v)) != 0 for v in vals]

    zeros = [False] * n
    masks = torch.as_tensor([bitmask(aL) + zeros + [False],   # A_I, G half
                             zeros + bitmask(aR) + [False],   # A_I, H half
                             bitmask(aO) + zeros + [False]],  # A_O, G half
                            device=dev)
    g_sum, h_sum, o_sum = from_device_points(
        _masked_sums(pts, masks, ctx), ctx)
    if sR_cls == "negbits":
        h_sum = -h_sum
    with _timed("t_commits", dev):
        bh, bo = h * i_blind, h * o_blind
    (S,) = msm_mod.msm_hybrid(
        pts, to_device_scalars(s_L + s_R + [s_blind], ctx, dev)[None], ctx,
        affine=affine)
    return g_sum + h_sum + bh, o_sum + bo, S


def _phase_table(G, H, h, ctx, device):
    """[G | H | h] on `device` and whether it is affine."""
    Gd, affG, _ = _pts_cache.get(G, ctx, device)
    Hd, affH, _ = _pts_cache.get(H, ctx, device)
    hd, affh = to_device_points_affine([h], ctx, device)
    return torch.cat([Gd, Hd, hd], dim=2), affG and affH and affh


# ---------------------------------------------------------------------------
# R1CS: the device prover
# ---------------------------------------------------------------------------

def prove_device(prover, G, H, device="cuda", fused=None):
    """`Prover.prove` (`prover.rs:322-593`) on `device`: the transcript and
    blinding schedule of the JAX package's `Prover._prove` and
    `prove_device`, so the proof bytes are theirs for the same rng.
    fused: the IPA's form (`create_ipp_implicit`)."""
    dev = torch.device(device)

    def commit_phase1(blinds, s_L, s_R, ctx):
        n1 = len(prover.a_L)
        with _timed("phase1_convert", dev):
            pts1, aff1 = _phase_table(G[:n1], H[:n1], prover.h, ctx, dev)
        with _timed("phase1_msm", dev):
            return _phase_commitments(prover.a_L, prover.a_R, prover.a_O,
                                      blinds, s_L, s_R, pts1, prover.h, ctx,
                                      affine=aff1)

    def prove_ipa(tr, Q, Gf_m, Hf_m, l_vec, r_vec, ctx):
        N = l_vec.shape[-1]
        pts_ipa, aff_ipa, table32 = _ipa_table(G[:N], H[:N], Q, ctx, dev)
        return create_ipp_implicit(
            tr, Gf_m, Hf_m, pts_ipa, l_vec, r_vec, ctx, affine=aff_ipa,
            table32=table32, fused=fused)

    return prove_schedule(prover, G, H, dev, commit_phase1, prove_ipa)


def prove_schedule(prover, G, H, dev, commit_phase1, prove_ipa):
    """The R1CS prover's schedule (`prover.rs:322-593`), shared by
    `prove_device` and the sharded prover (`parallel/sharded_prover.py`):
    the transcript, the rng draws, the phase-2 commitments, the z-fold,
    t(x) and l(x)/r(x) on `dev`, with the two steps that differ passed in.

    commit_phase1(blinds, s_L, s_R, ctx) -> (A_I1, A_O1, S1): the phase-1
    witness commitments of `prover`'s first len(a_L) multipliers over
    G, H and h, blinds = (i, o, s).
    prove_ipa(transcript, Q, Gf_m, Hf_m, l_vec, r_vec, ctx) -> (L_vec,
    R_vec, a, b): the IPA over G[:N], H[:N], N = l_vec's length, the
    factors and vectors (Lr, N) Montgomery on `dev`."""
    from ..r1cs.proof import R1CSProof
    from ..ipp import InnerProductArgumentProof
    from ..utils.errors import InvalidGeneratorsLength
    from ..utils.vector_poly import Poly6
    from .ec_host import commit_to_field_element
    from .field_host import inner_product, random_scalars

    tr = prover.transcript
    rng = prover.rng
    cv = prover.g.cv
    ctx = CurveCtx(cv)
    fr = ctx.fr

    tr.append_u64(b"m", len(prover.v))

    n1 = len(prover.a_L)
    if len(G) < n1:
        raise InvalidGeneratorsLength()

    i_blinding1 = Scalar.random(rng)
    o_blinding1 = Scalar.random(rng)
    s_blinding1 = Scalar.random(rng)
    s_L1 = random_scalars(n1, rng)
    s_R1 = random_scalars(n1, rng)

    A_I1, A_O1, S1 = commit_phase1((i_blinding1, o_blinding1, s_blinding1),
                                   s_L1, s_R1, ctx)

    tr.commit_point(b"A_I1", A_I1)
    tr.commit_point(b"A_O1", A_O1)
    tr.commit_point(b"S1", S1)

    prover._create_randomized_constraints()

    n = len(prover.a_L)
    n2 = n - n1
    padded_n = 1 if n == 0 else 1 << (n - 1).bit_length()
    pad = padded_n - n
    if len(G) < padded_n:
        raise InvalidGeneratorsLength()

    if n2 > 0:
        i_blinding2 = Scalar.random(rng)
        o_blinding2 = Scalar.random(rng)
        s_blinding2 = Scalar.random(rng)
    else:
        i_blinding2 = o_blinding2 = s_blinding2 = Scalar.zero()
    s_L2 = random_scalars(n2, rng)
    s_R2 = random_scalars(n2, rng)

    if n2 > 0:
        pts2, aff2 = _phase_table(G[n1:n], H[n1:n], prover.h, ctx, dev)
        A_I2, A_O2, S2 = _phase_commitments(
            prover.a_L[n1:], prover.a_R[n1:], prover.a_O[n1:],
            (i_blinding2, o_blinding2, s_blinding2), s_L2, s_R2, pts2,
            prover.h, ctx, affine=aff2)
    else:
        A_I2 = A_O2 = S2 = type(prover.g).identity(cv)

    tr.commit_point(b"A_I2", A_I2)
    tr.commit_point(b"A_O2", A_O2)
    tr.commit_point(b"S2", S2)

    y = tr.challenge_scalar(b"y")
    z = tr.challenge_scalar(b"z")

    with _timed("zfold", dev):
        tables = build_zfold_tables(prover.constraints, n, len(prover.v))
        wL, wR, wO, wV_m, _ = zfold_device(tables, z, len(prover.constraints),
                                           fr, padded_n, dev)

    with _timed("tpoly", dev):
        zpad = [0] * pad
        N = padded_n
        stacked = _mont(fr, prover.a_L + zpad + prover.a_R + zpad
                        + prover.a_O + zpad + s_L1 + s_L2 + zpad
                        + s_R1 + s_R2 + zpad + [y, y.inverse()], dev)
        aL_m, aR_m, aO_m, sL_m, sR_m = (stacked[:, k * N:(k + 1) * N]
                                        for k in range(5))
        t16, l1, l2, l3, r0, r1, r3, y_inv_pows = _t_poly_kernel(
            aL_m, aR_m, aO_m, sL_m, sR_m, wL, wR, wO,
            stacked[:, 5 * N:5 * N + 1], stacked[:, 5 * N + 1:], fr)
        t_poly = Poly6(*[Scalar(v, cv) for v in fr.from_mont(t16)])

    t_blindings = [Scalar.random(rng) for _ in range(5)]   # t_1, t_3..t_6
    g_, h_ = prover.g, prover.h
    with _timed("t_commits", dev):
        T_1, T_3, T_4, T_5, T_6 = [
            commit_to_field_element(g_, h_, t, b) for t, b in zip(
                [t_poly.t1, t_poly.t3, t_poly.t4, t_poly.t5, t_poly.t6],
                t_blindings)]

    tr.commit_point(b"T_1", T_1)
    tr.commit_point(b"T_3", T_3)
    tr.commit_point(b"T_4", T_4)
    tr.commit_point(b"T_5", T_5)
    tr.commit_point(b"T_6", T_6)

    u = tr.challenge_scalar(b"u")
    x = tr.challenge_scalar(b"x")

    wV = [Scalar(v, cv) for v in fr.from_mont(wV_m)]
    t_2_blinding = inner_product(wV, prover.v_blinding)
    t_1b, t_3b, t_4b, t_5b, t_6b = t_blindings
    t_blinding_poly = Poly6(t_1b, t_2_blinding, t_3b, t_4b, t_5b, t_6b)

    t_x = t_poly.eval(x)
    t_x_blinding = t_blinding_poly.eval(x)
    l_vec, r_vec = _lr_eval_kernel(l1, l2, l3, r0, r1, r3,
                                   _mont(fr, [x], dev), fr)

    i_blinding = i_blinding1 + u * i_blinding2
    o_blinding = o_blinding1 + u * o_blinding2
    s_blinding = s_blinding1 + u * s_blinding2
    e_blinding = x * (i_blinding + x * (o_blinding + x * s_blinding))

    tr.commit_scalar(b"t_x", t_x)
    tr.commit_scalar(b"t_x_blinding", t_x_blinding)
    tr.commit_scalar(b"e_blinding", e_blinding)

    w = tr.challenge_scalar(b"w")
    with _timed("t_commits", dev):
        Q = g_ * w

    # G_factors = [1]*n1 + [u]*(n2+pad); H_factors = y^-i * G_factors
    Gf_m = torch.cat([fr.on("one_m", dev).expand(fr.L, n1),
                      _mont(fr, [u], dev).expand(fr.L, n2 + pad)], dim=-1)
    Hf_m = fd.mont_mul(y_inv_pows, Gf_m, fr)

    L_vec, R_vec, a_fin, b_fin = prove_ipa(tr, Q, Gf_m, Hf_m, l_vec, r_vec,
                                           ctx)

    return R1CSProof(A_I1=A_I1, A_O1=A_O1, S1=S1, A_I2=A_I2, A_O2=A_O2,
                     S2=S2, T_1=T_1, T_3=T_3, T_4=T_4, T_5=T_5, T_6=T_6,
                     t_x=t_x, t_x_blinding=t_x_blinding,
                     e_blinding=e_blinding,
                     ipp_proof=InnerProductArgumentProof(
                         L=L_vec, R=R_vec, a=a_fin, b=b_fin))
