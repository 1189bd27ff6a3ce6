"""Sharded prover: the witness MSMs and the implicit-basis IPA over a mesh of
devices (`parallel/sharded_msm.py`), the port of
`bulletproofs_tpu/parallel/sharded_prover.py`.

The IPA's O(n) state (a, b and the running challenge products rG, rH)
lives in n/d shards, one on each mesh device, for the whole proof.  Per
round, as in the JAX package:

- round A: the half-swap a_k <-> a_{k xor n_j/2} is a shard exchange with
  partner i ^ (n_j/2 / ns) while the swap distance spans shards and a
  local reshape below that; each shard builds its slice of the L and R
  scalar sets over its own [G_s | H_s] table and its partial sums of
  c_L and c_R; the partial sums are added exactly in F_r on the first
  shard's device.  The arrays keep their full length n (a fold writes
  both halves of a block), so after j rounds they hold n/n_j copies of
  the length-n_j vector and the masked full-length sums are (n/n_j) c: one
  product by (n/n_j)^-1 fixes them;
- one sharded two-set MSM (`msm_multi_sharded`'s passes, butterfly and
  combine) gives L and R, and the host transcript its challenge: one host
  round trip a round;
- round B: the fold of a, b and the update of rG, rH, with the same
  exchanges.

Each shard's table is [G_s | H_s | Q], packed once a proof; Q's lane
carries c_L or c_R on the first shard and zero elsewhere, so the MSM
gives L and R whole (the JAX package adds Q * c on the host).

`prove_sharded` is `prove_device`'s schedule (`ops/prover_device.py:
prove_schedule`) with the phase-1 witness commitments through
`msm_multi_sharded` and the IPA through the sharded rounds; phase 2, the
z-fold, t(x) and l(x)/r(x) run on the mesh's first device.  The
transcript and the rng draws are unchanged, so a sharded proof's bytes
are the single-device proof's.

JAX name -> here: `_msm_multi_body` / `_msm_multi_sharded_jit` /
`msm_multi_sharded` -> `_msm_multi_shards` (shard lists) and
`msm_multi_sharded` (global arrays); `_round_a_body` / `_round_a_jit` ->
`_round_a`; `_round_b_body` / `_round_b_jit` -> `_round_b`;
`_bit_mask_local`, `_swap_sharded` -> the same names; `_swap_halves_local`
-> `prover_device._swap_halves`; `_tree_sum` -> `prover_device._tree_sum`;
`_mod_psum` (a 16-bit-limb psum and conditional subtractions) ->
`_field_sum` (modular adds, the same canonical limbs).
"""

import torch

from ..config import curve
from ..ops import field as fd
from ..ops import msm as msm_mod
from ..ops import prover_device as pd
from ..ops.ec import CurveCtx, to_device_points_affine, to_device_scalars
from ..ops.field_host import Scalar
from .sharded_msm import (_allreduce_buckets, _pad_to_multiple, make_mesh,
                          on_device, split_shards)

# (points a shard, sets, c, curve, shards, n_eff) -> the (rounds, pre)
# the last sharded multi-set MSM of that shape settled on, where the next
# one starts (witness MSMs of bit vectors pre-reduce every time)
_sharded_memo = {}


# ---------------------------------------------------------------------------
# Sharded multi-set MSM
# ---------------------------------------------------------------------------

def _msm_multi_shards(pts, tables, scal, ctx, c, affine=False, n_eff=None):
    """S scalar sets over the mesh's shards: pts[k] (3, L, m) Montgomery,
    tables[k] its packed `msm.point_table`, scal[k] (S, Lr, m) plain, all
    on shard k's device.

    Every shard's bucket pass runs at one (rounds, pre) and is launched
    before anything is read; then the shards' occupancies are read at one
    point (the JAX `pmax`).  Where any exceeds the rounds, every shard
    runs again at the shape `msm._escalate` gives, so imbalanced shards
    raise the global count and never drop points.  Then the butterfly to
    the first shard, its row and column sums and window totals there, one
    fetch and each set's window Horner on the host (as `msm.msm_hybrid`).
    -> list of S host G1.  n_eff: a bound on the non-zero scalars a set
    has on a shard, for the first round guess."""
    m, S = pts[0].shape[2], scal[0].shape[0]
    dev0 = pts[0].device
    key = (m, S, c, ctx.cv.name, len(pts), n_eff)
    rounds, pre = _sharded_memo.get(key, (msm_mod.occupancy_guess(
        max(n_eff or m, 1), ctx, c, dup=False), 0))
    plan = msm_mod.window_plan(ctx, c, n_sets=S)
    while True:
        with pd._timed("sharded_passes", dev0):
            buckets, occ = [], []
            for p, t, s in zip(pts, tables, scal):
                with on_device(p.device):
                    b, o = msm_mod.bucket_accumulate(
                        p, msm_mod._digits_multi(s, ctx, c), ctx, c, rounds,
                        plan=plan, pre_reduce=pre, affine=affine, table32=t,
                        sync=False)
                buckets.append(b)
                occ.append(o.to(dev0, non_blocking=True))
            top = int(torch.stack(occ).max())
        if top <= rounds:
            break
        rounds, pre = msm_mod._escalate(top, rounds, pre)
    _sharded_memo[key] = (rounds, pre)
    with pd._timed("sharded_butterfly", dev0):
        b0 = _allreduce_buckets(buckets, ctx, root=0)[0]
    with pd._timed("sharded_combine", dev0), on_device(dev0):
        rowsum, colsum = msm_mod.bucket_rowcol(b0, ctx, c)
        totals = msm_mod.plain_points(
            msm_mod.window_totals(rowsum, colsum, ctx, c), ctx)
        return msm_mod.horner_sets(totals, ctx, c, S)


def msm_multi_sharded(points, scalars, ctx, c, mesh, affine=False):
    """points (3, L, n) Montgomery, scalars (S, Lr, n) plain, global (any
    device; n padded to the mesh size with identities and zeros) -> list
    of S host G1: one bucket pass a shard for all S sets, with the
    guess-and-verify round count and the pre-reduction escalation of the
    single-device MSM (witness MSMs carry bit-vector scalars)."""
    points, scalars = _pad_to_multiple(points, scalars, ctx, mesh.size)
    pts = [p.contiguous() for p in split_shards(points, mesh)]
    tables = [msm_mod.point_table(p, ctx, affine) for p in pts]
    return _msm_multi_shards(pts, tables, split_shards(scalars, mesh), ctx,
                             c, affine)


# ---------------------------------------------------------------------------
# Sharded implicit-basis IPA rounds
# ---------------------------------------------------------------------------

def _bit_mask_local(n_j, ns, s, device):
    """(ns,) bool: True where shard s's entries lie in the upper half of
    their n_j block."""
    if n_j <= ns:
        return pd._upper_half(ns, n_j, device)
    # the whole shard lies in one half: its global offset decides
    return torch.full((ns,), (s * ns) % n_j >= n_j // 2, device=device)


def _swap_sharded(X, n_j, ns):
    """Every shard's entries' partners in the other half of their n_j
    block: a shard exchange with partner i ^ (n_j/2 / ns) when the half
    spans whole shards, else a local reshape."""
    half = n_j // 2
    if half >= ns:
        dist = half // ns
        return [X[i ^ dist].to(x.device, non_blocking=True)
                for i, x in enumerate(X)]
    return [pd._swap_halves(x, n_j) for x in X]


def _field_sum(parts, fr):
    """The exact F_r sum of the shards' (Lr, ...) Montgomery values, on the
    first one's device: canonical limbs, whatever the order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = fd.add_mod(acc, p.to(acc.device, non_blocking=True), fr)
    return acc


def _round_a(A, B, rG, rH, n_j, ns, tiles, fr):
    """Round A over the shards' (Lr, ns) Montgomery A, B, rG, rH: -> (per
    shard the plain (2, Lr, 2ns) L and R scalar slices over its [G_s |
    H_s], and [c_L, c_R] plain (Lr, 2) on the first shard's device).
    tiles = n / n_j, the copies of the logical vector the arrays hold."""
    swapA = _swap_sharded(A, n_j, ns)
    swapB = _swap_sharded(B, n_j, ns)
    sets, parts = [], []
    for s in range(len(A)):
        upper = _bit_mask_local(n_j, ns, s, A[s].device)
        prod = fd.mont_mul(A[s], swapB[s], fr)
        parts.append(pd._tree_sum(torch.stack(
            [torch.where(upper, 0, prod), torch.where(upper, prod, 0)],
            dim=1), fr))                                  # (Lr, 2, 1)
        L_s, R_s = pd._lr_sets(swapA[s], swapB[s], rG[s], rH[s], upper, fr)
        sets.append(fd.from_mont(torch.stack([L_s, R_s], dim=1),
                                 fr).permute(1, 0, 2).contiguous())
    c = _field_sum(parts, fr)[..., 0]
    inv_tiles = fr.to_mont([pow(tiles, -1, fr.mod_int)], c.device)
    return sets, fd.from_mont(fd.mont_mul(c, inv_tiles, fr), fr)


def _round_b(A, B, rG, rH, u_m, u_inv_m, n_j, ns, fr):
    """Round B: fold a and b by the challenge and update rG, rH on every
    shard (`prover_device._fold` with the exchanged partners).  u_m,
    u_inv_m: {device: (Lr, 1) Montgomery}.  -> lists (A, B, rG, rH)."""
    swapA = _swap_sharded(A, n_j, ns)
    swapB = _swap_sharded(B, n_j, ns)
    out = [pd._fold(A[s], B[s], swapA[s], swapB[s], rG[s], rH[s],
                    _bit_mask_local(n_j, ns, s, A[s].device),
                    u_m[A[s].device], u_inv_m[A[s].device], fr)
           for s in range(len(A))]
    return tuple(list(x) for x in zip(*out))


def _ipa_shard_tables(G_vec, H_vec, Q, ctx, mesh):
    """Per shard s its table [G_s | H_s | Q] (3, L, 2ns + 1) on its device
    and the table's packed rows, and whether the tables are affine."""
    dev0 = mesh.flat[0]
    Gd, affG, _ = pd._pts_cache.get(G_vec, ctx, dev0)
    Hd, affH, _ = pd._pts_cache.get(H_vec, ctx, dev0)
    Qd, affQ = to_device_points_affine([Q], ctx, dev0)
    affine = affG and affH and affQ
    pts = [torch.cat([g, h, Qd.to(g.device)], dim=2).contiguous()
           for g, h in zip(split_shards(Gd, mesh), split_shards(Hd, mesh))]
    return pts, [msm_mod.point_table(p, ctx, affine) for p in pts], affine


def _create_ipp_shards(transcript, Q, Gf_m, Hf_m, G_vec, H_vec, A, B, ctx,
                       mesh):
    """The sharded IPA on Montgomery (Lr, n) factors and vectors (any
    device): `create_ipp_sharded`'s rounds.  Returns (L_vec, R_vec, a,
    b)."""
    fr = ctx.fr
    n, d = len(G_vec), mesh.size
    if not n or n & (n - 1):
        raise ValueError(f"IPA length {n} is not a power of two")
    if n % d:
        raise ValueError(f"sharded IPA: n = {n} is not a multiple of the "
                         f"mesh's {d} shards")
    ns = n // d
    dev0 = mesh.flat[0]
    pts, tables, affine = _ipa_shard_tables(G_vec, H_vec, Q, ctx, mesh)
    A, B, rG, rH = (split_shards(x, mesh) for x in (A, B, Gf_m, Hf_m))
    transcript.innerproduct_domain_sep(n)

    c = msm_mod.pick_window(max(2 * n // d, 16))
    L_vec, R_vec = [], []
    n_j = n
    while n_j != 1:
        with pd._timed("ipa_scal", dev0):
            sets, cLR = _round_a(A, B, rG, rH, n_j, ns, n // n_j, fr)
            # Q's lane: c_L for L and c_R for R on the first shard
            scal = [torch.cat([x, (cLR.T[:, :, None] if s == 0 else
                                   x.new_zeros(x.shape[:2] + (1,)))], dim=-1)
                    for s, x in enumerate(sets)]
        with pd._timed("ipa_msm", dev0):
            L, R = _msm_multi_shards(pts, tables, scal, ctx, c, affine,
                                     n_eff=ns + 1)
        with pd._timed("ipa_transcript", dev0):
            transcript.commit_point(b"L", L)
            transcript.commit_point(b"R", R)
            L_vec.append(L)
            R_vec.append(R)
            u = transcript.challenge_scalar(b"u")
            u_inv = u.inverse()
            devs = set(mesh.flat)
            u_m = {dv: fr.to_mont([u.v], dv) for dv in devs}
            u_inv_m = {dv: fr.to_mont([u_inv.v], dv) for dv in devs}
        with pd._timed("ipa_fold", dev0):
            A, B, rG, rH = _round_b(A, B, rG, rH, u_m, u_inv_m, n_j, ns, fr)
        n_j //= 2

    ab = fd.limbs_to_ints(fd.from_mont(torch.cat([A[0][:, :1],
                                                  B[0][:, :1]], dim=1), fr))
    return L_vec, R_vec, Scalar(ab[0], ctx.cv), Scalar(ab[1], ctx.cv)


def create_ipp_sharded(transcript, Q, G_factors, H_factors, G_vec, H_vec,
                       a_vec, b_vec, mesh=None):
    """The IPA prover (`ipp.rs:35-202`'s transcript schedule) with its
    state sharded over `mesh` (default: every CUDA device): host lists in,
    (L_vec, R_vec, a, b) out, the bytes of `create_ipp`.  n must be a
    power of two and a multiple of the mesh size (ValueError)."""
    if not len(G_vec) == len(H_vec) == len(a_vec) == len(b_vec) \
            == len(G_factors) == len(H_factors):
        raise ValueError("IPA vectors of unequal length")
    mesh = mesh or make_mesh()
    ctx = CurveCtx(curve())
    dev0 = mesh.flat[0]
    mont = lambda vals: pd._mont(ctx.fr, vals, dev0)
    return _create_ipp_shards(transcript, Q, mont(G_factors),
                              mont(H_factors), list(G_vec), list(H_vec),
                              mont(a_vec), mont(b_vec), ctx, mesh)


# ---------------------------------------------------------------------------
# Whole proof on the mesh
# ---------------------------------------------------------------------------

def prove_sharded(prover, G, H, mesh=None):
    """`Prover.prove` (`prover.rs:322-593`) over `mesh` (default: every
    CUDA device): the phase-1 witness commitments through
    `msm_multi_sharded` over [G | H | h] (the blindings on h's lane), the
    IPA through the sharded rounds, the rest of `prove_device`'s schedule
    on the mesh's first device.  The proof's bytes are `prove_device`'s
    (and the JAX package's `Prover._prove`'s) for the same rng."""
    mesh = mesh or make_mesh()
    dev0 = mesh.flat[0]

    def commit_phase1(blinds, s_L, s_R, ctx):
        n1 = len(prover.a_L)
        i_blind, o_blind, s_blind = blinds
        with pd._timed("phase1_convert", dev0):
            pts1, aff1 = pd._phase_table(G[:n1], H[:n1], prover.h, ctx, dev0)
            sets = torch.stack([to_device_scalars(v, ctx, dev0) for v in (
                prover.a_L + prover.a_R + [i_blind],
                prover.a_O + [0] * n1 + [o_blind],
                s_L + s_R + [s_blind])], dim=0)
        with pd._timed("phase1_msm", dev0):
            c = msm_mod.pick_window(max(2 * n1 // mesh.size, 16))
            return msm_multi_sharded(pts1, sets, ctx, c, mesh, affine=aff1)

    def prove_ipa(tr, Q, Gf_m, Hf_m, l_vec, r_vec, ctx):
        N = l_vec.shape[-1]
        return _create_ipp_shards(tr, Q, Gf_m, Hf_m, G[:N], H[:N], l_vec,
                                  r_vec, ctx, mesh)

    return pd.prove_schedule(prover, G, H, dev0, commit_phase1, prove_ipa)
