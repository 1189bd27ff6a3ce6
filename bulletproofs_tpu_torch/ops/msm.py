"""Device multi-scalar multiplication: the uniform-work Pippenger of
`bulletproofs_tpu/ops/msm.py`, ported to PyTorch with its EC work in the
CUDA kernels of `ops/ec_kernels.py`.

1. **Digits**: base-2^c unsigned digits of all scalars, all windows at once.
2. **Slot grid**: within each window the points of one bucket get ranks
   0, 1, 2, ... (a stable sort and a cummax, no EC math); round t adds the
   rank-t point of every bucket, so a round is ONE batched EC add over all
   (window, bucket) slots.  Rounds = max bucket occupancy.  Skewed windows
   are spread over sub-buckets and duplicate rows (`window_plan`).
3. **Bucket rounds**: R_c rounds per kernel launch, accumulators resident in
   registers (`bucket_rounds_mixed` for affine tables, `bucket_rounds_proj`
   after pre-reduction passes), or, with `ec_kernel="round"`, one launch
   of `bucket_round_add` per round.
4. **Combine**: sub-bucket and duplicate-row folds, the two-level row/column
   sums and the weighted running sums, all through the batched `ec_add`
   kernel, give one total per window; the window Horner runs on the host in
   Python ints (`msm_hybrid`) or on the device (`msm_device`).

`pick_window`, `window_plan`, `occupancy_guess` and the slot-grid algorithm
are identical to the JAX package's, so digits, grids, occupancy and bucket
arrays compare entry for entry.  Their thresholds (c = 8, `EC_CHUNK` = 16,
the 4-sigma round margin) were tuned on a TPU and are untuned for the H100.

Layouts keep the JAX package's: points (3, L, n), digits (W, n), buckets
(3, L, W, B), with int64 lanes.
"""

import math

import numpy as np
import torch

from . import field as fd
from .ec import (CurveCtx, from_device_points, to_device_points_affine,
                 to_device_scalars)
from .ec_host import G1
from .ec_kernels import (bucket_round_add, bucket_rounds_mixed,
                         bucket_rounds_proj, ec_add)

# Rounds per bucket-kernel launch (the JAX package's BP_EC_CHUNK default).
EC_CHUNK = 16

# Forms of the bucket pass (the JAX package's BP_EC_KERNEL=pallas and
# pallas_round): R_c rounds per launch, or one launch per round.
EC_KERNELS = ("chunk", "round")


def _chunk_rounds(n_rounds):
    R_c = EC_CHUNK
    while n_rounds % R_c:
        R_c //= 2
    return max(R_c, 1)


def pick_window(n: int) -> int:
    """Even window size c (the JAX package's choice, tuned on a TPU)."""
    if n >= 4096:
        return 8
    if n >= 512:
        return 6
    if n >= 64:
        return 4
    return 2


def _n_windows(ctx, c):
    return -(-ctx.cv.fr.n_bits // c)


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

def window_plan(ctx, c, n_sets=1, dup=False):
    """STATIC per-(curve, c) window layout with sub-bucket splitting.

    The top window's digits span only `range_w = (r-1 >> c*w) + 1` values,
    so each such digit is spread over `split_w` sub-buckets: the point with
    digit d and occupancy rank t goes to bucket d + range_w * (t mod split_w)
    at round t // split_w.  `fold_split_buckets` restores true buckets.

    Returns (ranges, splits): numpy (n_sets*W, 1) int32 column vectors.
    dup=True also returns a duplicate-row plan for windows whose split still
    leaves them skewed (range*split in (B/2, B]): such a window gets g-1
    extra physical rows, appended after all sets, and its points are spread
    over the g rows by index residue; `_fold_dup_rows` folds them back.
    Return shape then (ranges, splits, dup_plan), dup_plan a tuple of
    (src_row, g)."""
    B = 1 << c
    W = _n_windows(ctx, c)
    r_max = ctx.cv.r - 1
    ranges, splits = [], []
    for w in range(W):
        rng = min(B, (r_max >> (c * w)) + 1)
        split = 1
        while split * 2 * rng <= B:
            split *= 2
        ranges.append(rng)
        splits.append(split)
    ranges_full = list(ranges) * n_sets
    splits_full = list(splits) * n_sets
    if not dup:
        return (np.asarray(ranges_full, np.int32).reshape(-1, 1),
                np.asarray(splits_full, np.int32).reshape(-1, 1))
    dup_plan = []
    for s in range(n_sets):
        for w in range(W):
            ratio = B / (ranges[w] * splits[w])
            if ratio > 1.04:
                dup_plan.append((s * W + w, int(np.ceil(ratio))))
    for src, g in dup_plan:
        ranges_full += [ranges_full[src]] * (g - 1)
        splits_full += [splits_full[src]] * (g - 1)
    return (np.asarray(ranges_full, np.int32).reshape(-1, 1),
            np.asarray(splits_full, np.int32).reshape(-1, 1),
            tuple(dup_plan))


def occupancy_guess(n, ctx, c, margin_sigma=4.0, dup=True):
    """STATIC round-count guess: the worst per-row mean occupancy under the
    split and duplicate-row plan plus a Poisson tail margin, rounded up to a
    multiple of 16.  The slot grid gives the true occupancy and callers
    escalate on the rare overflow."""
    plan = window_plan(ctx, c, dup=dup)
    ranges, splits = plan[0], plan[1]
    n_rows = ranges.shape[0]
    row_n = [n] * n_rows
    if len(plan) > 2:
        k = n_rows - sum(g - 1 for _, g in plan[2])
        for src, g in plan[2]:
            row_n[src] = -(-n // g)
            for _ in range(g - 1):
                row_n[k] = -(-n // g)
                k += 1
    worst = max(-(-row_n[i] // (int(ranges[i, 0]) * int(splits[i, 0])))
                for i in range(n_rows))
    guess = worst + margin_sigma * math.sqrt(worst) + 4
    return max(16, (int(guess) + 15) // 16 * 16)


_escalation_memo = {}


def _escalate(occ, rounds, pre):
    """Overflow policy: a mild overflow grows the round count; a large one
    (degenerate repeated scalars) adds halving passes until the projected
    occupancy fits."""
    if occ <= 2 * rounds:
        return (occ + 15) // 16 * 16, pre
    return rounds, pre + math.ceil(math.log2(occ / rounds))


# ---------------------------------------------------------------------------
# Slot grid
# ---------------------------------------------------------------------------

def _sorted_ranks(digits):
    """Stable per-window sort of the digits: (sorted digits, occupancy rank
    of each entry within its digit, permutation)."""
    W, n = digits.shape
    iota = torch.arange(n, device=digits.device).expand(W, n)
    sorted_d, perm = torch.sort(digits, dim=-1, stable=True)
    prev = torch.cat([torch.full_like(sorted_d[:, :1], -1),
                      sorted_d[:, :-1]], dim=1)
    start_pos = torch.cummax(torch.where(sorted_d != prev, iota, 0),
                             dim=1).values
    return sorted_d, iota - start_pos, perm


def _slot_grid(digits, B, R, ranges=None, splits=None):
    """The whole round plan as a dense grid: grid[t, w, b] = index of the
    point added to bucket b of window w in round t, or n for an empty slot.
    Returns ((R, W, B) grid, found mask, true max occupancy as an int)."""
    sorted_d, rank, perm = _sorted_ranks(digits)
    return _slot_grid_from(sorted_d, rank, perm, B, R, ranges, splits,
                           digits.shape[1])


def _sort_by(key, value):
    key, order = torch.sort(key, dim=-1, stable=True)
    return key, torch.gather(value, -1, order)


def _slot_grid_from(sorted_d, rank, values, B, R, ranges, splits, n):
    """Grid construction from a (sorted digit, rank, value) triple; `values`
    are what the bucket rounds gather by (point ids, or sorted positions
    after pre-reduction).  Two sorts and no scatter:

    1. slot key = round * B + bucket per real entry (digit-0 entries and
       rank >= R never scheduled);
    2. merge real entries with one dummy per slot (keys doubled, dummies
       odd, so a real entry sorts before its slot's dummy);
    3. keep the first entry of every slot and compact them to the front."""
    W = sorted_d.shape[0]
    dev = sorted_d.device
    if splits is not None:
        ranges_t = torch.as_tensor(ranges, dtype=torch.int64, device=dev)
        splits_t = torch.as_tensor(splits, dtype=torch.int64, device=dev)
        bucket = sorted_d + ranges_t * (rank % splits_t)
        rank = rank // splits_t
    else:
        bucket = sorted_d

    occ = int(torch.where(sorted_d == 0, 0, rank).max()) + 1

    real_key = torch.where((sorted_d == 0) | (rank >= R),
                           2 * (R * B + 1), (rank * B + bucket) * 2)
    dummy_key = (torch.arange(R * B, device=dev) * 2 + 1).expand(W, R * B)
    dummy_ids = torch.full((W, R * B), n, dtype=torch.int64, device=dev)
    k, v = _sort_by(torch.cat([real_key, dummy_key], dim=1),
                    torch.cat([values, dummy_ids], dim=1))

    slot = k >> 1
    prev_slot = torch.cat([torch.full_like(slot[:, :1], -1), slot[:, :-1]],
                          dim=1)
    total = k.shape[1]
    pos = torch.arange(total, device=dev).expand(W, total)
    _, grid = _sort_by(torch.where(slot != prev_slot, pos, total), v)
    grid = grid[:, :R * B].reshape(W, R, B).transpose(0, 1)
    return grid, grid != n, occ                          # (R, W, B)


# ---------------------------------------------------------------------------
# Bucket accumulation
# ---------------------------------------------------------------------------

def fold_split_buckets(buckets, ctx, ranges, splits):
    """Undo the sub-bucket spreading: for every window with split > 1, fold
    bucket d + range*j into bucket d.  (3, L, W, B) -> same shape."""
    B = buckets.shape[3]
    out = buckets.clone()
    for w in range(buckets.shape[2]):
        s, rng = int(splits[w, 0]), int(ranges[w, 0])
        if s == 1:
            continue
        col = buckets[:, :, w]                       # (3, L, B)
        acc = col[..., :rng].contiguous()
        for j in range(1, s):
            acc = ec_add(acc, col[..., j * rng:(j + 1) * rng].contiguous(),
                         ctx)
        out[:, :, w] = torch.cat(
            [acc, ctx.identity_like((B - rng,), buckets.device)], dim=-1)
    return out


def _fold_dup_rows(buckets, ctx, dup_plan, W_base):
    """Fold the duplicate bucket rows (appended past W_base) back into their
    source windows and strip them: (3, L, W', B) -> (3, L, W_base, B)."""
    if not dup_plan:
        return buckets
    base = buckets[:, :, :W_base].clone()
    extra = buckets[:, :, W_base:]
    k = 0
    for src, g in dup_plan:
        acc = base[:, :, src].contiguous()
        for _ in range(g - 1):
            acc = ec_add(acc, extra[:, :, k].contiguous(), ctx)
            k += 1
        base[:, :, src] = acc
    return base


def _spread_dup_rows(digits, dup_plan):
    """Spread each duplicated window's points over its g physical rows by
    index residue (a digit masked to 0 is never scheduled)."""
    n = digits.shape[1]
    grp_of = torch.arange(n, device=digits.device)
    rows = list(digits)
    extra = []
    for src, g in dup_plan:
        grp = grp_of % g
        src_digits = rows[src]
        rows[src] = torch.where(grp == 0, src_digits, 0)
        for j in range(1, g):
            extra.append(torch.where(grp == j, src_digits, 0))
    return torch.stack(rows + extra, dim=0)


def _pre_reduce_rows(points, sorted_d, rank, perm, ctx, pre_reduce):
    """`pre_reduce` passes of pairwise same-bucket merging over the digit-
    sorted point table: pass p adds the entry 2^p places on into every
    entry whose rank is a multiple of 2^(p+1), so a bucket's occupancy
    halves per pass.  Returns the merged per-window tables as (W*n, 3L)
    rows (row w*n + i is sorted position i of window w)."""
    W, n = sorted_d.shape
    L = points.shape[1]
    P = points[:, :, perm]                           # (3, L, W, n)
    ident = ctx.identity_like((W, 1), points.device)
    for p in range(pre_reduce):
        shift = 1 << p
        d_next = torch.cat([sorted_d[:, shift:],
                            torch.full_like(sorted_d[:, :shift], -1)], dim=1)
        P_next = torch.cat([P[..., shift:], ident.expand(3, L, W, shift)],
                           dim=-1)
        mergeable = ((rank & ((2 << p) - 1)) == 0) & \
            (d_next == sorted_d) & (sorted_d != 0)
        P = torch.where(mergeable[None, None], ec_add(P, P_next, ctx), P)
    return P.permute(2, 3, 0, 1).reshape(W * n, 3 * L)


def bucket_accumulate(points, digits, ctx: CurveCtx, c: int, n_rounds,
                      plan=None, pre_reduce=0, affine=False,
                      ec_kernel="chunk"):
    """points (3, L, n) Montgomery, digits (W, n) -> (buckets (3, L, W, B),
    occ), occ the true max occupancy under `plan` after `pre_reduce` passes.

    The occupancy comes from the slot grid before any EC work: when it
    exceeds `n_rounds` the schedule would drop points, so nothing is added
    and buckets is None; the caller escalates (`_escalate`) and calls again.

    plan: (ranges, splits[, dup_plan]) from `window_plan`.
    pre_reduce: halving passes (`_pre_reduce_rows`) that tame degenerate
    scalar distributions such as bit vectors, at W*n batched adds a pass.
    affine: the table has Z == 1 everywhere, so without pre-reduction the
    chunked rounds use the mixed-add kernel on (X, Y) rows.
    ec_kernel: "chunk" runs EC_CHUNK rounds per launch of kernel 1 or 2;
    "round" runs one launch of kernel 4 (`bucket_round_add`) per round on
    projective rows, affine table or not, as the JAX package's per-round
    branch does."""
    if ec_kernel not in EC_KERNELS:
        raise ValueError(f"ec_kernel must be one of {EC_KERNELS}, got "
                         f"{ec_kernel!r}")
    B = 1 << c
    L = points.shape[1]
    n = points.shape[2]
    dev = points.device
    if plan is None:
        ranges = splits = None
        dup_plan = ()
    else:
        ranges, splits = plan[0], plan[1]
        dup_plan = plan[2] if len(plan) > 2 else ()
    W_base = digits.shape[0]
    if dup_plan:
        digits = _spread_dup_rows(digits, dup_plan)
    W = digits.shape[0]

    mixed = (affine and pre_reduce == 0 and ctx.a_is_zero
             and ec_kernel == "chunk")
    w_off = None
    if pre_reduce:
        sorted_d, rank, perm = _sorted_ranks(digits)
        alive = (rank & ((1 << pre_reduce) - 1)) == 0
        iota = torch.arange(n, device=dev).expand(W, n)
        grid, found, occ = _slot_grid_from(
            torch.where(alive, sorted_d, 0), rank >> pre_reduce, iota, B,
            n_rounds, ranges, splits, n)
        if occ > n_rounds:
            return None, occ
        points_rows = _pre_reduce_rows(points, sorted_d, rank, perm, ctx,
                                       pre_reduce)
        w_off = (torch.arange(W, device=dev) * n).reshape(1, W, 1)
    else:
        grid, found, occ = _slot_grid(digits, B, n_rounds, ranges, splits)
        if occ > n_rounds:
            return None, occ
        table = points[:2] if mixed else points
        points_rows = table.permute(2, 0, 1).reshape(n, table.shape[0] * L)

    S = W * B
    R_c = 1 if ec_kernel == "round" else _chunk_rounds(n_rounds)
    grid_c = grid.reshape(n_rounds // R_c, R_c, W, B)
    found_c = found.reshape(n_rounds // R_c, R_c, S).to(torch.int32)
    buckets = ctx.identity_like((S,), dev)
    for ci in range(n_rounds // R_c):
        pid = grid_c[ci].clamp(max=n - 1)
        if w_off is not None:
            pid = pid + w_off
        rows = points_rows[pid.reshape(-1)]          # (R_c*S, 2L | 3L)
        if ec_kernel == "round":
            buckets = bucket_round_add(buckets, rows, found_c[ci, 0], ctx)
        elif mixed:
            buckets = bucket_rounds_mixed(buckets, rows, found_c[ci], ctx)
        else:
            buckets = bucket_rounds_proj(buckets, rows, found_c[ci], ctx)
    buckets = buckets.reshape(3, L, W, B)
    if plan is not None:
        buckets = fold_split_buckets(buckets, ctx, ranges, splits)
    return _fold_dup_rows(buckets, ctx, dup_plan, W_base), occ


# ---------------------------------------------------------------------------
# Bucket and window combine
# ---------------------------------------------------------------------------

def _running_weighted_sum(arr, m, ctx):
    """arr (3, L, *batch, m) -> sum_j j * arr[..., j] by the descending
    running sum (sum of suffixes)."""
    running = ctx.identity_like(arr.shape[2:-1], arr.device)
    total = ctx.identity_like(arr.shape[2:-1], arr.device)
    for t in range(m - 1):
        running = ec_add(running, arr[..., m - 1 - t].contiguous(), ctx)
        total = ec_add(total, running, ctx)
    return total


def _axis_sum(arr, m, axis, ctx):
    """Plain EC sum over `axis` (length m), sequential."""
    acc = ctx.identity_like(arr.shape[2:axis] + arr.shape[axis + 1:],
                            arr.device)
    for j in range(m):
        acc = ec_add(acc, arr.select(axis, j).contiguous(), ctx)
    return acc


def bucket_rowcol(buckets, ctx: CurveCtx, c: int):
    """The wide half of the bucket combine: with d = g*K + k,
    rowsum[w, g] = sum_k B[w, gK+k] and colsum[w, k] = sum_g B[w, gK+k].
    (3, L, W, B) -> ((3, L, W, G), (3, L, W, K))."""
    g_bits = (c + 1) // 2
    G, K = 1 << g_bits, 1 << (c - g_bits)
    bk = buckets.reshape(buckets.shape[:3] + (G, K))
    return _axis_sum(bk, K, 4, ctx), _axis_sum(bk, G, 3, ctx)


def window_totals(rowsum, colsum, ctx: CurveCtx, c: int):
    """Per-window totals T_w = K*(sum_g g*rowsum) + sum_k k*colsum:
    (3, L, W, G), (3, L, W, K) -> (3, L, W)."""
    G, K = rowsum.shape[3], colsum.shape[3]
    wr = _running_weighted_sum(rowsum, G, ctx)
    wc = _running_weighted_sum(colsum, K, ctx)
    for _ in range(c - (c + 1) // 2):                # K * wr
        wr = ec_add(wr, wr, ctx)
    return ec_add(wr, wc, ctx)


def combine_from_rowcol(rowsum, colsum, ctx: CurveCtx, c: int,
                        wins_per_set=None):
    """Device tail of the combine: window totals, then Horner over each
    set's windows.  W = n_sets * wins_per_set windows -> (3, L, n_sets)."""
    W = rowsum.shape[2]
    wins_per_set = wins_per_set or W
    n_sets = W // wins_per_set
    totals = window_totals(rowsum, colsum, ctx, c)
    totals = totals.reshape(totals.shape[:2] + (n_sets, wins_per_set))
    acc = ctx.identity_like((n_sets,), rowsum.device)
    for w in range(wins_per_set - 1, -1, -1):
        for _ in range(c):
            acc = ec_add(acc, acc, ctx)
        acc = ec_add(acc, totals[..., w].contiguous(), ctx)
    return acc


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def _digits_multi(scalars, ctx, c):
    """scalars (S, Lr, n) -> (S*W, n) digits, each set's windows stacked."""
    W = _n_windows(ctx, c)
    return torch.cat([fd.get_digits(s, c, W) for s in scalars], dim=0)


def msm_totals(points, scalars, ctx: CurveCtx, c: int, n_rounds,
               pre_reduce=0, affine=False, ec_kernel="chunk"):
    """S scalar sets against one point table in ONE bucket pass (the port
    of `_msm_multi_totals_jit`): points (3, L, n) Montgomery, scalars
    (S, Lr, n) plain -> (per-window totals (3, L, S*W) in PLAIN form, occ).
    Totals are None when occ > n_rounds (see `bucket_accumulate`, which
    also says what `ec_kernel` selects)."""
    digits = _digits_multi(scalars, ctx, c)
    plan = window_plan(ctx, c, n_sets=scalars.shape[0], dup=True)
    buckets, occ = bucket_accumulate(points, digits, ctx, c, n_rounds,
                                     plan=plan, pre_reduce=pre_reduce,
                                     affine=affine, ec_kernel=ec_kernel)
    if buckets is None:
        return None, occ
    rowsum, colsum = bucket_rowcol(buckets, ctx, c)
    totals = window_totals(rowsum, colsum, ctx, c)       # (3, L, S*W)
    L, m = ctx.fp.L, totals.shape[2]
    plain = fd.from_mont(totals.permute(1, 0, 2).reshape(L, 3 * m), ctx.fp)
    return plain.reshape(L, 3, m).permute(1, 0, 2), occ


def _horner(totals, cv, c):
    """Window Horner on the host: totals[w] plain (X, Y, Z) ints ->
    sum_w 2^(c*w) T_w, highest window first."""
    acc = G1.identity(cv)
    for X, Y, Z in reversed(totals):
        for _ in range(c):
            acc = acc + acc
        acc = acc + G1(X, Y, Z, cv)
    return acc


def msm_hybrid(points_dev, scalars_multi, ctx: CurveCtx, c: int = None,
               n_eff: int = None, affine: bool = False, ec_kernel="chunk"):
    """Multi-set MSM, the device Pippenger with the serial Horner tail on
    the host: points (3, L, n) Montgomery and scalars (S, Lr, n) plain, both
    on one device -> list of S host G1 results.

    The round count starts from the last successful escalation for this
    shape (`_escalation_memo`): bit-vector scalars need pre-reduction every
    time.  n_eff: a bound on the non-zero scalars per set, which tightens
    the round guess.  ec_kernel: the form of the bucket pass, "chunk" or
    "round" (`bucket_accumulate`); the results are equal."""
    n = points_dev.shape[2]
    S = scalars_multi.shape[0]
    if c is None:
        c = pick_window(n)
    W = _n_windows(ctx, c)
    key = (n, S, c, ctx.cv.name, n_eff)
    rounds, pre = _escalation_memo.get(
        key, (occupancy_guess(n_eff or n, ctx, c), 0))
    while True:
        totals, occ = msm_totals(points_dev, scalars_multi, ctx, c, rounds,
                                 pre, affine, ec_kernel)
        if totals is not None:
            break
        rounds, pre = _escalate(occ, rounds, pre)
    _escalation_memo[key] = (rounds, pre)

    ints = fd.limbs_to_ints(totals.permute(1, 2, 0))     # (L, S*W, 3)
    wins = [tuple(ints[3 * j:3 * j + 3]) for j in range(S * W)]
    return [_horner(wins[s * W:(s + 1) * W], ctx.cv, c) for s in range(S)]


def msm_device(points, scalars, ctx: CurveCtx, c: int, affine=False):
    """points (3, L, n) Montgomery, scalars (Lr, n) plain -> (3, L, 1), the
    whole MSM on the device: the round count starts at `occupancy_guess`
    and escalates on overflow."""
    rounds = occupancy_guess(points.shape[2], ctx, c)
    pre = 0
    digits = fd.get_digits(scalars, c, _n_windows(ctx, c))
    plan = window_plan(ctx, c, dup=True)
    while True:
        buckets, occ = bucket_accumulate(points, digits, ctx, c, rounds,
                                         plan=plan, pre_reduce=pre,
                                         affine=affine)
        if buckets is not None:
            break
        rounds, pre = _escalate(occ, rounds, pre)
    rowsum, colsum = bucket_rowcol(buckets, ctx, c)
    return combine_from_rowcol(rowsum, colsum, ctx, c)


def msm(points, scalars, cv=None, device="cuda"):
    """Host wrapper: list[G1] x list[Scalar | int] -> G1, the MSM on
    `device`."""
    if len(points) != len(scalars) or not points:
        raise ValueError("msm needs equally many points and scalars, >= 1")
    ctx = CurveCtx(cv or points[0].cv)
    P, affine = to_device_points_affine(points, ctx, device)
    s = to_device_scalars(scalars, ctx, device)
    out = msm_device(P, s, ctx, pick_window(len(points)), affine=affine)
    return from_device_points(out, ctx)[0]
