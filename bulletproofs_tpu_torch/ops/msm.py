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
   for projective ones and after pre-reduction passes), or, with
   `ec_kernel="round"`, one launch of `bucket_round_add` per round.  Each
   gathers its rows by point id from a table packed once per MSM
   (`point_table`, or the pre-reduced table).
4. **Combine**: sub-bucket and duplicate-row folds and the two-level
   row/column sums (`ec_gather_sum`), then the weighted running sums
   (`ec_window_totals`): kernel 3's sequential forms, one launch each, give
   one total per window; the window Horner runs on the host in Python ints
   (`msm_hybrid`) or on the device (`ec_horner`: `msm_device`, and
   `msm_sets_device`, the fused IPA's MSM, which never synchronises).

`pick_window`, `window_plan`, `occupancy_guess` and the slot-grid algorithm
are identical to the JAX package's, so digits, grids, occupancy and bucket
arrays compare entry for entry.  Their thresholds (c = 8, `EC_CHUNK` = 16,
the 4-sigma round margin) were tuned on a TPU and are untuned for the H100.

Layouts keep the JAX package's: points (3, L, n), digits (W, n), buckets
(3, L, W, B), with int64 lanes.  Between the bucket rounds and the window
totals the buckets stay PACKED in the kernels' 32-bit words, (3, NL, W, B)
int32 (`field.pack32`), on the CPU too: `bucket_rowcol`, `window_totals`
and `combine_from_rowcol` take and return packed points, and an MSM
unpacks once, its window totals.
"""

import math

import numpy as np
import torch

from . import field as fd
from .ec import (CurveCtx, from_device_points, to_device_points_affine,
                 to_device_scalars)
from .ec_host import G1
from .ec_kernels import (affine_rows32, bucket_round_add,
                         bucket_rounds_mixed, bucket_rounds_proj,
                         ec_gather_sum, ec_horner, ec_pre_reduce,
                         ec_window_totals, packed_identity, proj_rows32)
from .field import unpack32

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
# (n, c, curve, affine) -> the (rounds, pre) `msm_device` last settled on:
# a record of the shapes it ran, read by chip_smoke.py to check the
# kernels at them; `msm_device` does not start from it
_device_memo = {}


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
    grid, found, occ = _slot_grid_from(sorted_d, rank, perm, B, R, ranges,
                                       splits, digits.shape[1])
    return grid, found, int(occ)


def _split_ranks(sorted_d, rank, ranges, splits):
    """Sub-bucket spreading of `window_plan`: the entry of digit d and rank
    t goes to bucket d + range * (t mod split) at round t // split.
    -> (bucket, round) per entry; the digits are the buckets when splits
    is None."""
    if splits is None:
        return sorted_d, rank
    dev = sorted_d.device
    ranges_t = _index_on(("ranges", tuple(ranges[:, 0].tolist())),
                         lambda: ranges, dev)
    splits_t = _index_on(("splits", tuple(splits[:, 0].tolist())),
                         lambda: splits, dev)
    return sorted_d + ranges_t * (rank % splits_t), rank // splits_t


def _occupancy(sorted_d, rounds):
    """The rounds a schedule needs: 1 + the largest round of a non-zero
    digit (digit-0 entries are never scheduled), a 0-dim tensor."""
    return torch.where(sorted_d == 0, 0, rounds).max() + 1


def _max_occupancy(scalars, ctx, c):
    """The rounds one bucket pass over `scalars` (Lr, n) needs under
    `window_plan(ctx, c)` (no duplicate rows): the max non-zero bucket rank
    after the sub-bucket split, as the slot grid counts it, a 0-dim tensor
    on the scalars' device that is not read here.  The sharded MSM fixes
    one round count for all shards from it (the JAX package's
    `msm._max_occupancy`)."""
    ranges, splits = window_plan(ctx, c)
    sorted_d, rank, _ = _sorted_ranks(
        fd.get_digits(scalars, c, _n_windows(ctx, c)))
    return _occupancy(sorted_d, _split_ranks(sorted_d, rank, ranges,
                                             splits)[1])


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
    3. keep the first entry of every slot and compact them to the front.

    Returns ((R, W, B) grid, found mask, true max occupancy as a 0-dim
    tensor on the device)."""
    W = sorted_d.shape[0]
    dev = sorted_d.device
    bucket, rank = _split_ranks(sorted_d, rank, ranges, splits)
    occ = _occupancy(sorted_d, rank)

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

_index_tables = {}


def _index_on(key, make, device):
    """A constant table (numpy from `make()`: a gather-sum index, a window
    plan's ranges or splits) on `device`, made once per key and device, so
    a warm MSM copies nothing from the host."""
    k = (key, str(device))
    if k not in _index_tables:
        _index_tables[k] = torch.as_tensor(make(), device=device)
    return _index_tables[k]


def _pad_rows(rows):
    """Lists of column ids -> (len, max len) int32, padded with -1."""
    m = max(1, max(len(r) for r in rows))
    out = np.full((len(rows), m), -1, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _split_fold_index(W, B, ranges, splits):
    rows = []
    for w in range(W):
        s, rng = splits[w], ranges[w]
        for d in range(B):
            if s == 1:
                rows.append([w * B + d])
            elif d < rng:
                rows.append([w * B + d + j * rng for j in range(s)])
            else:
                rows.append([])                     # the identity
    return _pad_rows(rows)


def fold_split_buckets(buckets, ctx, ranges, splits):
    """Undo the sub-bucket spreading: for every window with split > 1, fold
    bucket d + range*j into bucket d (j = 1 .. split-1, in order) and set
    the buckets past the range to the identity.  Packed (3, NL, W, B) ->
    the same shape, in one launch of `ec_gather_sum`."""
    if int(splits.max()) == 1:
        return buckets
    nl, W, B = buckets.shape[1:]
    key = ("split", W, B, tuple(ranges[:, 0].tolist()),
           tuple(splits[:, 0].tolist()))
    idx = _index_on(key, lambda: _split_fold_index(
        W, B, ranges[:, 0].tolist(), splits[:, 0].tolist()), buckets.device)
    out = ec_gather_sum(buckets.reshape(3, nl, W * B), idx, False, ctx)
    return out.reshape(3, nl, W, B)


def _dup_fold_index(W_base, B, dup_plan):
    rows = [[w * B + d] for w in range(W_base) for d in range(B)]
    k = W_base
    for src, g in dup_plan:
        for d in range(B):
            rows[src * B + d] += [(k + i) * B + d for i in range(g - 1)]
        k += g - 1
    return _pad_rows(rows)


def _fold_dup_rows(buckets, ctx, dup_plan, W_base):
    """Fold the duplicate bucket rows (appended past W_base) back into their
    source windows, in order, and strip them: packed (3, NL, W', B) ->
    (3, NL, W_base, B), in one launch of `ec_gather_sum`."""
    if not dup_plan:
        return buckets
    nl, W, B = buckets.shape[1:]
    idx = _index_on(("dup", W_base, B, tuple(dup_plan)),
                    lambda: _dup_fold_index(W_base, B, dup_plan),
                    buckets.device)
    out = ec_gather_sum(buckets.reshape(3, nl, W * B), idx, False, ctx)
    return out.reshape(3, nl, W_base, B)


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
    sorted point table, on packed words: pass p adds the entry 2^p places
    on into every entry whose rank is a multiple of 2^(p+1), so a bucket's
    occupancy halves per pass.  Returns the merged per-window tables as
    kernel 2's packed table (W*n, 3NL) int32 (row w*n + i is sorted
    position i of window w), from kernel 3's pre-reduction form
    (`ec_pre_reduce`: a launch a pass, an add per merging pair)."""
    return ec_pre_reduce(proj_rows32(points), perm, sorted_d, rank,
                         pre_reduce, ctx)


def uses_mixed(ctx: CurveCtx, affine, pre_reduce=0, ec_kernel="chunk"):
    """Whether a bucket pass runs kernel 1, the mixed add from the packed
    affine table: the table has Z == 1 everywhere (`affine`), no
    pre-reduction pass made projective rows, the curve has a = 0 and the
    pass is chunked."""
    return (affine and pre_reduce == 0 and ctx.a_is_zero
            and ec_kernel == "chunk")


def point_table(points, ctx: CurveCtx, affine, ec_kernel="chunk"):
    """The packed table a bucket pass without pre-reduction reads its rows
    from: kernel 1's affine (n, 2NL) (`affine_rows32`) where the pass runs
    kernel 1 (`uses_mixed`), else kernels 2 and 4's projective (n, 3NL)
    (`proj_rows32`)."""
    if uses_mixed(ctx, affine, 0, ec_kernel):
        return affine_rows32(points)
    return proj_rows32(points)


def bucket_accumulate(points, digits, ctx: CurveCtx, c: int, n_rounds,
                      plan=None, pre_reduce=0, affine=False,
                      ec_kernel="chunk", table32=None, sync=True):
    """points (3, L, n) Montgomery, digits (W, n) -> (buckets (3, NL, W, B)
    PACKED, occ), occ the true max occupancy under `plan` after
    `pre_reduce` passes.

    The occupancy comes from the slot grid before any EC work: when it
    exceeds `n_rounds` the schedule would drop points, so nothing is added
    and buckets is None; the caller escalates (`_escalate`) and calls again.
    sync=False keeps occ a 0-dim device tensor, never read here, so the
    pass makes no host synchronisation: the rounds run whatever occ is,
    the points of rank >= n_rounds are dropped, and the caller reads occ
    later and, where it exceeds n_rounds, runs again escalated.

    plan: (ranges, splits[, dup_plan]) from `window_plan`.
    pre_reduce: halving passes (`_pre_reduce_rows`) that tame degenerate
    scalar distributions such as bit vectors, an add per merging pair;
    the rounds then read the pre-reduced table.
    affine: the table has Z == 1 everywhere, so without pre-reduction the
    chunked rounds use the mixed-add kernel (`uses_mixed`).
    table32: the packed table of `points` that the rounds read by the slot
    grid's point ids without pre-reduction (`point_table`, on the points'
    device; made here when not given); unused after pre-reduction.
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

    mixed = uses_mixed(ctx, affine, pre_reduce, ec_kernel)
    words = (2 if mixed else 3) * L // 2
    if not pre_reduce and table32 is not None and (
            tuple(table32.shape) != (n, words)
            or table32.dtype != torch.int32 or table32.device != dev):
        # the kernels read rows by id without bounds: a short table would
        # be read past its end
        raise ValueError(f"table32 must be ({n}, {words}) int32 on {dev}, "
                         f"got {tuple(table32.shape)} {table32.dtype} on "
                         f"{table32.device}")
    sorted_d, rank, perm = _sorted_ranks(digits)
    if pre_reduce:
        alive = (rank & ((1 << pre_reduce) - 1)) == 0
        iota = torch.arange(n, device=dev).expand(W, n)
        grid, found, occ = _slot_grid_from(
            torch.where(alive, sorted_d, 0), rank >> pre_reduce, iota, B,
            n_rounds, ranges, splits, n)
    else:
        grid, found, occ = _slot_grid_from(sorted_d, rank, perm, B,
                                           n_rounds, ranges, splits, n)
    if sync:
        occ = int(occ)
        if occ > n_rounds:
            return None, occ
    if pre_reduce:
        table32 = _pre_reduce_rows(points, sorted_d, rank, perm, ctx,
                                   pre_reduce)
        # window w's sorted positions are rows w*n .. w*n + n - 1
        grid = grid.clamp(max=n - 1) + \
            (torch.arange(W, device=dev) * n).reshape(1, W, 1)
    else:
        grid = grid.clamp(max=n - 1)
        if table32 is None:
            table32 = point_table(points, ctx, affine, ec_kernel)

    S = W * B
    # point ids (table rows) and occupancy of every round, (n_rounds, S)
    ids = grid.reshape(n_rounds, S).to(torch.int32)
    found32 = found.reshape(n_rounds, S).to(torch.int32)
    buckets = packed_identity(ctx, (S,), dev)
    if ec_kernel == "round":
        for r in range(n_rounds):
            buckets = bucket_round_add(buckets, table32, ids[r], found32[r],
                                       ctx)
    else:
        rounds_fn = bucket_rounds_mixed if mixed else bucket_rounds_proj
        R_c = _chunk_rounds(n_rounds)
        for r0 in range(0, n_rounds, R_c):
            buckets = rounds_fn(buckets, table32, ids[r0:r0 + R_c],
                                found32[r0:r0 + R_c], ctx)
    buckets = buckets.reshape(3, L // 2, W, B)
    if plan is not None:
        buckets = fold_split_buckets(buckets, ctx, ranges, splits)
    return _fold_dup_rows(buckets, ctx, dup_plan, W_base), occ


# ---------------------------------------------------------------------------
# Bucket and window combine
# ---------------------------------------------------------------------------

def _rowcol_index(W, G, K):
    """Row o < W*G lists the K buckets of rowsum[w, g]; row W*G + w*K + k
    the G buckets of colsum[w, k]; bucket d = g*K + k of window w is
    column w*G*K + d."""
    rows = [[w * G * K + g * K + k for k in range(K)]
            for w in range(W) for g in range(G)]
    rows += [[w * G * K + g * K + k for g in range(G)]
             for w in range(W) for k in range(K)]
    return _pad_rows(rows)


def bucket_rowcol(buckets, ctx: CurveCtx, c: int):
    """The wide half of the bucket combine: with d = g*K + k,
    rowsum[w, g] = sum_k B[w, gK+k] and colsum[w, k] = sum_g B[w, gK+k],
    each from the identity in index order, in one launch of
    `ec_gather_sum`.  Packed (3, NL, W, B) -> ((3, NL, W, G),
    (3, NL, W, K))."""
    g_bits = (c + 1) // 2
    G, K = 1 << g_bits, 1 << (c - g_bits)
    nl, W, B = buckets.shape[1:]
    idx = _index_on(("rowcol", W, G, K), lambda: _rowcol_index(W, G, K),
                    buckets.device)
    out = ec_gather_sum(buckets.reshape(3, nl, W * B), idx, True, ctx)
    return (out[:, :, :W * G].reshape(3, nl, W, G),
            out[:, :, W * G:].reshape(3, nl, W, K))


def window_totals(rowsum, colsum, ctx: CurveCtx, c: int):
    """Per-window totals T_w = K*(sum_g g*rowsum) + sum_k k*colsum, in one
    launch of `ec_window_totals`: packed (3, NL, W, G), (3, NL, W, K) ->
    (3, NL, W)."""
    return ec_window_totals(rowsum.contiguous(), colsum.contiguous(),
                            c - (c + 1) // 2, ctx)


def combine_from_rowcol(rowsum, colsum, ctx: CurveCtx, c: int,
                        wins_per_set=None):
    """Device tail of the combine: window totals, then Horner over each
    set's windows (`ec_horner`).  W = n_sets * wins_per_set windows, packed
    -> (3, NL, n_sets) packed."""
    W = rowsum.shape[2]
    totals = window_totals(rowsum, colsum, ctx, c)
    return ec_horner(totals, wins_per_set or W, c, ctx)


def combine_buckets(buckets, ctx: CurveCtx, c: int):
    """The whole combine on the device: packed buckets (3, NL, W, B) of one
    set -> its MSM total, packed (3, NL, 1)."""
    rowsum, colsum = bucket_rowcol(buckets, ctx, c)
    return combine_from_rowcol(rowsum, colsum, ctx, c)


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def _digits_multi(scalars, ctx, c):
    """scalars (S, Lr, n) -> (S*W, n) digits, each set's windows stacked."""
    W = _n_windows(ctx, c)
    return torch.cat([fd.get_digits(s, c, W) for s in scalars], dim=0)


def msm_totals(points, scalars, ctx: CurveCtx, c: int, n_rounds,
               pre_reduce=0, affine=False, ec_kernel="chunk", table32=None):
    """S scalar sets against one point table in ONE bucket pass (the port
    of `_msm_multi_totals_jit`): points (3, L, n) Montgomery, scalars
    (S, Lr, n) plain -> (per-window totals (3, L, S*W) in PLAIN form, occ).
    Totals are None when occ > n_rounds (see `bucket_accumulate`, which
    also says what `ec_kernel` and `table32` are)."""
    digits = _digits_multi(scalars, ctx, c)
    plan = window_plan(ctx, c, n_sets=scalars.shape[0], dup=True)
    buckets, occ = bucket_accumulate(points, digits, ctx, c, n_rounds,
                                     plan=plan, pre_reduce=pre_reduce,
                                     affine=affine, ec_kernel=ec_kernel,
                                     table32=table32)
    if buckets is None:
        return None, occ
    rowsum, colsum = bucket_rowcol(buckets, ctx, c)
    return plain_points(window_totals(rowsum, colsum, ctx, c), ctx), occ


def plain_points(points32, ctx: CurveCtx):
    """Packed Montgomery points (3, NL, m) -> plain-form limbs (3, L, m)."""
    totals = unpack32(points32, 1)
    L, m = ctx.fp.L, totals.shape[2]
    plain = fd.from_mont(totals.permute(1, 0, 2).reshape(L, 3 * m), ctx.fp)
    return plain.reshape(L, 3, m).permute(1, 0, 2)


def msm_sets_device(points, scalars, ctx: CurveCtx, c: int, n_rounds,
                    pre_reduce=0, affine=False, ec_kernel="chunk",
                    table32=None):
    """S scalar sets against one point table, all on the device and with
    no host synchronisation (the fused IPA's MSM): points (3, L, n)
    Montgomery and scalars (S, Lr, n) plain -> (packed (3, NL, S) results,
    the occupancy as a 0-dim device tensor).  One bucket pass at
    (n_rounds, pre_reduce) whatever the occupancy (`bucket_accumulate`
    with sync=False), the row and column sums, the window totals and each
    set's Horner on the card (`combine_from_rowcol`).  Where occ exceeds
    n_rounds, points were dropped and the results are wrong: the caller
    reads occ and runs again escalated (`_escalate`)."""
    digits = _digits_multi(scalars, ctx, c)
    plan = window_plan(ctx, c, n_sets=scalars.shape[0], dup=True)
    buckets, occ = bucket_accumulate(points, digits, ctx, c, n_rounds,
                                     plan=plan, pre_reduce=pre_reduce,
                                     affine=affine, ec_kernel=ec_kernel,
                                     table32=table32, sync=False)
    rowsum, colsum = bucket_rowcol(buckets, ctx, c)
    return combine_from_rowcol(rowsum, colsum, ctx, c,
                               wins_per_set=_n_windows(ctx, c)), occ


def horner_sets(totals, ctx: CurveCtx, c: int, n_sets):
    """Plain window totals (3, L, n_sets*W), one device fetch -> the
    n_sets host G1 results, each set's window Horner in Python ints."""
    W = totals.shape[2] // n_sets
    ints = fd.limbs_to_ints(totals.permute(1, 2, 0))     # (L, S*W, 3)
    wins = [tuple(ints[3 * j:3 * j + 3]) for j in range(n_sets * W)]
    return [_horner(wins[s * W:(s + 1) * W], ctx.cv, c)
            for s in range(n_sets)]


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
               n_eff: int = None, affine: bool = False, ec_kernel="chunk",
               table32=None):
    """Multi-set MSM, the device Pippenger with the serial Horner tail on
    the host: points (3, L, n) Montgomery and scalars (S, Lr, n) plain, both
    on one device -> list of S host G1 results.

    The round count starts from the last successful escalation for this
    shape (`_escalation_memo`): bit-vector scalars need pre-reduction every
    time.  n_eff: a bound on the non-zero scalars per set, which tightens
    the round guess.  ec_kernel: the form of the bucket pass, "chunk" or
    "round" (`bucket_accumulate`); the results are equal.  table32: the
    packed table of `point_table(points_dev, ctx, affine, ec_kernel)`, for
    a caller that reuses one table over many MSMs; else it is packed here,
    once, unless this shape's escalation memo says the pass pre-reduces."""
    n = points_dev.shape[2]
    S = scalars_multi.shape[0]
    if c is None:
        c = pick_window(n)
    key = (n, S, c, ctx.cv.name, n_eff)
    rounds, pre = _escalation_memo.get(
        key, (occupancy_guess(n_eff or n, ctx, c), 0))
    if table32 is None and pre == 0:
        table32 = point_table(points_dev, ctx, affine, ec_kernel)
    while True:
        totals, occ = msm_totals(points_dev, scalars_multi, ctx, c, rounds,
                                 pre, affine, ec_kernel, table32)
        if totals is not None:
            break
        rounds, pre = _escalate(occ, rounds, pre)
    _escalation_memo[key] = (rounds, pre)
    return horner_sets(totals, ctx, c, S)


def msm_device(points, scalars, ctx: CurveCtx, c: int, affine=False):
    """points (3, L, n) Montgomery, scalars (Lr, n) plain -> (3, L, 1), the
    whole MSM on the device: the round count starts at `occupancy_guess`
    and escalates on overflow."""
    rounds = occupancy_guess(points.shape[2], ctx, c)
    pre = 0
    digits = fd.get_digits(scalars, c, _n_windows(ctx, c))
    plan = window_plan(ctx, c, dup=True)
    table32 = point_table(points, ctx, affine)
    while True:
        buckets, occ = bucket_accumulate(points, digits, ctx, c, rounds,
                                         plan=plan, pre_reduce=pre,
                                         affine=affine, table32=table32)
        if buckets is not None:
            break
        rounds, pre = _escalate(occ, rounds, pre)
    _device_memo[(points.shape[2], c, ctx.cv.name, affine)] = (rounds, pre)
    return unpack32(combine_buckets(buckets, ctx, c), 1)


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
