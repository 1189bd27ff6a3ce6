// Hand-written Hopper (sm_90a) kernels for the G1 arithmetic of the device
// Pippenger MSM.  Plain C interface, built by nvcc into a shared library and
// called through ctypes (bulletproofs_tpu_torch/ops/build.py, ec_kernels.py).
// The one-thread field and group device functions are in ec_common.cuh;
// the lane-cooperative ones, and the projective round of kernels 2 and 4,
// in ec_lanes.cuh, shared with kernel 5 (mxu_kernels.cu, its own library,
// built in parallel).
//
// They replace the Pallas TPU kernels of bulletproofs_tpu/ops/ec_pallas.py:
//   bp_bucket_rounds_mixed  <- bucket_rounds_chunk_pallas_mixed (:425)
//   bp_bucket_rounds_proj   <- bucket_rounds_chunk_pallas       (:355)
//   bp_ec_add               <- ec_add_pallas                    (:499)
//   bp_bucket_round_add     <- bucket_round_add_pallas          (:469)
// and kernel 3's sequential forms, the loops of complete adds that the JAX
// package runs as `fori_loop`s over `ec_add` (bulletproofs_tpu/ops/msm.py
// `_axis_sum`, `_running_weighted_sum`, `window_totals`,
// `combine_from_rowcol`, `fold_split_buckets`, `_fold_dup_rows`):
//   bp_ec_gather_sum        the axis sums and the two folds, 4 groups of
//                           4 lanes an output
//   bp_ec_window_totals     the weighted running sums, doublings and add,
//                           a warp a chain, 4 chains a window at once
//   bp_ec_horner            the window Horner over the sets, a warp a set
//   bp_ec_pre_reduce        one pass of the MSM's same-bucket merging
//                           (`_pre_reduce_rows`; the JAX package's pass
//                           loop over `ec_add` in `bucket_accumulate`),
//                           in place on kernel 2's table, an add only
//                           where two entries merge
// The last two double by RCB16's dedicated doubling where the JAX package
// adds a point to itself (`ec_double` = `ec_add(P, P)`): on the curve the
// same triple, word for word (ec_lanes.cuh `ec_dbl_l`).
//
// Representation.  A field element is NL little-endian 32-bit limbs in
// Montgomery form with R = 2^(32*NL).  The JAX package and the port's plain
// PyTorch versions hold 2*NL 16-bit limbs with R = 2^(16*2*NL), the same
// integer, so packing limb pairs (ops/field.py pack32) is exact.  Every
// function returns CANONICAL values (< p), so a kernel and its plain
// version agree limb for limb.  Points are projective (X : Y : Z), identity
// (0 : 1 : 0); the group law is the complete addition of Renes-Costello-
// Batina 2016: for a = 0 curves algorithm 7 (algorithm 8 for the mixed
// add), and for a != 0 (ed25519's Weierstrass form) algorithm 1, whose 18
// products an add take the constants a, a^2 and 3b (`CurveA`).  Kernels 2,
// 3 and 4 are templates on the choice (GA): the a = 0 instantiations are
// the code they were, and the a != 0 ones are built for NL = 8 only,
// ed25519 being the one such curve of config.py, into a library of their
// own (ec_kernels_a.cu).  Kernel 1 takes a = 0 only: the MSM never gives
// it an a != 0 curve (ops/msm.py `uses_mixed`), as the JAX package's
// mixed path does not.
// Points are coordinate-major (3, NL, n) words; the bucket kernels' point
// tables are row-major: kernel 1's (n, 2NL), each affine point's X words,
// then its Y words; kernels 2 and 4's (n, 3NL), X, Y, then Z words.
//
// What bounds them.  Integer multiply-adds: a Montgomery product is
// 2*NL^2 + NL 32x32->64-bit multiply-adds (300 for BLS12-381, two IMAD
// instructions each), and an add does 11 (mixed), 12 or, for a != 0, 18
// of them against at most 144 bytes of point read, far above the card's
// bytes-per-operation balance.  But one thread per slot leaves the SMs
// nearly empty at the MSM's shapes (8448 slots give 2 warps an SM), so the
// latency of each thread's chain of dependent instructions limits it, not
// the IMAD pipe.
//
// The bucket kernels therefore give each slot a group of kLanes = 4
// threads (the gather-sum form 4 such groups an output, below) that share
// its field products (ec_lanes.cuh): 8448 slots make 8 warps an SM, each
// lane holds 3 words of a BLS12-381 element instead of 12 (68 registers
// against 188-218 for kernel 1), and a chain of adds runs ~4x faster.  The lanes shuffle over
// the whole warp, so the kernels keep warp-uniform control flow: an empty
// slot or a padded column is computed with the others and dropped by a
// select, or (kernels 2 and 4) adds the identity row.  On an NVIDIA H100
// (700 W) 4 lanes beat 1 and 2 in every kernel, and with masks of single
// groups 1 lane had beaten 4 (PERF.md section 6).  Only pairwise kernel 3
// keeps one thread a point.
// The bucket kernels gather their rows themselves from the packed point
// table by the slot grid's point ids, so no (R_c*S, 2NL or 3NL) row tensor
// is built per launch.  The table stays in the 50 MB L2 (6.3 MB at
// n = 2^16 affine, 18.9 MB for the IPA's 131074 projective rows); a
// pre-reduced one (W*n rows, 311 MB at n = 2^16) does not.  The sequential
// forms move the combine's Python loops of batched adds into one launch
// each, in the Python loop's order, so the words match.
// The window totals and the Horner are lone chains: a few dozen windows,
// one or two sets, each a chain of dependent adds and doublings (65 and
// 288 at c = 8), on almost no threads, so their time is the latency of
// each operation.  They run one chain a warp (ec_lanes.cuh `WarpLevels`):
// the independent products of one group operation run at once, each on a
// group of 4 lanes (the CIOS product the other kernels run), so an add
// takes the latency of 2 products (3 for a != 0), not 12 (18); doublings
// take RCB16's dedicated doubling (`ec_dbl_l`: algorithm 9, 8 products in
// 2 levels; algorithm 3 for a != 0), and the window totals run their 4
// chains (rows' and columns' running sums and totals) on 4 warps at once.
// The row and column sums are chains of 16 adds (c = 8) over 1024-3072
// outputs: one group an output left the card nearly empty and paid an
// add's latency on 4 lanes 16 times, so the gather-sum form runs 4 groups
// an output, 2 of each add's 6 products at once on each (`SplitLevels`;
// on an NVIDIA H100 as fast as a warp an output at 1024 outputs and 0.71x
// its time at 2048, where a warp an output runs out of issue slots), the
// next column loaded during the add.  The folds (tens of thousands of
// outputs of 2 columns, or 8 on ed25519) run the same layout: there it
// ties one group an output, or beats it (PERF.md section 6).
// The pre-reduction's passes add a pair only where two entries of one
// bucket merge: from ~W*n/2 adds in the first pass to a few hundred in
// the last, and for the bit vector (one window of nonzero digits in 33)
// a small share of the table.  Each warp takes a tile of 32 entries, finds
// the merging ones by a ballot and adds them 8 at a time, one a group; the
// first pass also writes the whole table from the points by id, so the
// table is written once (311 MB at n = 2^16, its bound).

#include "ec_common.cuh"
#include "ec_lanes.cuh"

// This file is built twice (ops/build.py), into two libraries that nvcc
// builds in parallel: as itself, kernels 1-4 for a = 0 (NL = 12 and 8),
// and through ec_kernels_a.cu, which defines BP_GENERAL_A, kernels 2, 3
// and 4 for a != 0 (NL = 8), their C functions named with "_a" at the end.
#ifdef BP_GENERAL_A
#define BP_C_NAME(name) name##_a
#else
#define BP_C_NAME(name) name
#endif

namespace {

#ifdef BP_GENERAL_A
constexpr Fields kBuilt = Fields::kGeneralA;
#else
constexpr Fields kBuilt = Fields::kA0;
#endif

constexpr int kSumGroups = 4;               // groups of 4 lanes an output
constexpr int kSumBlock = 4 * 32;           // of the gather-sum form
constexpr int kPreBlock = 4 * 32;           // of the pre-reduction form

// out, acc (3, NL, S); table (n, 2NL) affine rows; ids, found (R_c, S),
// round-major.  A group of kLanes lanes per slot loops over the R_c rounds
// with its accumulator in registers, loading the row of point ids[r, s]
// from the table; empty slots keep the accumulator (a warp whose slots
// are all empty skips the round; otherwise an empty slot's add is computed
// from row 0 and dropped).  out may alias acc.
template <int NL>
__global__ void __launch_bounds__(kSlotBlock)
bucket_rounds_mixed_kernel(uint32_t* out, const uint32_t* acc,
                           const uint32_t* table, const int32_t* ids,
                           const int32_t* found, int S, int R_c,
                           Field<NL> f) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    bool mine;
    const long long s = group_index(S, mine);
    const FieldL<NL> fl(f, ln.j);
    uint32_t X[K], Y[K], Z[K], sX[K], sY[K], sZ[K], x2[K], y2[K];
    load_point_l<NL>(X, Y, Z, acc, S, s, ln.j);
    for (int r = 0; r < R_c; r++) {
        const size_t slot = (size_t)r * S + s;
        const bool live = mine && found[slot] != 0;
        if (!warp_needs(live)) continue;
        const uint32_t* row = table + (size_t)(live ? ids[slot] : 0)
                              * (2 * NL) + ln.j * K;
#pragma unroll
        for (int k = 0; k < K; k++) {
            x2[k] = row[k];
            y2[k] = row[NL + k];
        }
        copy_point_l<NL>(sX, sY, sZ, X, Y, Z);
        ec_madd_l<NL>(sX, sY, sZ, x2, y2, fl, ln);
        select_point_l<NL>(X, Y, Z, !live, sX, sY, sZ);
    }
    if (mine) store_point_l<NL>(out, S, s, X, Y, Z, ln.j);
}

// out, acc (3, NL, S); table (n, 3NL) projective rows; ids, found (R_c, S),
// round-major.  A group of kLanes lanes per slot loops over the R_c rounds
// with its accumulator in registers, adding row ids[r, s] of the table or
// the identity where found[r, s] is 0 (`proj_round_l`).  out may alias acc.
template <int NL, bool GA>
__global__ void __launch_bounds__(kSlotBlock)
bucket_rounds_proj_kernel(uint32_t* out, const uint32_t* acc,
                          const uint32_t* table, const int32_t* ids,
                          const int32_t* found, int S, int R_c,
                          Field<NL> f,
                          const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    bool mine;
    const long long s = group_index(S, mine);
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    uint32_t X[K], Y[K], Z[K];
    load_point_l<NL>(X, Y, Z, acc, S, s, ln.j);
    for (int r = 0; r < R_c; r++) {
        const size_t slot = (size_t)r * S + s;
        const bool live = mine && found[slot] != 0;
        proj_round_l<NL, GA>(X, Y, Z, table, live ? ids[slot] : 0, live,
                             fl, ln);
    }
    if (mine) store_point_l<NL>(out, S, s, X, Y, Z, ln.j);
}

// One bucket round (the per-round form of the bucket pass): out, acc
// (3, NL, S); table (n, 3NL); ids, found (S,).  Kernel 2's round, one
// launch, one accumulator load and one store per round.  out may alias
// acc.
template <int NL, bool GA>
__global__ void __launch_bounds__(kSlotBlock)
bucket_round_add_kernel(uint32_t* out, const uint32_t* acc,
                        const uint32_t* table, const int32_t* ids,
                        const int32_t* found, int S, Field<NL> f,
                        const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    bool mine;
    const long long s = group_index(S, mine);
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    uint32_t X[K], Y[K], Z[K];
    load_point_l<NL>(X, Y, Z, acc, S, s, ln.j);
    const bool live = mine && found[s] != 0;
    proj_round_l<NL, GA>(X, Y, Z, table, live ? ids[s] : 0, live, fl, ln);
    if (mine) store_point_l<NL>(out, S, s, X, Y, Z, ln.j);
}

// out = P + Q elementwise over n points, all (3, NL, n); ragged n is masked.
template <int NL, bool GA>
__global__ void __launch_bounds__(kThreads)
ec_add_kernel(uint32_t* out, const uint32_t* P, const uint32_t* Q,
              long long n, Field<NL> f,
              const __grid_constant__ CurveA<NL> ca) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t X1[NL], Y1[NL], Z1[NL], X2[NL], Y2[NL], Z2[NL];
    load_point<NL>(X1, Y1, Z1, P, (size_t)n, (size_t)i);
    load_point<NL>(X2, Y2, Z2, Q, (size_t)n, (size_t)i);
    ec_add_inplace<NL, GA>(X1, Y1, Z1, X2, Y2, Z2, f, ca);
    store_point<NL>(out, (size_t)n, (size_t)i, X1, Y1, Z1);
}

// out (3, NL, n_out): out[o] = the columns idx[o, 0..m-1] of P
// (3, NL, ncols) added left to right, -1 entries skipped.  The chain starts
// from the identity when from_identity (identity + P[first] + ...), else
// from the first listed column itself; a row with no column gives the
// identity.  kSumGroups = 4 groups of 4 lanes an output (half a warp, 2
// outputs a warp): each add's levels of 6 products spread over the
// output's groups, 2 products at once on each (`SplitLevels`: `ec_add_lv`,
// the same words as `ec_add_l`), the next column's point loaded while the
// add runs.  A warp's outputs have their own column lists, so the loop
// runs every column for the whole warp and keeps each result by a select
// (a warp runs the add when any of its outputs adds).
template <int NL, bool GA>
__global__ void __launch_bounds__(kSumBlock)
ec_gather_sum_kernel(uint32_t* out, const uint32_t* P, const int32_t* idx,
                     int n_out, int m, long long ncols, int from_identity,
                     Field<NL> f,
                     const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    const SplitLevels<NL, kSumGroups> lv;
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    const long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                        / (kSumGroups * kLanes);
    const bool mine = t < n_out;
    const long long o = mine ? t : n_out - 1;
    const int32_t* row = idx + (size_t)o * m;
    uint32_t X[K], Y[K], Z[K], sX[K], sY[K], sZ[K];
    uint32_t x2[K], y2[K], z2[K], x3[K], y3[K], z3[K];
    identity_l<NL>(X, Y, Z, fl);
    bool started = from_identity != 0;
    int next = row[0];
    load_point_l<NL>(x3, y3, z3, P, (size_t)ncols,
                     (size_t)(next >= 0 ? next : 0), ln.j);
    for (int j = 0; j < m; j++) {
        const int id = next;
        copy_point_l<NL>(x2, y2, z2, x3, y3, z3);
        if (j + 1 < m) {
            next = row[j + 1];
            load_point_l<NL>(x3, y3, z3, P, (size_t)ncols,
                             (size_t)(next >= 0 ? next : 0), ln.j);
        }
        const bool take = mine && id >= 0;
        const bool adds = take && started;
        if (!warp_needs(take)) continue;
        if (warp_needs(adds)) {
            copy_point_l<NL>(sX, sY, sZ, X, Y, Z);
            ec_add_lv<NL, GA>(sX, sY, sZ, x2, y2, z2, fl, ln, lv);
            select_point_l<NL>(X, Y, Z, !adds, sX, sY, sZ);
        }
        select_point_l<NL>(X, Y, Z, !(take && !started), x2, y2, z2);
        started = started || take;
    }
    if (mine && (ln.base / kLanes) % kSumGroups == 0)
        store_point_l<NL>(out, n_out, o, X, Y, Z, ln.j);
}

// One pass of the MSM's pre-reduction on kernel 2's table (W*n, 3NL), row
// w*n + i the point at sorted position i of window w: row i += row
// i + 2^pass (the complete add, in that operand order) where the entry
// merges: its rank within its digit is a multiple of 2^(pass+1), its digit
// is not 0 and the entry 2^pass places on in the window's row has the same
// digit.  Every other row keeps its words.  Pass 0 also writes the table:
// row w*n + i is row perm[w*n + i] of `rows` (n, 3NL), the points by id,
// and its adds read their operands from `rows`; later passes run in place,
// which is safe: no row i + 2^pass is written in a pass (its rank is 2^pass
// mod 2^(pass+1)).  perm, digits, rank (W*n) int64, window-major.
//
// Only merging entries cost an add.  A warp takes a tile of 32 entries,
// one a lane (pass 0 first copies the tile's 32 rows, 16 bytes a lane a
// step), and ballots the merging ones (at most 16 a tile: a merging entry
// and its partner are both in its run); then its 8 groups add them 8 at a
// time, group g the g-th lowest left.  A group with none left adds the
// first one's rows again and stores nothing (warp-uniform control flow); a
// warp with none returns.
template <int NL, bool GA>
__global__ void __launch_bounds__(kPreBlock)
ec_pre_reduce_kernel(uint32_t* table, const uint32_t* rows,
                     const long long* perm, const long long* digits,
                     const long long* rank, int W, int n, int pass,
                     Field<NL> f, const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    constexpr int kGroups = 32 / kLanes;
    constexpr int kRow = 3 * NL;                 // words a row
    constexpr int kVec = kRow / 4;               // 16-byte pieces a row
    const long long entries = (long long)W * n;
    const long long tile = ((long long)blockIdx.x * blockDim.x
                            + threadIdx.x) & ~31ll;
    const int lane = threadIdx.x & 31;
    const long long i = tile + lane;
    const int shift = 1 << pass;
    if (pass == 0) {
        for (int v = lane; v < 32 * kVec; v += 32) {
            const long long e = tile + v / kVec;
            if (e < entries)
                reinterpret_cast<uint4*>(table + e * kRow)[v % kVec] =
                    reinterpret_cast<const uint4*>(
                        rows + perm[e] * kRow)[v % kVec];
        }
        __syncwarp();
    }
    bool merge = false;
    if (i < entries) {
        const long long d = digits[i];
        merge = d != 0 && (rank[i] & (2 * shift - 1)) == 0
                && (int)(i % n) + shift < n && digits[i + shift] == d;
    }
    uint32_t todo = __ballot_sync(kWarp, merge);
    if (todo == 0) return;                       // the whole warp
    const Lanes ln;
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    const int g = ln.base / kLanes;
    while (todo != 0) {
        uint32_t left = todo;
        for (int k = 0; k < g; k++) left &= left - 1;
        const bool live = left != 0;
        const long long e = tile + __ffs(live ? left : todo) - 1;
        const uint32_t* p1 = pass == 0 ? rows + perm[e] * kRow
                                       : table + e * kRow;
        const uint32_t* p2 = pass == 0 ? rows + perm[e + 1] * kRow
                                       : table + (e + shift) * kRow;
        uint32_t X[K], Y[K], Z[K], x2[K], y2[K], z2[K];
#pragma unroll
        for (int k = 0; k < K; k++) {
            const int w = ln.j * K + k;
            X[k] = p1[w];
            Y[k] = p1[NL + w];
            Z[k] = p1[2 * NL + w];
            x2[k] = p2[w];
            y2[k] = p2[NL + w];
            z2[k] = p2[2 * NL + w];
        }
        ec_add_l<NL, GA>(X, Y, Z, x2, y2, z2, fl, ln);
        if (live) {
            uint32_t* out = table + e * kRow + ln.j * K;
#pragma unroll
            for (int k = 0; k < K; k++) {
                out[k] = X[k];
                out[NL + k] = Y[k];
                out[2 * NL + k] = Z[k];
            }
        }
        for (int k = 0; k < kGroups; k++) todo &= todo - 1;
    }
}

// The lone chains' blocks: a warp a chain (`WarpLevels`).  The window
// totals give each window 4 warps, one a chain; the Horner one warp a set.
constexpr int kTotalsBlock = 4 * 32;
constexpr int kHornerBlock = 32;

// A point that every group of the warp holds, into shared memory as its
// X, Y, Z words (3NL): group 0 writes it.
template <int NL>
__device__ __forceinline__ void share_point_l(uint32_t* sh, const uint32_t* X,
                                              const uint32_t* Y,
                                              const uint32_t* Z,
                                              const Lanes& ln) {
    constexpr int K = NL / kLanes;
    if (ln.base == 0) {
#pragma unroll
        for (int k = 0; k < K; k++) {
            sh[ln.j * K + k] = X[k];
            sh[NL + ln.j * K + k] = Y[k];
            sh[2 * NL + ln.j * K + k] = Z[k];
        }
    }
}

template <int NL>
__device__ __forceinline__ void shared_point_l(uint32_t* X, uint32_t* Y,
                                               uint32_t* Z,
                                               const uint32_t* sh, int j) {
    constexpr int K = NL / kLanes;
#pragma unroll
    for (int k = 0; k < K; k++) {
        X[k] = sh[j * K + k];
        Y[k] = sh[NL + j * K + k];
        Z[k] = sh[2 * NL + j * K + k];
    }
}

// out (3, NL, W): per window w, wr = sum_g g*rowsum[w, g] and
// wc = sum_k k*colsum[w, k] by descending running sums (running +=
// arr[m-1-t]; total += running, from the identity), then dbl doublings of
// wr and wr + wc.  rowsum (3, NL, W*G), colsum (3, NL, W*Kc).
//
// One block a window, one warp a chain: warp 0 the rows' running sum,
// warp 1 their total, warps 2 and 3 the columns'.  At step s a running
// warp forms running_{s+1} = running_s + arr[m-1-s] while its total warp
// forms total_s = total_{s-1} + running_s from the shared copy of the
// step before (two buffers, one barrier a step), so the 4 chains of
// _weighted_sum_plain's adds, on the same operands in the same order,
// take max(G, Kc) steps of one add, not 2(G-1) + 2(Kc-1) adds in a row.
// Warp 1 then doubles its total dbl times (`ec_dbl_l`, the words of
// wr + wr on these points) and adds the columns' total.
template <int NL, bool GA>
__global__ void __launch_bounds__(kTotalsBlock)
ec_window_totals_kernel(uint32_t* out, const uint32_t* rowsum,
                        const uint32_t* colsum, int W, int G, int Kc,
                        int dbl, Field<NL> f,
                        const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    __shared__ uint32_t running[2][2][3 * NL];   // [axis][step & 1]
    __shared__ uint32_t col_total[3 * NL];
    const Lanes ln;
    const WarpLevels<NL> lv;
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    const int w = blockIdx.x;
    const int warp = threadIdx.x / 32;
    const int axis = warp >> 1;                  // 0 rows, 1 columns
    const bool total = warp & 1;
    const uint32_t* arr = axis ? colsum : rowsum;
    const int m = axis ? Kc : G;
    const size_t stride = (size_t)W * m;
    uint32_t X[K], Y[K], Z[K], x2[K], y2[K], z2[K];
    identity_l<NL>(X, Y, Z, fl);
    if (!total && m > 1)
        load_point_l<NL>(x2, y2, z2, arr, stride, (size_t)w * m + m - 1,
                         ln.j);
    const int steps = G > Kc ? G : Kc;
    for (int s = 0; s < steps; s++) {
        if (!total && s < m - 1) {
            ec_add_lv<NL, GA>(X, Y, Z, x2, y2, z2, fl, ln, lv);
            share_point_l<NL>(running[axis][s & 1], X, Y, Z, ln);
            if (s + 1 < m - 1)
                load_point_l<NL>(x2, y2, z2, arr, stride,
                                 (size_t)w * m + m - 2 - s, ln.j);
        } else if (total && s >= 1 && s < m) {
            shared_point_l<NL>(x2, y2, z2, running[axis][(s - 1) & 1],
                               ln.j);
            ec_add_lv<NL, GA>(X, Y, Z, x2, y2, z2, fl, ln, lv);
        }
        __syncthreads();
    }
    if (warp == 3) share_point_l<NL>(col_total, X, Y, Z, ln);
    if (warp == 1) {
        for (int d = 0; d < dbl; d++) ec_dbl_l<NL, GA>(X, Y, Z, fl, ln, lv);
    }
    __syncthreads();
    if (warp == 1) {
        shared_point_l<NL>(x2, y2, z2, col_total, ln.j);
        ec_add_lv<NL, GA>(X, Y, Z, x2, y2, z2, fl, ln, lv);
        if (ln.base == 0) store_point_l<NL>(out, W, w, X, Y, Z, ln.j);
    }
}

// out (3, NL, n_sets): per set, Horner over its wps window totals from the
// highest: acc = identity; acc = 2^c acc (c doublings), then
// acc + totals[set, w], for w = wps-1 .. 0.  totals (3, NL, n_sets*wps).
// One warp a set (`WarpLevels`), the next total loaded during the
// doublings.  The c doublings of the opening identity are skipped: the
// identity doubles to itself exactly, by either doubling; its first add
// is not (it scales the triple by the total's Y).
template <int NL, bool GA>
__global__ void __launch_bounds__(kHornerBlock)
ec_horner_kernel(uint32_t* out, const uint32_t* totals, int n_sets, int wps,
                 int c, Field<NL> f,
                 const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    const WarpLevels<NL> lv;
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    const int set = blockIdx.x;
    const size_t stride = (size_t)n_sets * wps;
    uint32_t X[K], Y[K], Z[K], x2[K], y2[K], z2[K], x3[K], y3[K], z3[K];
    identity_l<NL>(X, Y, Z, fl);
    load_point_l<NL>(x2, y2, z2, totals, stride,
                     (size_t)set * wps + wps - 1, ln.j);
    for (int w = wps - 1; w >= 0; w--) {
        if (w > 0)
            load_point_l<NL>(x3, y3, z3, totals, stride,
                             (size_t)set * wps + w - 1, ln.j);
        if (w < wps - 1) {
            for (int d = 0; d < c; d++)
                ec_dbl_l<NL, GA>(X, Y, Z, fl, ln, lv);
        }
        ec_add_lv<NL, GA>(X, Y, Z, x2, y2, z2, fl, ln, lv);
        if (w > 0) copy_point_l<NL>(x2, y2, z2, x3, y3, z3);
    }
    if (ln.base == 0) store_point_l<NL>(out, n_sets, set, X, Y, Z, ln.j);
}

}  // namespace

extern "C" {

// Each launch function returns cudaGetLastError() after the launch (0 when
// the launch was accepted); a field other than those `launch_field` names
// gives cudaErrorInvalidValue, and so does an a != 0 one for kernel 1.
// consts: the group kernels' (`make_field`, then `make_curve_a`).

#ifndef BP_GENERAL_A
int BP_C_NAME(bp_bucket_rounds_mixed)(
    void* out, const void* acc, const void* table, const void* ids,
    const void* found, int S, int R_c, int nl, const void* consts,
    void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* c = static_cast<const uint32_t*>(consts);
    if (S <= 0 || R_c <= 0 || (nl != 12 && nl != 8) || general_a(nl, c))
        return (int)cudaErrorInvalidValue;
    const unsigned grid = groups_grid(S, kSlotBlock);
    if (nl == 12) {
        bucket_rounds_mixed_kernel<12><<<grid, kSlotBlock, 0, st>>>(
            static_cast<uint32_t*>(out), static_cast<const uint32_t*>(acc),
            static_cast<const uint32_t*>(table),
            static_cast<const int32_t*>(ids),
            static_cast<const int32_t*>(found), S, R_c, make_field<12>(c));
    } else {
        bucket_rounds_mixed_kernel<8><<<grid, kSlotBlock, 0, st>>>(
            static_cast<uint32_t*>(out), static_cast<const uint32_t*>(acc),
            static_cast<const uint32_t*>(table),
            static_cast<const int32_t*>(ids),
            static_cast<const int32_t*>(found), S, R_c, make_field<8>(c));
    }
    return (int)cudaGetLastError();
}
#endif

int BP_C_NAME(bp_bucket_rounds_proj)(
    void* out, const void* acc, const void* table, const void* ids,
    const void* found, int S, int R_c, int nl, const void* consts,
    void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (S <= 0 || R_c <= 0) return (int)cudaErrorInvalidValue;
    const unsigned grid = groups_grid(S, kSlotBlock);
    return launch_field<kBuilt>(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto ca, auto ga) {
        bucket_rounds_proj_kernel<decltype(f)::kWords, decltype(ga)::value>
            <<<grid, kSlotBlock, 0, st>>>(
                static_cast<uint32_t*>(out),
                static_cast<const uint32_t*>(acc),
                static_cast<const uint32_t*>(table),
                static_cast<const int32_t*>(ids),
                static_cast<const int32_t*>(found), S, R_c, f, ca);
    });
}

int BP_C_NAME(bp_ec_add)(
    void* out, const void* P, const void* Q, long long n, int nl,
    const void* consts, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n <= 0) return (int)cudaErrorInvalidValue;
    return launch_field<kBuilt>(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto ca, auto ga) {
        ec_add_kernel<decltype(f)::kWords, decltype(ga)::value>
            <<<grid_for(n), kThreads, 0, st>>>(
                static_cast<uint32_t*>(out), static_cast<const uint32_t*>(P),
                static_cast<const uint32_t*>(Q), n, f, ca);
    });
}

int BP_C_NAME(bp_bucket_round_add)(
    void* out, const void* acc, const void* table, const void* ids,
    const void* found, int S, int nl, const void* consts, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (S <= 0) return (int)cudaErrorInvalidValue;
    const unsigned grid = groups_grid(S, kSlotBlock);
    return launch_field<kBuilt>(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto ca, auto ga) {
        bucket_round_add_kernel<decltype(f)::kWords, decltype(ga)::value>
            <<<grid, kSlotBlock, 0, st>>>(
                static_cast<uint32_t*>(out),
                static_cast<const uint32_t*>(acc),
                static_cast<const uint32_t*>(table),
                static_cast<const int32_t*>(ids),
                static_cast<const int32_t*>(found), S, f, ca);
    });
}

int BP_C_NAME(bp_ec_gather_sum)(
    void* out, const void* P, const void* idx, int n_out, int m,
    long long ncols, int from_identity, int nl, const void* consts,
    void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n_out <= 0 || m <= 0 || ncols <= 0) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(((long long)n_out * kSumGroups * kLanes
                                      + kSumBlock - 1) / kSumBlock);
    return launch_field<kBuilt>(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto ca, auto ga) {
        ec_gather_sum_kernel<decltype(f)::kWords, decltype(ga)::value>
            <<<grid, kSumBlock, 0, st>>>(
                static_cast<uint32_t*>(out), static_cast<const uint32_t*>(P),
                static_cast<const int32_t*>(idx), n_out, m, ncols,
                from_identity, f, ca);
    });
}

int BP_C_NAME(bp_ec_pre_reduce)(
    void* table, const void* rows, const void* perm, const void* digits,
    const void* rank, int W, int n, int pass, int nl, const void* consts,
    void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (W <= 0 || n <= 0 || pass < 0 || pass > 30)
        return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(((long long)W * n + kPreBlock - 1)
                                     / kPreBlock);
    return launch_field<kBuilt>(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto ca, auto ga) {
        ec_pre_reduce_kernel<decltype(f)::kWords, decltype(ga)::value>
            <<<grid, kPreBlock, 0, st>>>(
                static_cast<uint32_t*>(table),
                static_cast<const uint32_t*>(rows),
                static_cast<const long long*>(perm),
                static_cast<const long long*>(digits),
                static_cast<const long long*>(rank), W, n, pass, f, ca);
    });
}

int BP_C_NAME(bp_ec_window_totals)(
    void* out, const void* rowsum, const void* colsum, int W, int G, int Kc,
    int dbl, int nl, const void* consts, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (W <= 0 || G <= 0 || Kc <= 0 || dbl < 0)
        return (int)cudaErrorInvalidValue;
    return launch_field<kBuilt>(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto ca, auto ga) {
        ec_window_totals_kernel<decltype(f)::kWords, decltype(ga)::value>
            <<<W, kTotalsBlock, 0, st>>>(
                static_cast<uint32_t*>(out),
                static_cast<const uint32_t*>(rowsum),
                static_cast<const uint32_t*>(colsum), W, G, Kc, dbl, f, ca);
    });
}

int BP_C_NAME(bp_ec_horner)(
    void* out, const void* totals, int n_sets, int wps, int c, int nl,
    const void* consts, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n_sets <= 0 || wps <= 0 || c < 0) return (int)cudaErrorInvalidValue;
    return launch_field<kBuilt>(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto ca, auto ga) {
        ec_horner_kernel<decltype(f)::kWords, decltype(ga)::value>
            <<<n_sets, kHornerBlock, 0, st>>>(
                static_cast<uint32_t*>(out),
                static_cast<const uint32_t*>(totals), n_sets, wps, c, f, ca);
    });
}

}  // extern "C"
