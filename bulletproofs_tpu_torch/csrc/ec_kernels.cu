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
//   bp_ec_gather_sum        the axis sums and the two folds
//   bp_ec_window_totals     the weighted running sums, doublings and add
//   bp_ec_horner            the window Horner over the sets
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
// The bucket kernels and the sequential forms therefore give each slot or
// output a group of kLanes = 4 threads that share its field products
// (ec_lanes.cuh): 8448 slots make 8 warps an SM, each lane holds 3 words of
// a BLS12-381 element instead of 12 (68 registers against 188-218 for
// kernel 1), and a chain of adds runs ~4x faster.  The lanes shuffle over
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
// each: one group owns one output and runs its chain of adds in
// registers, in the Python loop's order, so the words match.  They run a
// few dozen to a few thousand groups: latency-bound by design.

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

constexpr int kSumBlock = 64;               // of the sequential forms

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
// identity.  One group per output.
template <int NL, bool GA>
__global__ void __launch_bounds__(kSumBlock)
ec_gather_sum_kernel(uint32_t* out, const uint32_t* P, const int32_t* idx,
                     int n_out, int m, long long ncols, int from_identity,
                     Field<NL> f,
                     const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    bool mine;
    const long long o = group_index(n_out, mine);
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    uint32_t X[K], Y[K], Z[K], sX[K], sY[K], sZ[K], x2[K], y2[K], z2[K];
    identity_l<NL>(X, Y, Z, fl);
    bool started = from_identity != 0;
    for (int j = 0; j < m; j++) {
        const int id = idx[(size_t)o * m + j];
        const bool take = mine && id >= 0;
        // the first column is taken as it is; later ones are added (a
        // warp runs the add when any of its groups adds)
        const bool adds = take && started;
        if (!warp_needs(take)) continue;
        load_point_l<NL>(x2, y2, z2, P, (size_t)ncols,
                            (size_t)(take ? id : 0), ln.j);
        if (warp_needs(adds)) {
            copy_point_l<NL>(sX, sY, sZ, X, Y, Z);
            ec_add_l<NL, GA>(sX, sY, sZ, x2, y2, z2, fl, ln);
            select_point_l<NL>(X, Y, Z, !adds, sX, sY, sZ);
        }
        select_point_l<NL>(X, Y, Z, !(take && !started), x2, y2, z2);
        started = started || take;
    }
    if (mine) store_point_l<NL>(out, n_out, o, X, Y, Z, ln.j);
}

// out (3, NL, W): per window w, wr = sum_g g*rowsum[w, g] and
// wc = sum_k k*colsum[w, k] by descending running sums (running +=
// arr[m-1-t]; total += running, from the identity), then dbl doublings of
// wr (wr + wr) and wr + wc.  rowsum (3, NL, W*G), colsum (3, NL, W*Kc).
// The two chains are independent and share the loop, so their adds can
// overlap.  One group per window.
template <int NL, bool GA>
__global__ void __launch_bounds__(kSumBlock)
ec_window_totals_kernel(uint32_t* out, const uint32_t* rowsum,
                        const uint32_t* colsum, int W, int G, int Kc,
                        int dbl, Field<NL> f,
                        const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    bool mine;
    const long long w = group_index(W, mine);
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    uint32_t rX[K], rY[K], rZ[K], tX[K], tY[K], tZ[K];    // rows' chain
    uint32_t cX[K], cY[K], cZ[K], uX[K], uY[K], uZ[K];    // columns' chain
    uint32_t x2[K], y2[K], z2[K];
    identity_l<NL>(rX, rY, rZ, fl);
    identity_l<NL>(tX, tY, tZ, fl);
    identity_l<NL>(cX, cY, cZ, fl);
    identity_l<NL>(uX, uY, uZ, fl);
    const int steps = (G > Kc ? G : Kc) - 1;
    for (int t = 0; t < steps; t++) {
        if (t < G - 1) {
            load_point_l<NL>(x2, y2, z2, rowsum, (size_t)W * G,
                                (size_t)w * G + (G - 1 - t), ln.j);
            ec_add_l<NL, GA>(rX, rY, rZ, x2, y2, z2, fl, ln);
            ec_add_l<NL, GA>(tX, tY, tZ, rX, rY, rZ, fl, ln);
        }
        if (t < Kc - 1) {
            load_point_l<NL>(x2, y2, z2, colsum, (size_t)W * Kc,
                                (size_t)w * Kc + (Kc - 1 - t), ln.j);
            ec_add_l<NL, GA>(cX, cY, cZ, x2, y2, z2, fl, ln);
            ec_add_l<NL, GA>(uX, uY, uZ, cX, cY, cZ, fl, ln);
        }
    }
    for (int d = 0; d < dbl; d++) {
        copy_point_l<NL>(x2, y2, z2, tX, tY, tZ);
        ec_add_l<NL, GA>(tX, tY, tZ, x2, y2, z2, fl, ln);
    }
    ec_add_l<NL, GA>(tX, tY, tZ, uX, uY, uZ, fl, ln);
    if (mine) store_point_l<NL>(out, W, w, tX, tY, tZ, ln.j);
}

// out (3, NL, n_sets): per set, Horner over its wps window totals from the
// highest: acc = identity; acc = 2^c acc (c doublings acc + acc), then
// acc + totals[set, w], for w = wps-1 .. 0.  totals (3, NL, n_sets*wps).
// One group per set.
template <int NL, bool GA>
__global__ void __launch_bounds__(kSumBlock)
ec_horner_kernel(uint32_t* out, const uint32_t* totals, int n_sets, int wps,
                 int c, Field<NL> f,
                 const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    bool mine;
    const long long set = group_index(n_sets, mine);
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    uint32_t X[K], Y[K], Z[K], x2[K], y2[K], z2[K];
    identity_l<NL>(X, Y, Z, fl);
    for (int w = wps - 1; w >= 0; w--) {
        for (int d = 0; d < c; d++) {
            copy_point_l<NL>(x2, y2, z2, X, Y, Z);
            ec_add_l<NL, GA>(X, Y, Z, x2, y2, z2, fl, ln);
        }
        load_point_l<NL>(x2, y2, z2, totals, (size_t)n_sets * wps,
                            (size_t)set * wps + w, ln.j);
        ec_add_l<NL, GA>(X, Y, Z, x2, y2, z2, fl, ln);
    }
    if (mine) store_point_l<NL>(out, n_sets, set, X, Y, Z, ln.j);
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
    const unsigned grid = groups_grid(n_out, kSumBlock);
    return launch_field<kBuilt>(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto ca, auto ga) {
        ec_gather_sum_kernel<decltype(f)::kWords, decltype(ga)::value>
            <<<grid, kSumBlock, 0, st>>>(
                static_cast<uint32_t*>(out), static_cast<const uint32_t*>(P),
                static_cast<const int32_t*>(idx), n_out, m, ncols,
                from_identity, f, ca);
    });
}

int BP_C_NAME(bp_ec_window_totals)(
    void* out, const void* rowsum, const void* colsum, int W, int G, int Kc,
    int dbl, int nl, const void* consts, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (W <= 0 || G <= 0 || Kc <= 0 || dbl < 0)
        return (int)cudaErrorInvalidValue;
    const unsigned grid = groups_grid(W, kSumBlock);
    return launch_field<kBuilt>(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto ca, auto ga) {
        ec_window_totals_kernel<decltype(f)::kWords, decltype(ga)::value>
            <<<grid, kSumBlock, 0, st>>>(
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
    const unsigned grid = groups_grid(n_sets, kSumBlock);
    return launch_field<kBuilt>(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto ca, auto ga) {
        ec_horner_kernel<decltype(f)::kWords, decltype(ga)::value>
            <<<grid, kSumBlock, 0, st>>>(
                static_cast<uint32_t*>(out),
                static_cast<const uint32_t*>(totals), n_sets, wps, c, f, ca);
    });
}

}  // extern "C"
