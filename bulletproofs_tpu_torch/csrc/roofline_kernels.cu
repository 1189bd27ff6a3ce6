// The roofline harness's chain kernel, hand-written for Hopper (sm_90a):
// `iters` dependent steps of the group law or of the Montgomery product
// per point, on the device functions the MSM's kernels run, so the harness
// times what the MSM runs.  Plain C interface, built by nvcc into its own
// shared library beside ec_kernels.cu's and called through ctypes
// (bulletproofs_tpu_torch/ops/build.py, utils/roofline.py).
//
// It replaces no Pallas kernel: its counterpart is the JAX package's XLA
// `fori_loop` chains of bulletproofs_tpu/utils/roofline.py:49-60
// (`_ec_add_chain`, `_mont_mul_chain`), which the JAX bench times against
// a speed-of-light model of the TPU's VPU.  Here the model is the H100's
// IMAD rate (utils/roofline.py).
//
//   bp_ec_chain        P (3, NL, n) packed projective Montgomery points;
//                      by `form`:
//                      0 `add`       acc = P + P + ... + P (iters adds,
//                                    acc + P each), `ec_add_l` on a group
//                                    of 4 lanes a point: the bucket
//                                    kernels' add;
//                      1 `dbl`       acc = 2^iters P, `ec_dbl_l` (RCB16's
//                                    dedicated doubling) on a group;
//                      2 `add_warp`  form 0's function, a warp a point
//                                    (`ec_add_lv` on `WarpLevels`): the
//                                    lone chains' add (kernel 3's window
//                                    totals and Horner);
//                      3 `dbl_warp`  form 1's function, a warp a point:
//                                    the lone chains' doubling
//   bp_mont_mul_chain  out = a * a * ... * a (iters products, acc * a),
//                      a (NL, n) packed Montgomery field elements, a group
//                      of 4 lanes an element
//
// What bounds it.  The chain is dependent by construction: step t + 1
// needs step t's result.  With one group of 4 lanes a point and n = 8192
// points (8 warps an SM of the 132), the latency of each group's chain of
// products limits it, as it limits the bucket kernels at the MSM's slot
// counts; the IMAD pipe is the bound the harness reports it against.  At
// n = 1 point (one warp) a step's time is its latency, the floor of the
// lone chains (`roofline.chain_latency`).

#include "ec_lanes.cuh"

namespace {

// out, P (3, NL, n): one group per point, acc = P, then iters times
// acc = acc + P (RCB16 algorithm 7, or algorithm 1 for GA).
template <int NL, bool GA>
__global__ void __launch_bounds__(kSlotBlock)
ec_add_chain_kernel(uint32_t* out, const uint32_t* P, long long n,
                    int iters, Field<NL> f,
                    const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    bool mine;
    const long long i = group_index(n, mine);
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    uint32_t X[K], Y[K], Z[K], pX[K], pY[K], pZ[K];
    load_point_l<NL>(pX, pY, pZ, P, (size_t)n, (size_t)i, ln.j);
    copy_point_l<NL>(X, Y, Z, pX, pY, pZ);
    for (int t = 0; t < iters; t++)
        ec_add_l<NL, GA>(X, Y, Z, pX, pY, pZ, fl, ln);
    if (mine) store_point_l<NL>(out, (size_t)n, (size_t)i, X, Y, Z, ln.j);
}

// out, P (3, NL, n): one group per point, acc = P, then iters times
// acc = 2 acc (`ec_dbl_l`, its products one after another).
template <int NL, bool GA>
__global__ void __launch_bounds__(kSlotBlock)
ec_dbl_chain_kernel(uint32_t* out, const uint32_t* P, long long n,
                    int iters, Field<NL> f,
                    const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    bool mine;
    const long long i = group_index(n, mine);
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    uint32_t X[K], Y[K], Z[K];
    load_point_l<NL>(X, Y, Z, P, (size_t)n, (size_t)i, ln.j);
    for (int t = 0; t < iters; t++) ec_dbl_l<NL, GA>(X, Y, Z, fl, ln);
    if (mine) store_point_l<NL>(out, (size_t)n, (size_t)i, X, Y, Z, ln.j);
}

// The warp of this thread, counted over the grid; warps past the last
// point (`count`) work on the last one and store nothing (`mine` false).
__device__ __forceinline__ long long warp_index(long long count,
                                                bool& mine) {
    const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                        / 32;
    mine = w < count;
    return mine ? w : count - 1;
}

// out, P (3, NL, n): one warp per point (`WarpLevels`), acc = P, then
// iters times acc = acc + P (`ec_add_lv`).
template <int NL, bool GA>
__global__ void __launch_bounds__(kSlotBlock)
warp_add_chain_kernel(uint32_t* out, const uint32_t* P, long long n,
                      int iters, Field<NL> f,
                      const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    const WarpLevels<NL> lv;
    bool mine;
    const long long i = warp_index(n, mine);
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    uint32_t X[K], Y[K], Z[K], pX[K], pY[K], pZ[K];
    load_point_l<NL>(pX, pY, pZ, P, (size_t)n, (size_t)i, ln.j);
    copy_point_l<NL>(X, Y, Z, pX, pY, pZ);
    for (int t = 0; t < iters; t++)
        ec_add_lv<NL, GA>(X, Y, Z, pX, pY, pZ, fl, ln, lv);
    if (mine && ln.base == 0)
        store_point_l<NL>(out, (size_t)n, (size_t)i, X, Y, Z, ln.j);
}

// out, P (3, NL, n): one warp per point, acc = P, then iters times
// acc = 2 acc (`ec_dbl_l` on `WarpLevels`).
template <int NL, bool GA>
__global__ void __launch_bounds__(kSlotBlock)
warp_dbl_chain_kernel(uint32_t* out, const uint32_t* P, long long n,
                      int iters, Field<NL> f,
                      const __grid_constant__ CurveA<NL> ca) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    const WarpLevels<NL> lv;
    bool mine;
    const long long i = warp_index(n, mine);
    const FieldL<NL> fl = field_l<NL, GA>(f, ca, ln.j);
    uint32_t X[K], Y[K], Z[K];
    load_point_l<NL>(X, Y, Z, P, (size_t)n, (size_t)i, ln.j);
    for (int t = 0; t < iters; t++) ec_dbl_l<NL, GA>(X, Y, Z, fl, ln, lv);
    if (mine && ln.base == 0)
        store_point_l<NL>(out, (size_t)n, (size_t)i, X, Y, Z, ln.j);
}

// out, a (NL, n): one group per element, acc = a, then iters times
// acc = acc * a * R^-1 (CIOS).
template <int NL>
__global__ void __launch_bounds__(kSlotBlock)
mont_mul_chain_kernel(uint32_t* out, const uint32_t* a, long long n,
                      int iters, Field<NL> f) {
    constexpr int K = NL / kLanes;
    const Lanes ln;
    bool mine;
    const long long i = group_index(n, mine);
    const FieldL<NL> fl(f, ln.j);
    uint32_t x[K], acc[K];
#pragma unroll
    for (int k = 0; k < K; k++) {
        x[k] = a[(size_t)(ln.j * K + k) * n + i];
        acc[k] = x[k];
    }
    for (int t = 0; t < iters; t++) mont_mul_l<NL>(acc, acc, x, fl, ln);
    if (mine) {
#pragma unroll
        for (int k = 0; k < K; k++)
            out[(size_t)(ln.j * K + k) * n + i] = acc[k];
    }
}

// The block of a chain launch of `threads` threads: kSlotBlock, or fewer
// for a short chain, so that one point runs on one warp alone.
int chain_block(long long threads) {
    return threads >= kSlotBlock ? kSlotBlock
                                 : (int)((threads + 31) / 32 * 32);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 when accepted); a
// field other than those `launch_field` names, n <= 0, iters < 0 or an
// unknown form gives cudaErrorInvalidValue.  consts: the group kernels'
// (ops/ec_kernels.py `_consts`).

int bp_ec_chain(void* out, const void* P, long long n, int iters, int form,
                int nl, const void* consts, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n <= 0 || iters < 0 || form < 0 || form > 3)
        return (int)cudaErrorInvalidValue;
    const long long threads = n * (form < 2 ? kLanes : 32);
    const int block = chain_block(threads);
    const unsigned grid = (unsigned)((threads + block - 1) / block);
    return launch_field(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto ca, auto ga) {
        constexpr int NL = decltype(f)::kWords;
        constexpr bool GA = decltype(ga)::value;
        uint32_t* o = static_cast<uint32_t*>(out);
        const uint32_t* p = static_cast<const uint32_t*>(P);
        if (form == 0)
            ec_add_chain_kernel<NL, GA><<<grid, block, 0, st>>>(
                o, p, n, iters, f, ca);
        else if (form == 1)
            ec_dbl_chain_kernel<NL, GA><<<grid, block, 0, st>>>(
                o, p, n, iters, f, ca);
        else if (form == 2)
            warp_add_chain_kernel<NL, GA><<<grid, block, 0, st>>>(
                o, p, n, iters, f, ca);
        else
            warp_dbl_chain_kernel<NL, GA><<<grid, block, 0, st>>>(
                o, p, n, iters, f, ca);
    });
}

int bp_mont_mul_chain(void* out, const void* a, long long n, int iters,
                      int nl, const void* consts, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
    const int block = chain_block(n * kLanes);
    const unsigned grid = groups_grid(n, block);
    return launch_field(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto, auto) {
        mont_mul_chain_kernel<decltype(f)::kWords>
            <<<grid, block, 0, st>>>(
                static_cast<uint32_t*>(out), static_cast<const uint32_t*>(a),
                n, iters, f);
    });
}

}  // extern "C"
