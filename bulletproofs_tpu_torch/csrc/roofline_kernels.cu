// The roofline harness's chain kernel, hand-written for Hopper (sm_90a):
// `iters` dependent steps of the group law (`ec_add_l`) or of the
// Montgomery product (`mont_mul_l`) per 4-lane group, the device functions
// the bucket kernels of ec_kernels.cu run, so the harness times what the
// MSM runs.  Plain C interface, built by nvcc into its own shared library
// beside ec_kernels.cu's and called through ctypes
// (bulletproofs_tpu_torch/ops/build.py, utils/roofline.py).
//
// It replaces no Pallas kernel: its counterpart is the JAX package's XLA
// `fori_loop` chains of bulletproofs_tpu/utils/roofline.py:49-60
// (`_ec_add_chain`, `_mont_mul_chain`), which the JAX bench times against
// a speed-of-light model of the TPU's VPU.  Here the model is the H100's
// IMAD rate (utils/roofline.py).
//
//   bp_ec_add_chain    out = P + P + ... + P (iters adds, acc + P each),
//                      P (3, NL, n) packed projective Montgomery points
//   bp_mont_mul_chain  out = a * a * ... * a (iters products, acc * a),
//                      a (NL, n) packed Montgomery field elements
//
// What bounds it.  The chain is dependent by construction: step t + 1
// needs step t's result.  With one group of 4 lanes a point and n = 8192
// points (8 warps an SM of the 132), the latency of each group's chain of
// products limits it, as it limits the bucket kernels at the MSM's slot
// counts; the IMAD pipe is the bound the harness reports it against.

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

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 when accepted); a
// field other than those `launch_field` names, n <= 0 or iters < 0 gives
// cudaErrorInvalidValue.  consts: the group kernels'
// (ops/ec_kernels.py `_consts`).

int bp_ec_add_chain(void* out, const void* P, long long n, int iters,
                    int nl, const void* consts, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
    const unsigned grid = groups_grid(n, kSlotBlock);
    return launch_field(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto ca, auto ga) {
        ec_add_chain_kernel<decltype(f)::kWords, decltype(ga)::value>
            <<<grid, kSlotBlock, 0, st>>>(
                static_cast<uint32_t*>(out), static_cast<const uint32_t*>(P),
                n, iters, f, ca);
    });
}

int bp_mont_mul_chain(void* out, const void* a, long long n, int iters,
                      int nl, const void* consts, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
    const unsigned grid = groups_grid(n, kSlotBlock);
    return launch_field(nl, static_cast<const uint32_t*>(consts),
                        [&](auto f, auto, auto) {
        mont_mul_chain_kernel<decltype(f)::kWords>
            <<<grid, kSlotBlock, 0, st>>>(
                static_cast<uint32_t*>(out), static_cast<const uint32_t*>(a),
                n, iters, f);
    });
}

}  // extern "C"
