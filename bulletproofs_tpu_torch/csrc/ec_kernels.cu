// Hand-written Hopper (sm_90a) kernels for the G1 arithmetic of the device
// Pippenger MSM.  Plain C interface, built by nvcc into a shared library and
// called through ctypes (bulletproofs_tpu_torch/ops/build.py, ec_kernels.py).
// The field and group device functions are in ec_common.cuh, shared with
// kernel 5 (mxu_kernels.cu, its own library, built in parallel).
//
// They replace the Pallas TPU kernels of bulletproofs_tpu/ops/ec_pallas.py:
//   bp_bucket_rounds_mixed  <- bucket_rounds_chunk_pallas_mixed (:425)
//   bp_bucket_rounds_proj   <- bucket_rounds_chunk_pallas       (:355)
//   bp_ec_add               <- ec_add_pallas                    (:499)
//   bp_bucket_round_add     <- bucket_round_add_pallas          (:469)
//
// Representation.  A field element is NL little-endian 32-bit limbs in
// Montgomery form with R = 2^(32*NL).  The JAX package and the port's plain
// PyTorch versions hold 2*NL 16-bit limbs with R = 2^(16*2*NL), the same
// integer, so packing limb pairs (done by the Python wrappers) is exact.
// Every function returns CANONICAL values (< p), so a kernel and its plain
// version agree limb for limb.  Points are projective (X : Y : Z), identity
// (0 : 1 : 0); the group law is the complete addition of Renes-Costello-
// Batina 2016 for a = 0 curves (algorithm 7; algorithm 8 for the mixed add).
//
// What bounds them.  Integer multiply-adds: a Montgomery product is
// 2*NL^2 + NL 32x32->64-bit multiply-adds (300 for BLS12-381, two IMAD
// instructions each), and a bucket round does 11 (mixed) or 12 of them per
// occupied slot (per slot in bp_bucket_round_add, where empty slots add the
// identity) against 96 or 144 bytes of row read, far above the card's
// bytes-per-operation balance.  The design keeps every operand of a point
// addition in registers: one thread owns one bucket slot (or one point of
// the batched add) and the Pallas grid's sequential rounds axis becomes a
// loop inside the thread, with the accumulator held in registers across the
// chunk's rounds.  At the n = 2^16 MSM shape S = 8448 slots give 132 blocks
// of 64 threads: one block per SM and only 2 warps on each (16896 slots and
// 4 warps for the IPA's two-set MSM), so latency, not the IMAD pipe, limits
// these kernels today.  Filling the SMs (several
// threads per slot, or rows gathered by slot id inside the kernel) is left
// to a later redesign.


#include "ec_common.cuh"

namespace {

// acc (3, NL, S) in/out; rows (R_c*S, 2NL) affine (X, Y), round-major;
// found (R_c, S).  One thread per slot loops over the R_c rounds with its
// accumulator in registers; empty slots keep the accumulator.
template <int NL>
__global__ void __launch_bounds__(kThreads)
bucket_rounds_mixed_kernel(uint32_t* acc, const uint32_t* rows,
                           const int32_t* found, int S, int R_c,
                           Field<NL> f) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= S) return;
    uint32_t X[NL], Y[NL], Z[NL], x2[NL], y2[NL];
    load_point<NL>(X, Y, Z, acc, S, s);
    for (int r = 0; r < R_c; r++) {
        const size_t slot = (size_t)r * S + s;
        if (found[slot] == 0) continue;
        const uint32_t* row = rows + slot * (2 * NL);
        load_words<NL>(x2, row);
        load_words<NL>(y2, row + NL);
        ec_madd_inplace<NL>(X, Y, Z, x2, y2, f);
    }
    store_point<NL>(acc, S, s, X, Y, Z);
}

// acc (3, NL, S) in/out; rows (R_c*S, 3NL) projective, round-major; found
// (R_c, S).  Empty slots add the identity (0 : 1 : 0), as the TPU kernel
// does, which rescales the accumulator's representative.
template <int NL>
__global__ void __launch_bounds__(kThreads)
bucket_rounds_proj_kernel(uint32_t* acc, const uint32_t* rows,
                          const int32_t* found, int S, int R_c,
                          Field<NL> f) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= S) return;
    uint32_t X[NL], Y[NL], Z[NL], x2[NL], y2[NL], z2[NL];
    load_point<NL>(X, Y, Z, acc, S, s);
    for (int r = 0; r < R_c; r++) {
        const size_t slot = (size_t)r * S + s;
        if (found[slot] != 0) {
            const uint32_t* row = rows + slot * (3 * NL);
            load_words<NL>(x2, row);
            load_words<NL>(y2, row + NL);
            load_words<NL>(z2, row + 2 * NL);
        } else {
#pragma unroll
            for (int k = 0; k < NL; k++) {
                x2[k] = 0;
                y2[k] = f.one[k];
                z2[k] = 0;
            }
        }
        ec_add_inplace<NL>(X, Y, Z, x2, y2, z2, f);
    }
    store_point<NL>(acc, S, s, X, Y, Z);
}

// One bucket round (the per-round form of the bucket pass): acc (3, NL, S)
// in/out, rows (S, 3NL) projective, found (S,).  Every slot adds its row,
// or the identity (0 : 1 : 0) where found is 0, as the TPU kernel does.  One
// thread per slot; the same 12-multiply complete add as the chunked kernel,
// but one launch, one accumulator load and one store per round.
template <int NL>
__global__ void __launch_bounds__(kThreads)
bucket_round_add_kernel(uint32_t* acc, const uint32_t* rows,
                        const int32_t* found, int S, Field<NL> f) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= S) return;
    uint32_t X[NL], Y[NL], Z[NL], x2[NL], y2[NL], z2[NL];
    load_point<NL>(X, Y, Z, acc, S, s);
    if (found[s] != 0) {
        const uint32_t* row = rows + (size_t)s * (3 * NL);
        load_words<NL>(x2, row);
        load_words<NL>(y2, row + NL);
        load_words<NL>(z2, row + 2 * NL);
    } else {
#pragma unroll
        for (int k = 0; k < NL; k++) {
            x2[k] = 0;
            y2[k] = f.one[k];
            z2[k] = 0;
        }
    }
    ec_add_inplace<NL>(X, Y, Z, x2, y2, z2, f);
    store_point<NL>(acc, S, s, X, Y, Z);
}

// out = P + Q elementwise over n points, all (3, NL, n); ragged n is masked.
template <int NL>
__global__ void __launch_bounds__(kThreads)
ec_add_kernel(uint32_t* out, const uint32_t* P, const uint32_t* Q,
              long long n, Field<NL> f) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t X1[NL], Y1[NL], Z1[NL], X2[NL], Y2[NL], Z2[NL];
    load_point<NL>(X1, Y1, Z1, P, (size_t)n, (size_t)i);
    load_point<NL>(X2, Y2, Z2, Q, (size_t)n, (size_t)i);
    ec_add_inplace<NL>(X1, Y1, Z1, X2, Y2, Z2, f);
    store_point<NL>(out, (size_t)n, (size_t)i, X1, Y1, Z1);
}

}  // namespace

extern "C" {

// Each launch function returns cudaGetLastError() after the launch (0 when
// the launch was accepted); a limb count other than 8 or 12 gives
// cudaErrorInvalidValue.

int bp_bucket_rounds_mixed(void* acc, const void* rows, const void* found,
                           int S, int R_c, int nl, const void* consts,
                           void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* c = static_cast<const uint32_t*>(consts);
    if (S <= 0 || R_c <= 0) return (int)cudaErrorInvalidValue;
    if (nl == 12) {
        bucket_rounds_mixed_kernel<12><<<grid_for(S), kThreads, 0, st>>>(
            static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(rows),
            static_cast<const int32_t*>(found), S, R_c, make_field<12>(c));
    } else if (nl == 8) {
        bucket_rounds_mixed_kernel<8><<<grid_for(S), kThreads, 0, st>>>(
            static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(rows),
            static_cast<const int32_t*>(found), S, R_c, make_field<8>(c));
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

int bp_bucket_rounds_proj(void* acc, const void* rows, const void* found,
                          int S, int R_c, int nl, const void* consts,
                          void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* c = static_cast<const uint32_t*>(consts);
    if (S <= 0 || R_c <= 0) return (int)cudaErrorInvalidValue;
    if (nl == 12) {
        bucket_rounds_proj_kernel<12><<<grid_for(S), kThreads, 0, st>>>(
            static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(rows),
            static_cast<const int32_t*>(found), S, R_c, make_field<12>(c));
    } else if (nl == 8) {
        bucket_rounds_proj_kernel<8><<<grid_for(S), kThreads, 0, st>>>(
            static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(rows),
            static_cast<const int32_t*>(found), S, R_c, make_field<8>(c));
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

int bp_ec_add(void* out, const void* P, const void* Q, long long n, int nl,
              const void* consts, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* c = static_cast<const uint32_t*>(consts);
    if (n <= 0) return (int)cudaErrorInvalidValue;
    if (nl == 12) {
        ec_add_kernel<12><<<grid_for(n), kThreads, 0, st>>>(
            static_cast<uint32_t*>(out), static_cast<const uint32_t*>(P),
            static_cast<const uint32_t*>(Q), n, make_field<12>(c));
    } else if (nl == 8) {
        ec_add_kernel<8><<<grid_for(n), kThreads, 0, st>>>(
            static_cast<uint32_t*>(out), static_cast<const uint32_t*>(P),
            static_cast<const uint32_t*>(Q), n, make_field<8>(c));
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

int bp_bucket_round_add(void* acc, const void* rows, const void* found,
                        int S, int nl, const void* consts, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* c = static_cast<const uint32_t*>(consts);
    if (S <= 0) return (int)cudaErrorInvalidValue;
    if (nl == 12) {
        bucket_round_add_kernel<12><<<grid_for(S), kThreads, 0, st>>>(
            static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(rows),
            static_cast<const int32_t*>(found), S, make_field<12>(c));
    } else if (nl == 8) {
        bucket_round_add_kernel<8><<<grid_for(S), kThreads, 0, st>>>(
            static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(rows),
            static_cast<const int32_t*>(found), S, make_field<8>(c));
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
