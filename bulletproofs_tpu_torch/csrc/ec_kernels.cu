// Hand-written Hopper (sm_90a) kernels for the G1 arithmetic of the device
// Pippenger MSM.  Plain C interface, built by nvcc into a shared library and
// called through ctypes (bulletproofs_tpu_torch/ops/build.py, ec_kernels.py).
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

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

template <int NL>
struct Field {
    uint32_t p[NL];      // modulus
    uint32_t one[NL];    // Montgomery one, R mod p
    uint32_t n0inv;      // -p^-1 mod 2^32
    uint32_t b3;         // 3 * b, a small curve constant
};

template <int NL>
__device__ __forceinline__ void add_mod(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b,
                                        const Field<NL>& f) {
    uint32_t s[NL], d[NL];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        c += (uint64_t)a[i] + b[i];
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    uint64_t br = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        uint64_t t = (uint64_t)s[i] - f.p[i] - br;
        d[i] = (uint32_t)t;
        br = t >> 63;
    }
    const bool ge = c != 0 || br == 0;   // a + b >= p
#pragma unroll
    for (int i = 0; i < NL; i++) r[i] = ge ? d[i] : s[i];
}

template <int NL>
__device__ __forceinline__ void sub_mod(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b,
                                        const Field<NL>& f) {
    uint32_t d[NL];
    uint64_t br = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        uint64_t t = (uint64_t)a[i] - b[i] - br;
        d[i] = (uint32_t)t;
        br = t >> 63;
    }
    // a < b: add p back (mask is all ones or zero)
    const uint32_t mask = 0u - (uint32_t)br;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        c += (uint64_t)d[i] + (f.p[i] & mask);
        r[i] = (uint32_t)c;
        c >>= 32;
    }
}

// CIOS Montgomery product a*b*R^-1 mod p, canonical in and out.
template <int NL>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b,
                                         const Field<NL>& f) {
    uint32_t t[NL + 2];
#pragma unroll
    for (int i = 0; i < NL + 2; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < NL; j++) {
            c += (uint64_t)a[i] * b[j] + t[j];
            t[j] = (uint32_t)c;
            c >>= 32;
        }
        c += t[NL];
        t[NL] = (uint32_t)c;
        t[NL + 1] = (uint32_t)(c >> 32);
        const uint32_t m = t[0] * f.n0inv;
        c = ((uint64_t)m * f.p[0] + t[0]) >> 32;
#pragma unroll
        for (int j = 1; j < NL; j++) {
            c += (uint64_t)m * f.p[j] + t[j];
            t[j - 1] = (uint32_t)c;
            c >>= 32;
        }
        c += t[NL];
        t[NL - 1] = (uint32_t)c;
        t[NL] = t[NL + 1] + (uint32_t)(c >> 32);
    }
    // t < 2p: subtract p once if t >= p
    uint32_t d[NL];
    uint64_t br = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        uint64_t x = (uint64_t)t[i] - f.p[i] - br;
        d[i] = (uint32_t)x;
        br = x >> 63;
    }
    const bool ge = t[NL] != 0 || br == 0;
#pragma unroll
    for (int i = 0; i < NL; i++) r[i] = ge ? d[i] : t[i];
}

// a * k for a small constant k, by double-and-add of mod-adds.
template <int NL>
__device__ __forceinline__ void mul_small(uint32_t* r, const uint32_t* a,
                                          uint32_t k, const Field<NL>& f) {
    uint32_t acc[NL];
#pragma unroll
    for (int i = 0; i < NL; i++) acc[i] = a[i];
    for (int bit = 30 - __clz(k); bit >= 0; bit--) {
        add_mod<NL>(acc, acc, acc, f);
        if ((k >> bit) & 1) add_mod<NL>(acc, acc, a, f);
    }
#pragma unroll
    for (int i = 0; i < NL; i++) r[i] = acc[i];
}

// Shared end of RCB16 algorithms 7 and 8: (X3, Y3, Z3) from xy, yz, xz, t0,
// m = t1 - b3*t2 and n = t1 + b3*t2.
template <int NL>
__device__ __forceinline__ void add_tail(uint32_t* X3, uint32_t* Y3,
                                         uint32_t* Z3, const uint32_t* xy,
                                         const uint32_t* yz,
                                         const uint32_t* xz,
                                         const uint32_t* t0,
                                         const uint32_t* m,
                                         const uint32_t* n,
                                         const Field<NL>& f) {
    uint32_t u[NL], v[NL], w[NL];
    mont_mul<NL>(u, xy, m, f);
    mont_mul<NL>(v, yz, xz, f);
    mul_small<NL>(w, v, f.b3, f);
    sub_mod<NL>(X3, u, w, f);             // xy*m - b3*yz*xz
    mont_mul<NL>(u, n, m, f);
    mont_mul<NL>(v, t0, xz, f);
    mul_small<NL>(w, v, 3 * f.b3, f);
    add_mod<NL>(Y3, u, w, f);             // n*m + 3b3*t0*xz
    mont_mul<NL>(u, yz, n, f);
    mont_mul<NL>(v, t0, xy, f);
    mul_small<NL>(w, v, 3, f);
    add_mod<NL>(Z3, u, w, f);             // yz*n + 3*t0*xy
}

// P1 += P2, complete projective add (RCB16 algorithm 7, 12 multiplies).
template <int NL>
__device__ __forceinline__ void ec_add_inplace(uint32_t* X1, uint32_t* Y1,
                                               uint32_t* Z1,
                                               const uint32_t* X2,
                                               const uint32_t* Y2,
                                               const uint32_t* Z2,
                                               const Field<NL>& f) {
    uint32_t t0[NL], t1[NL], t2[NL], xy[NL], yz[NL], xz[NL], s1[NL], s2[NL];
    mont_mul<NL>(t0, X1, X2, f);
    mont_mul<NL>(t1, Y1, Y2, f);
    mont_mul<NL>(t2, Z1, Z2, f);
    add_mod<NL>(s1, X1, Y1, f);
    add_mod<NL>(s2, X2, Y2, f);
    mont_mul<NL>(xy, s1, s2, f);
    sub_mod<NL>(xy, xy, t0, f);
    sub_mod<NL>(xy, xy, t1, f);
    add_mod<NL>(s1, Y1, Z1, f);
    add_mod<NL>(s2, Y2, Z2, f);
    mont_mul<NL>(yz, s1, s2, f);
    sub_mod<NL>(yz, yz, t1, f);
    sub_mod<NL>(yz, yz, t2, f);
    add_mod<NL>(s1, X1, Z1, f);
    add_mod<NL>(s2, X2, Z2, f);
    mont_mul<NL>(xz, s1, s2, f);
    sub_mod<NL>(xz, xz, t0, f);
    sub_mod<NL>(xz, xz, t2, f);
    mul_small<NL>(s1, t2, f.b3, f);       // b3*t2
    sub_mod<NL>(s2, t1, s1, f);           // m
    add_mod<NL>(t2, t1, s1, f);           // n
    add_tail<NL>(X1, Y1, Z1, xy, yz, xz, t0, s2, t2, f);
}

// P1 += (X2, Y2, 1), complete mixed add (RCB16 algorithm 8, 11 multiplies).
template <int NL>
__device__ __forceinline__ void ec_madd_inplace(uint32_t* X1, uint32_t* Y1,
                                                uint32_t* Z1,
                                                const uint32_t* X2,
                                                const uint32_t* Y2,
                                                const Field<NL>& f) {
    uint32_t t0[NL], t1[NL], xy[NL], yz[NL], xz[NL], s1[NL], s2[NL];
    mont_mul<NL>(t0, X1, X2, f);
    mont_mul<NL>(t1, Y1, Y2, f);
    add_mod<NL>(s1, X1, Y1, f);
    add_mod<NL>(s2, X2, Y2, f);
    mont_mul<NL>(xy, s1, s2, f);
    sub_mod<NL>(xy, xy, t0, f);
    sub_mod<NL>(xy, xy, t1, f);
    mont_mul<NL>(yz, Y2, Z1, f);
    add_mod<NL>(yz, yz, Y1, f);
    mont_mul<NL>(xz, X2, Z1, f);
    add_mod<NL>(xz, xz, X1, f);
    mul_small<NL>(s1, Z1, f.b3, f);       // b3*Z1
    sub_mod<NL>(s2, t1, s1, f);           // m
    add_mod<NL>(s1, t1, s1, f);           // n
    add_tail<NL>(X1, Y1, Z1, xy, yz, xz, t0, s2, s1, f);
}

// NL consecutive words from a 16-byte aligned address.
template <int NL>
__device__ __forceinline__ void load_words(uint32_t* dst,
                                           const uint32_t* src) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int k = 0; k < NL / 4; k++) {
        uint4 v = s[k];
        dst[4 * k] = v.x;
        dst[4 * k + 1] = v.y;
        dst[4 * k + 2] = v.z;
        dst[4 * k + 3] = v.w;
    }
}

// One coordinate-major point (3, NL, stride) at column i.
template <int NL>
__device__ __forceinline__ void load_point(uint32_t* X, uint32_t* Y,
                                           uint32_t* Z, const uint32_t* base,
                                           size_t stride, size_t i) {
#pragma unroll
    for (int k = 0; k < NL; k++) {
        X[k] = base[k * stride + i];
        Y[k] = base[(NL + k) * stride + i];
        Z[k] = base[(2 * NL + k) * stride + i];
    }
}

template <int NL>
__device__ __forceinline__ void store_point(uint32_t* base, size_t stride,
                                            size_t i, const uint32_t* X,
                                            const uint32_t* Y,
                                            const uint32_t* Z) {
#pragma unroll
    for (int k = 0; k < NL; k++) {
        base[k * stride + i] = X[k];
        base[(NL + k) * stride + i] = Y[k];
        base[(2 * NL + k) * stride + i] = Z[k];
    }
}

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

// consts (host memory): p[nl], one[nl], n0inv, b3.
template <int NL>
Field<NL> make_field(const uint32_t* consts) {
    Field<NL> f;
    std::memcpy(f.p, consts, NL * sizeof(uint32_t));
    std::memcpy(f.one, consts + NL, NL * sizeof(uint32_t));
    f.n0inv = consts[2 * NL];
    f.b3 = consts[2 * NL + 1];
    return f;
}

unsigned grid_for(long long n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
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
