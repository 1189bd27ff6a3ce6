// Field and group arithmetic shared by the port's CUDA kernels
// (ec_kernels.cu, mxu_kernels.cu): 32-bit-limb Montgomery field ops, the
// complete RCB16 addition, and point loads and stores.  See ec_kernels.cu
// for the representation.

#pragma once

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
