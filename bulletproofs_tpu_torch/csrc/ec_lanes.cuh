// Field and group arithmetic with kLanes = 4 cooperating lanes per field
// element: 4 consecutive threads of one warp (a "group") hold one element,
// lane j its K = NL / 4 words j*K .. j*K + K - 1.  The products use PTX
// carry chains (carry.cuh); values cross lanes only by warp shuffles and
// ballots.  Every function returns CANONICAL values (< p), the same words
// as the one-thread functions of ec_common.cuh and the plain PyTorch
// versions.
//
// Warp-uniform control flow.  The shuffles and ballots name the WHOLE warp
// (mask 0xffffffff, width 4), so all 32 threads of a warp must call each
// function together: a kernel does not let a group leave early or skip a
// step alone, it computes the step for every group of the warp and keeps
// the result by a per-group select (`warp_needs`).  Masks of single groups
// would let groups diverge, but groups of one warp then take their
// shuffles one mask at a time: on the H100 that made 4 lanes a slot slower
// than one (PERF.md section 6).
//
// Carries between lanes.  A sum or difference is first formed per lane
// (a K-word chain with a local carry or borrow out), then the carries
// between lanes are resolved at once, as a carry-lookahead adder does: a
// lane generates a carry, or passes an incoming one on when its words are
// all ones (all zeros for a borrow); with those as the bits G and P of two
// ballots, the carries into the lanes are the bits of (X + G) ^ X ^ G,
// X = G | P.  Each lane then adds its one incoming bit.
//
// The Montgomery product is CIOS with the accumulator spread over the
// lanes.  Each lane keeps, beside its K words, a two-word "spill" holding
// what carried out of its top word; the spill is not passed on at once.
// Each of the NL steps adds a_i * b and q * p (a_i broadcast from its
// owner lane, q = t_0 * n0inv from lane 0, whose low word has no spill
// below it and so is exact) and shifts the accumulator down one word:
// lane j + 1's low word moves to lane j's top, where lane j's spill lands,
// so the spill is folded in there.  One shift-down shuffle a step, and one
// carry resolution after the last step.

#pragma once

#include <cstdint>

#include "carry.cuh"
#include "ec_common.cuh"

namespace {

constexpr uint32_t kWarp = 0xffffffffu;
constexpr int kLanes = 4;       // lanes a group; divides 12 and 8 limbs
static_assert(12 % kLanes == 0 && 8 % kLanes == 0,
              "lanes must divide both limb counts");

struct Lanes {
    int base;        // the group's first lane in the warp
    int j;           // this thread's lane in the group

    __device__ __forceinline__ Lanes() {
        const int lane = threadIdx.x & 31;
        j = lane & (kLanes - 1);
        base = lane - j;
    }

    // v of lane src of the group
    __device__ __forceinline__ uint32_t bcast(uint32_t v, int src) const {
        return __shfl_sync(kWarp, v, src, kLanes);
    }

    // v of lane j + 1; 0 on the top lane
    __device__ __forceinline__ uint32_t from_next(uint32_t v) const {
        const uint32_t r = __shfl_down_sync(kWarp, v, 1, kLanes);
        return j == kLanes - 1 ? 0u : r;
    }

    // v of lane j - 1; 0 on lane 0
    __device__ __forceinline__ uint32_t from_prev(uint32_t v) const {
        const uint32_t r = __shfl_up_sync(kWarp, v, 1, kLanes);
        return j == 0 ? 0u : r;
    }

    // bit i: the predicate of lane i of the group
    __device__ __forceinline__ uint32_t ballot(bool p) const {
        return (__ballot_sync(kWarp, p) >> base) & ((1u << kLanes) - 1u);
    }
};

// Whether a step needed by this group where `p` must run: when p holds for
// any group of the warp, since the whole warp runs each step (the caller
// keeps the step's result only where p).
__device__ __forceinline__ bool warp_needs(bool p) {
    return __any_sync(kWarp, p);
}

// The field constants a lane needs: its words of p and of Montgomery one,
// and for a != 0 (the second constructor) the kernel's constants a, a^2
// and 3b, a `__grid_constant__` parameter that each product reads its
// words of where it takes them (`lane_words`), so that they hold no
// registers across the add.
template <int NL>
struct FieldL {
    static constexpr int K = NL / kLanes;
    uint32_t p[K];
    uint32_t one[K];
    uint32_t n0inv;
    uint32_t b3;
    const CurveA<NL>* ca = nullptr;   // RCB16 algorithm 1 (a != 0) only

    __device__ __forceinline__ FieldL(const Field<NL>& f, int j) {
#pragma unroll
        for (int k = 0; k < K; k++) {
            p[k] = f.p[j * K + k];
            one[k] = f.one[j * K + k];
        }
        n0inv = f.n0inv;
        b3 = f.b3;
    }

    __device__ __forceinline__ FieldL(const Field<NL>& f,
                                      const CurveA<NL>& curve, int j)
        : FieldL(f, j) {
        ca = &curve;
    }
};

// w: the lane's K words of an NL-word constant c; returns w.
template <int NL>
__device__ __forceinline__ const uint32_t* lane_words(uint32_t* w,
                                                      const uint32_t* c,
                                                      int j) {
    constexpr int K = NL / kLanes;
#pragma unroll
    for (int k = 0; k < K; k++) w[k] = c[j * K + k];
    return w;
}

// A lane's FieldL for a kernel instantiated for a = 0 or (GA) a != 0.
template <int NL, bool GA>
__device__ __forceinline__ FieldL<NL> field_l(const Field<NL>& f,
                                              const CurveA<NL>& ca, int j) {
    if constexpr (GA) {
        return FieldL<NL>(f, ca, j);
    } else {
        return FieldL<NL>(f, j);
    }
}

// r (the lane's K words of a sum formed lane by lane) and g, the lane's
// carry out: propagate the carries between lanes; returns the carry out of
// the top lane (the same on every lane).
template <int K>
__device__ __forceinline__ uint32_t carry_lanes(uint32_t* r, uint32_t g,
                                                const Lanes& ln) {
    bool ones = g == 0;
#pragma unroll
    for (int k = 0; k < K; k++) ones = ones && r[k] == 0xffffffffu;
    const uint32_t G = ln.ballot(g != 0);
    const uint32_t X = G | ln.ballot(ones);
    const uint32_t C = (X + G) ^ X ^ G;       // bit i: carry into lane i
    r[0] = add_cc(r[0], (C >> ln.j) & 1u);
#pragma unroll
    for (int k = 1; k < K; k++) r[k] = addc_cc(r[k], 0u);
    return (C >> kLanes) & 1u;
}

// The same for a difference: b is the lane's borrow out, and a lane whose
// words are all zero passes an incoming borrow on.
template <int K>
__device__ __forceinline__ uint32_t borrow_lanes(uint32_t* r, uint32_t b,
                                                 const Lanes& ln) {
    bool zeros = b == 0;
#pragma unroll
    for (int k = 0; k < K; k++) zeros = zeros && r[k] == 0u;
    const uint32_t G = ln.ballot(b != 0);
    const uint32_t X = G | ln.ballot(zeros);
    const uint32_t C = (X + G) ^ X ^ G;       // bit i: borrow into lane i
    r[0] = sub_cc(r[0], (C >> ln.j) & 1u);
#pragma unroll
    for (int k = 1; k < K; k++) r[k] = subc_cc(r[k], 0u);
    return (C >> kLanes) & 1u;
}

// r = x - p if x >= p, else x, where c is the carry above x's top word.
template <int NL>
__device__ __forceinline__ void reduce_once_l(uint32_t* r, const uint32_t* x,
                                              uint32_t c,
                                              const FieldL<NL>& f,
                                              const Lanes& ln) {
    constexpr int K = NL / kLanes;
    uint32_t d[K];
    d[0] = sub_cc(x[0], f.p[0]);
#pragma unroll
    for (int k = 1; k < K; k++) d[k] = subc_cc(x[k], f.p[k]);
    const uint32_t b = subc(0u, 0u) & 1u;
    const uint32_t br = borrow_lanes<K>(d, b, ln);
    const bool ge = c != 0 || br == 0;
#pragma unroll
    for (int k = 0; k < K; k++) r[k] = ge ? d[k] : x[k];
}

template <int NL>
__device__ __forceinline__ void add_mod_l(uint32_t* r, const uint32_t* a,
                                          const uint32_t* b,
                                          const FieldL<NL>& f,
                                          const Lanes& ln) {
    constexpr int K = NL / kLanes;
    uint32_t s[K];
    s[0] = add_cc(a[0], b[0]);
#pragma unroll
    for (int k = 1; k < K; k++) s[k] = addc_cc(a[k], b[k]);
    const uint32_t g = addc(0u, 0u);
    const uint32_t c = carry_lanes<K>(s, g, ln);
    reduce_once_l<NL>(r, s, c, f, ln);
}

template <int NL>
__device__ __forceinline__ void sub_mod_l(uint32_t* r, const uint32_t* a,
                                          const uint32_t* b,
                                          const FieldL<NL>& f,
                                          const Lanes& ln) {
    constexpr int K = NL / kLanes;
    uint32_t d[K];
    d[0] = sub_cc(a[0], b[0]);
#pragma unroll
    for (int k = 1; k < K; k++) d[k] = subc_cc(a[k], b[k]);
    const uint32_t bo = subc(0u, 0u) & 1u;
    // a < b: add p back (the carry out of the top wraps it)
    const uint32_t m = 0u - borrow_lanes<K>(d, bo, ln);
    r[0] = add_cc(d[0], f.p[0] & m);
#pragma unroll
    for (int k = 1; k < K; k++) r[k] = addc_cc(d[k], f.p[k] & m);
    const uint32_t g = addc(0u, 0u);
    carry_lanes<K>(r, g, ln);
}

// t += x * y over the lane's K words; what carries out of the top word goes
// into the spill s0 + 2^32 s1.
template <int K>
__device__ __forceinline__ void mac_row(uint32_t* t, uint32_t& s0,
                                        uint32_t& s1, uint32_t x,
                                        const uint32_t* y) {
    static_assert(K >= 2, "a lane holds at least two words");
    t[0] = mad_lo_cc(x, y[0], t[0]);
#pragma unroll
    for (int k = 1; k < K; k++) t[k] = madc_lo_cc(x, y[k], t[k]);
    s0 = addc_cc(s0, 0u);
    s1 = addc(s1, 0u);
    t[1] = mad_hi_cc(x, y[0], t[1]);
#pragma unroll
    for (int k = 2; k < K; k++) t[k] = madc_hi_cc(x, y[k - 1], t[k]);
    s0 = madc_hi_cc(x, y[K - 1], s0);
    s1 = addc(s1, 0u);
}

// CIOS Montgomery product a*b*R^-1 mod p, canonical in and out.
template <int NL>
__device__ __forceinline__ void mont_mul_l(uint32_t* r, const uint32_t* a,
                                           const uint32_t* b,
                                           const FieldL<NL>& f,
                                           const Lanes& ln) {
    constexpr int K = NL / kLanes;
    uint32_t t[K];
#pragma unroll
    for (int k = 0; k < K; k++) t[k] = 0u;
    uint32_t s0 = 0u, s1 = 0u;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        const uint32_t ai = ln.bcast(a[i % K], i / K);
        mac_row<K>(t, s0, s1, ai, b);
        const uint32_t q = ln.bcast(t[0] * f.n0inv, 0);
        mac_row<K>(t, s0, s1, q, f.p);
        // divide by 2^32; lane 0's low word is now 0
        const uint32_t down = ln.from_next(t[0]);
#pragma unroll
        for (int k = 0; k < K - 1; k++) t[k] = t[k + 1];
        t[K - 1] = add_cc(down, s0);
        s0 = addc(s1, 0u);
        s1 = 0u;
    }
    // lane j - 1's spill lands on lane j's low word; the top lane's is the
    // carry above word NL - 1.  The value is < 2p.
    const uint32_t top = ln.bcast(s0, kLanes - 1);
    t[0] = add_cc(t[0], ln.from_prev(s0));
#pragma unroll
    for (int k = 1; k < K; k++) t[k] = addc_cc(t[k], 0u);
    const uint32_t g = addc(0u, 0u);
    const uint32_t c = carry_lanes<K>(t, g, ln) + top;
    reduce_once_l<NL>(r, t, c, f, ln);
}

// M independent CIOS products at once on the calling group: r[j] =
// a[j] * b[j] * R^-1 mod p (the lane's K words of each), each step of
// `mont_mul_l` taken for all M before the next, so their shuffles and
// multiply-adds overlap in one instruction stream.  The same arithmetic as
// mont_mul_l, so the same words.
template <int NL, int M, int K = NL / kLanes>
__device__ __forceinline__ void mont_mul_m_l(uint32_t (&r)[M][K],
                                             const uint32_t (&a)[M][K],
                                             const uint32_t (&b)[M][K],
                                             const FieldL<NL>& f,
                                             const Lanes& ln) {
    uint32_t t[M][K], s0[M], s1[M];
#pragma unroll
    for (int m = 0; m < M; m++) {
#pragma unroll
        for (int k = 0; k < K; k++) t[m][k] = 0u;
        s0[m] = s1[m] = 0u;
    }
#pragma unroll
    for (int i = 0; i < NL; i++) {
        uint32_t x[M];
#pragma unroll
        for (int m = 0; m < M; m++) x[m] = ln.bcast(a[m][i % K], i / K);
#pragma unroll
        for (int m = 0; m < M; m++)
            mac_row<K>(t[m], s0[m], s1[m], x[m], b[m]);
#pragma unroll
        for (int m = 0; m < M; m++) x[m] = ln.bcast(t[m][0] * f.n0inv, 0);
#pragma unroll
        for (int m = 0; m < M; m++)
            mac_row<K>(t[m], s0[m], s1[m], x[m], f.p);
#pragma unroll
        for (int m = 0; m < M; m++) x[m] = ln.from_next(t[m][0]);
#pragma unroll
        for (int m = 0; m < M; m++) {
#pragma unroll
            for (int k = 0; k < K - 1; k++) t[m][k] = t[m][k + 1];
            t[m][K - 1] = add_cc(x[m], s0[m]);
            s0[m] = addc(s1[m], 0u);
            s1[m] = 0u;
        }
    }
#pragma unroll
    for (int m = 0; m < M; m++) {
        const uint32_t top = ln.bcast(s0[m], kLanes - 1);
        t[m][0] = add_cc(t[m][0], ln.from_prev(s0[m]));
#pragma unroll
        for (int k = 1; k < K; k++) t[m][k] = addc_cc(t[m][k], 0u);
        const uint32_t g = addc(0u, 0u);
        const uint32_t c = carry_lanes<K>(t[m], g, ln) + top;
        reduce_once_l<NL>(r[m], t[m], c, f, ln);
    }
}

// a * k for a small constant k, by double-and-add of mod-adds.
template <int NL>
__device__ __forceinline__ void mul_small_l(uint32_t* r, const uint32_t* a,
                                            uint32_t k,
                                            const FieldL<NL>& f,
                                            const Lanes& ln) {
    constexpr int K = NL / kLanes;
    uint32_t acc[K];
#pragma unroll
    for (int i = 0; i < K; i++) acc[i] = a[i];
    for (int bit = 30 - __clz(k); bit >= 0; bit--) {
        add_mod_l<NL>(acc, acc, acc, f, ln);
        if ((k >> bit) & 1) add_mod_l<NL>(acc, acc, a, f, ln);
    }
#pragma unroll
    for (int i = 0; i < K; i++) r[i] = acc[i];
}

// The Montgomery product of the group law below: CIOS (`mont_mul_l`) unless
// a kernel passes another with the same canonical result (mxu_kernels.cu).
template <int NL>
struct CiosMulL {
    __device__ __forceinline__ void operator()(uint32_t* r, const uint32_t* a,
                                               const uint32_t* b,
                                               const FieldL<NL>& f,
                                               const Lanes& ln) const {
        mont_mul_l<NL>(r, a, b, f, ln);
    }
};

// The shared end of RCB16 algorithms 7 and 8 (see ec_common.cuh add_tail).
template <int NL, class Mul = CiosMulL<NL>>
__device__ __forceinline__ void add_tail_l(uint32_t* X3, uint32_t* Y3,
                                           uint32_t* Z3, const uint32_t* xy,
                                           const uint32_t* yz,
                                           const uint32_t* xz,
                                           const uint32_t* t0,
                                           const uint32_t* m,
                                           const uint32_t* n,
                                           const FieldL<NL>& f,
                                           const Lanes& ln,
                                           const Mul& mul = Mul()) {
    constexpr int K = NL / kLanes;
    uint32_t u[K], v[K], w[K];
    mul(u, xy, m, f, ln);
    mul(v, yz, xz, f, ln);
    mul_small_l<NL>(w, v, f.b3, f, ln);
    sub_mod_l<NL>(X3, u, w, f, ln);         // xy*m - b3*yz*xz
    mul(u, n, m, f, ln);
    mul(v, t0, xz, f, ln);
    mul_small_l<NL>(w, v, 3 * f.b3, f, ln);
    add_mod_l<NL>(Y3, u, w, f, ln);         // n*m + 3b3*t0*xz
    mul(u, yz, n, f, ln);
    mul(v, t0, xy, f, ln);
    mul_small_l<NL>(w, v, 3, f, ln);
    add_mod_l<NL>(Z3, u, w, f, ln);         // yz*n + 3*t0*xy
}

// RCB16 algorithm 1's end (a != 0; see ec_common.cuh add_tail_a): 18
// products an add where algorithm 7 takes 12.
template <int NL, class Mul>
__device__ __forceinline__ void add_tail_a_l(uint32_t* X3, uint32_t* Y3,
                                             uint32_t* Z3,
                                             const uint32_t* t0,
                                             const uint32_t* t1,
                                             const uint32_t* t2,
                                             const uint32_t* xy,
                                             const uint32_t* yz,
                                             const uint32_t* xz,
                                             const FieldL<NL>& f,
                                             const Lanes& ln,
                                             const Mul& mul) {
    constexpr int K = NL / kLanes;
    uint32_t u[K], v[K], w[K], m[K], n[K], u1[K], u4[K], c[K];
    const CurveA<NL>& ca = *f.ca;
    mul(u, xz, lane_words<NL>(c, ca.a, ln.j), f, ln);
    mul(v, t2, lane_words<NL>(c, ca.b3, ln.j), f, ln);
    add_mod_l<NL>(w, u, v, f, ln);          // a*xz + 3b*t2
    sub_mod_l<NL>(m, t1, w, f, ln);
    add_mod_l<NL>(n, t1, w, f, ln);
    mul(u, t2, lane_words<NL>(c, ca.a, ln.j), f, ln);
    mul_small_l<NL>(v, t0, 3, f, ln);
    add_mod_l<NL>(u1, v, u, f, ln);         // 3*t0 + a*t2
    mul(u, t2, lane_words<NL>(c, ca.a2, ln.j), f, ln);
    mul(v, t0, lane_words<NL>(c, ca.a, ln.j), f, ln);
    sub_mod_l<NL>(w, v, u, f, ln);          // a*t0 - a^2*t2
    mul(u, xz, lane_words<NL>(c, ca.b3, ln.j), f, ln);
    add_mod_l<NL>(u4, u, w, f, ln);         // 3b*xz + a*t0 - a^2*t2
    mul(u, xy, m, f, ln);
    mul(v, yz, u4, f, ln);
    sub_mod_l<NL>(X3, u, v, f, ln);         // xy*m - yz*u4
    mul(u, m, n, f, ln);
    mul(v, u1, u4, f, ln);
    add_mod_l<NL>(Y3, u, v, f, ln);         // m*n + u1*u4
    mul(u, yz, n, f, ln);
    mul(v, xy, u1, f, ln);
    add_mod_l<NL>(Z3, u, v, f, ln);         // yz*n + xy*u1
}

// P1 += P2, complete projective add: RCB16 algorithm 7 (a = 0, 12
// multiplies), or algorithm 1 (GA: a != 0, 18 multiplies, the FieldL of
// `field_l<NL, true>`).
template <int NL, bool GA = false, class Mul = CiosMulL<NL>>
__device__ __forceinline__ void ec_add_l(uint32_t* X1, uint32_t* Y1,
                                         uint32_t* Z1, const uint32_t* X2,
                                         const uint32_t* Y2,
                                         const uint32_t* Z2,
                                         const FieldL<NL>& f,
                                         const Lanes& ln,
                                         const Mul& mul = Mul()) {
    constexpr int K = NL / kLanes;
    uint32_t t0[K], t1[K], t2[K], xy[K], yz[K], xz[K], s1[K], s2[K];
    mul(t0, X1, X2, f, ln);
    mul(t1, Y1, Y2, f, ln);
    mul(t2, Z1, Z2, f, ln);
    add_mod_l<NL>(s1, X1, Y1, f, ln);
    add_mod_l<NL>(s2, X2, Y2, f, ln);
    mul(xy, s1, s2, f, ln);
    sub_mod_l<NL>(xy, xy, t0, f, ln);
    sub_mod_l<NL>(xy, xy, t1, f, ln);
    add_mod_l<NL>(s1, Y1, Z1, f, ln);
    add_mod_l<NL>(s2, Y2, Z2, f, ln);
    mul(yz, s1, s2, f, ln);
    sub_mod_l<NL>(yz, yz, t1, f, ln);
    sub_mod_l<NL>(yz, yz, t2, f, ln);
    add_mod_l<NL>(s1, X1, Z1, f, ln);
    add_mod_l<NL>(s2, X2, Z2, f, ln);
    mul(xz, s1, s2, f, ln);
    sub_mod_l<NL>(xz, xz, t0, f, ln);
    sub_mod_l<NL>(xz, xz, t2, f, ln);
    if constexpr (GA) {
        add_tail_a_l<NL, Mul>(X1, Y1, Z1, t0, t1, t2, xy, yz, xz, f, ln,
                              mul);
    } else {
        mul_small_l<NL>(s1, t2, f.b3, f, ln);  // b3*t2
        sub_mod_l<NL>(s2, t1, s1, f, ln);      // m
        add_mod_l<NL>(t2, t1, s1, f, ln);      // n
        add_tail_l<NL, Mul>(X1, Y1, Z1, xy, yz, xz, t0, s2, t2, f, ln, mul);
    }
}

// P1 += (X2, Y2, 1), complete mixed add (RCB16 algorithm 8, 11 multiplies).
template <int NL>
__device__ __forceinline__ void ec_madd_l(uint32_t* X1, uint32_t* Y1,
                                          uint32_t* Z1, const uint32_t* X2,
                                          const uint32_t* Y2,
                                          const FieldL<NL>& f,
                                          const Lanes& ln) {
    constexpr int K = NL / kLanes;
    uint32_t t0[K], t1[K], xy[K], yz[K], xz[K], s1[K], s2[K];
    mont_mul_l<NL>(t0, X1, X2, f, ln);
    mont_mul_l<NL>(t1, Y1, Y2, f, ln);
    add_mod_l<NL>(s1, X1, Y1, f, ln);
    add_mod_l<NL>(s2, X2, Y2, f, ln);
    mont_mul_l<NL>(xy, s1, s2, f, ln);
    sub_mod_l<NL>(xy, xy, t0, f, ln);
    sub_mod_l<NL>(xy, xy, t1, f, ln);
    mont_mul_l<NL>(yz, Y2, Z1, f, ln);
    add_mod_l<NL>(yz, yz, Y1, f, ln);
    mont_mul_l<NL>(xz, X2, Z1, f, ln);
    add_mod_l<NL>(xz, xz, X1, f, ln);
    mul_small_l<NL>(s1, Z1, f.b3, f, ln);  // b3*Z1
    sub_mod_l<NL>(s2, t1, s1, f, ln);      // m
    add_mod_l<NL>(s1, t1, s1, f, ln);      // n
    add_tail_l<NL>(X1, Y1, Z1, xy, yz, xz, t0, s2, s1, f, ln);
}

// The lane's words of a coordinate-major point (3, NL, stride), column i.
template <int NL>
__device__ __forceinline__ void load_point_l(uint32_t* X, uint32_t* Y,
                                             uint32_t* Z,
                                             const uint32_t* base,
                                             size_t stride, size_t i,
                                             int j) {
    constexpr int K = NL / kLanes;
#pragma unroll
    for (int k = 0; k < K; k++) {
        const size_t w = (size_t)(j * K + k);
        X[k] = base[w * stride + i];
        Y[k] = base[(NL + w) * stride + i];
        Z[k] = base[(2 * NL + w) * stride + i];
    }
}

template <int NL>
__device__ __forceinline__ void store_point_l(uint32_t* base, size_t stride,
                                              size_t i, const uint32_t* X,
                                              const uint32_t* Y,
                                              const uint32_t* Z, int j) {
    constexpr int K = NL / kLanes;
#pragma unroll
    for (int k = 0; k < K; k++) {
        const size_t w = (size_t)(j * K + k);
        base[w * stride + i] = X[k];
        base[(NL + w) * stride + i] = Y[k];
        base[(2 * NL + w) * stride + i] = Z[k];
    }
}

// The identity (0 : 1 : 0).
template <int NL>
__device__ __forceinline__ void identity_l(uint32_t* X, uint32_t* Y,
                                           uint32_t* Z,
                                           const FieldL<NL>& f) {
#pragma unroll
    for (int k = 0; k < NL / kLanes; k++) {
        X[k] = 0u;
        Y[k] = f.one[k];
        Z[k] = 0u;
    }
}

template <int NL>
__device__ __forceinline__ void copy_point_l(uint32_t* X, uint32_t* Y,
                                             uint32_t* Z, const uint32_t* X2,
                                             const uint32_t* Y2,
                                             const uint32_t* Z2) {
#pragma unroll
    for (int k = 0; k < NL / kLanes; k++) {
        X[k] = X2[k];
        Y[k] = Y2[k];
        Z[k] = Z2[k];
    }
}

// (X, Y, Z) = (X2, Y2, Z2) where keep is false.
template <int NL>
__device__ __forceinline__ void select_point_l(uint32_t* X, uint32_t* Y,
                                               uint32_t* Z, bool keep,
                                               const uint32_t* X2,
                                               const uint32_t* Y2,
                                               const uint32_t* Z2) {
#pragma unroll
    for (int k = 0; k < NL / kLanes; k++) {
        X[k] = keep ? X[k] : X2[k];
        Y[k] = keep ? Y[k] : Y2[k];
        Z[k] = keep ? Z[k] : Z2[k];
    }
}

constexpr int kSlotBlock = 32 * kLanes;     // of kernels 1, 2, 4 and 5

// The group of kLanes lanes this thread belongs to, counted over the grid.
// Groups past the last one (`count`) work on the last one, so every warp
// stays whole for the lanes' shuffles, and store nothing (`mine` false).
__device__ __forceinline__ long long group_index(long long count,
                                                 bool& mine) {
    const long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                        / kLanes;
    mine = g < count;
    return mine ? g : count - 1;
}

unsigned groups_grid(long long groups, int block) {
    return (unsigned)((groups * kLanes + block - 1) / block);
}

// One round of RCB16 algorithm 7 (GA: algorithm 1) for a group of kernel
// 2, 4 or 5: the accumulator (X : Y : Z) adds row `id` of the projective
// table (n, 3NL), each point's X, Y, then Z words, where `live`, else the
// identity (0 : 1 : 0), as the TPU kernels do; either algorithm turns the
// identity into (X*Y : Y*Y : Z*Y), exactly, which rescales the
// representative.  A warp with a live slot runs the whole add for each of
// its groups, the empty ones on the identity row; a warp whose slots are
// all empty runs only those 3 products.  Either way the words are the
// plain version's.
template <int NL, bool GA = false, class Mul = CiosMulL<NL>>
__device__ __forceinline__ void proj_round_l(uint32_t* X, uint32_t* Y,
                                             uint32_t* Z,
                                             const uint32_t* table, int id,
                                             bool live, const FieldL<NL>& fl,
                                             const Lanes& ln,
                                             const Mul& mul = Mul()) {
    constexpr int K = NL / kLanes;
    if (warp_needs(live)) {
        uint32_t x2[K], y2[K], z2[K];
        const uint32_t* row = table + (size_t)(live ? id : 0) * (3 * NL)
                              + ln.j * K;
#pragma unroll
        for (int k = 0; k < K; k++) {
            x2[k] = live ? row[k] : 0u;
            y2[k] = live ? row[NL + k] : fl.one[k];
            z2[k] = live ? row[2 * NL + k] : 0u;
        }
        ec_add_l<NL, GA, Mul>(X, Y, Z, x2, y2, z2, fl, ln, mul);
    } else {
        uint32_t y[K];
#pragma unroll
        for (int k = 0; k < K; k++) y[k] = Y[k];
        mul(X, X, y, fl, ln);
        mul(Z, Z, y, fl, ln);
        mul(Y, y, y, fl, ln);
    }
}

// ---------------------------------------------------------------------------
// The lone chains: kernel 3's window totals and Horner, and the chain
// kernel's latency forms (roofline_kernels.cu).  One chain of dependent
// group operations has few threads to spread over, so its time is the
// latency of each operation, not a throughput.  ec_add_l above runs its
// 12 (18) products one after another on one group; but their dependency
// depth is 2 (3): the group law below is written as levels of independent
// products, and a level runs on a policy `Lv`:
//   GroupLevels  the products one after another on the calling group;
//   WarpLevels   product i on group i of the warp, all at once, each result
//                then passed to every group by full-width shuffles, so that
//                the warp's 8 groups hold the same values: one chain a
//                warp, a level taking one product's latency (SplitLevels
//                with G = 8; the gather-sum form's G = 4 puts 2 chains on
//                a warp, a level taking 2 products at once on a group).
// The adds, subtractions and small multiples between the levels run on
// every group alike (warp-uniform control flow); their independent chains
// overlap in the instruction stream.
// ---------------------------------------------------------------------------

template <int NL>
struct GroupLevels {
    // r[i] = a[i] * b[i] for i < N; no r[i] is an operand of the level
    template <int N>
    __device__ __forceinline__ void operator()(
            uint32_t* const (&r)[N], const uint32_t* const (&a)[N],
            const uint32_t* const (&b)[N], const FieldL<NL>& f,
            const Lanes& ln) const {
#pragma unroll
        for (int i = 0; i < N; i++) mont_mul_l<NL>(r[i], a[i], b[i], f, ln);
    }
};

// Product i of a level on group i % G of the G groups (of 4 lanes) that
// serve one chain, the ceil(N / G) products of each group at once
// (`mont_mul_m_l`), then every result to all G groups by full-width
// shuffles, so that they hold the same values.  G = 8 is the whole warp a
// chain (`WarpLevels`), a level taking one product's latency; G = 4 (the
// gather-sum form) serves 2 chains a warp, a level taking 2 products at
// once.
template <int NL, int G>
struct SplitLevels {
    static_assert(G == 4 || G == 8, "4 or 8 groups a chain");

    template <int N>
    __device__ __forceinline__ void operator()(
            uint32_t* const (&r)[N], const uint32_t* const (&a)[N],
            const uint32_t* const (&b)[N], const FieldL<NL>& f,
            const Lanes& ln) const {
        constexpr int K = NL / kLanes;
        constexpr int M = (N + G - 1) / G;
        const int g = ln.base / kLanes;
        const int q = g % G;                     // the group's place
        const int first = (g - q) * kLanes;      // the chain's first lane
        uint32_t x[M][K], y[M][K], p[M][K];
#pragma unroll
        for (int m = 0; m < M; m++) {
            // product m*G + q; a group past the level's last product
            // computes product m*G again, and its result is not read
#pragma unroll
            for (int k = 0; k < K; k++) {
                x[m][k] = a[m * G][k];
                y[m][k] = b[m * G][k];
            }
#pragma unroll
            for (int c = 1; c < G; c++) {
                if (m * G + c < N) {
#pragma unroll
                    for (int k = 0; k < K; k++) {
                        x[m][k] = q == c ? a[m * G + c][k] : x[m][k];
                        y[m][k] = q == c ? b[m * G + c][k] : y[m][k];
                    }
                }
            }
        }
        mont_mul_m_l<NL, M>(p, x, y, f, ln);
#pragma unroll
        for (int i = 0; i < N; i++) {
#pragma unroll
            for (int k = 0; k < K; k++)
                r[i][k] = __shfl_sync(kWarp, p[i / G][k],
                                      first + (i % G) * kLanes + ln.j);
        }
    }
};

template <int NL>
using WarpLevels = SplitLevels<NL, 8>;

// P1 += P2, complete: RCB16 algorithm 7 (a = 0) as 2 levels of 6
// products, or algorithm 1 (GA) as 3 levels of 6.  The same field values
// as ec_add_l, so the same canonical words: algorithm 7's small multiples
// move before the second level (b3*yz*xz = yz*(b3*xz), 3b3*t0*xz =
// (3*t0)*(b3*xz), 3*t0*xy = (3*t0)*xy), where they overlap the m and n of
// the same level, and leave one add or subtraction after it.
template <int NL, bool GA, class Lv>
__device__ __forceinline__ void ec_add_lv(uint32_t* X1, uint32_t* Y1,
                                          uint32_t* Z1, const uint32_t* X2,
                                          const uint32_t* Y2,
                                          const uint32_t* Z2,
                                          const FieldL<NL>& f,
                                          const Lanes& ln, const Lv& lv) {
    constexpr int K = NL / kLanes;
    uint32_t s[6][K], t0[K], t1[K], t2[K], xy[K], yz[K], xz[K];
    uint32_t m[K], n[K], p[6][K];
    add_mod_l<NL>(s[0], X1, Y1, f, ln);
    add_mod_l<NL>(s[1], X2, Y2, f, ln);
    add_mod_l<NL>(s[2], Y1, Z1, f, ln);
    add_mod_l<NL>(s[3], Y2, Z2, f, ln);
    add_mod_l<NL>(s[4], X1, Z1, f, ln);
    add_mod_l<NL>(s[5], X2, Z2, f, ln);
    {
        uint32_t* const r[6] = {t0, t1, t2, xy, yz, xz};
        const uint32_t* const a[6] = {X1, Y1, Z1, s[0], s[2], s[4]};
        const uint32_t* const b[6] = {X2, Y2, Z2, s[1], s[3], s[5]};
        lv(r, a, b, f, ln);
    }
    sub_mod_l<NL>(xy, xy, t0, f, ln);
    sub_mod_l<NL>(yz, yz, t1, f, ln);
    sub_mod_l<NL>(xz, xz, t0, f, ln);
    sub_mod_l<NL>(xy, xy, t1, f, ln);
    sub_mod_l<NL>(yz, yz, t2, f, ln);
    sub_mod_l<NL>(xz, xz, t2, f, ln);
    if constexpr (GA) {
        const CurveA<NL>& ca = *f.ca;
        uint32_t ka[K], ka2[K], kb3[K], v[6][K], u1[K], u4[K];
        lane_words<NL>(ka, ca.a, ln.j);
        lane_words<NL>(ka2, ca.a2, ln.j);
        lane_words<NL>(kb3, ca.b3, ln.j);
        {
            uint32_t* const r[6] = {v[0], v[1], v[2], v[3], v[4], v[5]};
            const uint32_t* const a[6] = {xz, t2, t2, t2, t0, xz};
            const uint32_t* const b[6] = {ka, kb3, ka, ka2, ka, kb3};
            lv(r, a, b, f, ln);
        }
        add_mod_l<NL>(u1, v[0], v[1], f, ln);       // a*xz + 3b*t2
        sub_mod_l<NL>(m, t1, u1, f, ln);
        add_mod_l<NL>(n, t1, u1, f, ln);
        mul_small_l<NL>(u1, t0, 3, f, ln);
        add_mod_l<NL>(u1, u1, v[2], f, ln);         // 3*t0 + a*t2
        sub_mod_l<NL>(u4, v[4], v[3], f, ln);
        add_mod_l<NL>(u4, v[5], u4, f, ln);         // 3b*xz + a*t0 - a^2*t2
        uint32_t* const r[6] = {p[0], p[1], p[2], p[3], p[4], p[5]};
        const uint32_t* const a[6] = {xy, yz, m, u1, yz, xy};
        const uint32_t* const b[6] = {m, u4, n, u4, n, u1};
        lv(r, a, b, f, ln);
    } else {
        uint32_t bxz[K], t03[K];
        mul_small_l<NL>(n, t2, f.b3, f, ln);        // b3*t2
        sub_mod_l<NL>(m, t1, n, f, ln);
        add_mod_l<NL>(n, t1, n, f, ln);
        mul_small_l<NL>(bxz, xz, f.b3, f, ln);
        mul_small_l<NL>(t03, t0, 3, f, ln);
        uint32_t* const r[6] = {p[0], p[1], p[2], p[3], p[4], p[5]};
        const uint32_t* const a[6] = {xy, yz, n, t03, yz, t03};
        const uint32_t* const b[6] = {m, bxz, m, bxz, n, xy};
        lv(r, a, b, f, ln);
    }
    sub_mod_l<NL>(X1, p[0], p[1], f, ln);   // xy*m - b3*yz*xz (a: yz*u4)
    add_mod_l<NL>(Y1, p[2], p[3], f, ln);   // n*m + 3b3*t0*xz (a: u1*u4)
    add_mod_l<NL>(Z1, p[4], p[5], f, ln);   // yz*n + 3*t0*xy (a: xy*u1)
}

// P = 2P, the dedicated doubling: RCB16 algorithm 9 (a = 0: 2 levels of 4
// products, 2 of them squarings, and one small multiple by b3) or
// algorithm 3 (GA: levels of 6, 7 and 4 products, a, a^2 and 3b from
// `CurveA`).
//
// On a point of the curve it gives the same projective triple as the
// complete add ec_add_l(P, P), the doubling the JAX package runs
// (`ec_double` = `ec_add(P, P)`): with the curve's equation both reduce,
// for a = 0, to X3 = 2XY(Y^2 - 9bZ^2), Y3 = Y^4 + 18bY^2Z^2 - 27b^2Z^4,
// Z3 = 8Y^3Z, and algorithm 3 is algorithm 1 with P = Q likewise; the
// identity (0 : 1 : 0) doubles to itself.  The values are canonical, so
// the words are equal.  Off the curve the two differ: the caller's points
// must be sums of curve points, as the MSM's are (`G1.from_bytes` and the
// generators check theirs).  The plain version is ops/ec.py `ec_dbl_plain`
// (the same field values: the levels only regroup algorithm 3's
// a*(X^2 - aZ^2) as a*X^2 - a^2*Z^2 and double a factor before a product
// instead of the product after it).
template <int NL, bool GA, class Lv = GroupLevels<NL>>
__device__ __forceinline__ void ec_dbl_l(uint32_t* X, uint32_t* Y,
                                         uint32_t* Z, const FieldL<NL>& f,
                                         const Lanes& ln,
                                         const Lv& lv = Lv()) {
    constexpr int K = NL / kLanes;
    if constexpr (GA) {
        const CurveA<NL>& ca = *f.ca;
        uint32_t t0[K], t1[K], t2[K], xy[K], xz[K], yz[K];
        uint32_t ka[K], ka2[K], kb3[K], v[7][K], e[K], g[K], t3[K];
        {
            uint32_t* const r[6] = {t0, t1, t2, xy, xz, yz};
            const uint32_t* const a[6] = {X, Y, Z, X, X, Y};
            const uint32_t* const b[6] = {X, Y, Z, Y, Z, Z};
            lv(r, a, b, f, ln);
        }
        add_mod_l<NL>(xz, xz, xz, f, ln);           // 2XZ
        add_mod_l<NL>(xy, xy, xy, f, ln);           // 2XY
        add_mod_l<NL>(yz, yz, yz, f, ln);           // 2YZ
        lane_words<NL>(ka, ca.a, ln.j);
        lane_words<NL>(ka2, ca.a2, ln.j);
        lane_words<NL>(kb3, ca.b3, ln.j);
        {
            uint32_t* const r[7] = {v[0], v[1], v[2], v[3], v[4], v[5],
                                    v[6]};
            const uint32_t* const a[7] = {xz, t2, xz, t2, t0, t2, yz};
            const uint32_t* const b[7] = {ka, kb3, kb3, ka, ka, ka2, t1};
            lv(r, a, b, f, ln);
        }
        add_mod_l<NL>(e, v[0], v[1], f, ln);        // 2aXZ + 3bZ^2
        sub_mod_l<NL>(g, t1, e, f, ln);             // X3 of line 11
        add_mod_l<NL>(e, t1, e, f, ln);             // Y3 of line 12
        sub_mod_l<NL>(t3, v[4], v[5], f, ln);
        add_mod_l<NL>(t3, t3, v[2], f, ln);         // a(X^2 - aZ^2) + 6bXZ
        add_mod_l<NL>(t1, t0, t0, f, ln);
        add_mod_l<NL>(t1, t1, t0, f, ln);
        add_mod_l<NL>(t1, t1, v[3], f, ln);         // 3X^2 + aZ^2
        add_mod_l<NL>(Z, v[6], v[6], f, ln);
        add_mod_l<NL>(Z, Z, Z, f, ln);              // 8Y^3Z
        {
            uint32_t* const r[4] = {t0, t2, xz, v[0]};
            const uint32_t* const a[4] = {g, xy, t1, yz};
            const uint32_t* const b[4] = {e, g, t3, t3};
            lv(r, a, b, f, ln);
        }
        add_mod_l<NL>(Y, t0, xz, f, ln);
        sub_mod_l<NL>(X, t2, v[0], f, ln);
    } else {
        uint32_t t0[K], t1[K], t2[K], xy[K], z8[K], y3[K], t3[K];
        {
            uint32_t* const r[4] = {t0, t1, t2, xy};
            const uint32_t* const a[4] = {Y, Y, Z, X};
            const uint32_t* const b[4] = {Y, Z, Z, Y};
            lv(r, a, b, f, ln);
        }
        add_mod_l<NL>(z8, t0, t0, f, ln);
        add_mod_l<NL>(z8, z8, z8, f, ln);
        add_mod_l<NL>(z8, z8, z8, f, ln);           // 8Y^2
        add_mod_l<NL>(xy, xy, xy, f, ln);           // 2XY
        mul_small_l<NL>(t2, t2, f.b3, f, ln);       // 3bZ^2
        add_mod_l<NL>(y3, t0, t2, f, ln);           // Y^2 + 3bZ^2
        add_mod_l<NL>(t3, t2, t2, f, ln);
        add_mod_l<NL>(t3, t3, t2, f, ln);
        sub_mod_l<NL>(t0, t0, t3, f, ln);           // Y^2 - 9bZ^2
        {
            uint32_t* const r[4] = {t3, Z, y3, X};
            const uint32_t* const a[4] = {t2, t1, t0, t0};
            const uint32_t* const b[4] = {z8, z8, y3, xy};
            lv(r, a, b, f, ln);
        }
        add_mod_l<NL>(Y, t3, y3, f, ln);
    }
}


}  // namespace
