// One IPA round's Fiat-Shamir step on the card, in one launch: the
// hand-written Hopper (sm_90a) kernel of the fused IPA
// (bulletproofs_tpu_torch/ops/transcript_kernels.py, ops/prover_device.py
// create_ipp_implicit_fused).  Plain C interface, built by nvcc into its own
// shared library and called through ctypes (ops/build.py).
//
// It replaces no Pallas kernel.  Its TPU counterpart is XLA code: the
// device transcript of bulletproofs_tpu/ops/transcript_device.py
// (DeviceStrobe, DeviceTranscript, serialize_points, reduce_bytes_mod_r)
// over the keccak-f1600 of bulletproofs_tpu/ops/keccak_jax.py, which the
// JAX package's fused IPA (ops/prover_device.py _ipa_fused_jit) traces
// into one program.  Its plain version is those functions' port
// (ops/transcript_device.py, ops/keccak.py), composed in
// ops/transcript_kernels.py: ipa_challenge_plain.
//
// bp_ipa_challenge, per launch, one warp whose 32 lanes run one
// instruction stream (so every full-warp shuffle is reached by all):
//   1. the round's absorb plan: the STROBE registers walked over the
//      round's stream of absorbed bytes (9 framing bytes, L's 2*mb + 1,
//      9, R's, 9: merlin's label, u32 length and begin_op flag bytes),
//      writing the framing bytes into the stream and, per keccak-f, the
//      stream index before which it runs and its padding registers.  The
//      positions depend only on the starting (pos, pos_begin), never on
//      the data;
//   2. serializes L and R (packed projective Montgomery words (3, NL, 2),
//      straight from the MSM's combine) into the stream as
//      0x04 || x_be || y_be, the identity as (0, 1): one inversion of
//      Z_L' Z_R' (an identity's Z taken as one; Montgomery's trick), then
//      lane parity picks the point for the affine and out-of-Montgomery
//      products;
//   3. absorbs the stream with all lanes: before each keccak-f, lane
//      l < 25 xors its 8 bytes of the block and of the padding into the
//      64-bit state lane it holds in a register; keccak-f1600 runs across
//      the warp (theta's column parities, the row neighbours of theta and
//      chi, and rho-pi's gather by __shfl_sync); the state is loaded and
//      stored once a launch.  The squeeze reads and zeroes the first mb
//      bytes after the challenge's forced permutation;
//   4. reduces the mb big-endian challenge bytes mod r into Montgomery
//      form (lo * R^2 + hi * R^3 through two products, lo the low NLR
//      words) and inverts u, 0 mapping to 0;
//   5. writes the (2, 2*mb + 1) point bytes and the new state as int64
//      byte values, and u and u^-1 in Montgomery form as (2, 2*NLR) int64
//      16-bit limbs, the plain-torch form the IPA's fold reads.
//
// The inversions are the variable-time safegcd of Bernstein and Yang
// (libsecp256k1's modinv32_var): divsteps in batches of 30 on the low
// words, each batch's 2x2 transition matrix then applied to the full f, g
// (signed 30-bit limbs) and d, e (kept in (-2m, m) by adding multiples of
// m that make the division by 2^30 exact), until g = 0.  Variable time is
// sound here: the inverted values (Z of the proof's L and R, the
// challenge u) are public, and the inverse being unique, the words are
// Fermat's.  Chosen over a binary extended Euclid: ~27 (Fp, 381 bits) or
// ~18 (Fr) matrix applications of 4 limb products each, against one
// multi-word halving and add per bit.  Inside a batch, g's trailing zeros
// go at once (ctz), and after each swap one multiple of f, from f's
// inverse mod 2^32 by Newton's iteration, cancels min(eta + 1, i) low
// bits of g: ~7.6 such steps a batch.
//
// What bounds it: latency.  Its work is one dependent chain: the Fp
// inversion, a few Fp products, 2-3 keccak-f, the Fr inversion.  The
// card's rates bound none of it (the function's IMADs take under 0.1 us
// at the IMAD rate).  The design shortens the chain: safegcd where
// exponentiation would take ~600 (Fp) and ~420 (Fr) dependent Montgomery
// products, one inversion for both points, keccak-f across the warp, the
// absorb a block at a time over all lanes.  What remains is the
// divsteps' scalar chains, each step waiting on the last.  Split
// of its time on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2,
// `kernel_split`: the clock64() stamps of bp_ipa_challenge_timed; 0.086
// ms a launch on BLS12-381): Fp inversion 44%, the Fp products and byte
// stores around it 19%, absorb and keccak-f 8%, u's reduction 5%, Fr
// inversion 24%.
//
// Field elements are NL little-endian 32-bit words in Montgomery form,
// canonical (< p), as in ec_common.cuh, whose CIOS mont_mul and add_mod
// serve both fields (Fr through a Field<NLR> of r's constants).  The two
// curves covered are the a = 0 ones of ec_kernels.cu: BLS12-381 (Fp 12
// words, Fr 8, mb 48) and BN254 (8, 8, 32).

#include "ec_common.cuh"

namespace {

constexpr int kStrobeR = 166;             // STROBE-128 rate
constexpr int kFlagI = 1, kFlagA = 2, kFlagC = 4, kFlagM = 16;
constexpr unsigned kWarp = 0xffffffffu;
constexpr int32_t kM30 = 0x3FFFFFFF;

__constant__ uint64_t kRoundConsts[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// rho's rotation of lane x + 5y
__constant__ int kRho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55,
                             20, 3,  10, 43, 25, 39, 41, 45, 15,
                             21, 8,  18, 2,  61, 56, 14};

// ---------------------------------------------------------------------------
// Field constants and the variable-time inverse
// ---------------------------------------------------------------------------

template <int NL>
struct Consts {
    Field<NL> f;                          // m, R mod m, -m^-1 mod 2^32
    uint32_t r2[NL];                      // R^2 mod m
    uint32_t r3[NL];                      // R^3 mod m
};

// NL words -> N limbs of 30 bits, the top limb holding the rest.
template <int NL, int N>
__device__ __forceinline__ void to_s30(int32_t* out, const uint32_t* w) {
#pragma unroll
    for (int i = 0; i < N; i++) {
        const int wi = 30 * i / 32, s = 30 * i % 32;
        uint32_t x = w[wi] >> s;
        if (s > 2 && wi + 1 < NL) x |= w[wi + 1] << (32 - s);
        out[i] = (int32_t)(i < N - 1 ? x & kM30 : x);
    }
}

// N limbs in [0, 2^30) -> NL words (s is even: two limbs cover a word).
template <int NL, int N>
__device__ __forceinline__ void from_s30(uint32_t* w, const int32_t* l) {
#pragma unroll
    for (int j = 0; j < NL; j++) {
        const int i = 32 * j / 30, s = 32 * j % 30;
        uint32_t x = (uint32_t)l[i] >> s;
        if (i + 1 < N) x |= (uint32_t)l[i + 1] << (30 - s);
        w[j] = x;
    }
}

struct Trans {                            // f' = (u f + v g) / 2^30,
    int32_t u, v, q, r;                   // g' = (q f + r g) / 2^30
};

// 30 divsteps on the low words of f and g (eta = -delta): -> the new eta
// and the transition matrix scaled by 2^30.  Only the low i bits of f
// and g are valid after 30 - i steps, and only those are read.
__device__ __forceinline__ int divsteps_30_var(int eta, uint32_t f,
                                               uint32_t g, Trans& t) {
    uint32_t u = 1, v = 0, q = 0, r = 1;
    int i = 30;
    for (;;) {
        // g's zero bits, up to i (a sentinel bit), are halvings at once
        const int zeros = __ffs((int)(g | (0xFFFFFFFFu << i))) - 1;
        g >>= zeros;
        u <<= zeros;
        v <<= zeros;
        eta -= zeros;
        i -= zeros;
        if (i == 0) break;
        if (eta < 0) {                    // swap: f, g = g, -f
            eta = -eta;
            uint32_t tmp = f;
            f = g;
            g = 0u - tmp;
            tmp = u;
            u = q;
            q = 0u - tmp;
            tmp = v;
            v = r;
            r = 0u - tmp;
        }
        // cancel min(eta + 1, i) low bits of g with one multiple of f:
        // as many steps without a swap
        const int limit = min(eta + 1, i);
        const uint32_t m = 0xFFFFFFFFu >> (32 - limit);
        uint32_t x = (3u * f) ^ 2u;       // f^-1 mod 2^5, then 2^10, 2^20,
        x *= 2u - f * x;                  // 2^40 by Newton's iteration
        x *= 2u - f * x;
        x *= 2u - f * x;
        const uint32_t w = (g * (0u - x)) & m;
        g += f * w;
        q += u * w;
        r += v * w;
    }
    t = {(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
    return eta;
}

// [d, e] = (t [d, e] + m [md, me]) / 2^30 with md, me making the low 30
// bits zero and keeping d, e in (-2m, m).
template <int N>
__device__ __forceinline__ void update_de(int32_t* d, int32_t* e,
                                          const Trans& t, const int32_t* m,
                                          uint32_t inv30) {
    const int32_t sd = d[N - 1] >> 31, se = e[N - 1] >> 31;
    int32_t md = (t.u & sd) + (t.v & se);
    int32_t me = (t.q & sd) + (t.r & se);
    int64_t cd = (int64_t)t.u * d[0] + (int64_t)t.v * e[0];
    int64_t ce = (int64_t)t.q * d[0] + (int64_t)t.r * e[0];
    md -= (int32_t)((inv30 * (uint32_t)cd + (uint32_t)md) & kM30);
    me -= (int32_t)((inv30 * (uint32_t)ce + (uint32_t)me) & kM30);
    cd += (int64_t)m[0] * md;
    ce += (int64_t)m[0] * me;
    cd >>= 30;
    ce >>= 30;
#pragma unroll
    for (int i = 1; i < N; i++) {
        cd += (int64_t)t.u * d[i] + (int64_t)t.v * e[i] + (int64_t)m[i] * md;
        ce += (int64_t)t.q * d[i] + (int64_t)t.r * e[i] + (int64_t)m[i] * me;
        d[i - 1] = (int32_t)cd & kM30;
        e[i - 1] = (int32_t)ce & kM30;
        cd >>= 30;
        ce >>= 30;
    }
    d[N - 1] = (int32_t)cd;
    e[N - 1] = (int32_t)ce;
}

// [f, g] = t [f, g] / 2^30, exact.
template <int N>
__device__ __forceinline__ void update_fg(int32_t* f, int32_t* g,
                                          const Trans& t) {
    int64_t cf = (int64_t)t.u * f[0] + (int64_t)t.v * g[0];
    int64_t cg = (int64_t)t.q * f[0] + (int64_t)t.r * g[0];
    cf >>= 30;
    cg >>= 30;
#pragma unroll
    for (int i = 1; i < N; i++) {
        cf += (int64_t)t.u * f[i] + (int64_t)t.v * g[i];
        cg += (int64_t)t.q * f[i] + (int64_t)t.r * g[i];
        f[i - 1] = (int32_t)cf & kM30;
        g[i - 1] = (int32_t)cg & kM30;
        cf >>= 30;
        cg >>= 30;
    }
    f[N - 1] = (int32_t)cf;
    g[N - 1] = (int32_t)cg;
}

template <int N>
__device__ __forceinline__ void carry30(int32_t* r) {
#pragma unroll
    for (int i = 1; i < N; i++) {
        r[i] += r[i - 1] >> 30;
        r[i - 1] &= kM30;
    }
}

// d in (-2m, m), negated where sign < 0 -> [0, m), limbs in [0, 2^30).
template <int N>
__device__ __forceinline__ void normalize(int32_t* d, int32_t sign,
                                          const int32_t* m) {
    int32_t add = d[N - 1] >> 31;
#pragma unroll
    for (int i = 0; i < N; i++) d[i] += m[i] & add;
    const int32_t neg = sign >> 31;
#pragma unroll
    for (int i = 0; i < N; i++) d[i] = (d[i] ^ neg) - neg;
    carry30<N>(d);
    add = d[N - 1] >> 31;
#pragma unroll
    for (int i = 0; i < N; i++) d[i] += m[i] & add;
    carry30<N>(d);
}

// out = a^-1 in Montgomery form, from a in Montgomery form (canonical
// words), 0 for 0: the safegcd of the words a*R gives a^-1 R^-1, one
// product by R^3 mod m makes it a^-1 R.  out may alias a.
template <int NL>
__device__ __forceinline__ void inverse_var(uint32_t* out, const uint32_t* a,
                            const Consts<NL>& c) {
    constexpr int N = (32 * NL + 29) / 30;    // 13 for NL = 12, 9 for 8
    int32_t m[N], d[N], e[N], f[N], g[N];
    to_s30<NL, N>(m, c.f.p);
    to_s30<NL, N>(g, a);
#pragma unroll
    for (int i = 0; i < N; i++) {
        d[i] = 0;
        e[i] = i == 0;
        f[i] = m[i];
    }
    const uint32_t inv30 = (0u - c.f.n0inv) & kM30;   // m^-1 mod 2^30
    int eta = -1;
    for (;;) {
        Trans t;
        eta = divsteps_30_var(eta, (uint32_t)f[0], (uint32_t)g[0], t);
        update_de<N>(d, e, t, m, inv30);
        update_fg<N>(f, g, t);
        int32_t any = 0;
#pragma unroll
        for (int i = 0; i < N; i++) any |= g[i];
        if (any == 0) break;
    }
    normalize<N>(d, f[N - 1], m);         // f = +-1 (m for a = 0, d = 0)
    uint32_t w[NL];
    from_s30<NL, N>(w, d);
    mont_mul<NL>(out, w, c.r3, c.f);
}

// ---------------------------------------------------------------------------
// The warp's keccak-f1600 and the round's absorb plan
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
    return (uint64_t)__shfl_sync(kWarp, (unsigned long long)v, src);
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
    return (x << n) | (x >> ((64 - n) & 63));   // 0 <= n < 64
}

// Lane l = x + 5y's sources (lanes 25-31 mirror 0-6 and are never read).
struct KeccakLane {
    int col1, col2, col3, col4;           // theta: (x, y + 1..4)
    int left, right, right2;              // (x - 1, y), (x + 1, y), (x + 2, y)
    int pi_src, rho;                      // rho-pi: B(x, y) = rot(A(src))
    uint64_t first;                       // all ones on lane 0 (iota)
};

__device__ __forceinline__ KeccakLane keccak_lane(int lane) {
    const int l = lane < 25 ? lane : lane - 25;
    const int x = l % 5, y = l / 5;
    const auto at = [](int xx, int yy) { return xx % 5 + 5 * (yy % 5); };
    return {at(x, y + 1), at(x, y + 2), at(x, y + 3), at(x, y + 4),
            at(x + 4, y), at(x + 1, y), at(x + 2, y),
            // B(x, y) = rot(A(x', y'), r(x', y')) with x = y', y = 2x' + 3y'
            at(3 * (y + 15 - 3 * x), 0) + 5 * x,
            lane < 25 ? kRho[lane] : 0, lane == 0 ? ~0ULL : 0ULL};
}

// keccak-f1600 with state lane l in lane l's register a.
__device__ __forceinline__ uint64_t keccak_f1600_warp(uint64_t a,
                                                      const KeccakLane& k) {
#pragma unroll 1
    for (int rnd = 0; rnd < 24; rnd++) {
        const uint64_t c = a ^ shfl64(a, k.col1) ^ shfl64(a, k.col2)
                           ^ shfl64(a, k.col3) ^ shfl64(a, k.col4);
        a ^= shfl64(c, k.left) ^ rotl64(shfl64(c, k.right), 1);
        const uint64_t b = shfl64(rotl64(a, k.rho), k.pi_src);
        a = b ^ (~shfl64(b, k.right) & shfl64(b, k.right2));
        a ^= kRoundConsts[rnd] & k.first;
    }
    return a;
}

// The STROBE registers (transcript/strobe.py) walked over a round's stream
// of absorbed bytes, with no state: writes the framing bytes at their
// stream index and, per keccak-f, (stream index before which it runs, pos,
// pos_begin) into perm.  All lanes walk alike and write the same values.
struct Walk {
    uint8_t* msg;
    int* perm;
    int pos, pos_begin, k, n_perm;

    __device__ void permute() {
        perm[3 * n_perm] = k;
        perm[3 * n_perm + 1] = pos;
        perm[3 * n_perm + 2] = pos_begin;
        n_perm++;
        pos = 0;
        pos_begin = 0;
    }

    __device__ void absorb(int len) {
        while (len > 0) {
            const int take = min(len, kStrobeR - pos);
            pos += take;
            k += take;
            len -= take;
            if (pos == kStrobeR) permute();
        }
    }

    __device__ void put(int b) {
        msg[k] = (uint8_t)b;
        absorb(1);
    }

    __device__ void begin_op(int flags) {  // a new op (`more` false)
        const int old_begin = pos_begin;
        pos_begin = pos + 1;
        put(old_begin);
        put(flags);
        if ((flags & kFlagC) && pos != 0) permute();
    }

    // merlin: meta_ad(label), meta_ad(u32 LE length, more)
    __device__ void label_and_length(uint8_t label, int len) {
        begin_op(kFlagM | kFlagA);
        put(label);
        for (int b = 0; b < 4; b++) put(len >> (8 * b));
    }
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ void stamp(long long* stamps, int i) {
    if (stamps != nullptr && threadIdx.x == 0) stamps[i] = clock64();
}

// L and R of (3, NLP, 2) packed projective Montgomery words -> their
// G1.to_bytes forms 0x04 || x || y (MB = 4*NLP big-endian bytes each) at
// outL and outR, written by lanes 0 (L) and 1 (R).
template <int NLP>
__device__ __forceinline__ void serialize_pair(uint8_t* outL, uint8_t* outR,
                               const uint32_t* pts, const Consts<NLP>& c,
                               long long* stamps) {
    const Field<NLP>& f = c.f;
    const int k = threadIdx.x & 1;        // this lane's point
    uint32_t zl[NLP], zr[NLP], inv[NLP];
    bool id_l = true, id_r = true;
#pragma unroll
    for (int w = 0; w < NLP; w++) {
        zl[w] = pts[(2 * NLP + w) * 2];
        zr[w] = pts[(2 * NLP + w) * 2 + 1];
        id_l = id_l && zl[w] == 0;
        id_r = id_r && zr[w] == 0;
    }
#pragma unroll
    for (int w = 0; w < NLP; w++) {       // an identity's Z taken as one
        if (id_l) zl[w] = f.one[w];
        if (id_r) zr[w] = f.one[w];
    }
    uint32_t X[NLP], Y[NLP], one[NLP];    // loaded before the inversion
#pragma unroll
    for (int w = 0; w < NLP; w++) {
        X[w] = pts[w * 2 + k];
        Y[w] = pts[(NLP + w) * 2 + k];
        one[w] = w == 0;
    }
    mont_mul<NLP>(inv, zl, zr, f);
    inverse_var<NLP>(inv, inv, c);        // (Z_L' Z_R')^-1
    stamp(stamps, 1);
#pragma unroll
    for (int w = 0; w < NLP; w++) zl[w] = k ? zl[w] : zr[w];
    mont_mul<NLP>(inv, inv, zl, f);       // Z_k^-1: times the other Z'
    mont_mul<NLP>(X, X, inv, f);
    mont_mul<NLP>(Y, Y, inv, f);
    mont_mul<NLP>(X, X, one, f);          // out of Montgomery form
    mont_mul<NLP>(Y, Y, one, f);
    if (k ? id_r : id_l) {                // affine() of the identity
#pragma unroll
        for (int w = 0; w < NLP; w++) {
            X[w] = 0;
            Y[w] = one[w];
        }
    }
    if (threadIdx.x < 2) {
        uint8_t* out = k ? outR : outL;
        out[0] = 4;
        constexpr int MB = 4 * NLP;
#pragma unroll
        for (int j = 0; j < MB; j++) {    // big-endian byte j
            const int w = (MB - 1 - j) / 4, sh = 8 * ((MB - 1 - j) % 4);
            out[1 + j] = (uint8_t)(X[w] >> sh);
            out[1 + MB + j] = (uint8_t)(Y[w] >> sh);
        }
    }
}

// Little-endian 32-bit word k of mb big-endian bytes.
__device__ __forceinline__ uint32_t be_word(const uint8_t* c, int mb,
                                            int k) {
    const int b = mb - 4 - 4 * k;         // the word's most significant byte
    return ((uint32_t)c[b] << 24) | ((uint32_t)c[b + 1] << 16)
           | ((uint32_t)c[b + 2] << 8) | c[b + 3];
}

// stamps: null, or 7 clock64() readings of lane 0 for the split of the
// time (bp_ipa_challenge_timed): start, after the Fp inversion, after the
// serialization, after the absorb and squeeze, after u's reduction, after
// the Fr inversion, at the end.
template <int NLP, int NLR>
__global__ void __launch_bounds__(32)
ipa_challenge_kernel(long long* out_bytes, long long* out_state,
                     long long* out_u, const uint32_t* pts,
                     const long long* state, int pos, int pos_begin,
                     const __grid_constant__ Consts<NLP> fp,
                     const __grid_constant__ Consts<NLR> fr,
                     long long* stamps) {
    constexpr int MB = 4 * NLP, PB = 2 * MB + 1, MW = MB / 4;
    constexpr int kL = 9, kR = 18 + PB;   // L's and R's stream offsets
    static_assert(MW <= 2 * NLR, "the challenge's high words must be < r");
    __shared__ uint8_t msg[27 + 2 * PB];
    __shared__ int perm[9];               // at most 3 keccak-f a round
    __shared__ uint64_t chal[MB / 8];
    const int lane = threadIdx.x;
    stamp(stamps, 0);

    Walk walk{msg, perm, pos, pos_begin, 0, 0};
    walk.label_and_length('L', PB);
    walk.begin_op(kFlagA);
    walk.absorb(PB);
    walk.label_and_length('R', PB);
    walk.begin_op(kFlagA);
    walk.absorb(PB);
    walk.label_and_length('u', MB);
    walk.begin_op(kFlagI | kFlagA | kFlagC);   // ends in a keccak-f
    uint64_t a = 0;                       // loaded before the inversion
    if (lane < 25) {                      // hides its latency
#pragma unroll
        for (int b = 0; b < 8; b++)
            a |= (uint64_t)(state[8 * lane + b] & 0xFF) << (8 * b);
    }
    serialize_pair<NLP>(msg + kL, msg + kR, pts, fp, stamps);
    __syncwarp();
    stamp(stamps, 2);
    for (int i = lane; i < 2 * PB; i += 32)
        out_bytes[i] = msg[i < PB ? kL + i : kR - PB + i];

    // each block: stream bytes k0.. at state offsets p0..p1, then padding
    const KeccakLane kl = keccak_lane(lane);
    int k0 = 0, p0 = pos;
    for (int j = 0; j < walk.n_perm; j++) {
        const int k1 = perm[3 * j], p1 = perm[3 * j + 1];
        const int pb = perm[3 * j + 2];
        uint64_t x = 0;
#pragma unroll
        for (int b = 0; b < 8; b++) {
            const int q = 8 * lane + b;
            int byte = 0;
            if (q >= p0 && q < p1) byte = msg[k0 + q - p0];
            if (q == p1) byte ^= pb;
            if (q == p1 + 1) byte ^= 0x04;
            if (q == kStrobeR + 1) byte ^= 0x80;
            x |= (uint64_t)(byte & 0xFF) << (8 * b);
        }
        a = keccak_f1600_warp(a ^ x, kl);
        k0 = k1;
        p0 = 0;
    }
    if (lane < MB / 8) {                  // squeeze mb bytes from offset 0
        chal[lane] = a;
        a = 0;
    }
    if (lane < 25) {
#pragma unroll
        for (int b = 0; b < 8; b++)
            out_state[8 * lane + b] = (a >> (8 * b)) & 0xFF;
    }
    __syncwarp();
    stamp(stamps, 3);

    // u = (lo + hi * 2^(32 NLR)) mod r in Montgomery form: lo * R^2 and
    // hi * R^3 through mont_mul (exact for lo < R, hi < r), then added
    const uint8_t* c = reinterpret_cast<const uint8_t*>(chal);
    uint32_t lo[NLR], hi[NLR], u[NLR], t[NLR];
#pragma unroll
    for (int k = 0; k < NLR; k++) {
        lo[k] = be_word(c, MB, k);
        hi[k] = NLR + k < MW ? be_word(c, MB, NLR + k) : 0;
    }
    mont_mul<NLR>(u, lo, fr.r2, fr.f);
    mont_mul<NLR>(t, hi, fr.r3, fr.f);
    add_mod<NLR>(u, u, t, fr.f);
    stamp(stamps, 4);
    inverse_var<NLR>(t, u, fr);
    stamp(stamps, 5);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NLR; k++) {
            out_u[2 * k] = u[k] & 0xFFFF;
            out_u[2 * k + 1] = u[k] >> 16;
            out_u[2 * NLR + 2 * k] = t[k] & 0xFFFF;
            out_u[2 * NLR + 2 * k + 1] = t[k] >> 16;
        }
    }
    stamp(stamps, 6);
}

// consts (host memory): m[nl], one[nl], n0inv, 0, R^2 mod m[nl],
// R^3 mod m[nl].
template <int NL>
Consts<NL> make_consts(const uint32_t* consts) {
    Consts<NL> c;
    c.f = make_field<NL>(consts);
    std::memcpy(c.r2, consts + 2 * NL + 2, NL * sizeof(uint32_t));
    std::memcpy(c.r3, consts + 3 * NL + 2, NL * sizeof(uint32_t));
    return c;
}

int launch_ipa_challenge(void* out_bytes, void* out_state, void* out_u,
                         const void* pts, const void* state, int pos,
                         int pos_begin, int nlp, int nlr, int mb,
                         const void* consts_p, const void* consts_r,
                         void* stamps, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* cp = static_cast<const uint32_t*>(consts_p);
    const uint32_t* cr = static_cast<const uint32_t*>(consts_r);
    if (pos < 0 || pos >= kStrobeR || pos_begin < 0 || pos_begin > kStrobeR
        || mb != 4 * nlp || nlr != 8 || (nlp != 12 && nlp != 8))
        return (int)cudaErrorInvalidValue;
    auto* ob = static_cast<long long*>(out_bytes);
    auto* os = static_cast<long long*>(out_state);
    auto* ou = static_cast<long long*>(out_u);
    const auto* p = static_cast<const uint32_t*>(pts);
    const auto* s = static_cast<const long long*>(state);
    auto* ts = static_cast<long long*>(stamps);
    if (nlp == 12)
        ipa_challenge_kernel<12, 8><<<1, 32, 0, st>>>(
            ob, os, ou, p, s, pos, pos_begin, make_consts<12>(cp),
            make_consts<8>(cr), ts);
    else
        ipa_challenge_kernel<8, 8><<<1, 32, 0, st>>>(
            ob, os, ou, p, s, pos, pos_begin, make_consts<8>(cp),
            make_consts<8>(cr), ts);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out_bytes (2, 2*mb + 1), out_state (200,), out_u (2, 2*nlr) int64;
// pts (3, nlp, 2) int32 packed words; state (200,) int64 byte values;
// consts_p and consts_r, nlp and nlr words each where a field element:
// the modulus, R mod it, -modulus^-1 mod 2^32, 0, R^2 and R^3 mod it.
// Returns cudaGetLastError() after the launch; shapes other than (nlp, nlr,
// mb) = (12, 8, 48) or (8, 8, 32), or registers outside the state, give
// cudaErrorInvalidValue.
int bp_ipa_challenge(void* out_bytes, void* out_state, void* out_u,
                     const void* pts, const void* state, int pos,
                     int pos_begin, int nlp, int nlr, int mb,
                     const void* consts_p, const void* consts_r,
                     void* stream) {
    return launch_ipa_challenge(out_bytes, out_state, out_u, pts, state, pos,
                                pos_begin, nlp, nlr, mb, consts_p, consts_r,
                                nullptr, stream);
}

// bp_ipa_challenge, also writing lane 0's 7 clock64() stamps (int64) to
// stamps: the split of the kernel's time, for measurement only.
int bp_ipa_challenge_timed(void* out_bytes, void* out_state, void* out_u,
                           const void* pts, const void* state, int pos,
                           int pos_begin, int nlp, int nlr, int mb,
                           const void* consts_p, const void* consts_r,
                           void* stamps, void* stream) {
    return launch_ipa_challenge(out_bytes, out_state, out_u, pts, state, pos,
                                pos_begin, nlp, nlr, mb, consts_p, consts_r,
                                stamps, stream);
}

}  // extern "C"
