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
// bp_ipa_challenge, per launch:
//   1. lanes 0 and 1 each serialize one of the round's combined points L, R
//      (packed projective Montgomery words (3, NL, 2), straight from the
//      MSM's combine) to 0x04 || x_be || y_be, the identity as (0, 1):
//      a Fermat inversion of Z, two products into affine form, two out of
//      Montgomery form;
//   2. lane 0 runs the round's STROBE-128 schedule on the 200-byte state:
//      append_message "L", append_message "R", challenge_bytes "u" of mb
//      bytes, with keccak-f1600 wherever the position reaches the rate.
//      The round's starting (pos, pos_begin) are launch parameters: they
//      depend on the schedule only, never on the data, and the host works
//      them out;
//   3. lane 0 reduces the mb big-endian challenge bytes mod r into
//      Montgomery form (lo * R^2 + hi * R^3 through two products, lo the
//      low NLR words) and inverts u by Fermat, 0 mapping to 0;
//   4. writes the (2, 2*mb + 1) point bytes and the new state as int64
//      byte values, and u and u^-1 in Montgomery form as (2, 2*NLR) int64
//      16-bit limbs, the plain-torch form the IPA's fold reads.
//
// What bounds it: latency.  Its work is one sequential chain: a Fermat
// inversion in Fp (~380 squarings on BLS12-381, one thread, the two points'
// in parallel on two lanes), 2-3 keccak permutations, and a Fermat
// inversion in Fr (~255 squarings), each step depending on the one before.
// The card's rates bound none of it (its IMADs take under 0.1 us at the
// IMAD rate); one thread's dependent products do.  One warp is launched,
// two of its lanes work.  Addition chains and a multi-lane product are
// later work.
//
// Field elements are NL little-endian 32-bit words in Montgomery form,
// canonical (< p), as in ec_common.cuh, whose CIOS mont_mul and add_mod
// serve both fields (Fr through a Field<NLR> of r's constants).  The two
// curves covered are the a = 0 ones of ec_kernels.cu: BLS12-381 (Fp 12
// words, Fr 8, mb 48) and BN254 (8, 8, 32).

#include "ec_common.cuh"

namespace {

constexpr int kStrobeR = 166;             // STROBE-128 rate
constexpr int kFlagI = 1, kFlagA = 2, kFlagC = 4, kFlagM = 16, kFlagK = 32;

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

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
    return (x << n) | (x >> (64 - n));    // 0 < n < 64
}

// keccak-f1600 on 25 lanes, lane x + 5y.  Rho and pi walk the lanes in
// pi's cycle from lane 1 (the tables of the reference implementation,
// rotations 1..62), so every shift is a constant once unrolled.
__device__ __forceinline__ void keccak_f1600(uint64_t* a) {
    constexpr int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                              27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
    constexpr int piln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                              15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
    for (int rnd = 0; rnd < 24; rnd++) {
        uint64_t c[5];
#pragma unroll
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
        for (int x = 0; x < 5; x++) {
            const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
            for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
        }
        uint64_t t = a[1];
#pragma unroll
        for (int i = 0; i < 24; i++) {
            const uint64_t next = a[piln[i]];
            a[piln[i]] = rotl64(t, rotc[i]);
            t = next;
        }
#pragma unroll
        for (int y = 0; y < 25; y += 5) {
#pragma unroll
            for (int x = 0; x < 5; x++) c[x] = a[y + x];
#pragma unroll
            for (int x = 0; x < 5; x++)
                a[y + x] = c[x] ^ (~c[(x + 1) % 5] & c[(x + 2) % 5]);
        }
        a[0] ^= kRoundConsts[rnd];
    }
}

// STROBE-128 over a 200-byte state in shared memory: the subset of
// transcript/strobe.py that merlin's append_message and challenge_bytes
// use, byte by byte, in the host's order of state updates.
struct Strobe {
    uint64_t* lanes;                      // 25 lanes = the 200 bytes
    int pos, pos_begin;

    __device__ uint8_t* bytes() { return reinterpret_cast<uint8_t*>(lanes); }

    __device__ void run_f() {
        uint8_t* s = bytes();
        s[pos] ^= (uint8_t)pos_begin;
        s[pos + 1] ^= 0x04;
        s[kStrobeR + 1] ^= 0x80;
        uint64_t a[25];
#pragma unroll
        for (int i = 0; i < 25; i++) a[i] = lanes[i];
        keccak_f1600(a);
#pragma unroll
        for (int i = 0; i < 25; i++) lanes[i] = a[i];
        pos = 0;
        pos_begin = 0;
    }

    __device__ void absorb(uint8_t b) {
        bytes()[pos++] ^= b;
        if (pos == kStrobeR) run_f();
    }

    __device__ uint8_t squeeze() {
        uint8_t* s = bytes();
        const uint8_t b = s[pos];
        s[pos++] = 0;
        if (pos == kStrobeR) run_f();
        return b;
    }

    __device__ void begin_op(int flags) {  // a new op (`more` false)
        const int old_begin = pos_begin;
        pos_begin = pos + 1;
        absorb((uint8_t)old_begin);
        absorb((uint8_t)flags);
        if ((flags & (kFlagC | kFlagK)) && pos != 0) run_f();
    }

    // merlin: meta_ad(label), meta_ad(u32 LE length, more)
    __device__ void label_and_length(uint8_t label, uint32_t len) {
        begin_op(kFlagM | kFlagA);
        absorb(label);
        for (int k = 0; k < 4; k++) absorb((uint8_t)(len >> (8 * k)));
    }

    __device__ void append_message(uint8_t label, const uint8_t* msg,
                                   int len) {
        label_and_length(label, (uint32_t)len);
        begin_op(kFlagA);
        for (int i = 0; i < len; i++) absorb(msg[i]);
    }

    __device__ void challenge_bytes(uint8_t label, uint8_t* out, int len) {
        label_and_length(label, (uint32_t)len);
        begin_op(kFlagI | kFlagA | kFlagC);
        for (int i = 0; i < len; i++) out[i] = squeeze();
    }
};

// r = a^(p-2) in Montgomery form (a^-1 for a != 0, 0 for 0): left-to-right
// square-and-multiply over every bit of p - 2 from the top word's, from
// Montgomery one.  Any exact chain gives the same canonical words.
template <int NL>
__device__ void fermat_inverse(uint32_t* r, const uint32_t* a,
                               const Field<NL>& f) {
    uint32_t e[NL];
    uint64_t br = 2;
#pragma unroll
    for (int i = 0; i < NL; i++) {        // e = p - 2
        const uint64_t t = (uint64_t)f.p[i] - br;
        e[i] = (uint32_t)t;
        br = t >> 63;
    }
    uint32_t acc[NL];
#pragma unroll
    for (int i = 0; i < NL; i++) acc[i] = f.one[i];
    for (int w = NL - 1; w >= 0; w--) {
        for (int b = 31; b >= 0; b--) {
            mont_mul<NL>(acc, acc, acc, f);
            if ((e[w] >> b) & 1) mont_mul<NL>(acc, acc, a, f);
        }
    }
#pragma unroll
    for (int i = 0; i < NL; i++) r[i] = acc[i];
}

template <int NLR>
struct FrConsts {
    Field<NLR> f;                         // r, R mod r, -r^-1 mod 2^32
    uint32_t r2[NLR];                     // R^2 mod r
    uint32_t r3[NLR];                     // R^3 mod r
};

// Point k of (3, NLP, 2) packed projective Montgomery words -> its
// G1.to_bytes form: 0x04 || x || y, each MB = 4*NLP big-endian bytes.
template <int NLP>
__device__ void serialize_point(uint8_t* out, const uint32_t* pts, int k,
                                const Field<NLP>& f) {
    uint32_t X[NLP], Y[NLP], Z[NLP], zinv[NLP], one[NLP];
    bool is_id = true;
#pragma unroll
    for (int w = 0; w < NLP; w++) {
        X[w] = pts[w * 2 + k];
        Y[w] = pts[(NLP + w) * 2 + k];
        Z[w] = pts[(2 * NLP + w) * 2 + k];
        is_id = is_id && Z[w] == 0;
        one[w] = w == 0;
    }
    fermat_inverse<NLP>(zinv, Z, f);
    mont_mul<NLP>(X, X, zinv, f);
    mont_mul<NLP>(Y, Y, zinv, f);
    mont_mul<NLP>(X, X, one, f);          // out of Montgomery form
    mont_mul<NLP>(Y, Y, one, f);
    if (is_id) {                          // affine() of the identity
#pragma unroll
        for (int w = 0; w < NLP; w++) {
            X[w] = 0;
            Y[w] = one[w];
        }
    }
    out[0] = 4;
    constexpr int MB = 4 * NLP;
#pragma unroll
    for (int j = 0; j < MB; j++) {        // big-endian byte j
        const int w = (MB - 1 - j) / 4, sh = 8 * ((MB - 1 - j) % 4);
        out[1 + j] = (uint8_t)(X[w] >> sh);
        out[1 + MB + j] = (uint8_t)(Y[w] >> sh);
    }
}

// Little-endian 32-bit word k of mb big-endian bytes.
__device__ __forceinline__ uint32_t be_word(const uint8_t* c, int mb,
                                            int k) {
    const int b = mb - 4 - 4 * k;         // the word's most significant byte
    return ((uint32_t)c[b] << 24) | ((uint32_t)c[b + 1] << 16)
           | ((uint32_t)c[b + 2] << 8) | c[b + 3];
}

template <int NLP, int NLR>
__global__ void __launch_bounds__(32)
ipa_challenge_kernel(long long* out_bytes, long long* out_state,
                     long long* out_u, const uint32_t* pts,
                     const long long* state, int pos, int pos_begin,
                     Field<NLP> fp, FrConsts<NLR> fr) {
    constexpr int MB = 4 * NLP, PB = 2 * MB + 1, MW = MB / 4;
    static_assert(MW <= 2 * NLR, "the challenge's high words must be < r");
    __shared__ uint64_t lanes[25];
    __shared__ uint8_t pb[2][PB];
    const int lane = threadIdx.x;
    uint8_t* s = reinterpret_cast<uint8_t*>(lanes);
    for (int i = lane; i < 200; i += 32) s[i] = (uint8_t)state[i];
    if (lane < 2) serialize_point<NLP>(pb[lane], pts, lane, fp);
    __syncthreads();
    for (int i = lane; i < 2 * PB; i += 32) out_bytes[i] = pb[i / PB][i % PB];
    if (lane != 0) return;

    Strobe st{lanes, pos, pos_begin};
    st.append_message('L', pb[0], PB);
    st.append_message('R', pb[1], PB);
    uint8_t c[MB];
    st.challenge_bytes('u', c, MB);
    for (int i = 0; i < 200; i++) out_state[i] = s[i];

    // u = (lo + hi * 2^(32 NLR)) mod r in Montgomery form: lo * R^2 and
    // hi * R^3 through mont_mul (exact for lo < R, hi < r), then added
    uint32_t lo[NLR], hi[NLR], u[NLR], t[NLR];
#pragma unroll
    for (int k = 0; k < NLR; k++) {
        lo[k] = be_word(c, MB, k);
        hi[k] = NLR + k < MW ? be_word(c, MB, NLR + k) : 0;
    }
    mont_mul<NLR>(u, lo, fr.r2, fr.f);
    mont_mul<NLR>(t, hi, fr.r3, fr.f);
    add_mod<NLR>(u, u, t, fr.f);
    fermat_inverse<NLR>(t, u, fr.f);
#pragma unroll
    for (int k = 0; k < NLR; k++) {
        out_u[2 * k] = u[k] & 0xFFFF;
        out_u[2 * k + 1] = u[k] >> 16;
        out_u[2 * NLR + 2 * k] = t[k] & 0xFFFF;
        out_u[2 * NLR + 2 * k + 1] = t[k] >> 16;
    }
}

template <int NLR>
FrConsts<NLR> make_fr(const uint32_t* consts) {
    FrConsts<NLR> c;
    c.f = make_field<NLR>(consts);
    std::memcpy(c.r2, consts + 2 * NLR + 2, NLR * sizeof(uint32_t));
    std::memcpy(c.r3, consts + 3 * NLR + 2, NLR * sizeof(uint32_t));
    return c;
}

template <int NLP, int NLR>
int launch_ipa_challenge(void* out_bytes, void* out_state, void* out_u,
                         const void* pts, const void* state, int pos,
                         int pos_begin, const uint32_t* cp,
                         const uint32_t* cr, cudaStream_t st) {
    ipa_challenge_kernel<NLP, NLR><<<1, 32, 0, st>>>(
        static_cast<long long*>(out_bytes),
        static_cast<long long*>(out_state), static_cast<long long*>(out_u),
        static_cast<const uint32_t*>(pts),
        static_cast<const long long*>(state), pos, pos_begin,
        make_field<NLP>(cp), make_fr<NLR>(cr));
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out_bytes (2, 2*mb + 1), out_state (200,), out_u (2, 2*nlr) int64;
// pts (3, nlp, 2) int32 packed words; state (200,) int64 byte values;
// consts_p: p, R mod p, -p^-1 mod 2^32, 3b (nlp words each where a field
// element); consts_r: r, R mod r, -r^-1 mod 2^32, 0, R^2 mod r, R^3 mod r.
// Returns cudaGetLastError() after the launch; shapes other than (nlp, nlr,
// mb) = (12, 8, 48) or (8, 8, 32), or registers outside the state, give
// cudaErrorInvalidValue.
int bp_ipa_challenge(void* out_bytes, void* out_state, void* out_u,
                     const void* pts, const void* state, int pos,
                     int pos_begin, int nlp, int nlr, int mb,
                     const void* consts_p, const void* consts_r,
                     void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* cp = static_cast<const uint32_t*>(consts_p);
    const uint32_t* cr = static_cast<const uint32_t*>(consts_r);
    if (pos < 0 || pos >= kStrobeR || pos_begin < 0 || pos_begin > kStrobeR
        || mb != 4 * nlp || nlr != 8)
        return (int)cudaErrorInvalidValue;
    if (nlp == 12)
        return launch_ipa_challenge<12, 8>(out_bytes, out_state, out_u, pts,
                                           state, pos, pos_begin, cp, cr, st);
    if (nlp == 8)
        return launch_ipa_challenge<8, 8>(out_bytes, out_state, out_u, pts,
                                          state, pos, pos_begin, cp, cr, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
