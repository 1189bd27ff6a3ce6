// Kernel 5, hand-written for Hopper (sm_90a): one bucket round (kernel 4's
// function) whose Montgomery products run their REDC's fixed-operand
// halves on the int8 tensor cores.  Plain C interface, built by nvcc into
// its own shared library beside ec_kernels.cu's and called through ctypes
// (bulletproofs_tpu_torch/ops/build.py, ec_kernels.py).
//
// It replaces the Pallas TPU kernel of bulletproofs_tpu/ops/ec_pallas.py:
//   bp_bucket_round_add_mxu <- bucket_round_add_pallas_mxu (:217; body
//   _round_kernel_mxu :189, product _mxu_mont_mul_factory :119)
//
// What it computes.  What kernel 4 (bp_bucket_round_add) computes, from the
// same operands: acc (3, NL, S) in, out (3, NL, S) (out may alias acc), the
// packed projective table (n, 3NL), ids and found (S,); every slot adds row
// ids[s], or the identity (0 : 1 : 0) where found is 0, by the complete
// RCB16 add.  It has kernel 4's form (ec_lanes.cuh): 4 lanes a slot, rows
// read by id, warp-uniform control (`proj_round_l`).  Only the Montgomery
// product differs: separated REDC (`mont_mul_mxu_l`).
//   1. T = a*b, 2NL words, by operand scanning over the lanes on IMAD with
//      PTX carry chains (both operands vary: no fixed table).
//   2. m = (T_lo * N') mod R and m * N as byte-sliced Toeplitz products
//      (the tables of ops/field.py mxu_tables, unbiased: unsigned bytes) on
//      mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32.  Every column sum is
//      exact: at most L8 = 4NL products of two bytes, < 2^22.
//   3. (T + m*N) / R and one conditional subtraction: canonical, so the
//      words equal kernel 4's.
//
// Fragment mapping: the table is A and a warp's 8 slots are B's columns.
// An mma's groupID (lane / 4) and threadID_in_group (lane % 4) are exactly
// a slot's group and its lane j, so B's column g is group g's input: lane
// j holds words jK .. jK + K - 1 of each operand (K = NL / 4) and passes
// them as they are, as b0 and b1 of 32-byte k-tiles (slot 2t of its words
// in b0 of k-tile t, slot 2t + 1 in b1; the host orders A's columns to
// match).  A is fixed, packed on the host in fragment order
// (ops/ec_kernels.py: _mxu_fragments) and copied into shared memory.  D's
// rows are 16 output bytes and its columns the 8 slots, so a slot's sums
// land in all 8 groups: each warp transposes D through its own buffer in
// shared memory (8 slots x (4NL + 4) words for m, x (8NL + 4) for m*N),
// and each lane reads back its words' byte columns, 4 at a time.
// BLS12-381: 6 mma for m and 12 for m*N a product of 8 slots (2 k-tiles);
// BN254: 2 and 4.  In the host's column order no block of the triangular
// tables is all zero, so none is skipped.
//
// The other mapping, slots as A's rows (rows 8-15 zero) and the table as
// B, needs no transposition but issues twice the mma (36 and 12) and held
// 144 registers on BLS12-381.  Raced on an NVIDIA H100, the columns won and
// the rows mapping was removed (PERF.md section 6).
//
// What bounds it.  Per product and 8 slots, on BLS12-381: 72 IMAD a lane
// for T (CIOS takes 144), 18 mma, ~40 shuffles and ballots, and the
// transposition's 12 shared stores and 3 loads a lane; the int8 tensor
// work (18 * 4096 multiply-adds issued) is far below the IMAD work at the
// card's rates, so like kernel 4 it is bound by the latency of each
// group's dependent chain of products at this occupancy.

#include "ec_lanes.cuh"

namespace {

// The tensor-core REDC's shape for NL-word elements.
template <int NL>
struct MxuShape {
    static constexpr int K = NL / kLanes;      // words a lane
    static constexpr int kTiles = (K + 1) / 2;  // 32-byte k-tiles an input
    // the tables' fragments (uint32 words): (m-tile, k-tile) blocks of m
    // (K m-tiles of 16 output bytes) then m*N (2K), 32 lanes of 4 words
    static constexpr int kWords = kTiles * 6 * K * 64;
    // a warp's transposition buffer, a row per slot (4 words of padding
    // keep the stores free of bank conflicts)
    static constexpr int kTransM = 4 * NL + 4;
    static constexpr int kTransN = 8 * NL + 4;
    static constexpr int kTransWarp = 8 * (kTransM + kTransN);
};

// The byte columns of an output word, c0 + 2^8 c1 + 2^16 c2 + 2^24 c3
// (each < 2^22), as one 64-bit value.
__device__ __forceinline__ uint64_t word_of_cols(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3) {
    return (uint64_t)c0 + ((uint64_t)c1 << 8) + ((uint64_t)c2 << 16)
           + ((uint64_t)c3 << 24);
}

// d += A * B for one m16n8k32 tile of unsigned bytes, int32 sums, the
// registers of the PTX ISA's fragments.
__device__ __forceinline__ void mma_u8(uint32_t* d, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Slot 2t + half of this lane's K words x, or 0 past them (padding).
template <int K>
__device__ __forceinline__ uint32_t slot_word(const uint32_t* x, int t,
                                              int half) {
    return 2 * t + half < K ? x[2 * t + half] : 0u;
}

// Where a product's byte columns come from: the fragments of the tables in
// shared memory, and the warp's transposition buffer.
struct MxuTab {
    const uint32_t* frag;   // this lane's entry of the first block
    uint32_t* trans;        // the warp's transposition buffer
};

// The table is A, the 8 slots' x are B's columns (b0, b1), so D's rows
// are output bytes 16 mt .. 16 mt + 15 and its columns slots; they go to
// the warp's transposition buffer (slot s's row from trans + s * row_len),
// in byte order.
template <int NL, int m_tiles>
__device__ __forceinline__ void stage_cols(const uint32_t* x,
                                           const MxuTab& tab, int first,
                                           uint32_t* trans, int row_len,
                                           const Lanes& ln) {
    using Sh = MxuShape<NL>;
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int mt = 0; mt < m_tiles; mt++) {
        uint32_t d[4] = {};
#pragma unroll
        for (int kt = 0; kt < Sh::kTiles; kt++) {
            const uint4 a = reinterpret_cast<const uint4*>(tab.frag)[
                (first + mt * Sh::kTiles + kt) * 32];
            mma_u8(d, a.x, a.y, a.z, a.w, slot_word<Sh::K>(x, kt, 0),
                   slot_word<Sh::K>(x, kt, 1));
        }
        uint32_t* r = trans + 2 * ln.j * row_len + 16 * mt + g;
        r[0] = d[0];
        r[row_len] = d[1];
        r[8] = d[2];
        r[row_len + 8] = d[3];
    }
    __syncwarp();
}

// The 64-bit value of this group's output word at byte column c of its
// row.
__device__ __forceinline__ uint64_t word_cols(const uint32_t* row, int c) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + c);
    return word_of_cols(v.x, v.y, v.z, v.w);
}

// r = a*b*R^-1 mod p, canonical in and out, lanes as in ec_lanes.cuh.
template <int NL>
__device__ __forceinline__ void mont_mul_mxu_l(uint32_t* r, const uint32_t* a,
                                               const uint32_t* b,
                                               const FieldL<NL>& f,
                                               const Lanes& ln,
                                               const MxuTab& tab) {
    using Sh = MxuShape<NL>;
    constexpr int K = Sh::K;
    const int g = (threadIdx.x & 31) >> 2;
    uint32_t* trans_m = tab.trans;
    uint32_t* trans_n = tab.trans + 8 * Sh::kTransM;
    // 1. T = a*b: mont_mul_l's steps without q*p.  The word leaving lane 0
    //    at step i is T's word i, kept by lane i / K (its own when i < K);
    //    the accumulator ends holding T_hi, lane j's spill due on lane j + 1.
    uint32_t t[K], lo[K];
#pragma unroll
    for (int k = 0; k < K; k++) {
        t[k] = 0u;
        lo[k] = 0u;
    }
    uint32_t s0 = 0u, s1 = 0u;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        const uint32_t ai = ln.bcast(a[i % K], i / K);
        mac_row<K>(t, s0, s1, ai, b);
        const uint32_t w = i < K ? t[0] : ln.bcast(t[0], 0);
        if (ln.j == i / K) lo[i % K] = w;
        const uint32_t down = ln.from_next(t[0]);
#pragma unroll
        for (int k = 0; k < K - 1; k++) t[k] = t[k + 1];
        t[K - 1] = add_cc(down, s0);
        s0 = addc(s1, 0u);
        s1 = 0u;
    }
    const uint32_t spill = ln.from_prev(s0);

    // 2. m = (T_lo * N') mod R: the lane's byte columns, carried into its K
    //    words, then the carries between lanes; the top carry is dropped.
    stage_cols<NL, K>(lo, tab, 0, trans_m, Sh::kTransM, ln);
    const uint32_t* slot_m = trans_m + g * Sh::kTransM;
    uint32_t m[K];
    uint64_t acc = 0;
#pragma unroll
    for (int k = 0; k < K; k++) {
        acc += word_cols(slot_m, 4 * (ln.j * K + k));
        m[k] = (uint32_t)acc;
        acc >>= 32;
    }
    m[0] = add_cc(m[0], ln.from_prev((uint32_t)acc));
#pragma unroll
    for (int k = 1; k < K; k++) m[k] = addc_cc(m[k], 0u);
    carry_lanes<K>(m, addc(0u, 0u), ln);

    // 3. (T + m*N) / R.  The low half T_lo + (m*N)_lo is 0 mod R; with lane
    //    j's words W_j and carry c_j it is R * (c_3 + [any W_j or c_{j<3}
    //    is nonzero]), since the rest is below 2R: its quotient is what
    //    carries into the high half, and no low word is resolved.
    stage_cols<NL, 2 * K>(m, tab, Sh::kTiles * K, trans_n, Sh::kTransN, ln);
    const uint32_t* slot_n = trans_n + g * Sh::kTransN;
    acc = 0;
    bool nonzero = false;
#pragma unroll
    for (int k = 0; k < K; k++) {
        acc += word_cols(slot_n, 4 * (ln.j * K + k)) + lo[k];
        nonzero = nonzero || (uint32_t)acc != 0u;
        acc >>= 32;
    }
    const uint32_t c_lo = (uint32_t)acc;
    const uint32_t rest =
        ln.ballot(nonzero || (ln.j < kLanes - 1 && c_lo != 0u)) != 0u;
    uint32_t hi[K];
    acc = spill;
#pragma unroll
    for (int k = 0; k < K; k++) {
        acc += word_cols(slot_n, 4 * (NL + ln.j * K + k)) + t[k];
        hi[k] = (uint32_t)acc;
        acc >>= 32;
    }
    const uint32_t c_hi = (uint32_t)acc;
    // carries in: lane 0 gets the low half's quotient, lane j > 0 lane
    // j - 1's c_hi; the top lane's c_hi is the carry above the result
    const uint32_t in = __shfl_sync(kWarp, ln.j == kLanes - 1 ? c_lo : c_hi,
                                    ln.j + kLanes - 1, kLanes);
    hi[0] = add_cc(hi[0], ln.j == 0 ? in + rest : in);
#pragma unroll
    for (int k = 1; k < K; k++) hi[k] = addc_cc(hi[k], 0u);
    const uint32_t gen = addc(0u, 0u)
                         | (uint32_t)(ln.j == kLanes - 1 && c_hi != 0u);
    // the value is < 2p
    reduce_once_l<NL>(r, hi, carry_lanes<K>(hi, gen, ln), f, ln);
}

template <int NL>
struct MxuMulL {
    MxuTab tab;
    __device__ __forceinline__ void operator()(uint32_t* r, const uint32_t* a,
                                               const uint32_t* b,
                                               const FieldL<NL>& f,
                                               const Lanes& ln) const {
        mont_mul_mxu_l<NL>(r, a, b, f, ln, tab);
    }
};

// One bucket round: out, acc (3, NL, S); table (n, 3NL); ids, found (S,);
// frags: the tables' MxuShape<NL>::kWords fragment words (device memory),
// copied into shared memory.  Kernel 4's body with the tensor-core
// product.  out may alias acc.
template <int NL>
__global__ void __launch_bounds__(kSlotBlock)
bucket_round_add_mxu_kernel(uint32_t* out, const uint32_t* acc,
                            const uint32_t* table, const int32_t* ids,
                            const int32_t* found, int S,
                            const uint32_t* frags, Field<NL> f) {
    using Sh = MxuShape<NL>;
    constexpr int K = Sh::K;
    constexpr int kWarps = kSlotBlock / 32;
    __shared__ __align__(16) uint32_t tab[Sh::kWords];
    __shared__ __align__(16) uint32_t trans[kWarps * Sh::kTransWarp];
    for (int i = threadIdx.x; i < Sh::kWords; i += blockDim.x)
        tab[i] = frags[i];
    __syncthreads();
    const Lanes ln;
    bool mine;
    const long long s = group_index(S, mine);
    const FieldL<NL> fl(f, ln.j);
    uint32_t X[K], Y[K], Z[K];
    load_point_l<NL>(X, Y, Z, acc, S, s, ln.j);
    const bool live = mine && found[s] != 0;
    const int lane = threadIdx.x & 31;
    const MxuTab mt{tab + lane * 4, trans + threadIdx.x / 32 * Sh::kTransWarp};
    proj_round_l<NL>(X, Y, Z, table, live ? ids[s] : 0, live, fl, ln,
                     MxuMulL<NL>{mt});
    if (mine) store_point_l<NL>(out, S, s, X, Y, Z, ln.j);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 when accepted); a limb
// count other than 8 or 12 gives cudaErrorInvalidValue, and so does an
// a != 0 curve (`general_a`): the kernel is RCB16 algorithm 7's.
int bp_bucket_round_add_mxu(void* out, const void* acc, const void* table,
                            const void* ids, const void* found, int S,
                            int nl, const void* consts, const void* tables,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* c = static_cast<const uint32_t*>(consts);
    const uint32_t* frags = static_cast<const uint32_t*>(tables);
    if (S <= 0 || ((nl == 12 || nl == 8) && general_a(nl, c)))
        return (int)cudaErrorInvalidValue;
    const unsigned grid = groups_grid(S, kSlotBlock);
    if (nl == 12) {
        bucket_round_add_mxu_kernel<12><<<grid, kSlotBlock, 0, st>>>(
            static_cast<uint32_t*>(out), static_cast<const uint32_t*>(acc),
            static_cast<const uint32_t*>(table),
            static_cast<const int32_t*>(ids),
            static_cast<const int32_t*>(found), S, frags, make_field<12>(c));
    } else if (nl == 8) {
        bucket_round_add_mxu_kernel<8><<<grid, kSlotBlock, 0, st>>>(
            static_cast<uint32_t*>(out), static_cast<const uint32_t*>(acc),
            static_cast<const uint32_t*>(table),
            static_cast<const int32_t*>(ids),
            static_cast<const int32_t*>(found), S, frags, make_field<8>(c));
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
