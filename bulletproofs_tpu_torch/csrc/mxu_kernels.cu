// Kernel 5, hand-written for Hopper (sm_90a): one bucket round whose
// Montgomery products run their REDC's fixed-operand halves as int8 dot
// products against Toeplitz tables.  Plain C interface, built by nvcc into
// its own shared library beside ec_kernels.cu's and called through ctypes
// (bulletproofs_tpu_torch/ops/build.py, ec_kernels.py).
//
// It replaces the Pallas TPU kernel of bulletproofs_tpu/ops/ec_pallas.py:
//   bp_bucket_round_add_mxu <- bucket_round_add_pallas_mxu (:217; body
//   _round_kernel_mxu :189, product _mxu_mont_mul_factory :119)
//
// What it computes.  What kernel 4 (bp_bucket_round_add) computes: acc
// (3, NL, S) in/out, rows (S, 3NL) projective, found (S,); every slot adds
// its row, or the identity (0 : 1 : 0) where found is 0, by the complete
// RCB16 add.  Each Montgomery product is separated REDC: T = a*b in 32-bit
// limbs (the schoolbook half: both operands vary), then m = (T_lo * N') mod R
// and m * N as byte-sliced Toeplitz products, int8 x int8 -> int32, through
// __dp4a over 4-byte groups: L8 = 4*NL bytes a field element, an (L8 x L8)
// table for N' and a (2*L8 x L8) table for N.  Both sides are biased by
// -128 to fit int8 exactly, and a row constant (128*rowsum + 16384*L8) plus
// 128 * the byte sum of the input undo the bias (ops/field.py: mxu_tables,
// the JAX package's field_jax._mxu_tables).  The result is canonical, so
// it equals kernel 4's limb for limb.
//
// What bounds it.  Integer work: a product is 3*L8^2/4 dp4a (1728 for
// BLS12-381, 768 for BN254) against CIOS's 2*NL^2 + NL multiply-adds, so
// the same round costs several times kernel 4's instructions; the bound
// chip_smoke.py states is kernel 4's (the same group operation).  The
// design is the simple one: one thread per slot, the tables copied into
// each block's shared memory (every thread of a warp reads the same table
// word, a broadcast), and the product a function of its own (__noinline__,
// one copy of its ~2.5k instructions per limb count, operands through
// local memory) so the build stays short.  A warp-wide
// mma.sync.m16n8k32.s32.s8.s8.s32 over 32 slots, the tensor cores' form of
// the same tables, is left to a redesign.

#include "ec_common.cuh"

namespace {

// Words of the packed tables (ops/ec_kernels.py: _mxu_words):
//   tm: 4NL rows of NL words (N' table, 4 int8 entries a word, entry 4w+j in
//       byte j of word w), tn: 8NL rows of NL words (N table),
//   cm: 4NL int32 row constants, cn: 8NL int32, p: the NL modulus words.
template <int NL>
struct MxuLayout {
    static constexpr int kWords = 12 * NL * NL + 12 * NL + NL;
};

// r = a*b*R^-1 mod p with the REDC products as int8 dot products; canonical
// in and out.  tab: the packed tables (shared memory).
template <int NL>
__device__ __noinline__ void mont_mul_mxu(uint32_t* r, const uint32_t* a,
                                          const uint32_t* b,
                                          const uint32_t* tab) {
    constexpr int L8 = 4 * NL;
    const uint32_t* tm = tab;
    const uint32_t* tn = tab + L8 * NL;
    const int32_t* cm = reinterpret_cast<const int32_t*>(tn + 2 * L8 * NL);
    const int32_t* cn = cm + L8;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(cn + 2 * L8);

    // T = a*b, 2NL words
    uint32_t t[2 * NL];
#pragma unroll
    for (int i = 0; i < 2 * NL; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < NL; j++) {
            c += (uint64_t)a[i] * b[j] + t[i + j];
            t[i + j] = (uint32_t)c;
            c >>= 32;
        }
        t[i + NL] = (uint32_t)c;
    }

    // x = T_lo as int8 bytes biased by -128 (u - 128 == u ^ 0x80 as int8)
    uint32_t xs[NL];
    int sx = 0;
#pragma unroll
    for (int w = 0; w < NL; w++) {
        xs[w] = t[w] ^ 0x80808080u;
        sx = __dp4a((int)xs[w], 0x01010101, sx);
    }

    // m = (T_lo * N') mod R: byte columns, carried into bytes, top dropped
    uint32_t ms[NL];
    int sm = 0;
    uint32_t carry = 0;
#pragma unroll
    for (int w = 0; w < NL; w++) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; j++) {
            const int k = 4 * w + j;
            int col = cm[k] + 128 * sx;
#pragma unroll
            for (int v = 0; v < NL; v++)
                col = __dp4a((int)tm[k * NL + v], (int)xs[v], col);
            const uint32_t val = (uint32_t)col + carry;   // col >= 0
            word |= (val & 0xFFu) << (8 * j);
            carry = val >> 8;
        }
        ms[w] = word ^ 0x80808080u;
        sm = __dp4a((int)ms[w], 0x01010101, sm);
    }

    // (T + m*N) / R: m*N's byte columns folded into 32-bit words with T's;
    // the low NL words cancel, the high ones and a top bit remain (< 2p)
    uint32_t hi[NL];
    uint64_t acc = 0;
#pragma unroll
    for (int w = 0; w < 2 * NL; w++) {
#pragma unroll
        for (int j = 0; j < 4; j++) {
            const int k = 4 * w + j;
            int col = cn[k] + 128 * sm;
#pragma unroll
            for (int v = 0; v < NL; v++)
                col = __dp4a((int)tn[k * NL + v], (int)ms[v], col);
            acc += (uint64_t)(uint32_t)col << (8 * j);
        }
        acc += t[w];
        if (w >= NL) hi[w - NL] = (uint32_t)acc;
        acc >>= 32;
    }

    uint32_t d[NL];
    uint64_t br = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        uint64_t x = (uint64_t)hi[i] - p[i] - br;
        d[i] = (uint32_t)x;
        br = x >> 63;
    }
    const bool ge = acc != 0 || br == 0;
#pragma unroll
    for (int i = 0; i < NL; i++) r[i] = ge ? d[i] : hi[i];
}

template <int NL>
struct MxuMul {
    const uint32_t* tab;
    __device__ __forceinline__ void operator()(uint32_t* r, const uint32_t* a,
                                               const uint32_t* b,
                                               const Field<NL>&) const {
        mont_mul_mxu<NL>(r, a, b, tab);
    }
};

// One bucket round, as bucket_round_add_kernel (ec_kernels.cu) with the
// int8-REDC product: acc (3, NL, S) in/out, rows (S, 3NL), found (S,),
// tables (MxuLayout<NL>::kWords words, device memory).
template <int NL>
__global__ void __launch_bounds__(kThreads)
bucket_round_add_mxu_kernel(uint32_t* acc, const uint32_t* rows,
                            const int32_t* found, int S,
                            const uint32_t* tables, Field<NL> f) {
    __shared__ uint32_t tab[MxuLayout<NL>::kWords];
    for (int i = threadIdx.x; i < MxuLayout<NL>::kWords; i += blockDim.x)
        tab[i] = tables[i];
    __syncthreads();
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
    ec_add_inplace<NL, MxuMul<NL>>(X, Y, Z, x2, y2, z2, f,
                                   MxuMul<NL>{tab});
    store_point<NL>(acc, S, s, X, Y, Z);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 when accepted); a limb
// count other than 8 or 12 gives cudaErrorInvalidValue.
int bp_bucket_round_add_mxu(void* acc, const void* rows, const void* found,
                            int S, int nl, const void* consts,
                            const void* tables, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* c = static_cast<const uint32_t*>(consts);
    const uint32_t* tab = static_cast<const uint32_t*>(tables);
    if (S <= 0) return (int)cudaErrorInvalidValue;
    if (nl == 12) {
        bucket_round_add_mxu_kernel<12><<<grid_for(S), kThreads, 0, st>>>(
            static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(rows),
            static_cast<const int32_t*>(found), S, tab, make_field<12>(c));
    } else if (nl == 8) {
        bucket_round_add_mxu_kernel<8><<<grid_for(S), kThreads, 0, st>>>(
            static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(rows),
            static_cast<const int32_t*>(found), S, tab, make_field<8>(c));
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
