"""The group kernels' own CUDA source (csrc/ec_kernels.cu with
ec_lanes.cuh and ec_common.cuh, and csrc/roofline_kernels.cu) built by the
host's g++ against a small CUDA stand-in and held against the plain
PyTorch versions on the CPU, where there is no card.

The stand-in runs each block's threads at once, each warp's 32 lanes
with the warp shuffles (within groups and across the whole warp), ballots
and votes the lane-cooperative functions use (a barrier of the warp a
call), `__syncthreads` (a barrier of the block) and `__shared__` arrays
(the block's: blocks run one after another), `blockIdx` and `blockDim`,
and the PTX carry chains of carry.cuh as C++ on a per-lane carry flag;
the launches `<<<grid, block, 0, st>>>` become calls that run the grid.
So the kernels' arithmetic and control flow run here as written: RCB16
algorithm 1 (a != 0, ed25519) in kernels 2, 3 (pairwise and every
sequential form) and 4 and in the chain kernel, which a card runs only in
a chip call, and, beside it, the a = 0 forms the card has run (BN254),
which hold the stand-in to the card's results; and the lone chains'
layout (a warp a chain, RCB16's dedicated doubling, the window totals'
4 warps a window) on both.  Every comparison is exact.
"""

import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.ops import build
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import ec_kernels as ek
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops.field import pack32
from bulletproofs_tpu_torch.utils import roofline as R

torch.set_num_threads(1)

_RUNTIME = r"""
#pragma once
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim3 threadIdx, blockIdx, blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
#define __shared__ static
// A warp's barrier and its two sets of exchange slots.
struct WarpState {
    std::barrier<>* bar;
    unsigned long long slots[2][32];
};
inline thread_local WarpState* warp_state;
inline thread_local int warp_parity;
inline std::barrier<>* block_barrier;
inline int lane_id() { return threadIdx.x & 31; }
// Every lane's v once the whole warp wrote it.  Two sets of slots,
// alternating: a lane past this call's barrier writes the other set next,
// which no lane still reads.
inline unsigned long long* exchange(unsigned long long v) {
    unsigned long long* slots = warp_state->slots[warp_parity ^= 1];
    slots[lane_id()] = v;
    warp_state->bar->arrive_and_wait();
    return slots;
}
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src, int w = 32) {
    const int l = lane_id();
    return (uint32_t)exchange(v)[(l & ~(w - 1)) + (src & (w - 1))];
}
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, unsigned d,
                                 int w = 32) {
    const int l = lane_id();
    unsigned long long* s = exchange(v);
    return (l & (w - 1)) + (int)d < w ? (uint32_t)s[l + d] : v;
}
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, unsigned d,
                               int w = 32) {
    const int l = lane_id();
    unsigned long long* s = exchange(v);
    return (l & (w - 1)) >= (int)d ? (uint32_t)s[l - d] : v;
}
inline uint32_t __ballot_sync(unsigned, int p) {
    unsigned long long* s = exchange(p != 0);
    uint32_t b = 0;
    for (int i = 0; i < 32; i++) b |= (uint32_t)s[i] << i;
    return b;
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __clz(int x) { return x ? __builtin_clz(x) : 32; }
// The grid's blocks one after another, each block's threads all at once
// (`__syncthreads` and the shared arrays are the block's).
template <class... P, class... A>
void run_grid(void (*kernel)(P...), unsigned grid, int block, A... args) {
    for (unsigned b = 0; b < grid; b++) {
        std::barrier<> bb(block);
        block_barrier = &bb;
        std::vector<std::unique_ptr<std::barrier<>>> bars;
        std::vector<WarpState> warps(block / 32);
        for (auto& w : warps) {
            bars.push_back(std::make_unique<std::barrier<>>(32));
            w.bar = bars.back().get();
        }
        std::vector<std::thread> threads;
        for (int t = 0; t < block; t++)
            threads.emplace_back([&, t] {
                blockIdx.x = b;
                blockDim.x = block;
                threadIdx.x = t;
                warp_state = &warps[t / 32];
                warp_parity = 0;
                kernel(args...);
            });
        for (auto& t : threads) t.join();
    }
}
"""

# carry.cuh's PTX carry chains on a per-lane carry flag (CC.CF; a borrow
# for the subtractions)
_CARRY = r"""
#pragma once
#include <cstdint>
namespace {
inline thread_local uint32_t cf;
inline uint32_t add_cc(uint32_t a, uint32_t b) {
    uint64_t s = (uint64_t)a + b; cf = s >> 32; return (uint32_t)s; }
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
    uint64_t s = (uint64_t)a + b + cf; cf = s >> 32; return (uint32_t)s; }
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + cf; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) { cf = a < b; return a - b; }
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
    uint64_t t = (uint64_t)b + cf; cf = (uint64_t)a < t;
    return (uint32_t)(a - t); }
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - cf; }
inline uint32_t hi(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a * b) >> 32); }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return add_cc(a * b, c); }
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return addc_cc(a * b, c); }
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return add_cc(hi(a, b), c); }
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return addc_cc(hi(a, b), c); }
}
"""

# Reads ops until the input ends: the op's name and ints, then each
# operand array (a count, then the words); prints the C function's return
# code and the output words.
_MAIN = r"""
#include <cstdio>
#include <string>
static std::vector<uint32_t> arr() {
    long long n = 0;
    if (scanf("%lld", &n) != 1) exit(2);
    std::vector<uint32_t> v(n);
    for (auto& x : v) if (scanf("%u", &x) != 1) exit(2);
    return v;
}
static int ints(int* v, int k) {
    for (int j = 0; j < k; j++) if (scanf("%d", &v[j]) != 1) exit(2);
    return v[k - 1];                      // the limb count, last
}
static void put(int rc, const std::vector<uint32_t>& out) {
    printf("%d", rc);
    for (auto x : out) printf(" %u", x);
    printf("\n");
    fflush(stdout);
}
int main() {
    char op[32];
    int v[5];
    while (scanf("%31s", op) == 1) {
        const std::string o(op);
        if (o == "proj" || o == "mixed") {            // S R_c nl
            const int nl = ints(v, 3);
            auto acc = arr(), tab = arr(), ids = arr(), fd = arr(),
                 c = arr();
            std::vector<uint32_t> out(acc.size());
            put((o == "proj" ? bp_bucket_rounds_proj
                             : bp_bucket_rounds_mixed)(
                    out.data(), acc.data(), tab.data(), ids.data(),
                    fd.data(), v[0], v[1], nl, c.data(), nullptr), out);
        } else if (o == "round") {                    // S nl
            const int nl = ints(v, 2);
            auto acc = arr(), tab = arr(), ids = arr(), fd = arr(),
                 c = arr();
            std::vector<uint32_t> out(acc.size());
            put(bp_bucket_round_add(out.data(), acc.data(), tab.data(),
                                    ids.data(), fd.data(), v[0], nl,
                                    c.data(), nullptr), out);
        } else if (o == "add") {                      // n nl
            const int nl = ints(v, 2);
            auto P = arr(), Q = arr(), c = arr();
            std::vector<uint32_t> out(P.size());
            put(bp_ec_add(out.data(), P.data(), Q.data(), v[0], nl,
                          c.data(), nullptr), out);
        } else if (o == "gather") {      // n_out m ncols from_identity nl
            const int nl = ints(v, 5);
            auto P = arr(), idx = arr(), c = arr();
            std::vector<uint32_t> out(3 * nl * v[0]);
            put(bp_ec_gather_sum(out.data(), P.data(), idx.data(), v[0],
                                 v[1], v[2], v[3], nl, c.data(), nullptr),
                out);
        } else if (o == "totals") {                   // W G Kc dbl nl
            const int nl = ints(v, 5);
            auto r = arr(), cs = arr(), c = arr();
            std::vector<uint32_t> out(3 * nl * v[0]);
            put(bp_ec_window_totals(out.data(), r.data(), cs.data(), v[0],
                                    v[1], v[2], v[3], nl, c.data(),
                                    nullptr), out);
        } else if (o == "horner") {                   // n_sets wps c nl
            const int nl = ints(v, 4);
            auto t = arr(), c = arr();
            std::vector<uint32_t> out(3 * nl * v[0]);
            put(bp_ec_horner(out.data(), t.data(), v[0], v[1], v[2], nl,
                             c.data(), nullptr), out);
        } else if (o == "chain") {                    // n iters form nl
            const int nl = ints(v, 4);
            auto x = arr(), c = arr();
            std::vector<uint32_t> out(x.size());
            put(bp_ec_chain(out.data(), x.data(), v[0], v[1], v[2], nl,
                            c.data(), nullptr), out);
        } else if (o == "chain_mul") {                // n iters nl
            const int nl = ints(v, 3);
            auto x = arr(), c = arr();
            std::vector<uint32_t> out(x.size());
            put(bp_mont_mul_chain(out.data(), x.data(), v[0], v[1], nl,
                                  c.data(), nullptr), out);
        } else {
            return 3;
        }
    }
}
"""

CSRC = build.CSRC


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    """csrc/ec_kernels.cu and csrc/roofline_kernels.cu, their launches
    turned into `run_grid` calls, ec_kernels.cu's launchers taking the
    a != 0 forms too, built by g++ against the stand-in ->
    run(op, ints, *arrays) -> (return code, output words uint32)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the emulated warp")
    d = tmp_path_factory.mktemp("lanes")
    (d / "cuda_runtime.h").write_text(_RUNTIME)
    (d / "carry.cuh").write_text(_CARRY)
    for header in ("ec_common.cuh", "ec_lanes.cuh"):
        (d / header).write_text((CSRC / header).read_text())
    src = '#include "ec_lanes.cuh"\n'
    for name, launches in (("ec_kernels.cu", 7), ("roofline_kernels.cu",
                                                  5)):
        text = (CSRC / name).read_text()
        text = re.sub(r'#include "ec_(common|lanes)\.cuh"', "", text)
        text, n = re.subn(
            r"(\w+<[^<>]*>)\s*<<<([^,]+),\s*([^,]+),\s*0,\s*st>>>\(",
            r"run_grid(\1, \2, \3, ", text)
        assert n == launches + (name == "ec_kernels.cu"), (name, n)
        # ec_kernels.cu's a = 0 and a != 0 libraries (ec_kernels_a.cu) in
        # one: its launchers take both forms here, by their a = 0 names
        text, n = re.subn("launch_field<kBuilt>",
                          "launch_field<Fields::kAll>", text)
        assert n == (6 if name == "ec_kernels.cu" else 0), (name, n)
        src += text
    (d / "kernels.cpp").write_text(src + _MAIN)
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-w", "-I",
                    str(d), "-o", str(d / "emu"), str(d / "kernels.cpp")],
                   check=True)

    def run(op, ints, *arrays):
        words = [op, *map(str, ints)]
        for a in arrays:
            a = np.asarray(a).astype(np.int64).reshape(-1) & 0xFFFFFFFF
            words += [str(a.size), *map(str, a.tolist())]
        out = subprocess.run([str(d / "emu")], input=" ".join(words),
                             capture_output=True, text=True,
                             check=True).stdout.split()
        return int(out[0]), np.array(out[1:], dtype=np.uint64).astype(
            np.uint32)
    return run


def _inputs(cv, seed):
    """ctx, the kernels' consts and a sampler of packed projective points
    (8 random points doubled, 1 in 5 the identity)."""
    ctx = E.CurveCtx(cv)
    rnd = random.Random(seed)
    gen = torch.Generator().manual_seed(seed)
    proj = E.to_device_points([p + p for p in (bt.G1.random(rnd, cv)
                                               for _ in range(8))], ctx,
                              "cpu")

    def points(count):
        P = proj[:, :, torch.randint(0, 8, (count,), generator=gen)]
        P[:, :, ::5] = ctx.identity_like((1,), "cpu")
        return pack32(P, 1).contiguous()
    return ctx, ek._consts(ctx), points, gen


def _slot_grid(gen, R, S, rows):
    """(ids, found) (R, S) int32: ~70% occupied, the 8 slots of one warp
    empty in every round, slot 0 adding one row twice (a doubling)."""
    ids = torch.randint(0, rows, (R, S), generator=gen).to(torch.int32)
    found = (torch.rand((R, S), generator=gen) < 0.7).to(torch.int32)
    found[:, 8:16] = 0
    ids[1, 0] = ids[0, 0]
    found[:2, 0] = 1
    return ids, found


FORMS = ["proj", "round", "add", "gather", "gather_first", "totals",
         "horner", "chain_add", "chain_mul"]
CASES = [("ed25519", f) for f in FORMS + ["mixed"]] + \
    [("bn254", f) for f in ("proj", "add", "totals", "mixed")]


@pytest.mark.parametrize("curve,form", CASES)
def test_kernel_source_matches_plain_on_an_emulated_warp(emulator, curve,
                                                         form):
    """Each kernel (and form) on 40 slots or points, the last warp partly
    past them, bit-exact against its plain version: kernel 2 over 3
    rounds, kernel 4, kernel 3 pairwise (with a doubling), the gather-sum
    form from the identity and from the first column, the window totals,
    the Horner, the chain kernel's two forms; on ed25519 kernel 1 refuses
    the a != 0 field (cudaErrorInvalidValue, 1)."""
    cv = config.CURVES[curve]
    ctx, consts, points, gen = _inputs(cv, 7)
    nl = ctx.fp.L // 2
    S, R_c, rows = 40, 3, 12
    if form in ("proj", "round", "mixed"):
        acc = points(S)
        ids, found = _slot_grid(gen, R_c, S, rows)
        if form == "mixed" and not ctx.a_is_zero:
            rc, _ = emulator("mixed", [S, R_c, nl], acc,
                             torch.zeros(rows, 2 * nl), ids, found, consts)
            assert rc == 1
            return
        if form == "mixed":
            rnd = random.Random(8)
            aff, _ = E.to_device_points_affine(
                [bt.G1.random(rnd, cv) for _ in range(4)], ctx, "cpu")
            table = ek.affine_rows32(aff)[torch.arange(rows) % 4]
            want = ek.bucket_rounds_mixed(acc, table, ids, found, ctx)
            got = emulator("mixed", [S, R_c, nl], acc, table, ids, found,
                           consts)
        elif form == "proj":
            table = ek.proj_rows32(points(rows))
            want = ek.bucket_rounds_proj(acc, table, ids, found, ctx)
            got = emulator("proj", [S, R_c, nl], acc, table, ids, found,
                           consts)
        else:
            table = ek.proj_rows32(points(rows))
            acc[:, :, 2] = table[ids[0, 2]].reshape(3, -1)    # P + P
            found[0, 2] = 1
            want = ek.bucket_round_add(acc, table, ids[0], found[0], ctx)
            got = emulator("round", [S, nl], acc, table, ids[0], found[0],
                           consts)
    elif form == "add":
        P, Q = points(37), points(37)
        Q[:, :, 3] = P[:, :, 3]
        want = ek.ec_add(P, Q, ctx)
        got = emulator("add", [37, nl], P, Q, consts)
    elif form in ("gather", "gather_first"):
        W, G, K = 2, 4, 4
        P = points(W * G * K)
        idx = torch.as_tensor(M._rowcol_index(W, G, K))
        idx[3, 1:] = -1                       # a row of one column
        idx[5, :] = -1                        # a row of none
        first = form == "gather"
        want = ek.ec_gather_sum(P, idx, first, ctx)
        got = emulator("gather", [idx.shape[0], idx.shape[1], P.shape[2],
                                  int(first), nl], P, idx, consts)
    elif form == "totals":
        W, G, K = 2, 4, 4
        rowsum = points(W * G).reshape(3, nl, W, G).contiguous()
        colsum = points(W * K).reshape(3, nl, W, K).contiguous()
        want = ek.ec_window_totals(rowsum, colsum, 2, ctx)
        got = emulator("totals", [W, G, K, 2, nl], rowsum, colsum, consts)
    elif form == "horner":
        totals = points(6)
        want = ek.ec_horner(totals, 3, 2, ctx)
        got = emulator("horner", [2, 3, 2, nl], totals, consts)
    else:
        op = form.split("_")[1]
        x = (R.chain_points if op == "add" else R.chain_elements)(
            ctx, S, seed=9, device="cpu")
        want = getattr(R, f"{'ec_add' if op == 'add' else 'mont_mul'}"
                          "_chain")(x, 3, ctx)
        got = (emulator("chain", [S, 3, 0, nl], x, consts) if op == "add"
               else emulator(form, [S, 3, nl], x, consts))
    rc, words = got
    assert rc == 0
    np.testing.assert_array_equal(words.view(np.int32),
                                  want.reshape(-1).numpy())


LONE = ["totals_c8", "totals_c5", "horner_c8", "horner_top_identity",
        "chain_dbl", "chain_add_warp", "chain_dbl_warp"]


@pytest.mark.parametrize("curve", ["bn254", "ed25519"])
@pytest.mark.parametrize("form", LONE)
def test_lone_chains_match_plain_on_an_emulated_warp(emulator, curve, form):
    """The lone chains' layout, a warp a chain (`WarpLevels`: one product
    a group of 4 lanes, results passed by full-width shuffles) with RCB16's
    dedicated doubling (`ec_dbl_l`, algorithm 9; algorithm 3 for ed25519),
    bit-exact against the plain versions, which double by the complete
    add: the window totals at the c = 8 combine's G = K = 16 and 4
    doublings (4 warps a window, shared memory and a block barrier a step)
    over 2 windows, and at c = 5's G = 8, K = 4 (the columns' chains end
    first) over 1; the Horner at c = 8 over 2 sets of 3 windows, and with
    the first set's top window total the identity (its opening doublings
    skipped); the chain kernel's doubling on a group of 4 lanes and its
    add and doubling on a warp, over 5 points (the second block of warps
    partly past them), 3 steps."""
    cv = config.CURVES[curve]
    ctx, consts, points, _ = _inputs(cv, 11)
    nl = ctx.fp.L // 2
    if form.startswith("totals"):
        W, G, K, dbl = (2, 16, 16, 4) if form == "totals_c8" else \
            (1, 8, 4, 2)
        rowsum = points(W * G).reshape(3, nl, W, G).contiguous()
        colsum = points(W * K).reshape(3, nl, W, K).contiguous()
        want = ek.ec_window_totals_plain(rowsum, colsum, dbl, ctx)
        got = emulator("totals", [W, G, K, dbl, nl], rowsum, colsum,
                       consts)
    elif form.startswith("horner"):
        totals = points(6)
        totals[:, :, 0] = totals[:, :, 1]     # a doubling in the chain
        if form == "horner_top_identity":
            totals[:, :, 2] = ek.packed_identity(ctx, (1,), "cpu")[:, :, 0]
        want = ek.ec_horner_plain(totals, 3, 8, ctx)
        got = emulator("horner", [2, 3, 8, nl], totals, consts)
    else:
        chain = form.split("_", 1)[1]
        x = R.chain_points(ctx, 5, seed=9, device="cpu")
        want = R.ec_chain_plain(x, 3, chain, ctx)
        got = emulator("chain", [5, 3, R.CHAIN_FORMS.index(chain), nl], x,
                       consts)
    rc, words = got
    assert rc == 0
    np.testing.assert_array_equal(words.view(np.int32),
                                  want.reshape(-1).numpy())
