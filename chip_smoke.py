"""Drive the PyTorch/CUDA port on one NVIDIA card: build its kernels, hold
each kernel against its plain PyTorch version, and run the n = 2^16 device
Pippenger MSM, the n = 2^16 inner-product argument (prove and verify), the
aggregated range proof (R1CS prove and verify, m = 16 values of 64 bits,
n = 2048) and the Poseidon / sparse-Merkle-tree workloads (bulk hashing,
batch updates, the depth-12 SMT-4 leaf-inclusion proof) of BLS12-381 end
to end.

    python3 chip_smoke.py [--seed S] [--n N]

Phases, each printing one JSON line with its seconds:
  0 device   the card's name and power limit (nvidia-smi);
  1 build    nvcc of csrc/ec_kernels.cu and csrc/mxu_kernels.cu, in
             parallel, into ctypes libraries; ptxas's registers, stack
             and spills; kernel 5's SASS holds IMMA and no IDP.4A;
  2 kernels  each kernel against its plain version at the width each path
             gives it (bit-exact; kernel 5 also against kernel 4): the
             bucket kernels from a packed point table of the path's size
             by a random slot grid, kernel 1 at the MSM's and the IPA's
             slots, kernel 2 at the MSM's from a pre-reduced table of W*n
             rows, kernel 4 at the IPA's, kernel 3 pairwise and its
             sequential forms (the
             folds, row and column sums, window totals and Horner of the
             combine) at the range proof's and the MSM's combine shapes;
             with the bare kernel's time on operands prepared beforehand
             (`ms`), the wrapper's time with its checks and any 16/32-bit
             limb packing (`wrapper_ms`), the plain version's time and the
             card's bound for the same work;
             after the paths, the bucket kernel and the combine's forms
             again at the shapes of each MSM that phase 7 ran (`kernels_at`:
             kernel 2 at the witness's and the IPA's pre-reduced tables,
             kernel 1 at the verifier's);
  3 msm_uniform    n random-scalar MSM (the bench's input: 256 base points
                   repeated) through `msm_hybrid`, 1 + 3 runs, and through
                   `msm_device` (the path of the public `msm`), 1 + 3 runs,
                   each checked against an independent host sum;
  4 msm_bitvector  n scalars in {0, 1}, the same two paths: escalates to
                   pre-reduction, so the projective bucket kernel and the
                   batched add run too;
  5 ipa      the standalone IPA at n (the bench's config 3: 256 hash-derived
             G and H bases repeated to n, unit factors): prove 1 + 3 times
             with the chunked bucket kernels, the per-stage seconds of one
             more proof, a host check of the proof in Python ints that does
             not use the device verifier, `verify_ipp` 1 + 3 times, a
             tampered proof rejected, and one proof with the per-round
             bucket kernel, byte-identical to the chunked one;
  6 r1cs     the bench's config 2: m = 16 aggregated 64-bit range proofs,
             n = 2048, `get_generators("G"/"H", 2048)`: prove 1 + 3 times
             (seeds 1-4), the stages of one more proof, the seed-2 proof's
             sha256 against the JAX package's
             (tests/vectors/torch_r1cs_agg16.json), a host check through
             `Verifier._verify` over `msm_host`, `verify_device` 1 + 3
             times, and t_x + 1 rejected;
  7 smt      the bench's Poseidon / SMT sections at their sizes
             (tests/vectors/torch_smt4_d12.json): `poseidon_hash_4_batch`
             over 8192 child lists (hashes/s, 64 checked on the host); two
             4096-pair `batch_update`s of a depth-12 SMT-4 (updates/s of
             the second; the root against the JAX package's; 16 updated
             leaves through `verify_proof`); the depth-12 leaf-inclusion
             proof, n = 4096, 1 + 3 rounds of prove and verify (the first
             proof's sha256 against the JAX package's), the stages of one
             more proof, the host check, t_x + 1 rejected; one hash batch
             and one proof traced (device busy, idle share, kernels);
  8 mxu_race one per-round bucket pass of the IPA MSM (its rounds over
             S slots) through kernel 5 and through kernel 4, in turns, with
             microseconds per round and the buckets bit-exact at the end
             (both read their rows by id from the packed table);
  9 launches the launch counts of each path (phases 3-4, 5, 6, 7, 8),
             kernel 3's also by form, each kernel of a path (and each form
             of kernel 3 the path runs, `PATHS`) required > 0 there, and
             the counts of one range proof and verification, one IPA
             proof and verification, and one SMT-4 proof and
             verification.
The last line is {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero before it.  Without a CUDA card the script exits 2.
"""

import argparse
import hashlib
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch.config import BLS381, using_curve
from bulletproofs_tpu_torch.ipp import verification_scalars
from bulletproofs_tpu_torch.ops import build, ec_kernels as ek
from bulletproofs_tpu_torch.ops import msm as msm_mod
from bulletproofs_tpu_torch.ops import prover_device
from bulletproofs_tpu_torch.ops.ec import (CurveCtx, content_digest,
                                           from_device_points,
                                           to_device_points,
                                           to_device_points_affine,
                                           to_device_scalars)
from bulletproofs_tpu_torch.models import bound_check
from bulletproofs_tpu_torch.models import sparse_merkle_tree_4_ary as smt4
from bulletproofs_tpu_torch.models.helper_constraints.poseidon import (
    PoseidonParams, Poseidon_hash_4)
from bulletproofs_tpu_torch.models.helper_constraints.\
    sparse_merkle_tree_4_ary import VanillaSparseMerkleTree_4
from bulletproofs_tpu_torch.ops import poseidon_device
from bulletproofs_tpu_torch.ops.field import pack32
from bulletproofs_tpu_torch.ops.ec_host import G1, msm_host
from bulletproofs_tpu_torch.ops.field_host import Scalar, inner_product
from bulletproofs_tpu_torch.utils.errors import VerificationError
from bulletproofs_tpu_torch.utils.hash_db import InMemoryHashDb

# Bound model (NVIDIA H100 SXM data sheet, at its 700 W limit).  HBM3 at
# 3.35 TB/s.  Integer multiply-adds: the float32 rate of 67 TFLOP/s counts
# an FMA as 2 operations on 128 lanes per SM; a 32-bit IMAD issues on 64
# lanes per SM, so 67e12 / 2 / 2 IMAD per second.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
# Dense int8 tensor-core rate of the same data sheet: 1979e12 operations a
# second, a multiply-add counted as 2.
INT8_MAC_PER_S = 1979e12 / 2

KERNEL_SOURCE = "bulletproofs_tpu_torch/csrc/ec_kernels.cu"
REPLACES = {
    "bucket_rounds_mixed": "bulletproofs_tpu/ops/ec_pallas.py:425",
    "bucket_rounds_proj": "bulletproofs_tpu/ops/ec_pallas.py:355",
    "ec_add": "bulletproofs_tpu/ops/ec_pallas.py:499",
    "bucket_round_add": "bulletproofs_tpu/ops/ec_pallas.py:469",
    "bucket_round_add_mxu": "bulletproofs_tpu/ops/ec_pallas.py:217",
}
SOURCES = {name: KERNEL_SOURCE for name in REPLACES}
SOURCES["bucket_round_add_mxu"] = "bulletproofs_tpu_torch/csrc/mxu_kernels.cu"
# The kernels each path launches, kernel 3 by form (`launch_counts`): the
# MSM phases 3-4, the IPA phase 5, the range proof phase 6, the sparse
# Merkle tree phase 7 and the race of kernels 5 and 4 (phase 8).  Each
# must launch on its path.
PATHS = {
    "msm": ("bucket_rounds_mixed", "bucket_rounds_proj", "ec_add:pairwise",
            "ec_add:gather_sum", "ec_add:window_totals", "ec_add:horner"),
    "ipa": ("bucket_rounds_mixed", "bucket_round_add", "ec_add:gather_sum",
            "ec_add:window_totals"),
    "r1cs": ("bucket_rounds_mixed", "ec_add:pairwise", "ec_add:gather_sum",
             "ec_add:window_totals"),
    "smt": ("bucket_rounds_mixed", "bucket_rounds_proj", "ec_add:pairwise",
            "ec_add:gather_sum", "ec_add:window_totals"),
    "mxu_race": ("bucket_round_add_mxu", "bucket_round_add"),
}
# kernel 3's forms in phase 2 -> the kernel form each launches
FORM_KERNEL = {"split_fold": "gather_sum", "dup_fold": "gather_sum",
               "rowcol": "gather_sum", "window_totals": "window_totals",
               "horner": "horner"}
N_BASE = 256
# The JAX package's config-2 proof digest (seed 2), made by
# tests/test_torch_r1cs.py::test_agg16_reference_digest
R1CS_REFERENCE = Path(__file__).resolve().parent / "tests" / "vectors" \
    / "torch_r1cs_agg16.json"
# The JAX package's depth-12 SMT-4 root and proof digest, made and checked
# by tests/test_torch_smt.py
SMT_REFERENCE = R1CS_REFERENCE.with_name("torch_smt4_d12.json")


def n_base(n):
    """Distinct base points: the bench's 256 at n = 2^16, fewer for the
    small CPU rehearsal (host point generation is exact-int Python)."""
    return max(16, min(N_BASE, n // 256))


def emit(obj):
    print(json.dumps(obj), flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps):
    """Mean milliseconds of fn() over reps calls: CUDA events on the card,
    the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _sync(device)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        _sync(device)
        return start.elapsed_time(end) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def imad_per_mont_mul(ctx):
    """32-bit IMAD instructions of one CIOS Montgomery product on NL = L/2
    words: 2*NL^2 + NL multiply-adds, each a low and a high IMAD."""
    nl = ctx.fp.L // 2
    return 2 * (2 * nl * nl + nl)


def bound(n_bytes, n_imad):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_imad / IMAD_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else
                                 "operations")


def mxu_bound(ctx, found, n_bytes):
    """Kernel 5's own minimum for one round over `found` (S,): the larger
    of its bytes over the memory rate, its schoolbook IMADs (T = a*b: NL^2
    multiply-adds a product, a low and a high IMAD each; 12 products a live
    slot, 3 an empty one) over the IMAD rate, and the int8 multiply-adds of
    its REDC's Toeplitz products (L8 x L8 for m, 2 L8 x L8 for m*N,
    L8 = 4 NL bytes, no padding) over the dense int8 rate.  Beside it, not
    in the bound: the mma the kernel issues (a warp of 8 slots runs 12
    products unless all 8 are empty, then 3; the k-tiles padded to 32)."""
    nl = ctx.fp.L // 2
    K, L8 = nl // 4, 4 * nl
    mma_per_product = (K + 1) // 2 * 3 * K     # k-tiles x (K + 2K) m-tiles
    live = int(found.sum())
    slots = found.numel()
    products = live * 12 + (slots - live) * 3
    n_imad = products * 2 * nl * nl
    n_mac = products * 3 * L8 * L8
    warps = torch.nn.functional.pad(found, (0, -slots % 8)).reshape(-1, 8)
    busy = int(warps.any(1).sum())
    n_mma = (busy * 12 + (warps.shape[0] - busy) * 3) * mma_per_product
    times = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "imad": n_imad / IMAD_PER_S * 1e3,
             "int8_tensor": n_mac / INT8_MAC_PER_S * 1e3}
    by = max(times, key=times.get)
    return {"mxu_bound_ms": times[by], "mxu_bound_by": by,
            "mxu_bound_parts_ms": times, "mxu_int8_macs": n_mac,
            "mxu_mma_issued": n_mma,
            "mxu_rate_source": "NVIDIA H100 SXM data sheet: 3.35 TB/s, "
                               "67 TFLOP/s fp32, 1979 TOPS int8 dense"}


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "seconds": time.time() - t0})
    return name, smi


def mxu_sass():
    """Kernel 5's instructions by `cuobjdump -sass` of its library: per
    instantiation the count of tensor-core IMMA and of IDP (IDP.4A, the
    dot products of its earlier form).  It must run on IMMA alone."""
    lib = build.library_path(build.CSRC / "mxu_kernels.cu")
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for func in sass.split("Function : ")[1:]:
        name = func.split(None, 1)[0]
        if "bucket_round_add_mxu_kernel" in name:
            counts[name] = {op: func.count(op + ".")
                            for op in ("IMMA", "IDP")}
    if not counts or any(c["IMMA"] == 0 or c["IDP"] for c in
                         counts.values()):
        raise AssertionError(f"kernel 5's SASS: {counts}")
    return counts


def phase_build():
    t0 = time.time()
    reports = build.build()
    build.load()
    ptxas = {path.name: build.ptxas_summary(report)
             for path, report in reports.items()}
    emit({"phase": "build", "ptxas": ptxas, "mxu_sass": mxu_sass(),
          "seconds": time.time() - t0})


def _random_points(rnd, m, cv):
    return [G1.random(rnd, cv) for _ in range(m)]


def ipa_slots(n):
    """Bucket slots of the IPA's two-set MSM over 2n + 2 points."""
    ctx = CurveCtx(BLS381)
    c = msm_mod.pick_window(2 * n + 2)
    return msm_mod.window_plan(ctx, c, n_sets=2, dup=True)[0].shape[0] << c


def combine_shapes(n, n_sets, c=None, horner=False):
    """The combine's shapes for an MSM of n points and n_sets scalar sets:
    c (by default pick_window(n)) and `window_plan(dup=True)`'s physical
    rows W' and base windows W, with G, K of `bucket_rowcol`; horner:
    whether the path runs the window Horner on the card (`msm_device`;
    `msm_hybrid` runs it on the host)."""
    ctx = CurveCtx(BLS381)
    c = c or msm_mod.pick_window(n)
    ranges, splits, dup = msm_mod.window_plan(ctx, c, n_sets=n_sets,
                                              dup=True)
    g_bits = (c + 1) // 2
    return {"n": n, "sets": n_sets, "c": c, "W_rows": ranges.shape[0],
            "W": ranges.shape[0] - sum(g - 1 for _, g in dup),
            "G": 1 << g_bits, "K": 1 << (c - g_bits), "ranges": ranges,
            "splits": splits, "dup": dup, "horner": horner}


def phase_kernels(device, n, seed, reps=5, r1cs_msm_n=4098):
    """Each kernel against its plain version at the width of its path: the
    chunked kernels at the MSM's S = W*B slots of `window_plan(dup=True)`
    at c = pick_window(n) and R_c = EC_CHUNK rounds, kernel 1 also at the
    IPA MSM's slots, kernels 4 and 5 at the IPA's on the same operands;
    each bucket kernel gathers its rows from a packed table of its path's
    size (kernel 1: n rows, 2n + 2 for the IPA; kernel 2: the pre-reduced
    table's W*n; kernels 4 and 5: 2n + 2) by a random slot grid
    (`slot_grid`); kernel 5's record also has its own minimum
    (`mxu_bound`); kernel 3 pairwise at n + 3 points
    and its sequential forms at the combine's shapes of the range proof's
    two-set MSM (r1cs_msm_n points) and of the n-point MSM.  Half the
    accumulators start at the identity.  Returns (per-kernel records,
    `check_msms`, which checks the kernels at the shapes of a path's MSMs
    once the path has run)."""
    t0 = time.time()
    device = torch.device(device)
    cv = BLS381
    ctx = CurveCtx(cv)
    L = ctx.fp.L
    c = msm_mod.pick_window(n)
    ranges, _, _ = msm_mod.window_plan(ctx, c, dup=True)
    W = ranges.shape[0]
    S = W << c
    R_c = msm_mod.EC_CHUNK
    rnd = random.Random(seed)
    gen = torch.Generator().manual_seed(seed)

    m = n_base(n)
    table_pts = _random_points(rnd, m, cv)
    table, affine = to_device_points_affine(table_pts, ctx, device)
    assert affine
    # projective rows: sums of two table points, Z != 1
    proj_pts = [a + b for a, b in zip(table_pts, table_pts[1:] +
                                      table_pts[:1])]
    proj = to_device_points(proj_pts, ctx, device)
    acc_pts = to_device_points(_random_points(rnd, m, cv), ctx, device)

    def accumulators(S_k):
        """S_k packed accumulators, the first half identities."""
        idx = torch.randint(0, m, (S_k - S_k // 2,), generator=gen)
        return pack32(torch.cat([ctx.identity_like((S_k // 2,), device),
                                 acc_pts[:, :, idx.to(device)]], dim=2), 1)

    def tables(n_rows):
        """Kernel 1's affine and kernels 2 and 4's projective packed
        tables of n_rows rows, row i the point i mod m."""
        rows_of = torch.arange(n_rows, device=device) % m
        return (ek.affine_rows32(table)[rows_of],
                ek.proj_rows32(proj)[rows_of])

    def slot_grid(R, S_k, n_rows):
        """(ids, found) (R, S_k) int32 over a table of n_rows rows: ~30%
        of the slots empty, the 8 slots of one warp empty in every round,
        slot S_k - 1 reading the table's last row, and slot 0 (an
        identity accumulator) adding one point in rounds 0 and 1, so it
        doubles in round 1."""
        pid = torch.randint(0, n_rows, (R, S_k), generator=gen)
        found = (torch.rand((R, S_k), generator=gen) < 0.7).to(
            torch.int32)
        found[:, 8:16] = 0
        pid[:, -1] = n_rows - 1
        found[:, -1] = 1
        if R > 1:
            pid[1, 0] = pid[0, 0]
        found[:2, 0] = 1
        return pid.to(torch.int32).to(device), found.to(device)

    buckets = accumulators(S)
    table32, _ = tables(n)
    ids, found = slot_grid(R_c, S, n)
    _, table_pre = tables(W * n)          # kernel 2 after pre-reduction
    ids_pre, found_pre = slot_grid(R_c, S, W * n)

    S_ipa = ipa_slots(n)                  # the IPA's two-set MSM
    buckets_ipa = accumulators(S_ipa)
    table32_ipa, table_ipa = tables(2 * n + 2)
    ids_ipa, found_ipa_c = slot_grid(R_c, S_ipa, 2 * n + 2)
    ids4, found4 = (x[0] for x in slot_grid(1, S_ipa, 2 * n + 2))
    buckets_round = buckets_ipa.clone()
    buckets_round[:, :, 0] = table_ipa[ids4[0]].reshape(3, -1)  # P + P

    n_add = n + 3                         # ragged: not a multiple of a tile
    ia = torch.randint(0, m, (n_add,), generator=gen).to(device)
    ib = torch.randint(0, m, (n_add,), generator=gen).to(device)
    P = proj[:, :, ia]
    Q = proj[:, :, ib]
    P[:, :, 0] = ctx.identity_like((1,), device)[:, :, 0]   # O + Q
    Q[:, :, 1] = ctx.identity_like((1,), device)[:, :, 0]   # P + O
    Q[:, :, 2:n_add:97] = P[:, :, 2:n_add:97]               # P + P

    imad = imad_per_mont_mul(ctx)
    nl = L // 2
    w32 = 4                               # the kernels move 32-bit words
    pt_words = 3 * nl

    def rounds_work(found_k, row_words, empty_muls, ids_read=False):
        """(bytes, IMADs) of the rounds the data needs: the accumulators
        read and written once, `found` read, a row (and, for the kernels
        that read a table, its point id) read only where its slot is
        occupied; an occupied slot's add takes 11 (mixed) or 12 products,
        an empty one `empty_muls` (a projective add of the identity is
        (X*Y : Y*Y : Z*Y), 3 products; the mixed kernel keeps the slot,
        0)."""
        slots = found_k.numel()
        live = int(found_k.sum())
        full = 11 if row_words == 2 * nl else 12
        n_bytes = (2 * pt_words * found_k.shape[-1]
                   + live * (row_words + ids_read) + slots) * w32
        return n_bytes, (live * full + (slots - live) * empty_muls) * imad

    def packed(x):
        return pack32(x, 1).contiguous()

    def bare_table(launch):
        """A bucket kernel's bare launch from its table, into a new
        accumulator tensor."""
        def make(args):
            out = torch.empty_like(args[0])
            return lambda: launch(out, *args, ctx)
        return make

    def bare_add(args):
        P32, Q32 = (packed(a) for a in args)
        return lambda: ek.ec_add32(P32, Q32, ctx)

    # (name, wrapper, plain, args, bare launch factory,
    #  (bytes the kernel moves, IMADs of its mont_muls), shape);
    # the first record of a name is its kernel-line record
    chunk_shape = {"S": S, "R_c": R_c}
    cases = [
        ("bucket_rounds_mixed", ek.bucket_rounds_mixed,
         ek.bucket_rounds_mixed_plain, (buckets, table32, ids, found),
         bare_table(ek.bucket_rounds_mixed32),
         rounds_work(found, 2 * nl, 0, ids_read=True),
         {**chunk_shape, "table_rows": n}),
        ("bucket_rounds_mixed", ek.bucket_rounds_mixed,
         ek.bucket_rounds_mixed_plain,
         (buckets_ipa, table32_ipa, ids_ipa, found_ipa_c),
         bare_table(ek.bucket_rounds_mixed32),
         rounds_work(found_ipa_c, 2 * nl, 0, ids_read=True),
         {"S": S_ipa, "R_c": R_c, "table_rows": 2 * n + 2}),
        ("bucket_rounds_proj", ek.bucket_rounds_proj,
         ek.bucket_rounds_proj_plain,
         (buckets, table_pre, ids_pre, found_pre),
         bare_table(ek.bucket_rounds_proj32),
         rounds_work(found_pre, 3 * nl, 3, ids_read=True),
         {**chunk_shape, "table_rows": W * n}),
        ("ec_add", ek.ec_add, ek.ec_add_plain, (P, Q), bare_add,
         (3 * pt_words * n_add * w32, n_add * 12 * imad), {"n": n_add}),
        ("bucket_round_add", ek.bucket_round_add,
         ek.bucket_round_add_plain, (buckets_round, table_ipa, ids4, found4),
         bare_table(ek.bucket_round_add32),
         rounds_work(found4, 3 * nl, 3, ids_read=True),
         {"S": S_ipa, "table_rows": 2 * n + 2}),
        # kernel 5: the same round on the same operands, so kernel 4's
        # bound; its own minimum is `mxu_bound` below
        ("bucket_round_add_mxu", ek.bucket_round_add_mxu,
         ek.bucket_round_add_mxu_plain,
         (buckets_round, table_ipa, ids4, found4),
         bare_table(ek.bucket_round_add_mxu32),
         rounds_work(found4, 3 * nl, 3, ids_read=True),
         {"S": S_ipa, "table_rows": 2 * n + 2}),
    ]
    cases += form_cases(ctx, proj, gen, device, [
        ("r1cs", combine_shapes(r1cs_msm_n, 2)),
        ("msm", combine_shapes(n, 1, horner=True))])

    records = {}

    def check(name, kernel, plain, args, bare, work, shape):
        """One case's kernel bit-exact against its plain version, timed,
        into `records`."""
        n_bytes, n_imad = work
        got = kernel(*args, ctx)
        _sync(device)
        plain_ms, want = time_ms(lambda: plain(*args, ctx), device, 1)
        if got.shape != want.shape or not torch.equal(got, want):
            err = int((got.long() - want.long()).abs().max()) \
                if got.shape == want.shape else -1
            raise AssertionError(f"{name} at {shape}: kernel differs from "
                                 f"its plain version (max abs word error "
                                 f"{err})")
        err = 0
        wrapper_ms, _ = time_ms(lambda: kernel(*args, ctx), device, reps)
        ms = None                         # the bare kernel: on the card only
        if device.type == "cuda":
            ms, _ = time_ms(bare(args), device, reps)
        bound_ms, bound_by = bound(n_bytes, n_imad)
        rec = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "max_abs_err": err, "ms": ms,
               "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        emit({"phase": "kernel", **rec, "shape": shape})
        sub = {"shape": shape, "max_abs_err": err, "ms": ms,
               "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        if "form" in shape:               # a sequential form of kernel 3
            records[name].setdefault("forms", []).append(sub)
        elif name in records:             # a further shape of a path
            records[name].setdefault("other_shapes", []).append(sub)
        else:
            records[name] = {**rec, "shape": shape}

    for case in cases:
        check(*case)

    # kernel 5 computes kernel 4's function: the same words
    if not torch.equal(
            ek.bucket_round_add_mxu(buckets_round, table_ipa, ids4, found4,
                                    ctx),
            ek.bucket_round_add(buckets_round, table_ipa, ids4, found4,
                                ctx)):
        raise AssertionError("bucket_round_add_mxu differs from "
                             "bucket_round_add")
    k5 = records["bucket_round_add_mxu"]
    k5.update(mxu_bound(ctx, found4, rounds_work(found4, 3 * nl, 3,
                                                 ids_read=True)[0]))
    emit({"phase": "kernel5_bound", **{k: v for k, v in k5.items()
                                        if k.startswith("mxu_")}})

    # independent spot check of the batched add against host ints
    picks = [0, 1, 2, 3, n_add - 1]
    sums = from_device_points(ek.ec_add(P[:, :, picks], Q[:, :, picks],
                                        ctx), ctx)
    pp = from_device_points(P[:, :, picks], ctx)
    qq = from_device_points(Q[:, :, picks], ctx)
    for s, a, b in zip(sums, pp, qq):
        if s != a + b:
            raise AssertionError("ec_add disagrees with host ints")
    emit({"phase": "kernels", "S": S, "S_ipa": S_ipa, "R_c": R_c,
          "seconds": time.time() - t0})

    def check_msms(path, msms):
        """The bucket kernel and kernel 3's sequential forms at the shapes
        of the MSMs a path ran, each (points, sets, c, rounds, pre) as
        `msm_shapes` lists them: at S = W'*B slots of `window_plan(n_sets=
        sets, dup=True)` and the rounds of one launch, kernel 2 from a
        pre-reduced table of W'*points rows where the MSM pre-reduced,
        else kernel 1 from a table of `points` rows; the combine's forms at
        its shapes.  Into `records` under `other_shapes` and `forms`."""
        t1 = time.time()
        for points, sets, c_k, rounds, pre in msms:
            sh = combine_shapes(points, sets, c_k)
            S_k = sh["W_rows"] << c_k
            R_k = msm_mod._chunk_rounds(rounds)
            rows = sh["W_rows"] * points if pre else points
            ids_k, found_k = slot_grid(R_k, S_k, rows)
            affine_k, proj_k = tables(rows)
            name, table_k, words, empty = (
                ("bucket_rounds_proj", proj_k, 3 * nl, 3) if pre
                else ("bucket_rounds_mixed", affine_k, 2 * nl, 0))
            kernel = getattr(ek, name)
            check(name, kernel, getattr(ek, name + "_plain"),
                  (accumulators(S_k), table_k, ids_k, found_k),
                  bare_table(getattr(ek, name + "32")),
                  rounds_work(found_k, words, empty, ids_read=True),
                  {"path": path, "points": points, "sets": sets, "S": S_k,
                   "R_c": R_k, "pre": pre, "table_rows": rows})
            for case in form_cases(ctx, proj, gen, device, [(path, sh)]):
                check(*case)
        emit({"phase": "kernels_at", "path": path, "msms": msms,
              "seconds": time.time() - t1})

    return records, check_msms


def form_cases(ctx, proj, gen, device, paths):
    """Phase 2's cases of kernel 3's sequential forms, at each path's
    combine shapes (`combine_shapes`): the split fold and the duplicate-row
    fold over W' rows of B buckets, the row and column sums, the window
    totals, and where the path runs it on the card (the n-point MSM's
    `msm_device`) the window Horner.  The buckets are projective points,
    1 in 16 the identity."""
    imad = imad_per_mont_mul(ctx)
    nl = ctx.fp.L // 2
    pt_bytes = 3 * nl * 4
    add = 12 * imad
    m = proj.shape[2]

    def points(count):
        pick = torch.randint(0, m, (count,), generator=gen).to(device)
        pts = proj[:, :, pick]
        pts[:, :, ::16] = ctx.identity_like((1,), device)
        return pack32(pts, 1).contiguous()

    def gather_case(path, form, sh, P32, idx, from_identity):
        ncols, n_out = P32.shape[2], idx.shape[0]
        entries = int((idx >= 0).sum())
        starts = 0 if from_identity else int((idx >= 0).any(1).sum())
        work = ((ncols + n_out) * pt_bytes + idx.numel() * 4,
                (entries - starts) * add)
        shape = {"form": form, "path": path, "n_out": n_out,
                 "m": idx.shape[1], "c": sh["c"]}

        def bare(args):
            out = torch.empty((3, nl, n_out), dtype=torch.int32,
                              device=device)
            return lambda: ek.ec_gather_sum32(out, *args, ctx)
        return ("ec_add", ek.ec_gather_sum, ek.ec_gather_sum_plain,
                (P32, idx, from_identity), bare, work, shape)

    cases = []
    for path, sh in paths:
        B = 1 << sh["c"]
        Wr, W, G, K = sh["W_rows"], sh["W"], sh["G"], sh["K"]
        raw = points(Wr * B)
        index = lambda key, make: msm_mod._index_on(key, make, device)
        split_idx = index(("split", Wr, B,
                           tuple(sh["ranges"][:, 0].tolist()),
                           tuple(sh["splits"][:, 0].tolist())),
                          lambda: msm_mod._split_fold_index(
                              Wr, B, sh["ranges"][:, 0].tolist(),
                              sh["splits"][:, 0].tolist()))
        cases.append(gather_case(path, "split_fold", sh, raw, split_idx,
                                 False))
        dup_idx = index(("dup", W, B, sh["dup"]),
                        lambda: msm_mod._dup_fold_index(W, B, sh["dup"]))
        cases.append(gather_case(path, "dup_fold", sh, raw, dup_idx, False))
        base = points(W * B)
        rowcol_idx = index(("rowcol", W, G, K),
                           lambda: msm_mod._rowcol_index(W, G, K))
        cases.append(gather_case(path, "rowcol", sh, base, rowcol_idx,
                                 True))
        rowsum = points(W * G).reshape(3, nl, W, G)
        colsum = points(W * K).reshape(3, nl, W, K)
        dbl = sh["c"] - (sh["c"] + 1) // 2
        adds = W * (2 * (G - 1) + 2 * (K - 1) + dbl + 1)

        def bare_totals(args, W=W):
            out = torch.empty((3, nl, W), dtype=torch.int32, device=device)
            return lambda: ek.ec_window_totals32(out, *args, ctx)
        cases.append(("ec_add", ek.ec_window_totals,
                      ek.ec_window_totals_plain, (rowsum, colsum, dbl),
                      bare_totals,
                      ((W * (G + K) + W) * pt_bytes, adds * add),
                      {"form": "window_totals", "path": path, "W": W,
                       "G": G, "K": K, "dbl": dbl}))
        if sh["horner"]:
            totals = points(W)
            c = sh["c"]

            def bare_horner(args):
                out = torch.empty((3, nl, 1), dtype=torch.int32,
                                  device=device)
                return lambda: ek.ec_horner32(out, *args, ctx)
            cases.append(("ec_add", ek.ec_horner, ek.ec_horner_plain,
                          (totals, W, c), bare_horner,
                          ((W + 1) * pt_bytes, W * (c + 1) * add),
                          {"form": "horner", "path": path, "sets": 1,
                           "wps": W, "c": c}))
    return cases


def _bench_input(n, seed, bits):
    """The bench's MSM input: m = n_base(n) random points repeated to n,
    scalars uniform mod r (or uniform bits), and the independent host value
    sum_j base_j * (sum_{i = j mod m} s_i mod r)."""
    cv = BLS381
    rnd = random.Random(seed)
    m = n_base(n)
    base = _random_points(rnd, m, cv)
    vals = [rnd.randrange(2) if bits else rnd.randrange(cv.r)
            for _ in range(n)]
    coef = [0] * m
    for i, v in enumerate(vals):
        coef[i % m] += v
    expected = G1.identity(cv)
    for b, k in zip(base, coef):
        expected = expected + b * (k % cv.r)
    return [base[i % m] for i in range(n)], vals, expected


def phase_msm(device, n, seed, bits, reps):
    t0 = time.time()
    name = "msm_bitvector" if bits else "msm_uniform"
    ctx = CurveCtx(BLS381)
    pts, vals, expected = _bench_input(n, seed, bits)
    P, affine = to_device_points_affine(pts, ctx, device)
    s = to_device_scalars(vals, ctx, device)[None]
    c = msm_mod.pick_window(n)
    setup = time.time() - t0

    def timed(run):
        """1 + reps runs of run() -> (first seconds, warm p50 seconds),
        each result checked against the host value."""
        times = []
        for _ in range(1 + reps):
            t1 = time.time()
            res = run()
            times.append(time.time() - t1)
            if res.to_bytes() != expected.to_bytes():
                raise AssertionError(f"{name}: MSM bytes differ from the "
                                     "host")
        warm = sorted(times[1:]) if reps else times
        return times[0], warm[len(warm) // 2]

    first, p50 = timed(
        lambda: msm_mod.msm_hybrid(P, s, ctx, c, affine=affine)[0])
    key = (n, 1, c, ctx.cv.name, None)
    rounds, pre = msm_mod._escalation_memo[key]
    dev_first, dev_p50 = timed(lambda: from_device_points(
        msm_mod.msm_device(P, s[0], ctx, c, affine=affine), ctx)[0])
    emit({"phase": name, "n": n, "c": c, "rounds": rounds,
          "pre_reduce": pre, "first_seconds": first,
          "msm_seconds_p50": p50, "points_per_s": n / p50,
          "msm_device_first_seconds": dev_first,
          "msm_device_seconds_p50": dev_p50,
          "setup_seconds": setup, "result": expected.to_bytes().hex()[:32],
          "seconds": time.time() - t0})


def _ipa_bases(n, seed):
    """The bench's config-3 bases and vectors (`bench.py` config3):
    m = n_base(n) hash-derived G and H bases (repeated to n by the
    callers), Q, and uniform a and b."""
    cv = BLS381
    m = n_base(n)
    Gb = [G1.from_msg_hash(b"G%d" % i, cv) for i in range(m)]
    Hb = [G1.from_msg_hash(b"H%d" % i, cv) for i in range(m)]
    Q = G1.from_msg_hash(b"Q", cv)
    rnd = random.Random(seed)
    a = [Scalar.random(rnd, cv) for _ in range(n)]
    b = [Scalar.random(rnd, cv) for _ in range(n)]
    return Gb, Hb, Q, a, b


def _ipa_input(n, seed):
    """`_ipa_bases` with unit factors and P = <a, G> + <b, H> + <a, b> Q
    from one host MSM over the 2m + 1 distinct points."""
    Gb, Hb, Q, a, b = _ipa_bases(n, seed)
    m = len(Gb)
    P = msm_host(Gb + Hb + [Q], _collapse(a, m) + _collapse(b, m)
                 + [inner_product(a, b).v])
    return Gb, Hb, Q, a, b, P


def _collapse(vals, m):
    """sum_{i = j mod m} vals_i mod r for j < m: the scalar of base j."""
    r = BLS381.r
    out = [0] * m
    for i, v in enumerate(vals):
        out[i % m] += v.v if hasattr(v, "v") else v
    return [x % r for x in out]


def _host_check(proof, n, Gb, Hb, Q, P, label):
    """The verification equation of `ipp.verify_ipp` in Python ints,
    independent of the device verifier: replay the transcript, build s,
    and collapse the G and H terms onto their m bases, so the check is one
    host MSM over 2m + 2 lg n + 1 points."""
    r = BLS381.r
    u_sq, u_inv_sq, s = verification_scalars(proof.L, proof.R, n,
                                             bt.ProofTranscript(label))
    a, b = proof.a.v, proof.b.v
    g = _collapse([a * si.v for si in s], len(Gb))
    h = _collapse([b * si.v for si in reversed(s)], len(Hb))
    want = msm_host([Q] + Gb + Hb + list(proof.L) + list(proof.R),
                    [a * b % r] + g + h + [r - u.v for u in u_sq]
                    + [r - u.v for u in u_inv_sq])
    if want != P:
        raise AssertionError("ipa: the proof fails the host check")


def _proof_bytes(proof):
    return ([p.to_bytes() for p in proof.L], [p.to_bytes() for p in proof.R],
            proof.a.to_bytes(), proof.b.to_bytes())


def phase_ipa(device, n, seed, reps):
    """The standalone IPA at n through the port's entry points."""
    t0 = time.time()
    label = b"ipa_smoke"
    Gb, Hb, Q, a, b, P = _ipa_input(n, seed)
    m = len(Gb)
    G = [Gb[i % m] for i in range(n)]
    H = [Hb[i % m] for i in range(n)]
    ones = [Scalar.one(BLS381)] * n
    setup = time.time() - t0

    per_call = {}               # kernel launches of one call of each kind

    def counted(kind, fn):
        before = launch_counts()
        out = fn()
        per_call[kind] = {k: v - before[k] for k, v in
                          launch_counts().items()}
        return out

    def prove(ec_kernel="chunk", profile=False):
        """-> (proof, seconds); profile: the stages' seconds go to
        `prover_device._prof` (each stage synchronizes the card)."""
        prover_device._prof.enabled = profile
        t1 = time.time()
        try:
            proof = counted(f"prove_{ec_kernel}", lambda: bt.create_ipp(
                bt.ProofTranscript(label), Q, ones, ones, G, H, a, b,
                device=device, ec_kernel=ec_kernel))
        finally:
            prover_device._prof.enabled = False
        return proof, time.time() - t1

    prover_device._prof.take()
    # the stage split comes from one more warm call (from the cold call
    # when there are no warm ones), so the timed calls carry no syncs
    proof, prove_first = prove(profile=not reps)
    want = _proof_bytes(proof)
    times = []
    for _ in range(reps):
        again, dt = prove()
        times.append(dt)
        if _proof_bytes(again) != want:
            raise AssertionError("ipa: proofs of one input differ")
    if reps:
        prove(profile=True)
    stages = prover_device._prof.take()

    t1 = time.time()
    _host_check(proof, n, Gb, Hb, Q, P, label)
    host_check = time.time() - t1
    # what the point-table cache pays on every prove and verify call
    t1 = time.time()
    content_digest(G, CurveCtx(BLS381))
    content_digest(H, CurveCtx(BLS381))
    digest = time.time() - t1

    def verify(a_fin):
        t1 = time.time()
        counted("verify", lambda: bt.verify_ipp(
            n, bt.ProofTranscript(label), ones, ones, P, Q, G, H, a_fin,
            proof.b, proof.L, proof.R, device=device))
        return time.time() - t1

    verify_first = verify(proof.a)
    vtimes = [verify(proof.a) for _ in range(reps)]
    try:
        bt.verify_ipp(n, bt.ProofTranscript(label), ones, ones, P, Q, G, H,
                      proof.a + Scalar.one(BLS381), proof.b, proof.L,
                      proof.R, device=device)
    except VerificationError:
        pass
    else:
        raise AssertionError("ipa: a tampered proof (a + 1) verified")

    round_proof, round_s = prove("round")
    if _proof_bytes(round_proof) != want:
        raise AssertionError("ipa: the per-round kernel's proof differs")
    p50 = lambda ts, first: sorted(ts)[len(ts) // 2] if ts else first
    emit({"phase": "ipa", "n": n, "bases": m,
          "ipa_prove_first_seconds": prove_first,
          "ipa_prove_seconds_p50": p50(times, prove_first),
          "ipa_prove_stage_seconds": stages,
          "stage_call": "warm" if reps else "cold",
          "ipa_verify_first_seconds": verify_first,
          "ipa_verify_seconds_p50": p50(vtimes, verify_first),
          "ipa_prove_round_kernel_seconds": round_s,
          "host_check_seconds": host_check,
          "table_digest_seconds": digest, "launches_per_call": per_call,
          "tampered_rejected": True,
          "round_kernel_proof_identical": True, "setup_seconds": setup,
          "a": proof.a.to_bytes().hex()[-32:], "seconds": time.time() - t0})
    return per_call


def _agg_range_prover(seed, m, bits, g, h, device):
    """The bench's config-2 statement (`bench.py:581-590`): m values of
    `bits` bits, each bound-checked in [0, 2^bits - 1] on one Prover, with
    the bench's rng order.  -> (prover, commitments per value)."""
    rng = random.Random(seed)
    vs = [rng.randrange(1 << (bits - 1)) for _ in range(m)]
    prover = bt.Prover(g, h, bt.ProofTranscript(b"AggRange"), rng=rng,
                       device=device)
    comms = [bound_check.prove_bounded_num(v, None, 0, (1 << bits) - 1,
                                           bits, rng, prover) for v in vs]
    return prover, comms


def _agg_range_verifier(comms, bits, device):
    verifier = bt.Verifier(bt.ProofTranscript(b"AggRange"), device=device)
    for c in comms:
        bound_check.verify_bounded_num(0, (1 << bits) - 1, bits, c,
                                       verifier)
    return verifier


def phase_r1cs(device, m, bits, reps, ref):
    """The aggregated range proof through the port's entry points: `Prover`
    with `models.bound_check`, `Prover.prove`, `Verifier.verify`.
    ref: {"seed", "sha256"} of the JAX package's proof for this statement;
    the proof of that seed must have that digest."""
    t0 = time.time()
    n = m * 2 * bits
    cv = BLS381
    G = bt.get_generators("G", n)
    H = bt.get_generators("H", n)
    g, h = G1.from_msg_hash(b"g", cv), G1.from_msg_hash(b"h", cv)
    setup = time.time() - t0

    per_call = {}

    def counted(kind, fn):
        before = launch_counts()
        out = fn()
        per_call[kind] = {k: v - before[k] for k, v in
                          launch_counts().items()}
        return out

    def prove(seed, profile=False):
        """-> (proof, commitments, prove seconds); profile: the stages'
        seconds go to `prover_device._prof`."""
        prover, comms = _agg_range_prover(seed, m, bits, g, h, device)
        prover_device._prof.enabled = profile
        t1 = time.time()
        try:
            proof = counted("prove", lambda: prover.prove(G, H))
        finally:
            prover_device._prof.enabled = False
        return proof, comms, time.time() - t1

    seeds = [1, 2, 3, 4][:1 + reps]
    runs = {seed: prove(seed) for seed in seeds}
    if ref["seed"] not in runs:
        raise AssertionError(f"r1cs: no proof of the reference seed "
                             f"{ref['seed']}")
    proof, comms, _ = runs[ref["seed"]]
    digest = hashlib.sha256(proof.to_bytes()).hexdigest()
    if digest != ref["sha256"]:
        raise AssertionError(f"r1cs: proof of seed {ref['seed']} has sha256 "
                             f"{digest}, the JAX package's {ref['sha256']}")
    prover_device._prof.take()
    again, _, staged = prove(ref["seed"], profile=True)
    stages = prover_device._prof.take()
    stages["other"] = staged - sum(stages.values())
    if again.to_bytes() != proof.to_bytes():
        raise AssertionError("r1cs: proofs of one input differ")

    t1 = time.time()
    _agg_range_verifier(comms, bits, device)._verify(proof, g, h, G, H)
    host_check = time.time() - t1

    def verify(pf):
        verifier = _agg_range_verifier(comms, bits, device)
        t1 = time.time()
        counted("verify", lambda: verifier.verify(pf, g, h, G, H))
        return time.time() - t1

    verify_first = verify(proof)
    vtimes = [verify(proof) for _ in range(reps)]
    bad = bt.R1CSProof.from_bytes(proof.to_bytes())
    bad.t_x = bad.t_x + Scalar.one(cv)
    try:
        verify(bad)
    except VerificationError:
        pass
    else:
        raise AssertionError("r1cs: a tampered proof (t_x + 1) verified")

    warm = sorted(runs[sd][2] for sd in seeds[1:]) or [runs[1][2]]
    p50 = lambda ts: ts[len(ts) // 2]
    emit({"phase": "r1cs", "m": m, "bits": bits, "n": n,
          "r1cs_prove_first_seconds": runs[1][2],
          "r1cs_prove_seconds_p50": p50(warm),
          "r1cs_prove_stage_seconds": stages,
          "r1cs_verify_first_seconds": verify_first,
          "r1cs_verify_seconds_p50": p50(sorted(vtimes) or [verify_first]),
          "proof_sha256": digest, "reference_seed": ref["seed"],
          "matches_reference": True, "host_check_seconds": host_check,
          "tampered_rejected": True, "launches_per_call": per_call,
          "setup_seconds": setup, "seconds": time.time() - t0})
    return per_call


def smt_params(ref):
    """The reference's Poseidon parameters and s-box on BLS12-381."""
    p = ref["poseidon"]
    return (PoseidonParams(p["width"], p["full_rounds_beginning"],
                           p["full_rounds_end"], p["partial_rounds"],
                           cv=BLS381), p["sbox"])


def trace(run):
    """Run run() once under torch.profiler on the card: -> (its result,
    {traced wall ms, device busy ms (kernels, copies and sets), idle share,
    kernels, copies and sets})."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, kernels, copies = 0.0, 0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += ev.time_range.elapsed_us()
            if ev.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
    return out, {"traced_wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
                 "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
                 "device_kernels": kernels, "device_copies_and_sets": copies}


def phase_smt(device, ref, n_bulk, reps):
    """The bench's three Poseidon / sparse-Merkle-tree sections through the
    port's entry points, with `ref`'s parameters and seeds (the shape of
    tests/vectors/torch_smt4_d12.json):
      - bulk Poseidon (`bench.py:671-685`): `poseidon_hash_4_batch` over
        n_bulk child lists from random.Random(11), one warm call and one
        timed; 64 sampled outputs against the host `Poseidon_hash_4`;
      - SMT-4 batch update (`bench.py:687-710`): the two batches of
        `ref["updates"]`, the first warm, the second timed; the root
        against the JAX package's, `verify_proof` of 16 updated leaves
        with the host hash;
      - the leaf-inclusion proof (`bench.py:449-489`): 1 + reps rounds of
        one `gen_proof_of_leaf_inclusion_4_ary_merkle_tree` and its
        `verify_proof_of_...`, the first a warm-up whose proof must have
        the JAX package's sha256; the stages of one more round's proof
        (of the first without warm rounds); the host check
        `Verifier._verify`; t_x + 1 rejected.
    On the card, one bulk batch and one proof are traced.  Returns the
    launches of one proof and one verification, the shapes of their MSMs
    (`msm_shapes`), and the first proof with its commitments and tree
    root."""
    t0 = time.time()
    cv = BLS381
    params, sbox = smt_params(ref)
    depth = ref["depth"]
    on_card = torch.device(device).type == "cuda"
    out = {"phase": "smt", "depth": depth}

    rnd = random.Random(11)                  # the bench's seed
    kids = [[Scalar.random(rnd, cv) for _ in range(4)] for _ in range(n_bulk)]

    def bulk():
        t1 = time.time()
        res = poseidon_device.poseidon_hash_4_batch(kids, params, sbox,
                                                    device=device)
        return res, time.time() - t1

    _, out["poseidon_hash4_first_seconds"] = bulk()
    hashes, dt = bulk()
    out["poseidon_hash4_per_s"] = n_bulk / dt
    for i in random.Random(12).sample(range(n_bulk), min(64, n_bulk)):
        if hashes[i] != Poseidon_hash_4(kids[i], params, sbox):
            raise AssertionError(f"smt: batched hash {i} differs from the "
                                 "host Poseidon_hash_4")
    if on_card:
        _, out["poseidon_batch_trace"] = trace(bulk)

    upd = ref["updates"]
    rnds = random.Random(upd["seed"])
    batches = [[(Scalar(rnds.randrange(4 ** depth), cv),
                 Scalar.random(rnds, cv)) for _ in range(upd["batch"])]
               for _ in range(2)]
    db = InMemoryHashDb()
    tree = VanillaSparseMerkleTree_4(params, depth, db, device=device)
    times = []
    for pairs in batches:
        t1 = time.time()
        tree.batch_update(pairs, db)
        times.append(time.time() - t1)
    out["smt4_updates_first_seconds"] = times[0]
    out["smt4_updates_per_s"] = upd["batch"] / times[1]
    if tree.root.to_bytes().hex() != upd["root_both_batches"]:
        raise AssertionError("smt: root after both batches differs from the "
                             "JAX package's")
    final = dict((k.v, v) for pairs in batches for k, v in pairs)
    for k in random.Random(upd["seed"] + 1).sample(sorted(final),
                                                   min(16, len(final))):
        nodes = []
        leaf = tree.get(Scalar(k, cv), nodes, db)
        if leaf != final[k] or not tree.verify_proof(Scalar(k, cv), leaf,
                                                     nodes):
            raise AssertionError(f"smt: leaf {k} fails verify_proof")

    pr = ref["proof"]
    t1 = time.time()
    pdb = InMemoryHashDb()
    ptree = VanillaSparseMerkleTree_4(params, depth, pdb, device=device)
    key = Scalar(pr["key"], cv)
    ptree.update(key, Scalar(pr["value"], cv), pdb)
    nodes = []
    leaf = ptree.get(key, nodes, pdb)
    if ptree.root.to_bytes().hex() != pr["tree_root"]:
        raise AssertionError("smt: the proof's tree root differs")
    G = bt.get_generators("G", pr["n"])
    H = bt.get_generators("H", pr["n"])
    g, h = G1.from_msg_hash(b"g", cv), G1.from_msg_hash(b"h", cv)
    label = pr["label"].encode()
    rng = random.Random(pr["rng_seed"])
    out["setup_seconds"] = time.time() - t1

    per_call = {}
    # the escalation memo starts empty for the proofs, so that it lists
    # every MSM shape they run (`msm_shapes`); earlier entries come back
    # after
    memo = msm_mod._escalation_memo
    earlier = dict(memo)
    memo.clear()

    def counted(kind, fn):
        before = launch_counts()
        res = fn()
        per_call[kind] = {k: v - before[k] for k, v in
                          launch_counts().items()}
        return res

    def prove():
        return smt4.gen_proof_of_leaf_inclusion_4_ary_merkle_tree(
            leaf, key, None, nodes, ptree.root, depth, params, sbox, rng,
            label, g, h, G, H, device=device)

    def verify(proof, comms):
        smt4.verify_proof_of_leaf_inclusion_4_ary_merkle_tree(
            ptree.root, depth, params, sbox, proof, comms, label, g, h, G, H,
            device=device)

    def once(profile=False):
        """One proof and its verification -> (proof, commitments, prove
        seconds, verify seconds); profile: the proof's stages' seconds go
        to `prover_device._prof`."""
        prover_device._prof.enabled = profile
        t1 = time.time()
        try:
            proof, comms = counted("prove", prove)
        finally:
            prover_device._prof.enabled = False
        t2 = time.time()
        counted("verify", lambda: verify(proof, comms))
        return proof, comms, t2 - t1, time.time() - t2

    # the stage split comes from one more warm proof (from the first when
    # there are no warm ones), so the timed proofs carry no syncs
    prover_device._prof.take()
    proof, comms, out["smt4_d12_prove_first_seconds"], \
        out["smt4_d12_verify_first_seconds"] = once(profile=not reps)
    digest = hashlib.sha256(proof.to_bytes()).hexdigest()
    if digest != pr["sha256"]:
        raise AssertionError(f"smt: the first proof has sha256 {digest}, "
                             f"the JAX package's {pr['sha256']}")
    runs = [once() for _ in range(reps)]
    p50 = lambda ts, first: sorted(ts)[len(ts) // 2] if ts else first
    out["smt4_d12_prove_seconds_p50"] = p50(
        [r[2] for r in runs], out["smt4_d12_prove_first_seconds"])
    out["smt4_d12_verify_seconds_p50"] = p50(
        [r[3] for r in runs], out["smt4_d12_verify_first_seconds"])

    staged = once(profile=True)[2] if reps \
        else out["smt4_d12_prove_first_seconds"]
    stages = prover_device._prof.take()
    stages["other"] = staged - sum(stages.values())
    out["smt4_d12_prove_stage_seconds"] = stages
    out["stage_call"] = "warm" if reps else "cold"

    t1 = time.time()
    verifier = bt.Verifier(bt.ProofTranscript(label), device=device)
    smt4.verify_leaf_inclusion_4_ary_merkle_tree(
        ptree.root, depth, params, sbox, comms, g, h, verifier)
    verifier._verify(proof, g, h, G, H)
    out["host_check_seconds"] = time.time() - t1
    bad = bt.R1CSProof.from_bytes(proof.to_bytes())
    bad.t_x = bad.t_x + Scalar.one(cv)
    try:
        verify(bad, comms)
    except VerificationError:
        pass
    else:
        raise AssertionError("smt: a tampered proof (t_x + 1) verified")
    if on_card:
        _, out["proof_trace"] = trace(prove)

    # the round counts and pre-reduction passes that the MSMs of the proof
    # and its verification settled on, by shape
    msms = msm_shapes()
    for k, v in earlier.items():
        memo.setdefault(k, v)
    out["msm_escalation"] = {
        f"points={n},sets={k},c={c}": {"rounds": r, "pre": pre}
        for n, k, c, r, pre in msms}
    emit({**out, "n_bulk": n_bulk, "updates": upd["batch"], "n": pr["n"],
          "proof_sha256": digest, "matches_reference": True,
          "root_matches_reference": True, "tampered_rejected": True,
          "launches_per_call": per_call, "seconds": time.time() - t0})
    return {"launches": per_call, "msms": msms, "proof": proof,
            "commitments": comms, "root": ptree.root}


def msm_shapes():
    """The MSM shapes in `msm._escalation_memo`, with the rounds and
    pre-reduction passes that `msm_hybrid` settled on for each:
    [(points, sets, c, rounds, pre)]."""
    return [(k[0], k[1], k[2], *v) for k, v in
            msm_mod._escalation_memo.items()]


def _ipa_round_schedule(n, seed, device):
    """The bucket rounds of the IPA's first two-set MSM at n, as
    `msm.bucket_accumulate` plans them: -> (the packed projective table
    [G | H | Q | identity] (2n+2, 3NL), per-round point ids (R, S) int32,
    found (R, S) int32)."""
    ctx = CurveCtx(BLS381)
    fr = ctx.fr
    Gb, Hb, Q, a, b = _ipa_bases(n, seed)
    k = len(Gb)
    pts = [Gb[i % k] for i in range(n)] + [Hb[i % k] for i in range(n)]
    table, _ = to_device_points_affine(pts + [Q], ctx, device)
    table = torch.cat([table, ctx.identity_like((1,), device)], dim=2)
    mont = lambda v: prover_device._mont(fr, v, device)
    ones = mont([1] * n)
    scal2 = prover_device._ipa_round_scalars(mont(a), mont(b), ones, ones,
                                             n, fr)
    c = msm_mod.pick_window(2 * n + 2)
    rounds = msm_mod.occupancy_guess(n + 1, ctx, c)
    ranges, splits, dup = msm_mod.window_plan(ctx, c, n_sets=2, dup=True)
    digits = msm_mod._spread_dup_rows(msm_mod._digits_multi(scal2, ctx, c),
                                      dup)
    grid, found, occ = msm_mod._slot_grid(digits, 1 << c, rounds, ranges,
                                          splits)
    if occ > rounds:
        raise AssertionError(f"mxu_race: occupancy {occ} > {rounds} rounds")
    ids = grid.reshape(rounds, -1).clamp(max=2 * n + 1).to(torch.int32)
    return (ek.proj_rows32(table), ids,
            found.reshape(rounds, -1).to(torch.int32))


def phase_mxu_race(device, n, seed):
    """One per-round bucket pass of the IPA MSM through kernel 5 and kernel
    4, in turns (4, 5, 5, 4): microseconds per round of each, and the
    final buckets bit-exact.  Both read their rows by id from the packed
    table; on the card the bare launches are timed, on the CPU the
    wrappers run their plain versions."""
    t0 = time.time()
    device = torch.device(device)
    ctx = CurveCtx(BLS381)
    table32, ids, found = _ipa_round_schedule(n, seed, device)
    R, S = found.shape
    ident = ek.packed_identity(ctx, (S,), device)
    on_card = device.type == "cuda"

    def runner(wrapper, bare):
        def run():
            acc = ident.clone()
            for r in range(R):
                if on_card:
                    bare(acc, acc, table32, ids[r], found[r], ctx)
                else:
                    acc = wrapper(acc, table32, ids[r], found[r], ctx)
            return acc
        return run

    kernels = {"bucket_round_add": runner(ek.bucket_round_add,
                                          ek.bucket_round_add32),
               "bucket_round_add_mxu": runner(ek.bucket_round_add_mxu,
                                              ek.bucket_round_add_mxu32)}
    us, out = {}, {}
    for name in ("bucket_round_add", "bucket_round_add_mxu",
                 "bucket_round_add_mxu", "bucket_round_add"):
        ms, out[name] = time_ms(kernels[name], device, 1)
        us.setdefault(name, []).append(ms * 1e3 / R)
    if not torch.equal(out["bucket_round_add"],
                       out["bucket_round_add_mxu"]):
        raise AssertionError("mxu_race: kernel 5's buckets differ from "
                             "kernel 4's")
    emit({"phase": "mxu_race", "n": n, "rounds": R, "S": S,
          "occupied_slots": int(found.sum()),
          "us_per_round": {k: sum(v) / len(v) for k, v in us.items()},
          "us_per_round_turns": us, "timed": "bare launches" if on_card
          else "plain versions (CPU)", "buckets_identical": True,
          "seconds": time.time() - t0})


def launch_counts():
    """Kernel launches so far: per kernel, and kernel 3's also per form
    (`ec_add:<form>`, `ek.form_launches`)."""
    return {**ek.launches,
            **{f"ec_add:{k}": v for k, v in ek.form_launches.items()}}


def _run_path(name, drive, per_call=None):
    """Drive one path with the launch counts at 0 and read them after:
    -> the path's counts; each kernel (and form of kernel 3) of the path
    must have launched.
    per_call: a dict that gets what drive() returns (its per-call
    counts)."""
    ek.reset_launches()
    out = drive()
    counts = launch_counts()
    if per_call is not None:
        per_call[name] = out
    for kernel in PATHS[name]:
        if counts[kernel] <= 0:
            raise AssertionError(f"{kernel} never launched on the {name} "
                                 "path")
    return counts


def add_launches(records, by_path):
    """Each record's launches over the paths' runs, in total and by path;
    kernel 3's sequential forms' sub-records by their kernel form."""
    for name, rec in records.items():
        rec["launches"] = sum(c[name] for c in by_path.values())
        rec["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
    for sub in records["ec_add"].get("forms", []):
        key = "ec_add:" + FORM_KERNEL[sub["shape"]["form"]]
        sub["launches"] = sum(c[key] for c in by_path.values())
        sub["launches_by_path"] = {p: c[key] for p, c in by_path.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0xBE7C)
    ap.add_argument("--n", type=int, default=1 << 16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    t_start = time.time()
    with using_curve(BLS381):
        kind, smi = phase_device()
        phase_build()
        records, check_msms = phase_kernels("cuda", args.n, args.seed)

        def msm_path():
            phase_msm("cuda", args.n, args.seed, bits=False, reps=3)
            phase_msm("cuda", args.n, args.seed + 1, bits=True, reps=3)

        ref = json.loads(R1CS_REFERENCE.read_text())
        smt_ref = json.loads(SMT_REFERENCE.read_text())
        per_call = {}
        by_path = {
            "msm": _run_path("msm", msm_path),
            "ipa": _run_path("ipa", lambda: phase_ipa(
                "cuda", args.n, args.seed + 2, reps=3), per_call),
            "r1cs": _run_path("r1cs", lambda: phase_r1cs(
                "cuda", ref["m"], ref["bits"], 3, ref), per_call),
            "smt": _run_path("smt", lambda: phase_smt(
                "cuda", smt_ref, 8192, 3), per_call),
            "mxu_race": _run_path("mxu_race", lambda: phase_mxu_race(
                "cuda", args.n, args.seed + 3)),
        }
        smt = per_call["smt"]
        per_call["smt"] = smt["launches"]
        check_msms("smt", smt["msms"])   # outside the paths' counts
        add_launches(records, by_path)
        emit({"phase": "launches", "launches": by_path,
              "per_r1cs_proof": per_call["r1cs"]["prove"],
              "per_r1cs_verify": per_call["r1cs"]["verify"],
              "per_ipa_proof": per_call["ipa"]["prove_chunk"],
              "per_ipa_verify": per_call["ipa"]["verify"],
              "per_smt_proof": per_call["smt"]["prove"],
              "per_smt_verify": per_call["smt"]["verify"],
              "seconds": time.time() - t_start})
    print(smi, flush=True)
    emit({"kernels": [records[k] for k in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
