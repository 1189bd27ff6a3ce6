"""Drive the PyTorch/CUDA port on one NVIDIA card: build its kernels, hold
each kernel against its plain PyTorch version, and run the n = 2^16 device
Pippenger MSM, the n = 2^16 inner-product argument (prove and verify;
fused, every round and its transcript on the card, against per-round), the
aggregated range proof (R1CS prove and verify, m = 16 values of 64 bits,
n = 2048), the Poseidon / sparse-Merkle-tree workloads (bulk hashing,
batch updates, the depth-12 SMT-4 leaf-inclusion proof), the batch
verifiers (8 range proofs in one check, 4 IPA proofs in one check),
every other gadget's proof, and the sharded MSM and prover on a mesh of
4 shards of the card, of BLS12-381 end to end; then ed25519 (a != 0:
RCB16 algorithm 1 in kernels 2-4) end to end, and the H100 roofline of the
group law and the product.

    python3 chip_smoke.py [--seed S] [--n N]
    python3 chip_smoke.py --trace-ipa REPS   # phase 6b's traces alone

To compare two trees' fused IPA on one card, copy this file into the root
of the other tree and run `python3 chip_smoke.py --trace-ipa 2` from each
root in turns (parent, change, change, parent): each copy traces the
package of the tree it stands in.

Phases, each printing one JSON line with its seconds:
  0 device   the card's name and power limit (nvidia-smi);
  1 build    nvcc of csrc/ec_kernels.cu, csrc/mxu_kernels.cu,
             csrc/roofline_kernels.cu and csrc/transcript_kernels.cu, in
             parallel, into ctypes libraries; ptxas's registers, stack and
             spills (the a != 0 instantiations named `<8, a!=0>`; those of
             `bp_ipa_challenge` again on their own line, `kernel_ptxas`,
             and in its record); kernel 5's SASS holds IMMA and no IDP.4A;
  2 kernels  each kernel against its plain version at the width each path
             gives it (bit-exact; kernel 5 also against kernel 4): the
             bucket kernels from a packed point table of the path's size
             by a random slot grid, kernel 1 at the MSM's and the IPA's
             slots, kernel 2 at the MSM's from a pre-reduced table of W*n
             rows, kernel 4 at the IPA's, kernel 3 pairwise and its
             sequential forms (the
             folds, row and column sums, window totals and Horner of the
             combine) at the range proof's and the MSM's combine shapes,
             each gather-sum case in the layout its shape gets, and its
             pre-reduction form at the bit-vector MSM's W x n entries and
             passes (its bound counts the adds of the merging entries),
             the fused IPA's `bp_ipa_challenge` on a projective point
             and the identity from a transcript whose round crosses the
             STROBE rate, and the roofline's chain kernel (both forms, 100
             steps over 8192 inputs); with the bare kernel's time on operands
             prepared beforehand (`ms`), the wrapper's time with its
             checks and any 16/32-bit limb packing (`wrapper_ms`), the
             plain version's time and the card's bound for the same work;
             `bp_ipa_challenge`'s time by span (`kernel_split`: its timed
             form's clock64() stamps, `tk.SPLIT`);
             after the paths, the bucket kernel and the combine's forms
             again at the shapes of each MSM that phase 7 ran (`kernels_at`:
             kernel 2 at the witness's and the IPA's pre-reduced tables and
             the pre-reduction form at their entries and passes, kernel 1
             at the verifier's);
  3 msm_uniform    n random-scalar MSM (the bench's input: 256 base points
                   repeated) through `msm_hybrid`, 1 + 3 runs, and through
                   `msm_device` (the path of the public `msm`), 1 + 3 runs,
                   each checked against an independent host sum;
  4 msm_bitvector  n scalars in {0, 1}, the same two paths: escalates to
                   pre-reduction, so the projective bucket kernel and the
                   batched add run too;
  5 ipa      the standalone IPA at n (the bench's config 3: 256 hash-derived
             G and H bases repeated to n, unit factors), fused (the
             default): prove 1 + 3 times with the chunked bucket kernels,
             the per-stage seconds of one more proof, a host check of the
             proof in Python ints that does not use the device
             verifier, `verify_ipp` 1 + 3 times, a tampered proof
             rejected, and one proof with the per-round bucket kernel,
             byte-identical to the chunked one;
  6 r1cs     the bench's config 2: m = 16 aggregated 64-bit range proofs,
             n = 2048, `get_generators("G"/"H", 2048)`: prove 1 + 3 times
             (seeds 1-4), the stages of one more proof, the seed-2 proof's
             sha256 against the JAX package's
             (tests/vectors/torch_r1cs_agg16.json), a host check through
             `Verifier._verify` over `msm_host`, `verify_device` 1 + 3
             times, and t_x + 1 rejected;
 6b ipa_fused  the fused IPA against the per-round one (`fused=False`:
             `msm_hybrid` and the host transcript each round) on phase 5's
             input: 1 + 3 proofs of each in turns, all byte-identical,
             each path's p50 and the stages of one more proof of each;
             the same turns of phase 6's seed-2 statement, every proof's
             sha256 the JAX package's; one traced IPA proof of each
             (device busy, idle share); one warm fused IPA under
             torch.cuda.set_sync_debug_mode("error") from its first launch
             to its one fetch; each trace's device ms of its costliest
             kernels and of `bp_ipa_challenge`; after the paths,
             `bp_ipa_challenge` against its plain version at the first two
             rounds' real L and R, with its bound there, its bare and
             wrapper times (3 runs of 50 launches each) and split
             (`kernel_at_path`);
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
  9 batch    the bench's `batch_verify_sec` (`bench.py:405-445`): 8
             config-2 proofs (seeds 70-77), one template `Verifier` and
             `rebind` per proof, `batch_verify` 1 + 3 times
             (`batch8_m16_verify_seconds_p50`, `batch_verify_proofs_per_s`),
             each proof through `verify_device` alone, proof 5's t_x + 1
             named by the bisection and rejected with localize=False; then
             `batch_verify_ipp` over 4 IPA proofs at n (phase 5's bases),
             accepted, and proof 2's a + 1 named;
 10 gadgets  one proof and one verification of each gadget of
             tests/vectors/torch_gadgets.json at its reference test's size
             (non-zero, the three set gadgets, MiMC 322 rounds, Hamming
             distance over 150 elements, the depth-8 randomizer at n =
             16384; the first run derives 16384 G and H, ~100 s): each
             proof's sha256 against the JAX package's, the statement
             tampered rejected; after the paths, the bucket kernel and the
             combine's forms at the shapes of its MSMs (`kernels_at`);
 12 sharded the sharded MSM and prover (`bulletproofs_tpu_torch.parallel`)
             on `make_mesh([cuda:0] * 4)`, four shards of the one card:
             `msm_sharded` on phase 3's input 1 + 3 times beside 1 + 3 of
             `msm_device`, `msm_sharded_2d` on a 2 x 2 mesh once,
             `msm_multi_sharded` on phase 4's bit vector 1 + 3 times (the
             shards pre-reduce), each against the host sum; one
             `msm_sharded` traced (the butterfly's device ms: its pairwise
             adds); `create_ipp_sharded` on phase 5's input 1 + 1 times,
             the bytes of phase 5's proof; `prove_sharded` on phase 6's
             statements, seeds 1-4, the seed-2 proof's sha256 against the
             JAX package's, `Verifier.verify` accepts it, t_x + 1
             rejected, the stages of one more proof; after the paths, the
             bucket kernels, kernel 3 pairwise and the combine's forms at
             the per-shard shapes (`kernels_at`);
 13 ed25519  under `using_curve(ED25519)`, with the plain add made to
             raise on a CUDA tensor (`no_plain_add_on_card`): phases 3-4
             on ed25519 inputs (the n-point uniform and bit-vector MSMs,
             1 + 3 runs each of `msm_hybrid` and `msm_device`, against the
             host sums), phase 5 at n (per round: Edwards transcripts;
             the host check, a + 1 rejected, the per-round kernel's proof
             identical), phase 6 on config 2 (the seed-2 proof's sha256
             against tests/vectors/torch_ed25519.json, verified, the host
             check, t_x + 1 rejected), and the three gadget proofs of the
             JAX package's tests/test_ed25519.py at n = 512
             (`ed25519_gadget_case`: each sha256 against the vector,
             verified, tampered rejected); kernels 2-4 launch their
             a != 0 builds only, and kernel 1 and `bp_ipa_challenge`
             must not launch (`NOT_ON_PATH`); after
             the paths, phase 2's checks on ed25519 (kernels 2-4, kernel 3
             pairwise and its forms, 18 products an add in the bounds)
             and `kernels_at` at the shapes of the MSMs the phase ran;
             then phase 2's checks on BN254 and secp256k1, which no path
             here runs;
 14 roofline `utils/roofline.py: roofline_report` on BLS12-381 and
             ed25519 (one timed launch of each form of the chain kernel,
             `csrc/roofline_kernels.cu`: 100 dependent adds or products
             over 8192 distinct canonical inputs; measured and
             speed-of-light rates, utilisation), with the card's name and
             power limit, each after its `chain_latency` line (one point,
             64 steps: the microseconds of a product, of an add and a
             dedicated doubling on a group of 4 lanes, and of both on a
             warp, the lone chains' layout); phase 2 holds the chain
             kernel bit-exact against its plain version at that size on
             both curves, and its doubling and warp forms at 1024 points;
 11 launches the launch counts of each path (phases 3-4, 5, 6, 6b, 7, 9,
             10, 8, 12, 13, 14), kernel 3's also by form, each split by
             build (a = 0, and a != 0 under `<kernel>:a!=0`), each build
             of a kernel a path runs (and each form of kernel 3, `PATHS`)
             required > 0 there, pairwise kernel 3 required 0 on the paths
             whose pairwise adds were all pre-reduction passes (`NOT_ON_PATH`:
             the MSMs, the SMT-4 proofs, the gadgets), and the counts of
             one range proof and
             verification, one IPA proof and verification, one fused and
             one per-round IPA proof, one SMT-4 proof and verification, one
             batch check, each gadget's proof and verification, one sharded
             proof and ed25519's calls.
The last line is {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero before it.  Without a CUDA card the script exits 2.
"""

import argparse
import contextlib
import hashlib
import functools
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch.config import (BLS381, BN254, ED25519, SECP256K1,
                                           curve, using_curve)
from bulletproofs_tpu_torch.ipp import verification_scalars
from bulletproofs_tpu_torch.ops import build, ec as ec_mod, ec_kernels as ek
from bulletproofs_tpu_torch.ops import transcript_kernels as tk
from bulletproofs_tpu_torch.ops.transcript_device import DeviceTranscript
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
from bulletproofs_tpu_torch.ops.field import (limbs_to_ints, pack32,
                                              unpack32)
from bulletproofs_tpu_torch.ops.ec_host import G1, msm_host
from bulletproofs_tpu_torch.ops.field_host import Scalar, inner_product
from bulletproofs_tpu_torch.utils.errors import (BatchVerificationError,
                                                 VerificationError)
from bulletproofs_tpu_torch.utils.hash_db import InMemoryHashDb
from bulletproofs_tpu_torch.utils import roofline
from bulletproofs_tpu_torch.utils.roofline import (HBM_BYTES_PER_S,
                                                   IMAD_PER_S, INT8_MAC_PER_S,
                                                   bound, imad_per_mont_mul,
                                                   mont_muls_per_add,
                                                   mont_muls_per_dbl)
from bulletproofs_tpu_torch.parallel import (create_ipp_sharded, make_mesh,
                                             make_mesh_2d, msm_multi_sharded,
                                             msm_sharded, msm_sharded_2d,
                                             prove_sharded)
from bulletproofs_tpu_torch.parallel import sharded_msm as sharded_msm_mod
from bulletproofs_tpu_torch.parallel import sharded_prover

# The bound model (HBM_BYTES_PER_S, IMAD_PER_S, INT8_MAC_PER_S, the IMADs
# of a product and `bound`) is the H100's of utils/roofline.py.

KERNEL_SOURCE = "bulletproofs_tpu_torch/csrc/ec_kernels.cu"
REPLACES = {
    "bucket_rounds_mixed": "bulletproofs_tpu/ops/ec_pallas.py:425",
    "bucket_rounds_proj": "bulletproofs_tpu/ops/ec_pallas.py:355",
    "ec_add": "bulletproofs_tpu/ops/ec_pallas.py:499",
    "bucket_round_add": "bulletproofs_tpu/ops/ec_pallas.py:469",
    "bucket_round_add_mxu": "bulletproofs_tpu/ops/ec_pallas.py:217",
    # XLA code, not a Pallas kernel: the device transcript and keccak that
    # the JAX package's fused IPA traces into its program
    "ipa_challenge": "bulletproofs_tpu/ops/transcript_device.py:129 "
                     "(DeviceTranscript, serialize_points :273), "
                     "bulletproofs_tpu/ops/keccak_jax.py:60",
    # XLA code, not a Pallas kernel: the roofline harness's jitted
    # fori_loop chains
    "chain": "bulletproofs_tpu/utils/roofline.py:49 (_ec_add_chain), "
             ":56 (_mont_mul_chain)",
}
SOURCES = {name: KERNEL_SOURCE for name in REPLACES}
SOURCES["bucket_round_add_mxu"] = "bulletproofs_tpu_torch/csrc/mxu_kernels.cu"
SOURCES["ipa_challenge"] = "bulletproofs_tpu_torch/csrc/transcript_kernels.cu"
SOURCES["chain"] = "bulletproofs_tpu_torch/csrc/roofline_kernels.cu"
# The kernels each path launches, kernel 3 by form (`launch_counts`): the
# MSM phases 3-4, the IPA phase 5, the range proof phase 6, the fused IPA
# against the per-round one (phase 6b), the sparse Merkle tree phase 7, the
# race of kernels 5 and 4 (phase 8), the batch verifiers (phase 9), the
# gadgets (phase 10) and the sharded MSMs and proofs (phase 12).  Each must
# launch on its path.  Every single-device proof's IPA runs fused: its MSMs
# end in the Horner form on the card, and each round launches
# `bp_ipa_challenge`; the sharded IPA takes one host transcript step a
# round and its MSMs end in the host Horner.
_FUSED_IPA = ("ec_add:horner", "ipa_challenge")
PATHS = {
    "msm": ("bucket_rounds_mixed", "bucket_rounds_proj", "ec_add:pre_reduce",
            "ec_add:gather_sum", "ec_add:window_totals", "ec_add:horner"),
    "ipa": ("bucket_rounds_mixed", "bucket_round_add", "ec_add:gather_sum",
            "ec_add:window_totals") + _FUSED_IPA,
    "ipa_fused": ("bucket_rounds_mixed", "ec_add:gather_sum",
                  "ec_add:window_totals") + _FUSED_IPA,
    "r1cs": ("bucket_rounds_mixed", "ec_add:pairwise", "ec_add:gather_sum",
             "ec_add:window_totals") + _FUSED_IPA,
    "smt": ("bucket_rounds_mixed", "bucket_rounds_proj", "ec_add:pre_reduce",
            "ec_add:gather_sum", "ec_add:window_totals") + _FUSED_IPA,
    "batch": ("bucket_rounds_mixed", "bucket_rounds_proj", "ec_add:pairwise",
              "ec_add:gather_sum", "ec_add:window_totals") + _FUSED_IPA,
    "gadgets": ("bucket_rounds_mixed", "bucket_rounds_proj",
                "ec_add:pre_reduce", "ec_add:gather_sum",
                "ec_add:window_totals") + _FUSED_IPA,
    "mxu_race": ("bucket_round_add_mxu", "bucket_round_add"),
    "sharded": ("bucket_rounds_mixed", "bucket_rounds_proj",
                "ec_add:pairwise", "ec_add:pre_reduce", "ec_add:gather_sum",
                "ec_add:window_totals"),
    # a != 0, the a != 0 builds (`:a!=0`): every bucket pass on kernel 2
    # (kernel 4 for the IPA's per-round kernel form), the IPA per round
    # (Edwards transcripts)
    "ed25519": tuple(f"{k}:a!=0" for k in (
        "bucket_rounds_proj", "bucket_round_add", "ec_add:pairwise",
        "ec_add:pre_reduce", "ec_add:gather_sum", "ec_add:window_totals",
        "ec_add:horner")),
    # BLS12-381's chain (its mont_mul form also on ed25519, whose product
    # runs the a = 0 build of its width) and ed25519's add chain
    "roofline": ("chain", "chain:a!=0"),
}
# kernels a path must never launch: kernel 1 and `bp_ipa_challenge` take
# no a != 0 / Edwards curve, and no a = 0 build runs an ed25519 add; the
# paths whose only pairwise adds were the pre-reduction's passes run none
# (the pre-reduction form took them)
NOT_ON_PATH = {"ed25519": ("bucket_rounds_mixed", "bucket_round_add_mxu",
                           "ipa_challenge", "bucket_rounds_proj",
                           "bucket_round_add", "ec_add", "chain"),
               **{path: ("ec_add:pairwise",)
                  for path in ("msm", "smt", "gadgets")}}
# each wrapper's kernel functions, as ptxas names them (`build.ptxas_summary`)
KERNEL_FUNCTIONS = {
    "bucket_rounds_proj": ("bucket_rounds_proj_kernel",),
    "bucket_round_add": ("bucket_round_add_kernel",),
    "ec_add": ("ec_add_kernel", "ec_gather_sum_kernel",
               "ec_window_totals_kernel", "ec_horner_kernel",
               "ec_pre_reduce_kernel"),
    "chain": ("ec_add_chain_kernel", "ec_dbl_chain_kernel",
              "warp_add_chain_kernel", "warp_dbl_chain_kernel",
              "mont_mul_chain_kernel"),
}
# kernel 3's forms in phase 2 -> the kernel form each launches
FORM_KERNEL = {"split_fold": "gather_sum", "dup_fold": "gather_sum",
               "rowcol": "gather_sum", "window_totals": "window_totals",
               "horner": "horner", "pre_reduce": "pre_reduce"}
N_BASE = 256
# The JAX package's config-2 proof digest (seed 2), made by
# tests/test_torch_r1cs.py::test_agg16_reference_digest
R1CS_REFERENCE = Path(__file__).resolve().parent / "tests" / "vectors" \
    / "torch_r1cs_agg16.json"
# The JAX package's depth-12 SMT-4 root and proof digest, made and checked
# by tests/test_torch_smt.py
SMT_REFERENCE = R1CS_REFERENCE.with_name("torch_smt4_d12.json")
# The JAX package's gadget proof digests at the reference tests' sizes,
# made and checked by tests/test_torch_gadgets.py
GADGET_REFERENCE = R1CS_REFERENCE.with_name("torch_gadgets.json")


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
    return ptxas


def _random_points(rnd, m, cv):
    return [G1.random(rnd, cv) for _ in range(m)]


def ipa_slots(n, ctx):
    """Bucket slots of the IPA's two-set MSM over 2n + 2 points."""
    c = msm_mod.pick_window(2 * n + 2)
    return msm_mod.window_plan(ctx, c, n_sets=2, dup=True)[0].shape[0] << c


def combine_shapes(n, n_sets, c=None, horner=False, dup=True, ctx=None):
    """The combine's shapes for an MSM of n points and n_sets scalar sets:
    c (by default pick_window(n)) and `window_plan(dup=dup)`'s physical
    rows W' and base windows W, with G, K of `bucket_rowcol`; horner:
    whether the path runs the window Horner on the card (`msm_device`;
    `msm_hybrid` runs it on the host); dup=False: the plan of the sharded
    MSMs, without duplicate rows; ctx: the curve's (by default the active
    curve's)."""
    ctx = ctx or CurveCtx(curve())
    c = c or msm_mod.pick_window(n)
    ranges, splits, *more = msm_mod.window_plan(ctx, c, n_sets=n_sets,
                                                dup=dup)
    dup_plan = more[0] if dup else ()
    g_bits = (c + 1) // 2
    return {"n": n, "sets": n_sets, "c": c, "W_rows": ranges.shape[0],
            "W": ranges.shape[0] - sum(g - 1 for _, g in dup_plan),
            "G": 1 << g_bits, "K": 1 << (c - g_bits), "ranges": ranges,
            "splits": splits, "dup": dup_plan, "dup_rows": dup,
            "horner": horner}


def phase_kernels(device, n, seed, reps=5, r1cs_msm_n=4098, cv=None):
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
    accumulators start at the identity.  cv: the curve (by default the
    active one); for a != 0 (ed25519) only kernels 2, 3 and 4, which are
    built for it (RCB16 algorithm 1, 18 products an add), and kernel 1's
    MSM shapes go to kernel 2, as `msm.uses_mixed` sends them.  Returns
    (per-kernel records, `check_msms`, which checks the kernels at the
    shapes of a path's MSMs once the path has run)."""
    t0 = time.time()
    device = torch.device(device)
    cv = cv or curve()
    ctx = CurveCtx(cv)
    a0 = ctx.a_is_zero
    per_add = mont_muls_per_add(ctx)
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

    S_ipa = ipa_slots(n, ctx)             # the IPA's two-set MSM
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
        occupied; an occupied slot's add takes 11 (mixed), 12 (a = 0) or
        18 (a != 0) products, an empty one `empty_muls` (a projective add
        of the identity is (X*Y : Y*Y : Z*Y), 3 products; the mixed kernel
        keeps the slot, 0)."""
        slots = found_k.numel()
        live = int(found_k.sum())
        full = 11 if row_words == 2 * nl else per_add
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

    def packed_add_plain(P32, Q32, ctx):
        """Kernel 3 pairwise's plain version on packed points (the form
        the butterfly and the pre-reduction call it in)."""
        return pack32(ek.ec_add_plain(unpack32(P32, 1), unpack32(Q32, 1),
                                      ctx), 1)

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
         (3 * pt_words * n_add * w32, n_add * per_add * imad),
         {"n": n_add}),
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
        ("r1cs", combine_shapes(r1cs_msm_n, 2, ctx=ctx)),
        ("msm", combine_shapes(n, 1, horner=True, ctx=ctx))])
    cases.append(pre_reduce_case(ctx, proj, gen, device, "msm",
                                 *bitvector_pre_reduce(ctx, n, gen)))
    cases += chain_cases(ctx, min(n, ROOFLINE_BATCH), device)
    if a0:
        cases.append(challenge_case(ctx, proj[:, :, :1], device))
    else:   # kernels 1 and 5 are built for a = 0, and Edwards curves run
        # no `bp_ipa_challenge`
        cases = [c for c in cases if c[0] not in (
            "bucket_rounds_mixed", "bucket_round_add_mxu")]

    records = {}
    # kernel 3's form shapes checked so far (`form_key`): a later path's
    # MSM of the same form shape is not checked again
    forms_seen = set()

    def check(name, kernel, plain, args, bare, work, shape):
        """One case's kernel bit-exact against its plain version, timed,
        into `records`.  work: (bytes, IMADs) of the function, or a
        function of the plain version's result that gives them."""
        got = kernel(*args, ctx)
        _sync(device)
        plain_ms, want = time_ms(lambda: plain(*args, ctx), device, 1)
        n_bytes, n_imad = work(want) if callable(work) else work
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} at {shape}: kernel differs from "
                                 f"its plain version (max abs word error "
                                 f"{err}, -1: shapes differ)")
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
        emit({"phase": "kernel", **rec, "shape": shape, "curve": cv.name})
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
        if "form" in case[-1]:
            forms_seen.add(form_key(case[-1]))
        check(*case)
    if device.type == "cuda" and a0:
        ch = records["ipa_challenge"]
        ch["split"] = challenge_split(
            ctx, next(c for c in cases if c[0] == "ipa_challenge")[3],
            ch["ms"])
        emit({"phase": "kernel_split", "name": "ipa_challenge",
              **ch["split"]})

    # kernel 5 computes kernel 4's function: the same words
    if a0 and not torch.equal(
            ek.bucket_round_add_mxu(buckets_round, table_ipa, ids4, found4,
                                    ctx),
            ek.bucket_round_add(buckets_round, table_ipa, ids4, found4,
                                ctx)):
        raise AssertionError("bucket_round_add_mxu differs from "
                             "bucket_round_add")
    if a0:
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
    emit({"phase": "kernels", "curve": cv.name, "S": S, "S_ipa": S_ipa,
          "R_c": R_c, "seconds": time.time() - t0})

    def check_msms(path, msms):
        """The bucket kernel and kernel 3's sequential forms at the shapes
        of the MSMs a path ran, each (points, sets, c, rounds, pre) as
        `msm_shapes` lists them, or (points, sets, c, rounds, pre, affine,
        horner) as `device_msm_shapes` does, or with an eighth entry dup
        (False for the sharded MSMs' per-shard passes): at S = W'*B slots
        of `window_plan(n_sets=sets, dup=dup)` and the rounds of one launch,
        kernel 2 from a pre-reduced table of W'*points rows where the MSM
        pre-reduced, or from a projective
        table of `points` rows where its table is not affine, else kernel 1
        from an affine table of `points` rows; the combine's forms at its
        shapes (Horner where the MSM ran it on the card) and, where it
        pre-reduced, the pre-reduction form over W' x points entries with
        its passes (`pre_reduce_digits`), each form shape once in the run
        (`form_key`); for a sharded pass also kernel 3 pairwise on packed
        points at the butterfly's W'*B, once.  Into `records` under
        `other_shapes` and `forms`."""
        t1 = time.time()
        for points, sets, c_k, rounds, pre, *more in msms:
            affine_msm, horner, dup = (*more,
                                       *(True, False, True)[len(more):])
            sh = combine_shapes(points, sets, c_k, horner=horner, dup=dup,
                                ctx=ctx)
            S_k = sh["W_rows"] << c_k
            R_k = msm_mod._chunk_rounds(rounds)
            rows = sh["W_rows"] * points if pre else points
            ids_k, found_k = slot_grid(R_k, S_k, rows)
            affine_k, proj_k = tables(rows)
            name, table_k, words, empty = (
                ("bucket_rounds_proj", proj_k, 3 * nl, 3)
                if pre or not affine_msm or not a0
                else ("bucket_rounds_mixed", affine_k, 2 * nl, 0))
            kernel = getattr(ek, name)
            check(name, kernel, getattr(ek, name + "_plain"),
                  (accumulators(S_k), table_k, ids_k, found_k),
                  bare_table(getattr(ek, name + "32")),
                  rounds_work(found_k, words, empty, ids_read=True),
                  {"path": path, "points": points, "sets": sets, "S": S_k,
                   "R_c": R_k, "pre": pre, "table_rows": rows,
                   "affine": affine_msm, "dup": dup})
            cases_k = form_cases(ctx, proj, gen, device, [(path, sh)])
            if pre:
                cases_k.append(pre_reduce_case(
                    ctx, proj, gen, device, path,
                    pre_reduce_digits(sh["W_rows"], points, gen), pre))
            for case in cases_k:
                if form_key(case[-1]) not in forms_seen:
                    forms_seen.add(form_key(case[-1]))
                    check(*case)
            if dup or ("pairwise", S_k) in forms_seen:
                continue
            forms_seen.add(("pairwise", S_k))
            P32, Q32 = (packed(proj[:, :, torch.randint(
                0, m, (S_k,), generator=gen).to(device)]) for _ in range(2))
            check("ec_add", ek.ec_add, packed_add_plain, (P32, Q32),
                  lambda args: lambda: ek.ec_add32(*args, ctx),
                  (3 * pt_words * S_k * w32, S_k * per_add * imad),
                  {"path": path, "n": S_k, "packed": True})
        emit({"phase": "kernels_at", "path": path, "curve": cv.name,
              "msms": msms, "seconds": time.time() - t1})

    return records, check_msms


def form_key(shape):
    """A kernel-3 form case's shape without its path (and the merges its
    random digits gave a pre-reduction case): two MSMs with equal keys run
    the form on operands of the same shapes and index tables (the window
    plan is fixed by the curve, c and the set count)."""
    return json.dumps({k: v for k, v in shape.items()
                       if k not in ("path", "merges")}, sort_keys=True)


def max_abs_err(got, want):
    """The largest absolute word difference between a kernel's result and
    its plain version's (tensors or tuples of them), -1 where a shape
    differs."""
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        return -1
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


# 32-bit integer operations of one keccak-f1600: 24 rounds of 130
# two-input 64-bit operations (theta 55, rho 24 rotations, chi 50, iota 1),
# two 32-bit ones each.
KECCAK_F_OPS = 24 * 130 * 2


def safegcd_work(x, m):
    """(batches, inner steps) of the variable-time safegcd that
    `bp_ipa_challenge` inverts x mod m with (`inverse_var`): its batches of
    30 divsteps, run here on Python ints (a batch's matrix applied to f
    and g takes them where the same steps on the full values do), until
    g = 0; an inner step is one cancelling multiple of f after the zero
    bits are shifted out."""
    eta, f, g, batches, inner = -1, m, x, 0, 0
    while True:
        batches += 1
        i = 30
        while True:
            zeros = min((g & -g).bit_length() - 1, i) if g else i
            g >>= zeros
            eta -= zeros
            i -= zeros
            if i == 0:
                break
            inner += 1
            if eta < 0:
                eta, f, g = -eta, g, -f
            bits = 1 << min(eta + 1, i)
            g += f * (-g * pow(f, -1, bits) % bits)
        if g == 0:
            return batches, inner


def round_permutations(pos, mb):
    """keccak-f1600s of one IPA round's transcript from STROBE position
    pos: its stream of 27 framing bytes and both points' 2 mb + 1 bytes
    crosses the rate of 166 bytes, and the challenge forces one more
    unless the stream ends on a crossing."""
    return -(-(pos + 27 + 2 * (2 * mb + 1)) // 166)


def challenge_work(ctx, pts32, regs, u_mont):
    """(bytes, 32-bit integer operations) of the function
    `bp_ipa_challenge` computes on these operands (pts32 the packed L and
    R, regs the round's starting STROBE registers, u_mont the challenge's
    Montgomery limbs its plain version returns), not of the kernel's own
    chains.  Bytes: its operands read and its results written once.
    Operations: the round's keccak-f1600s (`round_permutations` of
    `KECCAK_F_OPS` each); the
    Montgomery products (`imad_per_mont_mul` IMADs each): in Fp, per
    point that is not the identity its Z's inverse from the shared one
    (where both are points, after one product of the two Zs), X and Y into
    affine form and out of Montgomery form, and the shared inverse's return
    to Montgomery form; in Fr, the challenge's two reduction products and
    its inverse's return; the two inversions as the safegcd's work on
    these values (`safegcd_work`): a batch of 30 divsteps applies its
    matrix to f, g, d and e, 10 N wide limb products (two IMADs each) on
    N 30-bit limbs, and an inner step is ~11 IMADs (f's inverse mod 2^32
    by Newton, the multiple, three updates)."""
    nlp, nlr = ctx.fp.L // 2, ctx.fr.L // 2
    mb = ctx.cv.modbytes
    pb = 2 * mb + 1
    n_bytes = 3 * nlp * 2 * 4 + 200 * 8 + (2 * pb + 200 + 2 * ctx.fr.L) * 8
    perms = round_permutations(regs[0], mb)
    p, r = ctx.cv.p, ctx.cv.r

    def inverse_ops(x, m, nl):
        batches, inner = safegcd_work(x, m)
        return batches * 10 * ((32 * nl + 29) // 30) * 2 + inner * 11

    zs = [z for z in limbs_to_ints(unpack32(pts32, 1)[2]) if z]
    fp_muls, fp_inv = 5 * len(zs), 0
    if zs:
        z = zs[0]
        if len(zs) == 2:          # Montgomery's trick: Z_L Z_R R^-1
            z = zs[0] * zs[1] * pow(2, -32 * nlp, p) % p
            fp_muls += 1
        fp_muls += 1
        fp_inv = inverse_ops(z, p, nlp)
    u = limbs_to_ints(u_mont)[0]
    fr_ops = 3 * 2 * (2 * nlr * nlr + nlr) + inverse_ops(u, r, nlr)
    return n_bytes, (perms * KECCAK_F_OPS + fp_muls * imad_per_mont_mul(ctx)
                     + fp_inv + fr_ops)


def challenge_bare(ctx, device):
    """A bare-launch factory of `bp_ipa_challenge` into fresh outputs."""
    def make(args):
        outs = (torch.empty((2, 2 * ctx.cv.modbytes + 1), dtype=torch.int64,
                            device=device),
                torch.empty(200, dtype=torch.int64, device=device),
                torch.empty((2, ctx.fr.L, 1), dtype=torch.int64,
                            device=device))
        return lambda: tk.ipa_challenge32(*outs, *args, ctx)
    return make


def challenge_split(ctx, args, ms, reps=5):
    """`bp_ipa_challenge`'s time by span (`tk.SPLIT`): the mean of lane
    0's clock64() cycles in each span over reps launches of its timed form
    on args (points, state, registers), each span's share of the stamped
    cycles, and that share of the bare kernel's ms in microseconds."""
    outs = (torch.empty((2, 2 * ctx.cv.modbytes + 1), dtype=torch.int64,
                        device="cuda"),
            torch.empty(200, dtype=torch.int64, device="cuda"),
            torch.empty((2, ctx.fr.L, 1), dtype=torch.int64, device="cuda"))
    spans = {k: 0 for k in tk.SPLIT}
    for _ in range(reps):
        got = tk.ipa_challenge_split(*outs, *args, ctx)
        for k, v in got.items():
            spans[k] += v / reps
    total = sum(spans.values())
    return {"cycles": spans, "stamped_cycles": total,
            "share": {k: v / total for k, v in spans.items()},
            "us": {k: ms * 1e3 * v / total for k, v in spans.items()}}


def challenge_case(ctx, L, device):
    """Phase 2's case of `bp_ipa_challenge`: the points L (a projective
    point, Z != 1) and R the identity, from a transcript whose round
    crosses the STROBE rate inside L's bytes, so keccak-f runs mid-message
    (the starting position is between 60 and 120)."""
    pts32 = pack32(torch.cat([L, ctx.identity_like((1,), device)], dim=2),
                   1).contiguous()
    tr = bt.ProofTranscript(b"chip_smoke")
    while not 60 <= tr.strobe.pos <= 120:
        tr.append_message(b"pad", bytes(7))
    snap, *regs = DeviceTranscript.snapshot(tr)
    return ("ipa_challenge", tk.ipa_challenge, tk.ipa_challenge_plain,
            (pts32, torch.as_tensor(snap, device=device), tuple(regs)),
            challenge_bare(ctx, device),
            lambda want: challenge_work(ctx, pts32, regs, want[2][0]),
            {"points": 2, "R": "identity", "start_pos": regs[0],
             "crosses_rate": True})


def form_cases(ctx, proj, gen, device, paths):
    """Phase 2's cases of kernel 3's sequential forms, at each path's
    combine shapes (`combine_shapes`): the split fold and the duplicate-row
    fold over W' rows of B buckets, the row and column sums, the window
    totals, and where the path runs it on the card (the n-point MSM's
    `msm_device`) the window Horner.  The buckets are projective points,
    1 in 16 the identity.  The bound counts the products the kernels run:
    the window totals' and the Horner's doublings are dedicated ones
    (`mont_muls_per_dbl`), and the Horner skips those of its opening
    identity."""
    imad = imad_per_mont_mul(ctx)
    nl = ctx.fp.L // 2
    pt_bytes = 3 * nl * 4
    add = mont_muls_per_add(ctx) * imad
    dbl_ops = mont_muls_per_dbl(ctx) * imad     # the lone chains' doubling
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
        if sh["dup_rows"]:     # the sharded plans have no duplicate rows
            dup_idx = index(("dup", W, B, sh["dup"]),
                            lambda: msm_mod._dup_fold_index(W, B, sh["dup"]))
            cases.append(gather_case(path, "dup_fold", sh, raw, dup_idx,
                                     False))
        base = points(W * B)
        rowcol_idx = index(("rowcol", W, G, K),
                           lambda: msm_mod._rowcol_index(W, G, K))
        cases.append(gather_case(path, "rowcol", sh, base, rowcol_idx,
                                 True))
        rowsum = points(W * G).reshape(3, nl, W, G)
        colsum = points(W * K).reshape(3, nl, W, K)
        dbl = sh["c"] - (sh["c"] + 1) // 2
        adds = W * (2 * (G - 1) + 2 * (K - 1) + 1)

        def bare_totals(args, W=W):
            out = torch.empty((3, nl, W), dtype=torch.int32, device=device)
            return lambda: ek.ec_window_totals32(out, *args, ctx)
        cases.append(("ec_add", ek.ec_window_totals,
                      ek.ec_window_totals_plain, (rowsum, colsum, dbl),
                      bare_totals,
                      ((W * (G + K) + W) * pt_bytes,
                       adds * add + W * dbl * dbl_ops),
                      {"form": "window_totals", "path": path, "W": W,
                       "G": G, "K": K, "dbl": dbl}))
        if sh["horner"]:
            totals = points(W)
            c, sets = sh["c"], sh["sets"]

            def bare_horner(args, sets=sets):
                out = torch.empty((3, nl, sets), dtype=torch.int32,
                                  device=device)
                return lambda: ek.ec_horner32(out, *args, ctx)
            cases.append(("ec_add", ek.ec_horner, ek.ec_horner_plain,
                          (totals, W // sets, c), bare_horner,
                          ((W + sets) * pt_bytes,
                           W * add + (W - sets) * c * dbl_ops),
                          {"form": "horner", "path": path, "sets": sets,
                           "wps": W // sets, "c": c}))
    return cases


def pre_reduce_digits(W, n, gen):
    """Digits (W, n) for a pre-reduction case: windows in turn all zeros,
    mostly one digit (a run of ~0.8 n that every pass merges in) and
    uniform in {0, .., 3} (short runs across 2^p boundaries)."""
    d = torch.randint(0, 4, (W, n), generator=gen)
    d[::3] = 0
    d[1::3] = torch.where(torch.rand((len(range(1, W, 3)), n),
                                     generator=gen) < 0.8, 1, 0)
    return d


def pre_reduce_case(ctx, proj, gen, device, path, digits, passes):
    """The case of kernel 3's pre-reduction form over W x n entries of
    `digits` (W, n), `passes` passes, rows from n projective points: the
    bound counts the gather (n rows read, W*n written, perm, digits and
    ranks read once) and the adds of the merging entries only, which this
    run's digits give (`ek._merging`)."""
    imad = imad_per_mont_mul(ctx)
    nl = ctx.fp.L // 2
    W, n = digits.shape
    m = proj.shape[2]
    sorted_d, rank, perm = (x.to(device)
                            for x in msm_mod._sorted_ranks(digits))
    pick = torch.randint(0, m, (n,), generator=gen).to(device)
    rows32 = ek.proj_rows32(proj[:, :, pick])
    merges = [int(ek._merging(sorted_d, rank, p).sum())
              for p in range(passes)]
    work = ((n + W * n) * 3 * nl * 4 + W * n * 3 * 8,
            sum(merges) * mont_muls_per_add(ctx) * imad)

    def bare(args):
        rows, perm_, sd, rk, k = args
        table = torch.empty((W * n, 3 * nl), dtype=torch.int32,
                            device=device)

        def run():
            for p in range(k):
                ek.ec_pre_reduce32(table, rows, perm_, sd, rk, p, ctx)
        return run
    return ("ec_add", ek.ec_pre_reduce, ek.ec_pre_reduce_plain,
            (rows32, perm, sorted_d, rank, passes), bare, work,
            {"form": "pre_reduce", "path": path, "W": W, "n": n,
             "passes": passes, "merges": merges})


def bitvector_pre_reduce(ctx, n, gen):
    """The bit-vector MSM's pre-reduction at n: its digits (bits in
    window 0, spread over the duplicate rows of `window_plan(dup=True)` at
    c = pick_window(n)) and the passes `msm._escalate` gives them."""
    c = msm_mod.pick_window(n)
    ranges, splits, dup = msm_mod.window_plan(ctx, c, dup=True)
    W = msm_mod._n_windows(ctx, c)
    digits = torch.zeros((W, n), dtype=torch.int64)
    digits[0] = torch.randint(0, 2, (n,), generator=gen)
    digits = msm_mod._spread_dup_rows(digits, dup)
    rounds = msm_mod.occupancy_guess(n, ctx, c)
    _, _, occ = msm_mod._slot_grid(digits, 1 << c, rounds, ranges, splits)
    return digits, msm_mod._escalate(occ, rounds, 0)[1]


@functools.cache
def _bench_input(n, seed, bits, cv):
    """The bench's MSM input on curve cv: m = n_base(n) random points
    repeated to n, scalars uniform mod r (or uniform bits), and the
    independent host value sum_j base_j * (sum_{i = j mod m} s_i mod r)."""
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
    ctx = CurveCtx(curve())
    pts, vals, expected = _bench_input(n, seed, bits, ctx.cv)
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
    emit({"phase": name, "curve": ctx.cv.name, "n": n, "c": c,
          "rounds": rounds,
          "pre_reduce": pre, "first_seconds": first,
          "msm_seconds_p50": p50, "points_per_s": n / p50,
          "msm_device_first_seconds": dev_first,
          "msm_device_seconds_p50": dev_p50,
          "setup_seconds": setup, "result": expected.to_bytes().hex()[:32],
          "seconds": time.time() - t0})


@functools.cache
def _ipa_bases(n, seed, cv):
    """The bench's config-3 bases and vectors (`bench.py` config3) on
    curve cv: m = n_base(n) hash-derived G and H bases (repeated to n by
    the callers), Q, and uniform a and b."""
    m = n_base(n)
    Gb = [G1.from_msg_hash(b"G%d" % i, cv) for i in range(m)]
    Hb = [G1.from_msg_hash(b"H%d" % i, cv) for i in range(m)]
    Q = G1.from_msg_hash(b"Q", cv)
    rnd = random.Random(seed)
    a = [Scalar.random(rnd, cv) for _ in range(n)]
    b = [Scalar.random(rnd, cv) for _ in range(n)]
    return Gb, Hb, Q, a, b


@functools.cache
def _ipa_input(n, seed, cv):
    """`_ipa_bases` with unit factors and P = <a, G> + <b, H> + <a, b> Q
    from one host MSM over the 2m + 1 distinct points."""
    Gb, Hb, Q, a, b = _ipa_bases(n, seed, cv)
    m = len(Gb)
    P = msm_host(Gb + Hb + [Q], _collapse(a, m, cv) + _collapse(b, m, cv)
                 + [inner_product(a, b).v])
    return Gb, Hb, Q, a, b, P


def _collapse(vals, m, cv):
    """sum_{i = j mod m} vals_i mod r for j < m: the scalar of base j."""
    r = cv.r
    out = [0] * m
    for i, v in enumerate(vals):
        out[i % m] += v.v if hasattr(v, "v") else v
    return [x % r for x in out]


def _host_check(proof, n, Gb, Hb, Q, P, label):
    """The verification equation of `ipp.verify_ipp` in Python ints,
    independent of the device verifier: replay the transcript, build s,
    and collapse the G and H terms onto their m bases, so the check is one
    host MSM over 2m + 2 lg n + 1 points."""
    cv = Q.cv
    r = cv.r
    u_sq, u_inv_sq, s = verification_scalars(proof.L, proof.R, n,
                                             bt.ProofTranscript(label))
    a, b = proof.a.v, proof.b.v
    g = _collapse([a * si.v for si in s], len(Gb), cv)
    h = _collapse([b * si.v for si in reversed(s)], len(Hb), cv)
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
    cv = curve()
    Gb, Hb, Q, a, b, P = _ipa_input(n, seed, cv)
    m = len(Gb)
    G = [Gb[i % m] for i in range(n)]
    H = [Hb[i % m] for i in range(n)]
    ones = [Scalar.one(cv)] * n
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
    content_digest(G, CurveCtx(cv))
    content_digest(H, CurveCtx(cv))
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
                      proof.a + Scalar.one(cv), proof.b, proof.L,
                      proof.R, device=device)
    except VerificationError:
        pass
    else:
        raise AssertionError("ipa: a tampered proof (a + 1) verified")

    round_proof, round_s = prove("round")
    if _proof_bytes(round_proof) != want:
        raise AssertionError("ipa: the per-round kernel's proof differs")
    p50 = lambda ts, first: sorted(ts)[len(ts) // 2] if ts else first
    emit({"phase": "ipa", "curve": cv.name, "n": n, "bases": m,
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
    return {**per_call, "proof": want}


def phase_ipa_fused(device, n, seed, reps, records, r1cs=None):
    """The fused IPA (every round on the device, one launch of
    `bp_ipa_challenge` a round, one fetch) against the per-round one
    (`fused=False`: `msm_hybrid` and the host transcript each round) at n,
    phase 5's input: 1 + reps proofs of each in turns (fused, per-round,
    per-round, fused, ...), every proof byte-identical; the stages of one
    more of each; r1cs = (m, bits, ref): the same turns of phase 6's
    statement of seed ref["seed"], `Prover.prove(fused=...)`, each proof's
    sha256 ref["sha256"]; on the card one traced proof of each (device busy and
    idle share) and one warm fused IPA under
    `torch.cuda.set_sync_debug_mode("error")` from its first launch to its
    fetch (`prover_device._ipa_fused_rounds`), its bytes the proof's.
    Returns the launches of one proof of each and `check`, which holds
    `bp_ipa_challenge` against its plain version at the first two rounds'
    real L and R (into `records["ipa_challenge"]["at_path"]`); main runs
    it after the paths, outside their counts."""
    t0 = time.time()
    label = b"ipa_smoke"
    Gb, Hb, Q, a, b, _ = _ipa_input(n, seed, BLS381)
    m = len(Gb)
    G = [Gb[i % m] for i in range(n)]
    H = [Hb[i % m] for i in range(n)]
    ones = [Scalar.one(BLS381)] * n
    device = torch.device(device)
    on_card = device.type == "cuda"
    per_call = {}

    def prove(fused, profile=False):
        """-> (proof bytes, seconds, the proof)."""
        prover_device._prof.enabled = profile
        before = launch_counts()
        t1 = time.time()
        try:
            proof = bt.create_ipp(bt.ProofTranscript(label), Q, ones, ones,
                                  G, H, a, b, device=device, fused=fused)
        finally:
            prover_device._prof.enabled = False
        dt = time.time() - t1
        per_call["fused" if fused else "per_round"] = {
            k: v - before[k] for k, v in launch_counts().items()}
        return _proof_bytes(proof), dt, proof

    want, first_fused, proof = prove(True)
    got, first_round, _ = prove(False)
    if got != want:
        raise AssertionError("ipa_fused: the per-round proof differs")
    times = {True: [], False: []}
    for fused in ([True, False, False, True] * reps)[:2 * reps]:
        got, dt, _ = prove(fused)
        if got != want:
            raise AssertionError("ipa_fused: proofs of one input differ")
        times[fused].append(dt)
    stages = {}
    for fused in (True, False):
        prover_device._prof.take()
        _, dt, _ = prove(fused, profile=True)
        st = prover_device._prof.take()
        st["other"] = dt - sum(st.values())
        stages["fused" if fused else "per_round"] = st
    t1 = time.time()
    for pt in proof.L + proof.R:
        G1.from_bytes(pt.to_bytes(), BLS381)
    decode = time.time() - t1
    p50 = lambda ts, first: sorted(ts)[len(ts) // 2] if ts else first
    r1cs_out = {}
    if r1cs is not None:
        m_r, bits, ref = r1cs
        Gr = bt.get_generators("G", m_r * 2 * bits)
        Hr = bt.get_generators("H", m_r * 2 * bits)
        g, h = G1.from_msg_hash(b"g", BLS381), G1.from_msg_hash(b"h", BLS381)
        r_times = {True: [], False: []}
        for fused in [True, False] + ([True, False, False, True] * reps)[
                :2 * reps]:
            prover, _ = _agg_range_prover(ref["seed"], m_r, bits, g, h,
                                          device)
            t1 = time.time()
            digest = hashlib.sha256(prover.prove(Gr, Hr, fused=fused)
                                    .to_bytes()).hexdigest()
            r_times[fused].append(time.time() - t1)
            if digest != ref["sha256"]:
                raise AssertionError(f"ipa_fused: the r1cs proof (fused = "
                                     f"{fused}) has sha256 {digest}, the "
                                     f"JAX package's {ref['sha256']}")
        for fused, key in ((True, "fused"), (False, "round")):
            ts = r_times[fused]
            r1cs_out[f"r1cs_{key}_prove_first_seconds"] = ts[0]
            r1cs_out[f"r1cs_{key}_prove_seconds_p50"] = p50(ts[1:], ts[0])
        r1cs_out["r1cs_prove_seconds_turns"] = {
            "fused": r_times[True], "per_round": r_times[False]}
        r1cs_out["r1cs_matches_reference"] = True
    out = {"phase": "ipa_fused", "n": n, "bases": m,
           "ipa_fused_prove_first_seconds": first_fused,
           "ipa_fused_prove_seconds_p50": p50(times[True], first_fused),
           "ipa_round_prove_first_seconds": first_round,
           "ipa_round_prove_seconds_p50": p50(times[False], first_round),
           "prove_seconds_turns": {"fused": times[True],
                                   "per_round": times[False]},
           "stage_seconds": stages, "lr_decode_seconds": decode,
           "launches_per_call": per_call, "proofs_identical": True,
           **r1cs_out}

    ctx = CurveCtx(BLS381)
    fr = ctx.fr
    c = msm_mod.pick_window(2 * n + 2)
    rounds, pre = prover_device._fused_memo[(n, c, ctx.cv.name)]
    tr = bt.ProofTranscript(label)
    tr.innerproduct_domain_sep(n)
    snap, *regs0 = DeviceTranscript.snapshot(tr)
    regs = (tuple(regs0), tk.round_registers(regs0, ctx))
    pts, affine, table32 = prover_device._ipa_table(G, H, Q, ctx, device)
    mont = lambda v: prover_device._mont(fr, v, device)
    A, B, ones_m = mont(a), mont(b), mont(ones)
    state = torch.as_tensor(snap, device=device)
    if on_card:
        for fused in (True, False):
            _, out["trace_" + ("fused" if fused else "per_round")] = trace(
                lambda: prove(fused), watch=("ipa_challenge",))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = prover_device._ipa_fused_rounds(
                state, pts, A, B, ones_m, ones_m, ctx, c, rounds, pre, regs,
                affine, "chunk", table32)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        lr = bytes(res.cpu()[:len(proof.L) * 2 * (2 * ctx.cv.modbytes + 1)]
                   .to(torch.uint8).tolist())
        if lr != b"".join(L + R for L, R in zip(want[0], want[1])):
            raise AssertionError("ipa_fused: the run under the sync check "
                                 "gave other bytes")
        out["host_syncs_between_launch_and_fetch"] = 0
    emit({**out, "rounds": rounds, "pre": pre, "seconds": time.time() - t0})

    def check():
        """`bp_ipa_challenge` against its plain version on the first two
        rounds' real operands: round 1's combined L and R at the snapshot's
        registers, and again at the later rounds' registers on the state
        round 1 leaves."""
        t1 = time.time()
        scal2 = prover_device._ipa_round_scalars(A, B, ones_m, ones_m, n, fr)
        LR, _ = msm_mod.msm_sets_device(pts, scal2, ctx, c, rounds, pre,
                                        affine, "chunk", table32)
        rows, outs, st = [], [], state
        for r in regs:
            outs.append(tk.ipa_challenge(LR, st, r, ctx))
            plain_ms, plain = time_ms(
                lambda: tk.ipa_challenge_plain(LR, st, r, ctx), device, 1)
            err = max_abs_err(outs[-1], plain)
            if err:
                raise AssertionError(f"ipa_challenge at regs {r}: kernel "
                                     f"differs from its plain version "
                                     f"({err})")
            row = {"regs": list(r), "max_abs_err": err, "ms": None,
                   "wrapper_ms": None, "plain_ms": plain_ms,
                   "bound_ms": bound(*challenge_work(ctx, LR, r,
                                                     plain[2][0]))[0]}
            if on_card:   # the bare kernel, the wrapper: 3 runs of 50 each
                bare = challenge_bare(ctx, device)((LR, st, r))
                row["ms_runs"] = [time_ms(bare, device, 50)[0]
                                  for _ in range(3)]
                row["wrapper_ms_runs"] = [time_ms(
                    lambda: tk.ipa_challenge(LR, st, r, ctx), device, 50)[0]
                    for _ in range(3)]
                row["ms"] = sorted(row["ms_runs"])[1]
                row["wrapper_ms"] = sorted(row["wrapper_ms_runs"])[1]
                row["split"] = challenge_split(ctx, (LR, st, r), row["ms"])
            rows.append(row)
            st = outs[-1][1]
        if [bytes(x.tolist()) for x in outs[0][0]] != [want[0][0],
                                                       want[1][0]]:
            raise AssertionError("ipa_challenge: round 1's bytes are not the "
                                 "proof's L and R")
        records["ipa_challenge"]["at_path"] = rows
        emit({"phase": "kernel_at_path", "name": "ipa_challenge", "n": n,
              "rounds": rows, "seconds": time.time() - t1})

    return {"launches": per_call, "check": check}


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
    cv = curve()
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
    emit({"phase": "r1cs", "curve": cv.name, "m": m, "bits": bits, "n": n,
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


def trace(run, watch=()):
    """Run run() once under torch.profiler on the card: -> (its result,
    {traced wall ms, device busy ms (kernels, copies and sets), idle share,
    kernels, copies and sets, the device ms of the 6 kernels (by name, cut
    to 80 characters) that took the most, and for each name in watch the
    device ms of the kernels whose names hold it}).  It records the CUDA
    activity alone: the numbers read only the device's events, and
    recording the host's too doubled a trace's cost."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, kernels, copies, by_name = 0.0, 0, 0, {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            busy_us += us
            by_name[ev.name] = by_name.get(ev.name, 0.0) + us
            if ev.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return out, {"traced_wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
                 "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
                 "device_kernels": kernels, "device_copies_and_sets": copies,
                 "device_ms_by_kernel": {k[:80]: v / 1e3 for k, v in top},
                 "device_ms_of": {w: sum(v for k, v in by_name.items()
                                         if w in k) / 1e3 for w in watch}}


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
    # the MSM memos start empty for the proofs, so that they list every
    # MSM shape the proofs run (`msm_shapes`); earlier entries come back
    # after
    earlier = clear_msm_memos()

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
    restore_msm_memos(earlier)
    out["msm_escalation"] = {
        f"points={m[0]},sets={m[1]},c={m[2]}": {"rounds": m[3], "pre": m[4]}
        for m in msms}
    emit({**out, "n_bulk": n_bulk, "updates": upd["batch"], "n": pr["n"],
          "proof_sha256": digest, "matches_reference": True,
          "root_matches_reference": True, "tampered_rejected": True,
          "launches_per_call": per_call, "seconds": time.time() - t0})
    return {"launches": per_call, "msms": msms, "proof": proof,
            "commitments": comms, "root": ptree.root}


def phase_batch(device, m, bits, k, ipa_n, ipa_k, seed, reps):
    """The bench's `batch_verify_sec` (`bench.py:405-445`) through the
    port's entry points: k proofs of the aggregated range statement (m
    values of `bits` bits, n = 2 m bits generators, seeds 70, 71, ...,
    `_agg_range_prover`); one template `Verifier` synthesized from proof
    0's commitments, each item `tmpl.rebind(ProofTranscript(b"AggRange"),
    commitments)`, `batch_verify(..., rng=random.Random(1))` 1 + reps
    times (the first a warm-up); each proof through `verify_device` alone;
    proof `bad` = min(5, k - 1) with t_x + 1 named by
    `BatchVerificationError` and, with localize=False, a plain
    `VerificationError`.  Then `batch_verify_ipp` over ipa_k standalone
    IPA proofs at ipa_n (phase 5's bases, unit factors): accepted, and one
    with a + 1 named by its index.  Returns the launches of one batch
    check (all accepted, the first timed call) and the shapes of every
    MSM the phase's batch checks ran (`device_msm_shapes`), the
    bisections' included."""
    t0 = time.time()
    cv = BLS381
    n = m * 2 * bits
    G = bt.get_generators("G", n)
    H = bt.get_generators("H", n)
    g, h = G1.from_msg_hash(b"g", cv), G1.from_msg_hash(b"h", cv)
    out = {"phase": "batch", "proofs": k, "m": m, "bits": bits, "n": n}
    # the device MSM memo starts empty, so that it lists every shape the
    # batch checks run (`device_msm_shapes`); earlier entries come back
    # after
    device_memo = msm_mod._device_memo
    earlier = dict(device_memo)
    device_memo.clear()

    t1 = time.time()
    batch = []
    for i in range(k):
        prover, comms = _agg_range_prover(70 + i, m, bits, g, h, device)
        batch.append((prover.prove(G, H), [c for grp in comms for c in grp]))
    out["prove_seconds"] = time.time() - t1
    tmpl = bt.Verifier(bt.ProofTranscript(b"AggRange"), device=device)
    flat0 = batch[0][1]
    for j in range(0, len(flat0), 3):
        bound_check.verify_bounded_num(0, (1 << bits) - 1, bits,
                                       flat0[j:j + 3], tmpl)

    def items(proofs):
        return [(tmpl.rebind(bt.ProofTranscript(b"AggRange"), flat), pr)
                for pr, (_, flat) in zip(proofs, batch)]

    def batch_once(proofs, **kw):
        t1 = time.time()
        bt.batch_verify(items(proofs), g, h, G, H, rng=random.Random(1),
                        device=device, **kw)
        return time.time() - t1

    proofs = [pr for pr, _ in batch]
    out["batch_first_seconds"] = batch_once(proofs)
    times = []
    for rep in range(reps):
        before = launch_counts()
        times.append(batch_once(proofs))
        if rep == 0:
            per_check = {key: v - before[key]
                         for key, v in launch_counts().items()}
    if not reps:
        per_check = {}
    warm = sorted(times) or [out["batch_first_seconds"]]
    p50 = warm[len(warm) // 2]
    out["batch8_m16_verify_seconds_p50"] = p50
    out["batch_verify_proofs_per_s"] = k / p50

    t1 = time.time()
    for v, pr in items(proofs):
        v.verify(pr, g, h, G, H)
    out["verify_each_seconds"] = time.time() - t1

    bad = min(5, k - 1)
    tampered = list(proofs)
    tampered[bad] = bt.R1CSProof.from_bytes(proofs[bad].to_bytes())
    tampered[bad].t_x = tampered[bad].t_x + Scalar.one(cv)
    t1 = time.time()
    try:
        batch_once(tampered)
    except BatchVerificationError as e:
        if e.failed_indices != [bad]:
            raise AssertionError(f"batch: the tampered batch names "
                                 f"{e.failed_indices}, not [{bad}]")
    else:
        raise AssertionError("batch: a batch with a tampered proof verified")
    out["bisect_seconds"] = time.time() - t1
    try:
        batch_once(tampered, localize=False)
    except VerificationError as e:
        if isinstance(e, BatchVerificationError):
            raise AssertionError("batch: localize=False localized")
    else:
        raise AssertionError("batch: a batch with a tampered proof verified")

    # batch_verify_ipp over ipa_k proofs at ipa_n
    t1 = time.time()
    label = b"ipa_batch"
    ones = [Scalar.one(cv)] * ipa_n
    ipa_items, G_ipa, H_ipa = [], None, None
    for i in range(ipa_k):
        Gb, Hb, Q, a, b, P = _ipa_input(ipa_n, seed + i, BLS381)
        if G_ipa is None:
            mb = len(Gb)
            G_ipa = [Gb[j % mb] for j in range(ipa_n)]
            H_ipa = [Hb[j % mb] for j in range(ipa_n)]
        pf = bt.create_ipp(bt.ProofTranscript(label), Q, ones, ones, G_ipa,
                           H_ipa, a, b, device=device)
        ipa_items.append((P, Q, pf))
    out["ipa_prove_seconds"] = time.time() - t1

    def ipa_batch(bad_at=None):
        its = []
        for i, (P, Q, pf) in enumerate(ipa_items):
            a = pf.a + Scalar.one(cv) if i == bad_at else pf.a
            its.append((bt.ProofTranscript(label), ones, ones, P, Q, a,
                        pf.b, pf.L, pf.R))
        t1 = time.time()
        bt.batch_verify_ipp(ipa_n, G_ipa, H_ipa, its, rng=random.Random(2),
                            device=device)
        return time.time() - t1

    out["ipa_batch_first_seconds"] = ipa_batch()
    out["ipa_batch_seconds"] = ipa_batch()
    ipa_bad = min(2, ipa_k - 1)
    try:
        ipa_batch(ipa_bad)
    except BatchVerificationError as e:
        if e.failed_indices != [ipa_bad]:
            raise AssertionError(f"batch: the tampered IPA batch names "
                                 f"{e.failed_indices}, not [{ipa_bad}]")
    else:
        raise AssertionError("batch: a tampered IPA batch verified")
    msms = device_msm_shapes()
    for key, v in earlier.items():
        device_memo.setdefault(key, v)
    emit({**out, "tampered_index": bad, "tampered_named": True,
          "unlocalized_rejected": True, "ipa_n": ipa_n, "ipa_proofs": ipa_k,
          "ipa_tampered_index": ipa_bad, "launches_per_check": per_check,
          "msm_shapes": [m[:6] for m in msms],
          "seconds": time.time() - t0})
    return {"launches": per_check, "msms": msms}


# The gadgets of phase 10: transcript label and the reference test each
# statement's size comes from (`tests/vectors/torch_gadgets.json`).
GADGET_LABELS = {"non_zero": b"NonZero", "set_membership": b"SetMemb",
                 "set_membership_alt": b"SetMembAlt",
                 "set_non_membership": b"SetNonMemb", "mimc": b"MiMC",
                 "hamming_distance": b"Hamming", "randomizer": b"Randomizer"}


def gadget_case(pkg, name, spec, **kw):
    """One gadget's statement from `spec` (sizes and rng seed, the shape of
    tests/vectors/torch_gadgets.json), built from the modules of the
    imported package `pkg`, read as attributes and never imported here:
    this port, or in the tests the JAX package, which has the same module
    names.  kw goes to the port's entry points (`device`).  -> (prove, verify):
    prove(g, h, G, H) -> (proof, commitments), with the statement's rng
    state each time; verify(proof, commitments, g, h, G, H,
    tampered=False) raises unless the proof holds for the statement, or
    with tampered for a changed one (a set member replaced or added, the
    image or count + 1, the first commitment + g)."""
    mod = lambda m: functools.reduce(getattr, m.split("."), pkg.models)
    S = pkg.Scalar
    label = GADGET_LABELS[name]
    rng = random.Random(spec["seed"])
    plus = lambda comms, g: [comms[0] + g] + list(comms[1:])
    if name == "non_zero":
        m = mod("non_zero")
        value = S.random(rng)
        prove = lambda r, g, h, G, H: m.gen_proof_of_non_zero_val(
            value, None, r, label, g, h, G, H, **kw)
        verify = lambda pf, comms, g, h, G, H, t: \
            m.verify_proof_of_non_zero_val(pf, plus(comms, g) if t else comms,
                                           label, g, h, G, H, **kw)
    elif name in ("set_membership", "set_membership_alt",
                  "set_non_membership"):
        m = mod(name)
        v = spec["value"]
        sets = (spec["set"],
                [x + 1000 if x == v else x for x in spec["set"]]
                if name != "set_non_membership" else [v] + spec["set"][1:])
        if name != "set_membership_alt":
            v = S(v)
            sets = tuple([S(x) for x in s] for s in sets)
        gen = getattr(m, f"gen_proof_of_{name}")
        check = getattr(m, f"verify_proof_of_{name}")
        prove = lambda r, g, h, G, H: gen(v, None, sets[0], r, label, g, h,
                                          G, H, **kw)
        verify = lambda pf, comms, g, h, G, H, t: check(
            sets[t], pf, comms, label, g, h, G, H, **kw)
    elif name == "mimc":
        m = mod("mimc")
        rounds = spec["rounds"]
        consts = [S.random(rng) for _ in range(rounds)]
        xl, xr = S.random(rng), S.random(rng)
        image = mod("helper_constraints.mimc").mimc(xl, xr, consts, rounds)
        prove = lambda r, g, h, G, H: \
            m.gen_proof_of_knowledge_of_preimage_of_mimc(
                [xl, xr], None, image, consts, rounds, r, label, g, h, G, H,
                **kw)
        verify = lambda pf, comms, g, h, G, H, t: \
            m.verify_knowledge_of_preimage_of_mimc(
                image + S(1) if t else image, consts, rounds, pf, comms,
                label, g, h, G, H, **kw)
    elif name == "hamming_distance":
        m = mod("hamming_distance")
        original = [S.random(rng) for _ in range(spec["elements"])]
        new = list(original)
        for i in sorted(rng.sample(range(spec["elements"]),
                                   spec["different"])):
            new[i] = new[i] + S(1)
        count = spec["different"]
        prove = lambda r, g, h, G, H: m.gen_proof_for_hamming_distance(
            original, new, count, label, g, h, G, H, rng=r, **kw)
        verify = lambda pf, comms, g, h, G, H, t: \
            m.verify_proof_for_hamming_distance(
                new, count + 1 if t else count, pf, comms, label, g, h, G, H,
                **kw)
    elif name == "randomizer":
        m = mod("randomizer")
        tree_mod = mod("helper_constraints.sparse_merkle_tree_4_ary")
        p = spec["poseidon"]
        params = mod("helper_constraints.poseidon").PoseidonParams(
            p["width"], p["full_rounds_beginning"], p["full_rounds_end"],
            p["partial_rounds"])
        depth, sbox = spec["depth"], p["sbox"]
        data = [S(10 + i) for i in range(spec["data_size"])]
        indices = m.get_indices_to_modify(S(spec["nonce"]), len(data),
                                          spec["count_modified"])
        modified, new_data = m.get_randomized_data(data, indices)
        Db = pkg.utils.hash_db.InMemoryHashDb
        trees = []
        for values in (data, new_data):
            db = Db()
            tree = tree_mod.VanillaSparseMerkleTree_4(params, depth, db, **kw)
            for i, val in enumerate(values):
                tree.update(S(i), val, db)
            trees.append((tree, db))
        (orig, orig_db), (new, new_db) = trees
        mod_idx = sorted(modified, key=int)
        orig_vals = [modified[i] for i in mod_idx]
        prove = lambda r, g, h, G, H: m.gen_proof_for_randomizer(
            orig, orig_db, new, new_db, mod_idx, orig_vals, depth, params,
            sbox, label, g, h, G, H, rng=r, **kw)
        verify = lambda pf, comms, g, h, G, H, t: \
            m.verify_proof_for_randomizer(
                new, new_db, mod_idx, depth, params, sbox, pf,
                plus(comms, g) if t else comms, label, g, h, G, H, **kw)
    else:
        raise ValueError(f"no gadget {name!r}")
    state = rng.getstate()

    def prove_fresh(g, h, G, H):
        r = random.Random()
        r.setstate(state)
        return prove(r, g, h, G, H)

    return prove_fresh, (lambda pf, comms, g, h, G, H, tampered=False:
                         verify(pf, comms, g, h, G, H, tampered))


# The gadget statements of the JAX package's tests/test_ed25519.py:69-96 on
# ed25519 (the reference's `ed25519` cargo feature): a range proof, a set
# membership proof and a Poseidon preimage proof, each from its own seed;
# the generators the JAX test gives them
ED25519_GADGETS = {"bound_check": (b"ed", 81),
                   "set_membership": (b"edset", 82),
                   "poseidon_preimage": (b"edpos", 83)}
ED25519_GADGET_N = 512


def ed25519_gadget_case(pkg, name, poseidon_rounds=(4, 4, 55), **kw):
    """One of `ED25519_GADGETS`' statements, built from the modules of the
    package `pkg` (this port, or in the tests the JAX package) under its
    active curve, ed25519: 42 in [0, 2^16] with 16 bits, 9 in
    {5, 9, 1, 100}, and a preimage of Poseidon_hash_2 with width 3 and
    `poseidon_rounds` (full rounds at the beginning and end, partial
    rounds: the JAX test's 4, 4, 55 unless a CPU test asks for fewer) of
    the cube s-box.  kw goes to the port's entry points (`device`).
    -> (prove, verify) as `gadget_case` gives them; tampered: the first
    commitment + g, the member replaced, the image + 1."""
    mod = lambda m: functools.reduce(getattr, m.split("."), pkg.models)
    S = pkg.Scalar
    label, seed = ED25519_GADGETS[name]
    rng = random.Random(seed)
    plus = lambda comms, g: [comms[0] + g] + list(comms[1:])
    if name == "bound_check":
        m = mod("bound_check")
        prove = lambda r, g, h, G, H: m.gen_proof_of_bounded_num(
            42, None, 0, 1 << 16, 16, r, label, g, h, G, H, **kw)
        verify = lambda pf, comms, g, h, G, H, t: \
            m.verify_proof_of_bounded_num(
                0, 1 << 16, 16, pf, plus(comms, g) if t else comms, label, g,
                h, G, H, **kw)
    elif name == "set_membership":
        m = mod("set_membership")
        sets = ([S(v) for v in (5, 9, 1, 100)],
                [S(v) for v in (5, 1009, 1, 100)])
        prove = lambda r, g, h, G, H: m.gen_proof_of_set_membership(
            S(9), None, sets[0], r, label, g, h, G, H, **kw)
        verify = lambda pf, comms, g, h, G, H, t: \
            m.verify_proof_of_set_membership(sets[t], pf, comms, label, g, h,
                                             G, H, **kw)
    elif name == "poseidon_preimage":
        m = mod("poseidon_hash")
        pos = mod("helper_constraints.poseidon")
        params = pos.PoseidonParams(3, *poseidon_rounds)
        cube = pos.SboxType.Cube
        xl, xr = S.random(rng), S.random(rng)
        image = pos.Poseidon_hash_2(xl, xr, params, cube)
        prove = lambda r, g, h, G, H: \
            m.gen_proof_of_knowledge_of_preimage_of_Poseidon_2(
                [xl, xr], None, image, params, cube, r, label, g, h, G, H,
                **kw)
        verify = lambda pf, comms, g, h, G, H, t: \
            m.verify_proof_of_knowledge_of_preimage_of_Poseidon_2(
                image + S(1) if t else image, params, cube, pf, comms, label,
                g, h, G, H, **kw)
    else:
        raise ValueError(f"no ed25519 gadget {name!r}")
    state = rng.getstate()

    def prove_fresh(g, h, G, H):
        r = random.Random()
        r.setstate(state)
        return prove(r, g, h, G, H)

    return prove_fresh, (lambda pf, comms, g, h, G, H, tampered=False:
                         verify(pf, comms, g, h, G, H, tampered))


def phase_gadgets(device, ref):
    """One proof and one verification of each gadget of `ref["gadgets"]`
    (the shape of tests/vectors/torch_gadgets.json: each statement's
    sizes, seed, generator count n and the JAX package's proof sha256)
    through the port's one-shot entry points on `device`: the proof's
    sha256 against the JAX package's, and the statement tampered
    (`gadget_case`) rejected.  Returns the launches of each proof and
    verification, the shapes of their MSMs (`msm_shapes`) and each
    proof with its commitments."""
    t0 = time.time()
    cv = BLS381
    g, h = G1.from_msg_hash(b"g", cv), G1.from_msg_hash(b"h", cv)
    per_call, rows, proofs = {}, {}, {}
    earlier = clear_msm_memos()
    for name, spec in ref["gadgets"].items():
        t1 = time.time()
        G = bt.get_generators("G", spec["n"])
        H = bt.get_generators("H", spec["n"])
        prove, verify = gadget_case(bt, name, spec, device=device)
        setup = time.time() - t1
        before = launch_counts()
        t1 = time.time()
        proof, comms = prove(g, h, G, H)
        prove_s = time.time() - t1
        mid = launch_counts()
        verify(proof, comms, g, h, G, H)
        verify_s = time.time() - t1 - prove_s
        after = launch_counts()
        per_call[name] = {
            "prove": {k: v - before[k] for k, v in mid.items()
                      if v > before[k]},
            "verify": {k: v - mid[k] for k, v in after.items()
                       if v > mid[k]}}
        digest = hashlib.sha256(proof.to_bytes()).hexdigest()
        if digest != spec["sha256"]:
            raise AssertionError(f"gadgets: the {name} proof has sha256 "
                                 f"{digest}, the JAX package's "
                                 f"{spec['sha256']}")
        try:
            verify(proof, comms, g, h, G, H, tampered=True)
        except VerificationError:
            pass
        else:
            raise AssertionError(f"gadgets: {name} verified a tampered "
                                 "statement")
        rows[name] = {"n": 1 << len(proof.ipp_proof.L),
                      "prove_seconds": prove_s, "verify_seconds": verify_s,
                      "setup_seconds": setup, "proof_sha256": digest,
                      "tampered_rejected": True}
        proofs[name] = (proof, comms)
    msms = msm_shapes()
    restore_msm_memos(earlier)
    emit({"phase": "gadgets", "gadgets": rows, "matches_reference": True,
          "launches_per_call": per_call, "seconds": time.time() - t0})
    return {"launches": per_call, "msms": msms, "proofs": proofs}


def phase_sharded(device, n, seed, reps, ref, r1cs=(16, 64), shards=4,
                  ipa_n=None, ipa_proof=None):
    """Phase 12: the sharded MSM and prover (`bulletproofs_tpu_torch.
    parallel`) on a mesh of `shards` shards of one device,
    `make_mesh([device] * shards)`: every shard's bucket pass, every
    butterfly step and IPA exchange runs on that device.
    - `msm_sharded` on phase 3's input (n uniform scalars), 1 + reps runs
      beside 1 + reps of `msm_device` on the same input, each checked
      against the host sum, and on the card one traced run (the
      butterfly's device ms: its only pairwise adds); `msm_sharded_2d`
      once on a 2 x shards/2 mesh;
    - `msm_multi_sharded` on phase 4's bit vector, 1 + reps runs: the
      round guess overflows and the shards pre-reduce (kernels 2 and 3);
    - `create_ipp_sharded` at ipa_n (default n) on phase 5's input, 1 + 1
      runs, the bytes of phase 5's proof (ipa_proof; made here when None);
    - `prove_sharded` on phase 6's statements (r1cs = (m, bits)), seeds
      1..1 + reps, the seed ref["seed"] proof's sha256 ref["sha256"],
      `Verifier.verify` accepts it and t_x + 1 is rejected; the stages of
      one more proof.
    Returns {"msms": the per-shard MSM shapes the phase ran, for
    `kernels_at`, "launches": the launches of one sharded proof}."""
    t0 = time.time()
    device = torch.device(device)
    devices = [device] * shards
    mesh = make_mesh(devices)
    ctx = CurveCtx(BLS381)
    ns = n // shards
    sharded_prover._sharded_memo.clear()
    out = {"phase": "sharded", "shards": shards,
           "devices": [str(d) for d in mesh.flat], "n": n}
    p50 = lambda ts: sorted(ts)[len(ts) // 2]
    parts = {}                  # seconds by part of the phase

    def timed(name, run, expected):
        """1 + reps runs of run() -> (first s, warm p50 s), each result's
        bytes the expected point's."""
        times = []
        for _ in range(1 + reps):
            t1 = time.time()
            res = run()
            times.append(time.time() - t1)
            if res.to_bytes() != expected.to_bytes():
                raise AssertionError(f"sharded: {name} differs from the "
                                     "host sum")
        return times[0], p50(times[1:] or times)

    # phase 3's input, uniform scalars
    c = msm_mod.pick_window(n)
    pts, vals, expected = _bench_input(n, seed, False, BLS381)
    P, affine = to_device_points_affine(pts, ctx, device)
    s = to_device_scalars(vals, ctx, device)
    run = lambda: from_device_points(
        msm_sharded(P, s, ctx, c, mesh, affine=affine), ctx)[0]
    first, warm = timed("msm_sharded", run, expected)
    if device.type == "cuda":         # its only pairwise adds: the butterfly
        _, out["trace_msm_sharded"] = trace(run, watch=("ec_add_kernel",))
    one_first, one_warm = timed("msm_device", lambda: from_device_points(
        msm_mod.msm_device(P, s, ctx, c, affine=affine), ctx)[0], expected)
    rounds = sharded_msm_mod._global_rounds(
        sharded_msm_mod.split_shards(s, mesh), ctx, c)
    msms = [(ns, 1, c, rounds, 0, affine, True, False)]
    t1 = time.time()
    got = from_device_points(msm_sharded_2d(
        P, s, ctx, c, make_mesh_2d(2, shards // 2, devices),
        affine=affine), ctx)[0]
    if got.to_bytes() != expected.to_bytes():
        raise AssertionError("sharded: msm_sharded_2d differs from the host "
                             "sum")
    out.update({"c": c, "msm_rounds": rounds,
                "msm_sharded_first_seconds": first,
                "msm_sharded_seconds_p50": warm,
                "msm_device_first_seconds": one_first,
                "msm_device_seconds_p50": one_warm,
                "msm_sharded_2d_mesh": [2, shards // 2],
                "msm_sharded_2d_seconds": time.time() - t1})

    # phase 4's input, a bit vector: escalation to pre-reduction
    pts_b, vals_b, expected_b = _bench_input(n, seed + 1, True, BLS381)
    Pb, affine_b = to_device_points_affine(pts_b, ctx, device)
    sb = to_device_scalars(vals_b, ctx, device)[None]
    first, warm = timed("msm_multi_sharded (bits)", lambda: msm_multi_sharded(
        Pb, sb, ctx, c, mesh, affine=affine_b)[0], expected_b)
    rounds_b, pre_b = sharded_prover._sharded_memo[
        (ns, 1, c, ctx.cv.name, shards, None)]
    if pre_b == 0:
        raise AssertionError("sharded: the bit-vector MSM did not "
                             "pre-reduce")
    out.update({"bits_rounds": rounds_b, "bits_pre_reduce": pre_b,
                "msm_multi_sharded_bits_first_seconds": first,
                "msm_multi_sharded_bits_seconds_p50": warm})

    # phase 5's input: the IPA, its bytes phase 5's
    label = b"ipa_smoke"
    ipa_n = ipa_n or n
    parts["msm"] = time.time() - t0
    Gb, Hb, Q, a, b = _ipa_bases(ipa_n, seed + 2, BLS381)
    m = len(Gb)
    G = [Gb[i % m] for i in range(ipa_n)]
    H = [Hb[i % m] for i in range(ipa_n)]
    ones = [Scalar.one(BLS381)] * ipa_n
    if ipa_proof is None:
        ipa_proof = _proof_bytes(bt.create_ipp(
            bt.ProofTranscript(label), Q, ones, ones, G, H, a, b,
            device=device))

    def ipa():
        L, R, af, bf = create_ipp_sharded(bt.ProofTranscript(label), Q, ones,
                                          ones, G, H, a, b, mesh)
        return ([p.to_bytes() for p in L], [p.to_bytes() for p in R],
                af.to_bytes(), bf.to_bytes())

    ipa_times = []
    for _ in range(2):
        t1 = time.time()
        got = ipa()
        ipa_times.append(time.time() - t1)
        if got != ipa_proof:
            raise AssertionError("sharded: the sharded IPA's bytes differ "
                                 "from phase 5's proof")
    parts["ipa"] = time.time() - t0 - sum(parts.values())
    out.update({"ipa_n": ipa_n,
                "ipa_sharded_prove_first_seconds": ipa_times[0],
                "ipa_sharded_prove_seconds": ipa_times[1],
                "ipa_bytes_identical": True})

    # phase 6's statements, proved on the mesh
    m_r, bits = r1cs
    nr = m_r * 2 * bits
    Gr, Hr = bt.get_generators("G", nr), bt.get_generators("H", nr)
    g, h = G1.from_msg_hash(b"g", BLS381), G1.from_msg_hash(b"h", BLS381)
    per_call = {}

    def prove(seed_r, profile=False):
        prover, comms = _agg_range_prover(seed_r, m_r, bits, g, h, device)
        prover_device._prof.enabled = profile
        before = launch_counts()
        t1 = time.time()
        try:
            proof = prove_sharded(prover, Gr, Hr, mesh)
        finally:
            prover_device._prof.enabled = False
        dt = time.time() - t1
        per_call["prove"] = {k: v - before[k] for k, v in
                             launch_counts().items()}
        return proof, comms, dt

    seeds = [1, 2, 3, 4][:1 + reps]
    runs = {sd: prove(sd) for sd in seeds}
    if ref["seed"] not in runs:
        raise AssertionError(f"sharded: no proof of the reference seed "
                             f"{ref['seed']}")
    proof, comms, _ = runs[ref["seed"]]
    digest = hashlib.sha256(proof.to_bytes()).hexdigest()
    if digest != ref["sha256"]:
        raise AssertionError(f"sharded: proof of seed {ref['seed']} has "
                             f"sha256 {digest}, the JAX package's "
                             f"{ref['sha256']}")
    t1 = time.time()
    _agg_range_verifier(comms, bits, device).verify(proof, g, h, Gr, Hr)
    verify_s = time.time() - t1
    bad = bt.R1CSProof.from_bytes(proof.to_bytes())
    bad.t_x = bad.t_x + Scalar.one(BLS381)
    try:
        _agg_range_verifier(comms, bits, device).verify(bad, g, h, Gr, Hr)
    except VerificationError:
        pass
    else:
        raise AssertionError("sharded: a tampered proof (t_x + 1) verified")
    prover_device._prof.take()
    again, _, staged = prove(ref["seed"], profile=True)
    stages = prover_device._prof.take()
    stages["other"] = staged - sum(stages.values())
    if again.to_bytes() != proof.to_bytes():
        raise AssertionError("sharded: proofs of one input differ")
    warm = [runs[sd][2] for sd in seeds[1:]] or [runs[seeds[0]][2]]
    out.update({"m": m_r, "bits": bits, "r1cs_n": nr,
                "r1cs_sharded_prove_first_seconds": runs[seeds[0]][2],
                "r1cs_sharded_prove_seconds_p50": p50(warm),
                "r1cs_sharded_stage_seconds": stages,
                "r1cs_verify_seconds": verify_s, "proof_sha256": digest,
                "reference_seed": ref["seed"], "matches_reference": True,
                "tampered_rejected": True,
                "launches_per_proof": per_call["prove"]})
    # the per-shard shapes of the multi-set MSMs: (points a shard, sets,
    # c, rounds, pre, affine tables, Horner on the card, duplicate rows)
    msms += [(k[0], k[1], k[2], *v, True, False, False) for k, v in
             sharded_prover._sharded_memo.items()]
    out["msms"] = msms
    parts["r1cs"] = time.time() - t0 - sum(parts.values())
    emit({**out, "part_seconds": parts, "seconds": time.time() - t0})
    return {"msms": msms, "launches": per_call}


ED25519_REFERENCE = R1CS_REFERENCE.with_name("torch_ed25519.json")


@contextlib.contextmanager
def no_plain_add_on_card():
    """While open, the plain complete add (`ops.ec.ec_add`, and the kernel
    wrappers' handle on it) raises for a CUDA tensor: a path that hands
    the card's group law to the plain version fails."""
    plain = ec_mod.ec_add

    def guarded(P, Q, ctx, **kw):
        if P.device.type == "cuda":
            raise AssertionError("the plain ec_add ran on a CUDA tensor")
        return plain(P, Q, ctx, **kw)
    ec_mod.ec_add = ek.ec_add_plain = guarded
    try:
        yield
    finally:
        ec_mod.ec_add = ek.ec_add_plain = plain


def phase_ed25519(device, n, seed, reps, ref, r1cs=None, gadgets=True):
    """ed25519 (a != 0: RCB16 algorithm 1 in kernels 2, 3 and 4) end to end
    through the port's entry points on `device`, under
    `using_curve(ED25519)` and `no_plain_add_on_card`: phases 3-5 on
    ed25519 inputs (the n-point uniform and bit-vector MSMs against the
    host sums, 1 + reps runs of `msm_hybrid` and of `msm_device`; the IPA
    at n, per round: Edwards transcripts, 1 + reps proofs, the host check,
    `verify_ipp`, a + 1 rejected, the per-round kernel's proof
    identical), phase 6 on ref["config2"] (r1cs = (m, bits) overrides its
    size, for a rehearsal: proofs of seeds 1..1 + reps, the reference
    seed's sha256 the JAX package's, the host check, `Verifier.verify`,
    t_x + 1 rejected), and with `gadgets` the three gadget proofs of
    `ED25519_GADGETS` at n = 512, each sha256 against ref["gadgets"],
    verified, the statement tampered rejected.  Returns the launches of
    one IPA proof and verification, one config-2 proof and verification,
    each gadget's, and the shapes of the MSMs the phase ran
    (`msm_shapes`, `device_msm_shapes`) for `kernels_at`."""
    t0 = time.time()
    earlier = clear_msm_memos()
    c2 = dict(ref["config2"])
    if r1cs is not None:
        c2["m"], c2["bits"] = r1cs
    with using_curve(ED25519), no_plain_add_on_card():
        phase_msm(device, n, seed, bits=False, reps=reps)
        phase_msm(device, n, seed + 1, bits=True, reps=reps)
        ipa = phase_ipa(device, n, seed + 2, reps)
        ipa.pop("proof")
        per_call = {"ipa": ipa,
                    "r1cs": phase_r1cs(device, c2["m"], c2["bits"], reps,
                                       c2)}
        rows = {}
        if gadgets:
            g, h = G1.from_msg_hash(b"g"), G1.from_msg_hash(b"h")
            G = bt.get_generators("G", ED25519_GADGET_N)
            H = bt.get_generators("H", ED25519_GADGET_N)
            for name, spec in ref["gadgets"].items():
                prove, verify = ed25519_gadget_case(bt, name, device=device)
                before = launch_counts()
                t1 = time.time()
                proof, comms = prove(g, h, G, H)
                prove_s = time.time() - t1
                mid = launch_counts()
                verify(proof, comms, g, h, G, H)
                verify_s = time.time() - t1 - prove_s
                per_call[name] = {
                    "prove": {k: v - before[k] for k, v in mid.items()
                              if v > before[k]},
                    "verify": {k: v - mid[k] for k, v in
                               launch_counts().items() if v > mid[k]}}
                digest = hashlib.sha256(proof.to_bytes()).hexdigest()
                if digest != spec["sha256"]:
                    raise AssertionError(
                        f"ed25519: the {name} proof has sha256 {digest}, "
                        f"the JAX package's {spec['sha256']}")
                try:
                    verify(proof, comms, g, h, G, H, tampered=True)
                except VerificationError:
                    pass
                else:
                    raise AssertionError(f"ed25519: {name} verified a "
                                         "tampered statement")
                rows[name] = {"n": 1 << len(proof.ipp_proof.L),
                              "prove_seconds": prove_s,
                              "verify_seconds": verify_s,
                              "proof_sha256": digest,
                              "tampered_rejected": True}
    msms = msm_shapes() + device_msm_shapes("ed25519")
    restore_msm_memos(earlier)
    emit({"phase": "ed25519", "gadgets": rows, "matches_reference": True,
          "no_plain_add_on_card": True, "launches_per_call": per_call,
          "seconds": time.time() - t0})
    return {"launches": per_call, "msms": msms}


ROOFLINE_CURVES = (BLS381, ED25519)
# the curves no path of this script runs: phase 2's checks after the paths
# hold every kernel and form bit-exact at their widths too
OTHER_CURVES = (BN254, SECP256K1)
# the roofline report's size: the JAX bench's (`bench.py:711-720`)
ROOFLINE_BATCH, ROOFLINE_ITERS = 8192, 100
# the steps of `chain_latency`'s one-point chains
LATENCY_ITERS = 64


# the chain kernel's doubling and warp forms: a shorter chain over fewer
# points, their plain versions being the slow part of phase 2
CHAIN_FORM_BATCH, CHAIN_FORM_ITERS = 1024, 16


def chain_cases(ctx, batch, device):
    """Phase 2's cases of the roofline harness's chain kernel: its two
    roofline forms, `ROOFLINE_ITERS` dependent adds or products over
    `batch` distinct canonical inputs (the report's size on the card), and
    its doubling (a group of 4 lanes a point) and warp forms (a warp a
    point: the lone chains' add and doubling), `CHAIN_FORM_ITERS` steps
    over `CHAIN_FORM_BATCH` points.  Bound: the IMADs of the function's
    products (12 or 18 an add, 8 or 17 a doubling) and its inputs and
    outputs once.  Each shape names the build it runs: the product has no
    curve constant, so an a != 0 curve's runs the a = 0 build of its
    width, and its launches count as that build's."""
    build_of = "a!=0" if not ctx.a_is_zero else "a=0"
    cases = []
    for op, make, per_step in (
            ("ec_add", roofline.chain_points, roofline.imad_per_ec_add(ctx)),
            ("mont_mul", roofline.chain_elements,
             imad_per_mont_mul(ctx))):
        x = make(ctx, batch, device=device)

        def bare(args, op=op):
            out = torch.empty_like(args[0])
            launch = getattr(roofline, f"{op}_chain32")
            return lambda: launch(out, *args, ctx)
        cases.append(("chain", getattr(roofline, f"{op}_chain"),
                      getattr(roofline, f"{op}_chain_plain"),
                      (x, ROOFLINE_ITERS), bare,
                      (2 * x.numel() * 4, batch * ROOFLINE_ITERS * per_step),
                      {"op": op, "batch": batch, "iters": ROOFLINE_ITERS,
                       "build": build_of if op == "ec_add" else "a=0"}))
    imad = imad_per_mont_mul(ctx)
    form_batch = min(batch, CHAIN_FORM_BATCH)
    x = roofline.chain_points(ctx, form_batch, device=device)
    for form in roofline.CHAIN_FORMS[1:]:
        per_step = imad * (mont_muls_per_dbl(ctx) if form.startswith("dbl")
                           else mont_muls_per_add(ctx))

        def bare(args, form=form):
            out = torch.empty_like(args[0])
            return lambda: roofline.ec_chain32(out, *args, form, ctx)
        cases.append((
            "chain",
            lambda P32, iters, ctx, form=form: roofline.ec_chain(
                P32, iters, form, ctx),
            lambda P32, iters, ctx, form=form: roofline.ec_chain_plain(
                P32, iters, form, ctx),
            (x, CHAIN_FORM_ITERS), bare,
            (2 * x.numel() * 4, form_batch * CHAIN_FORM_ITERS * per_step),
            {"op": form, "batch": form_batch,
             "iters": CHAIN_FORM_ITERS, "build": build_of}))
    return cases


def phase_roofline(smi=None):
    """The H100 roofline (`utils/roofline.py: roofline_report`) on each
    curve of `ROOFLINE_CURVES` at the report's size, with the card's name
    and power limit (`smi`): measured and speed-of-light rates of the
    complete add and the product, and their utilisation; before it, the
    latency of one step of each chain form at one point (`chain_latency`:
    the product, and the add and doubling on a group of 4 lanes and on a
    warp), the floor of the lone chains.  The chain kernel
    it times is held bit-exact against its plain version at this size in
    phase 2 (`chain_cases`)."""
    t0 = time.time()
    for cv in ROOFLINE_CURVES:
        # one point's chain: the latency of a product, an add and a
        # doubling, on a group of 4 lanes and on a warp
        emit({"phase": "chain_latency", "curve": cv.name, "nvidia_smi": smi,
              **roofline.chain_latency(CurveCtx(cv), LATENCY_ITERS,
                                       "cuda")})
        report = roofline.roofline_report(CurveCtx(cv), ROOFLINE_BATCH,
                                          ROOFLINE_ITERS, "cuda")
        emit({"phase": "roofline", "curve": cv.name, "nvidia_smi": smi,
              **report})
    emit({"phase": "roofline_done", "seconds": time.time() - t0})


def msm_shapes():
    """The MSM shapes in `msm._escalation_memo`, with the rounds and
    pre-reduction passes that `msm_hybrid` settled on for each, then the
    fused IPAs' two-set MSMs in `prover_device._fused_memo` (over 2n + 2
    points, an affine table, the Horner on the card):
    [(points, sets, c, rounds, pre)] and [(points, 2, c, rounds, pre,
    True, True)]."""
    return [(k[0], k[1], k[2], *v) for k, v in
            msm_mod._escalation_memo.items()] + \
        [(2 * k[0] + 2, 2, k[1], *v, True, True) for k, v in
         prover_device._fused_memo.items()]


def _shape_memos():
    return msm_mod._escalation_memo, prover_device._fused_memo


def clear_msm_memos():
    """Empty the memos `msm_shapes` reads, so that it lists every shape
    run after: -> their earlier entries, for `restore_msm_memos`."""
    earlier = [dict(memo) for memo in _shape_memos()]
    for memo in _shape_memos():
        memo.clear()
    return earlier


def restore_msm_memos(earlier):
    """Put back the entries `clear_msm_memos` took that no later run
    replaced."""
    for memo, old in zip(_shape_memos(), earlier):
        for key, v in old.items():
            memo.setdefault(key, v)


def device_msm_shapes(curve_name=None):
    """The MSM shapes in `msm._device_memo` (of one curve, where named),
    with the rounds and pre-reduction passes that `msm_device` settled on
    for each and the Horner on the device: [(points, 1, c, rounds, pre,
    affine, True)]."""
    return [(k[0], 1, k[1], *v, k[3], True) for k, v in
            msm_mod._device_memo.items()
            if curve_name in (None, k[2])]


def _ipa_round_schedule(n, seed, device):
    """The bucket rounds of the IPA's first two-set MSM at n, as
    `msm.bucket_accumulate` plans them: -> (the packed projective table
    [G | H | Q | identity] (2n+2, 3NL), per-round point ids (R, S) int32,
    found (R, S) int32)."""
    ctx = CurveCtx(BLS381)
    fr = ctx.fr
    Gb, Hb, Q, a, b = _ipa_bases(n, seed, BLS381)
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
    (`ec_add:<form>`, `ek.form_launches`), each by build: `<key>` counts
    the launches of the a = 0 build, and for a kernel with an a != 0
    build (algorithm 1), `<key>:a!=0` those of that build
    (`ek.a_nonzero_launches`)."""
    total = {**ek.launches,
             **{f"ec_add:{k}": v for k, v in ek.form_launches.items()}}
    out = {}
    for key, n in total.items():
        general = ek.a_nonzero_launches.get(key)
        out[key] = n - (general or 0)
        if general is not None:
            out[f"{key}:a!=0"] = general
    return out


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
    for kernel in NOT_ON_PATH.get(name, ()):
        if counts[kernel]:
            raise AssertionError(f"{kernel} launched on the {name} path")
    return counts


def add_launches(records, by_path, build=""):
    """Each record's launches over the paths' runs, in total and by path
    (the paths that launched it); kernel 3's sequential forms' sub-records
    by their kernel form.  build: "" for the records of the a = 0 builds,
    ":a!=0" for those of the a != 0 builds (`launch_counts`)."""
    def put(rec, key):
        rec["launches"] = sum(c[key] for c in by_path.values())
        rec["launches_by_path"] = {p: c[key] for p, c in by_path.items()
                                   if c[key]}
    for name, rec in records.items():
        put(rec, name + build)
    for sub in records["ec_add"].get("forms", []):
        put(sub, "ec_add:" + FORM_KERNEL[sub["shape"]["form"]] + build)


def trace_ipa(n, seed, reps):
    """`--trace-ipa REPS`: phase 6b's traces alone, so that two trees
    compare in one call: a copy of this file in the root of each tree,
    run there in turns, traces that tree's package.  Phase 5's input
    proved fused and per round once each (warm, byte-identical), then reps
    traced proofs of each in turns, one line a proof: traced wall ms,
    device busy ms, idle share, the costliest kernels and
    `bp_ipa_challenge`'s device ms."""
    Gb, Hb, Q, a, b, _ = _ipa_input(n, seed, BLS381)
    m = len(Gb)
    G = [Gb[i % m] for i in range(n)]
    H = [Hb[i % m] for i in range(n)]
    ones = [Scalar.one(BLS381)] * n

    def prove(fused):
        return bt.create_ipp(bt.ProofTranscript(b"ipa_smoke"), Q, ones, ones,
                             G, H, a, b, device="cuda", fused=fused)

    if _proof_bytes(prove(True)) != _proof_bytes(prove(False)):
        raise AssertionError("trace_ipa: fused and per-round proofs differ")
    for rep in range(reps):
        for fused in (True, False):
            _, row = trace(lambda: prove(fused), watch=("ipa_challenge",))
            emit({"phase": "trace_ipa", "n": n, "rep": rep,
                  "path": "fused" if fused else "per_round", **row})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0xBE7C)
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--trace-ipa", type=int, default=0, metavar="REPS",
                    help="only trace REPS fused and per-round IPA proofs "
                         "in turns (phase 6b's traces)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if args.trace_ipa:
        with using_curve(BLS381):
            phase_device()
            trace_ipa(args.n, args.seed + 2, args.trace_ipa)
        return
    t_start = time.time()
    with using_curve(BLS381):
        kind, smi = phase_device()
        ptxas = phase_build()
        records, check_msms = phase_kernels("cuda", args.n, args.seed)
        records["ipa_challenge"]["ptxas"] = [
            e for entries in ptxas.values() for e in entries
            if e["kernel"].startswith("ipa_challenge_kernel")]
        emit({"phase": "kernel_ptxas", "name": "ipa_challenge",
              "ptxas": records["ipa_challenge"]["ptxas"]})

        def msm_path():
            phase_msm("cuda", args.n, args.seed, bits=False, reps=3)
            phase_msm("cuda", args.n, args.seed + 1, bits=True, reps=3)

        ref = json.loads(R1CS_REFERENCE.read_text())
        smt_ref = json.loads(SMT_REFERENCE.read_text())
        gadget_ref = json.loads(GADGET_REFERENCE.read_text())
        per_call = {}
        by_path = {
            "msm": _run_path("msm", msm_path),
            "ipa": _run_path("ipa", lambda: phase_ipa(
                "cuda", args.n, args.seed + 2, reps=3), per_call),
            "r1cs": _run_path("r1cs", lambda: phase_r1cs(
                "cuda", ref["m"], ref["bits"], 3, ref), per_call),
            "ipa_fused": _run_path("ipa_fused", lambda: phase_ipa_fused(
                "cuda", args.n, args.seed + 2, 3, records,
                (ref["m"], ref["bits"], ref)), per_call),
            "smt": _run_path("smt", lambda: phase_smt(
                "cuda", smt_ref, 8192, 3), per_call),
            "batch": _run_path("batch", lambda: phase_batch(
                "cuda", ref["m"], ref["bits"], 8, args.n, 4, args.seed + 4,
                reps=3), per_call),
            "gadgets": _run_path("gadgets", lambda: phase_gadgets(
                "cuda", gadget_ref), per_call),
            "mxu_race": _run_path("mxu_race", lambda: phase_mxu_race(
                "cuda", args.n, args.seed + 3)),
            "sharded": _run_path("sharded", lambda: phase_sharded(
                "cuda", args.n, args.seed, 3, ref, (ref["m"], ref["bits"]),
                ipa_proof=per_call["ipa"].pop("proof")), per_call),
        }
        ed_ref = json.loads(ED25519_REFERENCE.read_text())
        by_path["ed25519"] = _run_path("ed25519", lambda: phase_ed25519(
            "cuda", args.n, args.seed, 3, ed_ref), per_call)
        by_path["roofline"] = _run_path("roofline",
                                        lambda: phase_roofline(smi))
        with using_curve(ED25519):        # outside the paths' counts
            ed_records, ed_check = phase_kernels("cuda", args.n, args.seed,
                                                 cv=ED25519)
            ed_check("ed25519", per_call["ed25519"]["msms"])
        for cv in OTHER_CURVES:           # phase 2 on the other curves
            with using_curve(cv):
                phase_kernels("cuda", args.n, args.seed, cv=cv)
        check_msms("sharded", per_call["sharded"]["msms"])
        for path in ("smt", "batch", "gadgets"):
            res = per_call[path]
            per_call[path] = res["launches"]
            check_msms(path, res["msms"])   # outside the paths' counts
        per_call["ipa_fused"].pop("check")()  # outside the paths' counts
        fused_calls = per_call["ipa_fused"]["launches"]
        add_launches(records, by_path)
        add_launches(ed_records, by_path, ":a!=0")
        for name, rec in ed_records.items():
            rec["ptxas"] = [e for entries in ptxas.values() for e in entries
                            if e["kernel"].endswith("a!=0>")
                            and e["kernel"].split("<")[0]
                            in KERNEL_FUNCTIONS[name]]
            records[name]["a_nonzero"] = rec
        records["chain"]["ptxas"] = [
            e for entries in ptxas.values() for e in entries
            if e["kernel"].split("<")[0] in KERNEL_FUNCTIONS["chain"]]
        emit({"phase": "launches", "launches": by_path,
              "per_r1cs_proof": per_call["r1cs"]["prove"],
              "per_r1cs_verify": per_call["r1cs"]["verify"],
              "per_ipa_proof": per_call["ipa"]["prove_chunk"],
              "per_ipa_fused_proof": fused_calls["fused"],
              "per_ipa_round_proof": fused_calls["per_round"],
              "per_ipa_verify": per_call["ipa"]["verify"],
              "per_smt_proof": per_call["smt"]["prove"],
              "per_smt_verify": per_call["smt"]["verify"],
              "per_batch_check": per_call["batch"],
              "per_gadget": per_call["gadgets"],
              "per_sharded_r1cs_proof": per_call["sharded"]["launches"][
                  "prove"],
              "per_ed25519_call": per_call["ed25519"]["launches"],
              "seconds": time.time() - t_start})
    print(smi, flush=True)
    emit({"kernels": [records[k] for k in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
