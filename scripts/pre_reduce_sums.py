"""Time the MSM's pre-reduction (`msm._pre_reduce_rows`) and kernel 3's row
and column sums (`bp_ec_gather_sum` at `bucket_rowcol`'s shapes), and the
bit-vector MSM and depth-12 SMT-4 proof that run them, for the copy of
`bulletproofs_tpu_torch` in the tree this file stands in, on one CUDA card.

    python3 scripts/pre_reduce_sums.py [--reps 20] [--n 65536] [--seed 7]
                                       [--proofs 3]

To compare two trees on one card, copy this file into the other tree's
`scripts/` and run it from each tree's root in turns (parent, change,
change, parent): each run builds and times its own tree's kernels.  Set
`BP_GENERATOR_CACHE` to one directory for all runs, so that the SMT-4
proof's 4096 G and H are derived once.

One JSON line each:
- `ptxas`: registers, stack and spills of kernel 3's kernels (pairwise,
  gather-sum and pre-reduction forms), from this run's build (empty where
  the libraries were already built);
- `msm_bitvector`: 1 + reps runs each of `msm_hybrid` and `msm_device` on
  the n-point BLS12-381 bit vector (256 random points repeated, scalars
  uniform in {0, 1}), each checked against the host sum: first and p50
  seconds, the result's sha256;
- `smt4_proof`: the bench's depth-12 SMT-4 inclusion proof (n = 4096,
  tests/vectors/torch_smt4_d12.json) proved 1 + proofs times: its sha256
  against the JAX package's, the p50 seconds, and one traced proof's
  device busy ms and idle share;
- `pre_reduce`: each distinct pre-reduction that the bit-vector MSMs and
  the proof ran (window rows W, points n, passes): the mergeable entries
  of each pass, ms a call (the whole function: CUDA events, 3 runs of
  `reps` calls after a warm one), the sha256 of its (W*n, 3NL) table,
  and from one call under torch.profiler the device ms of the pairwise
  kernel (`ec_add_kernel`), of the pre-reduction kernel where the tree
  has one, and of the other kernels (plain-torch copies, the gather);
- `rowsum`: the bare gather-sum launch (`ec_gather_sum32`) at the row and
  column sums of the c = 8 combines (W = 32 and 64 windows: 1024 and 2048
  outputs of 16 columns, from the identity) and at the folds' shapes, on
  BLS12-381, BN254 and ed25519: ms a launch (3 runs of `reps`) and the
  output's sha256 (the old layout, one group of 4 lanes an output, is
  the parent tree's: time it by running this file there).
Each line carries the card's name and power limit (nvidia-smi).  The
sha256s are equal in two trees where the words are.
"""

import argparse
import hashlib
import json
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import bulletproofs_tpu_torch as bt  # noqa: E402
from bulletproofs_tpu_torch.config import BLS381, BN254, ED25519  # noqa
from bulletproofs_tpu_torch.ops import build  # noqa: E402
from bulletproofs_tpu_torch.ops import ec as E  # noqa: E402
from bulletproofs_tpu_torch.ops import ec_kernels as ek  # noqa: E402
from bulletproofs_tpu_torch.ops import msm as M  # noqa: E402
from bulletproofs_tpu_torch.ops.field import pack32  # noqa: E402

FORM_KERNELS = ("ec_add_kernel", "ec_gather_sum_kernel",
                "ec_pre_reduce_kernel")


def emit(obj):
    print(json.dumps(obj), flush=True)


def sha(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def kernel_ms(launch, reps):
    """ms a call: 3 runs of reps calls by CUDA events, after a warm
    call."""
    launch()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return runs


def device_ms_by_kernel(run):
    """run() once under torch.profiler (CUDA activity): -> {kernel name cut
    to 60 characters: device ms}."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            key = ev.name[:60]
            by_name[key] = by_name.get(key, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
    return by_name


class PreReduceCalls:
    """Records the arguments of every `msm._pre_reduce_rows` call while
    open, one per distinct shape (window rows, points, passes)."""

    def __enter__(self):
        self.calls = {}
        self.orig = M._pre_reduce_rows

        def hook(points, sorted_d, rank, perm, ctx, pre_reduce):
            key = (tuple(sorted_d.shape), pre_reduce, ctx.cv.name)
            self.calls.setdefault(key, (points, sorted_d, rank, perm, ctx,
                                        pre_reduce))
            return self.orig(points, sorted_d, rank, perm, ctx, pre_reduce)
        M._pre_reduce_rows = hook
        return self

    def __exit__(self, *exc):
        M._pre_reduce_rows = self.orig


def mergeable_counts(sorted_d, rank, passes):
    """The entries each pass adds into: rank a multiple of 2^(p+1), digit
    nonzero and equal to the digit 2^p places on in the window's row."""
    counts = []
    for p in range(passes):
        shift = 1 << p
        nxt = torch.cat([sorted_d[:, shift:], torch.full_like(
            sorted_d[:, :shift], -1)], dim=1)
        counts.append(int((((rank & ((2 << p) - 1)) == 0)
                           & (nxt == sorted_d) & (sorted_d != 0)).sum()))
    return counts


def time_pre_reduce(calls, reps, tag, origin):
    for (shape, passes, curve_name), args in calls.items():
        run = lambda: M._pre_reduce_rows(*args)
        table = run()
        runs = kernel_ms(run, reps)
        by_name = device_ms_by_kernel(run)
        pairwise = sum(v for k, v in by_name.items()
                       if "ec_add_kernel" in k)
        form = sum(v for k, v in by_name.items() if "ec_pre_reduce" in k)
        emit({"phase": "pre_reduce", "from": origin, "curve": curve_name,
              "W": shape[0], "n": shape[1], "rows": shape[0] * shape[1],
              "passes": passes,
              "mergeable": mergeable_counts(args[1], args[2], passes),
              "ms_runs": runs, "ms": min(runs), "sha256": sha(table),
              "device_ms_pairwise": pairwise,
              "device_ms_pre_reduce_kernel": form,
              "device_ms_other": sum(by_name.values()) - pairwise - form,
              "device_ms_by_kernel": by_name, **tag})


def msm_bitvector(n, seed, reps, tag):
    ctx = E.CurveCtx(BLS381)
    rnd = random.Random(seed)
    base = [bt.G1.random(rnd, BLS381) for _ in range(256)]
    pts = [base[i % 256] for i in range(n)]
    ks = [rnd.randrange(2) for _ in range(n)]
    sums = [0] * 256
    for i, k in enumerate(ks):
        sums[i % 256] += k
    want = bt.msm_host(base, sums)
    P, affine = E.to_device_points_affine(pts, ctx, "cuda")
    s = E.to_device_scalars(ks, ctx, "cuda")
    c = M.pick_window(n)
    out = {"phase": "msm_bitvector", "n": n, "c": c}
    with PreReduceCalls() as rec:
        for name, run in (
                ("msm_hybrid", lambda: M.msm_hybrid(P, s[None], ctx, c,
                                                    affine=affine)[0]),
                ("msm_device", lambda: E.from_device_points(
                    M.msm_device(P, s, ctx, c, affine=affine), ctx)[0])):
            times = []
            for _ in range(1 + reps):
                t0 = time.time()
                got = run()
                times.append(time.time() - t0)
                if got != want:
                    raise AssertionError(f"{name} differs from the host sum")
            warm = sorted(times[1:])
            out[name] = {"first_seconds": times[0],
                         "seconds_p50": warm[len(warm) // 2],
                         "seconds": times[1:]}
    out["sha256"] = hashlib.sha256(want.to_bytes()).hexdigest()
    emit({**out, **tag})
    return rec.calls


def smt4_proof(proofs, tag):
    import chip_smoke as cs
    from bulletproofs_tpu_torch.models import sparse_merkle_tree_4_ary \
        as smt4
    from bulletproofs_tpu_torch.models.helper_constraints.\
        sparse_merkle_tree_4_ary import VanillaSparseMerkleTree_4
    from bulletproofs_tpu_torch.utils.hash_db import InMemoryHashDb
    ref = json.loads(cs.SMT_REFERENCE.read_text())
    params, sbox = cs.smt_params(ref)
    pr, depth = ref["proof"], ref["depth"]
    db = InMemoryHashDb()
    tree = VanillaSparseMerkleTree_4(params, depth, db, device="cuda")
    key = bt.Scalar(pr["key"], BLS381)
    tree.update(key, bt.Scalar(pr["value"], BLS381), db)
    nodes = []
    leaf = tree.get(key, nodes, db)
    G, H = bt.get_generators("G", pr["n"]), bt.get_generators("H", pr["n"])
    g = bt.G1.from_msg_hash(b"g", BLS381)
    h = bt.G1.from_msg_hash(b"h", BLS381)

    def prove():
        return smt4.gen_proof_of_leaf_inclusion_4_ary_merkle_tree(
            leaf, key, None, nodes, tree.root, depth, params, sbox,
            random.Random(pr["rng_seed"]), pr["label"].encode(), g, h, G, H,
            device="cuda")

    with PreReduceCalls() as rec:
        times, digests = [], set()
        for _ in range(1 + proofs):
            t0 = time.time()
            proof, _ = prove()
            times.append(time.time() - t0)
            digests.add(hashlib.sha256(proof.to_bytes()).hexdigest())
    if digests != {pr["sha256"]}:
        raise AssertionError(f"smt4: proof sha256s {digests}, the JAX "
                             f"package's {pr['sha256']}")
    _, row = cs.trace(prove, watch=("ec_add_kernel", "ec_pre_reduce",
                                    "ec_gather_sum"))
    warm = sorted(times[1:])
    emit({"phase": "smt4_proof", "n": pr["n"], "sha256": pr["sha256"],
          "first_seconds": times[0], "seconds_p50": warm[len(warm) // 2],
          "seconds": times[1:], "trace": row, **tag})
    return rec.calls


def gather_shapes(ctx):
    """[(form, n_out, columns, from_identity)] of the combine at c = 8:
    the row and column sums of the one-set and two-set MSMs (W = 32, 64),
    the split fold (`fold_split_buckets`) and the duplicate-row fold of
    the two plans."""
    out = [("rowcol", W, M._rowcol_index(W, 16, 16), True) for W in (32, 64)]
    for sets in (1, 2):
        ranges, splits, dup = M.window_plan(ctx, 8, n_sets=sets, dup=True)
        Wr = ranges.shape[0]
        W = Wr - sum(g - 1 for _, g in dup)
        out.append(("split_fold", Wr, M._split_fold_index(
            Wr, 256, ranges[:, 0].tolist(), splits[:, 0].tolist()), False))
        if dup:
            out.append(("dup_fold", W, M._dup_fold_index(W, 256, dup),
                        False))
    return out


def rowsums(cv, seed, reps, tag):
    ctx = E.CurveCtx(cv)
    rnd = random.Random(seed)
    pts = [bt.G1.random(rnd, cv) for _ in range(16)]
    proj = E.to_device_points([p + p for p in pts], ctx, "cuda")
    gen = torch.Generator().manual_seed(seed)
    nl = ctx.fp.L // 2
    for form, W, idx, first in gather_shapes(ctx):
        idx = torch.as_tensor(idx, device="cuda")
        n_out, m = idx.shape
        ncols = int(idx.max()) + 1
        pick = torch.randint(0, 16, (ncols,), generator=gen).to("cuda")
        pts32 = proj[:, :, pick]
        pts32[:, :, ::16] = ctx.identity_like((1,), "cuda")
        P32 = pack32(pts32, 1).contiguous()
        out = torch.empty((3, nl, n_out), dtype=torch.int32, device="cuda")
        rec = {"phase": "rowsum", "curve": cv.name, "form": form, "W": W,
               "n_out": n_out, "m": m}
        runs = kernel_ms(lambda: ek.ec_gather_sum32(out, P32, idx, first,
                                                    ctx), reps)
        rec.update(ms_runs=runs, ms=min(runs), sha256=sha(out))
        emit({**rec, **tag})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--proofs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pre_reduce_sums: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tag = {"tree": str(ROOT), "nvidia_smi": smi}
    t0 = time.time()
    reports = build.build()
    build.load()
    emit({"phase": "ptxas", "build_seconds": time.time() - t0,
          "kernels": [e for path, rep in reports.items()
                      for e in build.ptxas_summary(rep)
                      if e["kernel"].split("<")[0] in FORM_KERNELS],
          **tag})
    calls = msm_bitvector(args.n, args.seed, 5, tag)
    time_pre_reduce(calls, args.reps, tag, "msm_bitvector")
    calls = smt4_proof(args.proofs, tag)
    time_pre_reduce(calls, max(2, args.reps // 4), tag, "smt4_proof")
    for cv in (BLS381, BN254, ED25519):
        rowsums(cv, args.seed, args.reps, tag)
    emit({"phase": "done", "seconds": time.time() - t0, **tag})


if __name__ == "__main__":
    main()
