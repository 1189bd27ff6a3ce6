"""Time kernel 3's lone chains, `bp_ec_window_totals` and `bp_ec_horner`,
and the n-point `msm_device` whose combine ends in them, for the copy of
`bulletproofs_tpu_torch` in the tree this file stands in, on one CUDA card.

    python3 scripts/lone_chains.py [--reps 20] [--n 65536] [--seed 7]

To compare two trees on one card, copy this file into the other tree's
`scripts/` and run it from each tree's root in turns (parent, change,
change, parent): each run builds and times its own tree's kernels.

One JSON line each:
- `ptxas`: registers, stack and spills of the two forms' kernels, from
  this run's build (empty where the libraries were already built);
- `form`: the bare kernel on packed operands at the combine shapes of the
  paths (c = 8: the two-set MSM of the IPA and the range proof, W
  windows of its `window_plan(dup=True)`; the one-set MSM of
  `msm_device`; the Horner over 1 set, `msm_device`'s, and over 2, the
  fused IPA's), on BLS12-381, BN254 and ed25519, and on BLS12-381 and
  ed25519 at the other shapes the paths give them (`TOTALS_AT`,
  `HORNER_AT`): ms a launch by CUDA events, 3 runs of `reps` launches
  after a warm one, and the sha256 of the output words (equal in two
  trees: the same words);
- `msm_device`: 1 + reps runs of the n-point BLS12-381 MSM (256 random
  points repeated, uniform scalars) from points and scalars on the card
  to the host point, each checked against the host sum: first and p50
  seconds;
- `chain_latency`, where the tree has it (`utils/roofline.py`): the
  microseconds of one product, add and doubling of one point on one warp.
Each line carries the card's name and power limit (nvidia-smi).
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
from bulletproofs_tpu_torch.utils import roofline  # noqa: E402

FORM_KERNELS = ("ec_window_totals_kernel", "ec_horner_kernel")


def emit(obj):
    print(json.dumps(obj), flush=True)


def kernel_ms(launch, reps):
    """ms a launch: 3 runs of reps launches by CUDA events, after a warm
    launch."""
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


# The forms' other shapes on the paths, as chip_smoke.py's `kernels_at`
# lines list them (the SMT, batch, gadget, sharded and ed25519 MSMs):
# window totals (W, G, K, dbl), Horner (sets, windows a set, c)
TOTALS_AT = [(129, 8, 8, 3), (86, 8, 8, 3), (96, 16, 16, 4), (43, 8, 8, 3),
             (64, 4, 4, 2), (128, 4, 4, 2), (192, 4, 4, 2), (128, 2, 2, 1),
             (256, 2, 2, 1), (384, 2, 2, 1), (127, 2, 2, 1), (254, 2, 2, 1),
             (381, 2, 2, 1)]
HORNER_AT = [(1, 43, 6), (2, 43, 6), (1, 64, 4), (2, 64, 4), (1, 128, 2),
             (2, 128, 2)]


def c8_shapes(ctx, c=8):
    """[(path, sets, W)]: the c = 8 combines of the two-set MSM of the IPA
    and the range proof and of the one-set `msm_device`, W windows of
    their `window_plan(dup=True)`."""
    out = []
    for path, sets in (("ipa_r1cs", 2), ("msm_device", 1)):
        ranges, _, dup = M.window_plan(ctx, c, n_sets=sets, dup=True)
        out.append((path, sets, ranges.shape[0] - sum(g - 1 for _, g in
                                                      dup)))
    return out


def forms(cv, seed, reps, tag, other_shapes):
    ctx = E.CurveCtx(cv)
    nl = ctx.fp.L // 2
    rnd = random.Random(seed)
    pts = [bt.G1.random(rnd, cv) for _ in range(16)]
    proj = E.to_device_points([p + p for p in pts], ctx, "cuda")
    gen = torch.Generator().manual_seed(seed)

    def points(count):
        pick = torch.randint(0, 16, (count,), generator=gen).to("cuda")
        return pack32(proj[:, :, pick], 1).contiguous()

    def record(launch, out, **shape):
        runs = kernel_ms(launch, reps)
        emit({"phase": "form", "curve": cv.name, **shape, "ms_runs": runs,
              "ms": min(runs), "sha256": hashlib.sha256(
                  out.cpu().numpy().tobytes()).hexdigest(), **tag})

    def totals(path, W, G, K, dbl):
        rowsum = points(W * G).reshape(3, nl, W, G)
        colsum = points(W * K).reshape(3, nl, W, K)
        out = torch.empty((3, nl, W), dtype=torch.int32, device="cuda")
        record(lambda: ek.ec_window_totals32(out, rowsum, colsum, dbl, ctx),
               out, form="window_totals", path=path, W=W, G=G, K=K, dbl=dbl)

    def horner(path, sets, wps, c):
        T = points(sets * wps)
        out = torch.empty((3, nl, sets), dtype=torch.int32, device="cuda")
        record(lambda: ek.ec_horner32(out, T, wps, c, ctx), out,
               form="horner", path=path, sets=sets, wps=wps, c=c)

    for path, sets, W in c8_shapes(ctx):
        totals(path, W, 16, 16, 4)
        horner(path, sets, W // sets, 8)
    if other_shapes:
        for shape in TOTALS_AT:
            totals("kernels_at", *shape)
        for shape in HORNER_AT:
            horner("kernels_at", *shape)


def msm_device(n, seed, reps, tag):
    ctx = E.CurveCtx(BLS381)
    rnd = random.Random(seed)
    base = [bt.G1.random(rnd, BLS381) for _ in range(256)]
    pts = [base[i % 256] for i in range(n)]
    ks = [rnd.randrange(BLS381.r) for _ in range(n)]
    sums = [0] * 256
    for i, k in enumerate(ks):
        sums[i % 256] = (sums[i % 256] + k) % BLS381.r
    want = bt.msm_host(base, sums)
    P, affine = E.to_device_points_affine(pts, ctx, "cuda")
    s = E.to_device_scalars(ks, ctx, "cuda")
    c = M.pick_window(n)
    times = []
    for _ in range(1 + reps):
        t0 = time.time()
        got = E.from_device_points(M.msm_device(P, s, ctx, c,
                                                affine=affine), ctx)[0]
        times.append(time.time() - t0)
        if got != want:
            raise AssertionError("msm_device differs from the host sum")
    warm = sorted(times[1:])
    emit({"phase": "msm_device", "n": n, "c": c, "first_seconds": times[0],
          "seconds_p50": warm[len(warm) // 2], "seconds": times[1:], **tag})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lone_chains: no CUDA device", file=sys.stderr)
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
    for cv in (BLS381, BN254, ED25519):
        forms(cv, args.seed, args.reps, tag, cv is not BN254)
    msm_device(args.n, args.seed, 5, tag)
    if hasattr(roofline, "chain_latency"):
        for cv in (BLS381, BN254, ED25519):
            emit({"phase": "chain_latency", "curve": cv.name,
                  **roofline.chain_latency(E.CurveCtx(cv)), **tag})


if __name__ == "__main__":
    main()
