"""Where the time of the PyTorch/CUDA port's MSM, or of one range proof,
goes on the card.

    python3 scripts/profile_torch_msm.py [--n 65536] [--seed S] [--bits]
    python3 scripts/profile_torch_msm.py --r1cs [--bits] [--seed S]

Default: runs `bulletproofs_tpu_torch.ops.msm.msm_hybrid` on chip_smoke.py's
bench input (n points from 256 repeated bases, scalars uniform mod r, or
bits with --bits), warms up, then:
  - times 5 whole MSMs on the host clock (p50) and, separately, the device
    part (`msm_totals`, ended by a synchronize) and the host Horner tail;
  - traces one MSM with torch.profiler.
--r1cs: the bench's config 2 (chip_smoke.py phase 6: m = 16 aggregated
64-bit range proofs, n = 2048, BLS12-381): one warm-up proof, 3 timed
proofs (p50), then one traced proof; with --bits, the bit-vector MSM's
line follows (its pre-reduction passes show as kernel 3 pairwise and
the elementwise torch around it, its rounds as kernel 2).
The trace gives the device time by kernel, grouped (the port's kernels and
kernel 3's forms, sorts, gathers, elementwise torch) and by name, with the
device's busy time and its idle share of the traced wall.  Prints one JSON
line.  Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import bulletproofs_tpu_torch as bt  # noqa: E402
from bulletproofs_tpu_torch.config import BLS381, using_curve  # noqa: E402
from bulletproofs_tpu_torch.ops import field as fd, msm as M  # noqa: E402
from bulletproofs_tpu_torch.ops.ec import (  # noqa: E402
    CurveCtx, to_device_points_affine, to_device_scalars)
from bulletproofs_tpu_torch.ops.ec_host import G1  # noqa: E402

# (group, substring of the kernel's name), first match wins
GROUPS = (("bucket_rounds_mixed", "bucket_rounds_mixed_kernel"),
          ("bucket_rounds_proj", "bucket_rounds_proj_kernel"),
          ("bucket_round_add", "bucket_round_add_kernel"),
          ("ec_add:gather_sum", "ec_gather_sum_kernel"),
          ("ec_add:window_totals", "ec_window_totals_kernel"),
          ("ec_add:horner", "ec_horner_kernel"),
          ("ec_add:pairwise", "ec_add_kernel"),
          ("sort", "sort"), ("sort", "Sort"), ("sort", "cummax"),
          ("sort", "scan"),
          ("gather_index", "index"), ("gather_index", "gather"))


def group_of(name):
    for group, key in GROUPS:
        if key in name:
            return group
    return "elementwise_other"


def traced(run):
    """Trace one run(): -> (traced wall ms, device busy ms, device ms and
    launches by group, device ms of the 12 costliest kernel names)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_group, launches, by_name, busy_us = {}, {}, {}, 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        g = group_of(ev.name)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3
        launches[g] = launches.get(g, 0) + 1
        by_name[ev.name[:80]] = by_name.get(ev.name[:80], 0.0) + us / 1e3
        busy_us += us
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
            "device_ms_by_group": by_group,
            "kernel_launches_by_group": launches,
            "device_ms_top_names": top}


def profile_msm(args, dev):
    ctx = CurveCtx(BLS381)
    pts, vals, expected = chip_smoke._bench_input(args.n, args.seed,
                                                  args.bits)
    P, affine = to_device_points_affine(pts, ctx, dev)
    s = to_device_scalars(vals, ctx, dev)[None]
    c = M.pick_window(args.n)
    (res,) = M.msm_hybrid(P, s, ctx, c, affine=affine)     # warm-up
    assert res.to_bytes() == expected.to_bytes()
    rounds, pre = M._escalation_memo[(args.n, 1, c, "bls381", None)]

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        M.msm_hybrid(P, s, ctx, c, affine=affine)
        walls.append(time.perf_counter() - t0)
    dev_parts, tails = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        totals, _ = M.msm_totals(P, s, ctx, c, rounds, pre, affine)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ints = fd.limbs_to_ints(totals.permute(1, 2, 0))
        wins = [tuple(ints[3 * j:3 * j + 3])
                for j in range(len(ints) // 3)]
        M._horner(wins, ctx.cv, c)
        dev_parts.append(t1 - t0)
        tails.append(time.perf_counter() - t1)
    med = lambda xs: sorted(xs)[len(xs) // 2]
    return {"n": args.n, "bits": args.bits, "rounds": rounds,
            "pre_reduce": pre, "msm_seconds_p50": med(walls),
            "msm_seconds": walls,
            "device_part_seconds_p50": med(dev_parts),
            "host_tail_seconds_p50": med(tails),
            **traced(lambda: M.msm_hybrid(P, s, ctx, c, affine=affine))}


def profile_r1cs(args, dev):
    """One config-2 proof, as chip_smoke.py phase 6 builds it."""
    ref = json.loads(chip_smoke.R1CS_REFERENCE.read_text())
    m, bits = ref["m"], ref["bits"]
    n = m * 2 * bits
    G, H = bt.get_generators("G", n), bt.get_generators("H", n)
    g, h = G1.from_msg_hash(b"g", BLS381), G1.from_msg_hash(b"h", BLS381)

    def prove(seed):
        prover, _ = chip_smoke._agg_range_prover(seed, m, bits, g, h, dev)
        return lambda: prover.prove(G, H)

    prove(args.seed)()                                     # warm-up
    walls = []
    for k in range(3):
        run = prove(args.seed + 1 + k)
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    return {"r1cs": {"m": m, "bits": bits, "n": n},
            "r1cs_prove_seconds_p50": sorted(walls)[1],
            "r1cs_prove_seconds": walls,
            **traced(prove(args.seed + 4))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--seed", type=int, default=0xBE7C)
    ap.add_argument("--bits", action="store_true")
    ap.add_argument("--r1cs", action="store_true",
                    help="trace one config-2 range proof (and then, with "
                    "--bits, the bit-vector MSM)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_msm: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with using_curve(BLS381):
        if args.r1cs:
            print(json.dumps({**profile_r1cs(args, dev), "card": smi}))
        if args.bits or not args.r1cs:
            print(json.dumps({**profile_msm(args, dev), "card": smi}))


if __name__ == "__main__":
    main()
