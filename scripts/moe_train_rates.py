#!/usr/bin/env python3
# Phase 20 of chip_smoke.py (dbrx-132b trained TRAIN_STEPS steps at its
# published width over TRAIN_CASES["moe"]'s layers, set up as
# chip_smoke.train_path sets it up) at each AdamW peak rate of --lr-peaks
# and each seed of --seeds, on one CUDA card: per run the losses, lb_loss
# and router_z of each step, the share of the tokens that chose the
# busiest expert (the most of any microbatch of the step), the leaves
# without a finite nonzero gradient, and which of chip_smoke's checks
# fail.  The record is written after each run.
#
#   python3 scripts/moe_train_rates.py [--lr-peaks 3e-3,3e-4,1e-4] [--seeds 0]
#       [--out chiprun_out/moe_train_rates.json]
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--lr-peaks", default="3e-3,3e-4,1e-4")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "moe_train_rates.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("moe_train_rates: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.models import moe

    card = cs.nvidia_smi_line()
    print(card, flush=True)
    cs.build_all({"flash": flash_kernel.LIBRARY, "flash_bwd": flash_kernel.BWD_LIBRARY})
    shares: list = []
    orig = moe.route

    def counted(logits, **kw):
        r = orig(logits, **kw)
        counts = torch.bincount(r.expert_ids.reshape(-1), minlength=kw["E"])
        shares.append(counts.max() * kw["K"] / counts.sum())
        return r

    record = {"card": card, "runs": []}
    moe.route = counted
    try:
        for seed in [int(x) for x in args.seeds.split(",")]:
            for lr in [float(x) for x in args.lr_peaks.split(",")]:
                cs.TRAIN_CASES["moe"]["lr_peak"] = lr
                fails = cs.Failures()
                shares.clear()
                rep = cs.train_path(torch, "moe", fails, seed, {})
                steps = rep["steps"]
                per_step = len(shares) // len(steps)
                busiest = [float(max(shares[i * per_step:(i + 1) * per_step])) for i in range(len(steps))]
                run = {"seed": seed, "lr_peak": lr, "losses": [r["loss"] for r in steps],
                       "lb_loss": [r.get("lb_loss") for r in steps], "router_z": [r.get("router_z") for r in steps],
                       "tokens_choosing_busiest_expert": busiest,
                       "leaves_without_gradient": [r["leaves"] - r["leaves_with_gradient"] for r in steps],
                       "step_ms": [r["ms"] for r in steps], "failures": fails.items}
                record["runs"].append(run)
                print(f"seed {seed} lr_peak {lr:g}: losses " + ", ".join(f"{x:.4f}" for x in run["losses"])
                      + "; lb_loss " + ", ".join(f"{x:.3f}" for x in run["lb_loss"])
                      + "; router_z " + ", ".join(f"{x:.4g}" for x in run["router_z"])
                      + "; tokens choosing the busiest expert " + ", ".join(f"{x:.3f}" for x in busiest)
                      + f"; leaves without a gradient {run['leaves_without_gradient']}; "
                      + f"{len(fails.items)} check(s) failed", flush=True)
                os.makedirs(os.path.dirname(args.out), exist_ok=True)
                with open(args.out, "w") as fh:
                    json.dump(record, fh, indent=1)
    finally:
        moe.route = orig
    return 0


if __name__ == "__main__":
    sys.exit(main())
