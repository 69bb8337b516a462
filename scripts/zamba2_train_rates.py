#!/usr/bin/env python3
# Phase 25 of chip_smoke.py (zamba2-7b trained TRAIN_STEPS steps at its
# published width over the scan steps TRAIN_CASES["zamba2"] reckons to fit,
# set up as chip_smoke.train_path sets it up) at each AdamW peak rate of
# --lr-peaks and each seed of --seeds, on one CUDA card: per run the
# losses, gradient norms, step ms and peak memory of each step, the leaves
# without a finite nonzero gradient, and which of chip_smoke's checks fail.
# The record is written after each run.
#
#   python3 scripts/zamba2_train_rates.py [--lr-peaks 1e-4,3e-5,1e-5] [--seeds 0]
#       [--out chiprun_out/zamba2_train_rates.json]
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
    ap.add_argument("--lr-peaks", default="1e-4,3e-5,1e-5")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "zamba2_train_rates.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("zamba2_train_rates: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.flash import kernel as flash_kernel

    card = cs.nvidia_smi_line()
    print(card, flush=True)
    cs.build_all({"flash": flash_kernel.LIBRARY, "flash_bwd": flash_kernel.BWD_LIBRARY})
    record = {"card": card, "runs": []}
    for seed in [int(x) for x in args.seeds.split(",")]:
        for lr in [float(x) for x in args.lr_peaks.split(",")]:
            cs.TRAIN_CASES["zamba2"]["lr_peak"] = lr
            fails = cs.Failures()
            rep = cs.train_path(torch, "zamba2", fails, seed, {})
            steps = rep["steps"]
            run = {"seed": seed, "lr_peak": lr, "layers": rep["layers"], "losses": [r["loss"] for r in steps],
                   "grad_norms": [r["grad_norm"] for r in steps],
                   "leaves_without_gradient": [r["leaves"] - r["leaves_with_gradient"] for r in steps],
                   "step_ms": [r["ms"] for r in steps], "device_ms": [r.get("device_ms") for r in steps],
                   "peak_gib": rep["peak_gib"], "failures": fails.items}
            record["runs"].append(run)
            print(f"seed {seed} lr_peak {lr:g}: losses " + ", ".join(f"{x:.4f}" for x in run["losses"])
                  + "; grad norms " + ", ".join(f"{x:.3g}" for x in run["grad_norms"])
                  + f"; leaves without a gradient {run['leaves_without_gradient']}; peak {run['peak_gib']:.1f} GiB; "
                  + f"{len(fails.items)} check(s) failed", flush=True)
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
