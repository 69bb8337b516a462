#!/usr/bin/env python3
# Time the hand-written WKV6 backward kernel (csrc/wkv6_bwd.cu) at rwkv6-3b's
# training microbatch beside the WKV6 forward, and hold it against its plain
# version in float64 (ref.BWD_TOL); print nvcc's ptxas report of its
# kernels.  With --baseline-source, another version of the source (an
# earlier one, or an edited copy under the git-ignored build/, with this
# source's C interface) is timed too, in turns (kernel, baseline, baseline,
# kernel), and held to the same limits; --walk-source does the same for the
# token-by-token walk of commit 1812a4f (scripts/wkv6_bwd_walk.py).  Needs
# one CUDA card.
#
#   python3 scripts/wkv6_bwd_shapes.py [--seed 0] [--out build/wkv6_bwd_shapes.json]
#       [--baseline-source build/wkv6_bwd_old.cu | --walk-source build/wkv6_bwd_walk.cu]
#
# The shape is chip_smoke.py's phase 17 and 18 microbatch: 2 sequences of
# 2048 tokens, 40 heads of 64, bf16, log_w = -exp(N(0, 1)); its bound and
# timer are chip_smoke.py's.
import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src"), os.path.join(ROOT, "scripts")]

from chip_smoke import device_ms, nvidia_smi_line, wkv6_bwd_at_train_shape, wkv6_bwd_inputs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.wkv6 import kernel  # noqa: E402
from repro_torch.kernels.wkv6.ref import bwd_agreement, wkv6_bwd_plain  # noqa: E402
import wkv6_bwd_walk  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    side = ap.add_mutually_exclusive_group()
    side.add_argument("--baseline-source", default=None)
    side.add_argument("--walk-source", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wkv6_bwd_shapes: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi_line(), flush=True)
    libs = {"kernel": kernel.BWD_LIBRARY}
    launch = {"kernel": lambda *xs: kernel.launch_bwd(*xs)}
    if args.baseline_source:
        libs["baseline"] = _build.variant(kernel.BWD_LIBRARY, "wkv6_bwd_baseline", args.baseline_source)
        launch["baseline"] = lambda *xs: kernel.launch_bwd(*xs, lib=libs["baseline"])
    elif args.walk_source:
        libs["baseline"] = wkv6_bwd_walk.library(args.walk_source)
        launch["baseline"] = lambda *xs: wkv6_bwd_walk.launch(libs["baseline"], *xs)
    kernel.LIBRARY.load()
    for name, lib in libs.items():
        lib.load()
        print(f"{name}: {lib.source}", flush=True)
        for line in lib.ptxas_log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("  " + line.split("info    : ")[-1].strip(), flush=True)
    row = wkv6_bwd_at_train_shape(torch, kernel, wkv6_bwd_plain, bwd_agreement, args.seed)
    row["card"] = nvidia_smi_line()
    ok = row["agreement"]["ok"]
    if "baseline" in libs:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed + 18)
        inputs = wkv6_bwd_inputs(torch, gen, *row["shape"], None, False, torch.bfloat16)
        agree = bwd_agreement(launch["baseline"](*inputs),
                              *wkv6_bwd_plain(*inputs, dtype=torch.float64, with_scales=True))
        ok = ok and agree["ok"]
        turns = {"kernel": [], "baseline": []}
        for name in ("kernel", "baseline", "baseline", "kernel"):
            turns[name].append(device_ms(torch, lambda: launch[name](*inputs), reps=10))
        row["turns_ms"] = turns
        row["baseline_agreement"] = agree
        print(f"  in turns: kernel {turns['kernel']} ms, baseline {turns['baseline']} ms; baseline worst/limit "
              f"{agree['worst']:.3g}, rel {agree['rel']:.3g}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(row, fh, indent=1, default=str)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
