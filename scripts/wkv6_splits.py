#!/usr/bin/env python3
# Time the hand-written WKV6 kernel at rwkv6-3b's serving shapes under every
# row split it is built for, beside the split the launch would choose, and
# hold each against the plain version.  Needs one CUDA card; builds the
# kernel library first.
#
#   python3 scripts/wkv6_splits.py [--seed 0] [--reps 10]
#
# The shapes are chip_smoke.py's serving scenarios: (a) 8 sequences of 2048
# tokens, (b) one of 16384, 40 heads of 64, r/k/v in bf16.  A split (KS in
# the source) is the number of threads that share a state column; see
# kernels/wkv6/kernel.py::row_split.
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.kernels.wkv6 import kernel, ops  # noqa: E402
from repro_torch.kernels.wkv6.ref import agreement, wkv6_plain  # noqa: E402

SHAPES = {"a": (8, 2048), "b": (1, 16384)}  # (B, S) at H = 40, K = 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wkv6_splits: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    kernel.library()
    # registers and shared memory of each instance, when this process built it
    for line in kernel.LIBRARY.ptxas_log.splitlines():
        if "Compiling entry" in line or "Used" in line:
            print("  " + line.split("info    : ")[-1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = kernel.row_split
    H, K = 40, 64
    for name, (B, S) in SHAPES.items():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        r, k, v = ((0.5 * torch.randn(B, S, H, K, device="cuda", generator=gen)).bfloat16() for _ in range(3))
        lw = -torch.exp(torch.randn(B, S, H, K, device="cuda", generator=gen))
        u = 0.3 * torch.randn(H, K, device="cuda", generator=gen)
        s0 = torch.zeros(B, H, K, K, device="cuda")
        want_y, want_s = wkv6_plain(r, k, v, lw, u, s0)
        print(f"({name}) B={B} S={S} H={H} K={K}: the launch chooses KS={chosen(B, H, K, sms)}")
        try:
            for ks in kernel.ROW_SPLITS[K]:
                kernel.row_split = lambda *_, ks=ks: ks
                y, st = ops.wkv6(r, k, v, lw, u, s0)
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    ops.wkv6(r, k, v, lw, u, s0)
                end.record()
                torch.cuda.synchronize()
                ay, ast = agreement(y, want_y), agreement(st, want_s)
                print(f"  KS={ks:>2}: {start.elapsed_time(end) / args.reps:.3f} ms  y worst/limit {ay['worst']:.3g}"
                      f" rel {ay['rel']:.3g}, state worst/limit {ast['worst']:.3g}"
                      f" ({'agree' if ay['ok'] and ast['ok'] else 'DISAGREE'})", flush=True)
        finally:
            kernel.row_split = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
