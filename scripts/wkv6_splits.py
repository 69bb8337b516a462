#!/usr/bin/env python3
# Time the hand-written WKV6 kernel at rwkv6-3b's serving shapes: as the
# launch splits the work, under every row split it is built for in one pass,
# under a range of segment counts of its sequence-parallel form, and beside
# an earlier or other version of the kernel's source when one is given (in
# turns: new, old, old, new); hold each against the plain version.  Needs one
# CUDA card; builds the kernel libraries first.
#
#   python3 scripts/wkv6_splits.py [--seed 0] [--reps 10] [--baseline-source build/old_wkv6.cu]
#                                  [--out build/wkv6_splits.json]
#
# The shapes are chip_smoke.py's serving scenarios: (a) 8 sequences of 2048
# tokens, (b) one of 16384 and (b)+1 one of 16385 (the consistency
# prefill), 40 heads of 64, r/k/v in bf16.  A split (KS in the source) is
# the number of threads that share a state column (kernels/wkv6/kernel.py::
# row_split); a segment count, how many pieces the sequence is cut into
# (kernel.segments).  An earlier source is launched in one pass, at the row
# split of row_split, through the C function every version has.
import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import device_ms, kernel_passes  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.wkv6 import kernel  # noqa: E402
from repro_torch.kernels.wkv6.ref import agreement, wkv6_plain  # noqa: E402

SHAPES = {"a": (8, 2048), "b": (1, 16384), "b+1": (1, 16385)}  # (B, S) at H = 40, K = 64
SEGMENT_COUNTS = (4, 7, 8, 10, 13, 16, 20, 26)
H, K = 40, 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--baseline-source", default=None, help="an earlier wkv6.cu to time beside the kernel")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "wkv6_splits.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wkv6_splits: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    libs = {"kernel": kernel.LIBRARY}
    if args.baseline_source:
        libs["baseline"] = _build.variant(kernel.LIBRARY, "wkv6_baseline", args.baseline_source,
                                          kernel.configure_single)
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.load) for lib in libs.values()]:
            fut.result()
    # registers and shared memory of each instance, when this process built it
    for line in kernel.LIBRARY.ptxas_log.splitlines():
        if "Compiling entry" in line or "Used" in line:
            print("  " + line.split("info    : ")[-1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    record = {"card": smi, "shapes": []}
    failed = False
    for name, (B, S) in SHAPES.items():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        r, k, v = ((0.5 * torch.randn(B, S, H, K, device="cuda", generator=gen)).bfloat16() for _ in range(3))
        lw = -torch.exp(torch.randn(B, S, H, K, device="cuda", generator=gen))
        u = 0.3 * torch.randn(H, K, device="cuda", generator=gen)
        s0 = torch.zeros(B, H, K, K, device="cuda")
        want_y, want_s = wkv6_plain(r, k, v, lw, u, s0)
        chosen = kernel.segments(B, H, S, K, sms)
        print(f"({name}) B={B} S={S} H={H} K={K}: the launch takes {chosen} segment(s), "
              f"KS={kernel.row_split(B, H, K, sms) if chosen == 1 else kernel.ROW_SPLITS[K][0]}", flush=True)
        row = {"shape": name, "B": B, "S": S, "segments": chosen, "ms": {}}

        def check(tag, y, st):
            nonlocal failed
            ay, ast = agreement(y, want_y), agreement(st, want_s)
            ok = ay["ok"] and ast["ok"]
            failed |= not ok
            row.setdefault("agreement", {})[tag] = {"y": ay["worst"], "state": ast["worst"], "ok": ok}
            return f"y worst/limit {ay['worst']:.3g} rel {ay['rel']:.3g}, state {ast['worst']:.3g}" + (
                "" if ok else " DISAGREE")

        # in turns against the baseline: new, old, old, new
        calls = {"kernel": lambda: kernel.launch(r, k, v, lw, u, s0)}
        if "baseline" in libs:
            calls["baseline"] = lambda: kernel.launch(r, k, v, lw, u, s0, lib=libs["baseline"], n_seg=1)
        for tag, fn in calls.items():
            print(f"  {tag}: {check(tag, *fn())}", flush=True)
        for tag in list(calls) + list(reversed(list(calls))):
            row["ms"].setdefault(tag, []).append(device_ms(torch, calls[tag], args.reps))
        best = {tag: min(ts) for tag, ts in row["ms"].items()}
        print("  in turns: " + ", ".join(f"{t} {ms:.3f} ms" for t, ms in best.items())
              + (f"; kernel / baseline {best['kernel'] / best['baseline']:.3f}" if "baseline" in best else ""),
              flush=True)
        row["passes_ms"] = kernel_passes(torch, calls["kernel"], prefixes=("wkv6_",))
        print("  passes " + "  ".join(f"{k} {v:.3f}" for k, v in row["passes_ms"].items()), flush=True)
        # every built row split in one pass, then segment counts at the fewest split
        for ks in kernel.ROW_SPLITS[K]:
            chosen_split = kernel.row_split
            kernel.row_split = lambda *_, ks=ks: ks
            try:
                fn = lambda: kernel.launch(r, k, v, lw, u, s0, n_seg=1)  # noqa: E731
                res = check(f"KS={ks}", *fn())
                ms = device_ms(torch, fn, args.reps)
            finally:
                kernel.row_split = chosen_split
            row["ms"][f"one pass, KS={ks}"] = ms
            print(f"  one pass, KS={ks:>2}: {ms:.3f} ms  {res}", flush=True)
        for n_seg in SEGMENT_COUNTS if B * H < 2 * sms else ():
            fn = lambda: kernel.launch(r, k, v, lw, u, s0, n_seg=n_seg)  # noqa: E731
            res = check(f"segments={n_seg}", *fn())
            ms = device_ms(torch, fn, args.reps)
            row["ms"][f"segments={n_seg}"] = ms
            print(f"  {n_seg:>2} segments of {kernel.segment_length(S, n_seg)}: {ms:.3f} ms  {res}", flush=True)
        record["shapes"].append(row)
        del r, k, v, lw, want_y, want_s
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
