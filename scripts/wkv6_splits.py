#!/usr/bin/env python3
# Time the hand-written WKV6 kernel at rwkv6-3b's serving shapes: as the
# launch splits the work, under a range of segment counts of its
# sequence-parallel form, and beside an
# earlier version of the kernel's source when one is given (in turns: new,
# old, old, new); hold each against the plain version.  Needs one CUDA card;
# builds the kernel libraries first.
#
#   python3 scripts/wkv6_splits.py [--seed 0] [--reps 10] [--baseline-source build/old_wkv6.cu]
#                                  [--out build/wkv6_splits.json]
#
# The shapes are chip_smoke.py's serving scenarios: (a) 8 sequences of 2048
# tokens, (b) one of 16384 and (b)+1 one of 16385 (the consistency
# prefill), 40 heads of 64, r/k/v in bf16.  A segment count is how many
# pieces the sequence is cut into (kernels/wkv6/kernel.py::segments).  The earlier source is the
# per-token scan (before the chunked kernel), launched as its own rule
# launched it: one pass at its row split where the heads gave every SM two
# blocks, else 4 blocks an SM of segments at row split 4 (``scan_rule``),
# through the two C functions both sources have.
import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import device_ms, kernel_passes, passes_text  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.wkv6 import kernel  # noqa: E402
from repro_torch.kernels.wkv6.ref import agreement, wkv6_plain  # noqa: E402

SHAPES = {"a": (8, 2048), "b": (1, 16384), "b+1": (1, 16385)}  # (B, S) at H = 40, K = 64
SEGMENT_COUNTS = (1, 2, 3, 4, 7, 10, 14, 20, 26, 33, 40, 52, 64)
H, K = 40, 64


def scan_rule(B: int, H: int, S: int, sms: int) -> tuple:
    """(row split, segments, segment length) as the per-token scan's rule
    chose them at K = 64 (4 columns a thread, 16 tokens staged, 4 blocks an
    SM): one pass at the fewest of the splits 4, 8, 16 that gives every SM
    two blocks, or the most; or, where split 4 cannot give that, segments
    at split 4 that give every SM four blocks."""
    def blocks(ks):
        return B * H * K * ks // (64 * 4)

    if blocks(4) >= 2 * sms:
        return next((ks for ks in (4, 8, 16) if blocks(ks) >= 2 * sms), 16), 1, S
    n = max(1, 4 * sms // blocks(4))
    seg_len = -(-(-(-max(S, 1) // n)) // 16) * 16
    return 4, -(-max(S, 1) // seg_len), seg_len


def launch_scan(lib, r, k, v, lw, u, s0, sms):
    """The earlier source at its own rule (``scan_rule``)."""
    B, S = r.shape[:2]
    ks, n_seg, seg_len = scan_rule(B, H, S, sms)
    y = torch.empty((B, S, H, K), dtype=torch.float32, device=r.device)
    s_out = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(), s0.data_ptr(), y.data_ptr(),
            s_out.data_ptr(), 1, B, S, H, K, ks)
    stream = torch.cuda.current_stream().cuda_stream
    if n_seg == 1:
        rc = lib.load().wkv6_launch(*args, 0, stream)
    else:
        states = torch.empty((B, H, n_seg, K, K), dtype=torch.float32, device=r.device)
        decay = torch.empty((B, H, n_seg, K), dtype=torch.float32, device=r.device)
        rc = lib.load().wkv6_launch_segmented(*args, n_seg, seg_len, states.data_ptr(), decay.data_ptr(), 0, stream)
    if rc != 0:
        raise RuntimeError(f"the earlier wkv6 source failed with cudaError {rc}")
    return y, s_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--baseline-source", default=None, help="the per-token scan's wkv6.cu, to time beside the kernel")
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
                                          kernel.configure_launches)
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.load) for lib in libs.values()]:
            fut.result()
    # registers and shared memory of each instance, when this process built it
    for line in kernel.LIBRARY.ptxas_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.split("info    : ")[-1])
    record = {"card": smi, "info": {}, "shapes": []}
    for dtype in (torch.bfloat16, torch.float32):
        for kk in kernel.HEAD_SIZES:
            for with_y in (True, False):
                info = kernel.library_info(dtype, kk, with_y)
                tag = f"{str(dtype).split('.')[-1]} K={kk} L={kernel.CHUNK} {'scan' if with_y else 'states'}"
                record["info"][tag] = info
                print(f"  {tag}: {info['registers']} registers, {info['smem']} shared bytes, "
                      f"{info['blocks_per_sm']} blocks an SM, {info['spill_bytes']} spilled bytes", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
        print(f"({name}) B={B} S={S} H={H} K={K}: the launch takes {chosen} segment(s) of "
              f"{kernel.segment_length(S, chosen)} tokens, L={kernel.CHUNK}", flush=True)
        row = {"shape": name, "B": B, "S": S, "segments": chosen, "chunk": kernel.CHUNK, "ms": {}}

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
            calls["baseline"] = lambda: launch_scan(libs["baseline"], r, k, v, lw, u, s0, sms)
            ks, n_b, len_b = scan_rule(B, H, S, sms)
            print(f"  baseline: row split {ks}, {n_b} segment(s) of {len_b}", flush=True)
        for tag, fn in calls.items():
            print(f"  {tag}: {check(tag, *fn())}", flush=True)
        for tag in list(calls) + list(reversed(list(calls))):
            row["ms"].setdefault(tag, []).append(device_ms(torch, calls[tag], args.reps))
        best = {tag: min(ts) for tag, ts in row["ms"].items()}
        print("  in turns: " + ", ".join(f"{t} {ms:.4f} ms" for t, ms in best.items())
              + (f"; kernel / baseline {best['kernel'] / best['baseline']:.3f}" if "baseline" in best else ""),
              flush=True)
        row["passes_ms"] = {tag: kernel_passes(torch, fn, prefixes=("wkv6_",)) for tag, fn in calls.items()}
        for tag, passes in row["passes_ms"].items():
            print(f"  {tag} passes (ms a launch x launches a call): " + passes_text(passes), flush=True)
        # a range of segment counts
        for n_seg in SEGMENT_COUNTS:
            if n_seg > 1 and kernel.segment_length(S, n_seg) * (n_seg - 1) >= S:
                continue  # a segment would be empty
            fn = lambda: kernel.launch(r, k, v, lw, u, s0, n_seg=n_seg)  # noqa: E731
            res = check(f"segments={n_seg}", *fn())
            ms = device_ms(torch, fn, args.reps)
            row["ms"][f"segments={n_seg}"] = ms
            print(f"  {n_seg:>2} segment(s) of {kernel.segment_length(S, n_seg):>5}: {ms:.4f} ms  {res}", flush=True)
        record["shapes"].append(row)
        del r, k, v, lw, want_y, want_s
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
