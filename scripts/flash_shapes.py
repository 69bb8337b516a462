#!/usr/bin/env python3
# Time the hand-written flash-attention kernel at gemma2-9b's prefill shapes
# beside scaled_dot_product_attention and beside an earlier or other version
# of the kernel's source when one is given; hold each against the plain
# version, at those shapes and on the softcap cases of chip_smoke.py's
# phase-6 matrix.  Needs one CUDA card; builds the libraries first, in
# parallel.
#
#   python3 scripts/flash_shapes.py [--seed 0] [--reps 10] [--baseline-source build/old_flash_fwd.cu]
#                                   [--out build/flash_shapes.json]
#
# The shapes are chip_smoke.py's serving scenarios: (a) 8 sequences of 2048
# tokens, (b) one of 8192, and (b)+1 one of 8193 (the consistency prefill),
# 16 query heads over 8 kv heads of 256, bf16, each layer kind of gemma2-9b:
# global (causal) and local (window 4096), softcap 50.  Every kernel is
# timed twice, in turns (new, old, old, new), with CUDA events.  The FLOPs
# and the bound are chip_smoke.py's.
import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import BF16_OPS_PER_S, FLASH_SHAPES, device_ms, flash_cases, flash_flops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash import kernel  # noqa: E402
from repro_torch.kernels.flash.ref import agreement, flash_attention_plain  # noqa: E402

SHAPES = {  # name: (B, S, window)
    "(a) global": (8, 2048, 0),
    "(a) local": (8, 2048, 4096),
    "(b) global": (1, 8192, 0),
    "(b) local": (1, 8192, 4096),
    "(b)+1 global": (1, 8193, 0),
}
H, HKV, D, SOFTCAP = 16, 8, 256, 50.0


def softcap_matrix(libs: dict, seed: int) -> dict:
    """Each library's worst reading against the plain version over the bf16
    softcap cases of chip_smoke.py's phase-6 matrix, apart for the cases
    with q as drawn and those with q scaled so the scores pass the cap."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    worst = {}
    for sq, sk in FLASH_SHAPES:
        for q, k, v, kw, q_mul, _ in flash_cases(torch, torch.bfloat16, sq, sk, gen):
            if kw["logit_softcap"] <= 0:
                continue
            want = flash_attention_plain(q, k, v, **kw)
            for name, lib in libs.items():
                agree = agreement(kernel.launch(q, k, v, lib=lib, **kw), want)
                w = worst.setdefault(f"{name}, q*{q_mul}", {"cases": 0, "failed": 0, "worst": 0.0, "rel": 0.0})
                w["cases"] += 1
                w["failed"] += not agree["ok"]
                w["worst"], w["rel"] = max(w["worst"], agree["worst"]), max(w["rel"], agree["rel"])
    for name, w in worst.items():
        print(f"softcap matrix, {name}: {w['cases'] - w['failed']}/{w['cases']} agree, "
              f"worst/limit {w['worst']:.3g}, rel {w['rel']:.3g}", flush=True)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--baseline-source", default=None, help="an earlier flash_fwd.cu to time beside the kernel")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "flash_shapes.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_shapes: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    libs = {"kernel": kernel.LIBRARY}
    if args.baseline_source:
        # an earlier source may lack flash_fwd_config: bind the launch alone
        libs["baseline"] = _build.variant(kernel.LIBRARY, "flash_fwd_baseline", args.baseline_source,
                                          kernel.configure_launch)
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.load) for lib in libs.values()]:
            fut.result()
    record = {"card": smi, "build_s": {n: lib.build_seconds for n, lib in libs.items()},
              "ptxas_d256": kernel.ptxas_report(D), "shapes": []}
    print("build: " + ", ".join(f"{n} {t:.1f} s" for n, t in record["build_s"].items()), flush=True)
    for line in record["ptxas_d256"]:
        print("  " + line, flush=True)

    for name, (B, S, window) in SHAPES.items():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        q = torch.randn(B, S, H, D, device="cuda", generator=gen).bfloat16()
        k = torch.randn(B, S, HKV, D, device="cuda", generator=gen).bfloat16()
        v = torch.randn(B, S, HKV, D, device="cuda", generator=gen).bfloat16()
        serve = dict(causal=True, window=window, scale=D ** -0.5, logit_softcap=SOFTCAP)
        nocap = dict(causal=True, window=0, scale=D ** -0.5, logit_softcap=0.0)
        flops = {"serve": flash_flops(B, S, S, H, D, True, window), "nocap": flash_flops(B, S, S, H, D, True, 0)}
        row = {"shape": name, "B": B, "S": S, "window": window,
               "bound_ms": flops["serve"] / BF16_OPS_PER_S * 1e3, "bound_nocap_ms": flops["nocap"] / BF16_OPS_PER_S * 1e3}
        want = flash_attention_plain(q, k, v, **serve)
        for lname, lib in libs.items():
            agree = agreement(kernel.launch(q, k, v, lib=lib, **serve), want)
            row[f"{lname} agreement"] = {x: agree[x] for x in ("ok", "worst", "rel", "max_abs_err")}
        del want
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        timed = {}
        order = list(libs) + list(reversed(list(libs)))  # new, old, old, new
        for lname in order:
            lib = libs[lname]
            for tag, kw in (("serve", serve), ("nocap", nocap)):
                t = device_ms(torch, lambda: kernel.launch(q, k, v, lib=lib, **kw), args.reps, warmup=1)
                timed.setdefault(f"{lname} {tag}", []).append(t)
            timed.setdefault("sdpa", []).append(device_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=D ** -0.5, enable_gqa=True),
                args.reps, warmup=1))
        row["ms"] = timed
        best = {key: min(ts) for key, ts in timed.items()}
        row["tflops"] = {key: flops[key.rsplit(" ", 1)[1]] / (ms * 1e9) for key, ms in best.items() if key != "sdpa"}
        record["shapes"].append(row)
        line = (f"{name:<13} bound {row['bound_ms']:.3f} ms (causal {row['bound_nocap_ms']:.3f})  "
                f"SDPA {best['sdpa']:.3f}")
        for lname in libs:
            ag = row[f"{lname} agreement"]
            line += (f" | {lname}: serve {best[lname + ' serve']:.3f} ms ({row['tflops'][lname + ' serve']:.0f} TFLOP/s)"
                     f" causal {best[lname + ' nocap']:.3f} ms = {best[lname + ' nocap'] / best['sdpa']:.2f}x SDPA"
                     f", worst/limit {ag['worst']:.3g} rel {ag['rel']:.3g}{'' if ag['ok'] else ' DISAGREES'}")
        print(line, flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    record["matrix"] = softcap_matrix(libs, args.seed)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
