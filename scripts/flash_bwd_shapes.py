#!/usr/bin/env python3
# Time the hand-written flash-attention backward kernel at starcoder2-3b's
# training shape beside scaled_dot_product_attention's backward and beside
# another version of the kernel's source when one is given, and hold each
# against the plain backward given the same forward output.  Needs one CUDA
# card.
#
#   python3 scripts/flash_bwd_shapes.py [--seed 0] [--reps 10] [--baseline-source build/old_flash_bwd.cu]
#                                       [--out build/flash_bwd_shapes.json]
#
# The shape is chip_smoke.py's phase 15 microbatch: 2 sequences of 2048
# tokens, 24 query heads over 2 kv heads of 128, bf16, causal; also the
# same with softcap 50 and with a window of 1024.  Each source is timed
# twice, in turns (new, old, old, new), with CUDA events, and the profiler's
# device ms of each of its launches is read over 5 calls.  Every source is given
# the forward kernel's output and row statistics (lse; a source that writes
# its own statistics into that buffer, as the one before the forward
# returned them did, gets a copy).  The bound is chip_smoke.py's.
import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import device_ms, flash_bwd_bound, launch_times, nvidia_smi_line  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash import kernel  # noqa: E402
from repro_torch.kernels.flash.ref import bwd_agreement, flash_attention_bwd_plain  # noqa: E402

B, S, H, HKV, D = 2, 2048, 24, 2, 128
CASES = {"causal": (0, 0.0), "causal softcap 50": (0, 50.0), "causal window 1024": (1024, 0.0)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--baseline-source", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_shapes: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi_line(), flush=True)
    libs = {"kernel": kernel.BWD_LIBRARY}
    if args.baseline_source:
        libs["baseline"] = _build.variant(kernel.BWD_LIBRARY, "flash_bwd_baseline", args.baseline_source)
    for lib in libs.values():
        lib.load()
    kernel.LIBRARY.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    q = torch.randn(B, S, H, D, device="cuda", generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(B, S, HKV, D, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(2))
    dout = torch.randn(B, S, H, D, device="cuda", generator=gen).to(torch.bfloat16)
    rows = []
    for name, (window, cap) in CASES.items():
        kw = dict(causal=True, window=window, scale=D ** -0.5, logit_softcap=cap)
        out, lse = kernel.launch(q, k, v, **kw, with_lse=True)
        lses = {n: lse if n == "kernel" else lse.clone() for n in libs}
        want = flash_attention_bwd_plain(q.double(), k.double(), v.double(), dout.double(), out.double(), **kw)
        row = {"case": name, "bound_ms": flash_bwd_bound(B, S, H, HKV, D, True, window)[0]}
        order = list(libs) + list(reversed(libs))
        for lib_name in order:
            lib, ls = libs[lib_name], lses[lib_name]
            ms = device_ms(torch, lambda: kernel.launch_bwd(q, k, v, out, dout, ls, lib=lib, **kw), reps=args.reps)
            row.setdefault(f"{lib_name}_ms", []).append(ms)
        for lib_name, lib in libs.items():
            ls = lses[lib_name]
            agree = bwd_agreement(kernel.launch_bwd(q, k, v, out, dout, ls, lib=lib, **kw), want)
            row[f"{lib_name}_agreement"] = {x: agree[x] for x in ("ok", "worst", "rel", "max_abs_err")}
            row[f"{lib_name}_launch_ms"] = launch_times(
                torch, lambda: kernel.launch_bwd(q, k, v, out, dout, ls, lib=lib, **kw), "flash_bwd")
        if window == 0 and cap == 0.0:
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=kw["scale"], enable_gqa=True)
            dot = dout.transpose(1, 2)
            row["sdpa_backward_ms"] = device_ms(
                torch, lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True), reps=args.reps)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": nvidia_smi_line(), "rows": rows}, fh, indent=1)
    return 0 if all(r[f"{n}_agreement"]["ok"] for r in rows for n in libs) else 1


if __name__ == "__main__":
    sys.exit(main())
