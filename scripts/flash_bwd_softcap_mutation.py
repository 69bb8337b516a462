#!/usr/bin/env python3
# Show that chip_smoke.py's softcap cases of the flash backward can see the
# softcap's derivative.  The script builds, beside the backward kernel, a
# copy of csrc/flash_bwd.cu with the lines `ds *= 1 - th * th` taken out
# (written to a temporary directory beside a copy of the headers it
# includes, never into the checkout), and holds
# both against the plain backward in float64 under ref.BWD_TOL on phase
# 14's softcap cases: q scaled by 1, 32 and 64 at cap 50.  Needs one CUDA
# card.
#
#   python3 scripts/flash_bwd_softcap_mutation.py [--seed 0] [--out build/flash_bwd_softcap_mutation.json]
#
# Exit 0 when the kernel agrees in every case and the copy without the
# derivative disagrees in every case at q x 32 and q x 64.
import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import FLASH_BWD_CAPS, FLASH_BWD_MASKS, nvidia_smi_line  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash import kernel  # noqa: E402
from repro_torch.kernels.flash.ref import bwd_agreement, flash_attention_bwd_plain  # noqa: E402

DERIVATIVE = "if (CAP) ds *= 1.f - th * th;"
LENGTHS = (200, 2048)
B, HKV, D = 1, 2, 128


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_softcap_mutation: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi_line(), flush=True)
    src = kernel.BWD_SOURCE.read_text()
    n_cut = src.count(DERIVATIVE)
    if n_cut == 0:
        print(f"flash_bwd_softcap_mutation: `{DERIVATIVE}` not in {kernel.BWD_SOURCE}", file=sys.stderr)
        return 1
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        cut = Path(tmp) / "flash_bwd_no_softcap_derivative.cu"
        cut.write_text(src.replace(DERIVATIVE, ""))
        for header in kernel.BWD_SOURCE.parent.glob("*.cuh"):
            (Path(tmp) / header.name).write_text(header.read_text())
        libs = {"kernel": kernel.BWD_LIBRARY,
                "without_derivative": _build.variant(kernel.BWD_LIBRARY, "flash_bwd_no_softcap_derivative", cut)}
        for lib in libs.values():
            lib.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    for S in LENGTHS:
        for G in (1, 12):
            q0 = torch.randn(B, S, HKV * G, D, device="cuda", generator=gen).to(torch.bfloat16)
            k, v = (torch.randn(B, S, HKV, D, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(2))
            dout = torch.randn(B, S, HKV * G, D, device="cuda", generator=gen).to(torch.bfloat16)
            for causal, window in FLASH_BWD_MASKS:
                for cap, q_mul in FLASH_BWD_CAPS:
                    if cap == 0.0:
                        continue
                    kw = dict(causal=causal, window=window, scale=D ** -0.5, logit_softcap=cap)
                    q = q0 * q_mul
                    out, lse = kernel.launch(q, k, v, **kw, with_lse=True)
                    want = flash_attention_bwd_plain(q.double(), k.double(), v.double(), dout.double(),
                                                     out.double(), **kw)
                    row = {"S": S, "G": G, "causal": causal, "window": window, "softcap": cap, "q_mul": q_mul}
                    for name, lib in libs.items():
                        agree = bwd_agreement(kernel.launch_bwd(q, k, v, out, dout, lse, lib=lib, **kw), want)
                        row[name] = {x: agree[x] for x in ("ok", "worst", "rel", "max_abs_err")}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    summary = {}
    for q_mul in sorted({r["q_mul"] for r in rows}):
        sel = [r for r in rows if r["q_mul"] == q_mul]
        summary[f"q*{q_mul}"] = {
            name: {"cases": len(sel), "agree": sum(r[name]["ok"] for r in sel),
                   "worst_min": min(r[name]["worst"] for r in sel), "worst_max": max(r[name]["worst"] for r in sel),
                   "rel_min": min(r[name]["rel"] for r in sel), "rel_max": max(r[name]["rel"] for r in sel)}
            for name in libs}
    print(json.dumps({"lines_cut": n_cut, "summary": summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": nvidia_smi_line(), "lines_cut": n_cut, "summary": summary, "rows": rows}, fh, indent=1)
    kernel_ok = all(r["kernel"]["ok"] for r in rows)
    caught = all(not r["without_derivative"]["ok"] for r in rows if r["q_mul"] >= 32)
    return 0 if kernel_ok and caught else 1


if __name__ == "__main__":
    sys.exit(main())
