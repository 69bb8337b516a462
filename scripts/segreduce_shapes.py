#!/usr/bin/env python3
# Time the hand-written segreduce kernel at the calls chip_smoke.py's main
# path makes (its phase 5) and over the cases of its phase-3 matrix that run
# without a float sum, beside an earlier or other version of the kernel's
# source when one is given, in turns (new, old, old, new), with each
# version's passes from the profiler.  Needs one CUDA card; builds the
# libraries first, in parallel.
#
#   python3 scripts/segreduce_shapes.py [--sf 10] [--seed 0] [--reps 10]
#       [--baseline-source build/old_segreduce.cu] [--out build/segreduce_shapes.json]
#
# The main path's calls are captured by running chip_smoke.py's queries over
# its TPC-H generator; each is timed by chip_smoke.time_call (kernel, plain
# version, the library yardsticks, the bound) and then in turns against the
# baseline.  An earlier source reads the same parameter struct (fields are
# only ever appended to it) and takes its own layout: without a float sum
# at the time, one atomic pass through a global table of every key
# (``earlier_layout``).  Where the call runs without a float sum past the
# shared-table limit, the path the layout rule did not take is timed too
# ("other path").  Every result is held bitwise against the kernel's.
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import Failures, device_ms, kernel_passes, main_path, passes_text, time_call, tpch_tables  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.segreduce import kernel, ops, ref  # noqa: E402

MATRIX_N = (5000, 60_000_000)
MATRIX_K = (1, 100, 100_001, 2_000_001)


def earlier_layout(lay: kernel.Layout, n: int, num_keys: int, n_tables: int, smem: int, sms: int) -> kernel.Layout:
    """The layout the earlier source takes: regimes 0 and 1 as now; without
    a float sum, its regime 2 (per-block tables when they fit a quarter of
    shared memory, else none) through a scratch table of every key."""
    if lay.regime in (0, 1):
        return lay
    return kernel.Layout(2, n_blocks=max(1, min(sms * 8, -(-n // (256 * 16)))),
                         atomic_smem=n_tables * num_keys * 4 <= smem // 4, scratch_words=n_tables * num_keys)


def bitwise(a, b) -> bool:
    if a is None or b is None:
        return a is b
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}.get(a.dtype)
    return bool(torch.equal(a.view(view), b.view(view)) if view else torch.equal(a, b))


def in_turns(libs: dict, keys, values, op_names, num_keys, mask, with_presence, reps: int) -> dict:
    """Each library's device ms (best of its turns), its passes, and whether
    its outputs equal the kernel's bit for bit."""
    index = keys.device.index or 0
    smem = kernel.library().segreduce_smem_limit(index)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    n, nt = int(keys.shape[0]), len(values) + int(with_presence)
    float_sum = any(op == "sum" and v.dtype.is_floating_point for v, op in zip(values, op_names))
    lay = kernel.table_layout(n, num_keys, nt, smem, sms, float_sum)
    layouts = {"kernel": lay, "baseline": earlier_layout(lay, n, num_keys, nt, smem, sms)}
    # without a float sum past the shared-table limit, the path the rule did
    # not take (direct atomics into the outputs, or the partition), with
    # this source: the evidence for the rule
    if lay.regime == 3 or (lay.regime == 2 and not lay.atomic_smem):
        libs = {**libs, "other path": libs["kernel"]}
        layouts["other path"] = (kernel.partition_layout(n, num_keys, nt, smem, sms) if lay.regime == 2 else
                                 kernel.direct_layout(n, sms, atomic_smem=False))
    calls = {name: (lambda lib=lib, lo=layouts[name]: kernel.launch(
        keys, values, op_names, num_keys, mask, with_presence, lib=lib, layout=lo)) for name, lib in libs.items()}
    want = calls["kernel"]()
    out = {"regime": lay.regime, "ms": {}, "passes_ms": {}, "same_bits": {}}
    for name, fn in calls.items():
        got = fn()
        out["same_bits"][name] = all(bitwise(a, b) for a, b in zip((*got[0], got[1]), (*want[0], want[1])))
    order = list(libs) + list(reversed(list(libs)))
    for name in order:
        out["ms"].setdefault(name, []).append(device_ms(torch, calls[name], reps, warmup=1))
    for name in libs:
        out["passes_ms"][name] = kernel_passes(torch, calls[name])
    return out


def report(label: str, row: dict) -> None:
    best = {name: min(ts) for name, ts in row["turns"]["ms"].items()}
    line = f"{label}: regime {row['turns']['regime']}"
    for name, ms in best.items():
        line += f" | {name} {ms:.3f} ms" + ("" if row["turns"]["same_bits"][name] else " DIFFERENT BITS")
    for other in ("baseline", "other path"):
        if other in best:
            line += f" | kernel / {other} {best['kernel'] / best[other]:.3f}"
    for key in ("library_ms", "library_all_ms", "bound_ms"):
        if key in row:
            line += f" | {key[:-3]} {row[key]:.3f}"
    print(line, flush=True)
    for name, passes in row["turns"]["passes_ms"].items():
        print(f"    {name} passes (ms a launch x launches a call) " + passes_text(passes, 3), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--baseline-source", default=None, help="an earlier segreduce.cu to time beside the kernel")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "segreduce_shapes.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("segreduce_shapes: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    libs = {"kernel": kernel.LIBRARY}
    if args.baseline_source:
        libs["baseline"] = _build.variant(kernel.LIBRARY, "segreduce_baseline", args.baseline_source)
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.load) for lib in libs.values()]:
            fut.result()
    record = {"card": smi, "build_s": {n: lib.build_seconds for n, lib in libs.items()}, "calls": [], "matrix": []}

    # the main path's calls (chip_smoke.py phases 4 and 5)
    fails = Failures()
    t0 = time.perf_counter()
    tables = tpch_tables(args.sf, args.seed)
    _, _, recorders = main_path(torch, repro_torch, ops, tables, fails)
    del tables
    print(f"main path at SF{args.sf:g} in {time.perf_counter() - t0:.1f} s", flush=True)
    for rec in recorders:
        seen = set()
        for label, cargs, ckw in rec.calls:
            if rec.name == "fused_segreduce":
                keys, values, op_names, num_keys = cargs
                mask, with_presence = ckw.get("mask"), ckw.get("with_presence", True)
            else:
                keys, v, num_keys = cargs[:3]
                values, op_names, mask, with_presence = (v,), (ckw.get("op", cargs[3] if len(cargs) > 3 else "sum"),), None, False
            shape = (rec.name, int(keys.shape[0]), num_keys, len(values), mask is not None)
            if shape in seen:
                continue
            seen.add(shape)
            row = {"call": rec.name, "query": label, "n": shape[1], "num_keys": num_keys, "n_aggs": len(values),
                   **{k: v for k, v in time_call(torch, ops, ref, rec.name, cargs, ckw).items()
                      if k in ("ok", "ms", "plain_ms", "library_ms", "library_all_ms", "bound_ms", "bound_by")}}
            row["turns"] = in_turns(libs, keys, tuple(values), tuple(op_names), num_keys, mask, with_presence,
                                    args.reps)
            record["calls"].append(row)
            report(f"{rec.name:<16} {label:<14} N={row['n']:>9} K={num_keys:>8}", row)
        rec.calls.clear()
    del recorders
    torch.cuda.empty_cache()

    # phase 3's shapes without a float sum: random keys, 60% of rows counted
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    for n in MATRIX_N:
        for num_keys in MATRIX_K:
            keys = torch.randint(0, num_keys, (n,), device="cuda", dtype=torch.int32, generator=gen)
            mask = torch.rand(n, device="cuda", generator=gen) < 0.6
            vi = torch.randint(-1000, 1000, (n,), device="cuda", dtype=torch.int32, generator=gen)
            vf = torch.rand(n, device="cuda", generator=gen)
            vb = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
            cases = {
                "int32 sum alone": ((vi,), ("sum",), None, False),
                "f32 max + presence, masked": ((vf,), ("max",), mask, True),
                "no-float-sum group, masked": ((vi, vi, vi, vf, vf, vb, vb),
                                               ("sum", "max", "min", "max", "min", "max", "min"), mask, True),
            }
            for cname, (values, op_names, m, pres) in cases.items():
                row = {"case": cname, "n": n, "num_keys": num_keys,
                       "turns": in_turns(libs, keys, values, op_names, num_keys, m, pres, args.reps)}
                record["matrix"].append(row)
                report(f"matrix N={n:>9} K={num_keys:>8} {cname}", row)
            del keys, mask, vi, vf, vb
            torch.cuda.empty_cache()
    for f in fails.items:
        print(f"FAIL {f}", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1, default=str)
    bad = [r for r in record["calls"] + record["matrix"] if not all(r["turns"]["same_bits"].values())]
    return 1 if (fails.items or bad or not all(r.get("ok", True) for r in record["calls"])) else 0


if __name__ == "__main__":
    sys.exit(main())
