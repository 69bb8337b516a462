#!/usr/bin/env python3
# Time the hand-written segreduce kernel at the calls of chip_smoke.py's main
# path, at the float-sum path's other shapes and over chip_smoke.py's
# phase-3 matrix, beside an earlier version of the kernel's source when one
# is given, in turns (new, old, old, new), with each version's passes from
# the profiler.  Needs one CUDA card; builds the libraries first, in
# parallel.
#
#   python3 scripts/segreduce_shapes.py [--sf 10] [--seed 0] [--reps 10]
#       [--baseline-source build/base/segreduce.cu] [--out chiprun_out/segreduce_shapes.json]
#
# The calls:
#   * the main path's: chip_smoke.py's queries through a Session over its
#     TPC-H generator at SF ``--sf`` (Q15's float sum with presence, the
#     counts and minimums without a float sum);
#   * Q15's call cut to the lengths of the partitioned backend's chunks
#     (phase 12's: 1,024 to 8,388,608 rows, its first rows);
#   * a 60M-row unmasked f32 SUM over a Zipf key (s = 1.1 over 100,000 keys,
#     chip_smoke.zipf_table), whose largest key range holds a tenth of the
#     rows;
#   * the float-sum path's one-launch form against its partition at lengths
#     on both sides of kernel.small_limit, over Q15's first rows (98 key
#     ranges) and over 2,000,001 keys (1,954): the evidence for
#     kernel.SMALL_READS;
#   * phase 3's shapes (N 5,000 and 60M, K 1, 100, 100,001 and 2,000,001,
#     random keys, 60% of rows counted): with a float sum (regime 0 at small
#     K, regime 1 past it) and without one (regimes 2 and 3).  Where a call
#     without a float sum is past the shared-table limit, the path the
#     layout rule did not take (direct atomics into the outputs, or the
#     partition by key range) is timed too, with this source ("other
#     path"): the evidence for the regime 2/3 rule.
# Each call is timed three ways: CUDA events around ``--reps`` eager calls
# (for a small call these read the host's launch), one call's device time
# replayed from a CUDA graph of 10 calls (its kernels and the gaps between
# them, as the partitioned backend replays its chunk kernels), and each pass
# from the profiler (chip_smoke.kernel_passes).  The main path's and the
# chunks' calls also get chip_smoke.time_call's bound, plain version and
# library calls (index_add_).  The baseline reads the same parameter struct
# (fields are only appended to it) and takes its own layout and scratch
# (``earlier_layout``: PR 19's source partitions a float sum at large K
# with int32 keys, in five passes).  Held: int32 sums, min/max and presence
# bitwise against the baseline, and every column of the other path bitwise
# against the rule's; float sums against the plain version in float64
# (chip_smoke.close's tolerances) and reruns bitwise.  Whether the float
# sums' bits equal the baseline's is recorded, not held: their order of
# additions changed.
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import (  # noqa: E402
    ZIPF_KEYS, Recorder, device_ms, kernel_passes, passes_text, smoke_queries, time_call, tpch_tables, zipf_table,
)
import repro_torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.segreduce import kernel, ops, ref  # noqa: E402

CHUNKS = (1024, 1536, 3072, 524_288, 1_048_576, 2_097_152, 8_388_608)
SWEEP = (256, 512, 1024, 2048, 4096, 8192, 16384, 20480, 24576, 32768, 65536)
GRAPH_CALLS = 10
MATRIX_N = (5000, 60_000_000)
MATRIX_K = (1, 100, 100_001, 2_000_001)


def earlier_layout(lay: kernel.Layout, n: int, num_keys: int, n_tables: int, n_values: int, smem: int,
                   sms: int) -> tuple:
    """(layout, scratch) that PR 19's source takes for a call this source
    lays out as ``lay``: regimes 0, 2 and 3 as now; regime 1 as its five
    passes took it (per-warp tables of 8, 4, 2 or 1 warps over ranges of at
    least 32 keys, two ranges an SM, its scatter's per-warp counts in shared
    memory; tiles of 8192 rows; int32 partitioned keys)."""
    if lay.regime != 1:
        return lay, None
    for warps in (8, 4, 2, 1):
        kpb = max(32, min(smem // (warps * n_tables * 4), -(-num_keys // (2 * sms))))
        nb = -(-num_keys // kpb)
        if (8 * nb + 2 * nb + 1) * 4 + 8192 * 2 + 256 <= smem:
            tiles = max(1, -(-n // 8192))
            return kernel.Layout(1, n_buckets=nb, keys_per_bucket=kpb, n_tiles=tiles, reduce_warps=warps), {
                "counts": (tiles * nb, torch.int32), "bucket_start": (nb + 1, torch.int32),
                "part_keys": (n, torch.int32), "part_vals": (n_values * n, torch.int32)}
    raise ValueError("beyond PR 19's key ranges")


def bitwise(a, b) -> bool:
    if a is None or b is None:
        return a is b
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}.get(a.dtype)
    return bool(torch.equal(a.view(view), b.view(view)) if view else torch.equal(a, b))


def graph_ms(fn, calls: int = GRAPH_CALLS, reps: int = 5) -> float:
    """Device ms of one call, from a CUDA graph of ``calls`` calls replayed
    ``reps`` times (no host launch in the window)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del graph
    torch.cuda.empty_cache()
    return ms


def held(got, want, plain, op_names, values) -> dict:
    """The kernel's outputs against the baseline's (``want``, or None) and
    the plain version's in float64: float sums within rtol and atol 1e-5
    (f32) or 1e-2 (bf16, f16: rounded once from f32) of the plain version,
    as chip_smoke.close holds them; the rest bitwise against the baseline
    and equal to the plain version."""
    accs, pres = got
    out = {"plain": bool(torch.equal(pres, plain[1])) if pres is not None else True, "baseline_bits": True}
    for i, (x, w, v, op) in enumerate(zip(accs, plain[0], values, op_names)):
        if op == "sum" and v.dtype.is_floating_point:
            tol = 1e-5 if x.dtype == torch.float32 else 1e-2
            out["plain"] &= bool(torch.allclose(x.double(), w.double(), rtol=tol, atol=tol))
            if want is not None:
                out["float_sum_bits_same"] = out.get("float_sum_bits_same", True) and bitwise(x, want[0][i])
        else:
            out["plain"] &= bool(torch.equal(x, w.to(x.dtype)) or torch.allclose(
                x.double(), w.double(), rtol=0, atol=0, equal_nan=True))
            if want is not None:
                out["baseline_bits"] &= bitwise(x, want[0][i])
    if want is not None and pres is not None:
        out["baseline_bits"] &= bitwise(pres, want[1])
    return out


def in_turns(libs: dict, keys, values, op_names, num_keys, mask, with_presence, reps: int,
             layout: kernel.Layout = None) -> dict:
    """Each library's events ms (best of its turns), graph ms and passes,
    and its outputs held; ``layout`` forces this source's layout."""
    index = keys.device.index or 0
    smem = kernel.library().segreduce_smem_limit(index)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    n, nt = int(keys.shape[0]), len(values) + int(with_presence)
    float_sum = any(op == "sum" and v.dtype.is_floating_point for v, op in zip(values, op_names))
    lay = layout or kernel.table_layout(n, num_keys, nt, smem, sms, float_sum)
    plans = {"kernel": (lay, None)}
    if "baseline" in libs:
        plans["baseline"] = earlier_layout(lay, n, num_keys, nt, len(values), smem, sms)
    # without a float sum past the shared-table limit, the path the rule
    # did not take, with this source
    if layout is None and (lay.regime == 3 or (lay.regime == 2 and not lay.atomic_smem)):
        libs = {**libs, "other path": libs["kernel"]}
        plans["other path"] = (kernel.partition_layout(n, num_keys, nt, smem, sms) if lay.regime == 2 else
                               kernel.direct_layout(n, sms, atomic_smem=False), None)
    calls = {name: (lambda lib=libs[name], lo=lo, sc=sc: kernel.launch(
        keys, values, op_names, num_keys, mask, with_presence, lib=lib, layout=lo, scratch_spec=sc))
        for name, (lo, sc) in plans.items()}
    plain_vals = tuple(v.double() if op == "sum" and v.dtype.is_floating_point else v
                       for v, op in zip(values, op_names))
    plain = ref.fused_segreduce_ref(keys, plain_vals, op_names, num_keys, mask=mask, with_presence=with_presence)
    outs = {name: fn() for name, fn in calls.items()}
    again = calls["kernel"]()
    torch.cuda.synchronize()
    rec = {"regime": lay.regime, "small": lay.small, "n_buckets": lay.n_buckets,
           "rerun_bits": all(bitwise(a, b) for a, b in zip((*outs["kernel"][0], outs["kernel"][1]),
                                                            (*again[0], again[1]))),
           "held": held(outs["kernel"], outs.get("baseline"), plain, op_names, values),
           "ms": {}, "graph_ms": {}, "passes_ms": {}}
    if "baseline" in outs:
        rec["baseline_plain"] = held(outs["baseline"], None, plain, op_names, values)["plain"]
    if "other path" in outs:
        rec["other_path"] = {"regime": plans["other path"][0].regime, "bits_same": all(
            bitwise(a, b) for a, b in zip((*outs["other path"][0], outs["other path"][1]),
                                          (*outs["kernel"][0], outs["kernel"][1])))}
    del outs, again, plain
    order = list(calls) + list(reversed(list(calls)))
    for name in order:
        rec["ms"].setdefault(name, []).append(device_ms(torch, calls[name], reps, warmup=1))
    for name in order:
        rec["graph_ms"].setdefault(name, []).append(graph_ms(calls[name]))
    for name in calls:
        rec["passes_ms"][name] = kernel_passes(torch, calls[name])
    return rec


def report(label: str, rec: dict, extra: dict = None) -> None:
    line = f"{label}: regime {rec['regime']}{' (one launch)' if rec['small'] else ''}"
    for name in rec["ms"]:
        line += f" | {name} {min(rec['ms'][name]):.4f} ms, graph {min(rec['graph_ms'][name]):.4f}"
    for other in ("baseline", "other path"):
        if other in rec["ms"]:
            line += (f" | kernel / {other}, events {min(rec['ms']['kernel']) / min(rec['ms'][other]):.3f}"
                     f", graph {min(rec['graph_ms']['kernel']) / min(rec['graph_ms'][other]):.3f}")
    h = rec["held"]
    line += f" | plain {'ok' if h['plain'] else 'DIFFERS'}, baseline bits {'same' if h['baseline_bits'] else 'DIFFER'}"
    if "float_sum_bits_same" in h:
        line += f" (float sums' {'same' if h['float_sum_bits_same'] else 'differ'})"
    if "other_path" in rec:
        line += (f", other path (regime {rec['other_path']['regime']}) bits "
                 f"{'same' if rec['other_path']['bits_same'] else 'DIFFER'}")
    line += f", reruns {'bitwise' if rec['rerun_bits'] else 'DIFFER'}"
    for key in ("library_ms", "library_all_ms", "bound_ms", "plain_ms"):
        if extra and key in extra:
            line += f" | {key[:-3]} {extra[key]:.4f}"
    print(line, flush=True)
    for name, passes in rec["passes_ms"].items():
        print(f"    {name} passes (ms a launch x launches a call) " + passes_text(passes, 4), flush=True)


def ok(rec: dict) -> bool:
    return rec["held"]["plain"] and rec["held"]["baseline_bits"] and rec["rerun_bits"] and rec.get(
        "baseline_plain", True) and rec.get("other_path", {}).get("bits_same", True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--baseline-source", default=None, help="an earlier segreduce.cu to time beside the kernel")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "segreduce_shapes.json"))
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
    record = {"card": smi, "build_s": {n: lib.build_seconds for n, lib in libs.items()},
              "calls": [], "chunks": [], "zipf": None, "small_n": [], "matrix": []}

    # the main path's calls
    t0 = time.perf_counter()
    tables = tpch_tables(args.sf, args.seed)
    session = repro_torch.Session()
    for name, cols in tables.items():
        session.register(name, **cols)
    recorders = [Recorder(ops, "fused_segreduce"), Recorder(ops, "segreduce")]
    with recorders[0], recorders[1]:
        for label, submit, _, _ in smoke_queries(repro_torch):
            for r in recorders:
                r.label = label
            submit(session)
    del tables, session
    print(f"main path at SF{args.sf:g} in {time.perf_counter() - t0:.1f} s", flush=True)
    q15 = None
    for rec in recorders:
        seen = set()
        for label, cargs, ckw in rec.calls:
            if rec.name == "fused_segreduce":
                keys, values, op_names, num_keys = cargs
                mask, with_presence = ckw.get("mask"), ckw.get("with_presence", True)
            else:
                keys, v, num_keys = cargs[:3]
                values, op_names = (v,), (ckw.get("op", cargs[3] if len(cargs) > 3 else "sum"),)
                mask, with_presence = None, False
            shape = (rec.name, int(keys.shape[0]), num_keys, len(values), mask is not None)
            if shape in seen:
                continue
            seen.add(shape)
            t = {k: v for k, v in time_call(torch, ops, ref, rec.name, cargs, ckw).items() if k != "passes_ms"}
            row = {"call": rec.name, "query": label, **t,
                   "turns": in_turns(libs, keys, tuple(values), tuple(op_names), num_keys, mask, with_presence,
                                     args.reps)}
            record["calls"].append(row)
            report(f"{rec.name:<16} {label:<14} N={t['n']:>9} K={num_keys:>8}", row["turns"], t)
            if label == "q15":
                q15 = (keys, tuple(values), tuple(op_names), num_keys, mask, with_presence)
        rec.calls.clear()
    del recorders

    # Q15's call cut to the partitioned backend's chunk lengths
    keys, values, op_names, num_keys, mask, with_presence = q15
    for n in CHUNKS:
        args_n = (keys[:n].contiguous(), tuple(v[:n].contiguous() for v in values), op_names, num_keys)
        kw = {"mask": mask[:n].contiguous(), "with_presence": with_presence}
        t = {k: v for k, v in time_call(torch, ops, ref, "fused_segreduce", args_n, kw).items() if k != "passes_ms"}
        row = {"n": n, **t, "turns": in_turns(libs, *args_n, kw["mask"], with_presence, args.reps)}
        record["chunks"].append(row)
        report(f"q15 chunk N={n:>9}", row["turns"], t)

    # the one-launch path against the partition on both sides of small_limit
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    wide_keys = torch.randint(0, 2_000_001, (max(SWEEP),), device="cuda", dtype=torch.int32, generator=gen)
    wide_mask = torch.rand(max(SWEEP), device="cuda", generator=gen) < 0.036
    for name, (k, v, m, nk) in {"q15": (keys, values, mask, num_keys),
                                "K=2000001": (wide_keys, values, wide_mask, 2_000_001)}.items():
        for n in SWEEP:
            a = (k[:n].contiguous(), tuple(x[:n].contiguous() for x in v), op_names, nk, m[:n].contiguous(), True)
            lay = kernel.table_layout(n, nk, len(v) + 1, kernel.library().segreduce_smem_limit(0),
                                      torch.cuda.get_device_properties(0).multi_processor_count)
            row = {"keys": name, "n": n}
            for path, small in (("one launch", True), ("partition", False)):
                row[path] = in_turns({"kernel": kernel.LIBRARY}, *a, 3, layout=dataclasses.replace(lay, small=small))
                report(f"small-N {name:<9} N={n:>7} {path:<10}", row[path])
            record["small_n"].append(row)
    del keys, values, mask, q15, wide_keys, wide_mask
    torch.cuda.empty_cache()

    # a 60M-row unmasked f32 SUM over a Zipf key
    z = zipf_table(60_000_000, args.seed)
    zkeys = torch.from_numpy(z["zk"]).cuda()
    zvals = torch.rand(zkeys.shape[0], device="cuda", generator=gen)
    lay = kernel.table_layout(zkeys.shape[0], ZIPF_KEYS, 1, kernel.library().segreduce_smem_limit(0),
                              torch.cuda.get_device_properties(0).multi_processor_count)
    per_range = np.bincount(z["zk"] >> lay.bucket_shift, minlength=lay.n_buckets)
    del z
    t = {k: v for k, v in time_call(torch, ops, ref, "segreduce", (zkeys, zvals, ZIPF_KEYS), {}).items()
         if k != "passes_ms"}
    record["zipf"] = {**t, "largest_range_rows": int(per_range.max()), "pieces": len(kernel.piece_cuts(
        per_range.tolist())), "turns": in_turns(libs, zkeys, (zvals,), ("sum",), ZIPF_KEYS, None, False, args.reps)}
    report(f"zipf N={zkeys.shape[0]} K={ZIPF_KEYS} largest range {per_range.max()} rows", record["zipf"]["turns"], t)
    del zkeys, zvals
    torch.cuda.empty_cache()

    # phase 3's shapes: random keys, 60% of rows counted
    for n in MATRIX_N:
        for num_keys in MATRIX_K:
            keys = torch.randint(0, num_keys, (n,), device="cuda", dtype=torch.int32, generator=gen)
            mask = torch.rand(n, device="cuda", generator=gen) < 0.6
            vi = torch.randint(-1000, 1000, (n,), device="cuda", dtype=torch.int32, generator=gen)
            vf = torch.rand(n, device="cuda", generator=gen)
            vb = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
            every = ((vi, vf, vb) * 3, ("sum",) * 3 + ("max",) * 3 + ("min",) * 3)
            cases = {
                "f32 sum alone": ((vf,), ("sum",), None, False),
                "f32 sum + presence, masked": ((vf,), ("sum",), mask, True),
                "bf16 sum + presence, masked": ((vb,), ("sum",), mask, True),
                "all group, masked": (*every, mask, True),
                "int32 sum alone": ((vi,), ("sum",), None, False),
                "f32 max + presence, masked": ((vf,), ("max",), mask, True),
                "no-float-sum group, masked": ((vi, vi, vi, vf, vf, vb, vb),
                                               ("sum", "max", "min", "max", "min", "max", "min"), mask, True),
            }
            for cname, (values, op_names, m, pres) in cases.items():
                row = {"case": cname, "n": n, "num_keys": num_keys,
                       "turns": in_turns(libs, keys, values, op_names, num_keys, m, pres, args.reps)}
                record["matrix"].append(row)
                report(f"matrix N={n:>9} K={num_keys:>8} {cname}", row["turns"])
            del keys, mask, vi, vf, vb
            torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1, default=str)
    bad = [r for r in record["calls"] + record["chunks"] + [record["zipf"]] + record["matrix"] if not ok(r["turns"])]
    bad += [r for r in record["small_n"] if not (ok(r["one launch"]) and ok(r["partition"]))]
    for r in bad:
        print(f"FAIL {r.get('query') or r.get('case') or ''} {r.get('n')}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
