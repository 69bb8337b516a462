# Roofline analysis, after the JAX package's roofline/analysis.py, with its
# names: the three terms of each dry-run record (launch/dryrun.py) and the
# dominant one a cell.
#
#   compute term    = dot FLOPs / PEAK_FLOPS          (per device)
#   memory term     = bytes / HBM_BW                  (per device)
#   collective term = sum over mesh axes of the bytes exchanged over the
#                     axis / that axis's link rate    (per device)
#
# The dry run reckons the global step's work and divides it by the devices
# (the reference's dry run compiles the per-device module; the two are the
# same quantity but for the compute the specs replicate, which the
# per-device module counts on every device).
#
# The constants are the H100 SXM5 80GB's datasheet values, not translated
# from the TPU's: bf16 dense tensor-core FLOP/s, HBM3 bytes/s, NVLink 4
# bytes/s a direction a GPU, and one 400 Gb/s network port a GPU.  An axis's
# collectives run over NVLink when its device group lies within one node of
# NODE_GPUS, i.e. when the axis's size times the sizes of the axes after it
# is at most NODE_GPUS; otherwise over the network.
#
# The memory fields differ on purpose from the reference's: ``memory_s``
# takes the traffic of every op as its own kernel (the port runs each op as
# one, and a CUDA graph replays the same kernels), ``memory_fused_s`` the
# traffic with the elementwise ops fused away; the reference's memory_s is
# its fused estimate and its memory_raw_s the unfused one.
from __future__ import annotations

import glob
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

# H100 SXM5 80GB
PEAK_FLOPS = 989e12      # bf16 dense FLOP/s
HBM_BW = 3.35e12         # HBM3 bytes/s
NVLINK_BW = 450e9        # NVLink 4 bytes/s, a direction, a GPU
NET_BW = 50e9            # one 400 Gb/s port a GPU, bytes/s
NODE_GPUS = 8


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    kind: str
    n_params: float
    peak_gb: float
    compute_s: float
    memory_s: float           # every op its own kernel (the port as it runs)
    memory_fused_s: float     # elementwise ops fused away
    collective_s: float
    dominant: str
    model_flops: float        # 6·N·D (train) or 2·N·D (inference), global
    dot_flops_global: float   # per-device dot FLOPs × devices
    useful_ratio: float       # model_flops / dot_flops_global
    roofline_frac: float      # compute_s / max(all terms)
    collective_detail: Dict[str, float]  # seconds an axis group
    note: str = ""


def link_bw(axes: List[str], sizes: List[int], group: str) -> float:
    """The link rate of a collective over ``group`` (axis names joined by
    ','): NVLink if the outermost of its axes, times the axes after it,
    spans at most one node, else the network."""
    first = min(axes.index(a) for a in group.split(","))
    return NVLINK_BW if math.prod(sizes[first:]) <= NODE_GPUS else NET_BW


def active_params(cfg) -> float:
    """Parameters touched per token (MoE counts top_k + shared experts)."""
    from repro_torch.models.transformer import Model

    total = Model(cfg, device="meta").n_params()
    if cfg.moe is None:
        return float(total)
    m = cfg.moe
    expert_p = 3 * cfg.d_model * m.d_ff_expert  # gate+up+down per expert
    inactive = cfg.n_layers * (m.n_experts - m.top_k) * expert_p
    return float(total - inactive)


def model_flops_for(rec: Dict[str, Any], cfg, cell=None) -> float:
    """Useful-math FLOPs for the cell: 6·N_active·tokens (train),
    2·N_active·tokens (fwd-only).  ``cell`` for a shape outside SHAPES."""
    n = active_params(cfg)
    from repro_torch.configs.base import SHAPES

    cell = cell or SHAPES[rec["shape"]]
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    tokens = cell.global_batch  # decode: one token per sequence
    return 2.0 * n * tokens


def analyze_record(rec: Dict[str, Any], cfg=None, cell=None) -> Optional[RooflineRow]:
    if not rec.get("ok"):
        return None
    from repro_torch.configs.base import get_config

    cfg = cfg or get_config(rec["arch"])
    chips = rec["n_devices"]
    ops = rec.get("ops", {})
    flops_chip = ops.get("dot_flops", 0.0)
    axes = list(rec["axes"])
    sizes = [int(s) for s in rec["mesh"].split("x")]
    detail = {g: b / link_bw(axes, sizes, g) for g, b in ops.get("collective_bytes_by_axes", {}).items()}

    compute_s = flops_chip / PEAK_FLOPS
    memory_s = ops.get("traffic_bytes", 0.0) / HBM_BW
    memory_fused_s = ops.get("fused_traffic_bytes", 0.0) / HBM_BW
    collective_s = sum(detail.values())
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops_for(rec, cfg, cell)
    dot_global = flops_chip * chips
    useful = mf / dot_global if dot_global else 0.0
    bound = max(terms.values())
    frac = compute_s / bound if bound > 0 else 0.0
    return RooflineRow(
        arch=rec["arch"],
        shape=rec["shape"],
        mesh=rec["mesh"],
        kind=rec["kind"],
        n_params=rec["n_params"],
        peak_gb=rec["memory"]["peak_device_bytes"] / 1e9,
        compute_s=compute_s,
        memory_s=memory_s,
        memory_fused_s=memory_fused_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=mf,
        dot_flops_global=dot_global,
        useful_ratio=useful,
        roofline_frac=frac,
        collective_detail=detail,
    )


def load_rows(outdir: str = "runs/dryrun_torch", mesh: str = "single") -> List[RooflineRow]:
    rows = []
    for f in sorted(glob.glob(os.path.join(outdir, f"*__{mesh}.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        row = analyze_record(rec)
        if row is not None:
            rows.append(row)
    return rows


def render_table(rows: List[RooflineRow]) -> str:
    hdr = (f"| {'arch':24s} | {'shape':11s} | {'GB/dev':>6s} | {'compute_s':>9s} | {'memory_s':>9s} | "
           f"{'fused_s':>9s} | {'collect_s':>9s} | {'bound':>10s} | {'MF/dot':>6s} | {'roofl%':>6s} |")
    sep = "|" + "-" * (len(hdr) - 2) + "|"
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r.arch:24s} | {r.shape:11s} | {r.peak_gb:6.2f} | {r.compute_s:9.4f} | {r.memory_s:9.4f} | "
            f"{r.memory_fused_s:9.4f} | {r.collective_s:9.4f} | {r.dominant:>10s} | {r.useful_ratio:6.2f} | "
            f"{100 * r.roofline_frac:5.1f}% |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="roofline terms of the dry run's records (H100 SXM5 constants)")
    ap.add_argument("--outdir", default="runs/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    rows = load_rows(args.outdir, args.mesh)
    print(render_table(rows))
    if rows:
        worst = min(rows, key=lambda r: r.roofline_frac)
        collb = max(rows, key=lambda r: r.collective_s / max(r.compute_s, 1e-12))
        print(f"\nworst roofline fraction: {worst.arch} × {worst.shape} ({100 * worst.roofline_frac:.1f}%)")
        print(f"most collective-bound:   {collb.arch} × {collb.shape} "
              f"(coll/compute = {collb.collective_s / max(collb.compute_s, 1e-12):.1f}×)")


if __name__ == "__main__":
    main()
