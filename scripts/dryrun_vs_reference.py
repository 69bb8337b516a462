#!/usr/bin/env python3
"""The port's dry-run reckoning against the JAX package's compiled program at
a (2, 4) ("data", "model") fake mesh of eight XLA host devices, on the CPU:
per collective kind, the port's reckoned bytes a device (launch/dryrun.py)
over the bytes hlo_parse reads from the reference's compiled step, and
XLA's memory_analysis() beside the port's memory record.

    PYTHONPATH=src python scripts/dryrun_vs_reference.py [--out cmp.json]

Cases: reduced starcoder2-3b and reduced dbrx-132b at train_4k (every
weight under REPLICATE_BELOW, so only data parallelism and the MoE pins
shard anything), and starcoder2-3b at a medium width (d_model 1024, d_ff
4096, 8 heads of 128, vocabulary 1024; 3 layers) on 16 x 256 tokens, where
FSDP and tensor parallelism shard the weights.  The reference's program is
built by its own launch/dryrun.build_cell with make_production_mesh and
get_config replaced; nothing of the JAX package changes.  This script
imports both packages, as the tests do; it runs on no card.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import dryrun as rd  # noqa: E402
from repro.roofline import hlo_parse  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import ProductionMesh  # noqa: E402

MEDIUM = dict(d_model=1024, d_ff=4096, vocab_size=1024, n_heads=8, head_dim=128)
CASES = (("starcoder2-3b", "reduced", "train_4k"), ("dbrx-132b", "reduced", "train_4k"),
         ("starcoder2-3b", "medium", "train_s"))
TRAIN_S = dict(seq_len=256, global_batch=16, kind="train")


def sized(cfg_mod, cfg, size: str):
    """The reduced config, widened to MEDIUM for ``size`` 'medium'."""
    cfg = cfg_mod.reduced_config(cfg)
    if size == "medium":
        moe = cfg.moe and dataclasses.replace(cfg.moe, d_ff_expert=2048)
        kv = MEDIUM["n_heads"] if cfg.n_kv_heads == cfg.n_heads else 2
        cfg = dataclasses.replace(cfg, n_kv_heads=kv, moe=moe, **MEDIUM)
    return cfg


def reference(arch: str, size: str, shape: str) -> dict:
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    get = rd.get_config
    saved = rd.make_production_mesh, rd.get_config, rd.SHAPES
    rd.make_production_mesh = lambda multi_pod=False: mesh
    rd.get_config = lambda a: sized(jbase, get(a), size)
    rd.SHAPES = dict(rd.SHAPES, train_s=jbase.ShapeCell("train_s", **TRAIN_S))
    try:
        fn, args, mesh, meta = rd.build_cell(arch, shape, False)
        with mesh:
            compiled = fn.lower(*args).compile()
    finally:
        rd.make_production_mesh, rd.get_config, rd.SHAPES = saved
    m = compiled.memory_analysis()
    st = hlo_parse.analyze(compiled.as_text())
    return {"collective_bytes": st.collective_bytes, "n_collectives": st.n_collectives, "dot_flops": st.dot_flops,
            "memory": {"argument_bytes": m.argument_size_in_bytes, "alias_bytes": m.alias_size_in_bytes,
                       "temp_bytes": m.temp_size_in_bytes}}


def port(arch: str, size: str, shape: str) -> dict:
    cell = base.ShapeCell("train_s", **TRAIN_S) if shape == "train_s" else shape
    rec = dryrun.run_cell(arch, cell, False, None, cfg=sized(base, base.get_config(arch), size),
                          mesh=ProductionMesh(("data", "model"), (2, 4)))
    return {"collective_bytes": rec["ops"]["collective_bytes"], "n_collectives": rec["ops"]["n_collectives"],
            "dot_flops": rec["ops"]["dot_flops"], "memory": rec["memory"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = []
    for arch, size, shape in CASES:
        t0 = time.time()
        ref, got = reference(arch, size, shape), port(arch, size, shape)
        kinds = sorted(set(ref["collective_bytes"]) | set(got["collective_bytes"]))
        ratio = {k: (got["collective_bytes"].get(k, 0.0) / ref["collective_bytes"][k]
                     if ref["collective_bytes"].get(k) else None) for k in kinds}
        grad = ("all-reduce", "reduce-scatter")
        ref_grad = sum(ref["collective_bytes"].get(k, 0.0) for k in grad)
        both = sum(got["collective_bytes"].get(k, 0.0) for k in grad) / ref_grad if ref_grad else None
        row = {"arch": arch, "size": size, "shape": shape, "reference": ref, "port": got, "ratio": ratio,
               "ratio_all_reduce_and_reduce_scatter": both, "seconds": time.time() - t0}
        out.append(row)
        print(f"{arch} ({size}) {shape}: reckoned over HLO bytes by kind " + ", ".join(
            f"{k} {got['collective_bytes'].get(k, 0.0):,.0f} / {ref['collective_bytes'].get(k, 0.0):,.0f}"
            + ("" if ratio[k] is None else f" = {ratio[k]:.4f}") for k in kinds)
            + (f"; all-reduce and reduce-scatter together {both:.4f}" if both is not None else ""), flush=True)
        print(f"  memory: XLA argument {ref['memory']['argument_bytes']:,} alias {ref['memory']['alias_bytes']:,} "
              f"temp {ref['memory']['temp_bytes']:,}; port argument {got['memory']['argument_bytes']:,} alias "
              f"{got['memory']['alias_bytes']:,} temp {got['memory']['temp_bytes']:,}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
