#!/usr/bin/env python3
# Whether phase 18 of chip_smoke.py (rwkv6-3b trained TRAIN_STEPS steps at
# its published width, set up as chip_smoke.train_path sets it up) can tell
# one right WKV6 gradient from another.  Four parts, on one CUDA card:
#
# leaves: along the trajectory of the training through this repo's kernel,
#   at each of the first --leaf-steps steps, the gradient of the whole model
#   (every leaf, each layer of a stacked one) on the step's parameters and
#   batch with the WKV6 backward through the plain version
#   (ref.wkv6_bwd_plain in f32, its outputs in the kernel's types), through
#   the walk of commit 1812a4f (scripts/wkv6_bwd_walk.py), through the walk
#   with dy scaled by 1 + 2^-20, and through the kernel.  Each is held
#   against the plain one and the walk's: the relative l2 distance of the
#   whole gradient and of each leaf, the leaf's projection on the other
#   (a scale error), and the share of elements whose sign differs (AdamW's
#   first steps follow the signs).
# sums: at the first step from the first seed, the WKV6 backward calls of
#   --sum-calls (a real layer's inputs and the gradient that reached it)
#   through the kernel, the walk and the plain version in f32, each held
#   against the plain version in f64 after a sum over the batch and the
#   tokens, as a parameter's gradient sums them: dlog_w . log_w (w0's
#   share), dlog_w, dr, dk, dv, and du.  A bias too small to see in any
#   one element shows in such a sum.
# exact: the training from the first seed at the first of --lr-peaks with
#   the WKV6 backward through the plain version in f64 (its outputs in the
#   kernel's types): the losses of the most exact WKV6 gradient the port
#   can take (~5 minutes).
# spread: the training from each seed of --seeds at each AdamW peak rate
#   of --lr-peaks (the first is phase 18's, TRAIN_CASES["wkv6"]): at the
#   first rate through the kernel and through the walk, each with dy
#   scaled by each of the first --nudges factors of NUDGES before the
#   backward; at the others through the kernel, unscaled (2^-20 moves dy by about 8 f32 ulps, far
#   below ref.BWD_TOL); every run's losses, and whether the last is below
#   the first (phase 18's check).  The record is written after each run.
#
#   git show 1812a4f:src/repro_torch/kernels/wkv6/csrc/wkv6_bwd.cu > build/wkv6_bwd_walk.cu
#   python3 scripts/wkv6_train_sensitivity.py --walk-source build/wkv6_bwd_walk.cu \
#       [--parts sums,leaves,exact,spread] [--sum-calls 0,31,64] [--seeds 0,1] [--leaf-steps 5]
#       [--lr-peaks 3e-4,3e-3] [--nudges 5] [--out chiprun_out/wkv6_train_sensitivity.json]
#
# Needs one CUDA card and ~20 minutes for all four parts at one rate.
# --reduced runs the code paths on the CPU at the reduced config and a
# short sequence (the plain backward throughout: on the CPU ops.WKV6
# never reaches the kernel or the walk).
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src"), os.path.join(ROOT, "scripts")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, ShardedLoader, build_dataset  # noqa: E402
from repro_torch.launch.train import batch_on, build_model  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.kernels.wkv6 import kernel, ops as wkv6_ops  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_bwd_plain  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.train.step import TrainSpec, _tree_from_paths, make_train_step, value_and_grad  # noqa: E402

NUDGES = (1.0, 1 + 2 ** -20, 1 - 2 ** -20, 1 + 2 ** -21, 1 - 2 ** -21)
ARCH = "rwkv6-3b"


def setup(seed: int, dev: torch.device, reduced: bool, seq: int):
    """phase 18's data, model and drawn weights from ``seed``."""
    cfg = get_config(ARCH)
    if reduced:
        cfg = reduced_config(cfg)
    docs = cs.zipf_documents(cs.TRAIN_DOCS, cfg.vocab_size - 8, seed)
    ds = build_dataset(docs, PipelineConfig(seq_len=seq, min_doc_tokens=8, vocab_size=cfg.vocab_size,
                                            device=dev.type))
    loader = ShardedLoader(ds, global_batch=cs.TRAIN_GLOBAL_BATCH, seed=seed)
    model = build_model(cfg, dev, seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    cs.spread_rwkv_zero_inits(torch, model, gen)
    return loader, model


def opt_config(lr_peak: float) -> AdamWConfig:
    return AdamWConfig(lr_peak=lr_peak, warmup_steps=10, total_steps=cs.TRAIN_STEPS)


def spec() -> TrainSpec:
    return TrainSpec(microbatches=cs.TRAIN_MICROBATCHES, remat=True)


def restore(model, init: dict) -> None:
    with torch.no_grad():
        for path, p in tree_leaves(model.params):
            p.copy_(init[path])


def train(model, loader, init: dict, dev, lr_peak: float, say=None) -> list:
    """TRAIN_STEPS steps from ``init`` at AdamW's peak rate ``lr_peak`` with
    kernel.launch_bwd as it is set: the losses (each passed to ``say`` as
    it comes)."""
    restore(model, init)
    params = model.params
    opt_state = adamw_init(params, "f32")
    step_fn = make_train_step(model, opt_config(lr_peak), spec())
    losses = []
    for s in range(cs.TRAIN_STEPS):
        params, opt_state, metrics = step_fn(params, opt_state, batch_on(loader, s, dev))
        losses.append(float(metrics["loss"]))
        if say:
            say(s, losses[-1])
    del opt_state, step_fn
    gc.collect()
    return losses


def compare(grads: dict, refs: dict) -> dict:
    """``grads`` (path -> tensor on the card) against each of ``refs``
    (name -> path -> tensor on the host): the whole gradient's relative l2
    distance, each leaf's (a stacked leaf's layers one by one) and its
    projection coefficient (g - ref) . ref / ref . ref, and the share of
    elements whose sign differs."""
    out = {}
    for name, ref in refs.items():
        names, rel, proj = [], [], []
        d2 = n2 = flips = count = 0.0
        for path, g in grads.items():
            r = ref[path].to(g.device)
            a, b = ((t.flatten(1) if path.startswith("groups.") else t.reshape(1, -1)).double() for t in (g, r))
            diff = ((a - b) ** 2).sum(1)
            nb = (b ** 2).sum(1)
            d2 += float(diff.sum())
            n2 += float(nb.sum())
            flips += float(((a > 0) != (b > 0)).logical_and((a != 0) | (b != 0)).sum())
            count += a.numel()
            rel += (diff.sqrt() / nb.sqrt().clamp_min(1e-300)).tolist()
            proj += (((a - b) * b).sum(1) / nb.clamp_min(1e-300)).tolist()
            names += [f"{path}[{i}]" for i in range(a.shape[0])] if path.startswith("groups.") else [path]
            del r, a, b
        out[name] = {"rel": (d2 / max(n2, 1e-300)) ** 0.5, "sign_differs": flips / count, "leaves": names,
                     "leaf_rel": rel, "leaf_proj": proj}
    return out


def summary(c: dict) -> str:
    rel, proj = c["leaf_rel"], c["leaf_proj"]
    worst = max(range(len(rel)), key=rel.__getitem__)
    srt = sorted(rel)
    return (f"rel {c['rel']:.3e}, leaves' rel median {srt[len(srt) // 2]:.3e} max {rel[worst]:.3e} "
            f"({c['leaves'][worst]}), max |projection| {max(abs(p) for p in proj):.3e}, sign differs in "
            f"{100 * c['sign_differs']:.4f}% of elements")


def token_sums(args, outs: dict) -> dict:
    """Each of ``outs`` (name -> the backward's six outputs on ``args``)
    against the plain backward in f64 after the sums over batch and tokens:
    per quantity, the relative l2 distance over the (H, K) sums, that
    distance over the sums' terms' magnitudes, and the mean signed error
    along the true sum's sign over the terms' magnitudes (a shrink or a
    growth)."""
    r, k, v, lw, u, s0, dy, ds = args
    want = wkv6_bwd_plain(r, k, v, lw, u, s0, dy, ds, dtype=torch.float64)

    def quantities(g):
        dr, dk, dv, dlw, du = (t.double() for t in g[:5])
        terms = {"dlog_w . log_w": dlw * lw.double(), "dlog_w": dlw, "dr": dr, "dk": dk, "dv": dv}
        out = {n: (t.sum((0, 1)), t.abs().sum((0, 1))) for n, t in terms.items()}
        out["du"] = (du, du.abs())
        return out

    truth = quantities(want)
    res = {}
    for name, g in outs.items():
        row = {}
        for q, (val, _) in quantities(g).items():
            t, mag = truth[q]
            err = val - t
            row[q] = {"rel": float(err.norm() / t.norm().clamp_min(1e-300)),
                      "over_terms": float(err.norm() / mag.norm().clamp_min(1e-300)),
                      "signed_over_terms": float((err * t.sign() / mag.clamp_min(1e-300)).mean())}
        row["dlog_w elements"] = float((g[3].double() - want[3]).norm() / want[3].norm())
        res[name] = row
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--walk-source", default=None)
    ap.add_argument("--parts", default="sums,leaves,exact,spread")
    ap.add_argument("--sum-calls", default="0,31,64")
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--leaf-steps", type=int, default=5)
    ap.add_argument("--lr-peaks", default=repr(cs.TRAIN_CASES["wkv6"]["lr_peak"]))
    ap.add_argument("--nudges", type=int, default=len(NUDGES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    if args.reduced:
        dev, seq = torch.device("cpu"), 64
    elif not torch.cuda.is_available():
        print("wkv6_train_sensitivity: no CUDA device", file=sys.stderr)
        return 2
    else:
        dev, seq = torch.device("cuda"), cs.TRAIN_SEQ
        print(cs.nvidia_smi_line(), flush=True)
    import wkv6_bwd_walk

    ours = kernel.launch_bwd
    walk_lib = None if args.reduced else wkv6_bwd_walk.library(args.walk_source)

    def walk(r, k, v, lw, u, s0, dy, ds, **kw):
        return wkv6_bwd_walk.launch(walk_lib, r, k, v, lw, u, s0, dy, ds)

    def plain(r, k, v, lw, u, s0, dy, ds, **kw):
        dr, dk, dv, dlw, du, ds0 = wkv6_bwd_plain(r, k, v, lw, u, s0, dy, ds, dtype=torch.float32)
        return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlw, du.to(u.dtype), ds0

    def plain64(r, k, v, lw, u, s0, dy, ds, **kw):
        dr, dk, dv, dlw, du, ds0 = wkv6_bwd_plain(r, k, v, lw, u, s0, dy, ds, dtype=torch.float64)
        return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlw.float(), du.to(u.dtype), ds0.float()

    def nudged(fn, f):
        return fn if f == 1.0 else (lambda r, k, v, lw, u, s0, dy, ds, **kw: fn(r, k, v, lw, u, s0, dy * f, ds))

    seeds = [int(x) for x in args.seeds.split(",")]
    lrs = [float(x) for x in args.lr_peaks.split(",")]
    parts = args.parts.split(",")
    record = {"card": None if args.reduced else cs.nvidia_smi_line(), "lr_peaks": lrs, "sums": [], "leaves": [],
              "spread": {}, "exact": []}

    def save():
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(record, fh)
    loader, model = setup(seeds[0], dev, args.reduced, seq)
    init = {path: p.detach().to("cpu", copy=True) for path, p in tree_leaves(model.params)}

    # sums: the first step's backward calls of --sum-calls, kept and judged
    if "sums" in parts:
        picks, kept = [int(x) for x in args.sum_calls.split(",")], {}

        backward = wkv6_ops._backward

        def keep(*a):
            n = kept.setdefault("n", 0)
            if n in picks:
                kept[n] = [t.clone() if t is not None else None for t in a]
            kept["n"] = n + 1
            return backward(*a)

        wkv6_ops._backward = keep
        value_and_grad(model, model.params, batch_on(loader, 0, dev), spec())
        wkv6_ops._backward = backward
        for n in picks:
            a = kept.pop(n)
            a = [None if t is None else t.contiguous() for t in a]
            a[6] = a[6].float()
            a[7] = None if a[7] is None else a[7].float()
            outs = {"plain f32": plain(*a)} if args.reduced else {
                "kernel": ours(*a), "walk": walk(*a), "plain f32": plain(*a)}
            res = token_sums(a, outs)
            record["sums"].append({"call": n, "log_w_range": [float(a[3].min()), float(a[3].max())], **res})
            for name, row in res.items():
                print(f"call {n}: {name}: dlog_w elements rel {row['dlog_w elements']:.3e}; sums over tokens " + "; ".join(
                    f"{q} rel {x['rel']:.3e} over terms {x['over_terms']:.3e} signed {x['signed_over_terms']:+.3e}"
                    for q, x in row.items() if q != "dlog_w elements"), flush=True)
            del a, outs
        gc.collect()

    # leaves: the kernel's trajectory, each step's gradient four ways
    params = model.params
    leaf_steps = args.leaf_steps if "leaves" in parts else 0
    opt_cfg, tspec = opt_config(lrs[0]), spec()
    opt_state = adamw_init(params, "f32")
    for s in range(leaf_steps):
        t0 = time.perf_counter()
        batch = batch_on(loader, s, dev)
        kernel.launch_bwd = plain
        _, _, g = value_and_grad(model, params, batch, tspec)
        refs = {"plain": {p: t.to("cpu", copy=True) for p, t in g.items()}}
        del g
        row = {"step": s}
        for name, fn in (("walk", walk), ("walk, dy x (1 + 2^-20)", nudged(walk, 1 + 2 ** -20)), ("kernel", ours)):
            kernel.launch_bwd = fn
            loss, _, g = value_and_grad(model, params, batch, tspec)
            row["loss"] = float(loss)
            row[name] = compare(g, refs)
            for ref_name, c in row[name].items():
                print(f"step {s}: {name} against {ref_name}: {summary(c)}", flush=True)
            if name == "walk":
                refs["walk"] = {p: t.to("cpu", copy=True) for p, t in g.items()}
            if name != "kernel":
                del g
        ratio = [k / max(w, 1e-300) for k, w in zip(row["kernel"]["plain"]["leaf_rel"],
                                                      row["walk"]["plain"]["leaf_rel"])]
        top = sorted(range(len(ratio)), key=ratio.__getitem__, reverse=True)[:5]
        print(f"step {s}: loss {row['loss']:.4f}; leaves where the kernel's rel against the plain gradient most "
              f"exceeds the walk's: " + ", ".join(
                  f"{row['kernel']['plain']['leaves'][i]} {row['kernel']['plain']['leaf_rel'][i]:.3e} / "
                  f"{row['walk']['plain']['leaf_rel'][i]:.3e}" for i in top) + f" ({time.perf_counter() - t0:.0f} s)",
              flush=True)
        params, opt_state, metrics = adamw_update(opt_cfg, _tree_from_paths(params, g), opt_state, params)
        del g, refs
        gc.collect()
        record["leaves"].append(row)
    del opt_state
    gc.collect()

    # spread: every seed and rate, both backwards, the nudges; exact: the
    # first seed at the first rate through the plain backward in f64
    for seed in seeds:
        if seed != seeds[0]:
            del model
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            loader, model = setup(seed, dev, args.reduced, seq)
            init = {path: p.detach().to("cpu", copy=True) for path, p in tree_leaves(model.params)}
        for i, lr in enumerate(lrs):
            builds = (("kernel", ours), ("walk", walk)) if i == 0 else (("kernel", ours),)
            for name, fn in builds if "spread" in parts else ():
                for f in NUDGES[:args.nudges] if i == 0 else (1.0,):
                    kernel.launch_bwd = nudged(fn, f)
                    losses = train(model, loader, init, dev, lr)
                    key = f"seed {seed}, lr_peak {lr!r}, {name}, dy x {f!r}"
                    record["spread"][key] = losses
                    print(f"{key}: losses {[round(x, 4) for x in losses]}; last below first: "
                          f"{losses[-1] < losses[0]}", flush=True)
                    save()
            if "exact" in parts and seed == seeds[0] and i == 0:
                t0 = time.perf_counter()
                kernel.launch_bwd = plain64
                record["exact"] = train(model, loader, init, dev, lr, lambda s, x: print(
                    f"seed {seed}, lr_peak {lr!r}, plain f64: step {s} loss {x:.4f} "
                    f"({time.perf_counter() - t0:.0f} s)", flush=True))
                save()
    kernel.launch_bwd = ours
    save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
