# Training entry point, after the JAX package's launch/train.py.
#
# Wires together: forelem data pipeline -> sharded loader -> train_step (the
# static schedule) -> dynamic fault-tolerant chunk scheduler (guided
# self-scheduling over step chunks) -> checkpointing -> elastic re-meshing.
# It runs on the card unless --device cpu.  --reduced (the default) runs the
# reduced config at the data's vocabulary; --no-reduced runs the published
# config.  --fail-at simulates a failure at that step: it restores
# the last checkpoint and goes on from it.  At the end it restores its
# final checkpoint and holds it bitwise against the state in memory.  An
# MoE model also logs its lb_loss and router_z (the loss includes them).
# --grad-compress is accepted and changes nothing, as in the JAX package's
# launcher, which never reads it.
#
#   PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
#       --steps 100 --reduced --fail-at 40
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, get_config, reduced_config
from repro_torch.data.pipeline import PackedDataset, PipelineConfig, ShardedLoader, build_dataset
from repro_torch.models.transformer import Model, resolve_device
from repro_torch.sched.elastic import ElasticController
from repro_torch.sched.loop_schedule import GuidedSelfScheduling
from repro_torch.train.checkpoint import CheckpointManager, flatten_with_paths
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_init
from repro_torch.train.step import TrainSpec, assign_, make_train_step


def demo_documents(seed: int, n_docs: int = 2000) -> List[str]:
    """The synthetic corpus of the JAX package's launch/train.py: documents of 30-200 words, each
    word the next of a walk st -> (13 st + 7) mod 256 from a random start."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        st = int(rng.integers(0, 256))
        ws = []
        for _ in range(int(rng.integers(30, 200))):
            st = (st * 13 + 7) % 256
            ws.append(f"w{st}")
        docs.append(" ".join(ws))
    return docs


def batch_on(loader: ShardedLoader, step: int, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in loader.batch(step).items()}


def build_model(cfg: ArchConfig, device: torch.device, seed: int) -> Model:
    """The model to train, its weights drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Model(cfg, device=device).init_params(gen)


def states_equal(a: Any, b: Any) -> bool:
    """Bitwise equality of two (params, AdamWState) trees, leaf by leaf."""
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    return [k for k, _ in fa] == [k for k, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x, y.to(x.device)) for (_, x), (_, y) in zip(fa, fb))


def train(args: argparse.Namespace) -> Dict[str, Any]:
    device = resolve_device(args.device)

    # --- data ---------------------------------------------------------------
    docs = demo_documents(args.seed)
    ds: PackedDataset = build_dataset(docs, PipelineConfig(seq_len=args.seq, min_doc_tokens=8, vocab_size=512,
                                                           device=str(device)))
    loader = ShardedLoader(ds, global_batch=args.global_batch)

    # --- model + step ----------------------------------------------------------
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduced_config(cfg), vocab_size=ds.vocab.size,
                                  window=args.seq, max_seq_len=args.seq)
    model = build_model(cfg, device, args.seed)
    print(f"[train] {args.arch}{' reduced' if args.reduced else ''}: {model.n_params()/1e6:.1f}M params "
          f"on {device}, {len(ds)} rows, vocab {ds.vocab.size}", flush=True)
    params = model.params
    opt_cfg = AdamWConfig(lr_peak=3e-3, warmup_steps=10, total_steps=args.steps)
    opt_state = adamw_init(params)
    step_fn = make_train_step(model, opt_cfg, TrainSpec(microbatches=args.microbatches, remat=False))

    # --- durability + elasticity ------------------------------------------------
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    elastic = ElasticController(n_devices=n_devices, model_parallel=1)

    def restore() -> int:
        nonlocal opt_state
        last, (p_r, s_r) = ckpt.restore((params, opt_state))
        assign_(params, p_r)
        opt_state = AdamWState(s_r.step, s_r.master, s_r.m, s_r.v)
        return last

    start = 0
    resumed: List[int] = []
    if ckpt.latest_step() is not None:
        start = restore()
        resumed.append(start)
        print(f"[train] resumed from step {start}", flush=True)

    # --- the dynamic level of the hybrid schedule (§III-A3): GSS over step
    # chunks; inside a chunk the step is the static schedule ------------------
    gss = GuidedSelfScheduling(min_chunk=args.ckpt_every)
    step = start
    losses: Dict[int, float] = {}
    aux_keys = ("lb_loss", "router_z") if cfg.moe is not None else ()
    aux_log: Dict[str, Dict[int, float]] = {k: {} for k in aux_keys}
    t0 = time.time()
    failed_once = False
    while step < args.steps:
        chunk = min(gss.next_chunk(args.steps - step, 1, 0, []), args.ckpt_every)
        end = min(step + chunk, args.steps)
        for s in range(step, end):
            if s == args.fail_at and not failed_once:
                failed_once = True
                print(f"[train] !! simulated failure at step {s}; re-meshing over survivors + restore",
                      flush=True)
                ckpt.wait()  # the save in flight is durable once its writer ends
                elastic.on_loss(time.time() - t0, 0, ckpt.latest_step() or 0)
                step = restore()
                resumed.append(step)
                print(f"[train] resumed from step {step}", flush=True)
                break
            params, opt_state, metrics = step_fn(params, opt_state, batch_on(loader, s, device))
            losses[s] = float(metrics["loss"])
            for k in aux_keys:
                aux_log[k][s] = float(metrics[k])
            if s % 10 == 0:
                print(f"[train] step {s:5d} loss {losses[s]:.4f} lr {float(metrics['lr']):.2e}"
                      + "".join(f" {k} {aux_log[k][s]:.4f}" for k in aux_keys), flush=True)
        else:
            step = end
            ckpt.save(step, (params, opt_state), blocking=False)
            continue
    ckpt.wait()
    _, final = ckpt.restore((params, opt_state), step)
    bitwise = states_equal((params, opt_state), final)
    print(f"[train] done in {time.time()-t0:.1f}s; final checkpoint at step {step} "
          f"restores bitwise: {bitwise}", flush=True)
    return {"final_step": step, "resumed_from": resumed, "restores_bitwise": bitwise,
            "losses": [losses[s] for s in sorted(losses)], "n_params": model.n_params(),
            "scale_events": len(elastic.events),
            **{k: [v[s] for s in sorted(v)] for k, v in aux_log.items()}}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="the reduced config (default); --no-reduced for the published one")
    ap.add_argument("--ckpt-dir", default="runs/ckpt_launch_train")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="simulate a worker failure at this step (restart from ckpt)")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8+error-feedback gradient sync on the pod axis (accepted as the JAX package's "
                         "launcher accepts it, and unused as there: one card has no pod axis)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    summary = train(parse_args(argv))
    print("[train] summary " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
