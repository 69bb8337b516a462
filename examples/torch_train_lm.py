# End-to-end LM training example of the PyTorch port: forelem data pipeline
# → packed dataset → fault-tolerant chunked training (hybrid scheduling
# §III-A3) with checkpoint/restart and a simulated mid-run worker failure.
# It runs on the card unless --device cpu; there every attention's gradient
# goes through the flash backward kernel.
#
# The counterpart of examples/train_lm.py: the same corpus, dataset, flags,
# configs, optimizer and printed lines.  Default config is CPU-sized (~8M
# params); ``--full`` selects a ~100M-param config (starcoder2-3b's family,
# head dim 64).  ``--fail-at-step`` simulates one failure: the latest
# checkpoint is restored once and training goes on to ``--steps``.  The
# default checkpoint directory is the port's own: either package restores
# the other's checkpoints, so a shared one would resume from the other's
# final step.  ``main(argv, params=None)`` returns what it printed as a
# dict, with the final state; ``params`` (a state dict) replaces the drawn
# weights.
#
# Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--full] [--device cpu]
import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.data.pipeline import PipelineConfig, ShardedLoader, build_dataset
from repro_torch.models.transformer import Model, resolve_device
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_init
from repro_torch.train.step import TrainSpec, assign_, make_train_step


def synth_corpus(n_docs: int, seed: int = 0) -> List[str]:
    """Markov-ish synthetic text so the loss has learnable structure."""
    rng = np.random.default_rng(seed)
    vocab = [f"tok{i}" for i in range(512)]
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(16, 256))
        state = int(rng.integers(0, 512))
        words = []
        for _ in range(n):
            state = (state * 31 + int(rng.integers(0, 7))) % 512
            words.append(vocab[state])
        docs.append(" ".join(words))
    return docs


def main(argv: Optional[List[str]] = None, params: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="~100M-param config")
    ap.add_argument("--ckpt-dir", default="runs/ckpt_train_lm_torch")
    ap.add_argument("--fail-at-step", type=int, default=-1, help="simulate worker failure")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- data: the forelem pipeline ----------------------------------------
    print("building dataset through the forelem pipeline ...")
    docs = synth_corpus(3000)
    ds = build_dataset(docs, PipelineConfig(seq_len=args.seq, min_doc_tokens=8, vocab_size=1024,
                                            device=str(device)))
    print(f"  {ds.n_docs} docs -> {len(ds)} packed rows, {ds.n_tokens} tokens, vocab {ds.vocab.size}")

    # --- model ----------------------------------------------------------------
    base = get_config("starcoder2-3b")
    if args.full:
        cfg = dataclasses.replace(base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                                  head_dim=64, d_ff=3072, vocab_size=ds.vocab.size, tie_embeddings=True)
    else:
        cfg = dataclasses.replace(reduced_config(base), n_layers=4, d_model=256, n_heads=8,
                                  n_kv_heads=4, head_dim=32, d_ff=1024, vocab_size=ds.vocab.size,
                                  window=args.seq, max_seq_len=args.seq)
    model = Model(cfg, device=device)
    print(f"  model: {model.n_params()/1e6:.1f}M params ({cfg.arch_id} family) on {device}")

    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        model.init_params(gen)
    else:
        model.load_state_dict(params, strict=True)
    params = model.params
    opt_cfg = AdamWConfig(lr_peak=3e-3, warmup_steps=20, total_steps=args.steps)
    opt_state = adamw_init(params)
    train_step = make_train_step(model, opt_cfg, TrainSpec(microbatches=1, remat=False))

    loader = ShardedLoader(ds, global_batch=args.batch)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    def restore() -> int:
        nonlocal opt_state
        last, (p_r, s_r) = ckpt.restore((params, opt_state))
        assign_(params, p_r)
        opt_state = AdamWState(s_r.step, s_r.master, s_r.m, s_r.v)
        return last

    # restore if a checkpoint exists (restart-after-failure path)
    start_step = 0
    if ckpt.latest_step() is not None:
        start_step = restore()
        print(f"  restored from checkpoint at step {start_step}")

    # --- training loop (one chunk of the hybrid schedule = ckpt interval) --
    t0 = time.time()
    losses: List[float] = []
    restored: List[int] = []
    chunk = 25  # static-schedule chunk size; dynamic level = this loop
    step = start_step
    while step < args.steps:
        chunk_end = min(step + chunk, args.steps)
        for s in range(step, chunk_end):
            if s == args.fail_at_step and not restored:
                print(f"  !! simulated worker failure at step {s} — restart from checkpoint")
                ckpt.wait()  # the save in flight is durable once its writer ends
                step = restore()
                restored.append(step)
                print(f"  restored from checkpoint at step {step}")
                break
            batch = {k: torch.from_numpy(v).to(device) for k, v in loader.batch(s).items()}
            params, opt_state, metrics = train_step(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if s % 20 == 0:
                print(f"  step {s:4d}  loss {losses[-1]:.4f}  lr {float(metrics['lr']):.2e}"
                      f"  gnorm {float(metrics['grad_norm']):.2f}")
        else:
            step = chunk_end
            ckpt.save(step, (params, opt_state), blocking=False)
    ckpt.wait()
    dt = time.time() - t0
    tok_s = (args.steps - start_step) * args.batch * args.seq / max(dt, 1e-9)
    print(f"\nfinal loss {losses[-1]:.4f} (from {losses[0]:.4f}); {tok_s:,.0f} tok/s on {device}")
    assert losses[-1] < losses[0], "loss did not improve"
    print("loss improved ✓  checkpoints in", args.ckpt_dir)
    return {
        "device": str(device), "n_docs": ds.n_docs, "n_rows": len(ds), "n_tokens": ds.n_tokens,
        "vocab": ds.vocab.size, "n_params": model.n_params(), "n_layers": cfg.n_layers,
        "start_step": start_step, "final_step": step, "restored_from": restored, "losses": losses,
        "seconds": dt, "tok_s": tok_s,
        "ckpt_dir": args.ckpt_dir, "state": (params, opt_state),
    }


if __name__ == "__main__":
    main()
