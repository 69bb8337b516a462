# Serving CLI: batched prefill + decode with continuous batching
# (finished sequences are replaced from the request queue without stopping
# the decode loop).  Runs on the card, where each decode step replays one
# CUDA graph (serve/step.make_decode_step), unless --device cpu.
#
#   PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
#       --requests 12 --batch 4 --new 24
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models.transformer import Model, resolve_device
from repro_torch.serve.step import make_decode_step, pad_cache, reset_lane_


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch))
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    model = Model(cfg, device=device).init_params(gen)
    print(f"[serve] {args.arch} reduced ({model.n_params()/1e6:.1f}M params) on {device}, "
          f"batch {args.batch}, continuous batching over {args.requests} requests")

    rng = np.random.default_rng(args.seed)
    queue: List[np.ndarray] = [
        rng.integers(4, cfg.vocab_size, args.prompt_len).astype(np.int32)
        for _ in range(args.requests)
    ]
    max_seq = args.prompt_len + args.new
    decode = make_decode_step(model, args.temperature)

    with torch.inference_mode():
        # slot state
        active = [queue.pop(0) for _ in range(min(args.batch, len(queue)))]
        remaining = [args.new] * len(active)
        done = 0
        t0 = time.time()
        tokens_out = 0

        prompts = torch.from_numpy(np.stack(active)).to(device)
        _, cache = model.prefill({"tokens": prompts})
        cache = pad_cache(cache, model.cache_init(len(active), max_seq))
        tok = torch.from_numpy(rng.integers(4, cfg.vocab_size, (len(active), 1)).astype(np.int32)).to(device)
        pos = args.prompt_len
        while done < args.requests and pos < max_seq:
            tok, _, cache = decode(cache, tok, pos, gen)
            tokens_out += len(active)
            pos += 1
            for i in range(len(remaining)):
                remaining[i] -= 1
                if remaining[i] == 0:
                    done += 1
                    if queue:
                        # continuous batching: swap a fresh request into slot i —
                        # reset its cache lane in place (on the card the decode
                        # graph keeps reading the same buffers)
                        queue.pop(0)
                        reset_lane_(cache, i)
                        remaining[i] = args.new
                        print(f"[serve] slot {i}: finished; admitting new request "
                              f"({len(queue)} queued, {done}/{args.requests} done)")
            if all(r <= 0 for r in remaining):
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
    print(f"[serve] {done} finished, {tokens_out} tokens in {dt:.1f}s "
          f"({tokens_out/max(dt,1e-9):.1f} tok/s)")
    return {"done": done, "tokens": tokens_out, "seconds": dt}


if __name__ == "__main__":
    main()
