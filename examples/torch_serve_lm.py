# Serving example of the PyTorch port: batched prefill + decode with KV
# cache (bf16 or int8), greedy sampling, on the card (``--device cpu`` runs
# it on the CPU).  On the card every prefill attention runs the flash
# kernel and each decode step replays one CUDA graph.
#
# The counterpart of examples/serve_lm.py: the same flags, weights seeded 0,
# prompts from default_rng(0) and printed lines.  ``--full`` serves the
# published config unreduced (gemma2-9b: 42 layers, d_model 3584).
# ``main(argv, params=None)`` returns what it printed as a dict; ``params``
# (a state dict) replaces the drawn weights.
#
# Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--batch 4] [--new 32] [--full] [--device cpu]
import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models.transformer import Model, resolve_device
from repro_torch.serve.kvcache import cache_bytes, dequantize_kv, quantize_kv
from repro_torch.serve.step import generate


def first_k(tree: Any, path: Tuple[str, ...] = ()) -> Optional[Tuple[str, ...]]:
    """The key path of the first cache tensor named ``k``, the cache's keys
    taken in sorted order (lists in order): the tensor that the JAX
    package's example reads as the cache tree's first leaf (gemma2-9b:
    ``groups/pos0/k``, the first layer's keys)."""
    if isinstance(tree, dict):
        if "k" in tree and isinstance(tree["k"], torch.Tensor):
            return path + ("k",)
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return None
    for key, sub in items:
        found = first_k(sub, path + (key,))
        if found is not None:
            return found
    return None


def at(tree: Any, path: Tuple[str, ...]) -> torch.Tensor:
    for key in path:
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree


def main(argv: Optional[List[str]] = None, params: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--full", action="store_true", help="the published config, unreduced")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced_config(get_config(args.arch))
    model = Model(cfg, device=device)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        model.init_params(gen)
    else:
        model.load_state_dict(params, strict=True)
    width = "published width" if args.full else "reduced"
    print(f"serving {args.arch} ({width}: {model.n_params()/1e6:.1f}M params) on {device}")

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(4, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32))
    prompts = prompts.to(device)

    # --- batched generation ---------------------------------------------------
    launches = flash_ops.LAUNCHES
    t0 = time.time()
    res = generate(model, prompts, max_new_tokens=args.new)
    dt = time.time() - t0
    gen_launches = flash_ops.LAUNCHES - launches
    print(f"generated {args.batch}×{args.new} tokens in {dt:.1f}s "
          f"({args.batch*args.new/dt:.1f} tok/s incl. the kernels' first calls): prefill "
          f"{res.prefill_s*1e3:.1f} ms, decode {res.decode_s*1e3/max(args.new-1, 1):.2f} ms/token, "
          f"{gen_launches} flash launches")
    sample = res.tokens[0, args.prompt_len:args.prompt_len + 12].cpu().numpy()
    print("sample:", sample)

    # --- int8 KV cache (serve-memory optimization) ---------------------------
    launches = flash_ops.LAUNCHES
    with torch.inference_mode():
        logits, cache = model.prefill({"tokens": prompts})
        q = quantize_kv(cache)
        deq = dequantize_kv(q)
        b0, b1 = cache_bytes(cache), cache_bytes(q)
        # error on one k tensor, picked by its key
        path = first_k(cache)
        err = float((at(cache, path).float() - at(deq, path).float()).abs().max()) if path else 0.0
        finite = bool(torch.isfinite(logits).all())
    prefill_launches = flash_ops.LAUNCHES - launches
    where = "/".join(path) if path else "no k tensor"
    print(f"int8 KV cache: {b0/1e6:.2f} MB -> {b1/1e6:.2f} MB ({b0/max(b1,1):.2f}x), max abs err {err:.4f} "
          f"({where})")
    return {
        "device": str(device), "n_params": model.n_params(), "n_layers": cfg.n_layers,
        "tokens": res.tokens.cpu(), "sample": sample, "seconds": dt,
        "prefill_ms": res.prefill_s * 1e3, "decode_ms_per_token": res.decode_s * 1e3 / max(args.new - 1, 1),
        "flash_launches": {"generate": gen_launches, "prefill": prefill_launches},
        "cache_bytes": b0, "int8_cache_bytes": b1, "k_path": path, "max_abs_err": err,
        "prefill_logits_finite": finite,
    }


if __name__ == "__main__":
    main()
