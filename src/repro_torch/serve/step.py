# Serving steps: batched prefill + decode with greedy or temperature
# sampling; continuous-batching bookkeeping in launch/serve.py.  The model
# owns its parameters; sampling takes an explicit torch.Generator.
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import torch

from repro_torch.models.transformer import Model


def make_prefill_step(model: Model) -> Callable:
    """prefill(batch) -> (last-position logits (B, V), cache)"""

    def prefill(batch):
        logits, cache = model.prefill(batch)
        return logits[:, -1], cache

    return prefill


def make_decode_step(model: Model, temperature: float = 0.0) -> Callable:
    """decode(cache, tokens (B,1), pos, generator) ->
    (next_tokens (B,1) int32, logits (B,1,V), cache written in place)"""

    def decode(cache, tokens, pos: int, generator: Optional[torch.Generator] = None):
        logits, cache = model.decode_step(cache, {"tokens": tokens, "pos": pos})
        nxt = pick(logits[:, -1], temperature, generator)
        return nxt[:, None], logits, cache

    return decode


def pick(logits: torch.Tensor, temperature: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax (the first of equal maxima) at temperature 0, else a
    draw from softmax(logits / temperature) with ``generator``."""
    last = logits.float()
    if temperature > 0:
        if generator is None:
            raise ValueError("sampling at temperature > 0 takes an explicit torch.Generator")
        probs = torch.softmax(last / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
    return torch.argmax(last, dim=-1).to(torch.int32)


@dataclass
class GenerationResult:
    tokens: torch.Tensor  # (B, S_prompt + steps)
    steps: int
    prefill_s: float = 0.0  # host wall time of the prefill, synchronized
    decode_s: float = 0.0   # host wall time of the decode loop, synchronized
    logits: List[torch.Tensor] = field(default_factory=list)  # (B, V) f32 per step, if kept


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pad_cache(c_pref: Any, c_full: Any) -> Any:
    """Place the prefill cache at the start of the full-length buffers (the
    prefill caches of global layers hold S_prompt positions)."""
    if isinstance(c_pref, dict):
        return {k: pad_cache(c_pref[k], c_full[k]) for k in c_pref}
    if isinstance(c_pref, list):
        return [pad_cache(a, b) for a, b in zip(c_pref, c_full)]
    if c_pref.shape == c_full.shape:
        return c_pref
    c_full[tuple(slice(0, n) for n in c_pref.shape)] = c_pref
    return c_full


@torch.inference_mode()
def generate(
    model: Model,
    prompts: torch.Tensor,  # (B, S_prompt) int
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    feed: Optional[torch.Tensor] = None,
    keep_logits: bool = False,
) -> GenerationResult:
    """Batched generation: one prefill, then ``max_new_tokens - 1`` decode
    steps.  The first token is the argmax of the prefill logits.  ``feed``
    (B, max_new_tokens), when given, is what each step feeds on instead of
    its own pick (teacher forcing); the result's tokens are still the
    picks.  ``keep_logits`` keeps each step's logits in f32."""
    B, Sp = prompts.shape
    device = model.device
    prompts = prompts.to(device)
    max_seq = Sp + max_new_tokens
    t0 = time.perf_counter()
    logits, pcache = model.prefill({"tokens": prompts})
    cache = pad_cache(pcache, model.cache_init(B, max_seq))
    tok = torch.argmax(logits[:, -1].float(), dim=-1)[:, None].to(torch.int32)
    _sync(device)
    t1 = time.perf_counter()
    kept = [logits[:, -1].float()] if keep_logits else []
    out = [tok]
    decode = make_decode_step(model, temperature)
    for t in range(max_new_tokens - 1):
        fed = tok if feed is None else feed[:, t : t + 1].to(device=device, dtype=torch.int32)
        tok, step_logits, cache = decode(cache, fed, Sp + t, generator)
        if keep_logits:
            kept.append(step_logits[:, -1].float())
        out.append(tok)
    _sync(device)
    t2 = time.perf_counter()
    return GenerationResult(
        torch.cat([prompts.to(torch.int32)] + out, dim=1), max_new_tokens,
        prefill_s=t1 - t0, decode_s=t2 - t1, logits=kept,
    )
