# Serving steps: batched prefill + decode with greedy or temperature
# sampling; continuous-batching bookkeeping in launch/serve.py.  The model
# owns its parameters; sampling takes an explicit torch.Generator.
#
# On a card the decode step is one CUDA graph (the counterpart of the JAX
# package's jitted step): captured once per cache (its buffers fix the
# model, batch and max_seq) and temperature, after one eager step, then
# replayed, with the token and the position copied into the graph's static
# buffers first.  A case the graph cannot take raises an error that names
# it; it never goes quietly eager.  On the CPU the same step runs eagerly.
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import Model


def make_prefill_step(model: Model) -> Callable:
    """prefill(batch) -> (last-position logits (B, V), cache)"""

    def prefill(batch):
        logits, cache = model.prefill(batch)
        return logits[:, -1], cache

    return prefill


def make_decode_step(model: Model, temperature: float = 0.0, graph: bool = True) -> Callable:
    """decode(cache, tokens (B,1), pos, generator) ->
    (next_tokens (B,1) int32, logits (B,1,V), cache written in place).
    ``pos`` is an int or a 0-dim device tensor.  On a card with ``graph``,
    the first call on a cache runs eagerly and the second captures the
    step; from then on each call replays it.  Its logits are then the
    graph's output buffer, which the next call overwrites (clone to keep
    them); the tokens are a fresh tensor.  ``graph=False`` runs every step
    eagerly (to hold the graph against)."""
    graphs: Dict[tuple, DecodeGraph] = {}
    warmed: set = set()

    def eager(cache, tokens, pos, generator: Optional[torch.Generator] = None):
        logits, cache = model.decode_step(cache, {"tokens": tokens, "pos": pos})
        nxt = pick(logits[:, -1], temperature, generator)
        return nxt[:, None], logits, cache

    if not graph or model.device.type != "cuda":
        return eager

    def decode(cache, tokens, pos, generator: Optional[torch.Generator] = None):
        key = (_cache_key(cache), tuple(tokens.shape), id(generator))
        g = graphs.get(key)
        if g is None:
            if key not in warmed:
                warmed.add(key)
                return eager(cache, tokens, pos, generator)
            g = graphs[key] = DecodeGraph(model, cache, tokens, temperature, generator)
        return (*g.replay(tokens, pos), cache)

    return decode


def _cache_key(cache: Any) -> tuple:
    """The addresses of a cache's buffers: a graph reads and writes these."""
    if isinstance(cache, dict):
        return tuple(x for k in sorted(cache) for x in _cache_key(cache[k]))
    if isinstance(cache, list):
        return tuple(x for c in cache for x in _cache_key(c))
    return (cache.data_ptr(),)


class DecodeGraph:
    """One decode step of ``model`` on ``cache`` captured in a CUDA graph.
    ``replay(tokens, pos)`` copies the token and the position into the
    static buffers, replays, and returns (a clone of the picked tokens, the
    static logits).  Sampling registers ``generator`` with the graph, so
    each replay draws fresh numbers from it."""

    def __init__(self, model: Model, cache: Any, tokens: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator]) -> None:
        device = model.device
        self.tokens = tokens.detach().to(device=device, dtype=torch.int32).clone()
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.graph = torch.cuda.CUDAGraph()
        if temperature > 0:
            if generator is None:
                raise ValueError("sampling at temperature > 0 takes an explicit torch.Generator")
            if generator.device.type != "cuda":
                raise ValueError(f"a decode graph samples with a generator on the card, not on {generator.device}")
            register = getattr(self.graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(f"sampled decoding in a CUDA graph needs CUDAGraph.register_generator_state, "
                                   f"which torch {torch.__version__} lacks")
            register(generator)
        try:
            with torch.cuda.graph(self.graph):
                logits, _ = model.decode_step(cache, {"tokens": self.tokens, "pos": self.pos})
                self.next = pick(logits[:, -1], temperature, generator)[:, None]
                self.logits = logits
        except RuntimeError as e:
            raise RuntimeError(f"capturing the decode step of {model.cfg.arch_id} at batch {tokens.shape[0]} "
                               f"in a CUDA graph failed: {e}") from e

    def replay(self, tokens: torch.Tensor, pos: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        self.tokens.copy_(tokens)
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:
            self.pos.fill_(int(pos))
        self.graph.replay()
        return self.next.clone(), self.logits


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


# the batch axis of each part of a cache: stacked group caches (repeats,
# B, ...), the shared blocks' stacked caches (repeats, invocations, B, ...),
# the remainder layers' and the remainder's shared invocations' (B, ...)
BATCH_AXIS = {"groups": 1, "shared": 2, "remainder": 0, "shared_rem": 0}


def reset_lane_(cache: Dict[str, Any], lane: int) -> None:
    """Zero one batch lane of a cache in place (a slot handed to a new
    request); the buffers stay the ones a captured decode graph reads and
    writes."""
    for key, sub in cache.items():
        axis = BATCH_AXIS[key]
        for _, t in tree_leaves(sub):
            t.select(axis, lane).zero_()


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
    graph: bool = True,
    inputs: Optional[Dict[str, torch.Tensor]] = None,
) -> GenerationResult:
    """Batched generation: one prefill, then ``max_new_tokens - 1`` decode
    steps.  The first token is the argmax of the prefill logits.  ``feed``
    (B, max_new_tokens), when given, is what each step feeds on instead of
    its own pick (teacher forcing); the result's tokens are still the
    picks.  ``keep_logits`` keeps each step's logits in f32.  ``graph``
    replays the decode step as a CUDA graph on a card (make_decode_step).
    ``inputs`` are the prefill's inputs beside the tokens, as
    prefill_forward takes them (a VLM's patch_embeds, patch_mask and 3-axis
    positions)."""
    B, Sp = prompts.shape
    device = model.device
    prompts = prompts.to(device)
    max_seq = Sp + max_new_tokens
    t0 = time.perf_counter()
    logits, pcache = model.prefill({"tokens": prompts, **(inputs or {})})
    cache = pad_cache(pcache, model.cache_init(B, max_seq))
    tok = torch.argmax(logits[:, -1].float(), dim=-1)[:, None].to(torch.int32)
    _sync(device)
    t1 = time.perf_counter()
    kept = [logits[:, -1].float()] if keep_logits else []
    out = [tok]
    decode = make_decode_step(model, temperature, graph)
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
