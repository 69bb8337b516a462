# KV-cache quantization (int8 per (position, head) over the feature axis):
# halves the decode cache's memory and the bytes each decode step reads
# against bf16.
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.attention import quantize_rows


def quantize_kv(cache: Dict[str, Any]) -> Dict[str, Any]:
    """bf16 {'k','v'} trees -> {'k_q','k_s','v_q','v_s'}: int8 values and
    f16 scales (one scale per (..., head) over the feature axis)."""

    def walk(tree):
        if isinstance(tree, dict) and set(tree) == {"k", "v"}:
            kq, ks = quantize_rows(tree["k"])
            vq, vs = quantize_rows(tree["v"])
            return {"k_q": kq, "k_s": ks, "v_q": vq, "v_s": vs}
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(cache)


def dequantize_kv(cache: Dict[str, Any]) -> Dict[str, Any]:
    def dq(q, s):
        return (q.float() * s.float()).to(torch.bfloat16)

    def walk(tree):
        if isinstance(tree, dict) and "k_q" in tree:
            return {"k": dq(tree["k_q"], tree["k_s"]), "v": dq(tree["v_q"], tree["v_s"])}
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(cache)


def cache_bytes(cache: Any) -> int:
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    if isinstance(cache, (list, tuple)):
        return sum(cache_bytes(v) for v in cache)
    return 0
