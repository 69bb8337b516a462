# input_specs(), after the JAX package's launch/specs.py: stand-ins for
# every model input of every (architecture x shape) cell, as tensors on the
# meta device (shapes and dtypes, nothing allocated).
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models.transformer import cache_init


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Meta tensors for the step function's ``batch`` argument."""
    B, S = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        out: Dict[str, Any] = {}
        if cfg.family == "audio":
            out["frames"] = _meta((B, S, cfg.d_model), torch.bfloat16)
            if cell.kind == "train":
                out["labels"] = _meta((B, S), torch.int32)
        else:
            out["tokens"] = _meta((B, S), torch.int32)
        if cfg.m_rope_sections:
            out["positions"] = _meta((3, B, S), torch.int32)
        return out
    # decode: one new token against a cache of S positions
    return {"tokens": _meta((B, 1), torch.int32), "pos": _meta((), torch.int32)}


def decode_cache_specs(cfg: ArchConfig, cell: ShapeCell) -> Any:
    return cache_init(cfg, cell.global_batch, cell.seq_len, device="meta")
