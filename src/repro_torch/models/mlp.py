# Feed-forward blocks: gated (SwiGLU/GeGLU) and plain MLPs.
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from .common import ParamDef, activation_fn


def mlp_defs(cfg: ArchConfig, d_ff: int = 0) -> Dict[str, ParamDef]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.gated_mlp:
        return {
            "w_gate": ParamDef((d, f), ("embed", "mlp")),
            "w_up": ParamDef((d, f), ("embed", "mlp")),
            "w_down": ParamDef((f, d), ("mlp", "embed")),
        }
    return {
        "w_in": ParamDef((d, f), ("embed", "mlp")),
        "w_out": ParamDef((f, d), ("mlp", "embed")),
    }


def mlp_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    if cfg.gated_mlp:
        return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return act(x @ p["w_in"]) @ p["w_out"]
