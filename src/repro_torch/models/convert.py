# Carrying weights and caches across from the JAX package.
#
# The JAX package's trees arrive as nested dicts and lists of numpy arrays
# (``jax.tree.map(np.asarray, tree)``); nothing here imports jax or
# ml_dtypes.  bf16 arrays (numpy's ml_dtypes ``bfloat16``) are viewed as
# int16 and reinterpreted as torch.bfloat16, bit for bit.
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .common import tree_leaves, tree_map


def tensor_from_numpy(a: Any, device: Any = "cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_jax(tree: Any, device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """The JAX package's param tree as the port's state dict: one tensor per
    leaf under its dotted path (``groups.pos0.attn.wq``), ready for
    ``Model.load_state_dict``."""
    return {path: tensor_from_numpy(a, device) for path, a in tree_leaves(tree)}


def cache_from_jax(tree: Any, device: Any = "cpu") -> Any:
    """The JAX package's cache tree as the port's (the same nesting)."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def opt_state_from_jax(state: Any, device: Any = "cpu"):
    """The JAX package's AdamWState (step, master, m, v; numpy leaves, m
    and v f32 arrays or int8 {'q', 's'} dicts) as the port's AdamWState
    with the same nesting."""
    from repro_torch.train.optimizer import AdamWState

    step, master, m, v = state
    conv = lambda tree: tree_map(lambda a: tensor_from_numpy(a, device), tree)  # noqa: E731
    return AdamWState(tensor_from_numpy(step, device), conv(master), conv(m), conv(v))
