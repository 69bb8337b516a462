# Sharding-rule engine, after the JAX package's launch/sharding.py, with its
# names: logical axes -> mesh axes with divisibility-aware fallbacks, fed by
# the core.distribution solver's objective (§III-A4: choose one
# distribution for all loops; avoid resharding between them).
#
# Rules are *candidate lists* per logical axis; the first candidate whose
# mesh-axis product divides the dimension (and whose axes are not already
# used by another dimension of the same tensor) wins.  The engine reads a
# mesh's axis names and sizes only (models/shardctx's mesh_axis_names /
# mesh_axis_sizes), so it runs on the one-card DeviceMesh and on the
# production meshes' stand-ins alike.  A spec is shardctx.PartitionSpec, a
# tuple equal to the JAX package's PartitionSpec read as a tuple; a
# NamedSharding pairs it with its mesh and names the DTensor placements it
# stands for (``Shard(dim)`` or ``Replicate()`` per mesh dimension).
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models.common import tree_map
from repro_torch.models.shardctx import PartitionSpec, mesh_axis_names, mesh_axis_sizes
from .mesh import dp_axes, dp_size

P = PartitionSpec
Axis = Union[str, Tuple[str, ...]]
Rules = Dict[str, List[Axis]]


def _axes_size(mesh, ax: Axis) -> int:
    sizes = mesh_axis_sizes(mesh)
    if isinstance(ax, tuple):
        return math.prod(sizes[a] for a in ax)
    return sizes[ax]


def _axis_names(ax: Axis) -> Tuple[str, ...]:
    return ax if isinstance(ax, tuple) else (ax,)


# Tensors below this element count are replicated regardless of rules:
# sharding a (d,) norm scale over 'data' costs a latency-bound all-gather at
# every use for no memory win.
REPLICATE_BELOW = 1 << 19


def spec_from_axes(
    logical: Sequence[Optional[str]], shape: Sequence[int], rules: Rules, mesh
) -> PartitionSpec:
    if math.prod(shape) < REPLICATE_BELOW if shape else True:
        return P()
    parts: List[Optional[Axis]] = []
    used: set = set()
    for dim, name in zip(shape, logical):
        chosen: Optional[Axis] = None
        for cand in rules.get(name, []) if name else []:
            if cand is None:
                break
            names = _axis_names(cand)
            if any(n in used for n in names):
                continue
            if dim % _axes_size(mesh, cand) == 0:
                chosen = cand if len(names) > 1 else names[0]
                used.update(names)
                break
        parts.append(chosen)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


# ---------------------------------------------------------------------------
# Rule sets: the *solved* distributions (core.distribution's chain solver
# picks among candidate option sets; the launcher materializes the winner).
# ---------------------------------------------------------------------------


def train_rules(mesh, cfg: ArchConfig) -> Rules:
    dp = dp_axes(mesh)
    return {
        # tensor-parallel family (the paper's indirect partitioning)
        "vocab": ["model"],
        "q_proj": ["model"],
        "kv_proj": ["model"],
        "mlp": ["model"],
        "ssm_in": ["model"],
        "embed_out": ["model"],
        "experts": [],            # TP-on-mlp baseline; EP is a perf variant
        # FSDP storage axis (the paper's direct partitioning applied to the
        # weight multiset): weights/optimizer state sharded over data
        "embed": ["data"],
        "heads": [],
        "layers": [],
        # activations / inputs
        "batch": [dp if len(dp) > 1 else dp[0]],
        "seq": [],
    }


def decode_rules(mesh, cfg: ArchConfig, cell: ShapeCell) -> Rules:
    dp = dp_axes(mesh)
    r = train_rules(mesh, cfg)
    r.update(
        {
            "batch": [dp if len(dp) > 1 else dp[0]],
            # cache axes: prefer heads on 'model'; fall back to head_dim.
            "kv_heads": ["model"],
            "head_dim": ["model"],   # only used if kv_heads didn't fit
            "kv_seq": ["data"] if cell.global_batch < dp_size(mesh) else [],
            "heads": ["model"],
            "key_dim": ["model"],
            "value_dim": [],
            "act_embed": ["model"],
            "ssm_act": ["model"],
            "state": [],
        }
    )
    if cell.global_batch < dp_size(mesh):
        # long-context single-stream decode: batch unshardable; shard the
        # cache sequence dim over 'data' (sequence parallelism)
        r["batch"] = []
    return r


# ---------------------------------------------------------------------------
# Spec builders
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """Per mesh dimension, ``Shard(d)`` for the tensor dimension d whose
        spec entry names it, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in mesh_axis_names(self.mesh):
            dims = [d for d, part in enumerate(self.spec) if part is not None and axis in _axis_names(part)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def param_pspecs(defs: Any, rules: Rules, mesh) -> Any:
    return tree_map(lambda d: spec_from_axes(d.axes, d.shape, rules, mesh), defs)


def param_shardings(defs: Any, rules: Rules, mesh) -> Any:
    return tree_map(lambda d: NamedSharding(mesh, spec_from_axes(d.axes, d.shape, rules, mesh)), defs)


def tree_shardings_from_axes(abstract: Any, axes_tree: Any, rules: Rules, mesh) -> Any:
    """Shardings for a tree of tensors (caches, batches; on the meta device
    too) given a congruent logical-axes tree: dicts and lists walked
    together, each leaf's axes tuple whole."""
    if isinstance(abstract, dict):
        return {k: tree_shardings_from_axes(v, axes_tree[k], rules, mesh) for k, v in abstract.items()}
    if isinstance(abstract, list):
        return [tree_shardings_from_axes(v, a, rules, mesh) for v, a in zip(abstract, axes_tree)]
    return NamedSharding(mesh, spec_from_axes(axes_tree, tuple(abstract.shape), rules, mesh))


def batch_axes(cfg: ArchConfig, kind: str) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes of the input batch leaves."""
    if kind in ("train", "prefill"):
        out: Dict[str, Any] = {}
        if cfg.family == "audio":
            out["frames"] = ("batch", "seq", "act_embed")
            if kind == "train":
                out["labels"] = ("batch", "seq")
        else:
            out["tokens"] = ("batch", "seq")
        if cfg.m_rope_sections:
            out["positions"] = (None, "batch", "seq")
        return out
    # decode
    return {"tokens": ("batch", None), "pos": ()}


def prefill_specs(mesh, cfg: ArchConfig) -> Dict[str, PartitionSpec]:
    """The activation layout the JAX package's dry run installs for a
    prefill cell whose batch the data axes divide (its launch/dryrun.py):
    the residual stream's batch over the data axes, and for an MoE model
    the expert buffers' TP pins (batch over data, the hidden dim on
    'model').  For ``shardctx.installed``."""
    dpx = dp_axes(mesh)
    nsx = dpx if len(dpx) > 1 else dpx[0]
    specs = {"hidden": P(nsx, None, None)}
    if cfg.moe is not None:
        specs.update(moe_xin=P(nsx, None, None, None), moe_h=P(nsx, None, None, "model"),
                     moe_y=P(nsx, None, None, None))
    return specs


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
