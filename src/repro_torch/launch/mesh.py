# Mesh construction, after the JAX package's launch/mesh.py, with its
# names.  Functions, not module-level constants, so importing this module
# starts no process group.
#
# The smoke mesh is a real torch DeviceMesh of shape (1, 1) over the
# production axis names.  One process cannot build a DeviceMesh of 256 or
# 512 devices, so the production meshes are stand-ins that carry only what
# the rule engine reads: ``shape`` (axis name -> size) and ``axis_names``.
# dp_axes and dp_size read those two through models/shardctx's
# mesh_axis_names / mesh_axis_sizes, which take either kind of mesh.
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

from repro_torch.models.shardctx import mesh_axis_names, mesh_axis_sizes


@dataclass(frozen=True)
class ProductionMesh:
    """A production mesh's axes and sizes, with no devices behind them."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ProductionMesh(axes, shape)


def make_smoke_mesh(device: Any = None):
    """A one-device DeviceMesh with the production axis names, on the card
    unless the caller asks for the CPU.  Without a process group it first
    starts one of one process from a HashStore (gloo on the CPU, NCCL on the
    card), so no address or port is needed."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.transformer import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        kwargs = {"device_id": torch.device("cuda", torch.cuda.current_device())} if dev.type == "cuda" else {}
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kwargs)
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))


def dp_axes(mesh: Any) -> tuple:
    """The data-parallel axes of a mesh (pod absorbs into DP)."""
    return tuple(a for a in mesh_axis_names(mesh) if a in ("pod", "data"))


def dp_size(mesh: Any) -> int:
    sizes = mesh_axis_sizes(mesh)
    s = 1
    for a in dp_axes(mesh):
        s *= sizes[a]
    return s
