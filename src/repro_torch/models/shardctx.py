# Activation-sharding context, after the JAX package's models/shardctx.py,
# with its names.  The launcher installs the solved activation layout
# (core.distribution §III-A4: one distribution for all loops); model code
# pins the residual stream to it (``constrain_hidden``) and the MoE block its
# expert buffers (``constrain``, by name: moe_xin, moe_h, moe_y).
#
# The port runs one card.  A spec is installed with the mesh it names;
# over a mesh of one device every pin is the identity, and a spec over a
# larger mesh is refused when it is installed, never silently dropped.
# With nothing installed each pin returns its input, as in the JAX package.
# The dry run (launch/dryrun.py) reckons a production mesh on the meta
# device: under ``reckoning(mesh)`` a spec over that stand-in is accepted,
# and each pin reports its tensor and spec to the active op counter
# (roofline/op_count.py) and returns its input unchanged.
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch


class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh axis name, a tuple of names, or
    None (replicated); trailing dimensions left out are replicated.  Equal
    element by element to the JAX package's PartitionSpec read as a tuple."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


_HIDDEN_SPEC: Optional[PartitionSpec] = None  # for (B, S, d) residual activations
_SPECS: Dict[str, PartitionSpec] = {}  # named constraint points (moe_xin, moe_h, ...)
_RECKONING: Any = None  # the stand-in mesh the dry run reckons over


def mesh_axis_names(mesh: Any) -> Tuple[str, ...]:
    """The axis names of a torch DeviceMesh or of a stand-in with
    ``axis_names``."""
    names = getattr(mesh, "axis_names", None)
    return tuple(mesh.mesh_dim_names if names is None else names)


def mesh_axis_sizes(mesh: Any) -> Dict[str, int]:
    """{axis name: size}: a stand-in's ``shape`` is that mapping already, a
    DeviceMesh's a tuple in the order of its names."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh_axis_names(mesh), shape))


def _checked(spec: Optional[PartitionSpec], mesh: Any) -> Optional[PartitionSpec]:
    if spec is None:
        return None
    if mesh is None:
        raise ValueError(f"shardctx: {spec!r} is installed without the mesh it names")
    sizes = mesh_axis_sizes(mesh)
    names = [n for part in spec if part is not None for n in (part if isinstance(part, tuple) else (part,))]
    unknown = [n for n in names if n not in sizes]
    if unknown:
        raise ValueError(f"shardctx: {spec!r} names axes {unknown} that the mesh {sizes} lacks")
    devices = math.prod(sizes.values())
    if devices > 1 and not (_RECKONING is not None and mesh is _RECKONING):
        raise ValueError(f"shardctx: {spec!r} is over a mesh of {devices} devices {sizes}; the port runs "
                         "one card, and a layout over more devices is refused, not ignored")
    return PartitionSpec(*spec)


def set_hidden_spec(spec: Optional[PartitionSpec], mesh: Any = None) -> None:
    global _HIDDEN_SPEC
    _HIDDEN_SPEC = _checked(spec, mesh)


def set_spec(name: str, spec: Optional[PartitionSpec], mesh: Any = None) -> None:
    if spec is None:
        _SPECS.pop(name, None)
    else:
        _SPECS[name] = _checked(spec, mesh)


def _pin(x: torch.Tensor, spec: Optional[PartitionSpec], name: str) -> torch.Tensor:
    """x under ``spec`` on a mesh of one device, or reckoned: x itself."""
    if spec is not None and len(spec) > x.dim():
        raise ValueError(f"shardctx: {spec!r} has more entries than the tensor's {x.dim()} dimensions")
    if spec is not None and _RECKONING is not None:
        from repro_torch.roofline import op_count

        op_count.report_pin(name, x, spec)
    return x


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    return _pin(x, _SPECS.get(name), name)


@contextlib.contextmanager
def reckoning(mesh: Any):
    """For the dry run: specs over ``mesh``, a production mesh's stand-in
    (``launch/mesh.ProductionMesh``), are accepted for the block, and each
    pin reports (name, shape, dtype, spec) to the active op counter.  A
    torch DeviceMesh of more than one device is refused here too."""
    global _RECKONING
    devices = math.prod(mesh_axis_sizes(mesh).values())
    if not isinstance(mesh.shape, Mapping) and devices > 1:
        raise ValueError(f"shardctx: a DeviceMesh of {devices} devices is refused; the port runs one card, "
                         "and the dry run reckons a production mesh's stand-in")
    prev = _RECKONING
    _RECKONING = mesh
    try:
        yield
    finally:
        _RECKONING = prev


@contextlib.contextmanager
def hidden_spec(spec: Optional[PartitionSpec], mesh: Any = None):
    global _HIDDEN_SPEC
    prev = _HIDDEN_SPEC
    _HIDDEN_SPEC = _checked(spec, mesh)
    try:
        yield
    finally:
        _HIDDEN_SPEC = prev


@contextlib.contextmanager
def installed(specs: Dict[str, PartitionSpec], mesh: Any):
    """``specs`` installed over ``mesh`` for the block: "hidden" as the
    hidden layout, every other name as that constraint point's; all of them
    cleared after."""
    try:
        for name, spec in specs.items():
            if name == "hidden":
                set_hidden_spec(spec, mesh)
            else:
                set_spec(name, spec, mesh)
        yield
    finally:
        set_hidden_spec(None)
        for name in specs:
            if name != "hidden":
                set_spec(name, None)


def constrain_hidden(x: torch.Tensor) -> torch.Tensor:
    """Pin a (B, S, d) activation to the installed layout (the identity when
    none is installed, and on a mesh of one device)."""
    return _pin(x, _HIDDEN_SPEC, "hidden")
