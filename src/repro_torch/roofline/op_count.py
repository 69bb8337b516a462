# The dry run's counter of one traced step, the port's counterpart of the
# JAX package's roofline/hlo_parse.py.  PyTorch emits no HLO, so nothing
# is parsed: a TorchDispatchMode sees every aten op the step runs (on the
# meta device, where nothing is computed or allocated) and folds, each
# weighted by the ``repeated`` count in force (the microbatches of a step,
# as hlo_parse weights a while body by its trip count):
#
# Two weights are in force: ``weight`` scales the work (the dry run sets it
# to the global step's repeats of the traced rows, and divides by the
# devices at the end) and ``repeats`` the kernels' calls and the
# collectives, which are one device's.
#
#   * dot_flops            2 * prod(result) * K for mm, addmm, bmm,
#                          baddbmm (hlo_parse's _dot_flops); a convolution
#                          with its own K; and each hand-written kernel's
#                          own products, which its meta route reports
#                          (kernels/flash/ops.py, kernels/wkv6/ops.py);
#   * traffic_bytes        inputs plus outputs of every op, view and
#                          metadata ops skipped (hlo_parse's _SKIP_TRAFFIC),
#                          an op that only writes counted by its outputs;
#   * fused_traffic_bytes  the same with the elementwise ops left out
#                          (hlo_parse's _FUSABLE): what fusing them reaches;
#   * kernels              {name: calls, FLOPs, bytes} of the kernels;
#   * collectives          {(kind, axes): bytes, count}: those the trace
#                          shows (a product whose contracting dim is sharded
#                          over a non-data axis all-reduces its output; a
#                          pin's exchanges) and those the dry run adds from
#                          the specs (``add_collective``);
#   * peak live bytes      every storage an op creates is live until its
#                          last tensor dies (a weakref on the storage); a
#                          storage's bytes may be rescaled after the fact
#                          (``scale_storage``: a leaf's gradient or a pinned
#                          tensor at its shard size), so the peak is taken
#                          at the end by replaying the allocations and frees.
#
# Storages that were live before the trace (arguments) are not counted.
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

ACTIVE: List["OpCounter"] = []

_MM = {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default}
# ops that move no data of their own (besides views)
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach", "lift_fresh",
               "alias", "_unsafe_view", "set_", "resize_", "lift_fresh_copy", "_local_scalar_dense"}
# ops that only write their outputs
_WRITE_ONLY = {"zero_", "fill_", "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "arange",
               "new_zeros", "new_ones", "new_full", "scalar_tensor", "normal_", "uniform_", "randn", "rand",
               "randint", "random_", "bernoulli_", "exponential_"}
# copies and conversions a fusing compiler folds into their neighbours,
# beside the ops tagged pointwise
_FUSABLE = {"_to_copy", "clone", "copy_", "constant_pad_nd", "expand_copy", "zero_", "fill_", "zeros_like",
            "ones_like", "full_like", "masked_fill_", "masked_fill"}


def _name(func) -> str:
    return func.overloadpacket.__name__


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def report_kernel(name: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's meta route reports one call."""
    if ACTIVE:
        ACTIVE[-1].kernel(name, flops, nbytes)


def report_pin(name: str, x: torch.Tensor, spec: Sequence[Any]) -> None:
    """A shardctx pin under ``reckoning`` reports its tensor and spec."""
    if ACTIVE:
        ACTIVE[-1].pin(name, x, spec)


def _axes_of(part: Any) -> Tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, tuple) else (part,)


class OpCounter(TorchDispatchMode):
    """Counts one trace (see the module's header).  ``sizes`` are the mesh's
    axis sizes and ``data_axes`` its data-parallel axes: a spec's other
    axes split the tensors the trace holds whole."""

    def __init__(self, sizes: Optional[Dict[str, int]] = None, data_axes: Sequence[str] = ()) -> None:
        super().__init__()
        self.sizes = dict(sizes or {})
        self.data_axes = tuple(data_axes)
        self.weight = 1.0
        self.repeats = 1.0
        self.dot_flops = 0.0
        self.traffic_bytes = 0.0
        self.fused_traffic_bytes = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.collectives: Dict[Tuple[str, Tuple[str, ...]], List[float]] = {}
        self.pins: Dict[str, int] = {}
        self.n_ops = 0
        # memory: an id a storage, its traced bytes and scale, the events
        self._ids: Dict[int, int] = {}          # storage key -> id, while live
        self._bytes: List[int] = []             # id -> traced bytes
        self._scale: Dict[int, float] = {}      # id -> scale
        self._events: List[int] = []            # +id allocation, -id - 1 free
        self._external: Dict[int, Any] = {}     # storage key -> weakref, storages from before the trace
        self._sharded: Dict[int, Tuple[tuple, tuple, tuple]] = {}  # key -> (shape, stride, axes per dim)
        self._into: Dict[int, float] = {}       # accumulator key -> its gradients' scale

    # -- the mode --------------------------------------------------------
    def __enter__(self):
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ACTIVE.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def repeated(self, work: float, repeats: float):
        """Ops inside count ``work`` times in the work and ``repeats`` times
        in the calls and collectives (the peak of live bytes does not
        change: the repeats run one after another)."""
        prev = self.weight, self.repeats
        self.weight, self.repeats = prev[0] * work, prev[1] * repeats
        try:
            yield
        finally:
            self.weight, self.repeats = prev

    def accumulate_into(self, acc: torch.Tensor, scale: float) -> None:
        """A gradient added into ``acc`` (``acc.add_(g)``) counts at
        ``scale`` of its traced bytes: a leaf's gradient at its shard."""
        self._into[_key(acc)] = scale

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        in_keys = set()
        for t in ins:
            k = _key(t)
            in_keys.add(k)
            if k not in self._ids and k not in self._external:
                self._mark_external(t)
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            k = _key(t)
            if k not in in_keys and k not in self._ids and k not in self._external:
                self._allocate(t, k)
        self._count(func, args, ins, outs)
        return out

    # -- counting --------------------------------------------------------
    def _count(self, func, args, ins, outs) -> None:
        self.n_ops += 1
        name = _name(func)
        w = self.weight
        if func in _MM:
            a, b = (args[0], args[1]) if func in (aten.mm.default, aten.bmm.default) else (args[1], args[2])
            k = a.shape[-1]
            self.dot_flops += w * 2.0 * outs[0].numel() * k
            axes = self._contracted(a, a.dim() - 1) + self._contracted(b, b.dim() - 2)
            if axes:
                self.add_collective("all-reduce", axes, _nbytes(outs[0]))
        elif func in (aten.dot.default, aten.mv.default):
            self.dot_flops += w * 2.0 * outs[0].numel() * args[0].shape[-1]
        elif name == "convolution":  # weight (C_out, C_in / groups, *kernel)
            weight = args[1]
            self.dot_flops += w * 2.0 * outs[0].numel() * weight.shape[1] * math.prod(weight.shape[2:])
        elif name == "convolution_backward":
            weight, mask = args[2], args[-1]
            per = 2.0 * args[0].numel() * weight.shape[1] * math.prod(weight.shape[2:])
            self.dot_flops += w * per * (int(mask[0]) + int(mask[1]))
        elif name == "add_" and len(ins) > 1 and _key(ins[0]) in self._into:
            self.scale_storage(ins[1], self._into[_key(ins[0])])
        elif name in ("embedding", "index") and ins:
            axes = self._contracted(ins[0], 0)
            if axes:
                self.add_collective("all-reduce", axes, _nbytes(outs[0]))
        if func.is_view or name in _NO_TRAFFIC:
            return
        nbytes = sum(_nbytes(t) for t in outs)
        if name not in _WRITE_ONLY:
            nbytes += sum(_nbytes(t) for t in ins)
        self.traffic_bytes += w * nbytes
        if not (torch.Tag.pointwise in func.tags or name in _FUSABLE):
            self.fused_traffic_bytes += w * nbytes

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += self.repeats
        k["flops"] += self.weight * flops
        k["bytes"] += self.weight * nbytes
        self.dot_flops += self.weight * flops
        self.traffic_bytes += self.weight * nbytes
        self.fused_traffic_bytes += self.weight * nbytes

    def add_collective(self, kind: str, axes: Sequence[str], nbytes: float, count: float = 1.0) -> None:
        """``count`` collectives of ``kind`` over ``axes``, each moving
        ``nbytes`` off the device (hlo_parse's operand bytes), times the
        repeats in force."""
        if math.prod(self.sizes.get(a, 1) for a in axes) <= 1:
            return  # over one device: nothing moves
        entry = self.collectives.setdefault((kind, tuple(axes)), [0.0, 0.0])
        entry[0] += self.repeats * count * nbytes
        entry[1] += self.repeats * count

    # -- sharding --------------------------------------------------------
    def split_axes(self, spec: Sequence[Any], dim: int) -> Tuple[str, ...]:
        """The non-data axes that ``spec`` puts on ``dim``."""
        return tuple(a for a in _axes_of(spec[dim] if dim < len(spec) else None) if a not in self.data_axes)

    def register_sharded(self, t: torch.Tensor, spec: Sequence[Any], *, data_too: bool = False) -> None:
        """``t``'s storage is ``spec``'s layout: a product that contracts
        one of its dims sharded over a non-data axis all-reduces over it."""
        axes = tuple(tuple(a for a in _axes_of(spec[d] if d < len(spec) else None)
                           if data_too or a not in self.data_axes) for d in range(t.dim()))
        if any(axes):
            self._sharded[_key(t)] = (tuple(t.shape), tuple(t.stride()), axes)

    def _contracted(self, t: torch.Tensor, dim: int) -> Tuple[str, ...]:
        info = self._sharded.get(_key(t))
        if info is None or t.shape[dim] == 1:
            return ()
        size, stride = t.shape[dim], t.stride()[dim]
        for ps, pst, axes in zip(*info):
            if pst == stride and ps == size:
                return tuple(a for a in axes if a not in self.data_axes)
        return ()

    def fraction(self, spec: Sequence[Any], shape: Sequence[int]) -> float:
        """The share of a traced tensor that one device holds under
        ``spec``, its data axes left out (the trace already holds one
        device's rows)."""
        n = 1
        for d in range(min(len(spec), len(shape))):
            n *= math.prod(self.sizes.get(a, 1) for a in self.split_axes(spec, d))
        return 1.0 / n

    def pin(self, name: str, x: torch.Tensor, spec: Sequence[Any]) -> None:
        """A shardctx pin: the tensor counts at its shard size; the hidden
        stream split over 'model' is gathered at the pin and its gradient
        reduce-scattered; an expert buffer split over 'model' on its expert
        dim is exchanged all to all, forward and backward; the hidden dim
        of the expert buffers split over 'model' makes the products that
        contract it all-reduce (forward and backward)."""
        self.pins[name] = self.pins.get(name, 0) + 1
        frac = self.fraction(spec, x.shape)
        self.scale_storage(x, frac)
        split = {d: self.split_axes(spec, d) for d in range(x.dim())}
        split = {d: a for d, a in split.items() if a}
        if not split:
            return
        hook = None
        if name == "hidden":
            axes = tuple(a for d in split for a in split[d])
            self.add_collective("all-gather", axes, _nbytes(x) * frac)

            def hook(g, axes=axes):
                self.add_collective("reduce-scatter", axes, _nbytes(g))
        elif 1 in split and x.dim() == 4:  # (groups, E, C, .) with the experts split
            self.add_collective("all-to-all", split[1], _nbytes(x))

            def hook(g, axes=split[1]):
                self.add_collective("all-to-all", axes, _nbytes(g))
        else:
            self.register_sharded(x, spec)

            def hook(g, spec=tuple(spec)):
                self.register_sharded(g, spec)
        if x.requires_grad:
            x.register_hook(hook)

    # -- memory ----------------------------------------------------------
    def _mark_external(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        k = st._cdata
        self._external[k] = weakref.finalize(st, self._external.pop, k, None)

    def _allocate(self, t: torch.Tensor, k: int) -> None:
        st = t.untyped_storage()
        i = len(self._bytes)
        self._bytes.append(st.nbytes())
        self._ids[k] = i
        self._events.append(i)
        weakref.finalize(st, self._free, k, i)

    def _free(self, k: int, i: int) -> None:
        if self._ids.get(k) == i:
            del self._ids[k]
        self._events.append(-i - 1)

    def scale_storage(self, t: torch.Tensor, scale: float) -> None:
        """Count the storage of ``t`` (made inside the trace) at ``scale``
        of its traced bytes, over its whole life."""
        i = self._ids.get(_key(t))
        if i is not None:
            self._scale[i] = min(self._scale.get(i, 1.0), scale)

    def live_bytes(self) -> float:
        return sum(self._bytes[i] * self._scale.get(i, 1.0) for i in self._ids.values())

    def peak_bytes(self) -> float:
        """The largest sum of live traced storages over the trace, each at
        its scale."""
        cur = peak = 0.0
        for e in self._events:
            if e >= 0:
                cur += self._bytes[e] * self._scale.get(e, 1.0)
                peak = max(peak, cur)
            else:
                cur -= self._bytes[-e - 1] * self._scale.get(-e - 1, 1.0)
        return peak

    def record(self, devices: int = 1) -> Dict[str, Any]:
        """The counts as the dry run's record keeps them: the work over
        ``devices`` (the global step's work a device), the calls and
        collectives as counted (one device's)."""
        kinds: Dict[str, float] = {}
        counts: Dict[str, float] = {}
        by_axes: Dict[str, float] = {}
        for (kind, axes), (b, n) in sorted(self.collectives.items()):
            kinds[kind] = kinds.get(kind, 0.0) + b
            counts[kind] = counts.get(kind, 0.0) + n
            name = ",".join(axes)
            by_axes[name] = by_axes.get(name, 0.0) + b
        return {
            "dot_flops": self.dot_flops / devices,
            "traffic_bytes": self.traffic_bytes / devices,
            "fused_traffic_bytes": self.fused_traffic_bytes / devices,
            "collective_bytes": kinds,
            "n_collectives": counts,
            "collective_bytes_by_axes": by_axes,
            "kernels": {k: {"calls": v["calls"], "flops": v["flops"] / devices, "bytes": v["bytes"] / devices}
                        for k, v in sorted(self.kernels.items())},
            "pins": dict(sorted(self.pins.items())),
            "n_ops": self.n_ops,
        }
