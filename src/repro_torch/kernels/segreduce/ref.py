# The plain PyTorch version of the segmented-reduction kernels: the same
# contract as kernel.py's CUDA kernel and as the JAX package's
# kernels/segreduce (masked rows contribute the op's identity, empty segments
# hold it, rows with a key outside [0, K) are dropped, int32 sums wrap,
# sub-f32 floats accumulate in f32 and are cast back, N == 0 returns
# identities).  The wrappers in ops.py run it for
# tensors on the CPU; chip_smoke.py holds the kernel against it on the card.
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

# Ops the segmented-aggregation kernels evaluate (the engine's '+' is mapped
# to 'sum' by backends/torch_vec).  COUNT and AVG lower to these at the
# frontend: COUNT is a sum of ones, AVG a sum/count pair.
OPS = ("sum", "max", "min")

_REDUCE = {"max": "amax", "min": "amin"}


def op_identity(op: str, dtype: torch.dtype):
    """Identity element of ``op`` for ``dtype`` as a Python scalar: what
    masked and padded rows contribute.  Integer MIN/MAX use the iinfo
    extremes (a float -inf sentinel is wrong for integer accumulators),
    float MIN/MAX use ±inf."""
    if op == "sum":
        return 0
    if op not in ("max", "min"):
        raise ValueError(f"unknown segreduce op {op!r}")
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype for a value column: preserved, except sub-f32
    floats (bf16/f16), which accumulate in f32 and are cast back."""
    if dtype.is_floating_point and dtype.itemsize < 4:
        return torch.float32
    return dtype


# Float max and min order their values as IEEE 754-2019's maximum and
# minimum, as the CUDA kernel and the JAX package do: -0.0 below +0.0 and a
# NaN wins either way, so no order of the rows changes the result.  The
# values are reduced as integers: the bits of an f32 (f64), read as an
# int32 (int64), with every bit but the sign flipped where the sign is set,
# order as the floats do (-0.0 maps to -1, +0.0 to 0); a NaN is sent past
# the end its op moves towards.  bf16 and f16 widen to f32 exactly first.
# A NaN result comes back as torch's NaN.
_WORDS = {torch.float64: torch.int64}


def _words(x: torch.Tensor, op: str) -> torch.Tensor:
    """The order-preserving integer words of a float tensor under max or
    min (f64 as int64, every other float widened to f32, as int32)."""
    wide = x if x.dtype == torch.float64 else x.to(torch.float32)
    it = _WORDS.get(wide.dtype, torch.int32)
    info = torch.iinfo(it)
    w = wide.contiguous().view(it)
    w = torch.where(w < 0, w ^ info.max, w)
    return torch.where(torch.isnan(wide), info.max if op == "max" else info.min, w)


def _floats(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``_words``' inverse (an involution on the bits), in ``dtype``."""
    f = torch.where(w < 0, w ^ torch.iinfo(w.dtype).max, w).view(
        torch.float64 if w.dtype == torch.int64 else torch.float32).to(dtype)
    return torch.where(torch.isnan(f), torch.full((), torch.nan, dtype=dtype, device=f.device), f)


def ordered_scatter(out: torch.Tensor, idx: torch.Tensor, values: torch.Tensor, op: str) -> torch.Tensor:
    """``out.scatter_reduce_(0, idx, values, 'amax' / 'amin')`` with float
    values ordered as IEEE 754-2019 orders them (see ``_words``); integers
    scatter as they are.  Returns ``out``, written in place."""
    if not values.dtype.is_floating_point:
        return out.scatter_reduce_(0, idx, values, reduce=_REDUCE[op], include_self=True)
    w = _words(out, op).scatter_reduce_(0, idx, _words(values, op), reduce=_REDUCE[op], include_self=True)
    return out.copy_(_floats(w, out.dtype))


def ordered_combine(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """The elementwise max or min of two tensors, floats ordered as
    ``ordered_scatter`` orders them."""
    if not a.dtype.is_floating_point:
        return torch.maximum(a, b) if op == "max" else torch.minimum(a, b)
    wa, wb = _words(a, op), _words(b, op)
    return _floats(torch.maximum(wa, wb) if op == "max" else torch.minimum(wa, wb), a.dtype)


def ordered_reduce(x: torch.Tensor, dim: int, op: str) -> torch.Tensor:
    """``x.amax(dim)`` / ``x.amin(dim)``, floats ordered as
    ``ordered_scatter`` orders them."""
    if not x.dtype.is_floating_point:
        return x.amax(dim) if op == "max" else x.amin(dim)
    w = _words(x, op)
    return _floats(w.amax(dim) if op == "max" else w.amin(dim), x.dtype)


def _reduce_into(keys: torch.Tensor, values: torch.Tensor, num_keys: int, op: str) -> torch.Tensor:
    """Rows whose key lies outside [0, num_keys) are dropped, as the CUDA
    kernel and the JAX package's segment ops drop them: they are given key 0
    and the op's identity before the scatter (on the card a scatter with an
    out-of-range index would trip a device-side assert)."""
    dt = acc_dtype(values.dtype)
    ident = op_identity(op, dt)
    out = torch.full((num_keys,), ident, dtype=dt, device=values.device)
    inside = (keys >= 0) & (keys < num_keys)
    idx = torch.where(inside, keys, 0).long()
    vals = torch.where(inside, values.to(dt), torch.tensor(ident, dtype=dt, device=values.device))
    if op == "sum":
        return out.index_add_(0, idx, vals)
    return ordered_scatter(out, idx, vals, op)


def segreduce_ref(
    keys: torch.Tensor, values: torch.Tensor, num_keys: int, op: str = "sum"
) -> torch.Tensor:
    """Group-by aggregation: out[k] = op over values[i] where keys[i] == k.
    Input dtype preserved; empty segments hold the op's identity."""
    if op not in OPS:
        raise ValueError(f"unknown segreduce op {op!r}")
    return _reduce_into(keys, values, num_keys, op).to(values.dtype)


def fused_segreduce_ref(
    keys: torch.Tensor,
    values: Sequence[torch.Tensor],
    ops: Sequence[str],
    num_keys: int,
    mask: Optional[torch.Tensor] = None,
    with_presence: bool = True,
) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """``values[i]`` aggregated under ``ops[i]``; rows with ``mask == False``
    are funnelled to key 0 carrying each op's identity.  Returns ``(accs,
    presence)``, where ``presence[k]`` counts the unmasked rows of segment k
    (None when ``with_presence=False``)."""
    if len(values) != len(ops):
        raise ValueError(f"{len(values)} value columns but {len(ops)} ops")
    for op in ops:
        if op not in OPS:
            raise ValueError(f"unknown segreduce op {op!r}")
    keys = keys.to(torch.int32)
    if mask is not None:
        mask = mask.to(torch.bool)
        keys = torch.where(mask, keys, 0)
    accs = []
    for op, v in zip(ops, values):
        if mask is not None:
            v = torch.where(mask, v, torch.tensor(op_identity(op, v.dtype), dtype=v.dtype, device=v.device))
        accs.append(_reduce_into(keys, v, num_keys, op).to(v.dtype))
    pres = None
    if with_presence:
        ones = torch.ones(keys.shape, dtype=torch.int32, device=keys.device)
        if mask is not None:
            ones = torch.where(mask, ones, 0)
        pres = _reduce_into(keys, ones, num_keys, "sum")
    return tuple(accs), pres
