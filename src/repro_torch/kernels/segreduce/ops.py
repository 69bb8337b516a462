# Public wrappers of the segmented-reduction kernel.  A tensor on the CPU
# goes to the plain PyTorch version (ref.py); a tensor on a CUDA device goes
# to the hand-written CUDA kernel (kernel.py, csrc/segreduce.cu) or raises.
# There is no fallback from the card to the plain version.
from __future__ import annotations

import threading
from collections import Counter
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from . import kernel
from .ref import OPS, fused_segreduce_ref, segreduce_ref

# Launches of the CUDA kernel, counted by the wrapper that made them, so a
# run can show that its aggregates went through the kernel.  Only the CUDA
# path counts; the plain version on the CPU launches nothing.  A launch
# made while the calling thread captures a CUDA graph (``capturing``) is
# recorded into that graph's count instead, and each replay of the graph
# adds its count here (``add_replay``): a capture launches nothing, a
# replay launches what was captured.
LAUNCHES = {"fused_segreduce": 0, "segreduce": 0}
_LOCK = threading.Lock()
_CAPTURE = threading.local()


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    log = getattr(_CAPTURE, "log", None)
    if log is not None:
        log[name] += 1
        return
    with _LOCK:
        LAUNCHES[name] += 1


@contextmanager
def capturing() -> Iterator[Counter]:
    """The kernel launches the calling thread makes inside the block, which
    captures them into a CUDA graph, counted into the yielded Counter and
    not into ``LAUNCHES``."""
    prev = getattr(_CAPTURE, "log", None)
    _CAPTURE.log = Counter()
    try:
        yield _CAPTURE.log
    finally:
        _CAPTURE.log = prev


def add_replay(launches: Dict[str, int]) -> None:
    """One replay of a CUDA graph that captured ``launches``."""
    with _LOCK:
        for name, n in launches.items():
            LAUNCHES[name] += n


def _check(keys, values, ops, num_keys, mask) -> None:
    if len(values) != len(ops):
        raise ValueError(f"{len(values)} value columns but {len(ops)} ops")
    for op in ops:
        if op not in OPS:
            raise ValueError(f"unknown segreduce op {op!r}")
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    if not 1 <= num_keys < 2**31:
        raise ValueError(f"num_keys must be in [1, 2**31), got {num_keys}")
    n = keys.shape[0]
    for t in (*values, *(() if mask is None else (mask,))):
        if t.shape != (n,):
            raise ValueError(f"column of shape {tuple(t.shape)} beside {n} keys")
        if t.device != keys.device:
            raise ValueError(f"column on {t.device} beside keys on {keys.device}")


def _cuda_launch(name, keys, values, ops, num_keys, mask, with_presence):
    """The CUDA path: checks what the kernel takes, then launches it once per
    kernel.MAX_AGGS aggregates (the presence histogram rides on the first)."""
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32 on CUDA, got {keys.dtype}")
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool on CUDA, got {mask.dtype}")
    for t in (keys, *values, *(() if mask is None else (mask,))):
        if not t.is_contiguous():
            raise ValueError("segreduce takes contiguous columns")
    for v in values:
        if v.dtype not in kernel._VTYPES:
            raise TypeError(f"segreduce has no CUDA path for values of {v.dtype}")
    accs: list = []
    pres = None
    step = kernel.MAX_AGGS
    for lo in range(0, max(1, len(values)), step):
        part_v, part_ops = tuple(values[lo:lo + step]), tuple(ops[lo:lo + step])
        outs, p = kernel.launch(
            keys, part_v, part_ops, num_keys, mask, with_presence and lo == 0
        )
        _count(name)
        accs.extend(outs)
        if lo == 0:
            pres = p
    return tuple(accs), pres


def fused_segreduce(
    keys: torch.Tensor,
    values: Sequence[torch.Tensor],
    ops: Sequence[str],
    num_keys: int,
    mask: Optional[torch.Tensor] = None,
    with_presence: bool = True,
) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """Fused multi-aggregate group-by: ``values[i]`` aggregated under
    ``ops[i]`` (each 'sum', 'max' or 'min') in one data pass, plus the
    group-presence histogram.  Masked rows contribute each op's identity.
    Returns ``(accs, presence-or-None)``; accumulators keep their input
    dtypes."""
    values = tuple(values)
    ops = tuple(ops)
    _check(keys, values, ops, num_keys, mask)
    if keys.device.type == "cpu":
        return fused_segreduce_ref(keys, values, ops, num_keys, mask=mask, with_presence=with_presence)
    if keys.device.type != "cuda":
        raise ValueError(f"segreduce runs on the CPU or a CUDA device, not {keys.device}")
    return _cuda_launch("fused_segreduce", keys, values, ops, num_keys, mask, with_presence)


def segreduce(
    keys: torch.Tensor, values: torch.Tensor, num_keys: int, op: str = "sum"
) -> torch.Tensor:
    """Single-op group-by aggregation: the fused kernel with one aggregate,
    no mask and no presence histogram.  Input dtype is preserved; empty
    segments hold the op's identity."""
    _check(keys, (values,), (op,), num_keys, None)
    if keys.device.type == "cpu":
        return segreduce_ref(keys, values, num_keys, op)
    if keys.device.type != "cuda":
        raise ValueError(f"segreduce runs on the CPU or a CUDA device, not {keys.device}")
    (acc,), _ = _cuda_launch("segreduce", keys, (values,), (op,), num_keys, None, False)
    return acc
