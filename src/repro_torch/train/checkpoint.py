# Checkpointing: shard-per-host layout, atomic manifest commit, async save,
# after the JAX package's train/checkpoint.py and on its on-disk layout, so
# that a checkpoint written by either package restores in the other:
#
#     <dir>/step_<%010d>/host_<id>/arr_<%05d>.npy  +  <dir>/step_<N>/manifest.json
#
# The manifest names each leaf by its path in the tree (the JAX package's
# path strings: dict keys, list and tuple indices, and the field names of a
# named tuple such as AdamWState, joined by '/'; dict keys in sorted order,
# as jax flattens them), with its file, shape and dtype.  bf16 is stored as
# its uint16 bits (numpy has no bf16; the JAX package stores it the same
# way) and restored bit for bit through int16, without ml_dtypes.
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_NUMPY_NAMES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16", torch.int8: "int8",
    torch.uint8: "uint8", torch.bool: "bool",
}


def _is_named_tuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path, leaf) in jax's flattening order: a tensor is a leaf; a named
    tuple's fields, a tuple's or list's items and a dict's sorted keys are
    the steps of a path."""
    if isinstance(tree, torch.Tensor):
        return [("/".join(prefix), tree)]
    if _is_named_tuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    else:
        raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")
    out: List[Tuple[str, Any]] = []
    for name, sub in items:
        out += flatten_with_paths(sub, prefix + (name,))
    return out


def _unflatten(like: Any, leaves: dict, prefix: Tuple[str, ...] = ()) -> Any:
    """``like``'s structure with each leaf replaced by leaves[path]."""
    if isinstance(like, torch.Tensor):
        return leaves["/".join(prefix)]
    if _is_named_tuple(like):
        return type(like)(*(_unflatten(v, leaves, prefix + (f,)) for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, prefix + (str(i),)) for i, v in enumerate(like))
    return {k: _unflatten(v, leaves, prefix + (str(k),)) for k, v in like.items()}


def to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` and the dtype name the manifest gives it (bf16
    as its uint16 bits)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    if t.dtype not in _NUMPY_NAMES:
        raise TypeError(f"cannot checkpoint a tensor of {t.dtype}")
    return t.cpu().numpy(), _NUMPY_NAMES[t.dtype]


def from_numpy(arr: np.ndarray, dtype: str, device: Any) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy; keeps a 0-dim array 0-dim
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


@dataclass
class CheckpointManager:
    """The manifest is written LAST (atomic rename): a step directory
    without a manifest is an aborted save and is ignored and
    garbage-collected.  ``keep`` newest steps are kept."""

    directory: str
    keep: int = 3
    host_id: int = 0

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Snapshot ``tree`` to host memory now (the caller may go on
        updating its tensors in place), write it to disk now or, with
        ``blocking=False``, on a thread that ``wait`` joins."""
        arrays = [(key, *to_numpy(leaf)) for key, leaf in flatten_with_paths(tree)]
        if blocking:
            self._write(step, arrays)
        else:
            self.wait()
            t = threading.Thread(target=self._write, args=(step, arrays), daemon=True)
            t.start()
            self._async_thread = t

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _write(self, step: int, arrays: List[Tuple[str, np.ndarray, str]]) -> None:
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        host_dir = os.path.join(tmp, f"host_{self.host_id}")
        os.makedirs(host_dir, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "leaves": []}
        for i, (key, arr, dtype) in enumerate(arrays):
            fn = f"arr_{i:05d}.npy"
            np.save(os.path.join(host_dir, fn), arr)
            manifest["leaves"].append({"key": key, "file": fn, "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)
        # remove aborted saves
        for d in os.listdir(self.directory):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> Tuple[int, Any]:
        """Restore into the structure of ``like``: each leaf a new tensor on
        the device of ``like``'s leaf at that path."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        host_dir = os.path.join(d, f"host_{self.host_id}")
        by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
        leaves = {}
        for key, ref in flatten_with_paths(like):
            ent = by_key[key]
            arr = np.load(os.path.join(host_dir, ent["file"]))
            leaves[key] = from_numpy(arr, ent["dtype"], ref.device)
        return step, _unflatten(like, leaves)
