# The dtype policy: how host columns, constants and parameters become
# tensors.  It reproduces the JAX package, which runs with jax's x64 mode
# off, so that both packages compute in the same types:
#
#   * integer columns become int32; wider ones wrap (``jnp.asarray`` of an
#     int64 column does: 2**31 + 5 becomes -2147483643);
#   * float64 columns become float32; float32, bf16 (ml_dtypes') and f16
#     stay;
#   * a Python int constant becomes int32, a float constant float32;
#   * a scalar SUM over int32 (or bool) stays int32 and wraps, as
#     ``jnp.sum`` does, where ``torch.sum`` would widen to int64.
#
# One departure: int8/int16/uint8/uint16 columns also become int32 (jax
# keeps them narrow), so that every key column reaching the kernels is int32;
# their values are unchanged.
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .codegen import UnsupportedProgram

Device = Union[str, torch.device]


def host_dtype(dtype: Any) -> np.dtype:
    """The numpy dtype a host column of ``dtype`` takes under the policy
    (the partitioned backend casts each chunk's slice to it on the host)."""
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return dtype
    if np.issubdtype(dtype, np.integer):
        return np.dtype(np.int32)
    if dtype == np.float64:
        return np.dtype(np.float32)
    if dtype in (np.float32, np.float16) or dtype.name == "bfloat16":
        return dtype
    raise UnsupportedProgram(
        f"column of {dtype} has no tensor form — apply data reformatting "
        "(dictionary encoding) first, or use the reference backend"
    )


def torch_dtype(dtype: np.dtype) -> torch.dtype:
    """The tensor dtype of a host dtype (numpy has no bf16 of its own: a
    bf16 column arrives in ml_dtypes' ``bfloat16``, known by its name)."""
    if dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype)).dtype


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host tensor sharing ``arr``'s memory."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def host_array(t: torch.Tensor, dtype: np.dtype) -> np.ndarray:
    """A numpy array of ``dtype`` sharing host tensor ``t``'s memory."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(dtype)
    return t.numpy()


def column_tensor(values: Any, device: Device) -> torch.Tensor:
    """One host column as a tensor on ``device`` under the policy."""
    arr = np.asarray(values)
    return host_tensor(arr.astype(host_dtype(arr.dtype), copy=False)).to(device)


def scalar_tensor(value: Any, device: Device) -> torch.Tensor:
    """A constant or query parameter as a 0-d tensor under the policy.  It is
    filled on the device (no copy from the host), so a chunk kernel captured
    in a CUDA graph may make one."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    if arr.dtype == np.bool_:
        return torch.full((), bool(arr), dtype=torch.bool, device=device)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.full((), int(arr.astype(np.int32)), dtype=torch.int32, device=device)
    if np.issubdtype(arr.dtype, np.floating):
        return torch.full((), float(arr), dtype=torch.float32, device=device)
    raise UnsupportedProgram(f"constant {value!r} has no tensor form")


def const_dtype(value: Any) -> torch.dtype:
    """int32 for a Python int, float32 otherwise (the reference's
    ``jnp.full(..., dtype=int32 if isinstance(value, int) else float32)``)."""
    return torch.int32 if isinstance(value, int) else torch.float32


def scalar_sum(values: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` under x64-off: integer and bool inputs sum in int32 and
    wrap; float inputs keep their dtype."""
    if values.dtype.is_floating_point:
        return torch.sum(values)
    return torch.sum(values.to(torch.int32), dtype=torch.int32)
