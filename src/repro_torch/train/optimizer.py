# AdamW with fp32 master weights, after the JAX package's
# train/optimizer.py: the same state (step, master, m, v), schedule,
# clipping and order of operations in the update.
#
# The update works in place: master, m and v are overwritten leaf by leaf
# and the bf16 working parameters are copied into, so that at starcoder2-3b
# the card holds one copy of each (12 GB apiece in f32) and not two.  A
# leaf is updated a slice of its leading axis at a time (one layer of a
# stacked leaf), or of its rows over the last axis where one layer is
# larger than a slice, which bounds the f32 temporaries to one slice.
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

# elements of a leaf updated at once (a slice of its leading axis)
_CHUNK = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32
    master: Any            # fp32 params
    m: Any                 # fp32, or {'q': int8, 's': f32} per leaf
    v: Any


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # 'f32' | 'int8' — int8 stores m/v row-quantized (absmax over the last
    # dim): 4x smaller optimizer state; the fp32 master weights stay exact.
    state_dtype: str = "f32"


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, in f32."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * prog))
    return cfg.lr_peak * torch.where(s < cfg.warmup_steps, warm, cos)


# ---------------------------------------------------------------------------
# int8 state quantization (row absmax over the last dim)
# ---------------------------------------------------------------------------


def _scale_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(shape[:-1]) + (1,) if len(shape) else ()


def _quant(x32: torch.Tensor) -> Dict[str, torch.Tensor]:
    if x32.dim():
        s = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    else:
        s = x32.abs() / 127.0
    s = torch.where(s == 0, 1.0, s)
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(torch.float32)}


def _dequant(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, dict) and "q" in leaf:
        return leaf["q"].to(torch.float32) * leaf["s"]
    return leaf


def _is_state_leaf(x: Any) -> bool:
    return (isinstance(x, dict) and "q" in x) or isinstance(x, torch.Tensor)


def _state_items(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{dotted path: leaf} of a state tree whose leaves are tensors or int8
    {'q', 's'} dicts."""
    if _is_state_leaf(tree):
        return {prefix[:-1]: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, Any] = {}
    for k, sub in items:
        out.update(_state_items(sub, f"{prefix}{k}."))
    return out


def adamw_init(params: Any, state_dtype: str = "f32") -> AdamWState:
    """fp32 master copies of ``params`` and zero moments, on the params'
    devices."""
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    if state_dtype == "int8":
        def zeros():
            return tree_map(lambda p: {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                                       "s": torch.ones(_scale_shape(p.shape), dtype=torch.float32,
                                                       device=p.device)}, params)
    else:
        def zeros():
            return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    device = tree_leaves(params)[0][1].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device), master, zeros(), zeros())


def adamw_init_abstract(params_abs: Any, state_dtype: str = "f32") -> AdamWState:
    """The optimizer state of ``params_abs`` (tensors of any device, the meta
    device's among them) as tensors on the meta device: nothing allocated."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def f32():
        return tree_map(lambda p: meta(p.shape, torch.float32), params_abs)

    if state_dtype == "int8":
        def mk():
            return tree_map(lambda p: {"q": meta(p.shape, torch.int8),
                                       "s": meta(_scale_shape(tuple(p.shape)), torch.float32)}, params_abs)
        return AdamWState(meta((), torch.int32), f32(), mk(), mk())
    return AdamWState(meta((), torch.int32), f32(), f32(), f32())


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(_norm_sq(leaf) for _, leaf in tree_leaves(tree)))


def _norm_sq(leaf: torch.Tensor) -> torch.Tensor:
    """sum(square(leaf)) in f32, a slice at a time."""
    total = torch.zeros((), dtype=torch.float32, device=leaf.device)
    for part in _slices(leaf, _plan(leaf)):
        total = total + torch.sum(torch.square(part.to(torch.float32)))
    return total


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def _plan(t: torch.Tensor) -> Tuple[bool, int]:
    """How ``t`` is cut into slices of at most _CHUNK elements: (over its
    last axis, rows).  Rows of its leading axis, or, where one such row is
    larger (one layer of an MoE model's expert stack), rows of ``t`` viewed
    as (-1, last axis); rows 0: the whole leaf at once.  A row over the
    last axis is never cut, so the int8 state's row scales cut alike."""
    if t.dim() < 2 or t.numel() <= _CHUNK:
        return False, 0
    if t[0].numel() <= _CHUNK:
        return False, max(1, _CHUNK // max(1, t[0].numel()))
    return True, max(1, _CHUNK // t.shape[-1])


def _slices(t: torch.Tensor, plan: Tuple[bool, int]) -> List[torch.Tensor]:
    """Views of ``t`` cut by ``plan`` (``_plan`` of a tensor of its shape
    but for the last axis)."""
    flat, rows = plan
    if rows == 0:
        return [t]
    return list(torch.split(t.reshape(-1, t.shape[-1]) if flat else t, rows, dim=0))


def adamw_update(
    cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (params, state, metrics).  ``params`` (the bf16 working
    copies) and the state's master, m and v are written in place and
    returned; the step is a new tensor.  The order of operations is the JAX
    package's: clip by the global norm, then m, v, their bias corrections,
    and w - lr * (m_hat / (sqrt(v_hat) + eps) + wd * w).  The clipped f32
    gradient is formed a slice at a time, not as clip_by_global_norm's
    full-size copy."""
    gnorm = global_norm(grads)
    clip = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(g, m, v, w):
        g = g.to(torch.float32) * clip
        m_new = cfg.b1 * _dequant(m) + (1 - cfg.b1) * g
        v_new = cfg.b2 * _dequant(v) + (1 - cfg.b2) * torch.square(g)
        mh = m_new / b1c
        vh = v_new / b2c
        w_new = w - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * w)
        return m_new, v_new, w_new

    flat_p = dict(tree_leaves(params))
    flat_w = dict(tree_leaves(state.master))
    flat_m, flat_v = _state_items(state.m), _state_items(state.v)
    with torch.no_grad():
        for path, g in tree_leaves(grads):
            m, v, w, p = flat_m[path], flat_v[path], flat_w[path], flat_p[path]
            plan = _plan(w)

            def cut(t):
                return _slices(t, plan)

            if cfg.state_dtype == "int8":
                parts = zip(cut(g), cut(m["q"]), cut(m["s"]), cut(v["q"]), cut(v["s"]), cut(w), cut(p))
                for gs, mq, ms, vq, vs, ws, ps in parts:
                    m_new, v_new, w_new = upd(gs, {"q": mq, "s": ms}, {"q": vq, "s": vs}, ws)
                    for (q_out, s_out), new in (((mq, ms), _quant(m_new)), ((vq, vs), _quant(v_new))):
                        q_out.copy_(new["q"])
                        s_out.copy_(new["s"])
                    ws.copy_(w_new)
                    ps.copy_(w_new.to(ps.dtype))
            else:
                for gs, ms, vs, ws, ps in zip(cut(g), cut(m), cut(v), cut(w), cut(p)):
                    m_new, v_new, w_new = upd(gs, ms, vs, ws)
                    ms.copy_(m_new)
                    vs.copy_(v_new)
                    ws.copy_(w_new)
                    ps.copy_(w_new.to(ps.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.master, state.m, state.v), metrics
