# Shared model machinery: parameter definition trees (shape + dtype +
# logical axes, which launch/sharding.py maps onto a mesh), their
# initialisation from an explicit generator, norms, RoPE / M-RoPE,
# activations and soft-capping.
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .shardctx import PartitionSpec

# ---------------------------------------------------------------------------
# Parameter definition trees
# ---------------------------------------------------------------------------
#
# A model's parameters are described once as a tree (dicts and lists) of
# ParamDef leaves; the Model module allocates one tensor per leaf under the
# leaf's dotted path ("groups.pos0.attn.wq", "remainder.0.mlp.w_up").


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names, len == len(shape)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # 'normal' | 'zeros' | 'ones'
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_param_def(x: Any) -> bool:
    return isinstance(x, ParamDef)


def tree_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(dotted path, leaf) pairs of a tree of dicts and lists."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k, v in tree.items():
            out += tree_leaves(v, f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += tree_leaves(v, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_abstract(defs: Any) -> Any:
    """The tree's leaves as tensors on the meta device: shapes and dtypes,
    nothing allocated."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def tree_partition_specs(defs: Any, rules: Dict[str, Optional[str]]) -> Any:
    """logical axes -> PartitionSpec via ``rules`` (logical -> mesh axis or
    None).  Unknown logical axes are replicated."""
    return tree_map(lambda d: PartitionSpec(*[rules.get(a) if a is not None else None for a in d.axes]), defs)


def tree_logical_axes(defs: Any) -> Any:
    return tree_map(lambda d: d.axes, defs)


def stack_defs(d: ParamDef, n: int, axis_name: Optional[str] = "layers") -> ParamDef:
    """Add a leading stacking axis (one tensor per pattern position, with a
    leading ``repeats`` axis, as the JAX package stacks for lax.scan)."""
    return ParamDef((n,) + d.shape, (axis_name,) + d.axes, d.dtype, d.init, d.scale)


def tree_stack_defs(defs: Any, n: int) -> Any:
    return tree_map(lambda d: stack_defs(d, n), defs)


def param_count(defs: Any) -> int:
    return int(sum(math.prod(d.shape) for _, d in tree_leaves(defs)))


def _std(d: ParamDef) -> float:
    """scale / sqrt(fan_in), fan_in the second-to-last axis (the last for
    vectors)."""
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    return d.scale / math.sqrt(max(fan_in, 1))


def init_param(d: ParamDef, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """One leaf after the JAX package's ``tree_init``: a normal draw in f32
    times scale / sqrt(fan_in), cast to the def's dtype; zeros and ones as
    declared."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    x = torch.randn(d.shape, dtype=torch.float32, device=device, generator=generator)
    return x.mul_(_std(d)).to(d.dtype)


# a normal leaf of more elements than this is drawn in row blocks of
# _DRAW_BLOCK elements (its f32 draw whole would be over 8 GiB: an MoE
# model's stacked experts, 31.5 GiB for eight layers of dbrx-132b)
_DRAW_WHOLE = 1 << 31
_DRAW_BLOCK = 1 << 28


@torch.no_grad()
def draw_param_(t: torch.Tensor, d: ParamDef, generator: torch.Generator) -> None:
    """Fill the parameter ``t`` of def ``d`` as ``init_param`` draws it
    (the same values where it holds at most _DRAW_WHOLE elements)."""
    if d.init != "normal" or t.numel() <= _DRAW_WHOLE:
        t.copy_(init_param(d, generator, t.device))
        return
    rows = t.view(-1, t.shape[-1])
    step = max(1, _DRAW_BLOCK // t.shape[-1])
    for lo in range(0, rows.shape[0], step):
        block = rows[lo : lo + step]
        x = torch.randn(block.shape, dtype=torch.float32, device=t.device, generator=generator)
        block.copy_(x.mul_(_std(d)))


def init_params(defs: Any, generator: torch.Generator, device: torch.device) -> Any:
    """A tree of tensors congruent with ``defs``, drawn leaf by leaf from
    ``generator`` (which lives on ``device``)."""
    return tree_map(lambda d: init_param(d, generator, device), defs)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    # gemma-style (1 + scale) parameterization keeps init at identity
    return (out * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (incl. Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------


def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def rope_angles(head_dim: int, theta: float, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) -> cos/sin of shape (..., S, head_dim//2), f32."""
    ang = positions[..., None].float() * _inv_freq(head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, half) or (S, half).  The bf16 x f32
    products promote to f32; the result is cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def mrope_angles(
    head_dim: int, theta: float, positions_3d: torch.Tensor, sections: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE: positions_3d (3, B, S) for (t, h, w);
    the half-dim frequency bands are split into `sections` (e.g. 16/24/24),
    each section using the corresponding position stream."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    ang = positions_3d[..., None].float() * _inv_freq(head_dim, theta, positions_3d.device)
    parts = []
    start = 0
    for si, sec in enumerate(sections):
        parts.append(ang[si, :, :, start : start + sec])
        start += sec
    ang_sel = torch.cat(parts, dim=-1)  # (B, S, half)
    return torch.cos(ang_sel), torch.sin(ang_sel)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid as the JAX package computes it on bf16: 1 / (1 +
    exp(-x)), each step rounded to x's type (torch.sigmoid rounds once, and
    differs from it in a third of bf16 outputs)."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu, x * sigmoid(x), each step rounded to x's type as XLA
    rounds it (F.silu rounds once; with it an MoE block's bf16 output
    matched the reference's bit for bit at 45% of elements, with this at
    all of them)."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=True), x / 2 (1 + tanh(sqrt(2/pi) (x +
    0.044715 x^3))), each step rounded to x's type as XLA rounds it, its
    constants cast to x's type first (F.gelu rounds once, and differed
    from it in half a zamba2 MLP's bf16 outputs)."""
    c = float(torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype))
    cubic = float(torch.tensor(0.044715, dtype=x.dtype))
    return x * ((torch.tanh((x + x * x * x * cubic) * c) + 1.0) * 0.5)


def _horner(t: torch.Tensor, coeffs: Tuple[float, ...]) -> torch.Tensor:
    acc = t * coeffs[0] + coeffs[1]
    for c in coeffs[2:]:
        acc = acc * t + c
    return acc


# XLA's f32 expansion of erfc (its chlo.erfc lowering, as the JAX package's
# compiled CPU code runs it): 1 - z P(z^2) for |z| < 1, else exp(-z^2) / |z|
# times a rational fit in 1 / z^2, one for |z| < 2 and one beyond, 2 - that
# for z < 0, and 0 where exp(-z^2) would underflow.
_ERFC_SMALL = (7.85386146e-05, -0.000801019371, 0.00518832775, -0.0268538129, 0.112835854, -0.37612626,
               1.12837911)
_ERFC_MID = (0.0232682, -0.138703942, 0.368742466, -0.582473278, 0.621000469, -0.494451523, 0.340488,
             -0.274112701, 0.563825965)
_ERFC_FAR = (-10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523, 0.42184633, -0.282076746, 0.564189494)


def erfc_xla(z: torch.Tensor) -> torch.Tensor:
    """erfc of an f32 tensor as XLA expands it (C43)."""
    a = z.abs()
    z2 = z * z
    small = 1.0 - z * _horner(z2, _ERFC_SMALL)
    q = 1.0 / z2
    r = torch.where(a < 2.0, _horner(q, _ERFC_MID), _horner(q, _ERFC_FAR)) * (torch.exp(-z2) * (1.0 / a))
    r = torch.where(-z2 < -88.7228394, torch.zeros_like(r), r)
    return torch.where(a < 1.0, small, torch.where(z < 0, 2.0 - r, r))


def _gelu_steps(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=False) = 0.5 x erfc(-x sqrt(1/2)) as the
    compiled reference computes it on x's type: 0.5 x rounded, -x times
    sqrt(1/2) cast to x's type (0.70703125 in bf16) in f32, unrounded, into
    XLA's erfc, its value rounded, and the product rounded."""
    c = float(torch.tensor(math.sqrt(0.5), dtype=x.dtype))
    half = x * 0.5
    e = erfc_xla(-x.float() * c).to(x.dtype)
    return (half.float() * e.float()).to(x.dtype)


_GELU_TABLES: dict = {}


def _gelu_table(device: torch.device) -> torch.Tensor:
    """_gelu_steps of every bf16 value, by its 16-bit word + 32768, computed
    once on the CPU and kept on ``device``."""
    if device not in _GELU_TABLES:
        words = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
        _GELU_TABLES[device] = _gelu_steps(words.view(torch.bfloat16)).to(device)
    return _GELU_TABLES[device]


class _Gelu(torch.autograd.Function):
    """The exact gelu: on bf16 a lookup of ``_gelu_table`` (the compiled
    reference's rounding, in one gather), else ``_gelu_steps``; its gradient
    0.5 erfc(-x c) + x c exp(-(x c)^2) / sqrt(pi) in f32, rounded once."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.dtype == torch.bfloat16:
            idx = x.view(torch.int16).to(torch.int32) + 32768
            return _gelu_table(x.device)[idx]
        return _gelu_steps(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        c = float(torch.tensor(math.sqrt(0.5), dtype=x.dtype))
        xc = x.float() * c
        d = 0.5 * torch.special.erfc(-xc) + xc * torch.exp(-xc * xc) / math.sqrt(math.pi)
        return (g.float() * d).to(g.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=False) as the JAX package's compiled code
    computes it: bit for bit on bf16 (C43; F.gelu rounds once after an
    exact erf, and differs from it at 3.3% of bf16 values)."""
    return _Gelu.apply(x)


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return silu
    if name == "gelu":
        return gelu
    if name == "gelu_tanh":
        return gelu_tanh
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name}")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap * tanh(x / cap), computed in f32."""
    if cap <= 0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
