# train_step factory, after the JAX package's train/step.py: gradient
# accumulation over microbatches, remat, and the AdamW update.  This is the
# static schedule of the paper's hybrid scheme (§III-A3): one chunk of work
# with no scheduling inside it; the dynamic fault-tolerant scheduler
# (sched/) operates on chunks of these steps.
#
# The gradient is taken against leaves that view the model's parameters:
# one per repeat of a stacked parameter (the JAX package's lax.scan slices
# it the same way), one for each other parameter.  Each microbatch's bf16
# gradients are added into f32 accumulators (TrainSpec.accum_dtype) a
# repeat at a time and dropped, so the card never holds a second full-size
# gradient, nor the full-size zeros that autograd would build for every
# layer's slice of a stacked parameter.
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import Model, lm_loss
from repro_torch.serve.step import make_prefill_step  # noqa: F401  (the JAX package's train/step.py has it too)
from .optimizer import AdamWConfig, AdamWState, adamw_update


@dataclass(frozen=True)
class TrainSpec:
    microbatches: int = 1
    remat: bool = True
    accum_dtype: torch.dtype = torch.float32


class _PerRepeat:
    """A stacked parameter as one leaf per repeat: ``[r]`` is repeat r's
    leaf, which the forward reads where it would index the stack."""

    def __init__(self, leaves: List[torch.Tensor]) -> None:
        self.leaves = leaves

    def __getitem__(self, r: int) -> torch.Tensor:
        return self.leaves[r]


def _grad_leaves(params: Dict[str, Any]) -> Tuple[Dict[str, Any], List[Tuple[str, Any]]]:
    """(the tree the forward reads, (path, leaf or _PerRepeat) pairs): every
    leaf a detached view of its parameter that requires grad."""
    pairs: List[Tuple[str, Any]] = []

    def leaf(path: str, p: torch.Tensor) -> Any:
        base = p.detach()
        if path.startswith("groups."):
            out: Any = _PerRepeat([base[r].requires_grad_() for r in range(base.shape[0])])
        else:
            out = base.requires_grad_()
        pairs.append((path, out))
        return out

    def walk(tree: Any, prefix: str) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, f"{prefix}{i}.") for i, v in enumerate(tree)]
        return leaf(prefix[:-1], tree)

    return walk(params, ""), pairs


def _accumulate(acc: Dict[str, torch.Tensor], pairs: List[Tuple[str, Any]]) -> None:
    """acc[path] += the gradient of its leaf (per repeat for a stacked
    parameter), in acc's type; each gradient is dropped once added."""
    with torch.no_grad():
        for path, leaf in pairs:
            parts = leaf.leaves if isinstance(leaf, _PerRepeat) else [leaf]
            target = list(acc[path]) if isinstance(leaf, _PerRepeat) else [acc[path]]
            for t, part in zip(target, parts):
                if part.grad is not None:
                    t.add_(part.grad)
                    part.grad = None


def split_microbatches(batch: Dict[str, torch.Tensor], n_mb: int) -> List[Dict[str, torch.Tensor]]:
    """The global batch cut into ``n_mb`` microbatches along its batch axis:
    axis 0 for most leaves, axis 1 for a leaf with a leading component
    axis (M-RoPE positions are (3, B, S))."""
    if n_mb == 1:
        return [batch]
    B = (batch["tokens"] if "tokens" in batch else batch["frames"]).shape[0]
    if B % n_mb:
        raise ValueError(f"a global batch of {B} does not split into {n_mb} microbatches")

    def split(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] == B:
            return x.reshape((n_mb, B // n_mb) + tuple(x.shape[1:]))
        if x.dim() >= 2 and x.shape[1] == B:
            return x.reshape((x.shape[0], n_mb, B // n_mb) + tuple(x.shape[2:])).movedim(1, 0)
        raise ValueError(f"cannot microbatch-split shape {tuple(x.shape)} (B={B})")

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_mb)]


def zeroed_accumulators(params: Dict[str, Any], spec: TrainSpec,
                        acc: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The gradient accumulators of a step, keyed by parameter path in
    ``spec.accum_dtype``: ``acc`` zeroed, or new zeros."""
    if acc is None:
        return {path: torch.zeros(p.shape, dtype=spec.accum_dtype, device=p.device)
                for path, p in tree_leaves(params)}
    for t in acc.values():
        t.zero_()
    return acc


def microbatch_grad(
    model: Model, params: Dict[str, Any], mb: Dict[str, torch.Tensor], spec: TrainSpec,
    acc: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One microbatch's loss and metrics (detached); its gradient is added
    into ``acc``."""
    tree, pairs = _grad_leaves(params)
    loss, metrics = lm_loss(tree, mb, model.cfg, remat=spec.remat)
    loss.backward()
    _accumulate(acc, pairs)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def averaged(acc: Dict[str, torch.Tensor], n_mb: int) -> Dict[str, torch.Tensor]:
    """The accumulated gradient divided by the microbatch count, in place."""
    if n_mb > 1:
        for t in acc.values():
            t.div_(n_mb)
    return acc


def value_and_grad(
    model: Model, params: Dict[str, Any], batch: Dict[str, torch.Tensor], spec: TrainSpec,
    acc: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The loss, its metrics (means over the microbatches) and the gradient
    of the mean loss of ``spec.microbatches`` microbatches, keyed by
    parameter path, in ``spec.accum_dtype``: the JAX package's
    value_and_grad of lm_loss, accumulated and divided as its train_step
    does.  ``acc`` holds accumulators to reuse (zeroed here)."""
    acc = zeroed_accumulators(params, spec, acc)
    n_mb = spec.microbatches
    loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
    metric_sums: Dict[str, torch.Tensor] = {}
    for mb in split_microbatches(batch, n_mb):
        loss, metrics = microbatch_grad(model, params, mb, spec, acc)
        loss_sum = loss_sum + loss
        for k, v in metrics.items():
            metric_sums[k] = metric_sums.get(k, 0.0) + v
    metrics = {k: v / n_mb for k, v in metric_sums.items()}
    return loss_sum / n_mb, metrics, averaged(acc, n_mb)


def update(opt_cfg: AdamWConfig, params: Any, opt_state: AdamWState,
           grads: Dict[str, torch.Tensor]) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """AdamW's update of ``params`` and ``opt_state`` (in place) by the
    gradient keyed by parameter path."""
    return adamw_update(opt_cfg, _tree_from_paths(params, grads), opt_state, params)


def make_train_step(
    model: Model, opt_cfg: AdamWConfig, spec: TrainSpec
) -> Callable[[Any, AdamWState, Dict[str, torch.Tensor]], Tuple[Any, AdamWState, Dict[str, torch.Tensor]]]:
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics), ``params`` being ``model.params``.  The global batch's leading
    dim is split into ``spec.microbatches`` accumulation steps, bounding
    activation memory; the parameters and the optimizer state are updated
    in place (optimizer.adamw_update).  The f32 accumulators are allocated
    at the first step and kept.  A step is zeroed_accumulators, then
    microbatch_grad for each microbatch, averaged and update (the dry run,
    launch/dryrun.py, traces those parts)."""
    held: Dict[str, Any] = {}

    def train_step(params, opt_state: AdamWState, batch):
        loss, metrics, grads = value_and_grad(model, params, batch, spec, held.get("acc"))
        held["acc"] = grads
        new_params, new_state, opt_metrics = update(opt_cfg, params, opt_state, grads)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return train_step


def _tree_from_paths(like: Any, flat: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    """``like``'s structure with the leaf at each dotted path from ``flat``."""
    if isinstance(like, dict):
        return {k: _tree_from_paths(v, flat, f"{prefix}{k}.") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_tree_from_paths(v, flat, f"{prefix}{i}.") for i, v in enumerate(like)]
    return flat[prefix[:-1]]


def assign_(dst: Any, src: Any) -> None:
    """Copy each leaf of ``src`` into the leaf of ``dst`` at its path, in
    place (a restored checkpoint into a model's parameters or a state)."""
    flat = dict(tree_leaves(src))
    with torch.no_grad():
        for path, t in tree_leaves(dst):
            t.copy_(flat[path])
