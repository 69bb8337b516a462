# Multi-pod dry run, after the JAX package's launch/dryrun.py, with its
# names: reckon every (architecture x shape x mesh) cell against the
# production meshes, 16 x 16 ("data", "model") and 2 x 16 x 16 ("pod",
# "data", "model"), each read as that many H100s in that shape, and record
# per device the memory, the work and the collectives.  The reference
# compiles each cell for 512 fake XLA host devices; the port holds no
# 256-device program.  One process reckons a cell on the meta device, where
# nothing is computed or allocated, and needs no card.
#
# The reckoning:
#
# * State, exact.  Every leaf of the parameters, the optimizer state, the
#   batch and the cache counts at its shard shape under its spec on the
#   ``ProductionMesh`` stand-in (param_shardings / tree_shardings_from_axes
#   of batch_axes, cache_axes and decode_rules, equal to the reference's);
#   a dim a spec shards must divide evenly, as the reference's shard_shape
#   requires.  argument_bytes, output_bytes and alias_bytes follow; the
#   donated arguments are the reference's donate_argnums: the parameters
#   and optimizer state of a full train step, the cache of a decode step.
# * Work, from one traced step.  The cell's program runs once on meta under
#   roofline/op_count's counter: one microbatch at one device's rows,
#   global_batch / microbatches / dp (at least 1), at full width.  Its work
#   counts (global rows / traced rows) x microbatches times (hlo_parse
#   folds a while body by its trip count), the step's own parts once (the
#   accumulators zeroed and divided; the AdamW update, which runs on one
#   device's shards, once a device); a device's
#   work is the global step's over n_devices, the identity
#   roofline/analysis.py states.  Compute that the specs replicate (norms
#   and elementwise ops on a residual stream 'model' does not split) is so
#   counted once, where the reference's per-device module counts it on
#   every device.  A train step is traced as make_train_step composes it:
#   train/step's zeroed_accumulators, microbatch_grad, averaged, update.
# * Activations, temp_bytes.  The peak of live bytes over the trace, at one
#   device's rows.  A leaf's gradient and its accumulator count at their
#   shard size under the parameter's spec, a tensor pinned by shardctx (the
#   residual stream that remat saves, the MoE buffers) at its shard size
#   under the pin's spec, an output at its size in the record; everything
#   else at its traced size, an upper bound wherever 'model' would split
#   it.  peak_device_bytes = argument + output + temp - alias, as the
#   reference's: the arguments and the step's peak beyond them.
# * Collectives, reckoned from the specs and the trace, not read from a
#   program (there is no compiler here to insert them).  Operand bytes, as
#   hlo_parse counts them: the payload leaving the device.  How often each
#   falls follows the reference's program compiled at a (2, 4) fake mesh
#   (PERF.md): per microbatch, inside the layer loop.
#   - FSDP: a leaf sharded over a data axis is all-gathered over it before
#     each use, in the forward, the forward that remat recomputes and the
#     backward, and its gradient reduce-scattered, each microbatch;
#   - data parallelism: a gradient the data axes replicate is all-reduced
#     over them each microbatch, at the accumulators' type;
#   - tensor parallelism: a product that contracts a dim a spec shards over
#     'model' (a weight's, or the MoE hidden buffer's) all-reduces its
#     output over 'model', forward and backward (op_count);
#   - experts: with moe_ep the expert buffers are exchanged all to all over
#     'model' at each pin, forward and backward (op_count).
#
# The record keeps the reference's keys where the quantity is the same; it
# has t_trace_s for t_lower_s and t_compile_s, and ``ops`` for ``hlo``.  It
# has no xla_cost: that is XLA's own cost analysis, which visits a while
# body once (the undercount hlo_parse exists to correct).
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell, get_config, list_archs, valid_cells
from repro_torch.launch.mesh import dp_axes, dp_size, make_production_mesh
from repro_torch.launch.sharding import (
    P,
    batch_axes,
    decode_rules,
    param_pspecs,
    spec_from_axes,
    train_rules,
)
from repro_torch.launch.specs import input_specs
from repro_torch.models import rwkv6, shardctx
from repro_torch.models.common import tree_leaves
from repro_torch.models.shardctx import mesh_axis_names, mesh_axis_sizes
from repro_torch.models.transformer import Model, cache_axes, cache_init, forward, lm_loss, prefill_forward
from repro_torch.roofline.op_count import OpCounter
from repro_torch.train import step as train_step
from repro_torch.train.optimizer import AdamWConfig, adamw_init_abstract

NOTES = ("no xla_cost: the reference's own cost analysis visits a while body once",
         "temp_bytes counts tensors the trace holds whole at their traced size: an upper bound where "
         "'model' would split them")


# ---------------------------------------------------------------------------
# State at its shard size
# ---------------------------------------------------------------------------


def shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shard of ``shape`` under ``spec``; a dim must divide evenly."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        k = math.prod(sizes[a] for a in ((part,) if isinstance(part, str) else part or ()))
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {part} ({k} devices)")
        out.append(n // k)
    return tuple(out)


def shard_bytes(t: torch.Tensor, spec, mesh) -> int:
    return math.prod(shard_shape(tuple(t.shape), spec, mesh)) * t.element_size()


def _walk(tree: Any, axes: Any):
    """(leaf, its axes) of a tree of dicts and lists with a congruent axes
    tree (an axes leaf is a tuple)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, axes[k])
    elif isinstance(tree, list):
        for v, a in zip(tree, axes):
            yield from _walk(v, a)
    else:
        yield tree, axes


def _flat_specs(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{dotted path: spec} of a spec tree (a spec is a tuple, so
    tree_leaves, which walks tuples, would split it)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat_specs(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat_specs(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _map_paths(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``tree`` (dicts and lists) with each leaf replaced by fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def tree_spec_bytes(tree: Any, axes: Any, rules, mesh) -> int:
    """Bytes a device holds of ``tree`` (its leaves' logical axes ``axes``)."""
    return sum(shard_bytes(t, spec_from_axes(a, tuple(t.shape), rules, mesh), mesh) for t, a in _walk(tree, axes))


def _int8_scale_spec(spec, ndim: int):
    """The reference's _opt_shardings: an int8 moment's scale keeps the
    parameter's spec but for its last dim."""
    parts = list(spec)
    if len(parts) == ndim and parts:
        parts[-1] = None
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def param_state_bytes(params: Any, specs: Any, mesh, state_dtype: Optional[str]) -> Tuple[int, int]:
    """(the parameters' bytes a device, with the AdamW state's when
    ``state_dtype`` is given: f32 master, m and v, or m and v as int8 with
    f32 row scales; the step)."""
    flat_s = _flat_specs(specs)
    p_bytes = opt = 0
    for path, p in tree_leaves(params):
        spec = flat_s[path]
        n = math.prod(shard_shape(tuple(p.shape), spec, mesh))
        p_bytes += n * p.element_size()
        if state_dtype == "int8":
            scale = shard_shape(tuple(p.shape[:-1]) + (1,) if p.dim() else (), _int8_scale_spec(spec, p.dim()), mesh)
            opt += n * 4 + 2 * (n + 4 * math.prod(scale))
        elif state_dtype is not None:
            opt += 3 * n * 4
    return p_bytes, opt + (4 if state_dtype is not None else 0)


# ---------------------------------------------------------------------------
# A cell
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """One (arch, shape, mesh) cell: ``run(counter)`` traces its program on
    meta under the counter and returns the bytes a device of its outputs
    that no spec places (metrics, logits: their traced size); ``state``
    holds argument_bytes, alias_bytes and output_state_bytes (the outputs a
    spec places, at their shard size)."""
    run: Callable[[OpCounter], int]
    state: Dict[str, int]
    meta: Dict[str, Any]


def _rows(n: int, dp: int) -> int:
    return max(1, n // dp)


def _meta_batch(cfg: ArchConfig, cell: ShapeCell, rows: int) -> Dict[str, torch.Tensor]:
    return input_specs(cfg, dataclasses.replace(cell, global_batch=rows))


def _scale_outputs(counter: OpCounter, outs: List[Tuple[torch.Tensor, float]]) -> None:
    """Each in-trace output a spec places counts at its shard's bytes."""
    for t, nbytes in outs:
        traced = t.numel() * t.element_size()
        if traced:
            counter.scale_storage(t, nbytes / traced)


def _traced_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _gather_collectives(counter: OpCounter, params: Any, specs: Any, mesh, uses: Callable[[str], int]) -> None:
    """FSDP's all-gathers: each leaf sharded over a data axis, its shard
    once a use (``uses(path)`` a microbatch or step)."""
    flat_s = _flat_specs(specs)
    data = set(dp_axes(mesh))
    for path, p in tree_leaves(params):
        spec = flat_s[path]
        axes = tuple(a for part in spec for a in ((part,) if isinstance(part, str) else part or ()) if a in data)
        if axes:
            counter.add_collective("all-gather", axes, shard_bytes(p, spec, mesh), uses(path))


def _grad_collectives(counter: OpCounter, params: Any, specs: Any, mesh, accum: torch.dtype) -> None:
    """A microbatch's gradient exchanges at the accumulators' type: a leaf
    sharded over data axes reduce-scattered over them (its operand the
    gradient the other axes leave), else all-reduced over every data
    axis."""
    flat_s = _flat_specs(specs)
    data = dp_axes(mesh)
    elem = torch.empty((), dtype=accum).element_size()
    for path, p in tree_leaves(params):
        spec = flat_s[path]
        named = [a for part in spec for a in ((part,) if isinstance(part, str) else part or ())]
        on_data = tuple(a for a in named if a in data)
        others = P(*[tuple(a for a in ((part,) if isinstance(part, str) else part or ()) if a not in data) or None
                     for part in spec])
        nbytes = math.prod(shard_shape(tuple(p.shape), others, mesh)) * elem
        if on_data:
            counter.add_collective("reduce-scatter", on_data, nbytes)
        else:
            counter.add_collective("all-reduce", data, nbytes)


def build_cell(arch: str, shape: Union[str, ShapeCell], multi_pod: bool, probe: Optional[Dict[str, Any]] = None,
               *, cfg: Optional[ArchConfig] = None, mesh: Any = None) -> Tuple[Cell, Any]:
    """Returns (cell, mesh).  ``probe`` options are the reference's
    (``--opt`` takes ``opt_probe``): mode 'full' | 'grad' | 'fwd',
    microbatches, accum_dtype, remat, remat_block, wkv_method,
    hidden_model_shard, no_fsdp, moe_ep, no_moe_pins, opt_state, kv_int8.
    ``shape`` may be a ShapeCell, ``cfg`` replaces the arch's config (a
    cut one) and ``mesh`` the production mesh (another stand-in)."""
    probe = probe or {}
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    cfg = cfg if cfg is not None else get_config(arch)
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    if probe.get("remat_block"):
        k = int(probe["remat_block"])
        cfg = dataclasses.replace(cfg, layer_pattern=cfg.layer_pattern * k)
    dp = dp_size(mesh)
    dpx = dp_axes(mesh)
    nsx = dpx if len(dpx) > 1 else dpx[0]
    n_devices = math.prod(mesh_axis_sizes(mesh).values())
    # one device's rows hold one group of the dispatch (the reference's
    # dispatch_shards = dp groups over the global batch, a group a device)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch_shards=1))
    model = Model(cfg, device="meta")
    params = model.params
    defs = model.defs()
    specs: Dict[str, Any] = {}

    if cell.kind in ("train", "prefill"):
        microbatches = probe.get("microbatches") or (max(1, cell.global_batch // dp) if cell.kind == "train" else 1)
        per_mb = cell.global_batch // microbatches
        if per_mb % dp == 0:
            specs["hidden"] = P(nsx, None, "model" if probe.get("hidden_model_shard") else None)
    if cfg.moe is not None and cell.kind in ("train", "prefill") and not probe.get("no_moe_pins"):
        if probe.get("moe_ep"):
            specs.update(moe_xin=P(nsx, "model", None, None), moe_h=P(nsx, "model", None, None),
                         moe_y=P(nsx, "model", None, None))
        else:
            specs.update(moe_xin=P(nsx, None, None, None), moe_h=P(nsx, None, None, "model"),
                         moe_y=P(nsx, None, None, None))

    meta: Dict[str, Any] = {}
    quant = bool(probe.get("kv_int8"))
    if cell.kind == "train":
        rules = train_rules(mesh, cfg)
        if probe.get("moe_ep"):
            rules["experts"] = ["model"]
        if probe.get("no_fsdp"):
            rules["embed"] = []
        state_dtype = probe.get("opt_state", "f32")
        accum = torch.bfloat16 if probe.get("accum_dtype") == "bf16" else torch.float32
        microbatches = probe.get("microbatches", max(1, cell.global_batch // dp))
        remat = probe.get("remat", True)
        spec = train_step.TrainSpec(microbatches=1, remat=remat, accum_dtype=accum)
        mode = probe.get("mode", "full")
        p_specs = param_pspecs(defs, rules, mesh)
        b_global = input_specs(cfg, cell)
        b_bytes = tree_spec_bytes(b_global, batch_axes(cfg, "train"), rules, mesh)
        p_bytes, opt_bytes = param_state_bytes(params, p_specs, mesh, state_dtype if mode == "full" else None)
        per_mb = cell.global_batch // microbatches
        rows = _rows(per_mb, dp)
        flat_s = _flat_specs(p_specs)

        def frac(path: str, p: torch.Tensor) -> float:
            return math.prod(shard_shape(tuple(p.shape), flat_s[path], mesh)) / max(p.numel(), 1)

        def uses(path: str) -> int:
            return 3 if remat and path.startswith(("groups.", "shared.")) else 2

        fwd_rows = _rows(cell.global_batch, dp)
        # the arguments, made before the trace; the AdamW update runs on one
        # device's shards (its temporaries and work are a device's), so it
        # takes the parameters, state and gradient at their shard shapes
        batch = _meta_batch(cfg, cell, fwd_rows if mode == "fwd" else rows)

        def shard_of(path: str, p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
            return torch.empty(shard_shape(tuple(p.shape), flat_s[path], mesh), dtype=dtype, device="meta")

        p_shard = _map_paths(lambda path, p: shard_of(path, p, p.dtype), params)
        opt_shard = adamw_init_abstract(p_shard, state_dtype)
        acc_shard = {path: shard_of(path, p, accum) for path, p in tree_leaves(params)}

        def run(counter: OpCounter) -> int:
            if mode == "fwd":
                with counter.repeated(cell.global_batch / fwd_rows, 1):
                    _gather_collectives(counter, params, p_specs, mesh, lambda path: 1)
                    loss, _ = lm_loss(params, batch, cfg, remat=False)
                return _traced_bytes(loss)
            acc = train_step.zeroed_accumulators(params, spec)
            flat_p = dict(tree_leaves(params))
            for path, t in acc.items():
                counter.scale_storage(t, frac(path, flat_p[path]))
                counter.accumulate_into(t, frac(path, flat_p[path]))
            with counter.repeated(microbatches * per_mb / rows, microbatches):
                _gather_collectives(counter, params, p_specs, mesh, uses)
                _grad_collectives(counter, params, p_specs, mesh, accum)
                loss, metrics = train_step.microbatch_grad(model, params, batch, spec, acc)
            train_step.averaged(acc, microbatches)
            if mode == "grad":
                return _traced_bytes(loss)
            with counter.repeated(n_devices, 1):
                _, _, opt_metrics = train_step.update(AdamWConfig(state_dtype=state_dtype), p_shard, opt_shard,
                                                      acc_shard)
            return _traced_bytes(loss, *metrics.values(), *opt_metrics.values())

        elem = torch.empty((), dtype=accum).element_size()
        grads = sum(math.prod(shard_shape(tuple(p.shape), flat_s[path], mesh)) * elem
                    for path, p in tree_leaves(params))
        alias = p_bytes + opt_bytes if mode == "full" else 0
        out_state = {"full": p_bytes + opt_bytes, "grad": grads, "fwd": 0}[mode]
        state = {"argument_bytes": p_bytes + opt_bytes + b_bytes, "alias_bytes": alias,
                 "output_state_bytes": out_state}
        meta = {"microbatches": microbatches, "probe": {k: str(v) for k, v in probe.items()}}
        trace = {"rows": rows, "microbatch_rows": per_mb}
    elif cell.kind == "prefill":
        rules = train_rules(mesh, cfg)
        p_specs = param_pspecs(defs, rules, mesh)
        b_global = input_specs(cfg, cell)
        b_bytes = tree_spec_bytes(b_global, batch_axes(cfg, "prefill"), rules, mesh)
        p_bytes, _ = param_state_bytes(params, p_specs, mesh, None)
        rows = _rows(cell.global_batch, dp)
        d_rules = decode_rules(mesh, cfg, cell)
        c_global = cache_init(cfg, cell.global_batch, cell.seq_len, quantized=quant, device="meta")
        c_axes = cache_axes(cfg, quantized=quant)

        batch = _meta_batch(cfg, cell, rows)

        def run(counter: OpCounter) -> int:
            with counter.repeated(cell.global_batch / rows, 1), torch.no_grad():
                _gather_collectives(counter, params, p_specs, mesh, lambda path: 1)
                if cfg.family == "audio":
                    logits, _ = forward(params, batch, cfg)
                    return _traced_bytes(logits)
                logits, cache = prefill_forward(params, batch, cfg, quantize_cache=quant)
            _scale_outputs(counter, [(t, shard_bytes(g, spec_from_axes(ax, tuple(g.shape), d_rules, mesh), mesh))
                                     for (t, ax), (g, _) in zip(_walk(cache, c_axes), _walk(c_global, c_axes))])
            return _traced_bytes(logits)

        out_state = 0 if cfg.family == "audio" else tree_spec_bytes(c_global, c_axes, d_rules, mesh)
        state = {"argument_bytes": p_bytes + b_bytes, "alias_bytes": 0, "output_state_bytes": out_state}
        trace = {"rows": rows}
    else:  # decode
        rules = decode_rules(mesh, cfg, cell)
        p_specs = param_pspecs(defs, rules, mesh)
        c_global = cache_init(cfg, cell.global_batch, cell.seq_len, quantized=quant, device="meta")
        c_axes = cache_axes(cfg, quantized=quant)
        c_bytes = tree_spec_bytes(c_global, c_axes, rules, mesh)
        b_bytes = tree_spec_bytes(input_specs(cfg, cell), batch_axes(cfg, "decode"), rules, mesh)
        p_bytes, _ = param_state_bytes(params, p_specs, mesh, None)
        rows = _rows(cell.global_batch, dp)

        cache = cache_init(cfg, rows, cell.seq_len, quantized=quant, device="meta")
        batch = _meta_batch(cfg, cell, rows)

        def run(counter: OpCounter) -> int:
            with counter.repeated(cell.global_batch / rows, 1), torch.no_grad():
                _gather_collectives(counter, params, p_specs, mesh, lambda path: 1)
                logits, _ = model.decode_step(cache, batch)
            return _traced_bytes(logits)

        state = {"argument_bytes": p_bytes + c_bytes + b_bytes, "alias_bytes": c_bytes, "output_state_bytes": c_bytes}
        trace = {"rows": rows}

    def traced(counter: OpCounter) -> int:
        flat_s = _flat_specs(p_specs)
        for path, p in tree_leaves(params):
            counter.register_sharded(p, flat_s[path])
        prev = rwkv6.DEFAULT_METHOD
        if probe.get("wkv_method"):
            rwkv6.DEFAULT_METHOD = probe["wkv_method"]
        try:
            with shardctx.reckoning(mesh), shardctx.installed(specs, mesh):
                return run(counter)
        finally:
            rwkv6.DEFAULT_METHOD = prev

    meta.update({
        "arch": arch,
        "shape": cell.name,
        "kind": cell.kind,
        "mesh": "x".join(str(s) for s in mesh_axis_sizes(mesh).values()),
        "axes": list(mesh_axis_names(mesh)),
        "n_devices": int(n_devices),
        "n_params": model.n_params(),
        "traced": trace,
    })
    return Cell(traced, state, meta), mesh


def run_cell(arch: str, shape: Union[str, ShapeCell], multi_pod: bool, outdir: Optional[str],
             analyze_ops: bool = True, probe: Optional[Dict[str, Any]] = None, tag: str = "", *,
             cfg: Optional[ArchConfig] = None, mesh: Any = None) -> Dict[str, Any]:
    """Reckon one cell; write its record to ``outdir`` (None: write
    nothing) and return it."""
    t0 = time.time()
    cell, mesh = build_cell(arch, shape, multi_pod, probe=probe, cfg=cfg, mesh=mesh)
    sizes = mesh_axis_sizes(mesh)
    counter = OpCounter(sizes, dp_axes(mesh))
    with counter:
        out_bytes = cell.state["output_state_bytes"] + cell.run(counter)
    t_trace = time.time() - t0
    t1 = time.time()
    peak = counter.peak_bytes()
    arg, alias = cell.state["argument_bytes"], cell.state["alias_bytes"]
    temp = max(0, int(round(peak)) - (out_bytes - alias))
    rec: Dict[str, Any] = dict(cell.meta)
    rec.update({
        "ok": True,
        "t_trace_s": round(t_trace, 2),
        "memory": {
            "argument_bytes": int(arg),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(temp),
            "alias_bytes": int(alias),
            "peak_device_bytes": int(arg + out_bytes + temp - alias),
        },
        "notes": list(NOTES),
    })
    if analyze_ops:
        ops = counter.record(rec["n_devices"])
        ops["t_analyze_s"] = round(time.time() - t1, 2)
        rec["ops"] = ops
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fname = f"{arch}__{rec['shape']}__{'multi' if multi_pod else 'single'}{suffix}.json"
        with open(os.path.join(outdir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def opt_probe(cfg, cell) -> Dict[str, Any]:
    """The reference's promoted optimization set: SP-sharded saved
    activations, bf16 gradient accumulation, expert parallelism for MoE,
    int8 optimizer state where fp32 Adam cannot fit, an int8 KV cache."""
    p: Dict[str, Any] = {}
    if cell.kind == "train":
        p["accum_dtype"] = "bf16"
        p["hidden_model_shard"] = True
    if cfg.moe is not None:
        p["moe_ep"] = True
    if cfg.arch_id in ("dbrx-132b", "llama4-scout-17b-a16e") and cell.kind == "train":
        p["opt_state"] = "int8"
    if cell.kind in ("decode", "prefill") and cfg.family not in ("ssm", "audio"):
        p["kv_int8"] = True
    return p


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run, reckoned on the meta device")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--outdir", default="runs/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-ops", action="store_true", help="leave the op counts out of the record")
    ap.add_argument("--opt", action="store_true", help="apply the promoted optimization preset")
    ap.add_argument("--baseline", action="store_true", help="paper-faithful baseline (no MoE pins)")
    args = ap.parse_args(argv)

    cells = []
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    for arch in archs:
        cfg = get_config(arch)
        shapes = valid_cells(cfg) if args.shape is None else [args.shape]
        for shape in shapes:
            for mp in ([False] if args.mesh == "single" else [True] if args.mesh == "multi" else [False, True]):
                cells.append((arch, shape, mp))

    t0 = time.time()
    results = []
    for arch, shape, mp in cells:
        tag = f"{arch} x {shape} x {'multi' if mp else 'single'}"
        fname = os.path.join(args.outdir, f"{arch}__{shape}__{'multi' if mp else 'single'}.json")
        if args.skip_existing and os.path.exists(fname):
            with open(fname) as f:
                prev = json.load(f)
            if prev.get("ok"):
                print(f"[skip] {tag}")
                continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            probe = opt_probe(get_config(arch), SHAPES[shape]) if args.opt else (
                {"no_moe_pins": True} if args.baseline else None)
            rec = run_cell(arch, shape, mp, args.outdir, analyze_ops=not args.no_ops, probe=probe)
            gb = rec["memory"]["peak_device_bytes"] / 1e9
            print(f"  ok: {gb:.2f} GB/device, trace {rec['t_trace_s']}s, "
                  f"dot_flops {rec.get('ops', {}).get('dot_flops', 0):.3e}", flush=True)
            results.append(rec)
        except Exception as e:
            os.makedirs(args.outdir, exist_ok=True)
            with open(fname, "w") as f:
                json.dump({"arch": arch, "shape": shape, "ok": False, "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-4000:]}, f, indent=1)
            print(f"  FAIL: {type(e).__name__}: {str(e)[:300]}", flush=True)
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"done: {n_ok}/{len(cells)} cells ok in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
