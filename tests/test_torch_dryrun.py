# The port's dry run (launch/dryrun.py), its op counter (roofline/op_count.py),
# the kernels' meta routes and shardctx.reckoning, on the CPU against the JAX
# package's own functions:
#
# * state bytes, exactly: for every arch, valid cell and production mesh
#   (16 x 16 and 2 x 16 x 16), with and without opt_probe, the port's
#   argument, alias and spec-placed output bytes against the sum over the
#   leaves of NamedSharding(AbstractMesh(sizes, names), spec).shard_shape,
#   the specs the reference's own (spec_from_axes over its abstract trees,
#   its dry run's _opt_shardings for the optimizer state);
# * XLA's memory_analysis() of the reference's run_cell at a (2, 4) fake
#   mesh (a subprocess with eight host devices) on a reduced dense train
#   cell: argument and alias bytes equal to the port's;
# * dot FLOPs at reduced configs on the (1, 1) mesh against hlo_parse of
#   the reference's step compiled on the one CPU device, within 1%.  Where
#   the two formulations differ by design, the function's own products are
#   exchanged before the comparison, at the call's shapes: the port's
#   kernels count their unmasked pairs (attention) or their own products
#   (WKV6), and B3-bwd recomputes q.k^T, where the reference's jnp
#   attention computes whole blocks and its autodiff saves; the port's SSD
#   takes C.B^T once a group where the reference's takes it a head.  The
#   reference's side is its attention's products from its blocking, its
#   WKV6 and SSD compiled alone (forward, and with the gradient for a train
#   cell); the port's the kernels' records and its SSD counted alone;
# * the counter on toys, the kernels' meta routes, and the stand-in specs
#   under reckoning.
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import base as jax_base
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models import transformer as jtransformer
from repro.roofline import hlo_parse
from repro.train import optimizer as jopt
from repro_torch.configs import base
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.sharding import P
from repro_torch.models import shardctx
from repro_torch.roofline import op_count
from test_torch_threads import cap_torch_threads, subprocess_env

cap_torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = base.list_archs()
ONE_CARD = tmesh.ProductionMesh(("data", "model"), (1, 1))


def _ref_dryrun():
    """The reference's launch/dryrun module, imported with the backend
    already up and XLA_FLAGS as it was (its import prepends 512 host
    devices to the flags, for a process of its own)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as rd

    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return rd


# ---------------------------------------------------------------------------
# state bytes
# ---------------------------------------------------------------------------


class _Standin:
    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _bytes(abstract, shardings) -> int:
    """Sum over the leaves of shard_shape's elements times the item size."""
    leaves = jax.tree.leaves(jax.tree.map(
        lambda sd, sh: int(np.prod(sh.shard_shape(sd.shape))) * jnp.dtype(sd.dtype).itemsize, abstract, shardings,
        is_leaf=lambda x: isinstance(x, NamedSharding)))
    return int(sum(leaves))


def _ref_state(arch, shape, multi_pod, probe):
    """(argument, alias, spec-placed output) bytes of the reference's cell."""
    rd = _ref_dryrun()
    probe = probe or {}
    port_mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    names, sizes = port_mesh.axis_names, port_mesh.sizes
    amesh = AbstractMesh(sizes, names)
    standin = _Standin(names, sizes)
    cfg, cell = jax_base.get_config(arch), jax_base.SHAPES[shape]
    model = jtransformer.Model(cfg)
    params = model.abstract_params()

    def shardings(abstract, axes, rules):
        return jax.tree.map(lambda sd, ax: NamedSharding(amesh, jsharding.spec_from_axes(ax, sd.shape, rules, standin)),
                            abstract, axes)

    def param_sh(rules):
        return jax.tree.map(lambda d: NamedSharding(amesh, jsharding.spec_from_axes(d.axes, d.shape, rules, standin)),
                            model.defs(), is_leaf=lambda x: hasattr(x, "axes"))

    if cell.kind == "train":
        rules = jsharding.train_rules(standin, cfg)
        if probe.get("moe_ep"):
            rules["experts"] = ["model"]
        if probe.get("no_fsdp"):
            rules["embed"] = []
        state_dtype = probe.get("opt_state", "f32")
        p_sh = param_sh(rules)
        o_sh = rd._opt_shardings(p_sh, amesh, state_dtype, defs=model.defs())
        opt = jopt.adamw_init_abstract(params, state_dtype)
        state = _bytes(params, p_sh) + _bytes(opt, o_sh)
        batch = _bytes(jspecs.input_specs(cfg, cell), shardings(jspecs.input_specs(cfg, cell),
                                                                jsharding.batch_axes(cfg, "train"), rules))
        return state + batch, state, state
    quant = bool(probe.get("kv_int8"))
    cache = jtransformer.cache_abstract(cfg, cell.global_batch, cell.seq_len, quantized=quant)
    c_axes = jtransformer.cache_axes(cfg, quantized=quant)
    if cell.kind == "prefill":
        rules = jsharding.train_rules(standin, cfg)
        p = _bytes(params, param_sh(rules))
        b = _bytes(jspecs.input_specs(cfg, cell),
                   shardings(jspecs.input_specs(cfg, cell), jsharding.batch_axes(cfg, "prefill"), rules))
        out = 0 if cfg.family == "audio" else _bytes(
            cache, shardings(cache, c_axes, jsharding.decode_rules(standin, cfg, cell)))
        return p + b, 0, out
    rules = jsharding.decode_rules(standin, cfg, cell)
    p = _bytes(params, param_sh(rules))
    c = _bytes(cache, shardings(cache, c_axes, rules))
    b = _bytes(jspecs.input_specs(cfg, cell),
               shardings(jspecs.input_specs(cfg, cell), jsharding.batch_axes(cfg, "decode"), rules))
    return p + c + b, c, c


@pytest.mark.parametrize("arch", ARCHS)
def test_state_bytes_equal_the_references_shard_bytes(arch):
    cfg = base.get_config(arch)
    n = 0
    for shape in base.valid_cells(cfg):
        for multi_pod in (False, True):
            for probe in (None, dryrun.opt_probe(cfg, base.SHAPES[shape])):
                cell, _ = dryrun.build_cell(arch, shape, multi_pod, probe=probe)
                got = (cell.state["argument_bytes"], cell.state["alias_bytes"], cell.state["output_state_bytes"])
                assert got == _ref_state(arch, shape, multi_pod, probe), (shape, multi_pod, probe)
                n += 1
    assert n == 4 * len(base.valid_cells(cfg))


def test_shard_shape_refuses_an_uneven_split():
    big = tmesh.make_production_mesh(multi_pod=True)
    assert dryrun.shard_shape((4096, 3072), P(("pod", "data"), "model"), big) == (128, 192)
    with pytest.raises(ValueError, match="divide"):
        dryrun.shard_shape((10,), P("data"), big)


_XLA_PROBE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
from jax.sharding import Mesh
from repro.launch import dryrun
from repro.configs.base import reduced_config
dryrun.make_production_mesh = lambda multi_pod=False: Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
get = dryrun.get_config
dryrun.get_config = lambda arch: reduced_config(get(arch))
fn, args, mesh, meta = dryrun.build_cell(sys.argv[1], sys.argv[2], False)
with mesh:
    m = fn.lower(*args).compile().memory_analysis()
print(json.dumps({"argument_bytes": int(m.argument_size_in_bytes), "alias_bytes": int(m.alias_size_in_bytes)}))
"""


def test_argument_and_alias_bytes_equal_xlas_memory_analysis():
    """The reference's run_cell compiled at a (2, 4) fake mesh on reduced
    starcoder2-3b's train_4k cell: XLA's argument and alias bytes."""
    arch, shape = "starcoder2-3b", "train_4k"
    out = subprocess.run([sys.executable, "-c", _XLA_PROBE, arch, shape], capture_output=True, text=True,
                         timeout=120, env=subprocess_env(PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    cell, _ = dryrun.build_cell(arch, shape, False, cfg=base.reduced_config(base.get_config(arch)),
                                mesh=tmesh.ProductionMesh(("data", "model"), (2, 4)))
    assert {k: cell.state[k] for k in want} == want


# ---------------------------------------------------------------------------
# dot FLOPs against the reference's HLO
# ---------------------------------------------------------------------------

SEQ, BATCH = 64, 2


def _ref_hlo_flops(arch, kind):
    """hlo_parse's dot FLOPs of the reference's dry-run program for reduced
    ``arch`` at a (SEQ x BATCH) cell of ``kind``, on the one CPU device."""
    from repro.models import shardctx as jshardctx

    rd = _ref_dryrun()
    saved = rd.make_production_mesh, rd.get_config, rd.SHAPES
    layout = jshardctx._HIDDEN_SPEC, dict(jshardctx._SPECS)
    rd.make_production_mesh = lambda multi_pod=False: jax.sharding.Mesh(
        np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rd.get_config = lambda a: jax_base.reduced_config(saved[1](a))
    rd.SHAPES = dict(saved[2], cell=jax_base.ShapeCell("cell", SEQ, BATCH, kind))
    try:
        fn, args, mesh, meta = rd.build_cell(arch, "cell", False)
        with mesh:
            compiled = fn.lower(*args).compile()
    finally:
        # build_cell installs its layout in the reference's shardctx for the
        # process; the tests after this one run without it
        rd.make_production_mesh, rd.get_config, rd.SHAPES = saved
        jshardctx.set_hidden_spec(layout[0])
        jshardctx._SPECS.clear()
        jshardctx._SPECS.update(layout[1])
    return hlo_parse.analyze(compiled.as_text()).dot_flops, meta


def _compiled_flops(fn, *args) -> float:
    return hlo_parse.analyze(jax.jit(fn).lower(*args).compile().as_text()).dot_flops


def _fwd_and_grad_flops(fn, args, diff):
    """(forward, forward and gradient in the args ``diff`` names) dot FLOPs
    of ``fn`` compiled alone."""
    def loss(*a):
        out = fn(*a)
        out = out[0] if isinstance(out, tuple) else out
        return jnp.sum(out.astype(jnp.float32))

    return _compiled_flops(fn, *args), _compiled_flops(jax.grad(loss, argnums=diff), *args)


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


def _ref_attention(cfg, kind, rows):
    """(forward, forward and gradient) products of the reference's attention
    formulation of a layer ``kind`` on ``rows`` of the cell, from its
    blocking: flash_attention_jnp computes every (1024-query, 1024-key)
    block whole, masked or not; banded_window_attention each W-query block
    against 2W keys.  Two products forward (q.k^T, p.v), four more in its
    autodiff (dp, dv, dq, dk)."""
    H, D = cfg.n_heads, cfg.resolved_head_dim
    if kind == "local" and SEQ > cfg.window:
        W = cfg.window
        pairs = -(-SEQ // W) * W * 2 * W
    else:
        blk = min(1024, SEQ)
        pairs = (-(-SEQ // blk) * blk) ** 2
    fwd = 4.0 * D * pairs * rows * H
    return fwd, 3 * fwd


def _ref_wkv(cfg, rows):
    """The reference's WKV6 formulation on ``rows``, its inputs, and the
    inputs its gradient takes (not S0: a train step starts from zeros)."""
    from repro.models import rwkv6 as jrwkv6

    K = cfg.ssm.head_size
    H = cfg.d_model // K
    t, f = _sds((rows, SEQ, H, K), jnp.bfloat16), _sds((rows, SEQ, H, K), jnp.float32)
    args = (t, t, t, f, _sds((H, K), jnp.bfloat16), _sds((rows, H, K, K), jnp.float32))
    return jrwkv6._wkv_chunked, args, (0, 1, 2, 3, 4)


def _ssd_shapes(cfg):
    from repro_torch.models.mamba2 import mamba2_dims

    _, H, Pd, N = mamba2_dims(cfg)
    return H, Pd, N, cfg.ssm.n_groups


def _ssd_exchange(cfg):
    """Per mamba2 layer: the reference's _ssd_chunked products compiled
    alone minus the port's ssd_batched counted alone, at the cell's shapes."""
    from repro.models import mamba2 as jmamba2
    from repro_torch.models import mamba2 as tmamba2

    H, Pd, N, G = _ssd_shapes(cfg)
    f32 = jnp.float32
    ref = _compiled_flops(lambda x, ld, b, c, s: jmamba2._ssd_chunked(x, ld, b, c, s, 64),
                          _sds((BATCH, SEQ, H, Pd), f32), _sds((BATCH, SEQ, H), f32),
                          _sds((BATCH, SEQ, H, N), f32), _sds((BATCH, SEQ, H, N), f32),
                          _sds((BATCH, H, Pd, N), f32))
    meta = dict(device="meta", dtype=torch.float32)
    counter = op_count.OpCounter()
    with counter, torch.no_grad():
        tmamba2.ssd_batched(torch.empty(BATCH, SEQ, H, Pd, **meta), torch.empty(BATCH, SEQ, H, **meta),
                            torch.empty(BATCH, SEQ, G, N, **meta), torch.empty(BATCH, SEQ, G, N, **meta),
                            torch.empty(BATCH, H, Pd, N, **meta), 64)
    return ref - counter.dot_flops


def _exchanged(cfg, kind, rec, microbatches):
    """The reference's products of the functions the port's kernels (and
    SSD) stand in for, minus the port's, for the whole cell."""
    from repro_torch.models.transformer import _layers

    train = kind == "train"
    rows = BATCH // microbatches
    measured = {}  # a layer kind's (forward, forward and gradient) products, measured once

    def products(k):
        if k not in measured:
            if k in ("global", "local", "bidir"):
                measured[k] = _ref_attention(cfg, k, rows)
            elif k == "rwkv":
                measured[k] = _fwd_and_grad_flops(*_ref_wkv(cfg, rows))
            else:
                assert k == "mamba2" and not train, k
                measured[k] = (_ssd_exchange(cfg), None)
        return measured[k]

    total = 0.0
    for group, _, layer_kind, shared in _layers(cfg):
        remat = train and group is not None
        for k in [layer_kind] + (["global"] if shared is not None else []):
            fwd, grad = products(k)
            total += (fwd * remat + grad) if train else fwd
    total *= microbatches
    return total - sum(v["flops"] for v in rec["ops"]["kernels"].values())


FLOP_CELLS = [("gemma2-9b", "prefill"), ("gemma2-9b", "train"), ("rwkv6-3b", "prefill"), ("rwkv6-3b", "train"),
              ("dbrx-132b", "prefill"), ("dbrx-132b", "train"), ("hubert-xlarge", "prefill"),
              ("hubert-xlarge", "train"), ("zamba2-7b", "prefill")]


@pytest.mark.parametrize("arch,kind", FLOP_CELLS)
def test_dot_flops_agree_with_the_references_hlo(arch, kind):
    want, meta = _ref_hlo_flops(arch, kind)
    cfg = base.reduced_config(base.get_config(arch))
    rec = dryrun.run_cell(arch, base.ShapeCell("cell", SEQ, BATCH, kind), False, None, cfg=cfg, mesh=ONE_CARD)
    microbatches = rec.get("microbatches", 1)
    assert microbatches == meta.get("microbatches", 1)
    got = rec["ops"]["dot_flops"] + _exchanged(cfg, kind, rec, microbatches)
    assert abs(got - want) <= 0.01 * want, (got, want, rec["ops"]["kernels"])


# ---------------------------------------------------------------------------
# the counter, the meta routes and the stand-in specs
# ---------------------------------------------------------------------------


def test_counter_folds_a_loop_of_matmuls():
    a = torch.empty(64, 64, device="meta")
    counter = op_count.OpCounter()
    with counter:
        for _ in range(5):
            b = a @ a
    assert counter.dot_flops == 5 * 2 * 64 ** 3
    assert counter.traffic_bytes == 5 * 3 * 64 * 64 * 4
    del b


def test_counter_weights_repeats_and_skips_views():
    x = torch.empty(8, 16, device="meta")
    counter = op_count.OpCounter()
    with counter:
        with counter.repeated(3, 2):
            y = x.t().reshape(16, 8)[2:]      # views move nothing
            z = torch.mm(y, x[:, :4])
            w = torch.relu(z) + 1.0           # elementwise: traffic, not fused traffic
            op_count.report_kernel("k", 10.0, 7.0)
    assert counter.dot_flops == 3 * (2 * 14 * 4 * 8) + 3 * 10.0
    mm_bytes = (14 * 8 + 8 * 4 + 14 * 4) * 4
    assert counter.fused_traffic_bytes == 3 * (mm_bytes + 7.0)
    assert counter.traffic_bytes == 3 * (mm_bytes + 7.0 + 2 * (2 * 14 * 4 * 4))
    assert counter.fused_traffic_bytes <= counter.traffic_bytes
    assert counter.kernels == {"k": {"calls": 2.0, "flops": 30.0, "bytes": 21.0}}
    del w


def test_counter_peak_of_a_hand_worked_sequence():
    """Live bytes: a 400 B, then b 800 B (1200), a freed (800), c 200 B on a
    view of b (1000), d 4000 B (5000) freed with c; the peak is 5000 B, and
    800 B stay live.  Rescaling b to a quarter lowers the peak by 600 B."""
    e = torch.empty(10, device="meta")
    counter = op_count.OpCounter()
    with counter:
        a = e.new_empty(100)
        b = a.new_empty(200) + 1.0
        del a
        c = b[:50] * 1.0
        d = torch.zeros(1000, device="meta")
        peak_live = counter.live_bytes()
        del c, d
    assert peak_live == 800 + 200 + 4000
    assert counter.live_bytes() == 800 and counter.peak_bytes() == 5000
    counter.scale_storage(b, 0.25)
    assert counter.peak_bytes() == 4400
    del b


def test_meta_routes_give_the_card_paths_shapes_and_types():
    bf = dict(device="meta", dtype=torch.bfloat16)
    q, k = torch.empty(2, 64, 8, 112, **bf), torch.empty(2, 64, 2, 112, **bf)
    counter = op_count.OpCounter()
    with counter:
        out, lse = flash_ops._forward(q, k, k, True, 0, 1.0, 0.0, with_lse=True)
        assert out.shape == q.shape and out.dtype == q.dtype and lse.shape == (2, 8, 64)
        assert lse.dtype == torch.float32
        grads = flash_ops._backward(q, k, k, out, lse, out, True, 0, 1.0, 0.0)
        assert [(g.shape, g.dtype) for g in grads] == [(t.shape, t.dtype) for t in (q, k, k)]
        assert flash_ops._forward(q, k, k, True, 16, 1.0, 0.0).shape == q.shape
        r = torch.empty(2, 48, 4, 64, **bf)
        lw, s0 = torch.empty(2, 48, 4, 64, device="meta"), torch.empty(2, 4, 64, 64, device="meta")
        u = torch.empty(4, 64, **bf)
        y, s = wkv6_ops._forward(r, r, r, lw, u, s0)
        assert (y.shape, y.dtype, s.shape, s.dtype) == (r.shape, torch.float32, s0.shape, torch.float32)
        g = wkv6_ops._backward(r, r, r, lw, u, s0, y, s)
        assert [(t.shape, t.dtype) for t in g] == [(r.shape, r.dtype)] * 3 + [
            (lw.shape, torch.float32), (u.shape, u.dtype), (s0.shape, torch.float32)]
    pairs = 64 * 65 // 2
    kern = counter.kernels
    assert kern["flash_attention"]["calls"] == 2
    assert kern["flash_attention"]["flops"] == 4 * 112 * 2 * 8 * (pairs + flash_ops.unmasked_pairs(64, 64, True, 16))
    assert kern["flash_attention_bwd"]["flops"] == 10 * 112 * 2 * 8 * pairs
    assert kern["wkv6"]["flops"] == 4 * 64 * 64 * 2 * 48 * 4 and kern["wkv6_bwd"]["flops"] == 10 * 64 * 64 * 2 * 48 * 4
    assert flash_ops.LAUNCHES == 0 and wkv6_ops.LAUNCHES == 0 and flash_ops.BWD_LAUNCHES == 0


def test_stand_in_specs_only_under_reckoning():
    big = tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="one card"):
        shardctx.set_hidden_spec(P("data", None, None), big)
    x = torch.empty(2, 8, 32, device="meta")
    counter = op_count.OpCounter(big.shape, ("data",))
    with counter, shardctx.reckoning(big), shardctx.installed({"hidden": P("data", None, "model"),
                                                                 "moe_h": P("data", None, None, "model")}, big):
        y = x * 1.0
        assert shardctx.constrain_hidden(y) is y
        h = torch.empty(1, 4, 8, 32, device="meta") * 1.0
        assert shardctx.constrain(h, "moe_h") is h
        live = counter.live_bytes()
    assert counter.pins == {"hidden": 1, "moe_h": 1}
    assert live == (2 * 8 * 32 + 4 * 8 * 32) * 4 / 16  # each at its shard ('model' splits their last dim)
    assert counter.collectives == {("all-gather", ("model",)): [2 * 8 * 32 * 4 / 16, 1.0]}
    assert shardctx._HIDDEN_SPEC is None and shardctx._RECKONING is None
    with pytest.raises(ValueError, match="one card"):
        shardctx.set_spec("moe_h", P("data", None, None, "model"), big)
    fake = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    with pytest.raises(ValueError, match="one card"):
        with shardctx.reckoning(fake):
            pass


def test_tensor_parallel_products_all_reduce_over_model():
    """A product contracting a weight's dim that 'model' shards all-reduces
    its output over 'model' (a row-parallel projection); one over a dim the
    data axes shard (FSDP, gathered first) or a column-parallel one does
    not."""
    sizes = {"data": 16, "model": 16}
    w_row = torch.empty(64, 32, device="meta")
    w_col = torch.empty(32, 64, device="meta")
    x = torch.empty(4, 64, device="meta")
    counter = op_count.OpCounter(sizes, ("data",))
    counter.register_sharded(w_row, P("model", "data"))
    counter.register_sharded(w_col, P("data", "model"))
    with counter:
        y = x @ w_row          # contracts w_row's 'model' dim
        z = y @ w_col          # contracts w_col's 'data' dim
        x @ z.new_empty(64, 8)
    assert counter.collectives == {("all-reduce", ("model",)): [4 * 32 * 4, 1.0]}
    del z
