# The port's mesh layer (launch/mesh.py, launch/sharding.py, launch/specs.py,
# models/shardctx.py and the tree helpers they read) on the CPU against the
# JAX package's own functions:
#
# * for every arch at its published size, on the one-device smoke mesh (the
#   port's a real DeviceMesh over gloo, the reference's jax's) and on
#   stand-ins of the production meshes, (16, 16) ("data", "model") and
#   (2, 16, 16) ("pod", "data", "model") (the reference's read as
#   tests/test_system.py's _fake_mesh reads them): the rules, and under
#   train_rules and under decode_rules of every valid cell, the parameter
#   specs of model_defs, the decode cells' cache specs (cache_axes over
#   cache_abstract) and every cell's batch specs (batch_axes over
#   input_specs), each equal to the reference's PartitionSpec read as a
#   tuple, exactly;
# * Model.abstract_params, the cache on the meta device and
#   adamw_init_abstract (f32 and int8) against the reference's
#   ShapeDtypeStructs: every leaf's shape and dtype, nothing allocated;
# * the constraint points: constrain_hidden and the MoE pins called as
#   often in one forward and one prefill of each reduced arch as the
#   reference's (counted at run time there, by a jax.debug.callback in each
#   patched point, since the reference's scan traces its body once);
# * with the one-device specs a prefill cell installs (the hidden layout,
#   and the MoE pins of an MoE arch), forward and prefill outputs bit for
#   bit those without; a spec over a larger mesh refused;
# * param_shardings on the DeviceMesh name the DTensor placements of each
#   spec, and distribute_tensor takes them.
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JaxP

from repro.configs import base as jax_base
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models import shardctx as jshardctx
from repro.models import transformer as jtransformer
from repro.train import optimizer as jopt
from repro_torch.configs import base
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import specs as tspecs
from repro_torch.models import shardctx
from repro_torch.models import transformer
from repro_torch.models.common import tree_leaves
from repro_torch.train import optimizer as topt
from test_torch_threads import cap_torch_threads

cap_torch_threads()

ARCHS = base.list_archs()
MESHES = ["smoke", "16x16", "2x16x16"]


@pytest.fixture(scope="module")
def smoke_mesh():
    """The port's one-device DeviceMesh (a one-process gloo group from a
    HashStore), torn down after the module if it started the group."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    mesh = tmesh.make_smoke_mesh("cpu")
    yield mesh
    if started:
        dist.destroy_process_group()


class _Standin:
    """The reference's view of a production mesh: shape and axis names."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _meshes(which, smoke_mesh):
    """(port's mesh, reference's mesh)."""
    if which == "smoke":
        return smoke_mesh, jmesh.make_smoke_mesh()
    port = tmesh.make_production_mesh(multi_pod=which == "2x16x16")
    return port, _Standin(port.axis_names, port.sizes)


def _flat_ref(tree):
    """{dotted path: leaf} of a reference tree whose leaves are
    PartitionSpecs, ShapeDtypeStructs or axes tuples."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JaxP, jax.ShapeDtypeStruct, tuple)))[0]
    return {".".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))) for p in path): leaf
            for path, leaf in leaves}


def _flat_port(tree, prefix=""):
    """{dotted path: leaf} of a port tree of dicts and lists (a spec is a
    tuple, so tree_leaves, which walks tuples, would split it)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat_port(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat_port(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _specs_equal(port_tree, ref_tree, what):
    got = {k: tuple(v.spec if isinstance(v, tsharding.NamedSharding) else v) for k, v in _flat_port(port_tree).items()}
    want = {k: tuple(v) for k, v in _flat_ref(ref_tree).items()}
    assert got.keys() == want.keys(), what
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert bad == {}, what
    return len(got)


def _ref_tree_specs(abstract, axes, rules, mesh):
    """The reference's tree_shardings_from_axes, spec by spec: its own
    spec_from_axes mapped over its abstract tree with the congruent axes
    tree (a stand-in mesh cannot carry a NamedSharding)."""
    return jax.tree.map(lambda sd, ax: jsharding.spec_from_axes(ax, sd.shape, rules, mesh), abstract, axes)


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(arch, which, smoke_mesh):
    cfg, jcfg = base.get_config(arch), jax_base.get_config(arch)
    port_mesh, ref_mesh = _meshes(which, smoke_mesh)
    assert tmesh.dp_axes(port_mesh) == jmesh.dp_axes(ref_mesh)
    assert tmesh.dp_size(port_mesh) == jmesh.dp_size(ref_mesh)
    defs, jdefs = transformer.model_defs(cfg), jtransformer.model_defs(jcfg)
    rule_sets = [("train", tsharding.train_rules(port_mesh, cfg), jsharding.train_rules(ref_mesh, jcfg))]
    for name in base.valid_cells(cfg):
        cell, jcell = base.SHAPES[name], jax_base.SHAPES[name]
        rule_sets.append((name, tsharding.decode_rules(port_mesh, cfg, cell),
                          jsharding.decode_rules(ref_mesh, jcfg, jcell)))
    n = 0
    for name, rules, jrules in rule_sets:
        assert rules == jrules, name
        n += _specs_equal(tsharding.param_pspecs(defs, rules, port_mesh),
                          jsharding.param_pspecs(jdefs, jrules, ref_mesh), (name, "params"))
        shard = tsharding.param_shardings(defs, rules, port_mesh)
        _specs_equal(shard, jsharding.param_pspecs(jdefs, jrules, ref_mesh), (name, "param_shardings"))
    for name in base.valid_cells(cfg):
        cell, jcell = base.SHAPES[name], jax_base.SHAPES[name]
        rules, jrules = ((tsharding.train_rules(port_mesh, cfg), jsharding.train_rules(ref_mesh, jcfg))
                         if cell.kind != "decode" else
                         (tsharding.decode_rules(port_mesh, cfg, cell), jsharding.decode_rules(ref_mesh, jcfg, jcell)))
        axes, jaxes = tsharding.batch_axes(cfg, cell.kind), jsharding.batch_axes(jcfg, cell.kind)
        assert axes == jaxes, name
        _specs_equal(tsharding.tree_shardings_from_axes(tspecs.input_specs(cfg, cell), axes, rules, port_mesh),
                     _ref_tree_specs(jspecs.input_specs(jcfg, jcell), jaxes, jrules, ref_mesh), (name, "batch"))
        if cell.kind == "decode":
            cax, jcax = transformer.cache_axes(cfg), jtransformer.cache_axes(jcfg)
            want = _ref_tree_specs(jspecs.decode_cache_specs(jcfg, jcell), jcax, jrules, ref_mesh)
            n += _specs_equal(tsharding.tree_shardings_from_axes(tspecs.decode_cache_specs(cfg, cell), cax, rules,
                                                                 port_mesh), want, (name, "cache"))
    assert n > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_helpers_match_the_reference(arch):
    """is_param_def, tree_logical_axes and tree_partition_specs (a rule
    dict of one mesh axis or None a logical axis) on model_defs at the
    published size, leaf by leaf as the reference's."""
    from repro.models import common as jcommon
    from repro_torch.models import common

    defs, jdefs = transformer.model_defs(base.get_config(arch)), jtransformer.model_defs(jax_base.get_config(arch))
    leaves = _flat_port(defs)
    assert leaves and all(common.is_param_def(d) for d in leaves.values())
    assert not common.is_param_def(next(iter(leaves.values())).axes)
    got, want = _flat_port(common.tree_logical_axes(defs)), _flat_ref(jcommon.tree_logical_axes(jdefs))
    assert got == want
    rules = {"embed": "data", "mlp": "model", "vocab": "model", "q_proj": "model", "heads": None}
    _specs_equal(common.tree_partition_specs(defs, rules), jcommon.tree_partition_specs(jdefs, rules), "rules")


def _shape_dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).split(".")[-1]
    return tuple(leaf.shape), str(jnp.dtype(leaf.dtype))


def _abstract_equal(port_tree, ref_tree, what):
    got = {k: _shape_dtype(v) for k, v in _flat_port(port_tree).items()}
    want = {k: _shape_dtype(v) for k, v in _flat_ref(ref_tree).items()}
    assert got == want, what
    assert all(v.device.type == "meta" for v in _flat_port(port_tree).values()), what


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_the_reference(arch):
    """Params, caches and AdamW state at the published size on the meta
    device: every leaf's shape and dtype as the reference's."""
    cfg, jcfg = base.get_config(arch), jax_base.get_config(arch)
    model = transformer.Model(cfg, device="meta")
    params = model.abstract_params()
    jparams = jtransformer.Model(jcfg).abstract_params()
    _abstract_equal(params, jparams, "params")
    for state_dtype in ("f32", "int8"):
        got, want = topt.adamw_init_abstract(params, state_dtype), jopt.adamw_init_abstract(jparams, state_dtype)
        assert tuple(got.step.shape) == () and got.step.dtype == torch.int32
        for part in ("master", "m", "v"):
            _abstract_equal(getattr(got, part), getattr(want, part), (state_dtype, part))
    for name in base.valid_cells(cfg):
        cell = base.SHAPES[name]
        if cell.kind == "decode":
            _abstract_equal(tspecs.decode_cache_specs(cfg, cell),
                            jspecs.decode_cache_specs(jcfg, jax_base.SHAPES[name]), name)
            _abstract_equal(model.cache_init(cell.global_batch, cell.seq_len, quantized=True),
                            jtransformer.cache_abstract(jcfg, cell.global_batch, cell.seq_len, True), name)
        _abstract_equal(tspecs.input_specs(cfg, cell), jspecs.input_specs(jcfg, jax_base.SHAPES[name]), name)


def _reduced_batch(cfg, S=16, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)}


def _port_model(arch):
    cfg = base.reduced_config(base.get_config(arch))
    return transformer.Model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_constraint_points_are_called_as_the_references(arch, monkeypatch):
    """constrain_hidden and the named pins, counted in one forward and one
    prefill of the reduced arch in both packages."""
    jcfg = jax_base.reduced_config(jax_base.get_config(arch))
    jparams = jax.jit(jtransformer.Model(jcfg).init_params)(jax.random.PRNGKey(0))
    model = _port_model(arch)
    batch = _reduced_batch(jcfg)
    counts = {"port": {}, "ref": {}}

    def bump(side, key):
        counts[side][key] = counts[side].get(key, 0) + 1

    def ref_point(key):
        def point(x, *name):
            k = key if not name else name[0]
            jax.debug.callback(lambda: bump("ref", (phase[0], k)))
            return x
        return point

    def port_point(key):
        def point(x, *name):
            bump("port", (phase[0], key if not name else name[0]))
            return x
        return point

    monkeypatch.setattr(jshardctx, "constrain_hidden", ref_point("hidden"))
    monkeypatch.setattr(jshardctx, "constrain", ref_point(None))
    monkeypatch.setattr(shardctx, "constrain_hidden", port_point("hidden"))
    monkeypatch.setattr(shardctx, "constrain", port_point(None))
    phase = ["forward"]
    jtransformer.forward(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        model(tbatch)
        phase[0] = "prefill"
        model.prefill(tbatch)
    jtransformer.prefill_forward(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    jax.effects_barrier()
    assert counts["port"] == counts["ref"]
    (pattern, repeats), _ = jcfg.scan_groups()
    assert counts["port"][("forward", "hidden")] == 1 + repeats * len(pattern)
    assert counts["port"][("prefill", "hidden")] == 1
    if jcfg.moe is not None:
        assert {k for _, k in counts["port"]} == {"hidden", "moe_xin", "moe_h", "moe_y"}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_specs_leave_outputs_bitwise(arch, smoke_mesh):
    model = _port_model(arch)
    batch = {k: torch.from_numpy(v) for k, v in _reduced_batch(model.cfg, seed=1).items()}
    outs = []
    for specs in ({}, tsharding.prefill_specs(smoke_mesh, model.cfg)):
        with shardctx.installed(specs, smoke_mesh), torch.no_grad():
            logits, _ = model(batch)
            last, cache = model.prefill(batch)
        outs.append([logits, last] + [t for _, t in tree_leaves(cache)])
    assert shardctx._HIDDEN_SPEC is None and shardctx._SPECS == {}
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_prefill_specs_are_the_dry_runs(smoke_mesh):
    """prefill_specs is what the JAX package's dry run installs for a
    prefill cell (launch/dryrun.py): its TP pins for an MoE arch."""
    P = tsharding.P
    dense, moe = base.get_config("starcoder2-3b"), base.get_config("dbrx-132b")
    assert tsharding.prefill_specs(smoke_mesh, dense) == {"hidden": P("data", None, None)}
    big = tmesh.make_production_mesh(multi_pod=True)
    assert tsharding.prefill_specs(big, moe) == {
        "hidden": P(("pod", "data"), None, None), "moe_xin": P(("pod", "data"), None, None, None),
        "moe_h": P(("pod", "data"), None, None, "model"), "moe_y": P(("pod", "data"), None, None, None)}


def test_specs_over_more_than_one_device_are_refused(smoke_mesh):
    P = tsharding.P
    for multi_pod in (False, True):
        big = tmesh.make_production_mesh(multi_pod=multi_pod)
        with pytest.raises(ValueError, match="one card"):
            shardctx.set_hidden_spec(P("data", None, None), big)
        with pytest.raises(ValueError, match="one card"):
            shardctx.set_spec("moe_h", P("data", None, None, "model"), big)
        with pytest.raises(ValueError, match="one card"):
            with shardctx.hidden_spec(P("data"), big):
                pass
    with pytest.raises(ValueError, match="without the mesh"):
        shardctx.set_hidden_spec(P("data"))
    with pytest.raises(ValueError, match="lacks"):
        shardctx.set_spec("moe_xin", P("pod"), smoke_mesh)
    assert shardctx._HIDDEN_SPEC is None and shardctx._SPECS == {}
    x = torch.ones(2, 3)
    with shardctx.hidden_spec(P("data", None), smoke_mesh):
        assert shardctx.constrain_hidden(x) is x
    with shardctx.hidden_spec(P("data", None, None), smoke_mesh):
        with pytest.raises(ValueError, match="dimensions"):
            shardctx.constrain_hidden(x)
    assert shardctx.constrain_hidden(x) is x and shardctx.constrain(x, "moe_xin") is x


def test_param_shardings_name_dtensor_placements(smoke_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    cfg = base.reduced_config(base.get_config("starcoder2-3b"))
    cfg_big = base.get_config("starcoder2-3b")
    rules = tsharding.train_rules(smoke_mesh, cfg_big)
    shard = tsharding.param_shardings(transformer.model_defs(cfg_big), rules, smoke_mesh)
    # embed (vocab, embed): vocab on 'model', embed on 'data'
    assert shard["embed"].spec == ("model", "data")
    assert shard["embed"].placements == (Shard(1), Shard(0))
    assert shard["final_norm"].spec == () and shard["final_norm"].placements == (Replicate(), Replicate())
    assert tsharding.replicated(smoke_mesh).placements == (Replicate(), Replicate())
    model = _port_model("starcoder2-3b")
    small = tsharding.param_shardings(transformer.model_defs(cfg), {"vocab": ["model"], "embed": ["data"]},
                                      smoke_mesh)
    t = model.params["embed"]
    d = distribute_tensor(t, smoke_mesh, small["embed"].placements)
    assert torch.equal(d.to_local(), t) and tuple(d.placements) == small["embed"].placements
