# The port's MoE block (models/moe.py) on the CPU against the JAX package's
# (repro.models.moe), on the same inputs: x drawn with numpy from a seed,
# the block's weights from the reference's own init (tree_init of its
# moe_defs) carried across by params_from_jax.  Cases: reduced dbrx-132b
# (4 experts, top-2) and reduced llama4-scout (4 experts, top-1, a shared
# expert); x in bf16 and in f32 (with every weight in f32); one and two
# dispatch groups; the config's capacity factor and 0.5, which drops
# choices; and a forced tie, two router columns equal (and scaled up so
# that they often lead), which torch.topk may order either way and
# jax.lax.top_k orders by index.
#
# What each case holds:
# - the routing exactly: expert ids in top-k order, the sorted choices'
#   tokens and slots, the kept flags (the reference's weight is nonzero
#   exactly where it keeps a choice: its gate is a positive probability),
#   and the expert buffers xin bit for bit (a copy of x's rows);
# - the output within OUT_TOL of its dtype: 1e-5 in f32 (both packages
#   compute the same f32 operations; the products sum in another order),
#   2e-2 in bf16 (matmul outputs round to bf16 at the same places, their
#   f32 sums in another order);
# - lb_loss and router_z within rtol 1e-5 (f32 means over the tokens);
# - the gradient of a fixed scalar of the output and the aux losses with
#   respect to x, the router and every expert weight, against jax.grad,
#   within tests/test_torch_train.py's GRAD_REL and GRAD_TOL (its
#   _grads_agree).
#
# Also the helpers with which the whole-model tests (test_torch_models.py,
# test_torch_train.py) route the port's MoE blocks as the reference routed
# them.  Through a whole model the bf16 hidden states of the two packages
# differ by rounding (C19, C27), so a token whose reference margin between
# two adjacent probabilities of its top K + 1 is smaller than that
# difference may choose other experts in the port, and a changed choice
# moves the capacity drops of the tokens after it and, through attention,
# the later tokens.  ``reference_routing`` records, for each MoE block the
# reference runs, its router probabilities and expert ids;
# ``forced_routing`` routes each of the port's blocks by the ids of the
# recorded block whose probabilities lie nearest the port's, after
# checking each token where the port would choose otherwise: the choice
# may differ only where the reference's own margin is at most twice the
# largest difference between the two packages' probabilities at that token
# (both probabilities of the pair can move by that much).  The gates stay
# the port's own probabilities.  The tests count such tokens, and no token
# is left out of any comparison.
import contextlib
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jax_base
from repro.models import moe as jmoe
from repro.models import transformer as jax_transformer
from repro.models.common import tree_init
from repro_torch.configs import base
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax, tensor_from_numpy

from test_torch_train import _grads_agree
from test_torch_threads import cap_torch_threads

cap_torch_threads()

OUT_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
AUX_RTOL = 1e-5
B, S = 2, 32
LB_WEIGHT = 0.01  # lm_loss's weight of lb_loss

# (arch, x dtype, dispatch groups, capacity factor or None for the config's, tie)
CASES = [
    ("dbrx-132b", "bfloat16", 1, None, False),
    ("dbrx-132b", "bfloat16", 2, None, False),
    ("dbrx-132b", "float32", 1, 0.5, False),
    ("dbrx-132b", "bfloat16", 2, 0.5, False),
    ("dbrx-132b", "bfloat16", 1, None, True),
    ("llama4-scout-17b-a16e", "bfloat16", 1, None, False),
    ("llama4-scout-17b-a16e", "float32", 2, None, False),
    ("llama4-scout-17b-a16e", "bfloat16", 1, 0.5, False),
    ("llama4-scout-17b-a16e", "float32", 2, 0.5, True),
]


def _configs(arch, shards, cf):
    cfgs = []
    for pkg in (jax_base, base):
        cfg = pkg.reduced_config(pkg.get_config(arch))
        m = dataclasses.replace(cfg.moe, dispatch_shards=shards,
                                capacity_factor=cfg.moe.capacity_factor if cf is None else cf)
        cfgs.append(dataclasses.replace(cfg, moe=m))
    return cfgs


def _inputs(cfg, dtype, tie, seed=0):
    """x, the cotangent of the output, and the block's weights (numpy), the
    weights from the reference's init; in f32 every weight is f32."""
    params = jax.tree.map(np.asarray, tree_init(jmoe.moe_defs(cfg), jax.random.PRNGKey(seed)))
    if tie:
        router = params["router"].copy()
        router[:, 1:3] = 4.0 * router[:, 1:2]
        params["router"] = router
    if dtype == "float32":
        params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return x, cot, params


def _jax_side(cfg, x, cot, params, dtype):
    """The reference's routing (expert ids, slot, stok, kept flags, xin),
    output, aux and gradients."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    xj = jnp.asarray(x).astype(dtype)
    pj = jax.tree.map(jnp.asarray, params)
    T = B * S
    ns = m.dispatch_shards
    Tl = T // ns
    C = max(8, min(Tl, int(m.capacity_factor * K * Tl / E)))

    @jax.jit
    def routing(xj, pj):
        xt = xj.reshape(T, -1)
        logits = xt.astype(jnp.float32) @ pj["router"]
        ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)[1]
        route = partial(jmoe._route_group, E=E, K=K, C=C)
        xin, slot, stok, weight, _ = jax.vmap(route)(xt.reshape(ns, Tl, -1), logits.reshape(ns, Tl, E))
        return ids.reshape(ns, Tl, K), slot, stok, weight != 0, xin, logits

    def scalar(xj, pj):
        out, aux = jmoe.moe_block(pj, xj, cfg)
        return (jnp.sum(out.astype(jnp.float32) * cot) + LB_WEIGHT * aux["lb_loss"]
                + m.router_z_loss * aux["router_z"]), (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(scalar, argnums=(0, 1), has_aux=True))(xj, pj)
    ids, slot, stok, keep, xin, logits = routing(xj, pj)
    return dict(expert_ids=ids, slot=slot, stok=stok, keep=keep, xin=xin, logits=logits, out=out, aux=aux,
                grads={"x": grads[0], **grads[1]}, C=C)


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


@pytest.mark.parametrize("arch,dtype,shards,cf,tie", CASES)
def test_moe_block_matches_reference(arch, dtype, shards, cf, tie):
    jcfg, cfg = _configs(arch, shards, cf)
    x, cot, params = _inputs(jcfg, dtype, tie)
    want = _jax_side(jcfg, x, cot, params, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    xt = tensor_from_numpy(x).to(tdt).requires_grad_()
    p = {k: v.requires_grad_() for k, v in params_from_jax(params).items()}
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    T = B * S
    ns, C = moe.capacity(cfg, T)
    assert (ns, C) == (shards, want["C"])

    # the routing, exactly
    with torch.no_grad():
        logits = xt.reshape(T, -1).float() @ p["router"]
        r = moe.route(logits.reshape(ns, T // ns, E), E=E, K=K, C=C, dtype=tdt)
        xin = moe.dispatch(xt.reshape(ns, T // ns, -1), r, E, C)
    if tie:
        probs = np.asarray(jax.nn.softmax(want["logits"], axis=-1))
        assert np.array_equal(probs[:, 1], probs[:, 2])  # the reference's own probabilities tie
        assert np.any(np.asarray(want["expert_ids"])[..., 0] == 1)
    for name in ("expert_ids", "slot", "stok", "keep"):
        ref = np.array(want[name])
        assert torch.equal(getattr(r, name), torch.from_numpy(ref.astype(np.int64) if name != "keep" else ref)), name
    if cf == 0.5:
        assert not bool(r.keep.all())  # the case drops choices
    assert torch.equal(xin, tensor_from_numpy(np.asarray(want["xin"])))

    # the output and the aux losses
    out, aux = moe.moe_block(p, xt, cfg)
    assert out.dtype == tdt and out.shape == xt.shape
    np.testing.assert_allclose(_np64(out), _np64(want["out"]), **OUT_TOL[dtype])
    for k in ("lb_loss", "router_z"):
        np.testing.assert_allclose(float(aux[k].detach()), float(want["aux"][k]), rtol=AUX_RTOL, err_msg=k)

    # the gradients
    scalar = ((out.float() * torch.from_numpy(cot)).sum() + LB_WEIGHT * aux["lb_loss"]
              + m.router_z_loss * aux["router_z"])
    names = ["x"] + sorted(p)
    got = dict(zip(names, torch.autograd.grad(scalar, [xt] + [p[n] for n in names[1:]])))
    wanted = {n: _np64(g) for n, g in want["grads"].items()}
    assert set(got) == set(wanted)
    assert _grads_agree(got, wanted) == []
    # the check fails a router gradient 10% off
    assert [n for n, _ in _grads_agree(dict(got, router=got["router"] * 1.1), wanted)] == ["router"]


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
def test_moe_param_tree_crosses(arch):
    """Every leaf of a reduced MoE model's parameter tree (the 3-D expert
    stacks, the f32 router, the shared expert) crosses by its path with its
    shape, dtype and bits, and loads into the port's Model."""
    from repro.models.transformer import Model as JaxModel
    from repro_torch.models.transformer import Model

    jm = JaxModel(jax_base.reduced_config(jax_base.get_config(arch)))
    tree = jax.tree.map(np.asarray, jax.jit(jm.init_params)(jax.random.PRNGKey(3)))
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): a
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
    state = params_from_jax(tree)
    assert state.keys() == flat.keys()
    moe_leaves = [p for p in flat if ".moe." in p]
    names = {p.split(".")[-1] for p in moe_leaves}
    assert names >= {"router", "w_gate", "w_up", "w_down"}
    assert ("shared_gate" in names) == (arch == "llama4-scout-17b-a16e")
    for path, a in flat.items():
        t = state[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).split(".")[-1] == a.dtype.name, path
        assert np.array_equal(t.view(torch.int16).numpy() if a.dtype.name == "bfloat16" else t.numpy(),
                              a.view(np.int16) if a.dtype.name == "bfloat16" else a), path
    assert all(state[p].dtype == torch.float32 for p in moe_leaves if p.endswith("router"))
    assert all(state[p].dim() == 4 for p in moe_leaves if p.startswith("groups.") and ".w_" in p)
    model = Model(base.reduced_config(base.get_config(arch)), device="cpu")
    model.load_state_dict(state, strict=True)
    assert model.n_params() == jm.n_params()


def test_top_k_breaks_ties_by_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, ids = moe.top_k(probs, 2)
    assert ids.tolist() == [[1, 2], [0, 1]]
    jvals, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert ids.tolist() == np.asarray(jids).tolist()
    assert torch.equal(vals, torch.from_numpy(np.array(jvals)))


# ---------------------------------------------------------------------------
# routing whole models as the reference routed them
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def reference_routing(log: list):
    """While it is open, every MoE block the reference traces also sends
    its router probabilities (T, E) f32 and expert ids (T, K), computed as
    its routing computes them, to ``log`` (numpy pairs, one a block and
    call).  Trace inside it a function jitted anew (a lambda), so that no
    trace cached before it is reused."""
    orig = jax_transformer.moe_block

    def recorded(p, x, cfg):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"]
        probs = jax.nn.softmax(logits, axis=-1)
        ids = jax.lax.top_k(probs, cfg.moe.top_k)[1]
        jax.debug.callback(lambda a, b: log.append((np.asarray(a), np.asarray(b))), probs, ids, ordered=True)
        return orig(p, x, cfg)

    jax_transformer.moe_block = recorded
    try:
        yield log
    finally:
        jax.effects_barrier()
        jax_transformer.moe_block = orig


def split_steps(log: list, B: int, S: int) -> list:
    """A full-sequence run's records cut into one record a position and
    block, as a teacher-forced decode of the same tokens routes them (each
    token's choice is its own where no expert drops)."""
    return [(pr.reshape(B, S, -1)[:, t], ids.reshape(B, S, -1)[:, t]) for pr, ids in log for t in range(S)]


class ForcedRouting:
    """See the header.  ``tokens_differing`` counts the tokens whose own
    choice differed from the reference's (each within the margin);
    ``unmatched`` the blocks that found no record near enough and routed by
    their own choice."""

    MATCH = 0.1  # a record's probabilities lie within this of the port's at its own block

    def __init__(self, records: list) -> None:
        self.records = [(torch.from_numpy(np.array(pr)).reshape(-1, pr.shape[-1]),
                         torch.from_numpy(np.array(ids, np.int64)).reshape(-1, ids.shape[-1])) for pr, ids in records]
        self.tokens_differing = 0
        self.unmatched = 0
        self.unexplained: list = []

    def top_k(self, orig, probs: torch.Tensor, k: int):
        vals, ids = orig(probs, k)
        flat = probs.detach().reshape(-1, probs.shape[-1])
        near = [(float((flat - pr).abs().max()), pr, rid) for pr, rid in self.records if pr.shape == flat.shape]
        if not near or min(n[0] for n in near) > self.MATCH:
            self.unmatched += 1
            return vals, ids
        _, ref_probs, ref_ids = min(near, key=lambda n: n[0])
        differ = (ids.reshape(ref_ids.shape) != ref_ids).any(-1)
        if bool(differ.any()):
            srt = ref_probs.sort(dim=-1, descending=True).values[:, : k + 1]
            margin = (srt[:, :-1] - srt[:, 1:]).min(dim=-1).values
            gap = (flat - ref_probs).abs().amax(dim=-1)
            self.tokens_differing += int(differ.sum())
            bad = differ & (margin > 2 * gap)
            self.unexplained += [(float(margin[i]), float(gap[i])) for i in torch.nonzero(bad).flatten().tolist()]
        ref_ids = ref_ids.reshape(ids.shape)
        return probs.gather(-1, ref_ids), ref_ids


@contextlib.contextmanager
def forced_routing(records: list):
    """Route the port's MoE blocks by ``records`` (``reference_routing``'s)
    while open; yields the ForcedRouting, whose ``unexplained`` must be
    empty."""
    forced = ForcedRouting(records)
    orig = moe.top_k
    moe.top_k = lambda probs, k: forced.top_k(orig, probs, k)
    try:
        yield forced
    finally:
        moe.top_k = orig


@pytest.mark.parametrize("K,C", [(1, 8), (2, 8), (4, 3)])
def test_dispatch_gradient_sums_each_tokens_rows_in_order(K, C):
    """moe.dispatch's gradient (``_TokenRows``: each token's K rows gathered
    and summed in f32 in ascending order, rounded once) equals
    index_select's own backward on the CPU bit for bit, dropped choices
    included (C = 3 drops)."""
    rng = np.random.default_rng(K * 10 + C)
    ns, Tl, E, d = 2, 12, 4, 8
    logits = torch.from_numpy(rng.standard_normal((ns, Tl, E)).astype(np.float32))
    r = moe.route(logits, E=E, K=K, C=C, dtype=torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((ns, Tl, d)).astype(np.float32)).bfloat16()
    cot = torch.from_numpy(rng.standard_normal((ns, E, C, d)).astype(np.float32)).bfloat16()
    a = x.clone().requires_grad_()
    moe.dispatch(a, r, E, C).backward(cot)
    b = x.clone().requires_grad_()
    base = torch.arange(ns)[:, None]
    src = b.reshape(ns * Tl, d).index_select(0, (r.stok + base * Tl).reshape(-1))
    dest = (torch.where(r.keep, r.slot, E * C) + base * (E * C + 1)).reshape(-1)
    xin = b.new_zeros((ns * (E * C + 1), d)).index_copy(0, dest, src)
    xin.reshape(ns, E * C + 1, d)[:, : E * C].reshape(ns, E, C, d).backward(cot)
    assert torch.equal(a.grad + 0.0, b.grad + 0.0)
