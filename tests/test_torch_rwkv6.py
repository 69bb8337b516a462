# The port's rwkv6 serving path on the CPU against the JAX package, on the
# reduced config of rwkv6-3b with the reference's weights carried across by
# params_from_jax: forward logits, prefill's last logits and its wkv /
# shift_t / shift_c caches, decode logits teacher-forced on the reference's
# tokens (a decode that forgot to write its state back would restart every
# step from the prefill state and drift from the second step on), greedy
# generation, the serving CLI, and the time-mix's three forms.
#
# The reference initialises mu_*, w0, w_lora_b, u and ln_x to zeros, which
# gives log_w = -1 everywhere, no bonus and no token shift.  So these are
# drawn here with numpy on the JAX tree before it is carried across: w0
# uniform over the clip range [-8, 4], u 0.3 N(0, 1), mu_* U(0, 1),
# w_lora_b 0.01 N(0, 1), ln_x 0.1 N(0, 1).
#
# Tolerances are the reference's own (tests/test_models_smoke.py): 5e-2 for
# bf16 forward/prefill logits and caches, 0.15 for decode logits.
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jax_base
from repro.models.rwkv6 import rwkv6_time_mix as jax_time_mix
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import prefill_forward as jax_prefill
from repro.serve.step import make_decode_step as jax_make_decode_step
from repro_torch.configs import base
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.models.rwkv6 import rwkv6_time_mix
from repro_torch.models.transformer import Model
from repro_torch.serve.step import generate, make_prefill_step
from test_torch_threads import cap_torch_threads

cap_torch_threads()

PREFILL_TOL = dict(rtol=5e-2, atol=5e-2)
DECODE_TOL = dict(rtol=0.15, atol=0.15)
ARCH = "rwkv6-3b"
PROMPT, NEW = 37, 6  # a ragged last chunk (37 = 2 * 16 + 5); decode at 37..42


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol) -> None:
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def spread_zero_inits(params, seed: int):
    """The numpy tree ``params`` with the tensors rwkv6 initialises to zeros
    drawn as the header says, in their own dtypes."""
    rng = np.random.default_rng(seed)
    draw = {
        "w0": lambda s: rng.uniform(-8.0, 4.0, s),
        "u": lambda s: 0.3 * rng.normal(size=s),
        "w_lora_b": lambda s: 0.01 * rng.normal(size=s),
        "ln_x": lambda s: 0.1 * rng.normal(size=s),
    }
    out = {}
    for path, a in tree_leaves(params):
        leaf = path.split(".")[-1]
        fn = draw.get(leaf) if ".tmix." in path else None
        if leaf.startswith("mu_"):
            fn = lambda s: rng.uniform(0.0, 1.0, s)  # noqa: E731
        out[path] = np.asarray(jnp.asarray(fn(a.shape), a.dtype)) if fn else a
    return _unflatten(params, out)


def _unflatten(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(v, flat, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return flat[prefix[:-1]]


@pytest.fixture(scope="module")
def case():
    """The port's model with the reference's (spread) weights, and the
    reference's outputs on the inputs the tests share."""
    cfg = jax_base.reduced_config(jax_base.get_config(ARCH))
    jm = JaxModel(cfg)
    raw = jax.tree.map(np.asarray, jax.jit(jm.init_params)(jax.random.PRNGKey(0)))
    np_params = spread_zero_inits(raw, seed=1)
    params = jax.tree.map(jnp.asarray, np_params)
    model = Model(base.reduced_config(base.get_config(ARCH)), device="cpu")
    model.load_state_dict(params_from_jax(np_params), strict=True)
    toks = np.random.default_rng(2).integers(4, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    logits, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    last, cache = jax.jit(jax_prefill, static_argnums=(2, 3))(params, {"tokens": jnp.asarray(toks)}, cfg, False)
    # the reference's generate loop (serve/step.py), step by step
    decode = jax.jit(jax_make_decode_step(jm))
    gcache = cache
    tok = jnp.argmax(last[:, -1].astype(jnp.float32), axis=-1)[:, None].astype(jnp.int32)
    gen_toks, gen_logits = [tok], [last[:, -1]]
    for t in range(NEW - 1):
        tok, lg, gcache = decode(params, gcache, tok, jnp.asarray(PROMPT + t, jnp.int32), jax.random.PRNGKey(0))
        gen_toks.append(tok)
        gen_logits.append(lg[:, -1])
    ref = dict(
        toks=toks, logits=logits, last=last, cache=jax.tree.map(np.asarray, cache),
        gen_toks=np.asarray(jnp.concatenate(gen_toks, axis=1)), gen_logits=gen_logits,
        n_params=jm.n_params(), params=np_params,
    )
    return cfg, params, model, ref


def test_param_names_and_counts(case):
    cfg, _, model, ref = case
    want = {path: tuple(np.shape(a)) for path, a in tree_leaves(ref["params"])}
    got = {name: tuple(p.shape) for name, p in model.state_dict().items()}
    assert got == want
    assert model.n_params() == ref["n_params"]
    assert "groups.pos0.tmix.wr" in got and "groups.pos0.cmix.wk" in got
    # the spread reached the port: the decay spans the clip range
    w0 = model.state_dict()["groups.pos0.tmix.w0"].float()
    assert float(w0.min()) < -7.0 and float(w0.max()) > 3.0


def test_full_width_param_count():
    from repro_torch.models.common import param_count
    from repro_torch.models.transformer import model_defs

    cfg = jax_base.get_config(ARCH)
    assert param_count(model_defs(base.get_config(ARCH))) == JaxModel(cfg).n_params() == 3_073_313_280


def test_forward_and_prefill_match(case):
    cfg, _, model, ref = case
    toks = torch.from_numpy(ref["toks"])
    got, _ = model({"tokens": toks})
    assert got.shape == ref["logits"].shape and got.dtype == torch.bfloat16
    _close(got, ref["logits"], PREFILL_TOL)
    got_last, got_cache = make_prefill_step(model)({"tokens": toks})
    _close(got_last, ref["last"][:, -1], PREFILL_TOL)
    want = dict(tree_leaves(cache_from_jax(ref["cache"])))
    got = dict(tree_leaves(got_cache))
    assert want.keys() == got.keys() == {f"groups.pos0.{n}" for n in ("wkv", "shift_t", "shift_c")}
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        _close(got[name], w, PREFILL_TOL)


def test_decode_teacher_forced_matches(case):
    """Every step's logits, fed the reference's tokens, match the
    reference's; each of the port's tokens is the argmax of its step."""
    cfg, _, model, ref = case
    prompts = torch.from_numpy(ref["toks"])
    res = generate(model, prompts, NEW, feed=torch.from_numpy(ref["gen_toks"].copy()), keep_logits=True)
    assert len(res.logits) == NEW >= 5  # the prefill's and at least four decode steps
    for got, want in zip(res.logits, ref["gen_logits"]):
        _close(got, want, DECODE_TOL)
    picks = torch.stack([lg.argmax(-1) for lg in res.logits], dim=1).to(torch.int32)
    assert torch.equal(res.tokens[:, PROMPT:], picks)


def test_decode_writes_the_state_in_place(case):
    """decode_step returns the cache it was given, with every leaf moved on
    by one token; the reference's decode returns the same states."""
    cfg, params, model, ref = case
    toks = torch.from_numpy(ref["toks"])
    with torch.inference_mode():
        _, cache = model.prefill({"tokens": toks})
        before = {n: t.clone() for n, t in tree_leaves(cache)}
        nxt = torch.from_numpy(ref["gen_toks"][:, :1].copy())
        _, out = model.decode_step(cache, {"tokens": nxt, "pos": PROMPT})
    assert out is cache
    after = dict(tree_leaves(cache))
    for name, t in before.items():
        assert not torch.equal(after[name], t), name
    jcache = jax.tree.map(jnp.asarray, ref["cache"])
    _, jout = jax.jit(JaxModel(cfg).decode_step)(
        params, jcache, {"tokens": jnp.asarray(ref["gen_toks"][:, :1]), "pos": jnp.asarray(PROMPT)})
    for name, w in tree_leaves(cache_from_jax(jax.tree.map(np.asarray, jout))):
        _close(after[name], w, PREFILL_TOL)


def test_greedy_generation_feeds_on_its_own_picks(case):
    cfg, _, model, ref = case
    prompts = torch.from_numpy(ref["toks"])
    free = generate(model, prompts, NEW)
    assert free.tokens.shape == (2, PROMPT + NEW)
    assert torch.equal(free.tokens[:, :PROMPT], prompts)
    assert np.array_equal(free.tokens[:, PROMPT].numpy(), ref["gen_toks"][:, 0])


@pytest.mark.parametrize("method", ["scan", "default", "factorized"])
@pytest.mark.parametrize("with_state", [False, True], ids=["prefill", "carry"])
def test_time_mix_forms_match(case, method, with_state):
    """One time-mix layer in each form, from zeros or a carried state,
    against the reference's same form."""
    cfg, params, model, ref = case
    rng = np.random.default_rng(3)
    x = np.asarray(jnp.asarray(rng.normal(size=(2, 21, cfg.d_model)), jnp.bfloat16))
    jp = jax.tree.map(lambda a: a[0], params["groups"]["pos0"]["tmix"])
    tp = {n: p[0] for n, p in model.params["groups"]["pos0"]["tmix"].items()}
    jstate = tstate = None
    if with_state:
        leaves = {n: a[0] for n, a in ref["cache"]["groups"]["pos0"].items()}
        jstate = jax.tree.map(jnp.asarray, leaves)
        tstate = cache_from_jax(leaves)
    want, want_state = jax_time_mix(jp, jnp.asarray(x), cfg, state=jstate, method=method)
    tx = cache_from_jax(x)
    with torch.inference_mode():
        got, got_state = rwkv6_time_mix(tp, tx, model.cfg, state=tstate, method=method)
    _close(got, want, PREFILL_TOL)
    if with_state:
        _close(got_state["wkv"], want_state["wkv"], PREFILL_TOL)
        assert torch.equal(got_state["shift_t"], tx[:, -1])


def test_serve_cli_on_the_cpu():
    from repro_torch.launch import serve

    out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--batch", "2", "--new", "4",
                      "--prompt-len", "20"])
    assert out["done"] >= 2 and out["tokens"] > 0
