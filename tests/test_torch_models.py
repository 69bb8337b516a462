# The port's LM serving path on the CPU against the JAX package, on reduced
# configs of gemma2-9b, gemma3-4b, starcoder2-3b, qwen2-vl-72b (its M-RoPE
# positions, text only), starcoder2-15b, the MoE models dbrx-132b and
# llama4-scout (chunked layers), zamba2-7b and the audio encoder
# hubert-xlarge (frames drawn from a seed in place of tokens; it has no
# decode shapes, supports_decode=False, so its generation and
# decode-against-forward tests skip as the reference's own do, while one
# decode step through its bf16 and int8 caches is held to the reference's
# decode step on the same frame) with the reference's own weights
# (Model.init_params(PRNGKey)) carried across by params_from_jax: forward
# logits, prefill's last logits and caches at S > window (so local layers
# mask by their window; llama4's prompt is longer than its reduced chunk,
# so its chunked layers attend within chunks and keep a rolled ring
# cache), decode logits teacher-forced on the reference's tokens, and
# greedy generation.  Also: every config equal field by field, and the
# int8 cache branch.
#
# Tolerances are the reference's own (tests/test_models_smoke.py): 5e-2 for
# bf16 forward/prefill logits and caches, 0.15 for decode logits.
#
# Decode from an empty cache is held against the reference's forward where
# the two compute the same function, as the reference's own golden check
# (test_models_smoke.test_decode_matches_forward) holds them: MoE models at
# its capacity factor of 8.0, where no expert drops a token (a prefill's
# drops depend on the batch; a decode step of B tokens never drops), and a
# chunked layer only inside the first chunk (past it the reference's
# decode reads its ring of the last chunk_size positions, a sliding window,
# where its forward attends within the chunk).  Past the first chunk the
# yardstick is the reference's own teacher-forced decode.
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jax_base
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import prefill_forward as jax_prefill
from repro.serve.kvcache import quantize_kv as jax_quantize_kv
from repro.serve.step import make_decode_step as jax_make_decode_step
from repro_torch.configs import base
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serve.kvcache import cache_bytes, dequantize_kv, quantize_kv
from repro_torch.serve.step import generate, make_prefill_step, pad_cache

from test_torch_moe import forced_routing, reference_routing, split_steps
from test_torch_threads import cap_torch_threads

cap_torch_threads()

PREFILL_TOL = dict(rtol=5e-2, atol=5e-2)
DECODE_TOL = dict(rtol=0.15, atol=0.15)
ARCHS = ["gemma2-9b", "gemma3-4b", "starcoder2-3b", "qwen2-vl-72b", "starcoder2-15b", "dbrx-132b",
         "llama4-scout-17b-a16e", "zamba2-7b", "hubert-xlarge"]
MOE_DECODE_CAPACITY = 8.0  # the reference's golden check's: C = T


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol) -> None:
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(4, vocab, (B, S)).astype(np.int32)


def _frames(d, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(ref, t0=0, t1=None) -> dict:
    """The shared inputs at positions t0..t1 as the port takes them: tokens,
    or an audio model's frames."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[:, t0:t1])) for k, v in ref["inputs"].items()}


def _skip_without_decode(cfg) -> None:
    if not cfg.supports_decode:
        pytest.skip(f"{cfg.arch_id} is encoder-only: no decode shapes (supports_decode=False), "
                    "as in the reference's own tests")


PROMPT, NEW = 24, 8  # prompts beyond the reduced window of 16; decode at 24..31
PROMPTS = {"llama4-scout-17b-a16e": 40}  # beyond the reduced chunk of 32


def _decode_config(cfg):
    """``cfg`` as the decode-against-forward check runs it."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_DECODE_CAPACITY))


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """The port's model with the reference's weights, and the reference's
    outputs on the inputs the tests share (computed once per arch), with
    the routing of every MoE block of each run (test_torch_moe's
    reference_routing; each function jitted anew under it)."""
    cfg = jax_base.reduced_config(jax_base.get_config(request.param))
    jm = JaxModel(cfg)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    model = Model(base.reduced_config(base.get_config(request.param)), device="cpu")
    model.load_state_dict(params_from_jax(_numpy_tree(params)), strict=True)
    prompt = PROMPTS.get(request.param, PROMPT)
    if cfg.family == "audio":
        inputs = {"frames": _frames(cfg.d_model, 2, prompt + 1, 1)}  # the last frame: one decode step
    else:
        inputs = {"tokens": _tokens(cfg.vocab_size, 2, prompt, 1)}  # reduced window 16 < prompt
    batch = {k: jnp.asarray(v[:, :prompt]) for k, v in inputs.items()}
    routing: dict = {}

    def recording(name):
        return reference_routing(routing.setdefault(name, []))

    with recording("forward"):
        logits, _ = jax.jit(lambda p, b: jm.forward(p, b))(params, batch)
    with recording("prefill"):
        last, cache = jax.jit(lambda p, b: jax_prefill(p, b, cfg, False))(params, batch)
    with recording("qprefill"):
        _, qcache = jax.jit(lambda p, b: jax_prefill(p, b, cfg, True))(params, batch)
    common = dict(inputs=inputs, logits=logits, last=last, cache=_numpy_tree(cache), qcache=_numpy_tree(qcache),
                  quantized=_numpy_tree(jax_quantize_kv(cache)), n_params=jm.n_params(), params=_numpy_tree(params),
                  prompt=prompt, routing=routing)
    step = jax.jit(lambda p, c, b: jm.decode_step(p, c, b))
    if not cfg.supports_decode:
        # the reference's decode step on the next frame, through the bf16
        # and the int8 caches padded by one position
        nxt = {"frames": jnp.asarray(inputs["frames"][:, prompt:]), "pos": jnp.asarray(prompt)}
        pads = []
        for c, quantized in ((cache, False), (qcache, True)):
            full = jm.cache_init(2, prompt + 1, quantized=quantized)
            pads.append(jax.tree.map(lambda a, b: jnp.pad(a, [(0, y - x) for x, y in zip(a.shape, b.shape)]), c, full))
        with recording("qdecode"):
            qlogits = step(params, pads[1], nxt)[0]
        return cfg, model, dict(common, alogits=step(params, pads[0], nxt)[0], qlogits=qlogits)
    toks = inputs["tokens"]
    # the reference's generate loop (serve/step.py), step by step, with each
    # step's logits; the decode step is the one its generate jits
    full = jm.cache_init(2, prompt + NEW)
    gcache = jax.tree.map(lambda a, b: jnp.pad(a, [(0, y - x) for x, y in zip(a.shape, b.shape)]), cache, full)
    tok = jnp.argmax(last[:, -1].astype(jnp.float32), axis=-1)[:, None].astype(jnp.int32)
    gen_toks, gen_logits = [tok], [last[:, -1]]
    with recording("decode"):
        decode = jax.jit(jax_make_decode_step(jm))
        for t in range(NEW - 1):
            tok, lg, gcache = decode(params, gcache, tok, jnp.asarray(prompt + t, jnp.int32), jax.random.PRNGKey(0))
            gen_toks.append(tok)
            gen_logits.append(lg[:, -1])
    # the int8 branch: one decode step on the padded quantized cache
    qfull = jm.cache_init(2, prompt + 1, quantized=True)
    qpad = jax.tree.map(lambda a, b: jnp.pad(a, [(0, y - x) for x, y in zip(a.shape, b.shape)]), qcache, qfull)
    with recording("qdecode"):
        qlogits, _ = step(params, qpad, {"tokens": jnp.asarray(toks[:, -1:]), "pos": jnp.asarray(prompt)})
    # the yardsticks of decode from an empty cache: the forward at the
    # decode config, and past a chunk the reference's own decode; a
    # decode step routes each token as the forward does where nothing drops
    dcfg = _decode_config(cfg)
    djm = jm if dcfg is cfg else JaxModel(dcfg)
    dlogits = logits
    if dcfg is not cfg:
        with recording("dforward"):
            dlogits = jax.jit(lambda p, b: djm.forward(p, b))(params, {"tokens": jnp.asarray(toks)})[0]
    else:
        routing["dforward"] = routing["forward"]
    routing["dsteps"] = split_steps(routing["dforward"], 2, prompt)
    tf_logits = None
    if "chunked" in cfg.layer_kinds():
        dcache, tf_logits = djm.cache_init(2, prompt), []
        with recording("tfsteps"):
            dstep = jax.jit(lambda p, c, b: djm.decode_step(p, c, b))
            for t in range(prompt):
                lg, dcache = dstep(params, dcache, {"tokens": jnp.asarray(toks[:, t : t + 1]), "pos": jnp.asarray(t)})
                tf_logits.append(lg[:, 0])
        tf_logits = jnp.stack(tf_logits, axis=1)
    ref = dict(common, toks=toks, qlogits=qlogits, gen_toks=np.asarray(jnp.concatenate(gen_toks, axis=1)),
               gen_logits=gen_logits, dlogits=dlogits, tf_logits=tf_logits)
    return cfg, model, ref


@contextlib.contextmanager
def _routed(ref, *runs, teacher_forced=True):
    """The port's MoE blocks routed as the reference's ``runs`` routed
    (test_torch_moe's forced_routing): every token whose own choice
    differs must lie within the reference's margin, and a teacher-forced
    run must find its record at every block."""
    with forced_routing([r for run in runs for r in ref["routing"][run]]) as forced:
        yield forced
    assert forced.unexplained == [], forced.unexplained
    assert forced.unmatched == 0 or not teacher_forced
    if forced.tokens_differing:
        print(f"{runs}: {forced.tokens_differing} token choices differed within the reference's margin")


def _first_layers(cfg):
    """Cache names and index of the first two layers' k/v, in layer order:
    for zamba2 (Mamba2 layers) those of its first two shared invocations."""
    if cfg.shared_attn_period:
        return [("shared", (0, 0)), ("shared", (0, 1))]
    pattern = cfg.layer_pattern
    if len(pattern) >= 2:
        return [("groups.pos0", 0), ("groups.pos1", 0)]
    return [("groups.pos0", 0), ("groups.pos0", 1)]


def _first_states(cfg):
    """The recurrent caches of the first two layers (zamba2's conv and ssm
    states), as (cache leaf name, repeat index)."""
    if "mamba2" not in cfg.layer_pattern:
        return []
    return [(f"groups.pos{i}.{name}", 0) for i in (0, 1) for name in ("conv", "ssm")]


@pytest.mark.parametrize("arch", sorted(jax_base.list_archs()))
def test_configs_equal_field_by_field(arch):
    want, got = jax_base.get_config(arch), base.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(base.reduced_config(got)) == dataclasses.asdict(jax_base.reduced_config(want))
    assert got.scan_groups() == want.scan_groups()
    assert got.layer_kinds() == want.layer_kinds()
    assert base.valid_cells(got) == jax_base.valid_cells(want)


def test_param_names_and_counts(case):
    cfg, model, ref = case
    want = {path: tuple(np.shape(a)) for path, a in tree_leaves(ref["params"])}
    got = {name: tuple(p.shape) for name, p in model.state_dict().items()}
    assert got == want
    assert model.n_params() == ref["n_params"]


def test_forward_and_prefill_match(case):
    cfg, model, ref = case
    batch = _inputs(ref, 0, ref["prompt"])
    with _routed(ref, "forward"):
        got, _ = model(batch)
    assert got.shape == ref["logits"].shape and got.dtype == torch.bfloat16
    _close(got, ref["logits"], PREFILL_TOL)
    with _routed(ref, "prefill"):
        got_last, got_cache = make_prefill_step(model)(batch)
    _close(got_last, ref["last"][:, -1], PREFILL_TOL)
    want_leaves = dict(tree_leaves(cache_from_jax(ref["cache"])))
    got_leaves = dict(tree_leaves(got_cache))
    assert want_leaves.keys() == got_leaves.keys()
    for name, w in want_leaves.items():
        assert got_leaves[name].shape == w.shape and got_leaves[name].dtype == w.dtype, name
    # the caches of the first two layers element by element, the ring
    # buffers' roll included; deeper layers carry the bf16 drift of the
    # layers below them into the decode logits, which the generation test
    # holds to the decode tolerance
    for group, r in _first_layers(cfg):
        for kv in "kv":
            _close(got_leaves[f"{group}.{kv}"][r], want_leaves[f"{group}.{kv}"][r], PREFILL_TOL)
    for name, r in _first_states(cfg):
        _close(got_leaves[name][r], want_leaves[name][r], PREFILL_TOL)


def test_generate_greedy_matches_teacher_forced(case):
    """The port's logits at every step, fed the reference's tokens, match the
    reference's; each of the port's tokens is the argmax of its step."""
    cfg, model, ref = case
    _skip_without_decode(cfg)
    prompt = ref["prompt"]
    prompts = torch.from_numpy(ref["toks"])
    with _routed(ref, "prefill", "decode"):
        res = generate(model, prompts, NEW, feed=torch.from_numpy(ref["gen_toks"].copy()), keep_logits=True)
    assert res.tokens.shape == (2, prompt + NEW) and res.steps == NEW
    assert torch.equal(res.tokens[:, :prompt], prompts)
    assert len(res.logits) == NEW
    for got, want in zip(res.logits, ref["gen_logits"]):
        _close(got, want, DECODE_TOL)
    picks = torch.stack([lg.argmax(-1) for lg in res.logits], dim=1).to(torch.int32)
    assert torch.equal(res.tokens[:, prompt:], picks)
    # without teacher forcing the port feeds on its own picks
    with _routed(ref, "prefill", teacher_forced=False):
        free = generate(model, prompts, NEW)
    assert torch.equal(free.tokens[:, : prompt + 1], res.tokens[:, : prompt + 1])


def test_decode_step_matches_forward(case):
    """Teacher-forced decode from an empty cache agrees with the reference's
    forward pass (its own golden check), ring buffers included, where the
    two compute the same function (the header says where), and past a
    chunk with the reference's own decode."""
    cfg, model, ref = case
    _skip_without_decode(cfg)
    toks, prompt = ref["toks"], ref["prompt"]
    dcfg = _decode_config(cfg)
    if dcfg is not cfg:
        model = Model(_decode_config(model.cfg), device="cpu")
        model.load_state_dict(params_from_jax(ref["params"]), strict=True)
    cache = model.cache_init(2, prompt)
    outs = []
    # past the first chunk (chunked layers) the reference's own decode
    n = cfg.chunk_size if ref["tf_logits"] is not None else prompt
    assert prompt > n or ref["tf_logits"] is None
    for t in range(prompt):
        with _routed(ref, "dsteps" if t < n else "tfsteps"):
            lg, cache = model.decode_step(cache, {"tokens": torch.from_numpy(toks[:, t : t + 1]), "pos": t})
        outs.append(lg[:, 0])
    got = torch.stack(outs, dim=1)
    _close(got[:, :n], np.asarray(ref["dlogits"], np.float32)[:, :n], DECODE_TOL)
    if ref["tf_logits"] is not None:
        _close(got[:, n:], np.asarray(ref["tf_logits"], np.float32)[:, n:], DECODE_TOL)


def test_int8_cache_branch(case):
    cfg, model, ref = case
    # the same bf16 cache quantizes to the same bits in both packages
    want = dict(tree_leaves(cache_from_jax(ref["quantized"])))
    got = dict(tree_leaves(quantize_kv(cache_from_jax(ref["cache"]))))
    assert want.keys() == got.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name
    # the quantized prefill: the same layout, and the first layers' values
    prompt = ref["prompt"]
    with _routed(ref, "qprefill"):
        _, tq = model.prefill(_inputs(ref, 0, prompt), quantize_cache=True)
    want = dict(tree_leaves(cache_from_jax(ref["qcache"])))
    got = dict(tree_leaves(tq))
    assert want.keys() == got.keys()
    for name in want:
        assert got[name].shape == want[name].shape and got[name].dtype == want[name].dtype, name
    for group, r in _first_layers(cfg):
        for kv in "kv":
            deq = [c[f"{group}.{kv}_q"][r].float() * c[f"{group}.{kv}_s"][r].float() for c in (got, want)]
            _close(deq[0], deq[1], PREFILL_TOL)
    # decode through the int8 branch, padded to one more position (an
    # audio model's next frame; a text model's last prompt token again)
    tpad = pad_cache(tq, model.cache_init(2, prompt + 1, quantized=True))
    nxt = _inputs(ref, prompt) if cfg.family == "audio" else _inputs(ref, prompt - 1, prompt)
    with _routed(ref, "qdecode"):
        got_lg, _ = model.decode_step(tpad, {**nxt, "pos": prompt})
    _close(got_lg, ref["qlogits"], DECODE_TOL)
    assert cache_bytes(tq) < cache_bytes(dequantize_kv(tq))


def test_entry_points_default_to_the_card():
    """Without a card, Model and the cache refuse to start rather than run
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = base.reduced_config(base.get_config("gemma2-9b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])


def test_serve_cli_on_the_cpu():
    from repro_torch.launch import serve

    out = serve.main(["--device", "cpu", "--requests", "3", "--batch", "2", "--new", "4", "--prompt-len", "20"])
    assert out["done"] >= 2 and out["tokens"] > 0


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
def test_serve_cli_runs_moe_on_the_cpu(arch):
    from repro_torch.launch import serve

    out = serve.main(["--device", "cpu", "--arch", arch, "--requests", "3", "--batch", "2", "--new", "4",
                      "--prompt-len", "40"])
    assert out["done"] >= 2 and out["tokens"] > 0


@pytest.mark.parametrize("case", ["hubert-xlarge"], indirect=True)
def test_audio_decode_step_matches_the_references(case):
    """An audio config's prefill caches and decode step do what the
    reference's do (it raises for neither): the next frame's logits through
    the prefill's bf16 cache, padded by one position, within the decode
    tolerance of the reference's decode step."""
    cfg, model, ref = case
    prompt = ref["prompt"]
    _, cache = model.prefill(_inputs(ref, 0, prompt))
    got, _ = model.decode_step(pad_cache(cache, model.cache_init(2, prompt + 1)), {**_inputs(ref, prompt),
                                                                                   "pos": prompt})
    assert got.shape == (2, 1, cfg.vocab_size)
    _close(got, ref["alogits"], DECODE_TOL)


def test_hubert_builds_with_the_references_names_and_counts():
    """hubert-xlarge's definitions (the frontend projection and the head in
    place of an embedding and an lm head) count the reference's parameters
    at the published size, nothing allocated; the reduced model builds on
    the CPU with the reference's names and shapes and takes every leaf of
    its tree."""
    import math

    from repro.models.transformer import model_defs as jax_model_defs
    from repro_torch.models.transformer import model_defs

    cfg, jcfg = base.get_config("hubert-xlarge"), jax_base.get_config("hubert-xlarge")
    want = {p: tuple(d.shape) for p, d in tree_leaves(jax_model_defs(jcfg))}
    got = {p: tuple(d.shape) for p, d in tree_leaves(model_defs(cfg))}
    assert got == want
    assert got["frontend"] == (1280, 1280) and got["head"] == (1280, 504)
    assert not {"embed", "lm_head"} & set(got)
    assert sum(math.prod(s) for s in got.values()) == 946_126_080
    model = Model(base.reduced_config(cfg), device="cpu")
    jm = JaxModel(jax_base.reduced_config(jcfg))
    state = params_from_jax(_numpy_tree(jax.jit(jm.init_params)(jax.random.PRNGKey(1))))
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(p.shape) for k, p in model.state_dict().items()}
    model.load_state_dict(state, strict=True)
    assert model.n_params() == jm.n_params()


def test_zamba2_builds_with_the_references_names_and_counts():
    """zamba2-7b's definitions count the reference's parameters at the
    published size (nothing allocated); the reduced model builds on the
    CPU with the reference's names and shapes, the shared blocks included,
    and every leaf of the reference's tree lands on a parameter."""
    import math

    from repro.models.transformer import model_defs as jax_model_defs
    from repro_torch.models.transformer import model_defs

    cfg, jcfg = base.get_config("zamba2-7b"), jax_base.get_config("zamba2-7b")
    want = {p: tuple(d.shape) for p, d in tree_leaves(jax_model_defs(jcfg))}
    got = {p: tuple(d.shape) for p, d in tree_leaves(model_defs(cfg))}
    assert got == want
    assert sum(math.prod(s) for s in got.values()) == 7_008_046_288
    assert any(p.startswith("shared.") for p in got)
    rcfg = base.reduced_config(cfg)
    model = Model(rcfg, device="cpu")
    jm = JaxModel(jax_base.reduced_config(jcfg))
    tree = _numpy_tree(jax.jit(jm.init_params)(jax.random.PRNGKey(1)))
    state = params_from_jax(tree)
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(p.shape) for k, p in model.state_dict().items()}
    model.load_state_dict(state, strict=True)
    assert model.n_params() == jm.n_params() == 328_584


def test_serve_cli_runs_zamba2_on_the_cpu():
    """Continuous batching over reduced zamba2: a finished slot's lane of
    every cache (the Mamba2 states and the shared blocks' k/v) is zeroed
    for the next request."""
    from repro_torch.launch import serve

    out = serve.main(["--device", "cpu", "--arch", "zamba2-7b", "--requests", "3", "--batch", "2", "--new", "4",
                      "--prompt-len", "20"])
    assert out["done"] >= 2 and out["tokens"] > 0


def test_reset_lane_zeroes_one_lane_of_a_zamba2_cache():
    cfg = base.reduced_config(base.get_config("zamba2-7b"))
    cfg = dataclasses.replace(cfg, n_layers=8)  # a remainder of two layers, one shared invocation among them
    from repro_torch.models.transformer import cache_init
    from repro_torch.serve.step import reset_lane_

    cache = cache_init(cfg, 3, 10, device="cpu")
    assert set(cache) == {"groups", "remainder", "shared", "shared_rem"}
    leaves = dict(tree_leaves(cache))
    for t in leaves.values():
        t.fill_(1)
    reset_lane_(cache, 1)
    axis = {"groups": 1, "shared": 2, "remainder": 0, "shared_rem": 0}  # the batch axis by the path's first part
    for name, t in leaves.items():
        ax = axis[name.split(".")[0]]
        assert bool((t.select(ax, 1) == 0).all()), name
        assert bool((t.select(ax, 0) == 1).all()) and bool((t.select(ax, 2) == 1).all()), name


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def test_exact_gelu_rounds_as_the_compiled_reference():
    """C43: jax.nn.gelu(approximate=False) on bf16, as the compiled reference
    computes it (XLA's f32 expansion of erfc, its argument unrounded, erfc
    and 0.5 x rounded to bf16), bit for bit over every bf16 value x with
    2^-100 <= |x| <= 8 (smaller ones reach f32 subnormals, which the
    compiled reference flushes to zero), through the port's table (bf16)
    and through its steps; F.gelu misses a few percent of them."""
    import torch.nn.functional as F

    from repro_torch.models.common import _gelu_steps, gelu

    words = np.arange(-32768, 32768, dtype=np.int64).astype(np.int16)
    vals = words.view(jnp.bfloat16)
    mag = np.abs(vals.astype(np.float32))
    vals = vals[(mag <= 8.0) & (mag >= 2.0 ** -100)]
    want = _bf16_bits(jax.jit(lambda v: jax.nn.gelu(v, approximate=False))(vals))
    x = torch.from_numpy(vals.view(np.int16).copy()).view(torch.bfloat16)
    np.testing.assert_array_equal(_bf16_bits(gelu(x)), want)
    np.testing.assert_array_equal(_bf16_bits(_gelu_steps(x)), want)
    assert (_bf16_bits(F.gelu(x)) != want).mean() > 0.01


def test_exact_gelu_gradient_matches_jax():
    """The exact gelu's gradient (its own backward) against jax.grad of
    jax.nn.gelu(approximate=False) in f32, within 1e-6."""
    from repro_torch.models.common import gelu

    xs = np.linspace(-9.0, 9.0, 4001).astype(np.float32)
    want = np.asarray(jax.vmap(jax.grad(lambda v: jax.nn.gelu(v, approximate=False)))(xs))
    x = torch.from_numpy(xs).requires_grad_()
    gelu(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_hubert_mlp_matches_the_compiled_reference_bit_for_bit():
    """hubert-xlarge's MLP (w_in, exact gelu, w_out) on reduced shapes
    against the jitted reference's mlp_block, bit for bit; with F.gelu in
    its place half the outputs differ."""
    import torch.nn.functional as F

    from repro.models.mlp import mlp_block as jax_mlp_block
    from repro_torch.models import mlp

    jcfg = jax_base.reduced_config(jax_base.get_config("hubert-xlarge"))
    cfg = base.reduced_config(base.get_config("hubert-xlarge"))
    rng = np.random.default_rng(43)
    p = {"w_in": (0.1 * rng.standard_normal((64, 128))).astype(jnp.bfloat16),
         "w_out": (0.1 * rng.standard_normal((128, 64))).astype(jnp.bfloat16)}
    h = rng.standard_normal((2, 24, 64)).astype(jnp.bfloat16)
    want = _bf16_bits(jax.jit(lambda p, h: jax_mlp_block(p, h, jcfg))(p, h))
    tp = {k: torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16) for k, v in p.items()}
    th = torch.from_numpy(h.view(np.int16).copy()).view(torch.bfloat16)
    np.testing.assert_array_equal(_bf16_bits(mlp.mlp_block(tp, th, cfg)), want)
    once = _bf16_bits(F.gelu(th @ tp["w_in"]) @ tp["w_out"])
    assert (once != want).mean() > 0.1
