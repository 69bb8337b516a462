# The graph-ready decode step on the CPU: the position is a 0-dim device
# tensor, the cache is written with index_copy_ and the valid mask is built
# from the tensor, so nothing reads a value back to the host (serve/step.py
# captures the step in a CUDA graph on a card).  Held here, bit for bit,
# against the previous form of the step, which took the position as a
# Python int and wrote the cache by slicing (kept below as
# _slice_write_attention_block, patched into the model for the oracle run),
# at reduced gemma2-9b (global and ring-buffer local layers, the ring
# wrapping) and rwkv6-3b (its state written in place), for the bf16 and the
# int8 cache; and make_decode_step on the CPU is that eager step.
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.common import apply_rope, rms_norm, tree_leaves
from repro_torch.models.transformer import Model
from repro_torch.serve.step import generate, make_decode_step, pad_cache, reset_lane_
from test_torch_threads import cap_torch_threads

cap_torch_threads()

PROMPT, NEW = 20, 12  # the reduced window is 16: decode wraps the ring buffers


def _slice_write_attention_block(p, x, cfg, kind, inputs):
    """The decode branch as it was: an int position, slice writes."""
    if inputs.cache is None:
        return A.attention_block(p, x, cfg, kind, inputs)
    B, S, d = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    scale = cfg.attn_scale if cfg.attn_scale is not None else Dh ** -0.5
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (x @ p["wk"]).reshape(B, S, Hkv, Dh)
    v = (x @ p["wv"]).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = A._rope_for(cfg, inputs.positions)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    pos = int(inputs.cache_pos)
    rolling = kind in ("local", "chunked")
    c = inputs.cache
    if "k_q" in c:
        Sc = c["k_q"].shape[1]
        w = pos % Sc if rolling else pos
        c["k_q"][:, w:w + 1], c["k_s"][:, w:w + 1] = A.quantize_rows(k)
        c["v_q"][:, w:w + 1], c["v_s"][:, w:w + 1] = A.quantize_rows(v)
        kc = (c["k_q"].float() * c["k_s"].float()).to(q.dtype)
        vc = (c["v_q"].float() * c["v_s"].float()).to(q.dtype)
    else:
        Sc = c["k"].shape[1]
        w = pos % Sc if rolling else pos
        c["k"][:, w:w + 1] = k.to(c["k"].dtype)
        c["v"][:, w:w + 1] = v.to(c["v"].dtype)
        kc, vc = c["k"].to(q.dtype), c["v"].to(q.dtype)
    idx = torch.arange(Sc)
    valid = ((idx <= pos % Sc) | (pos >= Sc)) if rolling else idx <= pos
    out = A.decode_attention(q, kc, vc, valid[None].expand(B, Sc), scale=scale, logit_softcap=cfg.attn_softcap)
    return out.reshape(B, S, H * Dh) @ p["wo"], c


def _model(arch):
    cfg = reduced_config(get_config(arch))
    gen = torch.Generator().manual_seed(0)
    model = Model(cfg, device="cpu").init_params(gen)
    with torch.no_grad():  # rwkv6 zero-initialises its decay and bonus: spread them
        for name, p in model.named_parameters():
            if name.endswith(("w0", "u", "ln_x")) or ".mu_" in name:
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))
    return cfg, model


def _decode_run(model, cfg, quantized, pos_as_tensor):
    toks = torch.from_numpy(np.random.default_rng(3).integers(4, cfg.vocab_size, (2, PROMPT)).astype(np.int32))
    feed = torch.from_numpy(np.random.default_rng(4).integers(4, cfg.vocab_size, (2, NEW)).astype(np.int32))
    with torch.inference_mode():
        _, pcache = model.prefill({"tokens": toks}, quantize_cache=quantized)
        cache = pad_cache(pcache, model.cache_init(2, PROMPT + NEW, quantized=quantized))
        decode = make_decode_step(model)
        picks, logits = [], []
        for t in range(NEW):
            pos = torch.tensor(PROMPT + t) if pos_as_tensor else PROMPT + t
            nxt, lg, cache = decode(cache, feed[:, t:t + 1], pos)
            picks.append(nxt)
            logits.append(lg.clone())
    return torch.cat(picks, 1), logits, cache


# rwkv6 keeps a recurrent state, not a kv cache to quantize
@pytest.mark.parametrize("arch,quantized", [("gemma2-9b", False), ("gemma2-9b", True), ("rwkv6-3b", False)],
                         ids=["gemma2-bf16", "gemma2-int8", "rwkv6"])
def test_tensor_pos_step_equals_the_slice_write_step(arch, quantized, monkeypatch):
    cfg, model = _model(arch)
    got = _decode_run(model, cfg, quantized, pos_as_tensor=True)
    monkeypatch.setattr(T, "attention_block", _slice_write_attention_block)
    want = _decode_run(model, cfg, quantized, pos_as_tensor=False)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    gl, wl = dict(tree_leaves(got[2])), dict(tree_leaves(want[2]))
    assert gl.keys() == wl.keys()
    for name in gl:
        assert torch.equal(gl[name], wl[name]), name


@pytest.mark.parametrize("arch", ["gemma2-9b", "rwkv6-3b"])
def test_int_and_tensor_positions_agree(arch):
    cfg, model = _model(arch)
    a, b = _decode_run(model, cfg, False, True), _decode_run(model, cfg, False, False)
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[2:], b[2:]):
        for (n, s), (_, t) in zip(tree_leaves(x), tree_leaves(y)):
            assert torch.equal(s, t), n


@pytest.mark.parametrize("rolling", [False, True])
def test_valid_mask_from_a_tensor_position(rolling):
    Sc = 16
    for pos in (0, 5, 15, 16, 17, 40):
        got = A._valid(torch.tensor(pos), Sc, rolling, 2, "cpu")
        idx = np.arange(Sc)
        want = ((idx <= pos % Sc) | (pos >= Sc)) if rolling else idx <= pos
        assert got.shape == (2, Sc) and (got.numpy() == want[None]).all()


def test_make_decode_step_on_the_cpu_is_the_eager_step():
    cfg, model = _model("gemma2-9b")
    toks = torch.from_numpy(np.random.default_rng(5).integers(4, cfg.vocab_size, (2, 8)).astype(np.int32))
    a = generate(model, toks, 6, keep_logits=True, graph=True)
    b = generate(model, toks, 6, keep_logits=True, graph=False)
    assert torch.equal(a.tokens, b.tokens)
    assert all(torch.equal(x, y) for x, y in zip(a.logits, b.logits))
    assert make_decode_step(model, graph=True).__name__ == "eager"


@pytest.mark.parametrize("arch", ["gemma2-9b", "rwkv6-3b"])
def test_reset_lane_zeroes_one_slot_in_place(arch):
    """A refilled slot's cache lane is zeroed in the buffers a decode graph
    holds; the other lanes keep their values."""
    cfg, model = _model(arch)
    toks = torch.from_numpy(np.random.default_rng(6).integers(4, cfg.vocab_size, (3, 20)).astype(np.int32))
    with torch.no_grad():
        _, cache = model.prefill({"tokens": toks})
    before = {n: t.clone() for n, t in tree_leaves(cache)}
    ptrs = {n: t.data_ptr() for n, t in tree_leaves(cache)}
    reset_lane_(cache, 1)
    for name, t in tree_leaves(cache):
        lane_axis = 1 if name.startswith("groups.") else 0
        assert t.data_ptr() == ptrs[name]
        assert not t.select(lane_axis, 1).any(), name
        for lane in (0, 2):
            assert torch.equal(t.select(lane_axis, lane), before[name].select(lane_axis, lane)), name
