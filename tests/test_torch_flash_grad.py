# The gradient of the port's flash attention on the CPU against the JAX
# package: flash_attention_bwd_plain (dq, dk, dv written out) against
# jax.vjp of the reference's flash_attention_jnp, the function its training
# path differentiates (without a window; with a window, against jax.vjp of
# the reference's attention_ref, since flash_attention_jnp takes none), and
# against torch autograd of the port's attention_ref; over causal or not,
# sliding window, softcap and GQA groups, with ragged tiles.  The wrapper's
# CPU gradient (ops.FlashAttention) is the plain backward, exactly.  The
# rows' log-sum-exp that the forward kernel returns for the backward has a
# plain version, flash_attention_lse_plain, held against logsumexp of the
# scores the JAX package's attention_ref takes; the plain backward given it
# agrees with its own recomputation.  Inputs come from numpy with a seed.
# Tolerance: 1e-4 (rtol and atol) in f32 against JAX's gradients (both sum
# in f32, in other orders and tilings), 1e-5 against torch autograd of the
# materialised softmax, against JAX's logsumexp and between the plain
# backward's two forms (f32 sums of a few dozen terms).
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash.ref import attention_ref as jax_attention_ref
from repro.models.attention import flash_attention_jnp
from repro_torch.kernels.flash import ops
from repro_torch.kernels.flash.ref import (
    attention_ref,
    flash_attention_bwd_plain,
    flash_attention_lse_plain,
    flash_attention_plain,
)
from test_torch_threads import cap_torch_threads

cap_torch_threads()

JAX_TOL = dict(rtol=1e-4, atol=1e-4)
TORCH_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, S, Hkv, G, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Hkv * G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    dout = rng.normal(size=(B, S, Hkv * G, D)).astype(np.float32)
    return q, k, v, dout


def _jax_grads(q, k, v, dout, causal, window, scale, cap):
    if window:
        def fn(q, k, v):
            return jax_attention_ref(q, k, v, causal=causal, window=window, scale=scale, logit_softcap=cap)
    else:
        def fn(q, k, v):
            return flash_attention_jnp(q, k, v, causal=causal, scale=scale, logit_softcap=cap,
                                       q_block=16, kv_block=16)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


CASES = [(causal, window, cap) for causal in (True, False) for window in (0, 7) for cap in (0.0, 5.0)]


@pytest.mark.parametrize("S", [13, 40])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("causal,window,cap", CASES)
def test_plain_backward_matches_jax_and_autograd(causal, window, cap, G, S):
    q, k, v, dout = _inputs(S * 10 + G, 2, S, 2, G, 16)
    kw = dict(causal=causal, window=window, scale=0.3, logit_softcap=cap)
    got = flash_attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, dout)), **kw, q_block=8)
    for g, w in zip(got, _jax_grads(q, k, v, dout, causal, window, 0.3, cap)):
        np.testing.assert_allclose(g.numpy(), w, **JAX_TOL)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    attention_ref(*leaves, **kw).backward(torch.from_numpy(dout))
    for g, t in zip(got, leaves):
        torch.testing.assert_close(g, t.grad, **TORCH_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [80, 112, 256])
def test_plain_backward_at_the_padded_and_wide_head_dims(D, causal):
    """The head dims the card's backward takes beyond its tiles' own:
    hubert-xlarge's 80 (not causal), zamba2's 112 (both padded to 128 on the
    card) and gemma's 256, against jax.vjp of flash_attention_jnp at the
    head dim's own scale, GQA of 2, S ragged against the 16-row tiles."""
    q, k, v, dout = _inputs(D + causal, 1, 37, 2, 2, D)
    kw = dict(causal=causal, window=0, scale=D ** -0.5, logit_softcap=0.0)
    got = flash_attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, dout)), **kw, q_block=8)
    for g, w in zip(got, _jax_grads(q, k, v, dout, causal, 0, D ** -0.5, 0.0)):
        np.testing.assert_allclose(g.numpy(), w, **JAX_TOL)


@pytest.mark.parametrize("causal,window,cap", CASES)
def test_wrapper_gradient_on_the_cpu_is_the_plain_backward(causal, window, cap):
    q, k, v, dout = _inputs(5, 1, 21, 2, 2, 8)
    kw = dict(causal=causal, window=window, scale=0.4, logit_softcap=cap)
    ops.reset_launches()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, **kw)
    out.backward(torch.from_numpy(dout))
    assert ops.PLAIN_BWD_CALLS == 1 and ops.BWD_LAUNCHES == 0 and ops.LAUNCHES == 0
    want = flash_attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, dout)), out.detach(), **kw)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


def test_gradient_takes_queries_and_keys_of_one_length():
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    k = torch.zeros(1, 6, 2, 8)
    with pytest.raises(ValueError, match="one length"):
        ops.flash_attention(q, k, k)
    with torch.no_grad():  # without a gradient the decode-style call stands
        assert ops.flash_attention(q, k, k).shape == (1, 4, 2, 8)


def test_plain_backward_in_float64_and_bf16_inputs():
    """float64 inputs compute in float64 (the card's yardstick); bf16 inputs
    compute in f32 and return bf16."""
    q, k, v, dout = _inputs(9, 1, 30, 1, 4, 16)
    kw = dict(causal=True, window=0, scale=0.25, logit_softcap=0.0)
    g64 = flash_attention_bwd_plain(*(torch.from_numpy(a).double() for a in (q, k, v, dout)), **kw)
    assert all(g.dtype == torch.float64 for g in g64)
    gb = flash_attention_bwd_plain(*(torch.from_numpy(a).bfloat16() for a in (q, k, v, dout)), **kw)
    assert all(g.dtype == torch.bfloat16 for g in gb)
    g32 = flash_attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, dout)), **kw)
    for a, b in zip(g64, g32):
        torch.testing.assert_close(a.float(), b, **TORCH_TOL)


def _jax_lse(q, k, causal, window, scale, cap):
    """logsumexp over each row of the scores of the JAX package's
    attention_ref (repro.kernels.flash.ref; its lines up to the softmax:
    scale, softcap, the mask with queries aligned to the end of the keys),
    +inf where a row sees no key; (B, H, Sq)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = jnp.asarray(q).reshape(B, Sq, Hkv, H // Hkv, D)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", qg, jnp.asarray(k)) * scale
    if cap > 0:
        s = cap * jnp.tanh(s / cap)
    q_ids = jnp.arange(Sq)[:, None] + (Sk - Sq)
    k_ids = jnp.arange(Sk)[None, :]
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask &= k_ids <= q_ids
    if window > 0:
        mask &= (q_ids - k_ids) < window
    lse = np.asarray(jax.nn.logsumexp(jnp.where(mask[None, None, None], s, -jnp.inf), axis=-1))
    return np.where(np.isneginf(lse), np.inf, lse).reshape(B, H, Sq)


@pytest.mark.parametrize("Sq,Sk", [(13, 13), (40, 40), (5, 21), (21, 5)])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("causal,window,cap", CASES)
def test_plain_lse_matches_jax_scores(causal, window, cap, G, Sq, Sk):
    """Over masks, caps and GQA groups, decode-style (Sq < Sk) and with rows
    that see no key (Sq > Sk, causal), which take +inf."""
    rng = np.random.default_rng(Sq * 100 + Sk + G)
    q = rng.normal(size=(2, Sq, 2 * G, 16)).astype(np.float32)
    k = rng.normal(size=(2, Sk, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, scale=0.3, logit_softcap=cap)
    got = flash_attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k), **kw, q_block=8)
    want = _jax_lse(q, k, causal, window, 0.3, cap)
    assert got.shape == (2, 2 * G, Sq) and got.dtype == torch.float32
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    np.testing.assert_allclose(got.numpy(), want, **TORCH_TOL)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("causal,window,cap", CASES)
def test_plain_backward_given_lse_matches_its_recomputation(causal, window, cap, G):
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(G + 31, 2, 29, 2, G, 16))
    kw = dict(causal=causal, window=window, scale=0.3, logit_softcap=cap)
    out = flash_attention_plain(q, k, v, **kw)
    lse = flash_attention_lse_plain(q, k, **kw)
    got = flash_attention_bwd_plain(q, k, v, dout, out, **kw, q_block=8, lse=lse)
    want = flash_attention_bwd_plain(q, k, v, dout, out, **kw, q_block=8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TORCH_TOL)


def test_cpu_forward_leaves_the_statistics_to_the_plain_backward():
    """On the CPU the forward under a gradient is the plain forward and
    saves no lse: the plain backward recomputes its statistics."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(4, 1, 12, 2, 2, 8))
    kw = dict(causal=True, window=0, scale=0.4, logit_softcap=0.0)
    ops.reset_launches()
    out, lse = ops._forward(q, k, v, *kw.values(), with_lse=True)
    assert lse is None and ops.LAUNCHES == 0
    assert torch.equal(out, flash_attention_plain(q, k, v, **kw))
