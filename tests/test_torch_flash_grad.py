# The gradient of the port's flash attention on the CPU against the JAX
# package: flash_attention_bwd_plain (dq, dk, dv written out) against
# jax.vjp of the reference's flash_attention_jnp, the function its training
# path differentiates (without a window; with a window, against jax.vjp of
# the reference's attention_ref, since flash_attention_jnp takes none), and
# against torch autograd of the port's attention_ref; over causal or not,
# sliding window, softcap and GQA groups, with ragged tiles.  The wrapper's
# CPU gradient (ops.FlashAttention) is the plain backward, exactly.  Inputs
# come from numpy with a seed.  Tolerance: 1e-4 (rtol and atol) in f32
# against JAX (both sum in f32, in other orders and tilings), 1e-5 against
# torch autograd of the materialised softmax.
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash.ref import attention_ref as jax_attention_ref
from repro.models.attention import flash_attention_jnp
from repro_torch.kernels.flash import ops
from repro_torch.kernels.flash.ref import attention_ref, flash_attention_bwd_plain

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
