# The port's Mamba2 block (models/mamba2.py) on the CPU against the JAX
# package's models/mamba2.py, on inputs drawn with numpy from a seed:
#
# * the depthwise causal conv on bf16, bit for bit, with and without a
#   carried state: it rounds each product, partial sum and the bias add
#   (ROADMAP C40);
# * the chunked SSD, the port's one-step-a-chunk transcription
#   (``_ssd_chunked``) and its batched form (``ssd_batched``, the serving
#   path), in f32 against the reference's ``_ssd_chunked`` at S in {5, 64,
#   100, 129}, with chunk 64 and smaller ones (chunk 4 at S = 129 carries
#   states across three blocks of ``_pass_states``), from a zero and a
#   random state: y and the final state within rtol 1e-4 / atol 1e-5 (f32
#   with another summation order).  The inputs are drawn as the block makes
#   them (dt log-uniform in [1e-3, 1e-1], A in [-16, -1]);
# * ``mamba2_block``'s prefill and a decode step from the prefill's state,
#   with a_log, dt_bias, conv_b and norm drawn as chip_smoke.py phase 21
#   draws them (``mamba2.spread_zero_inits_``), within PREFILL_TOL, the
#   conv state bit for bit;
# * the reference's compiled rounding the port follows: the gated norm of
#   the unrounded product (C41), gelu_tanh step by step (the shared block's
#   MLP), and the residual sum of one mamba2 layer normed unrounded by the
#   next (C42): two layers in one jitted function, bit for bit.
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jax_base
from repro.models import mamba2 as jm2
from repro.models import transformer as jax_transformer
from repro.models.common import tree_init
from repro_torch.configs import base
from repro_torch.models import mamba2
from repro_torch.models import transformer
from repro_torch.models.common import gelu_tanh, rms_norm, silu
from repro_torch.models.convert import tensor_from_numpy
from test_torch_threads import cap_torch_threads

cap_torch_threads()

ARCH = "zamba2-7b"
PREFILL_TOL = dict(rtol=5e-2, atol=5e-2)
SSD_TOL = dict(rtol=1e-4, atol=1e-5)


def _bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _bits(x) -> np.ndarray:
    """bf16 values as their int16 words (numpy's or torch's)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tree(tree):
    return jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a)), tree)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", [1, 5, 37])
def test_causal_conv1d_bitwise(S, carried):
    rng = np.random.default_rng(S + 10 * carried)
    C, W = 48, 4
    x = _bf16(rng.standard_normal((2, S, C)))
    w = _bf16(0.5 * rng.standard_normal((W, C)))
    b = _bf16(0.1 * rng.standard_normal(C))
    state = _bf16(rng.standard_normal((2, W - 1, C))) if carried else None
    want, want_state = jax.jit(jm2._causal_conv1d)(x, w, b, state)
    got, got_state = mamba2._causal_conv1d(*(tensor_from_numpy(a) for a in (x, w, b)),
                                           None if state is None else tensor_from_numpy(state))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if carried:
        np.testing.assert_array_equal(_bits(got_state), _bits(want_state))
    else:
        assert got_state is None and want_state is None


def _ssd_inputs(seed, B, S, H, P, N, random_state):
    rng = np.random.default_rng(seed)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, H)))
    xdt = (rng.standard_normal((B, S, H, P)) * dt[..., None]).astype(np.float32)
    log_decay = (-dt * rng.uniform(1.0, 16.0, H)).astype(np.float32)
    Bh = rng.standard_normal((B, S, H, N)).astype(np.float32)
    Ch = rng.standard_normal((B, S, H, N)).astype(np.float32)
    S0 = (rng.standard_normal((B, H, P, N)) if random_state else np.zeros((B, H, P, N))).astype(np.float32)
    return xdt, log_decay, Bh, Ch, S0


@pytest.mark.parametrize("random_state", [False, True])
@pytest.mark.parametrize("chunk", [64, 16, 4])
@pytest.mark.parametrize("S", [5, 64, 100, 129])
def test_ssd_matches_the_reference(S, chunk, random_state):
    args = _ssd_inputs(S * 7 + chunk, 2, S, 4, 8, 16, random_state)
    want_y, want_s = jax.jit(jm2._ssd_chunked, static_argnums=5)(*args, chunk)
    t = [torch.from_numpy(a) for a in args]
    for form in (mamba2._ssd_chunked, mamba2.ssd_batched):
        y, s = form(*t, chunk)
        assert y.shape == (2, S, 4, 8) and y.dtype == torch.float32, form.__name__
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL, err_msg=form.__name__)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **SSD_TOL, err_msg=form.__name__)


@pytest.mark.parametrize("S", [37, 129])
def test_ssd_batched_groups_broadcast_over_heads(S):
    """B and C of one group (G = 1) give what their copies for every head
    (G = H, the reference's repeated form) give."""
    xdt, log_decay, Bh, Ch, S0 = _ssd_inputs(S, 2, S, 6, 8, 16, True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    g1 = mamba2.ssd_batched(t(xdt), t(log_decay), t(Bh[:, :, :1]), t(Ch[:, :, :1]), t(S0), 16)
    rep = mamba2.ssd_batched(t(xdt), t(log_decay), t(np.repeat(Bh[:, :, :1], 6, 2)),
                             t(np.repeat(Ch[:, :, :1], 6, 2)), t(S0), 16)
    for a, b in zip(g1, rep):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SSD_TOL)


@pytest.mark.parametrize("n", [1, 5, 16, 17, 50])
def test_pass_states_matches_the_recurrence(n):
    """_pass_states' block products against S_{c+1} = e^{a_c} S_c + kv_c
    stepped one chunk at a time, in float64 (strong decays included)."""
    rng = np.random.default_rng(n)
    kv = torch.from_numpy(rng.standard_normal((2, n, 3, 4, 5)))
    log_a = torch.from_numpy(-np.exp(rng.uniform(-6.0, 4.0, (2, n, 3))))
    S0 = torch.from_numpy(rng.standard_normal((2, 3, 4, 5)))
    states, final = mamba2._pass_states(kv, log_a, S0, block=4)
    state = S0
    for c in range(n):
        torch.testing.assert_close(states[:, c], state, rtol=1e-12, atol=1e-12)
        state = torch.exp(log_a[:, c])[..., None, None] * state + kv[:, c]
    torch.testing.assert_close(final, state, rtol=1e-12, atol=1e-12)


def _block_params(seed: int):
    """The reduced zamba2 block's parameters: the reference's normal draws,
    then the constants drawn as phase 21 draws them (mamba2.spread_zero_inits_
    on a CPU generator), as (numpy tree for the reference, the port's)."""
    cfg = jax_base.reduced_config(jax_base.get_config(ARCH))
    tree = jax.tree.map(np.asarray, tree_init(jm2.mamba2_defs(cfg), jax.random.PRNGKey(seed)))
    port = {k: tensor_from_numpy(v) for k, v in tree.items()}
    gen = torch.Generator().manual_seed(seed)
    mamba2.spread_zero_inits_(port.items(), gen)
    ref = {k: np.asarray(jnp.asarray(v.float().numpy(), tree[k].dtype)) for k, v in port.items()}
    assert all(np.any(ref[k] != 0) for k in ("a_log", "dt_bias", "conv_b", "norm"))
    assert np.all(ref["dt_bias"] > -7.0) and np.all((ref["a_log"] >= 0) & (ref["a_log"] <= np.log(16) + 1e-3))
    return cfg, ref, port


def test_spread_zero_inits_follow_mamba2s_published_ranges():
    _, ref, _ = _block_params(3)
    dt = np.log1p(np.exp(ref["dt_bias"].astype(np.float64)))
    assert np.all((dt > 0.99e-3) & (dt < 1.01e-1))
    a = np.exp(ref["a_log"].astype(np.float64))
    assert np.all((a >= 1.0) & (a <= 16.0 + 1e-2))


@pytest.mark.parametrize("S", [1, 37, 64, 100])
def test_mamba2_block_prefill_and_decode(S):
    """The block's prefill from a zero state (its output, conv state bit for
    bit and ssm state) and a decode step from the prefill's state."""
    cfg, ref, port = _block_params(S)
    tcfg = base.reduced_config(base.get_config(ARCH))
    rng = np.random.default_rng(100 + S)
    x = _bf16(rng.standard_normal((2, S, cfg.d_model)))
    x1 = _bf16(rng.standard_normal((2, 1, cfg.d_model)))
    zero = jm2.mamba2_init_state(cfg, 2)

    def run(p, x, x1, st):
        out, st = jm2.mamba2_block(p, x, cfg, state=st)
        out1, st1 = jm2.mamba2_block(p, x1, cfg, state=st)
        return out, st, out1, st1

    want = jax.jit(run)(ref, x, x1, zero)
    st0 = mamba2.mamba2_init_state(tcfg, 2)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in st0.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in zero.items()}
    with torch.no_grad():
        out, st = mamba2.mamba2_block(port, tensor_from_numpy(x), tcfg, state=st0)
        out1, st1 = mamba2.mamba2_block(port, tensor_from_numpy(x1), tcfg, state=st)
    assert out.shape == (2, S, cfg.d_model) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(want[0]), **PREFILL_TOL)
    np.testing.assert_array_equal(_bits(st["conv"]), _bits(want[1]["conv"]))
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(want[1]["ssm"]), **PREFILL_TOL)
    np.testing.assert_allclose(_np(out1), _np(want[2]), **PREFILL_TOL)
    np.testing.assert_allclose(st1["ssm"].numpy(), np.asarray(want[3]["ssm"]), **PREFILL_TOL)


def test_gated_norm_takes_the_unrounded_product():
    """C41: rms_norm(y * silu(z)) in the compiled reference norms the bf16
    product unrounded.  The port's form matches it bit for bit but for the
    odd element whose f32 mean of squares sums in another order (one bf16
    unit at most); rounding the product first misses a tenth of them."""
    rng = np.random.default_rng(41)
    y, z = _bf16(rng.standard_normal((4, 64, 96))), _bf16(rng.standard_normal((4, 64, 96)))
    scale = _bf16(0.1 * rng.standard_normal(96))
    want = _bits(jax.jit(lambda y, z, s: jax_transformer.rms_norm(y * jax.nn.silu(z), s, 1e-6))(y, z, scale))
    ty, tz, ts = (tensor_from_numpy(a) for a in (y, z, scale))
    got = _bits(rms_norm(ty.float() * silu(tz).float(), ts, 1e-6).to(torch.bfloat16))
    rounded = _bits(rms_norm(ty * silu(tz), ts, 1e-6))
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    assert (got != want).mean() < 1e-3
    assert (rounded != want).mean() > 0.1


def test_gelu_tanh_rounds_step_by_step():
    """jax.nn.gelu(approximate=True) on bf16, as the compiled reference
    rounds it (its constants in bf16, each step rounded), bit for bit over
    every bf16 value x with 2^-100 <= |x| <= 8 (smaller ones reach f32
    subnormals, which the compiled reference flushes to zero)."""
    words = np.arange(-32768, 32768, dtype=np.int64).astype(np.int16)
    vals = words.view(jnp.bfloat16)
    mag = np.abs(vals.astype(np.float32))
    vals = vals[(mag <= 8.0) & (mag >= 2.0 ** -100)]
    want = jax.jit(lambda v: jax.nn.gelu(v, approximate=True))(vals)
    got = gelu_tanh(tensor_from_numpy(vals))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_consecutive_mamba2_layers_norm_the_unrounded_sum():
    """C42: inside the reference's compiled body, a layer's ln1 norms the
    previous mamba2 layer's residual sum unrounded (the residual itself is
    rounded); the port's apply_block carries that sum, bit for bit."""
    cfg = jax_base.reduced_config(jax_base.get_config(ARCH))
    tcfg = base.reduced_config(base.get_config(ARCH))
    defs = jax_transformer.block_defs(cfg, "mamba2")
    params = [jax.tree.map(np.asarray, tree_init(defs, jax.random.PRNGKey(k))) for k in (0, 1)]
    x = _bf16(np.random.default_rng(42).standard_normal((2, 24, cfg.d_model)))
    pos = jnp.broadcast_to(jnp.arange(24, dtype=jnp.int32)[None], (2, 24))

    def two(p0, p1, x):
        y, _, _ = jax_transformer.apply_block(p0, x, cfg, "mamba2", pos)
        return jax_transformer.apply_block(p1, y, cfg, "mamba2", pos)[0]

    want = jax.jit(two)(*params, x)
    tpos = torch.arange(24, dtype=torch.int32)[None].expand(2, 24)
    y = tensor_from_numpy(x)
    with torch.no_grad():
        for p in params:
            y, _, _ = transformer.apply_block(_tree(p), y, tcfg, "mamba2", tpos)
    assert y.dtype == torch.float32  # the unrounded sum
    np.testing.assert_array_equal(_bits(y.to(torch.bfloat16)), _bits(want))
