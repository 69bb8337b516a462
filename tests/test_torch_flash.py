# The port's flash attention on the CPU against the JAX package: the plain
# versions (flash_attention_plain, attention_ref) and the CPU path of the
# wrapper held against flash_attention_pallas in interpret mode, the JAX
# attention_ref and flash_attention_jnp, on the matrix of the reference's
# own flash tests, plus the sliding window beyond its width against both
# packages' banded_window_attention.  Inputs come from numpy with a seed.
# Tolerances are the reference's: 2e-3 for f32, 3e-2 for bf16.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash.kernel import flash_attention_pallas
from repro.kernels.flash.ref import attention_ref as jax_attention_ref
from repro.models.attention import banded_window_attention as jax_banded
from repro.models.attention import flash_attention_jnp
from repro_torch.kernels.flash import kernel, ops
from repro_torch.kernels.flash.ref import KERNEL_TOL, agreement, attention_ref, flash_attention_plain
from repro_torch.models.attention import banded_window_attention
from test_torch_threads import cap_torch_threads

cap_torch_threads()

F32_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _inputs(seed, B, Sq, Sk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    return q, k, v


def _jax(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _close(got: torch.Tensor, want, tol) -> None:
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("S,D,Hkv", [(64, 32, 2), (128, 64, 4), (200, 16, 1)])
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (False, 0, 0.0), (True, 32, 0.0), (True, 0, 30.0),
])
def test_flash_sweep(S, D, Hkv, causal, window, cap):
    B, H = 2, Hkv * 2
    q, k, v = _inputs(S + D, B, S, S, H, Hkv, D)
    kw = dict(causal=causal, window=window, scale=D ** -0.5, logit_softcap=cap)
    pallas = flash_attention_pallas(_jax(q), _jax(k), _jax(v), q_block=64, kv_block=64,
                                    interpret=True, **kw)
    oracle = jax_attention_ref(_jax(q), _jax(k), _jax(v), **kw)
    tq, tk, tv = _torch(q), _torch(k), _torch(v)
    # small tiles so that the plain version walks, and skips, many of them
    plain = flash_attention_plain(tq, tk, tv, q_block=48, kv_block=32, **kw)
    ref = attention_ref(tq, tk, tv, **kw)
    for got in (plain, ref, ops.flash_attention(tq, tk, tv, **kw)):
        _close(got, pallas, F32_TOL)
        _close(got, oracle, F32_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_flash_dtypes(dtype, tol):
    B, S, H, Hkv, D = 1, 96, 4, 2, 32
    q, k, v = _inputs(5, B, S, S, H, Hkv, D)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = _jax(q, jdt), _jax(k, jdt), _jax(v, jdt)
    pallas = flash_attention_pallas(jq, jk, jv, scale=D ** -0.5, q_block=32, kv_block=32, interpret=True)
    oracle = jax_attention_ref(jq, jk, jv, scale=D ** -0.5)
    tq, tk, tv = _torch(q, tdt), _torch(k, tdt), _torch(v, tdt)
    for got in (flash_attention_plain(tq, tk, tv, scale=D ** -0.5, q_block=32, kv_block=32),
                attention_ref(tq, tk, tv, scale=D ** -0.5)):
        assert got.dtype == tdt
        _close(got, pallas, tol)
        _close(got, oracle, tol)


@pytest.mark.parametrize("window", [0, 40])
def test_flash_decode_offset(window):
    """Sq < Sk: the query block sits at the end of the key range."""
    B, Sq, Sk, H, Hkv, D = 1, 8, 128, 4, 2, 32
    q, k, v = _inputs(7, B, Sq, Sk, H, Hkv, D)
    kw = dict(causal=True, window=window, scale=D ** -0.5)
    pallas = flash_attention_pallas(_jax(q), _jax(k), _jax(v), q_block=8, kv_block=32, interpret=True, **kw)
    oracle = jax_attention_ref(_jax(q), _jax(k), _jax(v), **kw)
    tq, tk, tv = _torch(q), _torch(k), _torch(v)
    for got in (flash_attention_plain(tq, tk, tv, q_block=8, kv_block=32, **kw), attention_ref(tq, tk, tv, **kw)):
        _close(got, pallas, F32_TOL)
        _close(got, oracle, F32_TOL)


def test_flash_matches_model_attention():
    """The plain version and the JAX package's scan-flash agree."""
    B, S, H, Hkv, D = 2, 160, 8, 4, 32
    q, k, v = _inputs(11, B, S, S, H, Hkv, D)
    want = flash_attention_jnp(_jax(q), _jax(k), _jax(v), causal=True, scale=D ** -0.5, q_block=64, kv_block=64)
    got = flash_attention_plain(_torch(q), _torch(k), _torch(v), scale=D ** -0.5, q_block=64, kv_block=64)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_window_beyond_its_width_matches_banded(dtype, tol):
    """S > window: the kernel's mask with window=W is the band 0 <= q-k < W."""
    B, S, H, Hkv, D, W = 2, 40, 4, 2, 16, 16
    q, k, v = _inputs(13, B, S, S, H, Hkv, D)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(window=W, scale=D ** -0.5, logit_softcap=50.0)
    want = jax_banded(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt), **kw)
    tq, tk, tv = _torch(q, tdt), _torch(k, tdt), _torch(v, tdt)
    port_banded = banded_window_attention(tq, tk, tv, **kw)
    _close(port_banded, want, tol)
    got = flash_attention_plain(tq, tk, tv, causal=True, q_block=8, kv_block=8, **kw)
    _close(got, want, tol)
    _close(got, port_banded, tol)


def test_fully_masked_rows_give_zero():
    """Sq > Sk with a causal mask leaves the first rows no key: they give 0,
    as the Pallas kernel writes them and attention_ref turns NaN rows to 0."""
    q, k, v = _inputs(17, 1, 12, 4, 2, 1, 16)
    tq, tk, tv = _torch(q), _torch(k), _torch(v)
    got = flash_attention_plain(tq, tk, tv, causal=True, q_block=4, kv_block=2)
    want = attention_ref(tq, tk, tv, causal=True)
    assert torch.count_nonzero(got[:, :8]) == 0
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("S", [1024, 8192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_tolerance_catches_a_dropped_key_tile(dtype, S):
    """The limits the kernel is held to on the card pass the plain version
    against itself at other tile sizes, and reject an output whose last 64
    query rows lost one 64-key tile of the S they see (at S=8192 in bf16,
    allclose with rtol = atol = 3e-2 lets that output through)."""
    B, H, Hkv, D, T = 1, 2, 1, 64, 64
    tdt = getattr(torch, dtype)
    tq, tk, tv = (_torch(a, tdt) for a in _inputs(19, B, S, S, H, Hkv, D))
    kw = dict(causal=True, scale=D ** -0.5, logit_softcap=50.0)
    want = flash_attention_plain(tq, tk, tv, **kw)
    assert agreement(flash_attention_plain(tq, tk, tv, q_block=64, kv_block=128, **kw), want)["ok"]
    keep = torch.ones(S, dtype=torch.bool)
    keep[2 * T : 3 * T] = False
    dropped = want.clone()
    dropped[:, -T:] = flash_attention_plain(tq[:, -T:], tk[:, keep], tv[:, keep], **kw)
    agree = agreement(dropped, want)
    assert not agree["ok"] and agree["worst"] > 1.0, agree
    if S == 1024:  # one tile in 16, lost by a sixteenth of the rows: the norm shows it too
        assert agree["rel"] > KERNEL_TOL[tdt]["rel"], agree


def test_cpu_tensors_launch_nothing_and_bad_inputs_raise():
    ops.reset_launches()
    q, k, v = (torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8))
    ops.flash_attention(q, k, v)
    assert ops.LAUNCHES == 0
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8))  # 2 % 3
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, torch.zeros(1, 5, 1, 8))
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.to(torch.bfloat16), v)
    # meta takes the dry run's route (an output of the card path's shape, no
    # computation); a device the wrapper does not run on is refused
    out = ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape and ops.LAUNCHES == 0
    with pytest.raises(ValueError, match="not xpu"):
        ops.flash_attention(*(_Elsewhere.of(t) for t in (q, k, v)))


class _Elsewhere(torch.Tensor):
    """A CPU tensor that says it lies on an XPU."""

    @staticmethod
    def of(t: torch.Tensor) -> "_Elsewhere":
        return torch.Tensor._make_subclass(_Elsewhere, t)

    @property
    def device(self) -> torch.device:
        return torch.device("xpu")


@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_kernel_tiles_fit_the_sm(D):
    """The bf16 kernel's tiles at each head dim fit one H100 SM: shared
    memory (q tile and the k/v ring) within a block's 227 KB, the registers
    setmaxnreg hands out within the SM's file, two consumer warpgroups of 64
    query rows, and key tiles that wgmma takes (N a multiple of 16 up to
    256, D a multiple of its 16-deep step)."""
    t = kernel.TILES[D]
    assert kernel.smem_bytes(D) <= kernel.SMEM_LIMIT
    assert kernel.registers_per_block() <= kernel.REGISTER_FILE
    assert kernel.THREADS == 3 * 128 and t["q_block"] == 2 * 64
    assert t["kv_block"] % 16 == 0 and 16 <= t["kv_block"] <= 256 and D % 16 == 0
    assert t["stages"] >= 2
    for regs in (kernel.PRODUCER_REGS, kernel.CONSUMER_REGS):
        assert regs % 8 == 0 and 24 <= regs <= 256
    # the f32 accumulator of 64 x D and the scores of 64 x kv_block, per thread
    # of a consumer warpgroup, leave room in its registers
    assert D // 2 + t["kv_block"] // 2 + t["kv_block"] // 4 < kernel.CONSUMER_REGS


@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
@pytest.mark.parametrize("Sq,Sk,window,cap", [(200, 200, 0, 50.0), (129, 300, 96, 0.0)])
def test_plain_at_kernel_tiles_matches_pallas(D, Sq, Sk, window, cap):
    """The plain version walking the bf16 kernel's own tiles (q_block,
    kv_block) against the Pallas kernel in interpret mode at the same tiles,
    with queries crossing a 128-query tile and (Sq < Sk) the causal offset
    inside one."""
    t = kernel.TILES[D]
    B, H, Hkv = 1, 2, 1
    q, k, v = _inputs(D + Sq, B, Sq, Sk, H, Hkv, D)
    kw = dict(causal=True, window=window, scale=D ** -0.5, logit_softcap=cap)
    pallas = flash_attention_pallas(_jax(q), _jax(k), _jax(v), q_block=t["q_block"], kv_block=t["kv_block"],
                                    interpret=True, **kw)
    got = flash_attention_plain(_torch(q), _torch(k), _torch(v), q_block=t["q_block"], kv_block=t["kv_block"], **kw)
    _close(got, pallas, F32_TOL)
