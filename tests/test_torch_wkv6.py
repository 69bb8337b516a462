# The port's WKV6 recurrence on the CPU against the JAX package: the plain
# versions (wkv6_plain, the chunked form the CUDA kernel is held to on the
# card, and wkv6_scan, the per-token oracle) and the CPU path of the wrapper
# held against wkv6_pallas in interpret mode, wkv6_ref and the model's
# _wkv_chunked, on the matrix of the reference's own wkv6 tests, plus the
# decay regimes the model's clip allows, a carried initial state and the
# final state.  Inputs come from numpy with a seed.
#
# Tolerances: 2e-3 over the reference's matrix and 1e-4 under strong decay,
# the reference's own (tests/test_kernels.py); all forms run in f32.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.wkv6.kernel import wkv6_pallas
from repro.kernels.wkv6.ref import wkv6_ref
from repro.models.rwkv6 import _wkv_chunked, _wkv_chunked_factorized, _wkv_scan
from repro_torch.kernels.wkv6 import kernel, ops
from repro_torch.kernels.wkv6.ref import KERNEL_TOL, agreement, wkv6_plain, wkv6_scan, wkv6_segmented_plain
from repro_torch.models import rwkv6 as port_rwkv6

TOL = dict(rtol=2e-3, atol=2e-3)
STRONG_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B, S, H, K, log_w=None, with_state=False):
    """r, k, v, log_w, u and S0 (or None) as f32 numpy arrays, after the
    reference's tests: r/k/v 0.5 N(0, 1), log_w -exp(N(0, 1)) unless given,
    u 0.3 N(0, 1), S0 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.normal(size=(B, S, H, K)) for _ in range(3))
    lw = -np.exp(rng.normal(size=(B, S, H, K))) if log_w is None else np.full((B, S, H, K), log_w)
    u = 0.3 * rng.normal(size=(H, K))
    s0 = rng.normal(size=(B, H, K, K)) if with_state else None
    return [None if a is None else np.asarray(a, np.float32) for a in (r, k, v, lw, u, s0)]


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("S", [16, 100, 256])
@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_and_scan_match_the_reference(S, K, chunk):
    """The reference's matrix: both plain versions against the Pallas kernel
    in interpret mode, the oracle scan and the model's chunked form."""
    arrays = _inputs(S * 3 + K + chunk, 2, S, 3, K)
    jr, jk, jv, jlw, ju, _ = _jax(arrays)
    r, k, v, lw, u, _ = _torch(arrays)
    pallas = wkv6_pallas(jr, jk, jv, jlw, ju, chunk=chunk, interpret=True)
    oracle, oracle_s = wkv6_ref(jr, jk, jv, jlw, ju)
    chunked, chunked_s = _wkv_chunked(jr, jk, jv, jlw, ju, jnp.zeros((2, 3, K, K), jnp.float32), chunk=chunk)
    plain, plain_s = wkv6_plain(r, k, v, lw, u, chunk=chunk)
    scan, scan_s = wkv6_scan(r, k, v, lw, u)
    for got in (plain, scan):
        for want in (pallas, oracle, chunked):
            _close(got, want, TOL)
    for got in (plain_s, scan_s):
        for want in (oracle_s, chunked_s):
            _close(got, want, TOL)


def test_strong_decay_is_exact():
    """Strong decay (w = e^-5 per token) at the reference's 1e-4."""
    arrays = _inputs(7, 1, 64, 2, 16, log_w=-5.0)
    arrays[4] = np.zeros_like(arrays[4])  # u = 0, as the reference's test
    jr, jk, jv, jlw, ju, _ = _jax(arrays)
    want, want_s = wkv6_ref(jr, jk, jv, jlw, ju)
    pallas = wkv6_pallas(jr, jk, jv, jlw, ju, chunk=16, interpret=True)
    r, k, v, lw, u, _ = _torch(arrays)
    for got, got_s in (wkv6_plain(r, k, v, lw, u), wkv6_scan(r, k, v, lw, u)):
        _close(got, want, STRONG_TOL)
        _close(got, pallas, STRONG_TOL)
        _close(got_s, want_s, STRONG_TOL)


@pytest.mark.parametrize("log_w", [-54.6, -3.4e-4])
def test_clip_range_stays_finite_and_exact(log_w):
    """The clip's strongest decay (-e^4: chunk sums far below any f32
    exponent) and its weakest (-e^-8) over 100 tokens, a ragged chunk
    tail included: finite, and the oracle's values."""
    arrays = _inputs(11, 2, 100, 3, 16, log_w=log_w, with_state=True)
    jr, jk, jv, jlw, ju, js0 = _jax(arrays)
    want, want_s = wkv6_ref(jr, jk, jv, jlw, ju, js0)
    r, k, v, lw, u, s0 = _torch(arrays)
    got, got_s = wkv6_plain(r, k, v, lw, u, s0)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(got_s).all())
    _close(got, want, TOL)
    _close(got_s, want_s, TOL)


@pytest.mark.parametrize("S", [1, 17, 37])
def test_final_state_at_ragged_lengths(S):
    """S_out against wkv6_ref's, where S is not a multiple of the chunk."""
    arrays = _inputs(S, 2, S, 3, 16)
    jr, jk, jv, jlw, ju, _ = _jax(arrays)
    want, want_s = wkv6_ref(jr, jk, jv, jlw, ju)
    r, k, v, lw, u, _ = _torch(arrays)
    got, got_s = ops.wkv6(r, k, v, lw, u)
    _close(got, want, TOL)
    _close(got_s, want_s, TOL)


def test_carried_state_matches_the_models_chunked_form():
    """A nonzero S0 against the JAX model's _wkv_chunked, and two halves of
    a sequence, the second from the first's state, against the whole."""
    arrays = _inputs(5, 2, 80, 3, 16, with_state=True)
    jr, jk, jv, jlw, ju, js0 = _jax(arrays)
    want, want_s = _wkv_chunked(jr, jk, jv, jlw, ju, js0, chunk=16)
    r, k, v, lw, u, s0 = _torch(arrays)
    got, got_s = wkv6_plain(r, k, v, lw, u, s0)
    _close(got, want, TOL)
    _close(got_s, want_s, TOL)
    y1, mid = wkv6_plain(r[:, :45], k[:, :45], v[:, :45], lw[:, :45], u, s0)
    y2, end = wkv6_plain(r[:, 45:], k[:, 45:], v[:, 45:], lw[:, 45:], u, mid)
    _close(torch.cat([y1, y2], dim=1), want, TOL)
    _close(end, want_s, TOL)


def test_model_forms_match_the_reference():
    """The model module's three forms against the JAX package's."""
    arrays = _inputs(9, 2, 48, 3, 16, with_state=True)
    jr, jk, jv, jlw, ju, js0 = _jax(arrays)
    r, k, v, lw, u, s0 = _torch(arrays)
    for port, ref in ((port_rwkv6._wkv_scan, _wkv_scan), (port_rwkv6._wkv_chunked, _wkv_chunked),
                      (port_rwkv6._wkv_chunked_factorized, _wkv_chunked_factorized)):
        got, got_s = port(r, k, v, lw, u, s0)
        want, want_s = ref(jr, jk, jv, jlw, ju, js0)
        _close(got, want, TOL)
        _close(got_s, want_s, TOL)


def test_bf16_inputs_are_widened_exactly():
    """r, k and v in bf16 give what their f32 widening gives."""
    arrays = _inputs(3, 1, 40, 2, 16)
    r, k, v, lw, u, _ = _torch(arrays)
    rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
    got, got_s = ops.wkv6(rb, kb, vb, lw, u.to(torch.bfloat16))
    want, want_s = wkv6_plain(rb.float(), kb.float(), vb.float(), lw, u.to(torch.bfloat16).float())
    assert got.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(got_s, want_s)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    arrays = _inputs(2, 2, 33, 3, 16, with_state=True)
    r, k, v, lw, u, s0 = _torch(arrays)
    ops.reset_launches()
    got, got_s = ops.wkv6(r, k, v, lw, u, s0)
    want, want_s = wkv6_plain(r, k, v, lw, u, s0)
    assert torch.equal(got, want) and torch.equal(got_s, want_s)
    assert ops.LAUNCHES == 0  # the plain version launches nothing


def test_wrapper_rejects_what_the_kernel_does_not_take():
    r, k, v, lw, u, s0 = _torch(_inputs(2, 2, 8, 3, 16, with_state=True))
    with pytest.raises(ValueError, match="disagree"):
        ops.wkv6(r, k[:, :4], v, lw, u)
    with pytest.raises(ValueError, match="u"):
        ops.wkv6(r, k, v, lw, u[:2])
    with pytest.raises(ValueError, match="S0"):
        ops.wkv6(r, k, v, lw, u, s0[:1])
    with pytest.raises(TypeError, match="log_w"):
        ops.wkv6(r, k, v, lw.double(), u)
    with pytest.raises(TypeError):
        ops.wkv6(r, k.to(torch.bfloat16), v, lw, u)
    with pytest.raises(ValueError, match="meta"):
        ops.wkv6(*(t.to("meta") for t in (r, k, v, lw, u)))


def test_row_split_fills_the_card():
    """The fewest threads to a state column that give two blocks per SM,
    more (thinner blocks) when B * H is small; K = 16 is built for one
    split."""
    sms = 132  # an H100 SXM
    assert kernel.row_split(8, 40, 64, sms) == 4     # serving batch: 320 blocks of 64 columns
    assert kernel.row_split(4, 40, 64, sms) == 8     # 320 blocks of 32 columns
    assert kernel.row_split(1, 40, 64, sms) == 16    # one long prompt: 160 blocks of 16 columns
    assert kernel.row_split(1, 40, 16, sms) == 4
    assert tuple(kernel.ROW_SPLITS) == (16, 64)


def test_segments_split_only_one_long_prompt():
    """One segment wherever the heads already give two blocks per SM (a
    serving batch); more for one long prompt; never an empty segment, and
    every token in one."""
    sms = 132
    assert kernel.segments(8, 40, 2048, 64, sms) == 1
    assert kernel.segments(1, 40, 16384, 64, sms) > 1
    assert kernel.segments(1, 40, 16385, 64, sms) > 1
    for B, H, K in ((1, 40, 64), (2, 3, 64), (2, 3, 16), (1, 1, 16), (8, 40, 64)):
        for S in (0, 1, 15, 16, 17, 100, 1263, 1264, 1265, 16384, 16385):
            n = kernel.segments(B, H, S, K, sms)
            L = kernel.segment_length(S, n)
            assert n >= 1 and L % kernel.TOKENS_STAGED == 0
            assert (n - 1) * L < max(S, 1) <= n * L, (B, H, K, S, n, L)


@pytest.mark.parametrize("S,seg_len", [(12, 16), (15, 16), (16, 16), (17, 16), (53, 16), (100, 32)],
                         ids=["S<L", "S=L-1", "S=L", "S=L+1", "3L+5", "ragged"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "S0"])
def test_segmented_plain_matches_the_reference(S, seg_len, with_state):
    """The kernel's three passes (segment states, carry, rescan), written
    plainly, against wkv6_plain, the Pallas kernel in interpret mode and
    wkv6_ref (y and the final state), at the reference's 2e-3."""
    arrays = _inputs(S + seg_len, 2, S, 3, 16, with_state=with_state)
    jr, jk, jv, jlw, ju, js0 = _jax(arrays)
    r, k, v, lw, u, s0 = _torch(arrays)
    got, got_s = wkv6_segmented_plain(r, k, v, lw, u, s0, seg_len=seg_len)
    plain, plain_s = wkv6_plain(r, k, v, lw, u, s0)
    oracle, oracle_s = wkv6_ref(jr, jk, jv, jlw, ju, js0)
    _close(got, plain, TOL)
    _close(got_s, plain_s, TOL)
    _close(got, oracle, TOL)
    _close(got_s, oracle_s, TOL)
    if not with_state:
        _close(got, wkv6_pallas(jr, jk, jv, jlw, ju, chunk=16, interpret=True), TOL)


@pytest.mark.parametrize("log_w,tol", [(-54.6, TOL), (-3.4e-4, TOL), (-5.0, STRONG_TOL)],
                         ids=["clip-strongest", "clip-weakest", "strong"])
def test_segmented_plain_across_the_decay_range(log_w, tol):
    """The clip's strongest and weakest decays over several segments and a
    ragged tail, from a carried state: finite, and wkv6_ref's values; strong
    decay (u = 0, as the reference's test) at the reference's 1e-4."""
    arrays = _inputs(23, 2, 75, 3, 16, log_w=log_w, with_state=True)
    if tol is STRONG_TOL:
        arrays[4] = np.zeros_like(arrays[4])
    jr, jk, jv, jlw, ju, js0 = _jax(arrays)
    want, want_s = wkv6_ref(jr, jk, jv, jlw, ju, js0)
    r, k, v, lw, u, s0 = _torch(arrays)
    got, got_s = wkv6_segmented_plain(r, k, v, lw, u, s0, seg_len=16)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(got_s).all())
    _close(got, want, tol)
    _close(got_s, want_s, tol)
    plain, plain_s = wkv6_plain(r, k, v, lw, u, s0)
    _close(got, plain, tol)
    _close(got_s, plain_s, tol)


def test_agreement_catches_a_dropped_token_and_a_lost_bonus():
    """The kernel's tolerance rejects a y whose one token lost its carried
    state, and one without the bonus u, though each changes few elements."""
    arrays = _inputs(4, 1, 64, 2, 16, with_state=True)
    r, k, v, lw, u, s0 = _torch(arrays)
    want, _ = wkv6_plain(r, k, v, lw, u, s0)
    assert agreement(want.clone(), want)["ok"]
    dropped = want.clone()
    dropped[:, 40] = wkv6_plain(r[:, 40:41], k[:, 40:41], v[:, 40:41], lw[:, 40:41], u)[0][:, 0]
    assert not agreement(dropped, want)["ok"]
    no_bonus, _ = wkv6_plain(r, k, v, lw, torch.zeros_like(u), s0)
    assert not agreement(no_bonus, want)["ok"]
    assert KERNEL_TOL["rtol"] <= 2e-3


def test_agreement_rejects_a_non_finite_output():
    """A NaN or inf anywhere fails the check, whatever the other elements."""
    r, k, v, lw, u, _ = _torch(_inputs(5, 1, 32, 2, 16))
    want, _ = wkv6_plain(r, k, v, lw, u)
    for bad in (float("nan"), float("inf")):
        got = want.clone()
        got[0, 7, 1, 3] = bad
        assert not agreement(got, want)["ok"]


def test_scan_in_f64_is_a_witness_for_both_f32_forms():
    """wkv6_scan in f64, the witness chip_smoke.py holds the kernel and the
    plain version to at the serving shapes, returns f64 and agrees with both
    f32 forms within the kernel's tolerance, under a weak decay that lets
    the state grow over 256 tokens."""
    r, k, v, lw, u, s0 = _torch(_inputs(6, 2, 256, 3, 16, log_w=-3.4e-4, with_state=True))
    want_y, want_s = wkv6_scan(r, k, v, lw, u, s0, dtype=torch.float64)
    assert want_y.dtype == want_s.dtype == torch.float64
    for y, st in (wkv6_scan(r, k, v, lw, u, s0), wkv6_plain(r, k, v, lw, u, s0)):
        assert y.dtype == torch.float32
        assert agreement(y, want_y)["ok"] and agreement(st, want_s)["ok"]
