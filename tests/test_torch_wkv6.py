# The port's WKV6 recurrence on the CPU against the JAX package: the plain
# versions (wkv6_plain, the chunked form the CUDA kernel is held to on the
# card, and wkv6_scan, the per-token oracle) and the CPU path of the wrapper
# held against wkv6_pallas in interpret mode, wkv6_ref and the model's
# _wkv_chunked, on the matrix of the reference's own wkv6 tests, plus the
# decay regimes the model's clip allows, a carried initial state and the
# final state.  Inputs come from numpy with a seed.
#
# Tolerances: 2e-3 over the reference's matrix and 1e-4 under strong decay,
# the reference's own (tests/test_kernels.py); all forms run in f32, the
# CUDA kernel's plain twin (wkv6_chunked_split_plain) with its products in
# split TF32.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.wkv6.kernel import wkv6_pallas
from repro.kernels.wkv6.ref import wkv6_ref
from repro.models.rwkv6 import _wkv_chunked, _wkv_chunked_factorized, _wkv_scan
from repro_torch.kernels.wkv6 import kernel, ops
from repro_torch.kernels.wkv6.ref import (
    KERNEL_TOL,
    agreement,
    split_tf32,
    tf32_round,
    wkv6_chunked_split_plain,
    wkv6_plain,
    wkv6_scan,
    wkv6_segmented_plain,
)
from repro_torch.models import rwkv6 as port_rwkv6
from test_torch_threads import cap_torch_threads

cap_torch_threads()

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
    # meta takes the dry run's route (outputs of the card path's shapes, no
    # computation); a device the wrapper does not run on is refused
    y, s_out = ops.wkv6(*(t.to("meta") for t in (r, k, v, lw, u)))
    assert y.device.type == "meta" and y.shape == r.shape and s_out.shape == s0.shape
    with pytest.raises(ValueError, match="not xpu"):
        ops.wkv6(*(_Elsewhere.of(t) for t in (r, k, v, lw, u)))


class _Elsewhere(torch.Tensor):
    """A CPU tensor that says it lies on an XPU."""

    @staticmethod
    def of(t: torch.Tensor) -> "_Elsewhere":
        return torch.Tensor._make_subclass(_Elsewhere, t)

    @property
    def device(self) -> torch.device:
        return torch.device("xpu")


def test_row_split_fills_the_card():
    """The chunked kernel splits the work across blocks by heads and
    sequence segments alone (the per-token scan's row split is gone): one
    block per (b, h, segment) of K = 16 or 64, chunks of CHUNK = 16 tokens.
    A serving batch (8 x 40 heads) gives an H100's 132 SMs two blocks each in
    one pass; one long prompt of 40 heads is cut until every SM has FILL
    blocks; the rule does not read K.  (The card test holds the library's
    residency at K = 64 to FILL_ONE_PASS blocks an SM.)"""
    sms = 132  # an H100 SXM

    def blocks(B, H, S, K):
        return B * H * kernel.segments(B, H, S, K, sms)

    assert kernel.CHUNK == 16 and kernel.HEAD_SIZES == (16, 64)
    assert blocks(8, 40, 2048, 64) == 320           # one pass: 2.4 blocks an SM
    assert blocks(1, 40, 16384, 64) >= kernel.FILL * sms
    assert blocks(1, 40, 16384, 16) == blocks(1, 40, 16384, 64)
    assert kernel.FILL_ONE_PASS <= kernel.FILL


@pytest.mark.parametrize("B,H,S,want", [
    (8, 40, 2048, 1), (8, 40, 300, 1), (1, 40, 16384, 27), (1, 40, 16385, 27), (4, 40, 300, 2),
    (1, 40, 2100, 15), (2, 3, 1000, 7), (1, 1, 77, 1)])
def test_segments_split_only_one_long_prompt(B, H, S, want):
    """One segment wherever the heads give every SM FILL_ONE_PASS blocks (a
    serving batch); otherwise enough for FILL blocks an SM, but no segment
    shorter than MIN_SEGMENT_CHUNKS chunks (1 x 16384: 27 segments of 608
    tokens; 2 x 3 heads of 1000 tokens: 7 of 144)."""
    assert kernel.segments(B, H, S, 64, 132) == want


def test_segments_cover_every_token_without_an_empty_one():
    """Never an empty segment, every token in one, and segments a multiple
    of the chunk."""
    sms = 132
    for B, H, K in ((1, 40, 64), (2, 3, 64), (2, 3, 16), (1, 1, 16), (8, 40, 64), (4, 40, 64)):
        for S in (0, 1, 15, 16, 17, 100, 127, 128, 129, 1263, 1264, 1265, 2048, 16384, 16385):
            n = kernel.segments(B, H, S, K, sms)
            L = kernel.segment_length(S, n)
            assert n >= 1 and L % kernel.CHUNK == 0
            assert (n - 1) * L < max(S, 1) <= n * L, (B, H, K, S, n, L)
            assert n == 1 or L >= kernel.MIN_SEGMENT_CHUNKS * kernel.CHUNK


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


def _bits(*words):
    return torch.from_numpy(np.array(words, np.uint32).view(np.float32))


def _words(t):
    return [int(w) for w in t.numpy().view(np.uint32)]


@pytest.mark.parametrize("word,want", [
    (0x3F801000, 0x3F802000),
    (0x3F803000, 0x3F804000),
    (0xBF801000, 0xBF802000),
    (0x3F800FFF, 0x3F800000),
    (0x3F801001, 0x3F802000),
    (0xBF800FFF, 0xBF800000),
    (0x00001000, 0x00002000),
    (0x80000FFF, 0x80000000),
    (0x007FF000, 0x00800000),
    (0x7F800000, 0x7F800000),
    (0xFF800000, 0xFF800000),
    (0x7F7FFFFF, 0x7F800000),
    (0x00000000, 0x00000000),
], ids=["tie-up", "odd-tie-away-not-even", "negative-tie-away", "below-tie", "above-tie", "negative-below-tie",
        "subnormal-tie", "negative-subnormal-to-minus-0", "largest-subnormal-to-normal", "inf", "minus-inf",
        "largest-finite-to-inf", "zero"])
def test_tf32_round_on_crafted_bit_patterns(word, want):
    """cvt.rna.tf32.f32: to nearest, ties away from zero (never to even),
    whatever the sign, on subnormals alike; infinities stay and a value past
    the largest TF32 number becomes one."""
    assert _words(tf32_round(_bits(word))) == [want]


def test_tf32_split_keeps_nans_and_recovers_the_value():
    """A NaN stays a NaN; hi and lo have TF32's low 13 bits clear, and hi +
    lo is x within 2^-21 of |x| over normal magnitudes from 2^-100 to
    2^100."""
    assert bool(torch.isnan(tf32_round(torch.tensor([float("nan")]))).all())
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=4096) * np.exp2(rng.integers(-100, 100, 4096))).astype(np.float32))
    hi, lo = split_tf32(x)
    assert all(w & 0x1FFF == 0 for w in _words(hi) + _words(lo))
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0**-21).all())
    assert not bool((hi == x).all())  # the split is not the identity: most x need lo


def _boundary(at):
    chunk = kernel.CHUNK
    return {"L-1": chunk - 1, "L": chunk, "L+1": chunk + 1, "3L+5": 3 * chunk + 5}[at]


@pytest.mark.parametrize("decay", ["random", "-54.6", "-5", "-3.4e-4"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "S0"])
@pytest.mark.parametrize("at", ["L-1", "L", "L+1", "3L+5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_tf32_plain_matches_the_reference_at_chunk_boundaries(dtype, at, with_state, decay):
    """The gate of the tensor-core kernel: its arithmetic with the products
    in split TF32 (wkv6_chunked_split_plain; the parts cut as the tensor
    cores read them), in one pass and over segments as the kernel cuts
    them, against wkv6_ref (y and the final state) and the Pallas kernel in
    interpret mode (at the kernel's chunk length L), at chunk boundaries and
    over the clip's decays: 2e-3, and 1e-4 under the strong decay (u = 0,
    as the reference's test).  With bf16 r, k and v (every operand split
    but v, which is exact in TF32) the references take the same values in
    f32."""
    chunk = kernel.CHUNK
    S = _boundary(at)
    lw = None if decay == "random" else float(decay)
    arrays = _inputs(S * 7 + chunk, 2, S, 3, 16, log_w=lw, with_state=with_state)
    tol = STRONG_TOL if decay == "-5" else TOL
    if decay == "-5":
        arrays[4] = np.zeros_like(arrays[4])
    arrays[:3] = [torch.from_numpy(a).to(dtype).float().numpy() for a in arrays[:3]]
    jr, jk, jv, jlw, ju, js0 = _jax(arrays)
    r, k, v, lw_, u, s0 = _torch(arrays)
    r, k, v = (t.to(dtype) for t in (r, k, v))
    oracle, oracle_s = wkv6_ref(jr, jk, jv, jlw, ju, js0)
    pallas = None if with_state else wkv6_pallas(jr, jk, jv, jlw, ju, chunk=chunk, interpret=True)
    for seg_len in (None, chunk):
        got, got_s = wkv6_chunked_split_plain(r, k, v, lw_, u, s0, seg_len=seg_len)
        assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(got_s).all())
        _close(got, oracle, tol)
        _close(got_s, oracle_s, tol)
        if pallas is not None:
            _close(got, pallas, tol)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "S0"])
@pytest.mark.parametrize("S", [1, 16385])
def test_split_tf32_plain_at_one_and_16385_tokens(S, with_state):
    """One token, and the consistency prefill's 16385 (a ragged last chunk
    after 1024 whole ones), in one pass and in 13 segments, against
    wkv6_ref and (from zero) the Pallas kernel in interpret mode."""
    chunk = kernel.CHUNK
    arrays = _inputs(S + chunk, 1, S, 1, 16, with_state=with_state)
    jr, jk, jv, jlw, ju, js0 = _jax(arrays)
    r, k, v, lw, u, s0 = _torch(arrays)
    oracle, oracle_s = wkv6_ref(jr, jk, jv, jlw, ju, js0)
    seg_len = -(-(-(-S // 13)) // chunk) * chunk
    for got, got_s in (wkv6_chunked_split_plain(r, k, v, lw, u, s0),
                       wkv6_chunked_split_plain(r, k, v, lw, u, s0, seg_len=seg_len)):
        _close(got, oracle, TOL)
        _close(got_s, oracle_s, TOL)
        if not with_state:
            _close(got, wkv6_pallas(jr, jk, jv, jlw, ju, chunk=chunk, interpret=True), TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_tf32_plain_at_rwkv6_head_size_holds_the_kernel_tolerance(dtype):
    """At rwkv6's head size (64) with r, k, v in f32 (every operand split)
    or bf16 (v exact in TF32, two products), the split form holds
    KERNEL_TOL against the f32 plain version and against the f64 scan, as
    closely as the f32 plain version does."""
    arrays = _inputs(64, 2, 77, 2, 64, with_state=True)
    r, k, v, lw, u, s0 = _torch(arrays)
    r, k, v = (t.to(dtype) for t in (r, k, v))
    want_y, want_s = wkv6_scan(r, k, v, lw, u, s0, dtype=torch.float64)
    plain_y, plain_s = wkv6_plain(r, k, v, lw, u, s0)
    got_y, got_s = wkv6_chunked_split_plain(r, k, v, lw, u, s0, seg_len=32)
    for got, plain, want in ((got_y, plain_y, want_y), (got_s, plain_s, want_s)):
        assert agreement(got, plain)["ok"]
        assert agreement(got, want)["worst"] <= max(2 * agreement(plain, want)["worst"], 0.05)
