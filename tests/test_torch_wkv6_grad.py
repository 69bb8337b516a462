# The gradient of the port's WKV6 recurrence on the CPU: the backward
# kernel's plain version (ref.wkv6_bwd_plain) against torch autograd of the
# per-token scan (wkv6_scan) in float64, and against jax.grad of the JAX
# package's chunked form (models/rwkv6._wkv_chunked, which the reference
# trains through) and of its oracle (kernels/wkv6/ref.wkv6_ref), for every
# output (dr, dk, dv, dlog_w, du, dS0), at ragged lengths, over the decay
# regimes the model's clip allows, with a carried state and a gradient of
# the final state; gradcheck of the autograd Function ops.WKV6; the CPU path
# of ops.wkv6 under a gradient; and the mutations ref.BWD_TOL must reject.
# The CUDA kernel's own arithmetic on the CPU (ref.wkv6_bwd_chunked_split_plain:
# chunks, log2 units, split-TF32 products, dlog_w from its four direct
# terms, segments with both carries) against the plain walk in float64 and
# against jax.grad, and its mutations.  Inputs come from numpy with a seed.
#
# Tolerances: the plain version in f64 against autograd in f64 within
# 1e-10 relative (the same sums in another order); jax.grad, run in f32
# (x64 off), within ref.BWD_TOL's f32 limits of the plain version in f64,
# the limits the CUDA kernel is held to on the card (tests/test_torch_cuda.py,
# chip_smoke.py phase 17); the plain version in f32 within them too.  One
# exception, the reference's own: jax.grad of the chunked form takes dlog_w
# through the cumulative sums of log_w, whose f32 terms (of the order of
# r . dr) cancel to it, so under a strong decay (dlog_w ~ e^{-5} to
# e^{-54.6} of those terms) its error is ~1e-6 of the terms' scale, not of
# dlog_w (the reverse-cumsum cancellation; read: 7e-6 of rms(dr) at worst).
# Its dlog_w is held per element within BWD_TOL's rtol of |want| plus
# REF_DLOGW_ATOL times the rms of dr.
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.wkv6.ref import wkv6_ref
from repro.models.rwkv6 import _wkv_chunked
from repro_torch.kernels._agreement import agreement
from repro_torch.kernels.wkv6 import ops
from repro_torch.kernels.wkv6 import ref
from repro_torch.kernels.wkv6.ref import (BWD_NAMES, BWD_TOL, bwd_agreement, wkv6_bwd_chunked_split_plain,
                                          wkv6_bwd_plain, wkv6_scan)
from test_torch_threads import cap_torch_threads

cap_torch_threads()

F64_REL = 1e-10
REF_DLOGW_ATOL = 2e-5
DECAYS = {"random": None, "-5": -5.0, "-54.6": -54.6, "-3.4e-4": -3.4e-4}


def _inputs(seed, B, S, H, K, decay=None, with_state=True):
    """r, k, v 0.5 N(0, 1), log_w -exp(N(0, 1)) unless ``decay``, u
    0.3 N(0, 1), S0 N(0, 1), dy N(0, 1), dS_out N(0, 1) (S0 and dS_out None
    without a state), as f64 numpy arrays."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.normal(size=(B, S, H, K)) for _ in range(3))
    lw = -np.exp(rng.normal(size=(B, S, H, K))) if decay is None else np.full((B, S, H, K), decay)
    u = 0.3 * rng.normal(size=(H, K))
    s0 = rng.normal(size=(B, H, K, K)) if with_state else None
    dy = rng.normal(size=(B, S, H, K))
    ds = rng.normal(size=(B, H, K, K)) if with_state else None
    return r, k, v, lw, u, s0, dy, ds


def _torch(arrays, dtype=torch.float64):
    return [None if a is None else torch.tensor(a, dtype=dtype) for a in arrays]


def _autograd_of_scan(r, k, v, lw, u, s0, dy, ds):
    """torch autograd of wkv6_scan in f64: (dr, dk, dv, dlog_w, du, dS0)."""
    leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
    s = torch.zeros(r.shape[0], r.shape[2], r.shape[3], r.shape[3], dtype=torch.float64) if s0 is None else s0
    s = s.clone().requires_grad_()
    y, s_out = wkv6_scan(*leaves, s, dtype=torch.float64)
    loss = (y * dy).sum() + (0.0 if ds is None else (s_out * ds).sum())
    grads = torch.autograd.grad(loss, leaves + [s], allow_unused=True)  # log_w is unused at S = 1 alone
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves + [s])]


def _jax_grad(fn, r, k, v, lw, u, s0, dy, ds):
    """jax.grad (f32) of sum(y dy) + sum(S_out dS_out) through ``fn``, for
    (r, k, v, log_w, u, S0)."""
    B, _, H, K = r.shape
    s0 = np.zeros((B, H, K, K)) if s0 is None else s0
    ds = np.zeros((B, H, K, K)) if ds is None else ds
    f32 = [jnp.asarray(a, jnp.float32) for a in (r, k, v, lw, u, s0)]

    def loss(*xs):
        y, s_out = fn(*xs)
        return jnp.sum(y * jnp.asarray(dy, jnp.float32)) + jnp.sum(s_out * jnp.asarray(ds, jnp.float32))

    return [torch.from_numpy(np.array(g)) for g in jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*f32)]


def _rel(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-300))


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("S", [1, 16, 37, 70])
def test_plain_matches_autograd_of_the_scan_in_f64(S, decay, with_state):
    arrays = _inputs(S + 3, 2, S, 3, 16, DECAYS[decay], with_state)
    t = _torch(arrays)
    got = wkv6_bwd_plain(*t, dtype=torch.float64)
    want = _autograd_of_scan(*t)
    for name, g, w in zip(BWD_NAMES, got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        assert _rel(g, w) <= F64_REL, (name, _rel(g, w))


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("S", [1, 37, 53])
@pytest.mark.parametrize("form", ["chunked", "wkv6_ref"])
def test_plain_matches_jax_grad_of_the_reference(form, S, decay, with_state):
    """jax.grad of the reference's chunked form (what it trains through) and
    of its oracle, every output including du and dS0, within BWD_TOL's f32
    limits of the plain version in f64."""
    arrays = _inputs(S * 7 + len(decay), 2, S, 3, 16, DECAYS[decay], with_state)
    fn = _wkv_chunked if form == "chunked" else wkv6_ref
    got = _jax_grad(fn, *arrays)
    want, scales = wkv6_bwd_plain(*_torch(arrays), dtype=torch.float64, with_scales=True)
    agree = bwd_agreement(got, want, scales)
    bad = {n: (p["worst"], p["rel"]) for n, p in agree["parts"].items() if not p["ok"]}
    assert set(bad) <= {"dlog_w"}, bad
    scale = float(want[0].square().mean().sqrt())
    limit = BWD_TOL[torch.float32]["rtol"] * want[3].abs() + REF_DLOGW_ATOL * scale
    assert bool(((got[3].double() - want[3]).abs() <= limit).all())
    if form == "wkv6_ref" or decay in ("random", "-3.4e-4"):
        assert not bad, bad  # the per-token oracle, and a weak decay, pass BWD_TOL itself


def test_plain_matches_jax_grad_at_head_size_64():
    arrays = _inputs(64, 1, 45, 2, 64, None, True)
    got = _jax_grad(_wkv_chunked, *arrays)
    assert bwd_agreement(got, *wkv6_bwd_plain(*_torch(arrays), dtype=torch.float64, with_scales=True))["ok"]


@pytest.mark.parametrize("decay", ["random", "-54.6", "-3.4e-4"])
@pytest.mark.parametrize("S", [1, 16, 53, 208])
def test_plain_in_f32_is_within_the_kernels_limits(S, decay):
    """The walk in f32, the CUDA kernel's arithmetic, within BWD_TOL of the
    walk in f64, at ragged and whole lengths; on these random inputs without
    the terms' magnitudes too."""
    arrays = _inputs(S, 1, S, 2, 64, DECAYS[decay], True)
    want, scales = wkv6_bwd_plain(*_torch(arrays), dtype=torch.float64, with_scales=True)
    got = wkv6_bwd_plain(*_torch(arrays, torch.float32), dtype=torch.float32)
    assert bwd_agreement(got, want, scales)["ok"]
    agree = bwd_agreement(got, want)
    assert agree["ok"], {n: (p["worst"], p["rel"]) for n, p in agree["parts"].items()}


def test_gradcheck_of_the_function():
    """torch.autograd.gradcheck of ops.WKV6 (its plain forward and backward
    on the CPU) at a tiny f64 shape, with a state and both outputs' gradients."""
    r, k, v, lw, u, s0, _, _ = _torch(_inputs(9, 1, 5, 2, 3, None, True))
    leaves = [t.requires_grad_() for t in (r, k, v, lw, u, s0)]
    assert torch.autograd.gradcheck(lambda *xs: ops.WKV6.apply(*xs), leaves)


def test_cpu_path_under_a_gradient_takes_the_plain_backward():
    """ops.wkv6 with an input that requires grad goes through WKV6: on the
    CPU its backward is the plain version (counted), the outputs keep their
    inputs' types (bf16 r, k, v and u), and the gradients match the plain
    version's, which gives S0 none when S0 does not require grad."""
    r, k, v, lw, u, s0, dy, ds = _inputs(3, 2, 37, 3, 16, None, True)
    rb, kb, vb, ub = (torch.tensor(a, dtype=torch.float32).to(torch.bfloat16) for a in (r, k, v, u))
    lw32, s032, dy32, ds32 = (torch.tensor(a, dtype=torch.float32) for a in (lw, s0, dy, ds))
    leaves = [t.clone().requires_grad_() for t in (rb, kb, vb, lw32, ub)]
    ops.reset_launches()
    y, s_out = ops.wkv6(*leaves, s032)
    assert y.grad_fn is not None and y.dtype == torch.float32
    torch.autograd.backward((y, s_out), (dy32, ds32))
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES, ops.PLAIN_BWD_CALLS) == (0, 0, 1)
    want = wkv6_bwd_plain(rb, kb, vb, lw32, ub, s032, dy32, ds32)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype and torch.equal(leaf.grad, w.to(leaf.dtype))
    # without a gradient the forward alone runs, with no graph
    with torch.no_grad():
        y2, _ = ops.wkv6(*leaves, s032)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())


# ---------------------------------------------------------------------------
# what BWD_TOL must reject, each a mutated copy of the plain version in f32
# ---------------------------------------------------------------------------


def _mutants(t32):
    """(name, outputs) of the f32 walk with one fault each: a token's
    gradient dropped (dr, dk, dv, dlog_w zero at one token), the bonus
    term lost (the walk run with u = 0, so dr, dk and dv lose their u
    terms; du keeps none of u), and the decay taken one token late."""
    r, k, v, lw, u, s0, dy, ds = t32
    good = wkv6_bwd_plain(*t32)
    dropped = [g.clone() for g in good]
    for g in dropped[:4]:
        g[:, 20] = 0
    no_bonus = wkv6_bwd_plain(r, k, v, lw, torch.zeros_like(u), s0, dy, ds)
    late = torch.cat([lw[:, :1], lw[:, :-1]], dim=1)
    off_by_one = wkv6_bwd_plain(r, k, v, late, u, s0, dy, ds)
    return good, [("dropped token", dropped), ("lost bonus", no_bonus), ("decay off by one", off_by_one)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bwd_tol_rejects_a_dropped_token_a_lost_bonus_and_a_late_decay(dtype):
    arrays = _inputs(21, 2, 53, 3, 16, None, True)
    want, scales = wkv6_bwd_plain(*_torch(arrays), dtype=torch.float64, with_scales=True)
    good, mutants = _mutants(_torch(arrays, torch.float32))

    def typed(outs):  # dr, dk, dv and du in the kernel's output type
        return [o.to(dtype) if i in (0, 1, 2, 4) else o for i, o in enumerate(outs)]

    assert bwd_agreement(typed(good), want, scales)["ok"]
    for name, outs in mutants:
        agree = bwd_agreement(typed(outs), want, scales)
        assert not agree["ok"], (name, {n: (p["worst"], p["rel"]) for n, p in agree["parts"].items()})


def _cancelling_inputs(seed, S):
    """Inputs whose gradients cancel, as a real layer's do: v offset by
    V_OFFSET, so that each row of the state is nearly constant across its
    columns, and dy, per token and head, free of its mean and orthogonal to
    the group-normed y, as the group norm's gradient is; so dr, dk and
    dlog_w sum terms ~1e3 times their values.  Random decay, no state."""
    r, k, v, lw, u, _, dy, _ = _inputs(seed, 2, S, 3, 16, None, False)
    v = v + V_OFFSET
    y, _ = wkv6_scan(*_torch((r, k, v, lw, u)), dtype=torch.float64)
    y_hat = y - y.mean(-1, keepdim=True)
    y_hat = y_hat / y_hat.norm(dim=-1, keepdim=True)
    g = torch.from_numpy(dy)
    g = g - g.mean(-1, keepdim=True)
    g = g - (g * y_hat).sum(-1, keepdim=True) * y_hat
    return r, k, v, lw, u, None, g.numpy(), None


V_OFFSET = 100.0


@pytest.mark.parametrize("S", [53, 208])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bwd_tol_rejects_the_mutations_where_the_gradients_cancel(dtype, S):
    """Where the terms' magnitudes widen the limits (scale_frac), the three
    faults still fail; the f32 walk passes only with the magnitudes."""
    arrays = _cancelling_inputs(S + 1, S)
    want, scales = wkv6_bwd_plain(*_torch(arrays), dtype=torch.float64, with_scales=True)
    assert float((want[3].abs() / scales[3]).nanmedian()) < 3e-3  # dlog_w cancels (0 / 0 at the ends)
    good, mutants = _mutants(_torch(arrays, torch.float32))

    def typed(outs):
        return [o.to(dtype) if i in (0, 1, 2, 4) else o for i, o in enumerate(outs)]

    assert bwd_agreement(typed(good), want, scales)["ok"]
    assert not bwd_agreement(good, want)["ok"]
    for name, outs in mutants:
        agree = bwd_agreement(typed(outs), want, scales)
        failed = {n for n, p in agree["parts"].items() if p["worst"] > 1}
        assert failed, (name, {n: (p["worst"], p["rel"]) for n, p in agree["parts"].items()})


def test_scales_bound_each_gradient_and_are_exact_in_magnitude():
    """The terms' magnitudes are at least each gradient's magnitude (a sum's
    magnitude is at most the sum of its terms'), and equal to it where
    every term is positive."""
    t = _torch(_inputs(11, 1, 37, 2, 16, None, True))
    grads, scales = wkv6_bwd_plain(*t, dtype=torch.float64, with_scales=True)
    for name, g, sc in zip(BWD_NAMES, grads, scales):
        assert g.shape == sc.shape and bool((sc >= g.abs() * (1 - 1e-12)).all()), name
    pos = [a.abs() if a is not None else None for a in t]  # (w = e^{|log_w|} > 1 then: a growth, as good)
    grads, scales = wkv6_bwd_plain(*pos[:4], pos[4], pos[5], pos[6], pos[7], dtype=torch.float64, with_scales=True)
    for name, g, sc in zip(BWD_NAMES, grads, scales):
        torch.testing.assert_close(g, sc, rtol=1e-12, atol=0, msg=name)


def test_bwd_tol_reads_each_output_by_its_type():
    assert set(BWD_TOL) == {torch.float32, torch.bfloat16}
    x = torch.linspace(-1, 1, 64, dtype=torch.float64).reshape(4, 16)
    # one bf16 rounding passes the bf16 limits, not the f32 ones
    assert agreement(x.to(torch.bfloat16), x, BWD_TOL[torch.bfloat16])["ok"]
    assert not agreement(x.to(torch.bfloat16).float(), x, BWD_TOL[torch.float32])["ok"]


def test_bwd_workspace_at_the_training_shape():
    """The backward kernel's f32 workspace (kernel.bwd_work_floats, which
    csrc/wkv6_bwd.cu refuses to run short of): 41 MiB at rwkv6-3b's
    training microbatch, the 16 segments' states and gradients (20 MiB
    each) and their decays and du's partials; one segment at 17 tokens,
    two of 16."""
    from repro_torch.kernels.wkv6 import kernel

    assert kernel.bwd_segments(2048) == 2048 // kernel.BWD_SEGMENT == 16
    states = 2 * 40 * 16 * 64 * 64
    assert kernel.bwd_work_floats(2, 2048, 40, 64) == 2 * states + 2 * 2 * 40 * 16 * 64
    assert round(kernel.bwd_work_floats(2, 2048, 40, 64) * 4 / 2 ** 20) == 41
    assert kernel.bwd_work_floats(1, 17, 3, 16) == 2 * 3 * 16 * 16 + 2 * 3 * 16
    assert kernel.bwd_work_floats(1, 17, 3, 16, seg_len=16) == 2 * (2 * 3 * 16 * 16 + 2 * 3 * 16)


# ---------------------------------------------------------------------------
# the backward kernel's arithmetic on the CPU (ref.wkv6_bwd_chunked_split_plain)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seg_len", [16, 32, 64, 128, None], ids=["seg16", "seg32", "seg64", "seg128", "segS"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("S", [1, 16, 53, 208])
@pytest.mark.parametrize("K", [16, 64])
def test_chunked_twin_matches_the_plain_walk_in_f64(K, S, decay, with_state, seg_len):
    """The kernel's arithmetic in f32 (chunks, split TF32, dlog_w from its
    direct terms, segments of seg_len tokens or one of S) within BWD_TOL's
    f32 limits, with the terms' magnitudes, of the plain walk in f64."""
    arrays = _inputs(S * 3 + K, 1, S, 2, K, DECAYS[decay], with_state)
    want, scales = wkv6_bwd_plain(*_torch(arrays), dtype=torch.float64, with_scales=True)
    got = wkv6_bwd_chunked_split_plain(*_torch(arrays, torch.float32), seg_len=seg_len)
    assert [g.dtype for g in got] == [torch.float32] * 6 and [g.shape for g in got] == [w.shape for w in want]
    agree = bwd_agreement(got, want, scales)
    assert agree["ok"], {n: (p["worst"], p["rel"]) for n, p in agree["parts"].items()}


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("decay", list(DECAYS))
def test_chunked_twin_matches_jax_grad_of_the_reference(decay, with_state):
    """The kernel's arithmetic against jax.grad of the reference's chunked
    form (f32) within BWD_TOL's f32 limits with the terms' magnitudes, every
    output, over segments of 32 tokens; dlog_w under the reference's own
    stated exception (its reverse-cumsum cancellation at strong decay):
    rtol of |jax.grad| plus REF_DLOGW_ATOL times the rms of dr."""
    arrays = _inputs(53 + len(decay), 2, 53, 3, 16, DECAYS[decay], with_state)
    ref_grad = _jax_grad(_wkv_chunked, *arrays)
    _, scales = wkv6_bwd_plain(*_torch(arrays), dtype=torch.float64, with_scales=True)
    got = wkv6_bwd_chunked_split_plain(*_torch(arrays, torch.float32), seg_len=32)
    agree = bwd_agreement(got, [g.double() for g in ref_grad], scales)
    bad = {n: (p["worst"], p["rel"]) for n, p in agree["parts"].items() if not p["ok"]}
    assert set(bad) <= {"dlog_w"}, bad
    want = ref_grad[3].double()
    scale = float(ref_grad[0].double().square().mean().sqrt())
    limit = BWD_TOL[torch.float32]["rtol"] * want.abs() + REF_DLOGW_ATOL * scale
    assert bool(((got[3].double() - want).abs() <= limit).all())
    if decay in ("random", "-3.4e-4"):
        assert not bad, bad


@pytest.mark.parametrize("fault", ["a", "b", "c", "d", "chunk carry"])
def test_bwd_tol_rejects_the_chunked_twin_without_a_dlogw_term_or_a_carry(fault, monkeypatch):
    """The twin with one of dlog_w's four direct terms dropped, or with the
    gradient not carried from one chunk to the one before, fails BWD_TOL
    against the plain walk in f64; the twin as it is passes."""
    arrays = _inputs(29, 2, 53, 3, 16, None, True)
    want, scales = wkv6_bwd_plain(*_torch(arrays), dtype=torch.float64, with_scales=True)
    t32 = _torch(arrays, torch.float32)
    assert bwd_agreement(wkv6_bwd_chunked_split_plain(*t32), want, scales)["ok"]
    if fault == "chunk carry":
        monkeypatch.setattr(ref, "_carry_back", lambda dS, tot, g: g)
    else:
        keep, drop = ref._dlogw_terms, "abcd".index(fault)

        def without(*terms):
            return keep(*(torch.zeros_like(x) if i == drop else x for i, x in enumerate(terms)))

        monkeypatch.setattr(ref, "_dlogw_terms", without)
    agree = bwd_agreement(wkv6_bwd_chunked_split_plain(*t32), want, scales)
    assert not agree["ok"], (fault, {n: (p["worst"], p["rel"]) for n, p in agree["parts"].items()})
