# The gradient of the port's Mamba2 layer (models/mamba2.py) on the CPU
# against jax.grad / jax.value_and_grad of the JAX package's functions, on
# inputs drawn with numpy from a seed (ROADMAP C45: the serving form of the
# SSD scaled its decay matrix in place, so no gradient could pass it):
#
# * the chunked SSD in f32, the port's batched form (``ssd_batched``, with
#   B and C per head and per group) and its one-step-a-chunk form, against
#   the reference's ``_ssd_chunked``: every input's gradient (xdt,
#   log_decay, B, C, the initial state) under a random cotangent of y and
#   of the final state, each element within SSD_GRAD_TOL (f32 sums in
#   another order: 2.7e-6 of |want| + the leaf's rms read at most);
# * the depthwise causal conv on bf16, with and without a carried state:
#   x's, w's, b's (and the state's) gradient within test_torch_train's
#   GRAD_REL / GRAD_TOL (bf16 backward ops that round elsewhere);
# * one ``mamba2_block`` on bf16, its constants drawn as chip_smoke.py
#   draws them: every parameter's gradient and x's within GRAD_REL /
#   GRAD_TOL, with no f32 witness (0.5-1.1% in Frobenius norm read);
# * reduced zamba2-7b through train/step.value_and_grad with remat and
#   without, bit for bit the same (test_torch_train holds the remat step
#   against jax.value_and_grad at microbatches 1 and 2);
# * the serving form under torch.no_grad: the one in-place buffer, and the
#   same output bit for bit as the out-of-place form autograd takes;
# * the launcher trains zamba2-7b on the CPU.
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import mamba2 as jm2
from repro_torch.configs import base
from repro_torch.models import mamba2
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.train.step import TrainSpec, value_and_grad
from test_torch_mamba2 import _bf16, _block_params, _ssd_inputs
from test_torch_threads import cap_torch_threads, subprocess_env
from test_torch_train import GRAD_REL, GRAD_TOL, _batch, _reference

cap_torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "zamba2-7b"
# per element: |got - want| <= rtol * |want| + atol * rms(want's leaf)
SSD_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got: torch.Tensor, want, rtol: float, atol: float) -> bool:
    g, w = got.detach().double().numpy(), np.asarray(want, np.float64)
    return bool(np.all(np.abs(g - w) <= rtol * np.abs(w) + atol * np.sqrt(np.mean(w ** 2))))


def _bf16_agrees(got: torch.Tensor, want) -> bool:
    """test_torch_train's check of a bf16 gradient leaf: GRAD_REL in
    Frobenius norm and GRAD_TOL * (|want| + rms) per element."""
    g, w = got.detach().double().numpy(), np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    return bool(rel <= GRAD_REL and np.all(np.abs(g - w) <= GRAD_TOL * (np.abs(w) + np.sqrt(np.mean(w ** 2)))))


@pytest.mark.parametrize("groups", ["per_head", "one_group"])
@pytest.mark.parametrize("S,chunk", [(5, 64), (64, 16), (100, 16), (129, 4)])
def test_ssd_gradient_matches_jax_grad(S, chunk, groups):
    H, P, N = 4, 8, 16
    xdt, log_decay, Bh, Ch, S0 = _ssd_inputs(S * 3 + chunk, 2, S, H, P, N, True)
    if groups == "one_group":  # one B and C for every head, as zamba2's n_groups = 1
        Bh, Ch = Bh[:, :, :1], Ch[:, :, :1]
    rng = np.random.default_rng(S + chunk)
    gy = rng.standard_normal((2, S, H, P)).astype(np.float32)
    gs = rng.standard_normal((2, H, P, N)).astype(np.float32)

    def ref_loss(xdt, log_decay, Bg, Cg, S0):
        rep = H // Bg.shape[2]
        y, s = jm2._ssd_chunked(xdt, log_decay, jnp.repeat(Bg, rep, 2), jnp.repeat(Cg, rep, 2), S0, chunk)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    args = (xdt, log_decay, Bh, Ch, S0)
    want = jax.jit(jax.grad(ref_loss, argnums=tuple(range(5))))(*args)
    forms = [mamba2.ssd_batched] + ([mamba2._ssd_chunked] if groups == "per_head" else [])
    for form in forms:
        t = [torch.from_numpy(a).requires_grad_(True) for a in args]
        y, s = form(*t, chunk)
        ((y * torch.from_numpy(gy)).sum() + (s * torch.from_numpy(gs)).sum()).backward()
        for name, a, w in zip(("xdt", "log_decay", "B", "C", "S0"), t, want):
            assert a.grad is not None and a.grad.shape == a.shape, (form.__name__, name)
            assert _close(a.grad, w, **SSD_GRAD_TOL), (form.__name__, name)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", [1, 5, 37])
def test_causal_conv1d_gradient_matches_jax_grad(S, carried):
    rng = np.random.default_rng(50 + S + 10 * carried)
    C, W = 48, 4
    x = _bf16(rng.standard_normal((2, S, C)))
    w = _bf16(0.5 * rng.standard_normal((W, C)))
    b = _bf16(0.1 * rng.standard_normal(C))
    state = _bf16(rng.standard_normal((2, W - 1, C))) if carried else None
    gy = rng.standard_normal((2, S, C)).astype(np.float32)
    gst = rng.standard_normal((2, W - 1, C)).astype(np.float32)

    def ref_loss(x, w, b, state):
        out, st = jm2._causal_conv1d(x, w, b, state)
        loss = jnp.sum(out.astype(jnp.float32) * gy)
        return loss if st is None else loss + jnp.sum(st.astype(jnp.float32) * gst)

    n = 4 if carried else 3
    want = jax.jit(jax.grad(ref_loss, argnums=tuple(range(n))))(x, w, b, state)
    t = [tensor_from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    ts = tensor_from_numpy(state).requires_grad_(True) if carried else None
    out, st = mamba2._causal_conv1d(*t, ts)
    loss = (out.float() * torch.from_numpy(gy)).sum()
    if carried:
        loss = loss + (st.float() * torch.from_numpy(gst)).sum()
    loss.backward()
    for name, a, wnt in zip(("x", "w", "b", "state"), t + ([ts] if carried else []), want):
        assert a.grad.dtype == torch.bfloat16, name
        assert _bf16_agrees(a.grad, wnt), name


@pytest.mark.parametrize("S", [37, 100])
def test_mamba2_block_gradient_matches_jax_grad(S):
    """Every parameter's and the input's gradient of one block (a chunk of
    64 and a tail), its constants drawn as phase 21 draws them."""
    cfg, ref, port = _block_params(S)
    tcfg = base.reduced_config(base.get_config(ARCH))
    rng = np.random.default_rng(200 + S)
    x = _bf16(rng.standard_normal((2, S, cfg.d_model)))
    gy = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)

    def ref_loss(p, x):
        return jnp.sum(jm2.mamba2_block(p, x, cfg)[0].astype(jnp.float32) * gy)

    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(ref, x)
    tp = {k: v.clone().requires_grad_(True) for k, v in port.items()}
    tx = tensor_from_numpy(x).requires_grad_(True)
    out, _ = mamba2.mamba2_block(tp, tx, tcfg)
    (out.float() * torch.from_numpy(gy)).sum().backward()
    assert set(want_p) == set(tp)
    for k, w in want_p.items():
        assert float(tp[k].grad.abs().max()) > 0, k
        assert _bf16_agrees(tp[k].grad, w), k
    assert _bf16_agrees(tx.grad, want_x)
    # the check fails a gradient 10% off
    assert not _bf16_agrees(tp["w_in"].grad * 1.1, want_p["w_in"])


def test_zamba2_step_with_remat_equals_without():
    """Reduced zamba2-7b (mamba2 layers and both shared blocks) through the
    train step's value_and_grad, with each repeat recomputed in the backward
    and without: the same loss and gradient, bit for bit."""
    cfg, _, _, model = _reference(ARCH)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, 2, 20, 5).items()}
    l1, _, g1 = value_and_grad(model, model.params, batch, TrainSpec(microbatches=2, remat=True))
    l0, _, g0 = value_and_grad(model, model.params, batch, TrainSpec(microbatches=2, remat=False))
    assert torch.equal(l1, l0)
    assert any(".mamba." in p for p in g0) and any(p.startswith("shared.") for p in g0)
    for path in g0:
        assert torch.equal(g1[path], g0[path]), path
        assert bool(torch.isfinite(g0[path]).all()), path


def test_ssd_batched_serves_in_place_under_no_grad(monkeypatch):
    """Under torch.no_grad the SSD builds its decay matrix in one buffer and
    scales it in place, as before the gradient's repair; with a gradient it
    takes the out-of-place form.  Both give the same output bit for bit."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(7, 2, 100, 4, 8, 16, True)]
    seen = []
    real = mamba2._decay_matrix

    def spy(rows, cols, mask, inplace=True):
        seen.append(inplace)
        return real(rows, cols, mask, inplace)

    monkeypatch.setattr(mamba2, "_decay_matrix", spy)
    with torch.no_grad():
        y0, s0 = mamba2.ssd_batched(*args, 16)
    assert seen == [True, True]  # the intra-chunk matrix, then _pass_states'
    seen.clear()
    grad_args = [a.clone().requires_grad_(True) for a in args]
    y1, s1 = mamba2.ssd_batched(*grad_args, 16)
    assert seen == [False, True] and y1.requires_grad
    assert torch.equal(y0, y1.detach()) and torch.equal(s0, s1.detach())


def test_launch_train_trains_zamba2_on_the_cpu(tmp_path):
    env = subprocess_env(PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--device", "cpu", "--steps", "2",
         "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    import json

    summary = json.loads(out.stdout.split("[train] summary ")[-1])
    assert summary["final_step"] == 2 and summary["restores_bitwise"]
    assert len(summary["losses"]) == 2 and np.all(np.isfinite(summary["losses"]))
