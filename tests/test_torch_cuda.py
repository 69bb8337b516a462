# The port on a CUDA card: the hand-written segreduce kernel against its
# plain PyTorch version in each of its three regimes, run twice to show that
# its results are bitwise deterministic, and a default Session whose
# aggregates go through the kernel.  This file imports neither jax nor the
# JAX package, so it runs on a machine that has only the port:
#
#     PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
#
# Without a card every test skips.  Integers, min/max and presence must
# match exactly; f32 sums within rtol 1e-5 of the plain version, which sums
# in another order.
import numpy as np
import pytest
import torch

from repro_torch import Session
from repro_torch.kernels.segreduce import ops
from repro_torch.kernels.segreduce.ref import fused_segreduce_ref, segreduce_ref

_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the segreduce kernel runs only on one")
    return torch.device("cuda")


def _columns(rng, n, num_keys, device):
    keys = torch.from_numpy(rng.integers(0, num_keys, n).astype(np.int32)).to(device)
    mask = torch.from_numpy(rng.integers(0, 4, n) > 0).to(device)
    vi = torch.from_numpy(rng.integers(-100, 100, n).astype(np.int32)).to(device)
    vf = torch.from_numpy(rng.random(n).astype(np.float32)).to(device)
    return keys, mask, vi, vf


def _same(got, want):
    if got.dtype.is_floating_point:
        torch.testing.assert_close(got, want, **_TOL)
    else:
        assert torch.equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("float_sum", [True, False], ids=["ordered", "atomic"])
@pytest.mark.parametrize("num_keys", [1, 100, 100_001])
def test_kernel_matches_plain_and_is_deterministic(cuda, num_keys, float_sum):
    keys, mask, vi, vf = _columns(np.random.default_rng(13), 200_000, num_keys, cuda)
    if float_sum:  # regime 0 (small K) or 1 (large K)
        cols, ops_ = (vi, vf, vi, vf), ("sum", "sum", "max", "min")
    else:  # regime 2
        cols, ops_ = (vi, vi, vf, vf), ("sum", "max", "max", "min")
    a1, p1 = ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask)
    a2, p2 = ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask)
    want, want_pres = fused_segreduce_ref(keys, cols, ops_, num_keys, mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(p1, want_pres) and torch.equal(p1, p2)
    for x, y, w in zip(a1, a2, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))  # bitwise
        _same(x, w)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_single_op_and_bf16(cuda, op):
    keys, _, _, vf = _columns(np.random.default_rng(17), 50_000, 3000, cuda)
    _same(ops.segreduce(keys, vf, 3000, op), segreduce_ref(keys, vf, 3000, op))
    vb = vf.to(torch.bfloat16)
    got, want = ops.segreduce(keys, vb, 3000, op), segreduce_ref(keys, vb, 3000, op)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.requires_cuda
def test_empty_input_gives_identities(cuda):
    keys = torch.empty(0, dtype=torch.int32, device=cuda)
    vals = torch.empty(0, dtype=torch.float32, device=cuda)
    (mx,), pres = ops.fused_segreduce(keys, (vals,), ("max",), 7)
    assert torch.equal(mx, torch.full((7,), float("-inf"), device=cuda))
    assert torch.equal(pres, torch.zeros(7, dtype=torch.int32, device=cuda))


@pytest.mark.requires_cuda
def test_default_session_runs_the_kernel_on_the_card(cuda):
    rng = np.random.default_rng(8)
    n = 200_000
    cols = dict(
        k=rng.integers(0, 500, n).astype(np.int32),
        v=rng.integers(-100, 100, n).astype(np.int32),
        w=rng.random(n).astype(np.float32),
    )
    card, host = Session(), Session(device="cpu")
    for s in (card, host):
        s.register("t", **cols)
    q = "SELECT k, SUM(v), MIN(v), MAX(w), COUNT(k), AVG(w) FROM t WHERE v > 10 GROUP BY k"
    ops.reset_launches()
    got = card.sql(q)
    assert got.decision.chosen.agg_method == "kernel"
    assert ops.LAUNCHES["fused_segreduce"] >= 1
    want = host.sql(q)
    assert len(got.rows) == len(want.rows)
    for ra, rb in zip(sorted(got.rows), sorted(want.rows)):
        for x, y in zip(ra, rb):
            assert abs(float(x) - float(y)) <= 1e-3 + 1e-5 * abs(float(y)), (ra, rb)
