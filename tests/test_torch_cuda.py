# The port on a CUDA card: the hand-written segreduce kernel against its
# plain PyTorch version in each of its three regimes, run twice to show that
# its results are bitwise deterministic, and a default Session whose
# aggregates go through the kernel; the hand-written flash-attention kernel
# against its plain version (within ``ref.KERNEL_TOL``, reruns bitwise
# equal), and a model on the card whose prefill runs through it; the
# hand-written WKV6 kernel against its plain version (within
# ``ref.KERNEL_TOL``, reruns bitwise equal) over decay regimes from weak to
# the clip's strongest, and a reduced rwkv6 on the card whose prefill runs
# through it; the hand-written flash backward kernel against its plain
# version given the same forward output (within ``ref.BWD_TOL``, reruns
# bitwise equal, also where the dk and dv partials of 12 query heads are
# summed) and against the exact gradient (``ref.BWD_EXACT_REL``), the
# forward kernel's row statistics (its lse) against the plain lse, and
# serving calls without a gradient launching the forward without them,
# the decode step replayed as a CUDA graph against the eager step (tokens
# and logits bitwise equal), the serving CLI refilling slots under the
# graph, and a reduced starcoder2-3b train step whose attention gradients
# run the backward kernel; the hand-written WKV6 backward against its plain
# version in float64 (within ``ref.BWD_TOL``, reruns bitwise equal) and a
# reduced rwkv6 train step whose time-mix gradients run it, with the raise
# where it is not built; and the plain MAX/MIN paths' -0.0 / +0.0 order on
# the card, the same over 20 runs; the MoE block's sort-based routing on
# the card equal to the CPU's (ties and capacity drops included), and a
# reduced dbrx-132b and llama4-scout whose decode step, routing and all, is
# captured in a CUDA graph and gives the eager step's tokens and logits bit
# for bit, and whose train step's gradients repeat bit for bit (the
# dispatch's gradient a gather, not atomics); the flash kernel at zamba2's
# head dim 112 (zero-padded to 128),
# and a reduced zamba2 (Mamba2 layers, shared attention blocks) whose
# prefill runs the kernel once a shared invocation and matches the CPU,
# whose graph decode equals its eager decode, and which the serving CLI
# serves; a reduced zamba2 train step through the flash backward at head
# dim 112, each call against the plain backward in float64; and the
# one-card DeviceMesh (NCCL, world size 1), a prefill cell's specs leaving
# reduced dbrx's and zamba2's outputs bit for bit.  This file imports
# neither jax nor the JAX package, so it runs
# on a machine that has only the port:
#
#     PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
#
# Without a card every test skips.  Integers, min/max and presence must
# match exactly; f32 sums within rtol 1e-5 of the plain version, which sums
# in another order.
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import Session
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.kernels.flash import kernel as flash_kernel
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash.ref import (
    agreement,
    attention_ref,
    bwd_agreement,
    bwd_exact_agreement,
    flash_attention_bwd_plain,
    flash_attention_lse_plain,
    flash_attention_plain,
)
from repro_torch.kernels.segreduce import kernel as seg_kernel
from repro_torch.kernels.segreduce import ops
from repro_torch.kernels.segreduce.ref import fused_segreduce_ref, segreduce_ref
from repro_torch.kernels.wkv6 import kernel as wkv6_kernel
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6.ref import agreement as wkv6_agreement
from repro_torch.kernels.wkv6.ref import bwd_agreement as wkv6_bwd_agreement
from repro_torch.kernels.wkv6.ref import wkv6_bwd_plain, wkv6_plain, wkv6_scan
from repro_torch.models import mamba2
from repro_torch.models.transformer import Model
from repro_torch.serve.step import generate
from test_torch_threads import cap_torch_threads

cap_torch_threads()

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
    # the f32 sum's yardstick is the plain version in float64: its own f32
    # atomic sum of K = 1's 150,000 rows drifts by up to ~1.2e-5 between
    # runs, more than the tolerance (chip_smoke.py phase 3 does the same)
    plain = tuple(c.double() if op == "sum" and c.dtype.is_floating_point else c for c, op in zip(cols, ops_))
    want, want_pres = fused_segreduce_ref(keys, plain, ops_, num_keys, mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(p1, want_pres) and torch.equal(p1, p2)
    for x, y, w in zip(a1, a2, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))  # bitwise
        _same(x.double() if w.dtype == torch.float64 else x, w)


def _exact(got, want):
    """Equal values, NaN where the other has NaN (-0.0 equals +0.0)."""
    assert got.dtype == want.dtype
    if got.dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    else:
        assert torch.equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("group", ["one", "two", "seven"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("num_keys", [1, 100, 1_500_000, 2_000_001, 5_000_011])
def test_no_float_sum_regimes_match_plain_exactly(cuda, num_keys, order, masked, group):
    """Regime 2 (K = 1, 100 in shared tables; 5M, more keys than rows,
    straight into the outputs) and 3 (K = 1.5M, 2M): int32 sums that wrap,
    int32 and float min/max over values with -0.0, +-inf and NaN, bf16
    min/max, presence, masked rows, keys in random or sorted order; every
    result equal to the plain version's, and reruns bitwise equal."""
    rng = np.random.default_rng(num_keys + len(group) + masked)
    n = 3_000_000
    keys_np = rng.integers(0, num_keys, n).astype(np.int32)
    if order == "sorted":
        keys_np.sort()
    keys = torch.from_numpy(keys_np).to(cuda)
    mask = torch.from_numpy(rng.integers(0, 4, n) > 0).to(cuda) if masked else None
    vi = torch.from_numpy(rng.integers(2**29, 2**31 - 1, n).astype(np.int32)).to(cuda)  # sums wrap
    vf_np = rng.normal(size=n).astype(np.float32)
    special = rng.integers(0, n, 4000)
    vf_np[special] = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan], np.float32)[special % 5]
    vf = torch.from_numpy(vf_np).to(cuda)
    vb = vf.to(torch.bfloat16)
    cols, ops_ = {
        "one": ((vi,), ("sum",)),
        "two": ((vf, vi), ("min", "sum")),
        "seven": ((vi, vi, vi, vf, vf, vb, vb), ("sum", "max", "min", "max", "min", "max", "min")),
    }[group]
    a1, p1 = ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask)
    a2, p2 = ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask)
    want, want_pres = fused_segreduce_ref(keys, cols, ops_, num_keys, mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(p1, want_pres) and torch.equal(p1, p2)
    for x, y, w in zip(a1, a2, want):
        assert _bitwise(x, y)
        _exact(x, w)
    accs, pres = ops.fused_segreduce(keys, (), (), num_keys, mask=mask)  # presence alone
    assert accs == () and torch.equal(pres, want_pres)
    if not masked:
        single = ops.segreduce(keys, cols[0], num_keys, ops_[0])
        _exact(single, segreduce_ref(keys, cols[0], num_keys, ops_[0]))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("num_keys", [100, 2_000_001])
def test_no_float_sum_regimes_on_no_rows_give_identities(cuda, num_keys):
    """N = 0 in regimes 2 and 3: every output its op's identity."""
    keys = torch.empty(0, dtype=torch.int32, device=cuda)
    vi = torch.empty(0, dtype=torch.int32, device=cuda)
    vb = torch.empty(0, dtype=torch.bfloat16, device=cuda)
    cols, ops_ = (vi, vi, vb, vb), ("sum", "max", "max", "min")
    got, pres = ops.fused_segreduce(keys, cols, ops_, num_keys)
    want, want_pres = fused_segreduce_ref(keys, cols, ops_, num_keys)
    assert torch.equal(pres, want_pres)
    for x, w in zip(got, want):
        _exact(x, w)


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


def _bitwise(a, b):
    return torch.equal(a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                       b.view(torch.int16 if b.element_size() == 2 else torch.int32))


# Regime 1 (a float sum over a large key space).  Each launch carries a
# float sum of values in [-1, 1), an int32 sum that wraps, float max and min
# over values with -0.0, +0.0 and NaN, and presence: the sum within 1e-5
# (f32) or 1e-2 (bf16 and f16, rounded once from the f32 sum) of the sum of
# |value| over the key's rows, plus as much absolutely, from the plain
# version in float64 (the rounding of any order of an f32 sum grows with
# that sum of magnitudes, not with the sum, which cancels); everything else
# exactly, so that a row lost or counted twice shows; and both paths, the
# one the layout rule takes and the other one (one launch or the
# partition), reruns bitwise equal.
_ORD_TABLES = 5  # the four columns of _ordered_columns and presence
_PAST_REGIME0 = 232_448 // (4 * 8 * _ORD_TABLES) + 1  # the first K past regime 0 on an H100
_ORD_TILE = seg_kernel.TILE_ROWS
# row counts: fixed, or (the one-launch limit at the case's key space, an offset)
_ORD_LENGTHS = (0, 1, 1023, 1024, ("limit", -1), ("limit", 0), ("limit", 1), _ORD_TILE - 1, _ORD_TILE + 1,
                5 * _ORD_TILE - 1, 5 * _ORD_TILE + 1, 200_003, 2_000_003)


def _ordered_columns(rng, n, dtype, cuda):
    vf = rng.uniform(-1, 1, n).astype(np.float32)
    special = rng.integers(0, max(n, 1), min(n, 64))
    vf_mm = vf.copy()
    vf_mm[special] = np.array([-0.0, 0.0, np.nan, -0.0], np.float32)[special % 4]
    vi = rng.integers(2**29, 2**31 - 1, n).astype(np.int32)  # sums wrap
    cols = (torch.from_numpy(vf).to(cuda).to(dtype), torch.from_numpy(vi).to(cuda),
            torch.from_numpy(vf_mm).to(cuda), torch.from_numpy(vf_mm).to(cuda))
    return cols, ("sum", "sum", "max", "min")


def _layout(keys, values, ops_, num_keys, with_presence=True):
    index = keys.device.index or 0
    nt = len(values) + int(with_presence)
    return seg_kernel.table_layout(int(keys.shape[0]), num_keys, nt,
                                   seg_kernel.library().segreduce_smem_limit(index),
                                   torch.cuda.get_device_properties(index).multi_processor_count)


def _check_ordered(got, want_f64, cols, ops_):
    """The float sum against the plain version in float64, within its
    tolerance of the key's sum of magnitudes; the rest exactly, and float
    max/min bit for bit (``_minmax_bits``)."""
    accs, pres = got
    want, want_pres, magnitude, minmax = want_f64
    assert torch.equal(pres, want_pres)
    for x, w, m, b, v, op in zip(accs, want, magnitude, minmax, cols, ops_):
        assert x.dtype == v.dtype
        if op == "sum" and v.dtype.is_floating_point:
            tol = 1e-5 if v.dtype == torch.float32 else 1e-2
            err = (x.double() - w).abs()
            assert bool((err <= tol * (m + 1)).all()), float((err / (m + 1)).max())
        else:
            _exact(x, w.to(x.dtype))
        if b is not None:
            nan = torch.isnan(b)
            assert torch.equal(torch.isnan(x), nan)
            assert _bitwise(x[~nan], b[~nan])  # -0.0 and +0.0 apart


def _minmax_bits(keys, v, op, num_keys, mask):
    """Float max or min over each key's counted rows as IEEE 754-2019's
    maximum and minimum fold them, whatever the rows' order: a NaN wins (as
    in torch.maximum) and -0.0 is below +0.0 (by an order-preserving map of
    the f32 bits to int32, as the source's flip32); -inf/+inf for an empty
    key; in v's dtype."""
    keep = (keys >= 0) & (keys < num_keys)
    if mask is not None:
        keep &= mask
    k, x = keys[keep].long(), v[keep].float()
    w = x.view(torch.int32)
    flip = torch.where(w >= 0, w, w ^ 0x7FFFFFFF)
    empty = torch.tensor([-np.inf if op == "max" else np.inf], dtype=torch.float32, device=v.device).view(torch.int32)
    start = torch.where(empty >= 0, empty, empty ^ 0x7FFFFFFF).expand(num_keys).clone()
    out = start.scatter_reduce_(0, k, flip, "amax" if op == "max" else "amin", include_self=True)
    out = torch.where(out >= 0, out, out ^ 0x7FFFFFFF).view(torch.float32)
    has_nan = torch.zeros(num_keys, dtype=torch.bool, device=v.device).index_fill_(0, k[torch.isnan(x)], True)
    return out.masked_fill(has_nan, float("nan")).to(v.dtype)


def _plain_f64(keys, cols, ops_, num_keys, mask):
    """The plain version's outputs, float sums in float64; each float sum's
    sum of magnitudes and each float max/min's bits (``_minmax_bits``), None
    for the other columns."""
    sums = [op == "sum" and v.dtype.is_floating_point for v, op in zip(cols, ops_)]
    plain = tuple(v.double() if s else v for v, s in zip(cols, sums))
    want, want_pres = fused_segreduce_ref(keys, plain, ops_, num_keys, mask=mask)
    mags = fused_segreduce_ref(keys, tuple(v.abs() for v, s in zip(plain, sums) if s),
                               ("sum",) * sum(sums), num_keys, mask=mask, with_presence=False)[0]
    mags = iter(mags)
    minmax = tuple(_minmax_bits(keys, v, op, num_keys, mask) if op != "sum" and v.dtype.is_floating_point
                   else None for v, op in zip(cols, ops_))
    return want, want_pres, tuple(next(mags) if s else None for s in sums), minmax


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("rows", ["all", "masked", "none", "outside"])
@pytest.mark.parametrize("num_keys", [_PAST_REGIME0, 100_001, 2_000_001])
@pytest.mark.parametrize("n", _ORD_LENGTHS, ids=str)
def test_ordered_regime_matches_plain(cuda, n, num_keys, rows, dtype):
    """Regime 1 at row counts on both sides of the one-launch limit and of
    the partition's tiles, every row counted, a quarter masked, none counted
    (all masked), and keys outside [0, K) (negative ones, the int32
    extremes) dropped."""
    if isinstance(n, tuple):
        lay = _layout(torch.zeros(0, dtype=torch.int32, device=cuda), (None,) * 4, None, num_keys)
        n = seg_kernel.small_limit(lay.n_buckets) + n[1]
    rng = np.random.default_rng(n + num_keys)
    keys_np = rng.integers(0, num_keys, n).astype(np.int64)
    mask = None
    if rows == "masked":
        mask = torch.from_numpy(rng.integers(0, 4, n) > 0).to(cuda)
    elif rows == "none":
        mask = torch.zeros(n, dtype=torch.bool, device=cuda)
    elif rows == "outside":
        keys_np = rng.integers(-1000, num_keys + 1000, n)
        keys_np[rng.integers(0, max(n, 1), min(n, 8))] = np.array([2**31 - 1, -(2**31)] * 4)[: min(n, 8)]
    keys = torch.from_numpy(keys_np.astype(np.int32)).to(cuda)
    cols, ops_ = _ordered_columns(rng, n, dtype, cuda)
    lay = _layout(keys, cols, ops_, num_keys)
    assert lay.regime == 1 and lay.small == (n <= seg_kernel.small_limit(lay.n_buckets))
    want = _plain_f64(keys, cols, ops_, num_keys, mask)
    runs = [[ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask) for _ in range(2)]]
    if lay.small or n * lay.n_buckets <= 500_000_000:  # the one-launch path reads N rows a range
        other = dataclasses.replace(lay, small=not lay.small)
        runs.append([seg_kernel.launch(keys, cols, ops_, num_keys, mask, True, layout=other) for _ in range(2)])
    torch.cuda.synchronize()
    for a, b in runs:
        _check_ordered(a, want, cols, ops_)
        assert all(_bitwise(x, y) for x, y in zip((*a[0], a[1]), (*b[0], b[1])))  # reruns bitwise


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("num_keys", [1, 100, _PAST_REGIME0 - 1])
@pytest.mark.parametrize("n", [0, 5000, 300_003])
def test_small_key_float_sum_regime_matches_plain(cuda, n, num_keys, masked, dtype):
    """Regime 0 (a float sum, K up to its limit) under the checks of regime
    1: the float sum against float64, the int32 sum and presence exactly,
    float max/min over -0.0, +0.0 and NaN bit for bit, reruns bitwise."""
    rng = np.random.default_rng(n + num_keys + masked)
    keys = torch.from_numpy(rng.integers(0, num_keys, n).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.integers(0, 4, n) > 0).to(cuda) if masked else None
    cols, ops_ = _ordered_columns(rng, n, dtype, cuda)
    assert _layout(keys, cols, ops_, num_keys).regime == 0
    want = _plain_f64(keys, cols, ops_, num_keys, mask)
    a = ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask)
    b = ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask)
    torch.cuda.synchronize()
    _check_ordered(a, want, cols, ops_)
    assert all(_bitwise(x, y) for x, y in zip((*a[0], a[1]), (*b[0], b[1])))


def _zipf_keys(rng, n, num_keys, s=1.1):
    """Ranks drawn by the inverse CDF of a Zipf law over ``num_keys`` keys,
    given shuffled key ids (chip_smoke.py's Zipf table)."""
    w = 1.0 / np.arange(1, num_keys + 1, dtype=np.float64) ** s
    ranks = np.minimum(np.searchsorted(np.cumsum(w / w.sum()), rng.random(n)), num_keys - 1)
    return rng.permutation(num_keys).astype(np.int32)[ranks]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("order", ["sorted", "one_key", "zipf"])
@pytest.mark.parametrize("n", [200_003, 2_000_003])
def test_ordered_regime_key_orders_and_pieces(cuda, n, order, masked):
    """Sorted keys, every row in one key, and Zipf keys (s = 1.1 over
    100,000 keys): at 2M rows one key range holds more than PIECE_ROWS
    rows, so the fold cuts it into pieces joined by its tree."""
    num_keys = 100_000
    rng = np.random.default_rng(n + len(order))
    keys_np = {"sorted": np.sort(rng.integers(0, num_keys, n)).astype(np.int32),
               "one_key": np.full(n, 77_777, np.int32),
               "zipf": _zipf_keys(rng, n, num_keys)}[order]
    keys = torch.from_numpy(keys_np).to(cuda)
    mask = torch.from_numpy(rng.integers(0, 4, n) > 0).to(cuda) if masked else None
    cols, ops_ = _ordered_columns(rng, n, torch.float32, cuda)
    lay = _layout(keys, cols, ops_, num_keys)
    counted = keys_np if mask is None else keys_np[mask.cpu().numpy()]
    per_range = np.bincount(counted >> lay.bucket_shift, minlength=lay.n_buckets)
    cuts = seg_kernel.piece_cuts(per_range.tolist())
    assert max(hi - lo for _, lo, hi in cuts) <= seg_kernel.PIECE_ROWS
    if n > 1_000_000 and order != "sorted":
        assert per_range.max() > seg_kernel.PIECE_ROWS  # pieces are forced
    want = _plain_f64(keys, cols, ops_, num_keys, mask)
    a = ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask)
    b = ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask)
    torch.cuda.synchronize()
    _check_ordered(a, want, cols, ops_)
    assert all(_bitwise(x, y) for x, y in zip((*a[0], a[1]), (*b[0], b[1])))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_cols", [16, 17])
@pytest.mark.parametrize("n", [5000, 300_000])
def test_ordered_regime_sixteen_and_seventeen_columns(cuda, n, n_cols):
    """MAX_AGGS columns and presence in one launch, and one column more (a
    second launch), masked, over 100,001 keys."""
    num_keys = 100_001
    rng = np.random.default_rng(n + n_cols)
    keys = torch.from_numpy(rng.integers(0, num_keys, n).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.integers(0, 4, n) > 0).to(cuda)
    base, base_ops = _ordered_columns(rng, n, torch.float32, cuda)
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    cols = tuple(base[i % 4] if i % 4 else base[0].to(dtypes[(i // 4) % 3]) for i in range(n_cols))
    ops_ = tuple(base_ops[i % 4] for i in range(n_cols))
    want = _plain_f64(keys, cols, ops_, num_keys, mask)
    a = ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask)
    b = ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask)
    torch.cuda.synchronize()
    _check_ordered(a, want, cols, ops_)
    assert all(_bitwise(x, y) for x, y in zip((*a[0], a[1]), (*b[0], b[1])))


def _ordered_inputs(seed, n, num_keys, cuda):
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(_zipf_keys(rng, n, num_keys)).to(cuda)
    mask = torch.from_numpy(rng.integers(0, 4, n) > 0).to(cuda)
    cols, ops_ = _ordered_columns(rng, n, torch.float32, cuda)
    return keys, cols, ops_, mask


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [3000, 2_000_003])
def test_ordered_regime_two_streams_at_once(cuda, n):
    """Two launches on two streams at once give each the bits it gives
    alone: their fold tickets, prefix-tree counters and piece counters are
    their own scratch."""
    num_keys = 100_001
    inputs = [_ordered_inputs(40 + i, n, num_keys, cuda) for i in range(2)]
    serial = [ops.fused_segreduce(k, c, o, num_keys, mask=m) for k, c, o, m in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in inputs]
    for _ in range(3):
        got = [None, None]
        for i, ((k, c, o, m), st) in enumerate(zip(inputs, streams)):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                got[i] = ops.fused_segreduce(k, c, o, num_keys, mask=m)
        torch.cuda.synchronize()
        for g, w in zip(got, serial):
            assert all(_bitwise(x, y) for x, y in zip((*g[0], g[1]), (*w[0], w[1])))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [3000, 2_000_003])
def test_ordered_regime_graph_replay_matches_eager(cuda, n):
    """A captured call replayed over new inputs copied into its buffers
    gives the eager call's bits on those inputs, replay after replay."""
    num_keys = 100_001
    first = _ordered_inputs(50, n, num_keys, cuda)
    keys, cols, ops_, mask = (first[0].clone(), tuple(c.clone() for c in first[1]), first[2], first[3].clone())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask)  # builds and warms outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = ops.fused_segreduce(keys, cols, ops_, num_keys, mask=mask)
    for seed in (50, 51, 52, 51):
        k, c, _, m = _ordered_inputs(seed, n, num_keys, cuda)
        keys.copy_(k)
        mask.copy_(m)
        for dst, src in zip(cols, c):
            dst.copy_(src)
        graph.replay()
        eager = ops.fused_segreduce(k, c, ops_, num_keys, mask=m)
        torch.cuda.synchronize()
        assert all(_bitwise(x, y) for x, y in zip((*out[0], out[1]), (*eager[0], eager[1])))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 112, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 12])
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (False, 0, 0.0), (True, 32, 50.0), (False, 32, 0.0),
])
@pytest.mark.parametrize("Sq,Sk", [(1, 300), (130, 257), (200, 200)])
def test_flash_kernel_matches_plain(cuda, dtype, D, G, causal, window, cap, Sq, Sk):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(D * 1000 + G * 10 + Sq)
    Hkv = 2
    q = torch.randn(2, Sq, Hkv * G, D, device=cuda, generator=gen).to(dtype)
    k = torch.randn(2, Sk, Hkv, D, device=cuda, generator=gen).to(dtype)
    v = torch.randn(2, Sk, Hkv, D, device=cuda, generator=gen).to(dtype)
    kw = dict(causal=causal, window=window, scale=D ** -0.5, logit_softcap=cap)
    before = flash_ops.LAUNCHES
    a = flash_ops.flash_attention(q, k, v, **kw)
    b = flash_ops.flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, q_block=64, kv_block=64, **kw)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 2
    assert a.dtype == dtype and a.shape == q.shape
    assert _bitwise(a, b)
    agree = agreement(a, want)
    assert agree["ok"], agree


@pytest.mark.requires_cuda
def test_flash_kernel_small_head_dim_pads(cuda):
    """A head dim the kernel is not built for (the reduced configs' 16) is
    zero-padded to the next one and cut back."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    q, k, v = (torch.randn(1, 40, 4, 16, device=cuda, generator=gen) for _ in range(3))
    got = flash_ops.flash_attention(q, k[:, :, :2].contiguous(), v[:, :, :2].contiguous(), window=16, scale=0.25)
    want = flash_attention_plain(q, k[:, :, :2], v[:, :, :2], window=16, scale=0.25)
    agree = agreement(got, want)
    assert agree["ok"], agree


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D", [32, 64, 112, 128, 256])
@pytest.mark.parametrize("cap,q_mul", [(0.0, 1), (50.0, 1), (50.0, 32), (50.0, 64)])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (1, 1, True, 0), (1, 129, True, 0), (127, 127, True, 0), (128, 128, True, 0), (129, 129, True, 0),
    (200, 1000, True, 0), (200, 1000, False, 96), (300, 100, True, 0), (257, 257, True, 64),
])
def test_flash_bf16_kernel_at_tile_edges(cuda, D, cap, q_mul, Sq, Sk, causal, window):
    """The bf16 kernel (128-query tiles of two 64-row warpgroups, 80- or
    128-key tiles) where a sequence ends inside a tile, where the causal
    offset falls inside one, and where rows see no key (Sq > Sk, causal).
    q scaled by 32 or 64 puts the scaled scores at up to about 3x or 6x the
    softcap over a row, where tanh bends and the kernel's approximate tanh
    is furthest from the plain version's."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(D + Sq * 7 + Sk)
    q = torch.randn(2, Sq, 4, D, device=cuda, generator=gen).bfloat16() * q_mul
    k = torch.randn(2, Sk, 2, D, device=cuda, generator=gen).bfloat16()
    v = torch.randn(2, Sk, 2, D, device=cuda, generator=gen).bfloat16()
    kw = dict(causal=causal, window=window, scale=D ** -0.5, logit_softcap=cap)
    a = flash_ops.flash_attention(q, k, v, **kw)
    b = flash_ops.flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _bitwise(a, b)
    agree = agreement(a, want)
    assert agree["ok"], agree
    if Sq > Sk and causal:
        assert torch.count_nonzero(a[:, : Sq - Sk]) == 0


@pytest.mark.requires_cuda
def test_flash_bf16_small_head_dim_pads_and_one_query(cuda):
    """Head dim 16 in bf16 is padded to the 32 the library is built for
    (64-byte swizzle); one query over many keys, as a decode-shaped call."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    q = torch.randn(3, 1, 4, 16, device=cuda, generator=gen).bfloat16()
    k, v = (torch.randn(3, 300, 2, 16, device=cuda, generator=gen).bfloat16() for _ in range(2))
    kw = dict(window=64, scale=0.25, logit_softcap=30.0)
    got = flash_ops.flash_attention(q, k, v, **kw)
    agree = agreement(got, flash_attention_plain(q, k, v, **kw))
    assert got.shape == q.shape and agree["ok"], agree


@pytest.mark.requires_cuda
def test_flash_bf16_no_keys_gives_zero(cuda):
    q = torch.ones(1, 5, 2, 64, device=cuda, dtype=torch.bfloat16)
    k = v = torch.ones(1, 0, 1, 64, device=cuda, dtype=torch.bfloat16)
    got = flash_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.count_nonzero(got) == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_library_tiles_match_kernel_py(cuda, D):
    """The tile configuration compiled into the library is the one
    kernel.TILES states and the CPU tests hold to the SM's limits."""
    built = flash_kernel.library_config(D)
    assert {x: built[x] for x in flash_kernel.TILES[D]} == flash_kernel.TILES[D]
    assert built["smem"] == flash_kernel.smem_bytes(D)
    assert (built["threads"], built["producer_regs"], built["consumer_regs"]) == (
        flash_kernel.THREADS, flash_kernel.PRODUCER_REGS, flash_kernel.CONSUMER_REGS)


@pytest.mark.requires_cuda
def test_model_prefill_runs_the_kernel_and_matches_the_cpu(cuda):
    """Reduced gemma2 on the card: every prefill attention launches the
    kernel, and the logits agree with the same weights on the CPU within
    the bf16 prefill tolerance."""
    cfg = reduced_config(get_config("gemma2-9b"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    card = Model(cfg).init_params(gen)
    host = Model(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(4, cfg.vocab_size, (2, 40)).astype(np.int32))
    flash_ops.reset_launches()
    with torch.inference_mode():
        got, _ = card.prefill({"tokens": toks.to(cuda)})
        want, _ = host.prefill({"tokens": toks})
    assert flash_ops.LAUNCHES == cfg.n_layers
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=5e-2, atol=5e-2)
    res = generate(card, toks.to(cuda), 4)
    assert res.tokens.shape == (2, 44) and res.tokens.device.type == "cuda"


# the decay regimes of log_w: random, strong, the clip's strongest
# (-e^4) and its weakest (-e^-8)
WKV_DECAYS = ["random", "-5", "-54.6", "-3.4e-4"]


def _wkv_inputs(seed, B, S, H, K, decay, dtype, device, with_state):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(0.5 * rng.normal(size=(B, S, H, K)).astype(np.float32)).to(dtype)
               for _ in range(3))
    if decay == "random":
        lw = -np.exp(rng.normal(size=(B, S, H, K)))
    else:
        lw = np.full((B, S, H, K), float(decay))
    u = 0.3 * rng.normal(size=(H, K))
    s0 = rng.normal(size=(B, H, K, K)) if with_state else None
    f32 = [torch.from_numpy(np.asarray(a, np.float32)) if a is not None else None for a in (lw, u, s0)]
    return [t.to(device) if t is not None else None for t in (r, k, v, *f32)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "S0"])
@pytest.mark.parametrize("decay", WKV_DECAYS)
@pytest.mark.parametrize("B,H", [(2, 3), (8, 40), (1, 40)])
@pytest.mark.parametrize("S", [1, 100, 300])
@pytest.mark.parametrize("K", [16, 64])
def test_wkv6_kernel_matches_plain(cuda, K, S, B, H, decay, with_state):
    r, k, v, lw, u, s0 = _wkv_inputs(K * 7 + S, B, S, H, K, decay, torch.bfloat16, cuda, with_state)
    before = wkv6_ops.LAUNCHES
    y1, s1 = wkv6_ops.wkv6(r, k, v, lw, u, s0)
    y2, s2 = wkv6_ops.wkv6(r, k, v, lw, u, s0)
    want_y, want_s = wkv6_plain(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert wkv6_ops.LAUNCHES == before + 2
    assert y1.dtype == s1.dtype == torch.float32 and y1.shape == r.shape and s1.shape == (B, H, K, K)
    assert _bitwise(y1, y2) and _bitwise(s1, s2)
    for got, want in ((y1, want_y), (s1, want_s)):
        agree = wkv6_agreement(got, want)
        assert agree["ok"], agree


# (B, H, S) and the segments the rule cuts them into on an H100 (132 SMs):
# one where the heads give every SM two blocks, several for fewer heads, a
# count capped by the shortest segment for a short sequence
_WKV_RULE_SHAPES = {(8, 40, 300): 1, (4, 40, 300): 2, (1, 40, 2100): 15, (2, 3, 1000): 7, (1, 1, 77): 1}


def _wkv_rule_cases():
    """(K, B, H, S): each head size the kernel is built for at the shapes of
    _WKV_RULE_SHAPES."""
    return [(K, B, H, S) for K in wkv6_kernel.HEAD_SIZES for B, H, S in _WKV_RULE_SHAPES]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "S0"])
@pytest.mark.parametrize("decay", ["random", "-54.6", "-3.4e-4"])
@pytest.mark.parametrize("split", ["rule", "two", "every-chunk"])
@pytest.mark.parametrize("at", ["4L-1", "4L", "4L+1", "12L+5"])
@pytest.mark.parametrize("B,H", [(1, 40), (2, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K", wkv6_kernel.HEAD_SIZES)
def test_wkv6_kernel_at_segment_boundaries(cuda, K, dtype, B, H, at, split, decay, with_state):
    """The sequence-parallel passes where chunks and segments begin and end,
    at each head size, in bf16 and f32: the rule's own segment count, two
    segments, and one segment per chunk (S a multiple of the chunk length
    L, one less or one more, or 12 L + 5), with and without S0, over the
    clip's decays; y and the final state within KERNEL_TOL of the plain
    version, reruns bitwise equal."""
    chunk = wkv6_kernel.CHUNK
    S = {"4L-1": 4 * chunk - 1, "4L": 4 * chunk, "4L+1": 4 * chunk + 1, "12L+5": 12 * chunk + 5}[at]
    r, k, v, lw, u, s0 = _wkv_inputs(S * 3 + H + K, B, S, H, K, decay, dtype, cuda, with_state)
    n_seg = {"rule": None, "two": 2, "every-chunk": -(-S // chunk)}[split]
    y1, s1 = wkv6_kernel.launch(r, k, v, lw, u, s0, n_seg=n_seg)
    y2, s2 = wkv6_kernel.launch(r, k, v, lw, u, s0, n_seg=n_seg)
    want_y, want_s = wkv6_plain(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert _bitwise(y1, y2) and _bitwise(s1, s2)
    for got, want in ((y1, want_y), (s1, want_s)):
        agree = wkv6_agreement(got, want)
        assert agree["ok"], agree


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K,B,H,S", _wkv_rule_cases())
def test_wkv6_kernel_f32_and_every_row_split(cuda, K, B, H, S, dtype):
    """f32 and bf16 inputs at each head size, where the rule cuts the
    sequence into the segment counts it chooses on an H100 (the row splits
    of the per-token scan this kernel replaced are gone: the work is split
    by segments alone); reruns bitwise equal, and S = 0 returns the state it
    was given.  Every call goes through the model's entry, ops.wkv6, and
    counts one launch."""
    r, k, v, lw, u, s0 = _wkv_inputs(K + S, B, S, H, K, "random", dtype, cuda, True)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms == 132:
        assert wkv6_kernel.segments(B, H, S, K, sms) == _WKV_RULE_SHAPES[(B, H, S)]
    before = wkv6_ops.LAUNCHES
    got_y, got_s = wkv6_ops.wkv6(r, k, v, lw, u, s0)
    again_y, again_s = wkv6_ops.wkv6(r, k, v, lw, u, s0)
    want_y, want_s = wkv6_plain(r, k, v, lw, u, s0)
    assert wkv6_agreement(got_y, want_y)["ok"] and wkv6_agreement(got_s, want_s)["ok"]
    assert _bitwise(got_y, again_y) and _bitwise(got_s, again_s)
    y0, st = wkv6_ops.wkv6(r[:, :0], k[:, :0], v[:, :0], lw[:, :0], u, s0)
    assert y0.shape == (B, 0, H, K) and torch.equal(st, s0)
    assert wkv6_ops.LAUNCHES == before + 3


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_seg", [1, 3])
def test_wkv6_kernel_strong_decay_state_against_the_f64_scan(cuda, n_seg):
    """The clip's strongest decay (-54.6 a token, chunk exponents far below
    f32's) from a carried state: the final state, which then holds only the
    last token's k v^T, within KERNEL_TOL of the exact scan in f64, and y
    too."""
    r, k, v, lw, u, s0 = _wkv_inputs(54, 2, 197, 3, 64, "-54.6", torch.bfloat16, cuda, True)
    got_y, got_s = wkv6_kernel.launch(r, k, v, lw, u, s0, n_seg=n_seg)
    want_y, want_s = wkv6_scan(r, k, v, lw, u, s0, dtype=torch.float64)
    assert bool(torch.isfinite(got_s).all())
    assert wkv6_agreement(got_s, want_s)["ok"], wkv6_agreement(got_s, want_s)
    assert wkv6_agreement(got_y, want_y)["ok"], wkv6_agreement(got_y, want_y)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K", wkv6_kernel.HEAD_SIZES)
def test_wkv6_library_residency(cuda, K, dtype):
    """Every instance builds without spills, and at rwkv6's shapes (K = 64,
    bf16) the card holds at once the FILL_ONE_PASS blocks an SM that the
    segment rule runs in one pass (three, as measured on an H100)."""
    for with_y in (True, False):
        info = wkv6_kernel.library_info(dtype, K, with_y)
        assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 1, info
    if (K, dtype) == (64, torch.bfloat16):
        assert wkv6_kernel.library_info(dtype, K)["blocks_per_sm"] >= wkv6_kernel.FILL_ONE_PASS


def _spread_rwkv(model, generator):
    """Draw the tensors rwkv6 initialises to zeros, so that the decay spans
    the clip range and the bonus and token shift are not zero."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.split(".")[-1]
            if ".tmix." in name and leaf == "w0":
                p.copy_(torch.rand(p.shape, generator=generator, device=p.device) * 12 - 8)
            elif ".tmix." in name and leaf == "u":
                p.copy_(0.3 * torch.randn(p.shape, generator=generator, device=p.device))
            elif leaf.startswith("mu_"):
                p.copy_(torch.rand(p.shape, generator=generator, device=p.device))
            elif leaf == "w_lora_b":
                p.copy_(0.01 * torch.randn(p.shape, generator=generator, device=p.device))
            elif leaf == "ln_x":
                p.copy_(0.1 * torch.randn(p.shape, generator=generator, device=p.device))
    return model


@pytest.mark.requires_cuda
def test_rwkv6_prefill_runs_the_kernel_and_matches_the_cpu(cuda):
    """Reduced rwkv6 on the card: every prefill time-mix launches the
    kernel, and the logits and the final states agree with the same weights
    on the CPU within the bf16 prefill tolerance."""
    cfg = reduced_config(get_config("rwkv6-3b"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    card = _spread_rwkv(Model(cfg).init_params(gen), gen)
    host = Model(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(4, cfg.vocab_size, (2, 40)).astype(np.int32))
    wkv6_ops.reset_launches()
    with torch.inference_mode():
        got, gcache = card.prefill({"tokens": toks.to(cuda)})
        want, wcache = host.prefill({"tokens": toks})
    assert wkv6_ops.LAUNCHES == cfg.n_layers
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(gcache["groups"]["pos0"]["wkv"][0].cpu(), wcache["groups"]["pos0"]["wkv"][0],
                               rtol=5e-2, atol=5e-2)
    res = generate(card, toks.to(cuda), 4)
    assert res.tokens.shape == (2, 44) and res.tokens.device.type == "cuda"


def _wkv_grad_inputs(seed, B, S, H, K, decay, dtype, device, with_state):
    """_wkv_inputs, and dy (B, S, H, K) and dS_out (B, H, K, K; None without
    a state) N(0, 1) in f32."""
    r, k, v, lw, u, s0 = _wkv_inputs(seed, B, S, H, K, decay, dtype, device, with_state)
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.normal(size=(B, S, H, K)).astype(np.float32)).to(device)
    ds = torch.from_numpy(rng.normal(size=(B, H, K, K)).astype(np.float32)).to(device) if with_state else None
    return r, k, v, lw, u, s0, dy, ds


@pytest.mark.requires_cuda
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "S0"])
@pytest.mark.parametrize("decay", WKV_DECAYS)
@pytest.mark.parametrize("B,H", [(2, 3), (1, 40)])
@pytest.mark.parametrize("S", [1, 53, 208])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K", wkv6_kernel.HEAD_SIZES)
def test_wkv6_bwd_kernel_matches_plain(cuda, K, dtype, S, B, H, decay, with_state):
    """The backward kernel against wkv6_bwd_plain in float64 within BWD_TOL,
    every output in its type (u in r's type); reruns bitwise equal."""
    r, k, v, lw, u, s0, dy, ds = _wkv_grad_inputs(K * 5 + S, B, S, H, K, decay, dtype, cuda, with_state)
    u = u.to(dtype)
    got = wkv6_kernel.launch_bwd(r, k, v, lw, u, s0, dy, ds)
    again = wkv6_kernel.launch_bwd(r, k, v, lw, u, s0, dy, ds)
    want, scales = wkv6_bwd_plain(r, k, v, lw, u, s0, dy, ds, dtype=torch.float64, with_scales=True)
    torch.cuda.synchronize()
    assert [t.dtype for t in got] == [dtype] * 3 + [torch.float32, dtype, torch.float32]
    assert all(_bitwise(a, b) for a, b in zip(got, again))
    agree = wkv6_bwd_agreement(got, want, scales)
    assert agree["ok"], agree


@pytest.mark.requires_cuda
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "S0"])
@pytest.mark.parametrize("decay", ["random", "-54.6"])
@pytest.mark.parametrize("seg_len", [16, 32, 64, 128])
@pytest.mark.parametrize("at", ["4L-1", "4L", "4L+1", "12L+5"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K", wkv6_kernel.HEAD_SIZES)
def test_wkv6_bwd_kernel_at_segment_boundaries(cuda, K, dtype, at, seg_len, decay, with_state):
    """The backward's passes where chunks and segments begin and end, the
    counterpart of test_wkv6_kernel_at_segment_boundaries: segments of one,
    two, four and eight chunks (two groups of kept states; S a multiple of
    the chunk length L, one less or one more, or 12 L + 5), with and without
    S0 and dS_out; every output within BWD_TOL of the plain version in
    float64, reruns bitwise equal."""
    chunk = wkv6_kernel.CHUNK
    S = {"4L-1": 4 * chunk - 1, "4L": 4 * chunk, "4L+1": 4 * chunk + 1, "12L+5": 12 * chunk + 5}[at]
    r, k, v, lw, u, s0, dy, ds = _wkv_grad_inputs(S * 5 + seg_len + K, 2, S, 3, K, decay, dtype, cuda, with_state)
    u = u.to(dtype)
    got = wkv6_kernel.launch_bwd(r, k, v, lw, u, s0, dy, ds, seg_len=seg_len)
    again = wkv6_kernel.launch_bwd(r, k, v, lw, u, s0, dy, ds, seg_len=seg_len)
    want, scales = wkv6_bwd_plain(r, k, v, lw, u, s0, dy, ds, dtype=torch.float64, with_scales=True)
    torch.cuda.synchronize()
    assert all(_bitwise(a, b) for a, b in zip(got, again))
    agree = wkv6_bwd_agreement(got, want, scales)
    assert agree["ok"], agree


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("K", wkv6_kernel.HEAD_SIZES)
def test_wkv6_bwd_library_residency(cuda, K, dtype):
    """Both passes of the backward build and fit an SM: the chunk pass one
    block of two warpgroups with its kept states and operands in shared
    memory, the states pass without spills.  At K = 64 the chunk pass takes
    all 255 registers a thread and spills, as built with CUDA 12.8 on an
    H100, 24 bytes in bf16 and 248 in f32 (the training path is bf16); at
    K = 16 nothing.  A change that spills more fails here."""
    spill_limit = {(64, torch.bfloat16): 32, (64, torch.float32): 256}.get((K, dtype), 0)
    chunks = wkv6_kernel.bwd_library_info(dtype, K, True)
    assert chunks["blocks_per_sm"] >= 1 and chunks["smem"] <= 227 * 1024, chunks
    assert chunks["spill_bytes"] <= spill_limit, chunks
    states = wkv6_kernel.bwd_library_info(dtype, K, False)
    assert states["spill_bytes"] == 0 and states["blocks_per_sm"] >= 1, states


@pytest.mark.requires_cuda
@pytest.mark.parametrize("decay", ["random", "-3.4e-4"])
def test_wkv6_bwd_kernel_at_the_training_shape(cuda, decay):
    """rwkv6-3b's training microbatch (2 x 2048, 40 heads of 64, bf16),
    through the Function: dy from a loss, the counters, and the gradient
    within BWD_TOL of the plain version in float64."""
    r, k, v, lw, u, _, dy, _ = _wkv_grad_inputs(7, 2, 2048, 40, 64, decay, torch.bfloat16, cuda, False)
    u = u.to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
    wkv6_ops.reset_launches()
    y, _ = wkv6_ops.wkv6(*leaves)
    y.backward(dy)
    assert (wkv6_ops.LAUNCHES, wkv6_ops.BWD_LAUNCHES, wkv6_ops.PLAIN_BWD_CALLS) == (1, 1, 0)
    got = [t.grad for t in leaves]
    want, scales = wkv6_bwd_plain(r, k, v, lw, u, None, dy, None, dtype=torch.float64, with_scales=True)
    agree = wkv6_bwd_agreement(got, want[:5], scales[:5])
    assert agree["ok"], agree


@pytest.mark.requires_cuda
def test_wkv6_gradient_raises_where_the_kernel_is_not_built(cuda):
    """Under a gradient on the card, ops.wkv6 goes through the backward
    kernel or raises: a head size it is not built for, or an f16 input."""
    for K, dtype, err in ((32, torch.bfloat16, ValueError), (64, torch.float16, TypeError)):
        r = torch.zeros(1, 4, 2, K, device=cuda, dtype=dtype, requires_grad=True)
        lw = torch.zeros(1, 4, 2, K, device=cuda)
        u = torch.zeros(2, K, device=cuda)
        with pytest.raises(err, match="backward"):
            wkv6_ops.wkv6(r, r.detach(), r.detach(), lw, u)
    # without a gradient the forward alone decides
    with torch.no_grad():
        r = torch.zeros(1, 4, 2, 32, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head size"):
            wkv6_ops.wkv6(r, r, r, torch.zeros(1, 4, 2, 32, device=cuda), torch.zeros(2, 32, device=cuda))


@pytest.mark.requires_cuda
def test_rwkv6_train_step_on_the_card_runs_the_backward_kernel(cuda):
    """Reduced rwkv6: one value_and_grad on the card launches the WKV6
    backward once per layer and microbatch, never the plain one; every
    leaf gets a finite, nonzero gradient in every layer; the gradients agree with the same
    weights' on the CPU within the train tests' tolerance."""
    from repro_torch.train.step import TrainSpec, value_and_grad

    cfg = reduced_config(get_config("rwkv6-3b"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    card = _spread_rwkv(Model(cfg).init_params(gen), gen)
    host = Model(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = np.random.default_rng(2).integers(4, cfg.vocab_size, (4, 37)).astype(np.int32)
    spec = TrainSpec(microbatches=2, remat=True)
    wkv6_ops.reset_launches()
    loss, _, got = value_and_grad(card, card.params, {"tokens": torch.from_numpy(toks).to(cuda)}, spec)
    assert wkv6_ops.BWD_LAUNCHES == cfg.n_layers * 2 and wkv6_ops.PLAIN_BWD_CALLS == 0
    assert wkv6_ops.LAUNCHES == 2 * cfg.n_layers * 2
    # every leaf, and every layer's slice of a stacked one (15 of each block's
    # 22 are the time-mix's)
    assert len(got) == 25 and len([p for p in got if ".tmix." in p]) == 15
    for path, g in got.items():
        parts = list(g) if path.startswith("groups.") else [g]
        assert all(bool(torch.isfinite(x).all()) and float(x.abs().max()) > 0 for x in parts), path
    want_loss, _, want = value_and_grad(host, host.params, {"tokens": torch.from_numpy(toks)}, spec)
    assert abs(float(loss) - float(want_loss)) <= 2e-3 * abs(float(want_loss))
    for path, w in want.items():
        g = got[path].cpu().double()
        rel = float((g - w.double()).norm() / w.double().norm())
        assert rel <= 3e-2, (path, rel)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("method", ["dense", "sort"])
def test_plain_max_min_order_signed_zeros_the_same_every_run(cuda, method):
    """The plain MAX/MIN paths on the card (integer words scattered by
    atomics) give max +0.0 and min -0.0 for both keys, whichever zero a key
    meets first, the same bits over 20 runs."""
    from repro_torch.backends.torch_vec import CodegenChoices, Plan
    from repro_torch.core.transforms import canonicalize_array_names
    from repro_torch.data.multiset import database_from_columns
    from repro_torch.frontends.sql import sql_to_forelem

    n = 1 << 16
    keys = np.arange(n, dtype=np.int32) % 2
    vals = np.where((np.arange(n) // 2) % 2 == 0, -0.0, 0.0).astype(np.float32)
    sql = "SELECT k, MAX(v), MIN(v) FROM t GROUP BY k"
    prog = canonicalize_array_names(sql_to_forelem(sql, {"t": ["k", "v"]}))
    plan = Plan(prog, database_from_columns({"t": dict(k=keys, v=vals)}), CodegenChoices(agg_method=method))
    runs = [sorted((int(r[0]), float(r[1]), float(r[2])) for r in plan.run()["R"]) for _ in range(20)]
    want = [(0, 0.0, -0.0), (1, 0.0, -0.0)]
    for rows in runs:
        assert [(k, np.signbit(a), np.signbit(b)) for k, a, b in rows] == [(0, False, True), (1, False, True)]
        assert rows == want


# ---------------------------------------------------------------------------
# the partitioned backend's captured chunk kernels (backends/partitioned.py)
# ---------------------------------------------------------------------------

_CHUNK_SQL = "SELECT k, SUM(v), MIN(v), MAX(w), COUNT(k) FROM t WHERE v > -50 GROUP BY k"


def _chunk_kernel(cuda, agg_method="kernel"):
    """A fused chunk aggregation of _CHUNK_SQL on the card, wrapped in the
    backend's capture cache, with its eager function beside it."""
    from repro_torch.backends import CodegenChoices, TorchLowering
    from repro_torch.backends.partitioned import JitCacheStats, _JitKernel
    from repro_torch.data.multiset import database_from_columns
    from repro_torch.frontends.sql import sql_to_forelem

    rng = np.random.default_rng(21)
    db = database_from_columns({"t": dict(
        k=rng.integers(0, 300, 1000).astype(np.int32),
        v=rng.integers(-100, 100, 1000).astype(np.int32),
        w=rng.random(1000).astype(np.float32),
    )})
    low = TorchLowering(sql_to_forelem(_CHUNK_SQL, {"t": ["k", "v", "w"]}), db,
                        CodegenChoices(agg_method=agg_method, device="cuda"))
    group = [low.spec.aggs[i] for i in low.fused_groups[0]]
    fn = low.chunk_fused_agg_fn(tuple(group))
    return _JitKernel("agg", fn, JitCacheStats(), 64, cuda), fn


def _chunk(seed, m, n, cuda):
    rng = np.random.default_rng(seed)
    cols = {
        "k": torch.from_numpy(rng.integers(0, 300, m).astype(np.int32)).to(cuda),
        "v": torch.from_numpy(rng.integers(-100, 100, m).astype(np.int32)).to(cuda),
        "w": torch.from_numpy(rng.random(m).astype(np.float32)).to(cuda),
    }
    return cols, torch.full((), n, dtype=torch.int32, device=cuda)


def _equal_partials(a, b):
    (accs_a, pres_a), (accs_b, pres_b) = a, b
    return all(_bitwise(x, y) for x, y in zip(accs_a, accs_b)) and torch.equal(pres_a, pres_b)


@pytest.mark.requires_cuda
def test_graph_replays_two_chunks_of_one_bucket_without_aliasing(cuda):
    kern, fn = _chunk_kernel(cuda)
    c1, n1 = _chunk(1, 4096, 4000, cuda)
    c2, n2 = _chunk(2, 4096, 3900, cuda)
    r1, first = kern(c1, n1, {"__params__": {}}, {})
    r2, again = kern(c2, n2, {"__params__": {}}, {})
    assert first and not again and kern.stats.compiles == 1 and kern.stats.hits == 1
    torch.cuda.synchronize()
    assert _equal_partials(r1, fn(c1, n1, {"__params__": {}}, {}))
    assert _equal_partials(r2, fn(c2, n2, {"__params__": {}}, {}))
    assert not torch.equal(r1[1], r2[1])  # the first result was not overwritten


@pytest.mark.requires_cuda
def test_graph_reads_n_valid_at_each_replay(cuda):
    kern, fn = _chunk_kernel(cuda)
    cols, _ = _chunk(3, 2048, 2048, cuda)
    for n in (2048, 1500, 1, 0, 1025):
        nv = torch.full((), n, dtype=torch.int32, device=cuda)
        got, _ = kern(cols, nv, {"__params__": {}}, {})
        assert int(got[1].sum()) <= n
        assert _equal_partials(got, fn(cols, nv, {"__params__": {}}, {}))
    assert kern.stats.compiles == 1 and kern.stats.hits == 4


@pytest.mark.requires_cuda
def test_concurrent_workers_replay_one_signature(cuda):
    import threading

    kern, fn = _chunk_kernel(cuda)
    chunks = [_chunk(10 + i, 4096, 4096 - 7 * i, cuda) for i in range(16)]
    want = [fn(c, n, {"__params__": {}}, {}) for c, n in chunks]
    torch.cuda.synchronize()
    got = [None] * len(chunks)
    errors = []

    def worker(w):
        stream = torch.cuda.Stream()
        try:
            with torch.cuda.stream(stream):
                for i in range(w, len(chunks), 4):
                    c, n = chunks[i]
                    got[i], _ = kern(c, n, {"__params__": {}}, {})
            stream.synchronize()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert all(_equal_partials(g, w) for g, w in zip(got, want))
    assert kern.stats.compiles == 1 and kern.stats.hits == len(chunks) - 1


@pytest.mark.requires_cuda
def test_capture_stream_is_no_worker_stream(cuda):
    from repro_torch.backends.partitioned import StreamHandoff, capture_stream

    handoff = StreamHandoff(cuda)
    workers = {handoff.new_stream().cuda_stream for _ in range(100)}  # the pool wraps
    assert capture_stream(cuda).cuda_stream not in workers
    assert capture_stream(cuda) is capture_stream(cuda)


@pytest.mark.requires_cuda
def test_workers_replay_while_others_capture(cuda):
    """Workers on fresh streams (more than the stream pool holds) replay
    some signatures while other workers capture new ones."""
    import threading

    from repro_torch.backends.partitioned import StreamHandoff

    kern, fn = _chunk_kernel(cuda)
    sizes = [1024 * (1 + i % 8) for i in range(48)]
    chunks = [_chunk(40 + i, m, m - 3 * i, cuda) for i, m in enumerate(sizes)]
    want = [fn(c, n, {"__params__": {}}, {}) for c, n in chunks]
    torch.cuda.synchronize()
    got = [None] * len(chunks)
    errors = []
    handoff = StreamHandoff(cuda)

    def worker(w):
        try:
            for i in range(w, len(chunks), 6):
                stream = handoff.new_stream()
                with handoff.on(stream):
                    c, n = chunks[i]
                    got[i], _ = kern(c, n, {"__params__": {}}, {})
                handoff.finish(stream, got[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors[0]
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert all(_equal_partials(g, w) for g, w in zip(got, want))
    assert kern.stats.compiles == 8 and kern.stats.hits == len(chunks) - 8


def _partitioned_rows(sql, tables, **kw):
    from repro_torch.backends import CodegenChoices, PartitionedChoices, get_backend
    from repro_torch.data.multiset import database_from_columns
    from repro_torch.frontends.sql import sql_to_forelem

    schemas = {t: list(c) for t, c in tables.items()}
    base = CodegenChoices(agg_method=kw.pop("agg_method", "kernel"), device=kw.pop("device", "cuda"))
    plan = get_backend("partitioned").compile(
        sql_to_forelem(sql, schemas), database_from_columns(tables), PartitionedChoices(base=base, **kw))
    return plan.run()["R"], plan


@pytest.mark.requires_cuda
@pytest.mark.parametrize("schedule", ["static", "guided"])
def test_partitioned_async_equals_serial_bitwise_on_the_kernel_path(cuda, schedule):
    rng = np.random.default_rng(5)
    n = 300_000
    tables = {"t": dict(
        k=rng.integers(0, 5000, n).astype(np.int32),
        v=rng.integers(-100, 100, n).astype(np.int32),
        w=rng.random(n).astype(np.float32),
    )}
    q = "SELECT k, SUM(v), SUM(w), MIN(w), MAX(v), COUNT(k) FROM t WHERE v > -90 GROUP BY k"
    serial, _ = _partitioned_rows(q, tables, n_partitions=8, schedule=schedule, async_dispatch=False)
    pooled, plan = _partitioned_rows(q, tables, n_partitions=8, schedule=schedule, async_dispatch=True)
    assert plan.jit_stats.compiles > 0 and plan.jit_stats.hits > 0
    assert sorted(serial) == sorted(pooled)  # floats included: bitwise
    host, _ = _partitioned_rows(q, tables, n_partitions=8, schedule=schedule, device="cpu")
    for ra, rb in zip(sorted(pooled), sorted(host)):
        assert ra[0] == rb[0] and ra[1] == rb[1] and ra[4:] == rb[4:]
        assert all(abs(x - y) <= 1e-3 + 1e-5 * abs(y) for x, y in zip(ra[2:4], rb[2:4]))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("method", ["dense", "onehot", "sort", "kernel"])
def test_negative_group_keys_are_dropped_on_the_card(cuda, method):
    rng = np.random.default_rng(28)
    n = 2000
    tables = {"t": dict(k=rng.integers(-5, 40, n).astype(np.int32),
                        v=rng.integers(-100, 100, n).astype(np.int32))}
    q = "SELECT k, SUM(v), COUNT(k) FROM t GROUP BY k"
    from repro_torch.core import OptimizeOptions, optimize
    from repro_torch.data.multiset import database_from_columns
    from repro_torch.frontends.sql import sql_to_forelem

    prog = sql_to_forelem(q, {"t": ["k", "v"]})
    rows = {}
    for device in ("cuda", "cpu"):
        res = optimize(prog, database_from_columns(tables),
                       OptimizeOptions(agg_method=method, reformat=False, device=device))
        rows[device] = sorted(res.plan.run()["R"])
        torch.cuda.synchronize()
    part, _ = _partitioned_rows(q, tables, n_partitions=4, agg_method=method)
    assert rows["cuda"] == rows["cpu"] == sorted(part)
    assert len(rows["cuda"]) == 40 and all(r[0] >= 0 for r in rows["cuda"])


# ---------------------------------------------------------------------------
# the flash backward kernel (csrc/flash_bwd.cu), graph decode, training
# ---------------------------------------------------------------------------


def _bwd_inputs(gen, B, S, Hkv, G, D, device):
    q = torch.randn(B, S, Hkv * G, D, device=device, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(B, S, Hkv, D, device=device, generator=gen).to(torch.bfloat16) for _ in range(2))
    dout = torch.randn(B, S, Hkv * G, D, device=device, generator=gen).to(torch.bfloat16)
    return q, k, v, dout


@pytest.mark.requires_cuda
@pytest.mark.parametrize("S", [2, 77, 128, 300])
@pytest.mark.parametrize("cap,q_mul", [(0.0, 1), (50.0, 1), (50.0, 32), (50.0, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40), (False, 0), (False, 40)])
@pytest.mark.parametrize("G", [1, 12])
@pytest.mark.parametrize("D", [16, 64, 80, 112, 128, 256])
def test_flash_bwd_kernel_matches_plain(cuda, D, G, causal, window, cap, q_mul, S):
    """dq, dk, dv of the backward kernel against the plain version in
    float64 on the same bf16 inputs and forward output, within
    ref.BWD_TOL, and against the exact gradient within ref.BWD_EXACT_REL;
    a rerun is bitwise equal.  q scaled by 32 and 64 puts the scores at
    several times the softcap, where its derivative is far from 1."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(S * 7 + D + G)
    q, k, v, dout = _bwd_inputs(gen, 2, S, 2, G, D, cuda)
    q = q * q_mul
    kw = dict(causal=causal, window=window, scale=D ** -0.5, logit_softcap=cap)
    out, lse = flash_kernel.launch(q, k, v, **kw, with_lse=True)
    a = flash_kernel.launch_bwd(q, k, v, out, dout, lse, **kw)
    b = flash_kernel.launch_bwd(q, k, v, out, dout, lse, **kw)
    want = flash_attention_bwd_plain(q.double(), k.double(), v.double(), dout.double(), out.double(), **kw)
    exact = flash_attention_bwd_plain(q.double(), k.double(), v.double(), dout.double(), **kw)
    torch.cuda.synchronize()
    agree = bwd_agreement(a, want)
    assert agree["ok"], agree
    # at q x 32 and 64 the softmax saturates: dq and dk of the exact gradient
    # cancel to near zero, and the bf16 output that delta reads moves them by
    # much of their norm (the float64 plain version given that output too, at
    # S = 2), so there only dv, which delta does not enter, is held to it
    held = slice(None) if q_mul == 1 else slice(2, 3)
    assert bwd_exact_agreement(a[held], exact[held])["ok"]
    assert all(_bitwise(x, y) for x, y in zip(a, b))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("S", [1000, 2100])
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1024), (False, 0), (False, 1024)])
@pytest.mark.parametrize("G", [1, 2])
def test_flash_bwd_kernel_at_head_dim_256(cuda, G, causal, window, cap, S):
    """D = 256 (gemma2-9b's and gemma3-4b's heads; its own tiles, the two
    warpgroups of a block splitting the work) at gemma3's local window of
    1024 and gemma2's softcap of 50, GQA groups 1 and 2, S ragged against
    the 64-row tiles: within ref.BWD_TOL of the plain version in float64,
    within ref.BWD_EXACT_REL of the exact gradient, reruns bitwise equal."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(S + 10 * G + window)
    q, k, v, dout = _bwd_inputs(gen, 1, S, 2, G, 256, cuda)
    kw = dict(causal=causal, window=window, scale=256 ** -0.5, logit_softcap=cap)
    out, lse = flash_kernel.launch(q, k, v, **kw, with_lse=True)
    a = flash_kernel.launch_bwd(q, k, v, out, dout, lse, **kw)
    b = flash_kernel.launch_bwd(q, k, v, out, dout, lse, **kw)
    want = flash_attention_bwd_plain(q.double(), k.double(), v.double(), dout.double(), out.double(), **kw)
    exact = flash_attention_bwd_plain(q.double(), k.double(), v.double(), dout.double(), **kw)
    torch.cuda.synchronize()
    agree = bwd_agreement(a, want)
    assert agree["ok"], agree
    assert bwd_exact_agreement(a, exact)["ok"]
    assert all(_bitwise(x, y) for x, y in zip(a, b))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D", [80, 112, 256])
def test_flash_attention_gradient_at_the_new_head_dims(cuda, D):
    """ops.flash_attention's gradient at hubert-xlarge's 80 (not causal),
    zamba2's 112 and gemma3's 256 (causal): one forward and one backward
    launch, no plain backward, the head dim padded and cut back (80 and
    112), the gradients within ref.BWD_TOL of the plain backward."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(D)
    q, k, v, dout = _bwd_inputs(gen, 2, 333, 2, 2, D, cuda)
    kw = dict(causal=D != 80, window=0, scale=D ** -0.5, logit_softcap=0.0)
    flash_ops.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_ops.flash_attention(*leaves, **kw)
    out.backward(dout)
    assert (flash_ops.LAUNCHES, flash_ops.BWD_LAUNCHES, flash_ops.PLAIN_BWD_CALLS) == (1, 1, 0)
    got = [t.grad for t in leaves]
    assert [tuple(g.shape) for g in got] == [tuple(t.shape) for t in (q, k, v)]
    want = flash_attention_bwd_plain(q.double(), k.double(), v.double(), dout.double(), out.detach().double(), **kw)
    agree = bwd_agreement(got, want)
    assert agree["ok"], agree


@pytest.mark.requires_cuda
@pytest.mark.parametrize("G", [1, 12])
def test_flash_bwd_kernel_on_one_token(cuda, G):
    """A sequence of one token: p = 1 whatever the score, so dq and dk are
    zero (ds = dp - delta, delta taken by dp's own products) and dv = dout
    summed over the group."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(G)
    q, k, v, dout = _bwd_inputs(gen, 2, 1, 2, G, 128, cuda)
    kw = dict(causal=True, window=0, scale=128 ** -0.5, logit_softcap=0.0)
    out, lse = flash_kernel.launch(q, k, v, **kw, with_lse=True)
    dq, dk, dv = flash_kernel.launch_bwd(q, k, v, out, dout, lse, **kw)
    assert float(dq.abs().max()) <= 1e-5 and float(dk.abs().max()) <= 1e-5
    want = dout.float().reshape(2, 1, 2, G, 128).sum(dim=3)
    torch.testing.assert_close(dv.float(), want, rtol=2 ** -8, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_flash_bwd_partials_of_twelve_heads_rerun_bitwise(cuda, cap):
    """G = 12 query heads a kv head at S = 2048 (starcoder2-3b's grouping
    and length): each dkv block writes one head's f32 partials and a third
    launch sums them in head order, so a rerun is bitwise equal; the result
    agrees with the plain backward within ref.BWD_TOL."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(12)
    q, k, v, dout = _bwd_inputs(gen, 1, 2048, 2, 12, 128, cuda)
    kw = dict(causal=True, window=0, scale=128 ** -0.5, logit_softcap=cap)
    out, lse = flash_kernel.launch(q, k, v, **kw, with_lse=True)
    a = flash_kernel.launch_bwd(q, k, v, out, dout, lse, **kw)
    b = flash_kernel.launch_bwd(q, k, v, out, dout, lse, **kw)
    want = flash_attention_bwd_plain(q.double(), k.double(), v.double(), dout.double(), out.double(), **kw)
    torch.cuda.synchronize()
    assert all(_bitwise(x, y) for x, y in zip(a, b))
    agree = bwd_agreement(a, want)
    assert agree["ok"], agree


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 12])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 32), (False, 32)])
@pytest.mark.parametrize("cap,q_mul", [(0.0, 1), (50.0, 1), (50.0, 32)])
@pytest.mark.parametrize("Sq,Sk", [(130, 257), (200, 200), (300, 100)])
def test_flash_forward_lse_matches_plain(cuda, D, G, causal, window, cap, q_mul, Sq, Sk):
    """The bf16 kernel's row statistics against flash_attention_lse_plain in
    float64 on the same inputs, over phase 6's masks, caps and GQA groups,
    rows with no key (Sq > Sk, causal) at +inf; the output is bitwise the
    one the launch without statistics gives.  Tolerance: 1e-4 (1 + |lse|)
    for the f32 sums and ex2.approx, plus, under a cap c, c * 2^-11: the
    kernel's tanh.approx (relative error at most 2^-11) moves a capped
    score by up to that, and lse by no more."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(D * 1000 + G * 10 + Sq)
    q = torch.randn(2, Sq, 2 * G, D, device=cuda, generator=gen).bfloat16() * q_mul
    k, v = (torch.randn(2, Sk, 2, D, device=cuda, generator=gen).bfloat16() for _ in range(2))
    kw = dict(causal=causal, window=window, scale=D ** -0.5, logit_softcap=cap)
    out, lse = flash_kernel.launch(q, k, v, **kw, with_lse=True)
    want = flash_attention_lse_plain(q.double(), k.double(), **kw)
    torch.cuda.synchronize()
    assert lse.shape == (2, 2 * G, Sq) and lse.dtype == torch.float32
    assert _bitwise(out, flash_kernel.launch(q, k, v, **kw))
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    err = (lse.double()[fin] - want[fin]).abs()
    limit = 1e-4 * (1 + want[fin].abs()) + (cap * 2 ** -11 if cap > 0 else 0.0)
    assert bool((err <= limit).all()), float((err / limit).max())


@pytest.mark.requires_cuda
def test_flash_serving_calls_launch_without_statistics(cuda, monkeypatch):
    """Without a gradient (serving: prefill, decode) the wrapper launches the
    forward without row statistics, as before; under a gradient with
    them, and the backward reads them."""
    seen = []
    launch = flash_kernel.launch
    monkeypatch.setattr(flash_kernel, "launch", lambda *a, **kw: seen.append(kw["with_lse"]) or launch(*a, **kw))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    q, k, v, dout = _bwd_inputs(gen, 1, 70, 2, 2, 64, cuda)
    with torch.no_grad():
        flash_ops.flash_attention(q, k, v, scale=0.125)
    flash_ops.flash_attention(q, k, v, scale=0.125)
    flash_ops.flash_attention(q[:, -1:], k, v, scale=0.125)  # a decode-shaped call
    assert seen == [False, False, False]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_ops.flash_attention(*leaves, scale=0.125).backward(dout)
    assert seen[-1] is True


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_flash_attention_gradient_on_the_card(cuda, cap):
    """ops.flash_attention with inputs that require grad: the backward
    launches the kernel once and never the plain version, and its gradients
    agree with the plain backward given the same output within ref.BWD_TOL
    and with autograd of attention_ref in f32 within ref.BWD_EXACT_REL."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    q, k, v, dout = _bwd_inputs(gen, 2, 200, 2, 12, 128, cuda)
    kw = dict(causal=True, window=0, scale=128 ** -0.5, logit_softcap=cap)
    flash_ops.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_ops.flash_attention(*leaves, **kw)
    out.backward(dout)
    assert (flash_ops.LAUNCHES, flash_ops.BWD_LAUNCHES, flash_ops.PLAIN_BWD_CALLS) == (1, 1, 0)
    got = [t.grad for t in leaves]
    want = flash_attention_bwd_plain(q.double(), k.double(), v.double(), dout.double(), out.detach().double(), **kw)
    agree = bwd_agreement(got, want)
    assert agree["ok"], agree
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    attention_ref(*ref, **kw).backward(dout.float())
    assert bwd_exact_agreement(got, [t.grad for t in ref])["ok"]


@pytest.mark.requires_cuda
def test_flash_gradient_raises_where_the_kernel_is_not_built(cuda):
    q = torch.zeros(1, 8, 2, 96, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="head dims"):
        flash_ops.flash_attention(q, q.detach()[:, :, :1], q.detach()[:, :, :1])
    q32 = torch.zeros(1, 8, 2, 64, device=cuda, requires_grad=True)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_ops.flash_attention(q32, q32.detach(), q32.detach())
    qb = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    kb = torch.zeros(1, 9, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one length"):
        flash_ops.flash_attention(qb, kb, kb)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["gemma2-9b", "rwkv6-3b", "starcoder2-3b", "zamba2-7b"])
def test_graph_decode_equals_eager(cuda, arch):
    """Greedy generation with the decode step replayed as a CUDA graph gives
    the eager path's tokens and logits, bit for bit (zamba2: the Mamba2
    states and the shared blocks' k/v written in place)."""
    cfg = reduced_config(get_config(arch))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    model = Model(cfg).init_params(gen)
    if arch == "rwkv6-3b":
        model = _spread_rwkv(model, gen)
    if arch == "zamba2-7b":
        mamba2.spread_zero_inits_(model.named_parameters(), gen)
    toks = torch.from_numpy(np.random.default_rng(1).integers(4, cfg.vocab_size, (2, 24)).astype(np.int32)).to(cuda)
    eager = generate(model, toks, 10, keep_logits=True, graph=False)
    graphed = generate(model, toks, 10, keep_logits=True, graph=True)
    assert torch.equal(eager.tokens, graphed.tokens)
    for a, b in zip(eager.logits, graphed.logits):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shards,C", [(1, 8), (1, 40), (2, 12)])
def test_moe_route_on_the_card_equals_the_cpu(cuda, shards, C):
    """models/moe.route on the card (stable sort, searchsorted, gathers, the
    combine's order) against the CPU on the same f32 logits, with two
    experts tied at every token and capacities that drop and that do not:
    every field equal (lb_loss within f32 rounding), the combine
    bitwise."""
    from repro_torch.models import moe

    rng = np.random.default_rng(shards * 100 + C)
    E, K, T, d = 16, 4, 96, 32
    logits = rng.standard_normal((T, E)).astype(np.float32)
    logits[:, 5] = logits[:, 9]
    lg = torch.from_numpy(logits).reshape(shards, T // shards, E)
    y = torch.from_numpy(rng.standard_normal((shards, E * C, d)).astype(np.float32)).bfloat16()
    want = moe.route(lg, E=E, K=K, C=C, dtype=torch.bfloat16)
    got = moe.route(lg.to(cuda), E=E, K=K, C=C, dtype=torch.bfloat16)
    for name, w in want._asdict().items():
        if name == "lb":  # an f32 mean over the tokens, summed in another order
            torch.testing.assert_close(got.lb.cpu(), w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(getattr(got, name).cpu(), w), name
    assert torch.equal(moe.combine(y.to(cuda), got).cpu(), moe.combine(y, want))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
def test_moe_graph_decode_equals_eager(cuda, arch):
    """A reduced MoE model's decode step (routing, dispatch and combine with
    no value read back to the host) captures in a CUDA graph: greedy
    generation gives the eager step's tokens and logits bit for bit, and a
    second eager run the same (the combine is a gather, not an atomic
    scatter).  llama4's prompt is longer than its reduced chunk."""
    cfg = reduced_config(get_config(arch))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    model = Model(cfg).init_params(gen)
    toks = torch.from_numpy(np.random.default_rng(1).integers(4, cfg.vocab_size, (2, 40)).astype(np.int32)).to(cuda)
    eager = generate(model, toks, 10, keep_logits=True, graph=False)
    again = generate(model, toks, 10, keep_logits=True, graph=False)
    graphed = generate(model, toks, 10, keep_logits=True, graph=True)
    assert torch.equal(eager.tokens, graphed.tokens) and torch.equal(eager.tokens, again.tokens)
    for a, b, c in zip(eager.logits, graphed.logits, again.logits):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.requires_cuda
def test_graph_decode_samples_with_its_generator(cuda):
    cfg = reduced_config(get_config("starcoder2-3b"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    model = Model(cfg).init_params(gen)
    toks = torch.from_numpy(np.random.default_rng(1).integers(4, cfg.vocab_size, (2, 8)).astype(np.int32)).to(cuda)
    res = generate(model, toks, 12, temperature=1.0, generator=gen)
    assert res.tokens.shape == (2, 20)
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab_size


@pytest.mark.requires_cuda
def test_train_step_on_the_card_runs_the_backward_kernel(cuda):
    """Reduced starcoder2-3b: one value_and_grad on the card launches the
    backward kernel once per layer and microbatch (twice the forward with
    remat), never the plain backward, and its gradients agree with the same
    weights' on the CPU within the train tests' tolerance."""
    from repro_torch.train.step import TrainSpec, value_and_grad

    cfg = reduced_config(get_config("starcoder2-3b"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    card = Model(cfg).init_params(gen)
    host = Model(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = np.random.default_rng(2).integers(4, cfg.vocab_size, (4, 32)).astype(np.int32)
    spec = TrainSpec(microbatches=2, remat=True)
    flash_ops.reset_launches()
    loss, _, got = value_and_grad(card, card.params, {"tokens": torch.from_numpy(toks).to(cuda)}, spec)
    assert flash_ops.BWD_LAUNCHES == cfg.n_layers * 2 and flash_ops.PLAIN_BWD_CALLS == 0
    assert flash_ops.LAUNCHES == 2 * cfg.n_layers * 2
    want_loss, _, want = value_and_grad(host, host.params, {"tokens": torch.from_numpy(toks)}, spec)
    assert abs(float(loss) - float(want_loss)) <= 2e-3 * abs(float(want_loss))
    for path, w in want.items():
        g = got[path].cpu().double()
        rel = float((g - w.double()).norm() / w.double().norm())
        assert rel <= 3e-2, (path, rel)


@pytest.mark.requires_cuda
def test_hubert_on_the_card_matches_the_cpu(cuda):
    """Reduced hubert-xlarge (frames, bidirectional layers, the exact gelu's
    table on the card): one flash launch a layer, not causal, and logits
    within the bf16 prefill tolerance of the CPU's; one value_and_grad on
    frames, labels and a label_mask launches the backward kernel once per
    layer and microbatch, and its loss and gradients agree with the CPU's
    within the train tests' tolerance."""
    from repro_torch.models.common import gelu
    from repro_torch.train.step import TrainSpec, value_and_grad

    words = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    assert torch.equal(gelu(words.to(cuda)).cpu().view(torch.int16), gelu(words).view(torch.int16))
    cfg = reduced_config(get_config("hubert-xlarge"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    card = Model(cfg).init_params(gen)
    host = Model(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(3)
    batch = {"frames": rng.standard_normal((4, 40, cfg.d_model)).astype(np.float32),
             "labels": rng.integers(0, cfg.vocab_size, (4, 40)).astype(np.int32),
             "label_mask": rng.random((4, 40)) < 0.5}
    on_card = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    on_host = {k: torch.from_numpy(v) for k, v in batch.items()}
    flash_ops.reset_launches()
    with torch.no_grad():
        got = card({"frames": on_card["frames"]})[0]
    assert flash_ops.LAUNCHES == cfg.n_layers
    want = host({"frames": on_host["frames"]})[0]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=5e-2, atol=5e-2)
    spec = TrainSpec(microbatches=2, remat=True)
    flash_ops.reset_launches()
    loss, _, grads = value_and_grad(card, card.params, on_card, spec)
    assert flash_ops.BWD_LAUNCHES == cfg.n_layers * 2 and flash_ops.PLAIN_BWD_CALLS == 0
    want_loss, _, want_grads = value_and_grad(host, host.params, on_host, spec)
    assert abs(float(loss) - float(want_loss)) <= 2e-3 * abs(float(want_loss))
    for path, w in want_grads.items():
        rel = float((grads[path].cpu().double() - w.double()).norm() / w.double().norm())
        assert rel <= 3e-2, (path, rel)


@pytest.mark.requires_cuda
def test_serve_cli_refills_slots_under_the_graph(cuda):
    """launch/serve.py on the card: more requests than slots, so the slots
    that finish are refilled (their cache lane zeroed in place) while each
    decode step replays the graph.  As in the JAX package's CLI, the loop
    ends when the shared position reaches prompt + new."""
    from repro_torch.launch import serve

    out = serve.main(["--requests", "5", "--batch", "2", "--new", "4", "--prompt-len", "20"])
    assert out["done"] == 2 and out["tokens"] == 2 * 4


@pytest.mark.requires_cuda
def test_zamba2_prefill_runs_the_kernel_and_matches_the_cpu(cuda):
    """Reduced zamba2 on the card: one flash launch a shared invocation,
    the SSD's f32 products in f32 (no TF32), and the logits, the Mamba2
    states and the shared blocks' k/v agree with the same weights on the
    CPU within the bf16 prefill tolerance."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = reduced_config(get_config("zamba2-7b"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    card = Model(cfg).init_params(gen)
    mamba2.spread_zero_inits_(card.named_parameters(), gen)
    host = Model(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(4, cfg.vocab_size, (2, 100)).astype(np.int32))
    flash_ops.reset_launches()
    with torch.inference_mode():
        got, gcache = card.prefill({"tokens": toks.to(cuda)})
        want, wcache = host.prefill({"tokens": toks})
    assert flash_ops.LAUNCHES == cfg.n_layers // cfg.shared_attn_period == 3
    tol = dict(rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(got.float().cpu(), want.float(), **tol)
    for name in ("conv", "ssm"):
        torch.testing.assert_close(gcache["groups"]["pos0"][name][0].float().cpu(),
                                   wcache["groups"]["pos0"][name][0].float(), **tol)
    for name in ("k", "v"):
        torch.testing.assert_close(gcache["shared"][name][0, 0].float().cpu(), wcache["shared"][name][0, 0].float(),
                                   **tol)
    res = generate(card, toks.to(cuda), 4)
    assert res.tokens.shape == (2, 104) and res.tokens.device.type == "cuda"


@pytest.mark.requires_cuda
def test_serve_cli_serves_zamba2_under_the_graph(cuda):
    """launch/serve.py on the card with reduced zamba2: slots refilled (every
    cache lane zeroed in place, the shared stacks' included) while each
    decode step replays the graph."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", "zamba2-7b", "--requests", "5", "--batch", "2", "--new", "4", "--prompt-len", "20"])
    assert out["done"] == 2 and out["tokens"] == 2 * 4


@pytest.mark.requires_cuda
def test_moe_train_step_gradients_repeat_bitwise(cuda):
    """A reduced dbrx-132b value_and_grad on the card gives the same bits
    twice: the dispatch's gradient sums each token's K rows by a gather in
    a fixed order (moe._TokenRows), not by index_add_'s atomics."""
    from repro_torch.train.step import TrainSpec, value_and_grad

    cfg = reduced_config(get_config("dbrx-132b"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    model = Model(cfg).init_params(gen)
    toks = torch.from_numpy(np.random.default_rng(3).integers(4, cfg.vocab_size, (4, 32)).astype(np.int32)).to(cuda)
    spec = TrainSpec(microbatches=2, remat=True)
    runs = [value_and_grad(model, model.params, {"tokens": toks}, spec) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for path, g in runs[0][2].items():
        assert torch.equal(g, runs[1][2][path]), path


@pytest.mark.requires_cuda
def test_zamba2_train_step_on_the_card_runs_the_backward_at_head_dim_112(cuda, monkeypatch):
    """Reduced zamba2-7b with its shared blocks' published head dim of 112:
    one value_and_grad on the card (remat, two microbatches) launches the
    flash backward at 112 (padded to 128) once a shared invocation and
    microbatch and never the plain one; each call's dq, dk, dv within
    ``ref.BWD_TOL`` of the plain backward in float64 given the same output;
    the loss within the train tests' tolerance of the same weights' on the
    CPU, and every leaf, each shared block's slice and each layer's, a
    finite nonzero gradient."""
    from repro_torch.train.step import TrainSpec, value_and_grad

    cfg = dataclasses.replace(reduced_config(get_config("zamba2-7b")), head_dim=112)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    card = Model(cfg).init_params(gen)
    mamba2.spread_zero_inits_(card.named_parameters(), gen)
    host = Model(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = np.random.default_rng(4).integers(4, cfg.vocab_size, (4, 128)).astype(np.int32)
    calls = []
    real = flash_ops._backward

    def held(*args):
        grads = real(*args)
        calls.append(([a.clone() if hasattr(a, "clone") else a for a in args], [g.clone() for g in grads]))
        return grads

    monkeypatch.setattr(flash_ops, "_backward", held)
    spec = TrainSpec(microbatches=2, remat=True)
    flash_ops.reset_launches()
    loss, _, got = value_and_grad(card, card.params, {"tokens": torch.from_numpy(toks).to(cuda)}, spec)
    invocations = 3  # after layers 2, 4 and 6 of the reduced pattern
    assert flash_ops.BWD_LAUNCHES_BY_DIM == {112: invocations * 2} and flash_ops.PLAIN_BWD_CALLS == 0
    assert flash_ops.LAUNCHES_BY_DIM == {112: 2 * invocations * 2}
    assert len(calls) == invocations * 2
    for args, grads in calls:
        q, k, v, out, _, dout, causal, window, scale, cap = args
        want = flash_attention_bwd_plain(q.double(), k.double(), v.double(), dout.double(), out.double(),
                                         causal=causal, window=window, scale=scale, logit_softcap=cap)
        agree = bwd_agreement(grads, want)
        assert agree["ok"], agree
    monkeypatch.setattr(flash_ops, "_backward", real)
    want_loss, _, _ = value_and_grad(host, host.params, {"tokens": torch.from_numpy(toks)}, spec)
    assert abs(float(loss) - float(want_loss)) <= 2e-3 * abs(float(want_loss))
    for path, g in got.items():
        parts = g if path.startswith(("groups.", "shared.")) else g[None]
        for i, part in enumerate(parts):
            assert bool(torch.isfinite(part).all()) and float(part.abs().max()) > 0, (path, i)


@pytest.mark.requires_cuda
def test_smoke_mesh_on_the_card_leaves_outputs_bitwise(cuda):
    """launch/mesh.make_smoke_mesh on the card: a (1, 1) DeviceMesh over
    ("data", "model") on a one-process NCCL group; with the specs a prefill
    cell installs (sharding.prefill_specs), reduced dbrx-132b's and
    zamba2-7b's forward and prefill bitwise equal to without them."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding
    from repro_torch.models import shardctx
    from repro_torch.models.common import tree_leaves

    started = not dist.is_initialized()
    mesh = mesh_mod.make_smoke_mesh()
    try:
        assert mesh.device_type == "cuda" and mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and dist.get_backend() == "nccl" and dist.get_world_size() == 1
        for arch in ("dbrx-132b", "zamba2-7b"):
            cfg = reduced_config(get_config(arch))
            gen = torch.Generator(device=cuda)
            gen.manual_seed(1)
            model = Model(cfg).init_params(gen)
            toks = torch.randint(4, cfg.vocab_size, (4, 64), device=cuda, generator=gen, dtype=torch.int32)
            outs = []
            for specs in ({}, sharding.prefill_specs(mesh, cfg)):
                with shardctx.installed(specs, mesh), torch.inference_mode():
                    logits, _ = model({"tokens": toks})
                    last, cache = model.prefill({"tokens": toks})
                outs.append([logits, last] + [t for _, t in tree_leaves(cache)])
            assert len(outs[0]) == len(outs[1])
            for a, b in zip(*outs):
                assert torch.equal(a, b), arch
    finally:
        if started:
            dist.destroy_process_group()
