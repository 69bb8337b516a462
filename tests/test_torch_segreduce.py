# The port's segmented-reduction wrappers against the JAX package's: the
# plain PyTorch version (what the wrappers run for CPU tensors) against the
# Pallas kernel in interpret mode and the jnp fallback, over the fused
# differential matrix of test_kernels.py — query ops {SUM, COUNT, MIN, MAX,
# AVG} × {int32, f32} × {unfiltered, filtered} × {empty table, empty groups,
# single tile, multi tile} — plus bf16 accumulation, the int32 edge cases and
# partial-merge associativity.  Inputs are numpy, made from a seed, and go
# through both packages.  Integers must match exactly; floats within
# rtol 1e-5 / atol 1e-5, because the two sum in different orders.  The CUDA
# kernel itself is held against the plain version by test_torch_cuda.py and
# chip_smoke.py on the card.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.segreduce.kernel import fused_segreduce_pallas, segreduce_pallas
from repro.kernels.segreduce.ref import fused_segreduce_ref as jax_fused_ref
from repro_torch.kernels.segreduce import kernel as cuda_kernel
from repro_torch.kernels.segreduce import ops
from repro_torch.kernels.segreduce.ref import op_identity
from test_torch_threads import cap_torch_threads

cap_torch_threads()

# (n rows, num_keys, key range) — the reference kernel's row tile is 1024,
# so multi_tile spans 5 of its tiles; empty_groups leaves keys [8, 64) empty
_SHAPES = {
    "empty_table": (0, 16, 16),
    "empty_groups": (200, 64, 8),
    "single_tile": (300, 16, 16),
    "multi_tile": (5000, 16, 16),
}
_MERGE = {"sum": np.add, "max": np.maximum, "min": np.minimum}
_TOL = dict(rtol=1e-5, atol=1e-5)


def _lowering(qop, vals):
    """One query-level aggregate as kernel (columns, ops), as the SQL
    frontend lowers it: COUNT is a sum of ones, AVG a SUM/COUNT pair."""
    ones = np.ones(vals.shape[0], np.int32)
    return {
        "SUM": ([vals], ["sum"]),
        "COUNT": ([ones], ["sum"]),
        "MIN": ([vals], ["min"]),
        "MAX": ([vals], ["max"]),
        "AVG": ([vals, ones], ["sum", "sum"]),
    }[qop]


def _inputs(seed, shape, dtype, filtered):
    rng = np.random.default_rng(seed)
    n, num_keys, key_range = _SHAPES[shape]
    keys = rng.integers(0, key_range, n).astype(np.int32)
    if dtype == "int32":
        vals = rng.integers(-50, 50, n).astype(np.int32)
    else:
        vals = rng.normal(size=n).astype(np.float32)
    mask = rng.integers(0, 2, n).astype(bool) if filtered else np.ones(n, bool)
    return keys, vals, mask, num_keys


def _port(keys, cols, ops_, num_keys, mask):
    accs, pres = ops.fused_segreduce(
        torch.from_numpy(keys),
        tuple(torch.from_numpy(c) for c in cols),
        tuple(ops_),
        num_keys,
        mask=torch.from_numpy(mask),
    )
    return [a.numpy() for a in accs], pres.numpy()


def _jax(impl, keys, cols, ops_, num_keys, mask):
    fn = fused_segreduce_pallas if impl == "pallas" else jax_fused_ref
    kwargs = {"interpret": True} if impl == "pallas" else {}
    accs, pres = fn(
        jnp.asarray(keys), tuple(jnp.asarray(c) for c in cols), tuple(ops_), num_keys,
        mask=jnp.asarray(mask), **kwargs,
    )
    return [np.asarray(a) for a in accs], np.asarray(pres)


def _assert_same(got, want, dtype):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), **_TOL)


@pytest.mark.parametrize("shape", list(_SHAPES))
@pytest.mark.parametrize("filtered", [False, True], ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("qop", ["SUM", "COUNT", "MIN", "MAX", "AVG"])
def test_fused_matrix_matches_jax(qop, dtype, filtered, shape):
    keys, vals, mask, num_keys = _inputs(11, shape, dtype, filtered)
    cols, ops_ = _lowering(qop, vals)
    got, got_pres = _port(keys, cols, ops_, num_keys, mask)
    for impl in ("pallas", "jnp"):
        want, want_pres = _jax(impl, keys, cols, ops_, num_keys, mask)
        np.testing.assert_array_equal(got_pres, want_pres)
        for g, w, c in zip(got, want, cols):
            assert g.dtype == c.dtype
            _assert_same(g, w, c.dtype)


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_bf16_accumulates_in_f32_like_pallas(op):
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 33, 700).astype(np.int32)
    vals = rng.normal(size=700).astype(np.float32)
    mask = rng.integers(0, 3, 700) > 0
    (got,), _ = ops.fused_segreduce(
        torch.from_numpy(keys), (torch.from_numpy(vals).to(torch.bfloat16),), (op,), 33,
        mask=torch.from_numpy(mask),
    )
    (want,), _ = fused_segreduce_pallas(
        jnp.asarray(keys), (jnp.asarray(vals).astype(jnp.bfloat16),), (op,), 33,
        mask=jnp.asarray(mask), interpret=True,
    )
    assert got.dtype == torch.bfloat16
    # both accumulate in f32 and round once to bf16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2
    )


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_single_op_matches_segreduce_pallas(op, dtype):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 40, 3000).astype(np.int32)
    vals = (rng.integers(-9, 9, 3000) if dtype == "int32" else rng.normal(size=3000)).astype(dtype)
    got = ops.segreduce(torch.from_numpy(keys), torch.from_numpy(vals), 41, op=op).numpy()
    want = np.asarray(segreduce_pallas(jnp.asarray(keys), jnp.asarray(vals), 41, op=op))
    _assert_same(got, want, vals.dtype)


def test_int32_sum_wraps_and_extremes_survive():
    keys = torch.tensor([0, 0, 1, 1, 2], dtype=torch.int32)
    vals = torch.tensor([2**31 - 1, 5, -(2**31) + 5, 7, -3], dtype=torch.int32)
    (s, mx, mn), pres = ops.fused_segreduce(keys, (vals, vals, vals), ("sum", "max", "min"), 4)
    (js, jmx, jmn), jpres = fused_segreduce_pallas(
        jnp.asarray(keys.numpy()), (jnp.asarray(vals.numpy()),) * 3, ("sum", "max", "min"), 4,
        interpret=True,
    )
    for got, want in ((s, js), (mx, jmx), (mn, jmn), (pres, jpres)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert s.tolist()[0] == -(2**31) + 4  # wrapped, as JAX's int32
    assert mx.tolist()[3] == torch.iinfo(torch.int32).min == op_identity("max", torch.int32)


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_partial_merge_associativity(n_chunks):
    """Split the rows into chunks, reduce each, merge every accumulator
    under its own op and presence under +: the whole-table result, and the
    JAX package's whole-table result."""
    rng = np.random.default_rng(7)
    n, num_keys = 3000, 32
    keys = rng.integers(0, num_keys, n).astype(np.int32)
    vi = rng.integers(-100, 100, n).astype(np.int32)
    vf = rng.normal(size=n).astype(np.float32)
    mask = rng.integers(0, 3, n) > 0
    cols, ops_ = [vi, vf, vi], ["sum", "max", "min"]
    bounds = np.linspace(0, n, n_chunks + 1).astype(int)
    accs, pres = [None] * 3, None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part, ppres = _port(keys[lo:hi], [c[lo:hi] for c in cols], ops_, num_keys, mask[lo:hi])
        for i, op in enumerate(ops_):
            accs[i] = part[i] if accs[i] is None else _MERGE[op](accs[i], part[i])
        pres = ppres if pres is None else pres + ppres
    want, want_pres = _jax("pallas", keys, cols, ops_, num_keys, mask)
    np.testing.assert_array_equal(pres, want_pres)
    for got, w, c in zip(accs, want, cols):
        _assert_same(got, w, c.dtype)


def test_wrappers_reject_bad_inputs():
    keys = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.fused_segreduce(keys, (torch.zeros(4),), ("sum", "max"), 2)
    with pytest.raises(ValueError):
        ops.fused_segreduce(keys, (torch.zeros(3),), ("sum",), 2)
    with pytest.raises(ValueError):
        ops.segreduce(keys, torch.zeros(4), 2, op="mean")
    with pytest.raises(ValueError):
        ops.segreduce(keys, torch.zeros(4), 0)


def test_cpu_tensors_launch_nothing():
    ops.reset_launches()
    ops.fused_segreduce(torch.zeros(4, dtype=torch.int32), (torch.ones(4),), ("sum",), 1)
    ops.segreduce(torch.zeros(4, dtype=torch.int32), torch.ones(4), 1)
    assert ops.LAUNCHES == {"fused_segreduce": 0, "segreduce": 0}


def test_table_layout_regimes():
    """With a float sum, small key spaces keep W per-warp tables of every key
    in shared memory; large ones are cut into key ranges of a power of two
    of keys (16-bit key offsets) whose tables fit there, with every key in
    some range and every row in some tile."""
    smem, n_sms = 232_448, 132
    lay = cuda_kernel.table_layout(5000, 100, 2, smem, n_sms)
    assert lay.regime == 0 and lay.n_warps * lay.rows_per_warp >= 5000 and lay.rows_per_warp % 32 == 0
    assert lay.n_warps % cuda_kernel.WARPS_PER_BLOCK == 0
    for n, k, tables in [(60_000_000, 100_001, 2), (8_000_000, 2_000_001, 2), (1, 5000, 17),
                         (3_000_000, 2_000_001, 17)]:
        lay = cuda_kernel.table_layout(n, k, tables, smem, n_sms)
        assert lay.regime == 1 and lay.keys_per_bucket == 1 << lay.bucket_shift <= 1 << 16
        assert (lay.n_buckets - 1) * lay.keys_per_bucket < k <= lay.n_buckets * lay.keys_per_bucket
        assert lay.reduce_warps * tables * lay.keys_per_bucket * 4 <= smem       # the fold's tables
        assert cuda_kernel.ordered_scatter_smem_bytes(lay.n_buckets) <= smem  # the scatter's arrays
        assert lay.n_buckets < 1 << 16                                         # 16-bit range ids
        assert lay.n_tiles * cuda_kernel.TILE_ROWS >= n and lay.piece_rows == cuda_kernel.PIECE_ROWS
        assert 1 <= lay.n_blocks <= cuda_kernel.max_pieces(n, lay.n_buckets)
        assert lay.small == (n * lay.n_buckets <= cuda_kernel.SMALL_READS) and lay.scratch_words == 0
        assert cuda_kernel.ordered_fold_smem_bytes(lay.reduce_warps, tables, lay.bucket_shift,
                                                   lay.n_buckets) <= smem
    # two fold blocks of eight warps an SM while the ranges fit the scatter
    lay = cuda_kernel.table_layout(60_000_000, 100_001, 2, smem, n_sms)
    assert (lay.reduce_warps, lay.keys_per_bucket, lay.n_buckets) == (8, 1024, 98)
    assert cuda_kernel.table_layout(0, 1, 2, smem, n_sms).n_warps == cuda_kernel.WARPS_PER_BLOCK
    # without a float sum every op is exact in any order: tables of every
    # key in shared memory for small K, a partition by key range past them
    # (atomics straight into the outputs for one table, or where the rows
    # are fewer than the keys)
    for n, k, tables in [(15_000_000, 1_500_000, 2), (8_000_000, 2_000_001, 2), (60_000_000, 100_001, 8)]:
        lay = cuda_kernel.table_layout(n, k, tables, smem, n_sms, float_sum=False)
        assert lay.regime == 3 and lay.keys_per_bucket == 1 << lay.bucket_shift <= 1 << 16
        assert (lay.n_buckets - 1) * lay.keys_per_bucket < k <= lay.n_buckets * lay.keys_per_bucket
        assert lay.n_buckets >= 2 * n_sms and lay.n_tiles * cuda_kernel.PART_TILE >= n
        assert tables * lay.keys_per_bucket * 4 <= smem // 4          # the fold's tables
        assert lay.n_buckets * 4 <= smem                             # the histogram's counts
        assert cuda_kernel.part_scatter_smem_bytes(lay.n_buckets) <= smem
        assert lay.n_buckets < 0xFFFF                                # 16-bit range ids
        assert lay.scratch_words == 0
    lay = cuda_kernel.table_layout(100, 100, 2, smem, n_sms, float_sum=False)
    assert lay.regime == 2 and lay.atomic_smem and lay.n_blocks >= 1 and lay.scratch_words == 0
    for n, k, tables in [(0, 100_001, 2), (1, 100_001, 2), (5000, 2_000_001, 8), (15_000_000, 1_500_001, 1)]:
        lay = cuda_kernel.table_layout(n, k, tables, smem, n_sms, float_sum=False)
        assert lay.regime == 2 and not lay.atomic_smem and lay.n_blocks >= 1
    for k in (1, 100, 7264):  # the last key space whose two tables fit a quarter of shared memory
        assert cuda_kernel.table_layout(60_000_000, k, 2, smem, n_sms, float_sum=False).atomic_smem
    assert cuda_kernel.table_layout(8000, 7265, 2, smem, n_sms, float_sum=False).regime == 3
    with pytest.raises(ValueError):
        cuda_kernel.table_layout(10, 2**31 - 1, 17, smem, n_sms)


def test_variant_builds_another_source_behind_the_same_binding(tmp_path):
    """_build.variant: another source of a kernel (an earlier version, timed
    beside it) under its own name, bound like the kernel unless told
    otherwise, built nowhere until it is loaded."""
    from repro_torch.kernels import _build

    older = tmp_path / "older.cu"
    older.write_text("// an earlier version\n")
    lib = _build.variant(cuda_kernel.LIBRARY, "segreduce_older", older)
    assert lib.source == older and lib.configure is cuda_kernel.LIBRARY.configure
    assert lib.path().name.startswith("segreduce_older-") and lib.path() != cuda_kernel.LIBRARY.path()
    assert not lib.path().exists()
    bind_less = _build.variant(cuda_kernel.LIBRARY, "segreduce_older", older, configure=print)
    assert bind_less.configure is print


def test_ordered_layout_takes_one_launch_up_to_small_limit():
    """Regime 1 takes its one-launch path while N rows times R ranges is at
    most SMALL_READS (N = 0 included) and the partition past it, for every
    key space it serves."""
    smem, n_sms = 232_448, 132
    for k, tables in [(3633, 2), (100_001, 2), (100_001, 17), (2_000_001, 2)]:
        n_buckets = cuda_kernel.table_layout(0, k, tables, smem, n_sms).n_buckets
        limit = cuda_kernel.small_limit(n_buckets)
        assert limit * n_buckets <= cuda_kernel.SMALL_READS < (limit + 1) * n_buckets
        for n in (0, 1, limit - 1, limit):
            lay = cuda_kernel.table_layout(n, k, tables, smem, n_sms)
            assert lay.regime == 1 and lay.small and lay.n_buckets == n_buckets
            assert cuda_kernel.scratch(lay, n, tables - 1, tables) == {}
        for n in (limit + 1, 60_000_000):
            lay = cuda_kernel.table_layout(n, k, tables, smem, n_sms)
            assert lay.regime == 1 and not lay.small
    assert cuda_kernel.table_layout(1, 3632, 2, smem, n_sms).regime == 0  # the last K of regime 0 at two tables


def test_ordered_scratch_words():
    """Regime 1's scratch for N rows over R ranges: the counters (range and
    piece starts, the fold's ticket, a counter a node of the tiles' prefix
    tree above its leaves, a counter a piece), the prefix tree (R words a
    node), a 16-bit key offset a row, a word a row and value column, and a
    folded table a piece; sized by N, never by the rows the mask keeps,
    since a captured graph cannot learn those."""
    import torch

    smem, n_sms = 232_448, 132
    n, k, n_values = 59_996_105, 100_001, 1
    lay = cuda_kernel.table_layout(n, k, n_values + 1, smem, n_sms)
    pieces = -(-n // cuda_kernel.PIECE_ROWS) + lay.n_buckets
    assert cuda_kernel.max_pieces(n, lay.n_buckets) == pieces
    levels = cuda_kernel.tile_levels(lay.n_tiles)
    assert levels == [14648, 458, 15, 1]  # tiles of 4096 rows, 32 children a node
    assert cuda_kernel.tile_levels(1) == [1] and cuda_kernel.tile_levels(33) == [33, 2, 1]
    assert cuda_kernel.scratch(lay, n, n_values, n_values + 1) == {
        "part_ranges": (2 * lay.n_buckets + 3 + 458 + 15 + 1 + pieces, torch.int32),
        "tile_prefix": (sum(levels) * lay.n_buckets, torch.int32),
        "part_off": (n, torch.int16),
        "part_vals": (n_values * n, torch.int32),
        "partials": (pieces * (n_values + 1) * lay.keys_per_bucket, torch.int32),
    }
    # the key words are 16-bit: 2 + 4 bytes a row for one value column, where
    # the partition of earlier sources kept 4 + 4
    words = cuda_kernel.scratch(lay, n, n_values, n_values + 1)
    per_row = sum(c * d.itemsize for f, (c, d) in words.items() if f in ("part_off", "part_vals")) / n
    assert per_row == 6
    # regimes 2 and 0 as before: none, and regime 0's per-block tables
    assert cuda_kernel.scratch(cuda_kernel.table_layout(100, 100, 2, smem, n_sms, float_sum=False), 100, 1, 2) == {}
    lay0 = cuda_kernel.table_layout(5000, 100, 2, smem, n_sms)
    assert cuda_kernel.scratch(lay0, 5000, 1, 2) == {"scratch": (lay0.scratch_words, torch.int32)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_piece_cuts_of_skewed_counts(seed):
    """The fold's pieces over a Zipf-skewed count vector (s = 1.1 over
    100,000 keys, 60M rows, ranges of 1024 keys): each holds at most
    PIECE_ROWS rows, together they cover every row once in order, an empty
    range still gets one piece (for its identities), the count of pieces
    stays under max_pieces, and the cuts depend on the counts alone."""
    rng = np.random.default_rng(seed)
    n, n_keys, width = 60_000_000, 100_000, 1024
    w = 1.0 / np.arange(1, n_keys + 1) ** 1.1
    per_key = rng.multinomial(n, w / w.sum())[rng.permutation(n_keys)]
    per_range = np.add.reduceat(per_key, np.arange(0, n_keys, width)).tolist()
    per_range[3] = 0  # an empty range
    cuts = cuda_kernel.piece_cuts(per_range)
    rows = sum(per_range)
    assert max(per_range) > 10 * cuda_kernel.PIECE_ROWS  # the skew forces pieces
    assert all(hi - lo <= cuda_kernel.PIECE_ROWS for _, lo, hi in cuts)
    assert [lo for _, lo, _ in cuts[1:]] == [hi for _, _, hi in cuts[:-1]]  # contiguous
    assert cuts[0][1] == 0 and cuts[-1][2] == rows                       # every row once
    assert [b for b, _, _ in cuts] == sorted(b for b, _, _ in cuts)      # range by range
    assert sum(1 for b, _, _ in cuts if b == 3) == 1
    assert len(cuts) <= cuda_kernel.max_pieces(rows, len(per_range))
    assert cuda_kernel.piece_cuts(list(per_range)) == cuts
    # a range's pieces differ by at most one row
    for b in set(b for b, _, _ in cuts):
        sizes = [hi - lo for bb, lo, hi in cuts if bb == b]
        assert max(sizes) - min(sizes) <= 1



@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", ["zeros", "nan"])
def test_signed_zero_and_nan_match_jax_bitwise(case, dtype):
    """MAX and MIN order -0.0 below +0.0 and let a NaN win whatever the
    order of the rows (ROADMAP C34), as the Pallas kernel, the jnp fallback
    and the CUDA kernel do: bit for bit, a NaN against a NaN."""
    v = [-0.0, 0.0, 0.0, -0.0] + ([np.nan, 1.0, 2.0, np.nan] if case == "nan" else [])
    keys = np.array([0, 0, 1, 1, 2, 2, 3, 3][: len(v)], np.int32)
    vals = np.array(v, np.float32)
    K = int(keys.max()) + 2  # the last key empty: its identity
    tvals = torch.from_numpy(vals).to(getattr(torch, dtype))
    jvals = jnp.asarray(vals).astype(getattr(jnp, dtype))
    for op in ("max", "min"):
        (got,), _ = ops.fused_segreduce(torch.from_numpy(keys), (tvals,), (op,), K)
        single = ops.segreduce(torch.from_numpy(keys), tvals, K, op=op)
        for jax_fn in (lambda: fused_segreduce_pallas(jnp.asarray(keys), (jvals,), (op,), K, interpret=True)[0][0],
                       lambda: jax_fused_ref(jnp.asarray(keys), (jvals,), (op,), K)[0][0]):
            want = np.asarray(jax_fn(), np.float32)
            for g in (got, single):
                g = g.float().numpy()
                assert np.array_equal(np.isnan(g), np.isnan(want)), (op, g, want)
                ok = ~np.isnan(want)
                assert np.array_equal(np.signbit(g[ok]), np.signbit(want[ok])) and np.array_equal(g[ok], want[ok]), (
                    op, g, want)
        if case == "zeros":
            assert list(np.signbit(got.float().numpy()[:2])) == [op == "min"] * 2
