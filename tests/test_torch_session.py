# The port's Session (on the CPU) against the JAX package's Session: the
# same tables and queries give the same rows, the same plan-cache
# fingerprint, the same planner decision and the same EXPLAIN text; SQL and
# MapReduce share one plan-cache entry; and a Session asked for no device on
# a machine without CUDA refuses to run rather than fall back to the CPU.
# Integers must match exactly; floats within 1e-3 as test_kernels.py's
# _rows_close, plus 1e-5 of the value, since f32 sums near 1e4 taken in
# another order differ by more than 1e-3 absolute.
import numpy as np
import pytest
import torch

import repro
from repro.core.transforms import canonicalize_array_names as jax_canon
from repro.frontends.mapreduce import MapReduceSpec as JaxMR
from repro.frontends.mapreduce import mapreduce_to_forelem as jax_mr
from repro.frontends.sql import sql_to_forelem as jax_sql
from repro.planner import program_fingerprint as jax_fingerprint
import repro_torch
from repro_torch import MapReduceSpec, Session
from repro_torch.core.transforms import canonicalize_array_names
from repro_torch.engine import EngineError
from repro_torch.frontends.mapreduce import mapreduce_to_forelem
from repro_torch.frontends.sql import sql_to_forelem
from repro_torch.planner import program_fingerprint
from test_torch_threads import cap_torch_threads

cap_torch_threads()


def _rows_close(a, b, tol=1e-3, rtol=1e-5):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, int) and isinstance(y, int):
                assert x == y, (ra, rb)
            else:
                assert abs(float(x) - float(y)) <= tol + rtol * abs(float(y)), (ra, rb)


def _tables(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    return {
        "access": dict(
            url=rng.integers(0, 17, n).astype(np.int32),
            latency=rng.gamma(2.0, 30.0, n).astype(np.float32),
        ),
        "t": dict(
            k=rng.integers(0, 50, n).astype(np.int32),
            v=rng.integers(-100, 100, n).astype(np.int32),
            w=rng.normal(size=n).astype(np.float32),
        ),
        "A": dict(
            b_id=rng.integers(0, 12, 300).astype(np.int32),
            f=rng.integers(0, 6, 300).astype(np.int32),
            w=rng.integers(-50, 50, 300).astype(np.int32),
        ),
        "B": dict(
            id=rng.integers(0, 12, 40).astype(np.int32),
            g=rng.integers(0, 5, 40).astype(np.int32),
            v=rng.integers(-30, 30, 40).astype(np.int32),
        ),
    }


def _sessions(tables, **kw):
    js = repro.Session(**kw)
    ts = Session(device="cpu", **kw)
    for name, cols in tables.items():
        js.register(name, **cols)
        ts.register(name, **cols)
    return js, ts


QUERIES = [
    "SELECT url, COUNT(url) FROM access GROUP BY url",
    "SELECT url, SUM(latency) FROM access GROUP BY url",
    "SELECT url, MIN(latency), MAX(latency), AVG(latency) FROM access WHERE latency > 20 GROUP BY url",
    "SELECT url, COUNT(url) AS c FROM access GROUP BY url ORDER BY c DESC LIMIT 3",
    "SELECT SUM(latency) FROM access WHERE url = 3",
    "SELECT k, SUM(v), MIN(v), MAX(w), COUNT(k), AVG(w) FROM t GROUP BY k",
    "SELECT k, SUM(v), MIN(v), MAX(w), COUNT(k), AVG(w) FROM t WHERE v > 10 GROUP BY k",
    "SELECT a.f, b.g FROM A a, B b WHERE a.b_id = b.id",
    "SELECT b.g, COUNT(b.g), SUM(a.w) FROM A a, B b WHERE a.b_id = b.id GROUP BY b.g",
    "SELECT a.f, SUM(b.v) FROM A a, B b WHERE a.b_id = b.id AND a.w > 0 GROUP BY a.f",
]


def _chosen(decision):
    c = decision.chosen
    return (c.order, c.agg_method, c.parallel, c.partition_field, c.join_method, c.fused_aggs)


@pytest.mark.parametrize("n_parts", [1, 4])
@pytest.mark.parametrize("query", QUERIES)
def test_session_matches_jax_session(query, n_parts):
    js, ts = _sessions(_tables(1), n_parts=n_parts)
    jr, tr = js.sql(query), ts.sql(query)
    assert _chosen(tr.decision) == _chosen(jr.decision)
    assert tr.decision.fingerprint == jr.decision.fingerprint
    assert ts.explain(query) == js.explain(query)
    if jr.rows is None:
        assert tr.scalar() == pytest.approx(jr.scalar(), rel=1e-5)
    elif "ORDER BY" in query or "b.g FROM" in query:
        _rows_close(jr.rows, tr.rows)  # ordered output, or join rows in build order
    else:
        _rows_close(sorted(jr.rows), sorted(tr.rows))


@pytest.mark.parametrize(
    "spec", [("count", "url"), ("aggregate", "url", "latency", "+"), ("aggregate", "url", "latency", "max")]
)
def test_mapreduce_shares_the_sql_cache_entry(spec):
    js, ts = _sessions(_tables(2))
    kind, *args = spec
    jspec, tspec = getattr(JaxMR, kind)("access", *args), getattr(MapReduceSpec, kind)("access", *args)
    agg = {"count": "COUNT(url)", "+": "SUM(latency)", "max": "MAX(latency)"}[args[-1] if kind != "count" else kind]
    sql = f"SELECT url, {agg} FROM access GROUP BY url"
    jsql, tsql = js.sql(sql), ts.sql(sql)
    jmr, tmr = js.mapreduce(jspec), ts.mapreduce(tspec)
    assert tsql.cache_hit is False and tmr.cache_hit is True == jmr.cache_hit
    assert len(ts.plan_cache) == len(js.plan_cache) == 1
    _rows_close(sorted(jmr.rows), sorted(tmr.rows))
    _rows_close(sorted(tsql.rows), sorted(tmr.rows))
    assert tmr.decision.fingerprint == jmr.decision.fingerprint == jsql.decision.fingerprint


@pytest.mark.parametrize("query", QUERIES)
def test_program_fingerprint_matches_jax(query):
    schemas = {name: list(cols) for name, cols in _tables(3).items()}
    assert program_fingerprint(canonicalize_array_names(sql_to_forelem(query, schemas))) == (
        jax_fingerprint(jax_canon(jax_sql(query, schemas)))
    )


def test_mapreduce_fingerprint_matches_jax():
    tp = canonicalize_array_names(mapreduce_to_forelem(MapReduceSpec.count("access", "url"), ["url"]))
    jp = jax_canon(jax_mr(JaxMR.count("access", "url"), ["url"]))
    assert program_fingerprint(tp) == jax_fingerprint(jp)


def test_warm_dispatch_and_epoch_invalidation():
    _, ts = _sessions(_tables(4))
    q = "SELECT k, SUM(v) FROM t GROUP BY k"
    r1, r2 = ts.sql(q), ts.sql(q)
    assert r1.dispatch_hit is False and r2.dispatch_hit is True
    ts.register("t", k=np.array([5, 5, 6], np.int32), v=np.array([10, 20, 30], np.int32),
                w=np.zeros(3, np.float32))
    assert len(ts.plan_cache) == 0
    assert sorted(ts.sql(q).rows) == [(5, 30), (6, 30)]


def test_feedback_session_runs():
    js, ts = _sessions(_tables(5), feedback=True)
    q = "SELECT url, COUNT(url) FROM access GROUP BY url"
    _rows_close(sorted(js.sql(q).rows), sorted(ts.sql(q).rows))


def test_reference_backend_agrees():
    tables = _tables(6)
    ts = Session(device="cpu", backend="reference")
    for name, cols in tables.items():
        ts.register(name, **cols)
    _, tt = _sessions(tables)
    q = "SELECT k, MAX(v) FROM t GROUP BY k"
    assert sorted(ts.sql(q).rows) == sorted(tt.sql(q).rows)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineError, match="device='cpu'"):
        Session()
    with pytest.raises(EngineError):
        Session(device="cuda")


@pytest.mark.parametrize("kw", [dict(backend="partitioned"), dict(schedule="guided"), dict(fault="retry")])
def test_unported_hooks_raise(kw):
    """The hooks that raised "not yet ported" until the partitioned backend
    came over now run: each gives the JAX package's rows, and an unknown
    chunk schedule still raises."""
    from repro_torch.sched import RetryPolicy

    if kw.get("fault") == "retry":
        kw = dict(backend="partitioned", fault=RetryPolicy(max_retries=1))
    tables = _tables(12)
    js = repro.Session(**{k: v for k, v in kw.items() if k != "fault"})
    ts = Session(device="cpu", **kw)
    for name, cols in tables.items():
        js.register(name, **cols)
        ts.register(name, **cols)
    q = "SELECT k, SUM(v), MIN(v), COUNT(k) FROM t GROUP BY k"
    assert sorted(ts.sql(q).rows) == sorted(js.sql(q).rows)
    with pytest.raises(EngineError, match="unknown schedule"):
        Session(device="cpu", schedule="not-a-policy")


def test_database_from_columns_matches_jax_epoch():
    tables = _tables(7)
    jdb = repro.Session()
    for name, cols in tables.items():
        jdb.register(name, **cols)
    assert repro_torch.database_from_columns(tables).stats_epoch() == jdb.db.stats_epoch()


def test_cost_model_prices_the_kernel_by_device():
    from repro_torch.planner import CostCoefficients, CostModel, calibrate, collect_stats

    stats = collect_stats(repro_torch.database_from_columns(_tables(9)))
    c = CostCoefficients()
    assert CostModel(stats, device="cuda")._kernel_per_elem() == c.c_kernel
    assert CostModel(stats, device="cuda:1")._kernel_per_elem() == c.c_kernel
    assert CostModel(stats, device="cpu")._kernel_per_elem() == c.c_kernel_fallback
    fitted = calibrate(n_rows=2000, n_keys=16, repeats=1, device="cpu")
    assert fitted.c_dense == c.c_dense and fitted.c_onehot > 0 and fitted.c_sort > 0


# dictionary encoding (the reformat pass) takes a sorted set of an object
# column's strings in place of np.unique's Python comparisons; both give
# the JAX package's dictionary and codes, and other columns take np.unique
DICT_COLUMNS = {
    "urls": np.array([f"http://s{u % 97}.com/p{u}" for u in np.random.default_rng(0).zipf(1.3, 5000) % 3000],
                     dtype=object),
    "odd_strings": np.array(["b", "", "é", "a", "b", "Z", "", "ab"], dtype=object),
    "empty": np.array([], dtype=object),
    "fixed_width": np.array(["x", "yy", "x", "z"]),
    "ints_as_objects": np.array([3, 1, 3, 2], dtype=object),
    "ints": np.array([5, 5, -1, 7], np.int32),
}


@pytest.mark.parametrize("name", sorted(DICT_COLUMNS))
def test_dict_encode_and_nbytes_match_the_references(name):
    from repro.data.multiset import PlainColumn as JaxPlain
    from repro.data.multiset import dict_encode as jax_dict_encode
    from repro_torch.data.multiset import PlainColumn, dict_encode

    values = DICT_COLUMNS[name]
    got, want = dict_encode(values), jax_dict_encode(values)
    assert got.codes.dtype == want.codes.dtype == np.int32
    assert np.array_equal(got.codes, want.codes)
    assert got.dictionary.dtype == want.dictionary.dtype and list(got.dictionary) == list(want.dictionary)
    assert PlainColumn(values).nbytes == JaxPlain(values).nbytes
