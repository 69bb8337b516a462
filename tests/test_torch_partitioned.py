# The port's partitioned backend (repro_torch.backends.partitioned) against
# the JAX package's (repro.backends.partitioned), on the CPU, on the same
# numpy tables: the K × schedule × async × jit matrix, the core join/agg
# shapes, the chunk-kernel bounds (shape buckets, identity padding per
# dtype, the empty table, no recaptures once warm, overflow past the cap,
# eager never captures, the fused 2 against per-aggregate 8 count), the
# presence cache under filters, knobs in the plan-cache fingerprint, worker
# errors, and negative and too-large group keys (C28, C29).
#
# Integers must match exactly (both packages wrap int64 columns to int32);
# floats within test_kernels.py's 1e-3 absolute, plus 1e-5 of the value:
# f32 sums taken in another order differ in the last digits.
import functools

import numpy as np
import pytest

import repro
from repro.backends import CodegenChoices as JChoices
from repro.backends import PartitionedChoices as JPChoices
from repro.backends import ReferenceInterpreter
from repro.backends import get_backend as jget
from repro.backends.partitioned import bucket_rows as jbucket_rows
from repro.data.multiset import Database as JDatabase
from repro.data.multiset import Multiset as JMultiset
from repro.frontends.sql import sql_to_forelem as jsql
import repro_torch
from repro_torch.backends import CodegenChoices, PartitionedChoices, PartitionedPlan, get_backend
from repro_torch.backends.partitioned import BUCKET_MIN, bucket_rows, hash_partition
from repro_torch.data.multiset import database_from_columns
from repro_torch.engine import EngineError
from repro_torch.frontends.sql import sql_to_forelem
from repro_torch.planner import PlanCache
from test_torch_threads import cap_torch_threads

cap_torch_threads()

SCHEMAS = {"A": ["b_id", "f", "w"], "B": ["id", "g", "v"], "t": ["k", "v", "w"]}


def _rows_close(a, b, tol=1e-3, rtol=1e-5):
    assert len(a) == len(b), (len(a), len(b))
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, int) and isinstance(y, int):
                assert x == y, (ra, rb)
            else:
                assert abs(float(x) - float(y)) <= tol + rtol * abs(float(y)), (ra, rb)


def _tables(seed, n_a=400, n_b=40, n_t=3000, dup_build=True, v_dtype=np.int32):
    rng = np.random.default_rng(seed)
    return {
        "A": dict(
            b_id=rng.integers(0, 12, n_a).astype(np.int32),
            f=rng.integers(0, 6, n_a).astype(np.int32),
            w=rng.integers(-50, 50, n_a).astype(np.int32),
        ),
        "B": dict(
            id=(rng.integers(0, 12, n_b) if dup_build else rng.permutation(n_b)).astype(np.int32),
            g=rng.integers(0, 5, n_b).astype(np.int32),
            v=rng.integers(-30, 30, n_b).astype(np.int32),
        ),
        "t": dict(
            k=rng.integers(0, 40, n_t).astype(np.int32),
            v=rng.integers(-1000, 1000, n_t).astype(v_dtype),
            w=rng.normal(size=n_t).astype(np.float32),
        ),
    }


def _jdb(tables):
    db = JDatabase()
    for name, cols in tables.items():
        db.add(JMultiset.from_columns(name, **cols))
    return db


def _both(sql, tables, agg_method="dense", jax_jit=True, **kw):
    """(JAX package's result, port's result, port's plan, JAX package's plan) of one program
    through both partitioned backends with the same choices."""
    jplan = jget("partitioned").compile(
        jsql(sql, SCHEMAS), _jdb(tables),
        JPChoices(base=JChoices(agg_method=agg_method), **{**kw, "jit_chunks": jax_jit}),
    )
    tplan = get_backend("partitioned").compile(
        sql_to_forelem(sql, SCHEMAS), database_from_columns(tables),
        PartitionedChoices(base=CodegenChoices(agg_method=agg_method, device="cpu"), **kw),
    )
    return jplan.run(), tplan.run(), tplan, jplan


def _same(j, t, name="R"):
    jr, tr = j[name], t[name]
    if isinstance(jr, list):
        _rows_close(sorted(jr), sorted(tr))
    else:
        _rows_close([(jr,)], [(tr,)])


# ---------------------------------------------------------------------------
# the K × schedule × async × jit matrix
# ---------------------------------------------------------------------------

MATRIX_SQL = "SELECT k, SUM(v), MIN(v), MAX(w), COUNT(k) FROM t WHERE v > -500 GROUP BY k"


@functools.lru_cache(maxsize=None)
def _jax_matrix(k, schedule):
    """The JAX package's rows and chunk schedule for MATRIX_SQL: neither
    depends on async dispatch or on jit, so one run serves four cases."""
    plan = jget("partitioned").compile(
        jsql(MATRIX_SQL, SCHEMAS), _jdb(_tables(k)),
        JPChoices(base=JChoices(agg_method="dense"), n_partitions=k, schedule=schedule),
    )
    rows = sorted(plan.run()["R"])
    return rows, [(d.op, d.partition, d.rows, d.start) for d in plan.dispatch_log]


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("async_dispatch", [False, True], ids=["serial", "async"])
@pytest.mark.parametrize("schedule", ["static", "fixed", "guided"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_matrix_matches_jax(k, schedule, async_dispatch, jit):
    jrows, jlog = _jax_matrix(k, schedule)
    tplan = _plan(MATRIX_SQL, _tables(k), n_partitions=k, schedule=schedule,
                  async_dispatch=async_dispatch, jit_chunks=jit)
    _rows_close(jrows, sorted(tplan.run()["R"]))
    # the same data distribution and loop schedule: chunk for chunk
    assert [(d.op, d.partition, d.rows, d.start) for d in tplan.dispatch_log] == jlog
    if jit:
        assert all(d.bucket == bucket_rows(d.rows) for d in tplan.dispatch_log)


CORE_QUERIES = [
    "SELECT a.f, b.g FROM A a, B b WHERE a.b_id = b.id",
    "SELECT a.f, b.g FROM A a, B b WHERE a.b_id = b.id AND a.w > 0",
    "SELECT a.f, COUNT(a.f) FROM A a, B b WHERE a.b_id = b.id GROUP BY a.f",
    "SELECT a.f, SUM(b.v) FROM A a, B b WHERE a.b_id = b.id GROUP BY a.f",
    "SELECT b.g, COUNT(b.g), SUM(a.w) FROM A a, B b WHERE a.b_id = b.id GROUP BY b.g",
    "SELECT b.g, MIN(a.w), MAX(b.v) FROM A a, B b WHERE a.b_id = b.id GROUP BY b.g",
    "SELECT a.f, SUM(a.w + b.v) FROM A a, B b WHERE a.b_id = b.id GROUP BY a.f",
    "SELECT SUM(w) FROM t WHERE k = 3",
    "SELECT k, v FROM t WHERE v > 900",
]


@pytest.mark.parametrize("method", ["dense", "kernel"])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("sql", CORE_QUERIES)
def test_core_queries_match_jax(sql, k, method):
    tables = _tables(11)
    j, t, _, _ = _both(sql, tables, agg_method=method, n_partitions=k)
    name = "R" if "R" in j else "scalar"
    if name == "R" and "SUM" not in sql and "COUNT" not in sql and "MIN" not in sql:
        assert t["R"] == j["R"]  # streaming rows: the same order
    _same(j, t, name)


@pytest.mark.parametrize("k", [1, 4])
def test_unique_build_side(k):
    tables = _tables(12, dup_build=False)
    for sql in CORE_QUERIES[:2] + CORE_QUERIES[4:5]:
        j, t, _, _ = _both(sql, tables, n_partitions=k, jit_chunks=True)
        _same(j, t)


def test_member_matches_isin():
    """The sync-free membership test the chunk kernels use for member
    filters, against ``torch.isin``: duplicates, misses, empty sets."""
    import torch

    from repro_torch.backends.torch_vec import _member

    rng = np.random.default_rng(21)
    values = torch.from_numpy(rng.integers(-20, 60, 500).astype(np.int32))
    for members in (rng.integers(0, 40, 30), rng.integers(100, 200, 5), np.array([], np.int64),
                    np.repeat([3, 7], 9)):
        m = torch.from_numpy(members.astype(np.int32))
        assert torch.equal(_member(values, m), torch.isin(values, m))


def test_graph_replays_count_the_launches_they_captured():
    """A launch made while a thread captures is counted into the capture,
    not into LAUNCHES; each replay adds the captured count."""
    from repro_torch.kernels.segreduce import ops

    ops.reset_launches()
    with ops.capturing() as captured:
        ops._count("fused_segreduce")
        ops._count("fused_segreduce")
        ops._count("segreduce")
    assert ops.LAUNCHES == {"fused_segreduce": 0, "segreduce": 0}
    for _ in range(3):
        ops.add_replay(captured)
    ops._count("segreduce")
    assert ops.LAUNCHES == {"fused_segreduce": 6, "segreduce": 4}
    ops.reset_launches()


def test_buckets_match_jax():
    for n in [0, 1, BUCKET_MIN - 1, BUCKET_MIN, BUCKET_MIN + 1, 1500, 4097, 10**5, 7_499_513, 2**24 + 3]:
        assert bucket_rows(n) == jbucket_rows(n)
    vals = np.arange(-50, 5000, dtype=np.int64)
    from repro.backends.partitioned import hash_partition as jhash

    for k in (1, 2, 7, 8):
        assert np.array_equal(hash_partition(vals, k), jhash(vals, k))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
@pytest.mark.parametrize("agg", ["MIN", "MAX", "SUM"])
def test_identity_padding_per_dtype(agg, dtype):
    tables = _tables(13, v_dtype=dtype)
    tables["t"]["v"] = -np.abs(tables["t"]["v"]) - 1  # all negative: zero padding would show in MAX
    sql = f"SELECT k, {agg}(v) FROM t WHERE v < -2 GROUP BY k"
    want = sorted(ReferenceInterpreter(_jdb(tables)).run(jsql(sql, SCHEMAS))["R"])
    for sched in ("static", "fixed", "guided"):
        j, t, _, _ = _both(sql, tables, n_partitions=3, schedule=sched, jit_chunks=True)
        _same(j, t)
        _rows_close(sorted(t["R"]), want)


def test_empty_table():
    tables = {"t": dict(k=np.array([], np.int32), v=np.array([], np.int32), w=np.array([], np.float32))}
    j, t, tplan, _ = _both("SELECT k, SUM(v) FROM t GROUP BY k", tables, n_partitions=4,
                           jit_chunks=True, async_dispatch=True)
    assert t["R"] == j["R"] == []
    assert tplan.dispatch_log == [] and not tplan.runtime_report()["ran"]


def _plan(sql, tables, **kw):
    base = CodegenChoices(agg_method=kw.pop("agg_method", "dense"), device="cpu")
    return get_backend("partitioned").compile(
        sql_to_forelem(sql, SCHEMAS), database_from_columns(tables), PartitionedChoices(base=base, **kw))


def test_no_recaptures_once_warm():
    plan = _plan("SELECT k, SUM(v) FROM t GROUP BY k", _tables(14, n_t=9000), n_partitions=4,
                 schedule="guided", jit_chunks=True)
    plan.run()
    plan.run()  # the presence-cached kernel variant
    warm = plan.jit_stats.compiles
    plan.run()
    plan.run()
    assert plan.jit_stats.compiles == warm and plan.jit_stats.hits > 0
    buckets = {d.bucket for d in plan.dispatch_log if d.bucket}
    assert plan.jit_stats.compiles <= max(1, len(buckets)) * len(plan._kernels)
    assert all(d.bucket >= d.rows for d in plan.dispatch_log)


def test_overflow_past_the_cap_runs_eagerly_and_stays_right():
    tables = _tables(15, n_t=9000)
    plan = _plan("SELECT k, SUM(v) FROM t GROUP BY k", tables, n_partitions=4, schedule="guided",
                 jit_chunks=True, jit_cache_cap=1)
    out = sorted(plan.run()["R"])
    assert plan.jit_stats.overflows > 0
    assert plan.jit_stats.compiles <= len(plan._kernels)
    p = jsql("SELECT k, SUM(v) FROM t GROUP BY k", SCHEMAS)
    assert out == sorted(ReferenceInterpreter(_jdb(tables)).run(p)["R"])


def test_eager_never_captures():
    plan = _plan("SELECT k, SUM(v) FROM t GROUP BY k", _tables(16), n_partitions=4, jit_chunks=False)
    plan.run()
    assert plan.jit_stats.compiles == 0 and plan.jit_stats.hits == 0
    assert all(d.bucket == 0 for d in plan.dispatch_log)


def test_fused_two_against_per_aggregate_eight_compiles():
    """benchmarks/bench_kernels.py's count: a 4-aggregate GROUP BY captures
    one fused kernel per bucket (2) against one kernel per aggregate (8)."""
    rng = np.random.default_rng(7)
    n = 50_000
    tables = {"t": dict(
        k=rng.integers(0, 256, n).astype(np.int32),
        v=rng.integers(-100, 100, n).astype(np.int32),
        w=rng.normal(size=n).astype(np.float32),
    )}
    sql = "SELECT k, SUM(v), SUM(w), MAX(w), MIN(v) FROM t GROUP BY k"
    counts = {}
    for label, method in (("fused", "kernel"), ("per_agg", "dense")):
        kw = dict(n_partitions=4, schedule="static", partition_field=("t", "k"),
                  jit_chunks=True, async_dispatch=False)
        tplan = _plan(sql, tables, agg_method=method, **kw)
        tplan.run()
        jplan = jget("partitioned").compile(jsql(sql, SCHEMAS), _jdb(tables),
                                            JPChoices(base=JChoices(agg_method=method), **kw))
        jplan.run()
        t, j = tplan.runtime_report()["jit"], jplan.runtime_report()["jit"]
        assert {x: t[x] for x in ("kernels", "buckets", "compiles", "hits")} == {
            x: j[x] for x in ("kernels", "buckets", "compiles", "hits")}
        counts[label] = t["compiles"]
    assert counts == {"fused": 2, "per_agg": 8}


def test_presence_cache_respects_filters():
    kk = np.array([0, 0, 1, 2, 2, 3], np.int32)
    v = np.array([5, 7, -9, 2, 4, -100], np.int32)
    tables = {"t": dict(k=kk, v=v, w=np.zeros(6, np.float32))}
    db = database_from_columns(tables)
    pu = sql_to_forelem("SELECT k, SUM(v) FROM t GROUP BY k", SCHEMAS)
    pf = sql_to_forelem("SELECT k, SUM(v) FROM t WHERE v > 0 GROUP BY k", SCHEMAS)
    cpu = CodegenChoices(device="cpu")
    plan = PartitionedPlan(pu, db, PartitionedChoices(base=cpu, n_partitions=2))
    for _ in range(2):
        assert sorted(plan.run()["R"]) == [(0, 12), (1, -9), (2, 6), (3, -100)]
    planf = PartitionedPlan(pf, db, PartitionedChoices(base=cpu, n_partitions=2))
    for _ in range(2):  # the second run takes any cached-presence path
        assert sorted(planf.run()["R"]) == [(0, 12), (2, 6)]


def test_knobs_in_plan_cache_fingerprint():
    cols = dict(url=np.random.default_rng(17).integers(0, 8, 300).astype(np.int32))
    q = "SELECT url, COUNT(url) FROM logs GROUP BY url"
    cache = PlanCache()
    s1 = repro_torch.Session(device="cpu", backend="partitioned", plan_cache=cache,
                             jit_chunks=True, async_dispatch=True).register("logs", **cols)
    s2 = repro_torch.Session(device="cpu", backend="partitioned", plan_cache=cache,
                             jit_chunks=False, async_dispatch=False).register("logs", **cols)
    r1, r2 = s1.sql(q), s2.sql(q)
    assert r1.rows == r2.rows
    assert r1.plan.choices.jit_chunks is True and r2.plan.choices.jit_chunks is False
    assert r1.plan.choices.async_dispatch is True and r2.plan.choices.async_dispatch is False


def test_worker_errors_propagate():
    plan = _plan("SELECT k, SUM(v) FROM t GROUP BY k", _tables(18), n_partitions=4,
                 schedule="fixed", async_dispatch=True)

    def bad_work(ch):
        raise RuntimeError("chunk failed")

    chunks = plan._chunks(plan._layout("t", None), "agg:x")
    with pytest.raises(RuntimeError, match="chunk failed"):
        plan._dispatch(chunks, bad_work)


def test_session_partitioned_matches_jax_session():
    tables = _tables(19)
    js = repro.Session(backend="partitioned", n_partitions=4, schedule="guided")
    ts = repro_torch.Session(device="cpu", backend="partitioned", n_partitions=4, schedule="gss")
    for name, cols in tables.items():
        js.register(name, **cols)
        ts.register(name, **cols)
    for q in (MATRIX_SQL, CORE_QUERIES[4], CORE_QUERIES[8]):
        jr, tr = js.sql(q), ts.sql(q)
        _rows_close(sorted(jr.rows), sorted(tr.rows))
        assert tr.plan.k == jr.plan.k == 4 and tr.plan.choices.schedule == "guided"
    assert "achieved_imbalance=" in ts.explain(MATRIX_SQL, analyze=True)
    with pytest.raises(EngineError, match="unknown schedule"):
        repro_torch.Session(device="cpu", schedule="round-robin")


def test_planner_picks_the_same_k_and_schedule():
    tables = _tables(20, n_t=20_000)
    js, ts = repro.Session(backend="partitioned"), repro_torch.Session(device="cpu", backend="partitioned")
    for name, cols in tables.items():
        js.register(name, **cols)
        ts.register(name, **cols)
    jr, tr = js.sql(MATRIX_SQL), ts.sql(MATRIX_SQL)
    assert (tr.plan.k, tr.plan.choices.schedule) == (jr.plan.k, jr.plan.choices.schedule)
    _rows_close(sorted(jr.rows), sorted(tr.rows))


# ---------------------------------------------------------------------------
# C28: negative group keys; C29: group keys past int32
# ---------------------------------------------------------------------------


def _negative_keys():
    rng = np.random.default_rng(28)
    return {"t": dict(k=rng.integers(-5, 40, 2000).astype(np.int32),
                      v=rng.integers(-100, 100, 2000).astype(np.int32),
                      w=rng.normal(size=2000).astype(np.float32))}


@pytest.mark.parametrize("method", ["dense", "onehot", "sort", "kernel"])
def test_negative_keys_dropped_as_the_jax_backend_drops_them(method):
    """The JAX package's 'jax' backend returns no group for a negative key
    (its segment ops drop the rows; its ReferenceInterpreter would keep
    them: 45 groups against 40); the port does the same in every method,
    monolithic and partitioned."""
    tables = _negative_keys()
    q = "SELECT k, SUM(v), MIN(w), COUNT(k) FROM t GROUP BY k"
    js = repro.Session()
    ts = repro_torch.Session(device="cpu")
    for s in (js, ts):
        s.register("t", **tables["t"])
    _rows_close(sorted(js.sql(q).rows), sorted(ts.sql(q).rows))  # the planner's method
    from repro.core import OptimizeOptions as JOpts
    from repro.core import optimize as joptimize
    from repro_torch.core import OptimizeOptions, optimize

    jres = joptimize(jsql(q, SCHEMAS), _jdb(tables), JOpts(agg_method=method, reformat=False))
    tres = optimize(sql_to_forelem(q, SCHEMAS), database_from_columns(tables),
                    OptimizeOptions(agg_method=method, reformat=False, device="cpu"))
    jrows, trows = sorted(jres.plan.run()["R"]), sorted(tres.plan.run()["R"])
    assert len(jrows) == 40 and all(r[0] >= 0 for r in jrows)
    _rows_close(jrows, trows)
    j, t, _, _ = _both(q, tables, agg_method=method, n_partitions=4, jit_chunks=True)
    _rows_close(sorted(j["R"]), sorted(t["R"]))
    _rows_close(sorted(t["R"]), trows)
    interp = ReferenceInterpreter(_jdb(tables)).run(jsql(q, SCHEMAS))["R"]
    assert len(interp) == 45


@pytest.mark.parametrize("backend", ["torch", "partitioned"])
def test_group_keys_past_int32_raise_overflow_as_the_jax_package_does(backend):
    """The JAX package's 'jax' backend raises OverflowError before any
    work; both of the port's backends raise it too, before allocating a
    table of 2^33 keys (the JAX package's own partitioned backend would
    allocate its 34 GB table, so it is not run here)."""
    tables = {"t": dict(k=np.array([1, 2, 2**33 + 10], np.int64), v=np.ones(3, np.int32),
                        w=np.zeros(3, np.float32))}
    q = "SELECT k, SUM(v) FROM t GROUP BY k"
    js = repro.Session(backend="jax")
    ts = repro_torch.Session(device="cpu", backend=backend)
    for s in (js, ts):
        s.register("t", **tables["t"])
    with pytest.raises(OverflowError):
        js.sql(q)
    with pytest.raises(OverflowError):
        ts.sql(q)


@pytest.mark.parametrize("method", ["dense", "kernel"])
@pytest.mark.parametrize("k", [2, 4])
def test_signed_zero_merge_matches_jax(k, method):
    """MAX and MIN merge the partitions' partials with -0.0 below +0.0 and
    a NaN winning, as the JAX package does (ROADMAP C34): key 0 meets -0.0
    first and key 1 +0.0, each in another partition than its second row
    (the rows are partitioned by w, which differs in every row)."""
    q = "SELECT k, MAX(v), MIN(v) FROM t GROUP BY k"
    for v in ([-0.0, 0.0, 0.0, -0.0], [-0.0, np.nan, 0.0, -0.0]):
        tables = {"t": dict(k=np.array([0, 0, 1, 1], np.int32), v=np.array(v, np.float32),
                            w=np.arange(4, dtype=np.int32))}
        j, t, tplan, _ = _both(q, tables, agg_method=method, n_partitions=k, partition_field=("t", "w"))
        assert len({d.partition for d in tplan.dispatch_log}) >= 2
        bits = [[(x if isinstance(x, int) else ("nan" if np.isnan(x) else (bool(np.signbit(x)), x))) for x in r]
                for r in sorted(t["R"])]
        assert bits == [[(x if isinstance(x, int) else ("nan" if np.isnan(x) else (bool(np.signbit(x)), x)))
                         for x in r] for r in sorted(j["R"])]
        assert bits[1] == [1, (False, 0.0), (True, -0.0)]
