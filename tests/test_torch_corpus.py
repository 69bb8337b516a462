# The join/agg programs of tests/test_engine.py and tests/test_join_agg.py
# (32 programs, each on the data its reference test draws, and 7 of them in
# each of the four agg methods, as test_join_agg.py runs them) through both
# packages, on the CPU: the
# vectorized backend ('jax' against the port's 'torch') with the cost
# planner, and the partitioned backend at K = 4 under 'static' chunks; the
# agg-method variants through optimize() with the method pinned.  Integers
# must match exactly; floats within test_kernels.py's 1e-3 absolute, plus
# 1e-5 of the value (f32 sums in another order).
import numpy as np
import pytest

import repro
from repro.core import OptimizeOptions as JOptions
from repro.core import optimize as joptimize
from repro.data.multiset import Database as JDatabase
from repro.data.multiset import Multiset as JMultiset
from repro.frontends.mapreduce import MapReduceSpec as JMR
from repro.frontends.sql import sql_to_forelem as jsql
import repro_torch
from repro_torch import MapReduceSpec
from repro_torch.core import OptimizeOptions, optimize
from repro_torch.data.multiset import database_from_columns
from repro_torch.frontends.sql import sql_to_forelem
from test_torch_threads import cap_torch_threads

cap_torch_threads()

i32 = np.int32


def _rows_close(a, b, tol=1e-3, rtol=1e-5):
    assert len(a) == len(b), (len(a), len(b))
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, int) and isinstance(y, int):
                assert x == y, (ra, rb)
            else:
                assert abs(float(x) - float(y)) <= tol + rtol * abs(float(y)), (ra, rb)


# -- the data of each program, as the reference files draw it ---------------

def _web():
    rng = np.random.default_rng(0)
    return {"access": dict(url=rng.integers(0, 17, 800).astype(i32),
                           latency=rng.gamma(2.0, 30.0, 800).astype(np.float32))}


def _ab(dup_build=True, seed=1):
    rng = np.random.default_rng(seed)
    n_b = 40
    return {
        "A": dict(b_id=rng.integers(0, 12 if dup_build else n_b, 120).astype(i32),
                  f=rng.integers(0, 6, 120).astype(i32), w=rng.integers(-50, 50, 120).astype(i32)),
        "B": dict(id=(rng.integers(0, 12, n_b) if dup_build else rng.permutation(n_b)).astype(i32),
                  g=rng.integers(0, 5, n_b).astype(i32), v=rng.integers(-30, 30, n_b).astype(i32)),
    }


def _negative_t():
    rng = np.random.default_rng(2)
    return {"t": dict(k=rng.integers(0, 8, 400).astype(i32), v=rng.integers(-100, -1, 400).astype(i32))}


def _emptied_t():
    return {"t": dict(k=np.array([0, 0, 1, 1, 2, 3, 3], i32), v=np.array([5, -7, 9, 2, -4, 100, 100], i32))}


def _small_t():
    rng = np.random.default_rng(3)
    return {"t": dict(k=rng.integers(0, 5, 200).astype(i32), v=rng.integers(1, 50, 200).astype(i32),
                      w=rng.normal(size=200).astype(np.float32))}


def _padded_t():
    rng = np.random.default_rng(4)
    return {"t": dict(k=rng.integers(0, 6, 301).astype(i32), v=rng.integers(-80, -20, 301).astype(i32))}


def _empty_build():
    rng = np.random.default_rng(5)
    return {"A": dict(b_id=rng.integers(0, 5, 20).astype(i32), f=rng.integers(0, 4, 20).astype(i32),
                      w=rng.integers(-9, 9, 20).astype(i32)),
            "B": dict(id=np.array([], i32), g=np.array([], i32), v=np.array([], i32))}


def _no_match():
    rng = np.random.default_rng(6)
    return {"A": dict(b_id=(100 + rng.integers(0, 5, 20)).astype(i32), f=rng.integers(0, 4, 20).astype(i32),
                      w=np.zeros(20, i32)),
            "B": dict(id=rng.integers(0, 5, 10).astype(i32), g=rng.integers(0, 4, 10).astype(i32),
                      v=np.zeros(10, i32))}


def _emptied_join():
    return {"A": dict(b_id=np.array([0, 0, 1, 1], i32), f=np.array([0, 0, 1, 1], i32),
                      w=np.array([5, 6, -5, -6], i32)),
            "B": dict(id=np.array([0, 1], i32), g=np.array([0, 1], i32), v=np.array([10, 20], i32))}


def _unmatched_group():
    return {"A": dict(b_id=np.array([0, 0], i32), f=np.array([1, 2], i32), w=np.array([3, 4], i32)),
            "B": dict(id=np.array([0, 7], i32), g=np.array([0, 9], i32), v=np.array([1, 1], i32))}


# (id, data, query): a SQL string, or ("mr", MapReduceSpec constructor, args)
JOIN = "SELECT a.f, b.g FROM A a, B b WHERE a.b_id = b.id"
PROGRAMS = [
    ("count", _web, "SELECT url, COUNT(url) FROM access GROUP BY url"),
    ("count_mr", _web, ("mr", "count", ("access", "url"))),
    ("sum", _web, "SELECT url, SUM(latency) FROM access GROUP BY url"),
    ("sum_mr", _web, ("mr", "aggregate", ("access", "url", "latency", "+"))),
    ("scalar", _web, "SELECT SUM(latency) FROM access WHERE url = 3"),
    ("order_limit", _web, "SELECT url, COUNT(url) AS c FROM access GROUP BY url ORDER BY c DESC LIMIT 3"),
    ("max_mr", _small_t, ("mr", "aggregate", ("t", "k", "v", "max"))),
    ("sum_int", _small_t, "SELECT k, SUM(v) FROM t GROUP BY k"),
    ("sum_float", _small_t, "SELECT k, SUM(w) FROM t GROUP BY k"),
    ("count_t", _small_t, "SELECT k, COUNT(k) FROM t GROUP BY k"),
    ("order_count", _small_t, "SELECT k, COUNT(k) FROM t GROUP BY k ORDER BY COUNT(k) DESC LIMIT 3"),
    ("filtered_min", _negative_t, "SELECT k, MIN(v) FROM t WHERE v < -10 GROUP BY k"),
    ("filtered_max", _negative_t, "SELECT k, MAX(v) FROM t WHERE v < -10 GROUP BY k"),
    ("filtered_sum", _negative_t, "SELECT k, SUM(v) FROM t WHERE v < -10 GROUP BY k"),
    ("emptied_group", _emptied_t, "SELECT k, MIN(v), MAX(v) FROM t WHERE v < 50 GROUP BY k"),
    ("min", _small_t, "SELECT k, MIN(v) FROM t GROUP BY k"),
    ("max_padded", _padded_t, "SELECT k, MAX(v) FROM t GROUP BY k"),
    ("join_fanout", _ab, JOIN),
    ("join_unique", lambda: _ab(dup_build=False), JOIN),
    ("join_empty_build", _empty_build, JOIN),
    ("join_no_match", _no_match, JOIN),
    ("join_probe_filter", _ab, JOIN + " AND a.w > 0"),
    ("join_residual_first", _ab, "SELECT a.f, b.g FROM A a, B b WHERE b.id = a.b_id AND a.w > 0"),
    ("join_count", _ab, "SELECT a.f, COUNT(a.f) FROM A a, B b WHERE a.b_id = b.id GROUP BY a.f"),
    ("join_sum_build", _ab, "SELECT a.f, SUM(b.v) FROM A a, B b WHERE a.b_id = b.id GROUP BY a.f"),
    ("join_count_sum", _ab, "SELECT b.g, COUNT(b.g), SUM(a.w) FROM A a, B b WHERE a.b_id = b.id GROUP BY b.g"),
    ("join_min_max", _ab, "SELECT b.g, MIN(a.w), MAX(b.v) FROM A a, B b WHERE a.b_id = b.id GROUP BY b.g"),
    ("join_sum_expr", _ab, "SELECT a.f, SUM(a.w + b.v) FROM A a, B b WHERE a.b_id = b.id GROUP BY a.f"),
    ("join_count_min", _ab, "SELECT b.g, COUNT(b.g), MIN(a.w) FROM A a, B b WHERE a.b_id = b.id GROUP BY b.g"),
    ("join_avg", _ab, "SELECT a.f, AVG(b.v) FROM A a, B b WHERE a.b_id = b.id GROUP BY a.f"),
    ("join_emptied_group", _emptied_join,
     "SELECT a.f, SUM(b.v) FROM A a, B b WHERE a.b_id = b.id AND a.w > 0 GROUP BY a.f"),
    ("join_unmatched_group", _unmatched_group,
     "SELECT b.g, SUM(a.w) FROM A a, B b WHERE a.b_id = b.id GROUP BY b.g"),
]
# agg-method variants, as test_join_agg.py runs them
METHOD_PROGRAMS = ["filtered_min", "filtered_max", "filtered_sum", "emptied_group", "min", "max_padded",
                   "join_count_min"]
METHODS = ["dense", "onehot", "sort", "kernel"]
BY_ID = {pid: (data, q) for pid, data, q in PROGRAMS}


def _submit(session, q, mr):
    if isinstance(q, tuple):
        _, ctor, args = q
        return session.mapreduce(getattr(mr, ctor)(*args))
    return session.sql(q)


def _results(out):
    return out.results["R"] if "R" in out.results else [(out.results["scalar"],)]


@pytest.mark.parametrize("backend", ["vectorized", "partitioned"])
@pytest.mark.parametrize("pid", [p[0] for p in PROGRAMS])
def test_program_matches_jax(pid, backend):
    data, q = BY_ID[pid]
    tables = data()
    if backend == "vectorized":
        js, ts = repro.Session(), repro_torch.Session(device="cpu")
    else:
        kw = dict(backend="partitioned", n_partitions=4, schedule="static")
        js, ts = repro.Session(**kw), repro_torch.Session(device="cpu", **kw)
    for s in (js, ts):
        for name, cols in tables.items():
            s.register(name, **cols)
    jr, tr = _results(_submit(js, q, JMR)), _results(_submit(ts, q, MapReduceSpec))
    ordered = isinstance(q, str) and "ORDER BY" in q
    _rows_close(jr if ordered else sorted(jr), tr if ordered else sorted(tr))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("pid", METHOD_PROGRAMS)
def test_agg_method_variant_matches_jax(pid, method):
    data, q = BY_ID[pid]
    tables = data()
    schemas = {t: list(c) for t, c in tables.items()}
    jdb = JDatabase()
    for name, cols in tables.items():
        jdb.add(JMultiset.from_columns(name, **cols))
    jres = joptimize(jsql(q, schemas), jdb, JOptions(agg_method=method, reformat=False))
    tres = optimize(sql_to_forelem(q, schemas), database_from_columns(tables),
                    OptimizeOptions(agg_method=method, reformat=False, device="cpu"))
    _rows_close(sorted(jres.plan.run()["R"]), sorted(tres.plan.run()["R"]))


# ---------------------------------------------------------------------------
# forelem → MapReduce export (frontends/export_mr.py) and the core.lower shim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pid", ["count", "sum_int", "count_mr", "sum_mr", "min", "join_count"])
def test_export_mr_matches_jax(pid):
    from repro.frontends.export_mr import NotMapReduceShape as JNotMR
    from repro.frontends.export_mr import forelem_to_mapreduce as jexport
    from repro.frontends.mapreduce import mapreduce_to_forelem as jmr
    from repro.frontends.mapreduce import run_python_mapreduce
    from repro_torch.frontends.export_mr import NotMapReduceShape, forelem_to_mapreduce
    from repro_torch.frontends.mapreduce import mapreduce_to_forelem
    from repro_torch.frontends.mapreduce import run_python_mapreduce as run_port_mapreduce

    data, q = BY_ID[pid]
    tables = data()
    schemas = {t: list(c) for t, c in tables.items()}
    if isinstance(q, tuple):
        _, ctor, args = q
        jp = jmr(getattr(JMR, ctor)(*args), schemas[args[0]])
        tp = mapreduce_to_forelem(getattr(MapReduceSpec, ctor)(*args), schemas[args[0]])
    else:
        jp, tp = jsql(q, schemas), sql_to_forelem(q, schemas)
    try:
        jmr_prog = jexport(jp)
    except JNotMR:
        with pytest.raises(NotMapReduceShape):
            forelem_to_mapreduce(tp)
        return
    tmr_prog = forelem_to_mapreduce(tp)
    assert (tmr_prog.table, tmr_prog.pseudocode) == (jmr_prog.table, jmr_prog.pseudocode)
    cols = tables[tmr_prog.table]
    rows = [(i, {f: c[i].item() for f, c in cols.items()}) for i in range(len(next(iter(cols.values()))))]
    assert sorted(run_port_mapreduce(tmr_prog.map_fn, tmr_prog.reduce_fn, rows, 4)) == sorted(
        run_python_mapreduce(jmr_prog.map_fn, jmr_prog.reduce_fn, rows, 4))


def test_lower_shim_reexports():
    from repro_torch.backends import codegen, reference, torch_vec
    from repro_torch.core import lower

    assert lower.Plan is torch_vec.Plan and lower.TorchLowering is torch_vec.TorchLowering
    assert lower.CodegenChoices is torch_vec.CodegenChoices
    assert lower.ReferenceInterpreter is reference.ReferenceInterpreter
    assert lower.extract_spec is codegen.extract_spec and lower.UnsupportedProgram is codegen.UnsupportedProgram
    import repro_torch.core as core

    assert core.TorchLowering is torch_vec.TorchLowering
