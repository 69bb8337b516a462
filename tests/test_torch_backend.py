# The port's vectorized backend (backends/torch_vec.Plan on the CPU) against
# the JAX package's (backends/jax_vec.Plan): every agg_method × parallel
# mode over the filtered MIN/MAX corpus and the fused multi-aggregate query
# of test_kernels.py, and every agg_method over the join corpus of
# test_join_agg.py.  Both packages parse the same SQL and read the same
# numpy columns.  Integers must match exactly; floats within 1e-3 as
# test_kernels.py's _rows_close, plus 1e-5 of the value (f32 sums taken in
# another order).  Join rows must come out in the same order,
# unsorted: that order is set by the stable sort of the build side.
import numpy as np
import pytest
import torch

from repro.backends.jax_vec import CodegenChoices as JaxChoices
from repro.backends.jax_vec import Plan as JaxPlan
from repro.core.passes import OptimizeOptions as JaxOptions
from repro.core.passes import optimize as jax_optimize
from repro.core.transforms import canonicalize_array_names as jax_canon
from repro.data.multiset import Database as JaxDatabase
from repro.data.multiset import Multiset as JaxMultiset
from repro.frontends.sql import sql_to_forelem as jax_sql
from repro_torch.backends import UnsupportedProgram
from repro_torch.backends.torch_vec import CodegenChoices, Plan
from repro_torch.core.passes import OptimizeOptions, optimize
from repro_torch.core.transforms import canonicalize_array_names
from repro_torch.data.multiset import database_from_columns
from repro_torch.frontends.sql import sql_to_forelem
from test_torch_threads import cap_torch_threads

cap_torch_threads()

AGG_METHODS = ("dense", "onehot", "sort", "kernel")
JOIN_SCHEMAS = {"A": ["b_id", "f", "w"], "B": ["id", "g", "v"]}


def _jax_db(tables):
    db = JaxDatabase()
    for name, cols in tables.items():
        db.add(JaxMultiset.from_columns(name, **cols))
    return db


def _rows_close(a, b, tol=1e-3, rtol=1e-5):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, int) and isinstance(y, int):
                assert x == y, (ra, rb)
            else:
                assert abs(float(x) - float(y)) <= tol + rtol * abs(float(y)), (ra, rb)


def _single_table(seed, n=400):
    rng = np.random.default_rng(seed)
    return {
        "t": dict(
            k=rng.integers(0, 8, n).astype(np.int32),
            v=rng.integers(-100, 100, n).astype(np.int32),
            w=rng.normal(size=n).astype(np.float32),
        )
    }


def _join_tables(seed, dup_build=True, n_a=120, n_b=40, key_range=12):
    rng = np.random.default_rng(seed)
    b_keys = (
        rng.integers(0, key_range, n_b).astype(np.int32)
        if dup_build
        else rng.permutation(n_b).astype(np.int32)
    )
    return {
        "A": dict(
            b_id=rng.integers(0, key_range if dup_build else n_b, n_a).astype(np.int32),
            f=rng.integers(0, 6, n_a).astype(np.int32),
            w=rng.integers(-50, 50, n_a).astype(np.int32),
        ),
        "B": dict(
            id=b_keys,
            g=rng.integers(0, 5, n_b).astype(np.int32),
            v=rng.integers(-30, 30, n_b).astype(np.int32),
        ),
    }


SINGLE_TABLE_SQL = [
    "SELECT k, MIN(v) FROM t WHERE v < -10 GROUP BY k",
    "SELECT k, MAX(v) FROM t WHERE v < -10 GROUP BY k",
    "SELECT k, SUM(v) FROM t WHERE v < -10 GROUP BY k",
    "SELECT k, MIN(v), MAX(v) FROM t WHERE v < 50 GROUP BY k",
    "SELECT k, SUM(v), MIN(v), MAX(w), COUNT(k), AVG(w) FROM t GROUP BY k",
    "SELECT k, SUM(v), MIN(v), MAX(w), COUNT(k), AVG(w) FROM t WHERE v > 10 GROUP BY k",
    "SELECT k, COUNT(k) FROM t GROUP BY k ORDER BY COUNT(k) DESC LIMIT 3",
]

JOIN_SQL = [
    ("SELECT a.f, b.g FROM A a, B b WHERE a.b_id = b.id", True),
    ("SELECT a.f, b.g FROM A a, B b WHERE a.b_id = b.id", False),
    ("SELECT a.f, b.g FROM A a, B b WHERE a.b_id = b.id AND a.w > 0", True),
    ("SELECT a.f, b.g FROM A a, B b WHERE b.id = a.b_id AND a.w > 0", True),
    ("SELECT a.f, COUNT(a.f) FROM A a, B b WHERE a.b_id = b.id GROUP BY a.f", True),
    ("SELECT a.f, SUM(b.v) FROM A a, B b WHERE a.b_id = b.id GROUP BY a.f", True),
    ("SELECT b.g, COUNT(b.g), SUM(a.w) FROM A a, B b WHERE a.b_id = b.id GROUP BY b.g", True),
    ("SELECT b.g, MIN(a.w), MAX(b.v) FROM A a, B b WHERE a.b_id = b.id GROUP BY b.g", True),
    ("SELECT a.f, SUM(a.w + b.v) FROM A a, B b WHERE a.b_id = b.id GROUP BY a.f", True),
    ("SELECT a.f, AVG(b.v) FROM A a, B b WHERE a.b_id = b.id GROUP BY a.f", True),
    ("SELECT b.g, COUNT(b.g), MIN(a.w) FROM A a, B b WHERE a.b_id = b.id GROUP BY b.g", False),
]


def _both_plans(sql, tables, method, schemas):
    jp = jax_canon(jax_sql(sql, schemas))
    tp = canonicalize_array_names(sql_to_forelem(sql, schemas))
    jplan = JaxPlan(jp, _jax_db(tables), JaxChoices(agg_method=method), jit=False)
    tplan = Plan(tp, database_from_columns(tables), CodegenChoices(agg_method=method, device="cpu"))
    return jplan, tplan


@pytest.mark.parametrize("method", AGG_METHODS)
@pytest.mark.parametrize("sql", SINGLE_TABLE_SQL)
def test_single_table_matches_jax_plan(method, sql):
    tables = _single_table(1)
    jplan, tplan = _both_plans(sql, tables, method, {"t": ["k", "v", "w"]})
    assert [len(g) for g in tplan.lowering.fused_groups] == [
        len(g) for g in jplan.lowering.fused_groups
    ]
    assert tplan.lowering.method_notes == jplan.lowering.method_notes
    _rows_close(jplan.run()["R"], tplan.run()["R"])


def test_fused_group_of_six_is_one_launch_without_notes():
    tables = _single_table(2, n=20000)
    sql = "SELECT k, SUM(v), MIN(v), MAX(w), COUNT(k), AVG(w) FROM t GROUP BY k"
    jplan, tplan = _both_plans(sql, tables, "kernel", {"t": ["k", "v", "w"]})
    assert [len(g) for g in tplan.lowering.fused_groups] == [6]
    assert tplan.lowering.method_notes == []
    _rows_close(sorted(jplan.run()["R"]), sorted(tplan.run()["R"]))


@pytest.mark.parametrize("method", AGG_METHODS)
@pytest.mark.parametrize("sql", SINGLE_TABLE_SQL[:4])
def test_vmap_parallel_matches_jax(method, sql):
    """parallel='vmap': N row blocks reduced apart and merged under the op
    (301 rows over 4 blocks exercises the identity padding)."""
    tables = _single_table(3, n=301)
    schemas = {"t": ["k", "v", "w"]}
    jres = jax_optimize(
        jax_sql(sql, schemas), _jax_db(tables),
        JaxOptions(n_parts=4, agg_method=method, parallel_exec="vmap"),
    )
    tres = optimize(
        sql_to_forelem(sql, schemas), database_from_columns(tables),
        OptimizeOptions(n_parts=4, agg_method=method, parallel_exec="vmap", device="cpu"),
    )
    assert tres.plan.lowering.choices.parallel == jres.plan.lowering.choices.parallel == "vmap"
    _rows_close(sorted(jres.plan.run()["R"]), sorted(tres.plan.run()["R"]))


@pytest.mark.parametrize("method", AGG_METHODS)
@pytest.mark.parametrize("sql,dup_build", JOIN_SQL)
def test_join_matches_jax_in_row_order(method, sql, dup_build):
    tables = _join_tables(4, dup_build=dup_build)
    jplan, tplan = _both_plans(sql, tables, method, JOIN_SCHEMAS)
    assert tplan.lowering.join_multiplicity == jplan.lowering.join_multiplicity
    _rows_close(jplan.run()["R"], tplan.run()["R"])  # unsorted: same order


def test_join_empty_build_and_forced_lookup():
    tables = _join_tables(5)
    tables["B"] = {k: v[:0] for k, v in tables["B"].items()}
    sql = "SELECT a.f, b.g FROM A a, B b WHERE a.b_id = b.id"
    jplan, tplan = _both_plans(sql, tables, "dense", JOIN_SCHEMAS)
    assert tplan.run()["R"] == jplan.run()["R"] == []
    dup = _join_tables(6, dup_build=True)
    with pytest.raises(UnsupportedProgram):
        Plan(sql_to_forelem(sql, JOIN_SCHEMAS), database_from_columns(dup),
             CodegenChoices(join_method="lookup", device="cpu"))


def test_scalar_int32_sum_wraps_like_jnp_sum():
    """A scalar SUM over int32 stays int32 and wraps, as jnp.sum does
    (torch.sum alone would widen it to int64)."""
    tables = {"t": dict(k=np.array([1, 1, 2], np.int32), v=np.array([2**30, 2**30, 5], np.int32))}
    sql = "SELECT SUM(v) FROM t WHERE k = 1"
    jplan, tplan = _both_plans(sql, tables, "dense", {"t": ["k", "v"]})
    assert tplan.run()["scalar"] == jplan.run()["scalar"] == -(2**31)


def test_int64_column_wraps_to_int32_like_jnp_asarray():
    tables = {"t": dict(k=np.array([0, 1], np.int64), v=np.array([2**31 + 5, 3], np.int64))}
    sql = "SELECT k, SUM(v) FROM t GROUP BY k"
    jplan, tplan = _both_plans(sql, tables, "dense", {"t": ["k", "v"]})
    assert sorted(tplan.run()["R"]) == sorted(jplan.run()["R"]) == [(0, -2147483643), (1, 3)]


def test_shard_map_has_no_counterpart():
    tables = _single_table(7)
    p = sql_to_forelem("SELECT k, SUM(v) FROM t GROUP BY k", {"t": ["k", "v", "w"]})
    with pytest.raises(UnsupportedProgram):
        Plan(p, database_from_columns(tables), CodegenChoices(parallel="shard_map", device="cpu"))


def test_plan_keeps_columns_on_its_device():
    tables = _single_table(8)
    p = sql_to_forelem("SELECT k, SUM(v) FROM t GROUP BY k", {"t": ["k", "v", "w"]})
    plan = Plan(p, database_from_columns(tables), CodegenChoices(device="cpu"))
    first = plan.input_columns()
    assert first["t"]["k"].dtype == torch.int32 and first["t"]["k"].device.type == "cpu"
    assert plan.input_columns()["t"]["k"] is first["t"]["k"]  # uploaded once


# ---------------------------------------------------------------------------
# MAX and MIN order -0.0 below +0.0, and a NaN wins, as the JAX package does
# (ROADMAP C34): both rows of each key hold one zero each, in either order,
# so a reduction that keeps whichever zero it meets first gives a key the
# wrong sign.  Held bit for bit; a NaN against a NaN.
# ---------------------------------------------------------------------------

SIGNED_ZERO_SQL = "SELECT k, MAX(v), MIN(v) FROM t GROUP BY k"
SIGNED_ZERO_CASES = {
    "zeros": [-0.0, 0.0, 0.0, -0.0],
    "nan": [-0.0, float("nan"), 0.0, -0.0],
}


def _signed_zero_table(case, dtype):
    import ml_dtypes

    np_dtype = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}[dtype]
    return {"t": dict(k=np.array([0, 0, 1, 1], np.int32), v=np.array(SIGNED_ZERO_CASES[case], np_dtype))}


def _bits(rows):
    """Each row's key and, per float, NaN or its sign and value."""
    out = []
    for r in sorted(rows, key=lambda r: r[0]):
        out.append((int(r[0]),) + tuple("nan" if np.isnan(float(x)) else (bool(np.signbit(float(x))), float(x))
                                        for x in r[1:]))
    return out


@pytest.mark.parametrize("case", sorted(SIGNED_ZERO_CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("method", AGG_METHODS)
def test_signed_zero_max_min_match_jax_plan(method, dtype, case):
    jplan, tplan = _both_plans(SIGNED_ZERO_SQL, _signed_zero_table(case, dtype), method, {"t": ["k", "v"]})
    want = _bits(jplan.run()["R"])
    assert _bits(tplan.run()["R"]) == want
    if case == "zeros":
        assert want == [(0, (False, 0.0), (True, -0.0)), (1, (False, 0.0), (True, -0.0))]


@pytest.mark.parametrize("case", sorted(SIGNED_ZERO_CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_signed_zero_max_min_match_jax_session(dtype, case):
    import repro
    from repro_torch import Session

    tables = _signed_zero_table(case, dtype)
    js, ts = repro.Session(), Session(device="cpu")
    for name, cols in tables.items():
        js.register(name, **cols)
        ts.register(name, **cols)
    assert _bits(ts.sql(SIGNED_ZERO_SQL).rows) == _bits(js.sql(SIGNED_ZERO_SQL).rows)


@pytest.mark.parametrize("method", AGG_METHODS)
def test_signed_zero_vmap_merge_matches_jax(method):
    """parallel='vmap' reduces row blocks apart and merges the partials:
    each row in a block of its own."""
    tables = _signed_zero_table("zeros", "f32")
    schemas = {"t": ["k", "v"]}
    jres = jax_optimize(jax_sql(SIGNED_ZERO_SQL, schemas), _jax_db(tables),
                        JaxOptions(n_parts=4, agg_method=method, parallel_exec="vmap"))
    tres = optimize(sql_to_forelem(SIGNED_ZERO_SQL, schemas), database_from_columns(tables),
                    OptimizeOptions(n_parts=4, agg_method=method, parallel_exec="vmap", device="cpu"))
    assert tres.plan.lowering.choices.parallel == "vmap" and tres.plan.lowering.spec.n_parts == 4
    assert _bits(tres.plan.run()["R"]) == _bits(jres.plan.run()["R"])


# the reference interpreter's FieldMatch (a join's probe) looks its value
# up in a per-column index of rows: it matches as the JAX package's scan
# of the column does, NaN matching nothing and -0.0 matching 0.0
FIELD_MATCH_KEYS = {
    "ints": (np.array([3, 1, 3, 7, 1, 3], np.int32), np.array([1, 3, 5], np.int32)),
    "floats": (np.array([0.5, np.nan, -0.0, 2.0, np.nan, 0.5], np.float32),
               np.array([np.nan, 0.0, 0.5, 2.0, 0.5], np.float32)),
    "int_against_float": (np.array([1, 2, 2, 4], np.int64), np.array([1.0, 2.0, 2.5, 4.0], np.float64)),
}


@pytest.mark.parametrize("keys", sorted(FIELD_MATCH_KEYS))
def test_reference_interpreter_field_match_matches_the_jax_scan(keys):
    from repro.backends.reference import ReferenceInterpreter as JaxInterpreter
    from repro_torch.backends import ReferenceInterpreter

    probe, build = FIELD_MATCH_KEYS[keys]
    tables = {"A": {"b_id": probe, "f": np.arange(len(probe), dtype=np.int32), "w": np.ones(len(probe), np.int32)},
              "B": {"id": build, "g": np.arange(len(build), dtype=np.int32), "v": 10 * np.arange(len(build))}}
    sql = "SELECT a.f, b.g FROM A a, B b WHERE a.b_id = b.id"
    want = JaxInterpreter(_jax_db(tables)).run(jax_sql(sql, JOIN_SCHEMAS))
    got = ReferenceInterpreter(database_from_columns(tables)).run(sql_to_forelem(sql, JOIN_SCHEMAS))
    assert got == want and len(got["R"]) > 0
