# The port's copies of the IR, the frontends and the verifier against the
# JAX package's originals: the same SQL or MapReduce job gives the same
# printed program (the corpora of test_frontends.py and test_engine.py),
# the same passes print the same result, and each of the 16 corruptions of
# test_analysis.py is caught by the port's verifier under the same
# invariant and pass name.
import dataclasses

import pytest

import repro.core.ir as jax_ir
import repro_torch.core.ir as torch_ir
from repro.analysis import IRVerificationError as JaxVerificationError
from repro.analysis import verify_program as jax_verify
from repro.core import transforms as jax_T
from repro.core.ir import FieldRef as JaxFieldRef
from repro.frontends.mapreduce import MapReduceSpec as JaxMR
from repro.frontends.mapreduce import mapreduce_to_forelem as jax_mr
from repro.frontends.sql import sql_to_forelem as jax_sql
from repro_torch.analysis import IRVerificationError, verify_program
from repro_torch.core import transforms as T
from repro_torch.core.ir import FieldRef, program_str
from repro_torch.frontends.mapreduce import MapReduceSpec, mapreduce_to_forelem
from repro_torch.frontends.sql import sql_to_forelem
from test_analysis import CORRUPTIONS
from test_torch_threads import cap_torch_threads

cap_torch_threads()


def to_port(obj):
    """The same IR tree built from the port's classes."""
    if dataclasses.is_dataclass(obj) and type(obj).__module__ == jax_ir.__name__:
        cls = getattr(torch_ir, type(obj).__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    if isinstance(obj, list):
        return [to_port(x) for x in obj]
    return obj


SCHEMAS = {
    "access": ["url", "latency"],
    "links": ["source", "target"],
    "t": ["k", "v", "w"],
    "A": ["b_id", "f", "w"],
    "B": ["id", "g", "v"],
}

SQL_CORPUS = [
    "SELECT url, COUNT(url) FROM access GROUP BY url",
    "SELECT target, COUNT(target) FROM links GROUP BY target",
    "SELECT k, SUM(v), MIN(v), MAX(v) FROM t GROUP BY k",
    "SELECT SUM(v) FROM t WHERE k = :kk",
    "SELECT a.f, b.g FROM A a, B b WHERE a.b_id = b.id",
    "SELECT k FROM t",
    "SELECT k FROM t WHERE k > 1",
    "SELECT url, SUM(latency) FROM access GROUP BY url",
    "SELECT SUM(latency) FROM access WHERE url = 3",
    "SELECT url, COUNT(url) AS c FROM access GROUP BY url ORDER BY c DESC LIMIT 3",
    "SELECT k, SUM(v) FROM t GROUP BY k",
    "SELECT k, SUM(v), MIN(v), MAX(w), COUNT(k), AVG(w) FROM t WHERE v > 10 GROUP BY k",
    "SELECT b.g, COUNT(b.g), SUM(a.w) FROM A a, B b WHERE a.b_id = b.id GROUP BY b.g",
    "SELECT a.f, SUM(b.v) FROM A a, B b WHERE a.b_id = b.id AND a.w > 0 GROUP BY a.f",
]


@pytest.mark.parametrize("canonical", [False, True], ids=["raw", "canonical"])
@pytest.mark.parametrize("sql", SQL_CORPUS)
def test_sql_program_str_matches_jax(sql, canonical):
    jp, tp = jax_sql(sql, SCHEMAS), sql_to_forelem(sql, SCHEMAS)
    if canonical:
        jp, tp = jax_T.canonicalize_array_names(jp), T.canonicalize_array_names(tp)
    assert program_str(tp) == jax_ir.program_str(jp)
    assert tp == to_port(jp)


MR_CORPUS = [
    (("access", "url"), "count", ["url"]),
    (("t", "k", "v", "+"), "aggregate", ["k", "v"]),
    (("t", "k", "v", "max"), "aggregate", ["k", "v"]),
    (("T", "f1"), "field", ["f1", "f2"]),
]


@pytest.mark.parametrize("args,kind,schema", MR_CORPUS)
def test_mapreduce_program_str_matches_jax(args, kind, schema):
    if kind == "field":
        jspec = JaxMR(args[0], args[1], JaxFieldRef("T", "i", "f2"))
        tspec = MapReduceSpec(args[0], args[1], FieldRef("T", "i", "f2"))
    else:
        jspec, tspec = getattr(JaxMR, kind)(*args), getattr(MapReduceSpec, kind)(*args)
    jp, tp = jax_mr(jspec, schema), mapreduce_to_forelem(tspec, schema)
    assert program_str(tp) == jax_ir.program_str(jp)
    assert program_str(T.canonicalize_array_names(tp)) == jax_ir.program_str(
        jax_T.canonicalize_array_names(jp)
    )


@pytest.mark.parametrize("pass_name", ["loop_interchange", "dead_code_elimination", "loop_fusion"])
@pytest.mark.parametrize("sql", SQL_CORPUS[:6])
def test_query_passes_print_the_same(sql, pass_name):
    jp, tp = jax_sql(sql, SCHEMAS), sql_to_forelem(sql, SCHEMAS)
    assert program_str(getattr(T, pass_name)(tp)) == jax_ir.program_str(getattr(jax_T, pass_name)(jp))


@pytest.mark.parametrize("invariant", sorted(CORRUPTIONS))
def test_corruption_named_like_jax(invariant):
    bad = CORRUPTIONS[invariant]()
    with pytest.raises(JaxVerificationError) as want:
        jax_verify(bad, pass_name="loop_fusion")
    with pytest.raises(IRVerificationError) as got:
        verify_program(to_port(bad), pass_name="loop_fusion")
    assert got.value.invariant == want.value.invariant == invariant
    assert got.value.pass_name == want.value.pass_name == "loop_fusion"
    assert str(got.value) == str(want.value)


def test_sixteen_corruptions():
    assert len(CORRUPTIONS) == 16
