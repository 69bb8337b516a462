# The port's examples and command-line tools (examples/torch_quickstart.py,
# examples/torch_bigdata_sql.py, scripts/torch_irlint.py,
# scripts/torch_trace_summary.py, scripts/torch_probe.py) held on the CPU
# against the JAX package's own (examples/quickstart.py,
# examples/bigdata_sql.py, scripts/irlint.py, scripts/trace_summary.py) and
# the dry run's run_cell.  Each file runs in process through its main, its
# printed lines captured; the JAX package's examples are loaded as modules
# whose Session is a subclass that records each result.  Integers match
# exactly, float sums within rtol 1e-4 (ROADMAP C4: the two packages sum
# in other orders); SUM(bytes) wraps in int32 in both (C5).
# chip_smoke.py's numpy oracle of the web-log queries (phase 29 holds the
# card's results against it at 2,000,000 rows) is held here against the
# port's ReferenceInterpreter.
import contextlib
import importlib.util
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

import repro
import repro.obs
import repro_torch
from repro_torch.backends import ReferenceInterpreter
from repro_torch.frontends.mapreduce import mapreduce_to_forelem

from test_torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

RTOL = 1e-4
WEBLOG_ROWS = 60_000
ORACLE_ROWS = 20_000


def load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def captured(main, *args, **kw):
    """(main's return value, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(*args, **kw)
    return out, buf.getvalue()


def recording(session_cls, seen: list):
    """``session_cls`` with each sql/mapreduce result appended to ``seen``."""

    class Recording(session_cls):
        def sql(self, query, params=None):
            r = super().sql(query, params)
            seen.append(r)
            return r

        def mapreduce(self, spec, params=None):
            r = super().mapreduce(spec, params)
            seen.append(r)
            return r

    return Recording


def run_reference(rel: str, name: str, argv: list, monkeypatch) -> tuple:
    """The JAX package's example ``rel`` run with ``argv``: (its results in
    order, what it printed)."""
    mod = load(rel, name)
    seen: list = []
    monkeypatch.setattr(mod, "Session", recording(repro.Session, seen))
    monkeypatch.setattr(sys, "argv", [rel] + argv)
    _, text = captured(mod.main)
    return seen, text


def same_value(got, want) -> bool:
    """Integers exactly, floats within RTOL, lists of rows as multisets."""
    if isinstance(want, list):
        return isinstance(got, list) and len(got) == len(want) and all(
            same_value(g, w) for g, w in zip(sorted(got), sorted(want)))
    if isinstance(want, tuple):
        return len(got) == len(want) and all(same_value(g, w) for g, w in zip(got, want))
    if isinstance(want, float):
        return abs(got - want) <= RTOL * abs(want)
    return got == want


def lines_with(text: str, needle: str) -> list:
    return [ln.strip() for ln in text.splitlines() if needle in ln]


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickstarts():
    mp = pytest.MonkeyPatch()
    try:
        ref = run_reference("examples/quickstart.py", "jax_quickstart", [], mp)
    finally:
        mp.undo()
    port = captured(load("examples/torch_quickstart.py", "torch_quickstart").main, ["--device", "cpu"])
    return ref, port


def test_quickstart_returns_the_references_rows(quickstarts):
    (seen, _), (out, _) = quickstarts
    ref_sql, ref_mr = sorted(seen[0].rows), sorted(seen[1].rows)
    assert out["rows"] == ref_sql and out["mr_rows"] == ref_mr
    assert out["raw_rows"] == out["reference_rows"] == ref_sql
    assert out["cache_hit"] and seen[1].cache_hit


def test_quickstart_prints_the_references_lines(quickstarts):
    (_, ref_text), (out, text) = quickstarts
    for needle in ("SQL:", "MapReduce execution matches SQL", "plan cache:", "low-level pipeline"):
        assert lines_with(text, needle)[:1] == lines_with(ref_text, needle)[:1], needle
    assert out["device"] == "cpu" and set(out["agg_methods"]) == {"sql", "mapreduce"}
    # on the CPU a wrapper runs its kernel's plain version: nothing launches
    assert all(n == 0 for run in out["launches"].values() for n in run.values())


# ---------------------------------------------------------------------------
# the web-log session
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weblogs():
    mp = pytest.MonkeyPatch()
    try:
        ref = run_reference("examples/bigdata_sql.py", "jax_bigdata_sql", ["--rows", str(WEBLOG_ROWS)], mp)
    finally:
        mp.undo()
    mod = load("examples/torch_bigdata_sql.py", "torch_bigdata_sql")
    port = captured(mod.main, ["--rows", str(WEBLOG_ROWS), "--device", "cpu"])
    return ref, port, mod


def test_weblog_results_match_the_reference_query_by_query(weblogs):
    (seen, _), (out, _), _ = weblogs
    assert len(out["queries"]) == len(seen) == 11
    for entry, r in zip(out["queries"], seen):
        assert entry["results"].keys() == r.results.keys(), entry["label"]
        for key, want in r.results.items():
            assert same_value(entry["results"][key], want), (entry["label"], key)


def test_weblog_plan_lines_and_cache_hits_match_the_reference(weblogs):
    (seen, ref_text), (out, _), _ = weblogs
    assert [e["plan"] for e in out["queries"]] == lines_with(ref_text, "plan: ")
    assert [e["cache_hit"] for e in out["queries"]] == [r.cache_hit for r in seen]
    assert lines_with(ref_text, "plan cache:") == [f"plan cache: {out['cache_stats']}"]


def test_weblog_distribution_and_schedule_match_the_reference(weblogs):
    (_, ref_text), (out, text), _ = weblogs
    for needle in ("partitioning conflicts before", "after reorder+fusion:"):
        assert lines_with(text, needle) == lines_with(ref_text, needle), needle
    # the scheduler's summary, its makespan aside
    strip = lambda lines: [re.sub(r"makespan=\S+ ", "", ln) for ln in lines]  # noqa: E731
    needle = "chunked execution with 1 injected node failure"
    assert strip(lines_with(text, needle)) == strip(lines_with(ref_text, needle))
    assert out["coverage"] is True


def test_weblog_explain_matches_the_reference(weblogs):
    (_, ref_text), (out, _), _ = weblogs
    start = ref_text.index("EXPLAIN mr_count")
    ref_block = ref_text[start:].split("\n\n")[0]
    assert out["explain"] == ref_block


def test_weblog_oracle_matches_the_reference_interpreter(weblogs):
    """chip_smoke.weblog_oracle (phase 29's yardstick) against the port's
    ReferenceInterpreter on the frontends' programs, and against the
    example's results at WEBLOG_ROWS."""
    _, (out, _), mod = weblogs
    want = chip_smoke.weblog_oracle(out["tables"])
    for entry, w in zip(out["queries"], want):
        assert chip_smoke.weblog_agree(next(iter(entry["results"].values())), w), entry["label"]
    tables = mod.web_logs(ORACLE_ROWS)
    s = repro_torch.Session(n_parts=8, device="cpu")
    for name, cols in tables.items():
        s.register(name, **cols)
    s.sql(mod.QUERIES[2])  # dictionary-encodes the url column as the engine does
    programs = [repro_torch.sql_to_forelem(q, s.schemas()) for q in mod.QUERIES]
    programs += [mapreduce_to_forelem(spec, s.schemas()) for spec in mod.MR_JOBS]
    oracle = chip_smoke.weblog_oracle(tables)
    for prog, w in zip(programs, oracle):
        got = next(iter(ReferenceInterpreter(s.db).run(prog).values()))
        if isinstance(got, int):  # the interpreter sums in Python ints; the engine wraps in int32 (C5)
            got = (got + 2**31) % 2**32 - 2**31
        assert chip_smoke.weblog_agree(got, w), prog.name


def test_weblog_agree_catches_a_wrong_row():
    want = [(1, 10, 2.5), (2, 20, 4.0)]
    assert chip_smoke.weblog_agree([(2, 20, 4.0), (1, 10, 2.5)], want)
    assert not chip_smoke.weblog_agree([(1, 10, 2.5), (2, 21, 4.0)], want)
    assert not chip_smoke.weblog_agree([(1, 10, 2.5), (2, 20, 4.01)], want)
    assert not chip_smoke.weblog_agree([(1, 10, 2.5)], want)
    top = {"limit": 2, "counts": {7: 5, 8: 9, 9: 1}}
    assert chip_smoke.weblog_agree([(8, 9), (7, 5)], top)
    assert not chip_smoke.weblog_agree([(8, 9), (9, 1)], top)


# ---------------------------------------------------------------------------
# the command-line tools
# ---------------------------------------------------------------------------


def _csv(tmp_path) -> str:
    path = tmp_path / "access.csv"
    rng = np.random.default_rng(1)
    rows = ["url,size,hits"] + [f"{u},{s},{h}" for u, s, h in zip(
        rng.choice(["a.html", "b.html", "c.html"], 300), rng.integers(1, 100, 300), rng.integers(0, 5, 300))]
    path.write_text("\n".join(rows) + "\n")
    return f"access={path}"


IRLINT_CASES = {
    "demo": lambda tmp: ["--demo"],
    "demo_k4": lambda tmp: ["--demo", "-K", "4"],
    "csv": lambda tmp: ["SELECT url, SUM(size) FROM access GROUP BY url", "--csv", _csv(tmp)],
    "csv_clean": lambda tmp: ["SELECT url, COUNT(url) FROM access GROUP BY url", "--csv", _csv(tmp), "-K", "2"],
}


@pytest.mark.parametrize("case", sorted(IRLINT_CASES))
def test_irlint_gives_the_references_exit_code_and_lines(case, tmp_path):
    argv = IRLINT_CASES[case](tmp_path)
    ref_rc, ref_text = captured(load("scripts/irlint.py", "jax_irlint").main, argv)
    rc, text = captured(load("scripts/torch_irlint.py", "torch_irlint").main, argv + ["--device", "cpu"])
    assert rc == ref_rc
    assert text == ref_text
    if case == "demo":
        assert rc == chip_smoke.IRLINT_DEMO_RC


def test_irlint_explain_prints_the_lint_block(tmp_path):
    argv = ["SELECT url, SUM(size) FROM access GROUP BY url", "--csv", _csv(tmp_path), "--explain"]
    ref_rc, ref_text = captured(load("scripts/irlint.py", "jax_irlint").main, argv)
    rc, text = captured(load("scripts/torch_irlint.py", "torch_irlint").main, argv + ["--device", "cpu"])
    assert rc == ref_rc
    strip = lambda t: re.sub(r"epoch=\w+", "", t)  # noqa: E731
    assert strip(text) == strip(ref_text)


def test_trace_summary_renders_a_trace_the_port_saved(tmp_path):
    """test_obs.py::test_trace_summary_cli's checks, on a trace of the
    port's partitioned session; the JAX package's tool renders it alike."""
    rng = np.random.default_rng(0)
    s = repro_torch.Session(backend="partitioned", n_partitions=5, schedule="guided", device="cpu")
    s.register("t", k=rng.integers(0, 40, 20_000).astype(np.int32), v=rng.integers(-1000, 1000, 20_000).astype(np.int32))
    with s.profile() as qt:
        s.sql("SELECT k, SUM(v) FROM t GROUP BY k")
    path = str(tmp_path / "trace.json.gz")
    qt.save(path)
    mod = load("scripts/torch_trace_summary.py", "torch_trace_summary")
    trace = repro_torch.obs.load_trace(path)
    text = mod.render_summary(trace)
    assert "dispatch" in text and "query" in text and "stage" in text
    assert "chunks=" in mod.render_dispatch(trace)
    assert captured(mod.main, [path, "--dispatch"])[0] == 0
    ref = load("scripts/trace_summary.py", "jax_trace_summary")
    ref_trace = repro.obs.load_trace(path)
    assert ref.render_summary(ref_trace) == text
    assert ref.render_dispatch(ref_trace) == mod.render_dispatch(trace)
    rc, _ = captured(mod.main, [str(tmp_path / "missing.json")])
    assert rc == 2


def test_probe_record_equals_run_cell(tmp_path, monkeypatch):
    from repro_torch.launch.dryrun import run_cell

    monkeypatch.chdir(tmp_path)
    rec, text = captured(load("scripts/torch_probe.py", "torch_probe").main, ["rwkv6-3b", "decode_32k", "t"])
    want = run_cell("rwkv6-3b", "decode_32k", False, None, probe={}, tag="t")
    timing = ("t_trace_s", "t_analyze_s")
    drop = lambda r: {k: (drop(v) if isinstance(v, dict) else v) for k, v in r.items() if k not in timing}  # noqa: E731
    assert drop(rec) == drop(want)
    assert text.startswith(f"t: peak {want['memory']['peak_device_bytes']/1e9:.2f} GB | dot ")
    assert os.path.exists(tmp_path / "runs" / "probe_torch" / "rwkv6-3b__decode_32k__single__t.json")


# ---------------------------------------------------------------------------
# the card unless --device cpu
# ---------------------------------------------------------------------------


REFUSING = {
    "examples/torch_quickstart.py": [],
    "examples/torch_bigdata_sql.py": ["--rows", "100"],
    "scripts/torch_irlint.py": ["--demo"],
}


@pytest.mark.parametrize("rel", sorted(REFUSING))
def test_without_a_card_the_tool_stops_unless_given_the_cpu(rel, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(repro_torch.EngineError, match="no CUDA device"):
        load(rel, "refusing").main(REFUSING[rel])
