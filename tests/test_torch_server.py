# The port's multi-tenant serving engine (repro_torch.engine.server) on the
# CPU, held against the JAX package's QueryServer and against its own serial
# runs: admission control (reject and block), single-flight compilation into
# one shared plan cache, chunk retries on the shared pool, elastic pool
# scaling, tenant isolation; and the adaptive loop's runtime half — a
# mid-run split and a feedback re-plan give the bits of the serial unsplit
# run, and tenants' profiles stay apart in the shared store.
import threading
import time

import numpy as np
import pytest

import repro
import repro_torch
from repro_torch import AdmissionError
from repro_torch.backends.partitioned import ChunkDispatch, SplitPolicy
from repro_torch.engine import EngineError
from repro_torch.engine.server import SharedChunkPool
from repro_torch.planner import program_fingerprint
from repro_torch.sched import ChunkRetryExceeded, PoolScalePolicy, RetryPolicy, deterministic_fault_hook
from test_torch_threads import cap_torch_threads

cap_torch_threads()

N_ROWS = 20_000
QUERIES = [
    "SELECT url, COUNT(url) FROM access GROUP BY url",
    "SELECT url, SUM(size) FROM access GROUP BY url",
    "SELECT u.region, COUNT(u.region), SUM(a.size) FROM access a, users u "
    "WHERE a.uid = u.uid GROUP BY u.region",
]


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "access": dict(
            url=rng.integers(0, 40, N_ROWS).astype(np.int32),
            uid=rng.integers(0, 300, N_ROWS).astype(np.int32),
            size=rng.integers(1, 1000, N_ROWS).astype(np.int32),
        ),
        "users": dict(uid=np.arange(300, dtype=np.int32), region=rng.integers(0, 5, 300).astype(np.int32)),
    }


def _server(**kw):
    kw.setdefault("n_partitions", 4)
    srv = repro_torch.QueryServer(device="cpu", **kw)
    for name, cols in _tables().items():
        srv.register(name, **cols)
    return srv


@pytest.fixture(scope="module")
def serial():
    """The JAX package's serial partitioned rows, which the port's serial
    rows equal (integers only)."""
    js = repro.Session(backend="partitioned", n_partitions=4, async_dispatch=False)
    ts = repro_torch.Session(device="cpu", backend="partitioned", n_partitions=4, async_dispatch=False)
    for name, cols in _tables().items():
        js.register(name, **cols)
        ts.register(name, **cols)
    out = {q: sorted(ts.sql(q).rows) for q in QUERIES}
    assert out == {q: sorted(js.sql(q).rows) for q in QUERIES}
    return out


def test_server_needs_a_card_unless_told_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineError, match="device='cpu'"):
        repro_torch.QueryServer()
    srv = repro_torch.QueryServer(device="cpu")
    assert srv.session("a").device == "cpu"
    srv.close()


def test_concurrent_tenants_with_faults_match_serial(serial):
    """6 tenants × 4 queries with injected chunk faults: every result equals
    the serial run, retries stay bounded, and each distinct query compiled
    once in the shared cache (single flight)."""
    srv = _server(fault=RetryPolicy(max_retries=2, fault_hook=deterministic_fault_hook(0.3, seed=1)),
                  scale=PoolScalePolicy(min_workers=2, max_workers=4), max_pending=8, admission="block")
    errors, logs = [], []
    lock = threading.Lock()

    def tenant(tid):
        try:
            for j in range(4):
                q = QUERIES[(tid + j) % len(QUERIES)]
                r = srv.submit(q, tenant=f"t{tid}", priority=tid % 3)
                with lock:
                    logs.append(list(r.plan.dispatch_log))
                assert sorted(r.rows) == serial[q], (tid, j)
        except BaseException as e:  # noqa: BLE001 — reported on the main thread
            errors.append(e)

    threads = [threading.Thread(target=tenant, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    try:
        assert not errors, errors
        assert not any(t.is_alive() for t in threads)
        assert all(d.attempt <= 2 for log in logs for d in log)
        assert srv.plan_cache.stats()["misses"] == len(QUERIES)
        assert srv.metrics.counter("serve.chunk.retries") > 0
        assert srv.metrics.counter("serve.admitted") == 24
    finally:
        srv.close()


def test_admission_reject_when_full(serial):
    srv = _server(max_pending=1, admission="reject")
    try:
        srv._admit("a", 0)
        with pytest.raises(AdmissionError):
            srv.submit(QUERIES[0], tenant="b")
        assert srv.metrics.counter("serve.rejected") == 1
        srv._release()
        assert sorted(srv.submit(QUERIES[0], tenant="b").rows) == serial[QUERIES[0]]
    finally:
        srv.close()


def test_admission_block_waits_for_slot():
    srv = _server(max_pending=1, admission="block")
    try:
        srv._admit("a", 0)
        got = []
        t = threading.Thread(target=lambda: got.append(srv.submit(QUERIES[0], tenant="b")))
        t.start()
        time.sleep(0.1)
        assert not got
        assert srv.metrics.counter("serve.blocked") == 1
        srv._release()
        t.join(timeout=30)
        assert not t.is_alive() and got and got[0].rows is not None
    finally:
        srv.close()


def test_retry_exhaustion_raises():
    srv = _server(fault=RetryPolicy(max_retries=1, speculate=False,
                                    fault_hook=deterministic_fault_hook(1.0, max_faulty_attempts=5)))
    try:
        with pytest.raises(ChunkRetryExceeded):
            srv.submit(QUERIES[0])
        assert srv.metrics.counter("serve.chunk.retries") > 0
    finally:
        srv.close()


def test_local_pool_and_serial_fault_paths(serial):
    fault = RetryPolicy(max_retries=2, fault_hook=deterministic_fault_hook(0.3, seed=1))
    for async_dispatch in (False, True):
        s = repro_torch.Session(device="cpu", backend="partitioned", n_partitions=4,
                                async_dispatch=async_dispatch, fault=fault)
        for name, cols in _tables().items():
            s.register(name, **cols)
        r = s.sql(QUERIES[0])
        assert sorted(r.rows) == serial[QUERIES[0]]
        assert r.plan.fault_stats.retries > 0


def test_pool_scales_up_and_down():
    policy = PoolScalePolicy(min_workers=1, max_workers=4, queue_high=1.0, idle_timeout=0.05)
    pool = SharedChunkPool(policy)
    try:
        def work(ch):
            time.sleep(0.01)
            return ch[2]

        chunks = [(0, None, ChunkDispatch("op", 0, 1, 0, start=i)) for i in range(16)]
        assert len(pool.run_chunks(chunks, work)) == 16
        assert "up" in [e.kind for e in policy.events]
        deadline = time.time() + 5.0
        while pool.n_workers > 1 and time.time() < deadline:
            time.sleep(0.02)
        assert pool.n_workers == 1 and "down" in [e.kind for e in policy.events]
    finally:
        pool.close()


def test_speculation_on_straggler():
    pool = SharedChunkPool(PoolScalePolicy(min_workers=3, max_workers=3))
    try:
        def hook(d):
            if d.start == 0 and not d.speculated:
                time.sleep(0.5)

        fault = RetryPolicy(max_retries=1, speculate=True, straggler_factor=4.0, min_completed=3, fault_hook=hook)
        chunks = [(0, None, ChunkDispatch("op", 0, 1, 0, start=i)) for i in range(12)]

        def work(ch):
            time.sleep(0.01)
            return ch[2].start

        assert pool.run_chunks(chunks, work, fault=fault) == list(range(12))
        assert chunks[0][2].speculated
    finally:
        pool.close()


def test_tenant_isolation_and_shared_cache_match_jax():
    stats = {}
    for name, srv in (("jax", repro.QueryServer(n_partitions=4)), ("torch", _server())):
        try:
            if name == "jax":
                for t, cols in _tables().items():
                    srv.register(t, **cols)
            srv.submit(QUERIES[0], tenant="alice")
            srv.submit(QUERIES[0], tenant="bob")
            assert len(srv.session("alice").query_log) == 1 and srv.tenants() == ["alice", "bob"]
            stats[name] = srv.plan_cache.stats()
        finally:
            srv.close()
    assert stats["torch"] == stats["jax"] and stats["torch"]["misses"] == 1


# ---------------------------------------------------------------------------
# the adaptive loop's runtime half
# ---------------------------------------------------------------------------


def _skewed(n=120_000, seed=3):
    rng = np.random.default_rng(seed)
    return dict(v=rng.integers(0, 1024, n).astype(np.int64), w=rng.integers(0, 100, n).astype(np.int64))


Q = "SELECT v, SUM(w), MIN(w), COUNT(v) FROM t GROUP BY v"


@pytest.mark.parametrize("async_dispatch", [False, True], ids=["serial", "pool"])
def test_midrun_split_bit_identical_to_the_serial_unsplit_run(async_dispatch):
    """Held against the port's serial unsplit run: the JAX package's own
    pool path never splits here (C1).  'fixed' chunks leave pending chunks
    behind the first completions, so the pool path splits too."""
    t = _skewed()
    oracle = repro_torch.Session(device="cpu", backend="partitioned", n_partitions=8,
                                 schedule="fixed", async_dispatch=False)
    oracle.register("t", **t)
    want = repr(oracle.sql(Q).results)
    s = repro_torch.Session(device="cpu", backend="partitioned", n_partitions=8, schedule="fixed",
                            async_dispatch=async_dispatch, feedback=True)
    s._split_policy = SplitPolicy(threshold_factor=0.0, min_rows=1, min_completed=2)
    s.register("t", **t)
    r = s.sql(Q)
    assert s.metrics_registry.counter_total("replan.splits") > 0
    assert any(d.split_child for d in r.plan.dispatch_log)
    assert repr(r.results) == want


def test_split_is_off_without_feedback():
    assert repro_torch.Session(device="cpu", backend="partitioned")._split_policy_for() is None
    assert isinstance(repro_torch.Session(device="cpu", feedback=True)._split_policy_for(), SplitPolicy)


def test_replanned_results_bit_identical_and_decision_matches_jax():
    """A feedback re-plan (drift between the planner's skew estimate and the
    measured partition rows) changes the plan but not the bits; the port's
    loop replans exactly when the JAX package's does."""
    keys = np.concatenate([np.arange(0, 8 * 300, 8), [x for x in range(1, 9 * 512) if x % 8][:212]])
    rng = np.random.default_rng(0)
    v = np.repeat(keys, 160)
    rng.shuffle(v)
    w = rng.integers(0, 1000, len(v)).astype(np.int64)
    q = "SELECT v, SUM(w) FROM t GROUP BY v"
    runs = {}
    for name, mk in (("jax", lambda: repro.Session(backend="partitioned", n_partitions=8, feedback=True)),
                     ("torch", lambda: repro_torch.Session(device="cpu", backend="partitioned",
                                                           n_partitions=8, feedback=True))):
        s = mk()
        s.register("t", v=v.astype(np.int64), w=w)
        first, second = s.sql(q), s.sql(q)
        runs[name] = (sorted(first.rows), sorted(second.rows), s.metrics_registry.counter_total("replan.drift"),
                      second.decision.replanned is not None and bool(second.decision.replanned))
    assert runs["torch"][0] == runs["torch"][1] == runs["jax"][0]
    assert runs["torch"][2:] == runs["jax"][2:]


def test_shared_store_keeps_tenants_apart():
    t = _skewed(n=30_000)
    srv = repro_torch.QueryServer(device="cpu", n_partitions=8, feedback=True)
    try:
        srv.register("t", **t)
        srv.submit(Q, tenant="a")
        srv.submit(Q, tenant="b")
        assert srv.session("a").feedback is srv.feedback is srv.session("b").feedback
        fp = program_fingerprint(srv.submit(Q, tenant="a").program)
        pa, pb = srv.feedback.get(fp, tenant="a"), srv.feedback.get(fp, tenant="b")
        assert pa is not None and pb is not None and pa is not pb
        assert (pa.n_runs, pb.n_runs) == (2, 1)
        assert srv.feedback.get(fp) is None
    finally:
        srv.close()
