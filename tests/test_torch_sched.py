# The port's scheduling policies (repro_torch.sched, copies of the JAX
# package's numpy-only sched/) against the JAX package's on the same
# inputs: chunk sizes, simulated schedules and their imbalance, the hybrid
# fault-tolerant scheduler's retries and speculation, straggler and retry
# decisions, and pool scale events.  Every result must be equal, floats
# included: the two run the same numpy code.
import numpy as np
import pytest

from repro.sched import elastic as jel
from repro.sched import fault_tolerant as jft
from repro.sched import loop_schedule as jls
from repro_torch.sched import elastic as tel
from repro_torch.sched import fault_tolerant as tft
from repro_torch.sched import loop_schedule as tls
from test_torch_threads import cap_torch_threads

cap_torch_threads()

POLICIES = ("static", "fixed", "gss", "guided", "tss", "factoring", "feedback")


def _sizes(mod, name, total, k, **kw):
    pol = mod.make_policy(name, total, k, **kw)
    pol.reset()
    out, rem, w = [], total, 0
    while rem > 0:
        c = max(1, min(pol.next_chunk(rem, k, w % k, []), rem))
        out.append(c)
        rem -= c
        w += 1
    return out


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("total,k", [(1000, 4), (59_999, 8), (7, 3)])
def test_chunk_sizes_match(name, total, k):
    kw = {"min_chunk": max(1, total // (16 * k))} if name in ("gss", "guided") else {}
    assert _sizes(tls, name, total, k, **kw) == _sizes(jls, name, total, k, **kw)


@pytest.mark.parametrize("name", ("static", "gss", "tss", "factoring", "feedback"))
def test_simulated_schedules_match(name):
    costs = np.random.default_rng(4).uniform(0.5, 1.5, 3000)
    kw = dict(worker_speed=[1.0] * 5 + [0.3], failures={2: 40.0}, dispatch_overhead=0.01)
    t = tls.simulate_schedule(tls.make_policy(name, len(costs), 6), costs, 6, **kw)
    j = jls.simulate_schedule(jls.make_policy(name, len(costs), 6), costs, 6, **kw)
    assert (t.makespan, t.n_dispatches, t.iterations_done, t.rescheduled_iters) == (
        j.makespan, j.n_dispatches, j.iterations_done, j.rescheduled_iters)
    assert t.per_worker_busy == j.per_worker_busy
    assert t.imbalance() == j.imbalance()
    assert [(r.worker, r.start_iter, r.size, r.t_end) for r in t.records] == [
        (r.worker, r.start_iter, r.size, r.t_end) for r in j.records]


def test_busy_times_and_imbalance_match():
    pairs = [(w % 3, float(t)) for w, t in enumerate(np.random.default_rng(5).uniform(0, 9, 40))]
    tb, jb = tls.busy_times(pairs), jls.busy_times(pairs)
    assert tb == jb and tls.worker_imbalance(tb) == jls.worker_imbalance(jb)


@pytest.mark.parametrize("failures", [None, {0: 0.5, 3: 2.0}])
def test_hybrid_scheduler_retries_and_speculation_match(failures):
    kw = dict(iter_cost=0.01, checkpoint_period=2.0, worker_speed=[1] * 5 + [0.2])
    t = tft.HybridFaultTolerantScheduler(4000, 6, **kw).run(failures=failures)
    j = jft.HybridFaultTolerantScheduler(4000, 6, **kw).run(failures=failures)
    assert t.summary() == j.summary()
    assert t.completed == j.completed
    assert [(e.time, e.kind, e.worker) for e in t.events] == [(e.time, e.kind, e.worker) for e in j.events]
    assert tft.verify_coverage(t, 4000) and jft.verify_coverage(j, 4000)


def test_straggler_and_retry_decisions_match():
    times = np.random.default_rng(6).gamma(2.0, 3.0, 50)
    td, jd = tft.StragglerDetector(3.0, 4), jft.StragglerDetector(3.0, 4)
    for t in times:
        td.record(float(t))
        jd.record(float(t))
        assert td.threshold_ms() == jd.threshold_ms()
        assert td.is_straggler(2.5 * float(t)) == jd.is_straggler(2.5 * float(t))
    tp, jp = tft.RetryPolicy(max_retries=2), jft.RetryPolicy(max_retries=2)
    assert [tp.retryable(a) for a in range(4)] == [jp.retryable(a) for a in range(4)]


def test_deterministic_fault_hook_matches():
    from repro.backends.partitioned import ChunkDispatch as JD
    from repro_torch.backends.partitioned import ChunkDispatch as TD

    th = tft.deterministic_fault_hook(0.3, seed=7)
    jh = jft.deterministic_fault_hook(0.3, seed=7)

    def fires(hook, d):
        try:
            hook(d)
            return False
        except RuntimeError:
            return True

    for p in range(8):
        for attempt in range(3):
            args = dict(op="agg:a0", partition=p, rows=100, worker=0, start=p * 100, attempt=attempt)
            assert fires(th, TD(**args)) == fires(jh, JD(**args))


def test_pool_scale_events_match():
    def drive(mod):
        pol = mod.PoolScalePolicy(min_workers=1, max_workers=4, queue_high=2.0, grow_delay=0.5)
        n = 1
        for t, depth in enumerate([1, 5, 9, 9, 12, 3, 20, 20, 0]):
            while pol.want_grow(depth, n, float(t)):
                n += 1
                pol.note("up", n, depth, float(t))
            if pol.want_shrink(0.3 * t, n):
                n -= 1
                pol.note("down", n, depth, float(t))
        return [(e.time, e.kind, e.n_workers, e.queue_depth) for e in pol.events]

    assert drive(tel) == drive(jel)


def test_elastic_remesh_matches():
    tc, jc = tel.ElasticController(512, model_parallel=16, pods=2), jel.ElasticController(512, 16, 2)
    assert tc.plan.shape == jc.plan.shape
    assert tc.on_loss(10.0, 16, 100).shape == jc.on_loss(10.0, 16, 100).shape
    assert tc.rescale_batch(256) == jc.rescale_batch(256)
    assert (tc.on_join(11.0, 8, 100) is None) == (jc.on_join(11.0, 8, 100) is None)
