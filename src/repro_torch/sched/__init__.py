# Scheduling policies shared by the query engine and the LM launch stack:
# loop_schedule (chunk dispatch order/sizes for the partitioned backend),
# fault_tolerant (bounded chunk retry, straggler speculation, injectable
# faults — the QueryServer's dispatch guarantees), elastic (worker-pool
# scale up/down hysteresis).  The serving-facing names are re-exported so
# callers can write ``from repro_torch.sched import RetryPolicy, PoolScalePolicy``.
from repro_torch.sched.elastic import PoolScaleEvent, PoolScalePolicy
from repro_torch.sched.fault_tolerant import (
    ChunkRetryExceeded,
    FaultStats,
    InjectedChunkFault,
    RetryPolicy,
    StragglerDetector,
    deterministic_fault_hook,
    verify_coverage,
)
from repro_torch.sched.loop_schedule import ChunkPolicy, make_policy, simulate_schedule

__all__ = [
    "ChunkPolicy",
    "ChunkRetryExceeded",
    "FaultStats",
    "InjectedChunkFault",
    "PoolScaleEvent",
    "PoolScalePolicy",
    "RetryPolicy",
    "StragglerDetector",
    "deterministic_fault_hook",
    "make_policy",
    "simulate_schedule",
    "verify_coverage",
]
