# Elastic scaling of the worker set (beyond-paper, required for 1000+-node
# deployments): when pod-slices die or join, the runtime re-plans the device
# mesh, restores from the latest checkpoint, and resumes the chunk queue.
#
# The paper's dynamic scheduling gives the *work* side of elasticity ("the
# code automatically adapts to different clusters and different compute node
# assignments"); this module gives the *mesh* side.
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class MeshPlan:
    """A concrete mesh shape for the surviving device set."""

    n_devices: int
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def data_parallel(self) -> int:
        return self.shape[self.axes.index("data")] if "data" in self.axes else 1

    @property
    def model_parallel(self) -> int:
        return self.shape[self.axes.index("model")] if "model" in self.axes else 1


def plan_mesh(n_devices: int, model_parallel: int, pods: int = 1) -> MeshPlan:
    """Largest usable mesh with a fixed model-parallel minor axis.

    Devices that do not fit a full data-parallel replica are left idle —
    training correctness requires whole replicas (an SPMD chunk is the
    static schedule of the paper's hybrid scheme; it cannot run on a
    partial replica)."""
    if n_devices < model_parallel:
        raise ValueError(f"{n_devices} devices cannot host model_parallel={model_parallel}")
    replicas = n_devices // model_parallel
    if pods > 1 and replicas % pods == 0:
        return MeshPlan(pods * (replicas // pods) * model_parallel, (pods, replicas // pods, model_parallel), ("pod", "data", "model"))
    return MeshPlan(replicas * model_parallel, (replicas, model_parallel), ("data", "model"))


@dataclass
class ScaleEvent:
    time: float
    kind: str  # 'lost' | 'joined'
    n_devices: int
    plan: MeshPlan
    restored_from_step: int


class ElasticController:
    """Tracks the live device count and decides when to re-mesh.

    Policy: re-mesh immediately on any loss (a collective with a dead
    participant deadlocks — the survivors must restart from checkpoint);
    batch joins with hysteresis `join_delay` so a trickle of rejoining hosts
    does not thrash the compilation cache."""

    def __init__(self, n_devices: int, model_parallel: int, pods: int = 1, join_delay: float = 300.0):
        self.model_parallel = model_parallel
        self.pods = pods
        self.join_delay = join_delay
        self.n_live = n_devices
        self.pending_join = 0
        self.first_pending_t: Optional[float] = None
        self.events: List[ScaleEvent] = []
        self.plan = plan_mesh(n_devices, model_parallel, pods)

    def on_loss(self, t: float, n_lost: int, last_ckpt_step: int) -> MeshPlan:
        self.n_live -= n_lost
        pods = self.pods if self.n_live >= 2 * (self.plan.n_devices // max(self.pods, 1)) else 1
        self.plan = plan_mesh(self.n_live, self.model_parallel, pods)
        self.events.append(ScaleEvent(t, "lost", self.n_live, self.plan, last_ckpt_step))
        return self.plan

    def on_join(self, t: float, n_joined: int, last_ckpt_step: int) -> Optional[MeshPlan]:
        self.pending_join += n_joined
        if self.first_pending_t is None:
            self.first_pending_t = t
        # hysteresis: batch a trickle of rejoining hosts; remesh only once
        # `join_delay` has elapsed since the first pending join (or a full
        # replica's worth of devices is waiting)
        if t - self.first_pending_t < self.join_delay and self.pending_join < self.model_parallel:
            return None
        self.n_live += self.pending_join
        self.pending_join = 0
        self.first_pending_t = None
        self.plan = plan_mesh(self.n_live, self.model_parallel, self.pods)
        self.events.append(ScaleEvent(t, "joined", self.n_live, self.plan, last_ckpt_step))
        return self.plan

    def rescale_batch(self, global_batch: int) -> Tuple[int, int]:
        """Keep the global batch constant across re-meshing by adjusting
        gradient-accumulation steps: returns (per_replica_batch, accum)."""
        replicas = self.plan.data_parallel * (self.plan.shape[0] if "pod" in self.plan.axes else 1)
        accum = max(1, math.ceil(global_batch / max(replicas, 1)))
        per_replica = max(1, global_batch // (replicas * accum))
        return per_replica, accum


# ---------------------------------------------------------------------------
# Worker-pool elasticity (the serving engine's shared chunk pool)
# ---------------------------------------------------------------------------


@dataclass
class PoolScaleEvent:
    """One scale decision of a ``PoolScalePolicy`` (the pool analogue of
    ``ScaleEvent``)."""

    time: float
    kind: str            # 'up' | 'down'
    n_workers: int       # worker count after the decision
    queue_depth: int


@dataclass
class PoolScalePolicy:
    """Queue-depth-driven worker scale-up/down with hysteresis — the same
    batching idea as ``ElasticController.join_delay``, applied to a thread
    worker pool instead of a device mesh.

    Scale up when the chunk queue holds more than ``queue_high`` pending
    chunks per live worker, but only after the pressure has persisted for
    ``grow_delay`` seconds (a momentary burst of tiny chunks must not
    thrash thread creation the way a trickle of rejoining hosts must not
    thrash the compile cache).  Scale down is decided by the workers
    themselves: a worker idle longer than ``idle_timeout`` retires, never
    below ``min_workers``.  Thread-safe: pool workers and submitters
    consult one policy concurrently."""

    min_workers: int = 1
    max_workers: int = 8
    queue_high: float = 2.0       # pending chunks per worker that mean pressure
    grow_delay: float = 0.0       # seconds of sustained pressure before growing
    idle_timeout: float = 0.25    # seconds a worker may idle before retiring
    events: List[PoolScaleEvent] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _pressure_t0: Optional[float] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        if not 1 <= self.min_workers <= self.max_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{self.min_workers}..{self.max_workers}"
            )

    def initial_workers(self) -> int:
        return self.min_workers

    def want_grow(self, queue_depth: int, n_workers: int, now: float) -> bool:
        """True when the pool should add one worker: sustained queue
        pressure and headroom below ``max_workers``."""
        with self._lock:
            if n_workers >= self.max_workers:
                self._pressure_t0 = None
                return False
            pressured = queue_depth > self.queue_high * max(1, n_workers)
            if not pressured:
                self._pressure_t0 = None
                return False
            if self._pressure_t0 is None:
                self._pressure_t0 = now
            if now - self._pressure_t0 < self.grow_delay:
                return False
            self._pressure_t0 = None  # re-arm the hysteresis window
            return True

    def want_shrink(self, idle_s: float, n_workers: int) -> bool:
        """True when an idle worker should retire (called by the worker
        itself after waiting ``idle_s`` without work)."""
        return n_workers > self.min_workers and idle_s >= self.idle_timeout

    def note(self, kind: str, n_workers: int, queue_depth: int, now: float) -> PoolScaleEvent:
        ev = PoolScaleEvent(now, kind, n_workers, queue_depth)
        with self._lock:
            self.events.append(ev)
        return ev
