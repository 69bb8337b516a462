# Executor-backend interface (paper §II Fig. 1): the forelem IR is the
# single intermediate; *how* an iteration is executed is a pluggable
# decision.  A backend turns a (Program, Database, CodegenChoices) triple
# into an executable plan; the registry lets the engine, the pass pipeline
# and future scale work (partitioned, async) select backends by
# name instead of growing pattern branches inside one module.
from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol, runtime_checkable


@runtime_checkable
class ExecutablePlan(Protocol):
    """What a backend's ``compile`` returns: a program bound to data, ready
    to run.  ``run`` executes and returns the program's results (multiset
    results densified to lists of tuples, scalars as Python values).

    ``tracer`` (keyword-only, default None) is a ``repro_torch.obs.Tracer``; a
    backend emits its execution spans into it — per-chunk ``dispatch``
    spans on the partitioned backend — and must treat None / the null
    tracer as the zero-overhead fast path.  Plans are cached and shared
    across queries, so the tracer is a *run-time* argument, never plan
    state."""

    program: Any  # repro_torch.core.ir.Program

    def run(
        self, params: Optional[Dict[str, Any]] = None, *, tracer: Any = None
    ) -> Dict[str, Any]:
        ...


@runtime_checkable
class ExecutorBackend(Protocol):
    """A lowering strategy for forelem programs.

    ``choices`` is a ``repro_torch.backends.torch_vec.CodegenChoices`` (or None for
    defaults); backends that have no strategy knobs may ignore it."""

    name: str

    def compile(self, program: Any, db: Any, choices: Any = None) -> ExecutablePlan:
        ...


_REGISTRY: Dict[str, ExecutorBackend] = {}


def register_backend(backend: ExecutorBackend) -> ExecutorBackend:
    """Register (or replace) a backend under ``backend.name``."""
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> ExecutorBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown executor backend {name!r}; available: {available_backends()}"
        ) from None


def available_backends() -> List[str]:
    return sorted(_REGISTRY)
