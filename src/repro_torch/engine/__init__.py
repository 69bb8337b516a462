# Unified query engine: the Session front door routing every frontend
# (SQL, MapReduce) through one pipeline — forelem IR → distribution passes
# → cost planner → plan cache → pluggable backend lowering.  The JAX
# package's multi-tenant QueryServer is not ported yet.
from .session import CheckReport, EngineError, QueryLogEntry, QueryResult, Session  # noqa: F401

__all__ = [
    "CheckReport",
    "EngineError",
    "QueryLogEntry",
    "QueryResult",
    "Session",
]
