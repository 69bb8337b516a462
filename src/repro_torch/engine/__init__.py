# Unified query engine: the Session front door routing every frontend
# (SQL, MapReduce) through one pipeline — forelem IR → distribution passes
# → cost planner → plan cache → pluggable backend lowering — and the
# multi-tenant QueryServer serving many concurrent Sessions over one
# shared chunk worker pool.
from .server import AdmissionError, QueryServer, SharedChunkPool  # noqa: F401
from .session import CheckReport, EngineError, QueryLogEntry, QueryResult, Session  # noqa: F401

__all__ = [
    "AdmissionError",
    "CheckReport",
    "EngineError",
    "QueryLogEntry",
    "QueryResult",
    "QueryServer",
    "Session",
    "SharedChunkPool",
]
