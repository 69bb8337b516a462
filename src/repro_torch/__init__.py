# Public API of the PyTorch port of the forelem reproduction.  It mirrors
# the JAX package ``repro`` and runs on a CUDA card by default:
#
#   >>> from repro_torch import Session, MapReduceSpec
#   >>> s = Session()                       # Session(device="cpu") on the CPU
#   >>> s.register("access", url=urls)
#   >>> s.sql("SELECT url, COUNT(url) FROM access GROUP BY url").rows
#   >>> s.mapreduce(MapReduceSpec.count("access", "url")).rows
#
# The low-level pipeline (frontend → optimize → plan.run) stays available
# for callers that need to drive individual passes.
from repro_torch.engine import AdmissionError, EngineError, QueryResult, QueryServer, Session  # noqa: F401
from repro_torch.core.passes import OptimizeOptions, OptimizeResult, optimize  # noqa: F401
from repro_torch.frontends.sql import sql_to_forelem  # noqa: F401
from repro_torch.frontends.mapreduce import MapReduceSpec  # noqa: F401
from repro_torch.data.multiset import Database, Multiset, database_from_columns  # noqa: F401
from repro_torch.obs import MetricsRegistry, QueryTrace, Tracer  # noqa: F401

__all__ = [
    "Session",
    "QueryServer",
    "AdmissionError",
    "QueryResult",
    "EngineError",
    "optimize",
    "OptimizeOptions",
    "OptimizeResult",
    "sql_to_forelem",
    "MapReduceSpec",
    "Database",
    "Multiset",
    "database_from_columns",
    "Tracer",
    "QueryTrace",
    "MetricsRegistry",
]
