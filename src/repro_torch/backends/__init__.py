# Pluggable executor backends for the forelem single intermediate
# (paper §II Fig. 1, §III-B): "At a later compilation stage, the compiler
# determines how to actually execute the iteration specified by a forelem
# loop and accompanied index set."
#
#   interface.py  ExecutorBackend protocol + named registry,
#   codegen.py    shared pattern extraction (ProgramSpec) + helpers,
#   dtypes.py     how host columns and constants become tensors,
#   reference.py  the oracle interpreter backend ('reference'),
#   torch_vec.py  the vectorized PyTorch lowering ('torch'),
#   partitioned.py K-way data distribution + scheduled chunk dispatch over
#                 the torch_vec kernels ('partitioned').
#
# ``repro_torch.core.lower`` remains as a thin compatibility shim
# re-exporting these names; new code should import from here (or use the
# registry).
from .interface import (  # noqa: F401
    ExecutablePlan,
    ExecutorBackend,
    available_backends,
    get_backend,
    register_backend,
)
from .codegen import (  # noqa: F401
    FUSABLE_AGG_OPS,
    AggSpec,
    DistinctReadSpec,
    FilterProjectSpec,
    JoinAgg,
    JoinSpec,
    ProgramSpec,
    ScalarReduceSpec,
    UnsupportedProgram,
    extract_spec,
    fused_agg_groups,
)
from .reference import ReferenceBackend, ReferenceInterpreter, ReferencePlan  # noqa: F401
from .torch_vec import CodegenChoices, Plan, TorchBackend, TorchLowering  # noqa: F401
from .partitioned import (  # noqa: F401
    PartitionedBackend,
    PartitionedChoices,
    PartitionedPlan,
)

__all__ = [
    "ExecutablePlan",
    "ExecutorBackend",
    "available_backends",
    "get_backend",
    "register_backend",
    "AggSpec",
    "DistinctReadSpec",
    "FilterProjectSpec",
    "JoinAgg",
    "JoinSpec",
    "ProgramSpec",
    "ScalarReduceSpec",
    "UnsupportedProgram",
    "extract_spec",
    "ReferenceBackend",
    "ReferenceInterpreter",
    "ReferencePlan",
    "CodegenChoices",
    "PartitionedBackend",
    "PartitionedChoices",
    "PartitionedPlan",
    "Plan",
    "TorchBackend",
    "TorchLowering",
]
