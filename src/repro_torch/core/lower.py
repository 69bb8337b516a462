# DEPRECATED compatibility shim — the executor logic lives in the pluggable
# backends package ``repro_torch.backends``:
#
#   repro_torch/backends/interface.py  ExecutorBackend protocol + registry
#   repro_torch/backends/codegen.py    pattern extraction (ProgramSpec) + helpers
#   repro_torch/backends/reference.py  ReferenceInterpreter (the oracle)
#   repro_torch/backends/torch_vec.py  TorchLowering / CodegenChoices / Plan
#
# This module re-exports the public names under the paths the JAX package's
# ``repro.core.lower`` gives them.  New code should import from
# ``repro_torch.backends`` (or go through the ``repro_torch.engine.Session``
# front door and never touch a backend directly).
#
# NOTE: submodule imports below are deliberate — ``repro_torch.backends.X``
# (not ``from repro_torch.backends import X``) keeps the import graph acyclic
# while ``repro_torch.core.__init__`` is still initializing.
from __future__ import annotations

from repro_torch.backends.codegen import (  # noqa: F401
    AggSpec,
    DistinctReadSpec,
    FilterProjectSpec,
    JoinAgg,
    JoinSpec,
    ProgramSpec,
    ScalarReduceSpec,
    UnsupportedProgram,
    cols_len_shape,
    extract_spec,
)
from repro_torch.backends.reference import (  # noqa: F401
    ReferenceBackend,
    ReferenceInterpreter,
    ReferencePlan,
)
from repro_torch.backends.torch_vec import (  # noqa: F401
    CodegenChoices,
    Plan,
    TorchBackend,
    TorchLowering,
)

__all__ = [
    "AggSpec",
    "DistinctReadSpec",
    "FilterProjectSpec",
    "JoinAgg",
    "JoinSpec",
    "ProgramSpec",
    "ScalarReduceSpec",
    "UnsupportedProgram",
    "extract_spec",
    "cols_len_shape",
    "ReferenceBackend",
    "ReferenceInterpreter",
    "ReferencePlan",
    "CodegenChoices",
    "TorchBackend",
    "TorchLowering",
    "Plan",
]
