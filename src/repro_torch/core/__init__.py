# The paper's primary contribution — the forelem single intermediate
# representation: one IR in which query optimization, classic compiler
# optimization, parallelization, data distribution and data reformatting are
# all carried out (Rietveld & Wijshoff, 2022).
#
# Only the IR itself is imported eagerly; the executor re-exports (the
# ``lower`` shim over the pluggable ``repro_torch.backends`` package) and the
# pass pipeline load lazily via PEP 562 so that ``repro_torch.backends`` can
# import ``repro_torch.core.ir`` without a cycle.
from .ir import (  # noqa: F401
    Accumulate,
    ArrayRead,
    BinOp,
    Blocked,
    CombinePartials,
    Const,
    Distinct,
    Expr,
    FieldMatch,
    FieldRef,
    Filtered,
    ForValue,
    Forall,
    Forelem,
    FullSet,
    IndexSet,
    MultisetDecl,
    Program,
    RangePart,
    ResultAppend,
    ScalarAssign,
    Stmt,
    TupleExpr,
    TupleSchema,
    ValueRange,
    Var,
    program_str,
)

# names re-exported from the pass pipeline
_PASSES_NAMES = frozenset({"OptimizeOptions", "OptimizeResult", "optimize"})
# names re-exported from the executor-backend shim (repro_torch.backends)
_LOWER_NAMES = frozenset(
    {"CodegenChoices", "TorchLowering", "Plan", "ReferenceInterpreter", "UnsupportedProgram"}
)
# submodules importable as attributes (historically imported eagerly here)
_SUBMODULES = frozenset(
    {"transforms", "partition", "distribution", "reformat", "lower", "passes", "ir"}
)


def __getattr__(name):
    if name in _LOWER_NAMES:
        from . import lower

        return getattr(lower, name)
    if name in _PASSES_NAMES:
        from . import passes

        return getattr(passes, name)
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _LOWER_NAMES | _PASSES_NAMES | _SUBMODULES)
