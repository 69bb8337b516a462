# Static analysis over the forelem IR (the correctness substrate of the
# pass pipeline):
#
#   verify.py  IR verifier — schema/dtype inference, Var/FieldRef/ArrayRead
#              scope checks and index-set well-formedness, run after every
#              pass in core/passes.optimize under REPRO_VERIFY_IR,
#   deps.py    dependence & legality — read/write sets, accumulate-op
#              algebra (commutativity/associativity), loop-carried
#              dependence tests and the partitionability proof the planner
#              consults before admitting a (K, schedule) candidate,
#   lint.py    plan linter — advisory findings (unused columns, partition
#              skew, pushable filters, SUM overflow) behind Session.check,
#              explain(lint=True) and scripts/irlint.py.
#
# This package imports only repro_torch.core.ir (+ numpy) so that core.transforms
# and the backends can depend on it without cycles.
from .deps import (
    ACCUM_OPS,
    OpAlgebra,
    accum_ops,
    accumulate_ops,
    expr_array_reads,
    independent,
    is_mergeable,
    merge_illegal_ops,
    op_algebra,
    parallelization_hazards,
    partitionable,
    required_fields,
    stmt_reads,
    stmt_writes,
    unknown_stmts,
)
from .lint import LintWarning, lint_program, render_lint
from .verify import IRVerificationError, verify_enabled, verify_program

__all__ = [
    "ACCUM_OPS",
    "OpAlgebra",
    "accum_ops",
    "accumulate_ops",
    "expr_array_reads",
    "independent",
    "is_mergeable",
    "merge_illegal_ops",
    "op_algebra",
    "parallelization_hazards",
    "partitionable",
    "required_fields",
    "stmt_reads",
    "stmt_writes",
    "unknown_stmts",
    "LintWarning",
    "lint_program",
    "render_lint",
    "IRVerificationError",
    "verify_enabled",
    "verify_program",
]
