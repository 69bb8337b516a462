# Quickstart of the PyTorch port: the paper in 80 lines, through the unified
# query engine, on the card (``--device cpu`` runs it on the CPU).
#
# 1. A Session owns the database, the cost planner and the plan cache.
# 2. SQL and MapReduce are *frontends onto the same forelem IR*: the same
#    logical query submitted either way produces identical results and
#    shares one plan-cache entry.
# 3. The super-optimizer parallelizes (indirect partitioning §III-A1),
#    reformats the data (dictionary encoding §III-C1) and cost-picks an
#    execution method for the index sets (Fig. 1).
#
# The counterpart of examples/quickstart.py: the same data, queries and
# printed lines, plus each query's agg_method and the segreduce launches
# it made.  ``main(argv)`` returns what it printed as a dict.
#
# Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
import argparse
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import MapReduceSpec, Session
from repro_torch.kernels.segreduce import ops as segreduce_ops

QUERY = "SELECT url, COUNT(url) FROM access GROUP BY url"


def launches_of(run) -> tuple:
    """``run()``'s result and the segreduce launches it made."""
    before = dict(segreduce_ops.LAUNCHES)
    out = run()
    return out, {k: n - before[k] for k, n in segreduce_ops.LAUNCHES.items()}


def plan_line(label: str, r, launches: Dict[str, int]) -> str:
    agg = r.decision.chosen.agg_method if r.decision is not None else "-"
    return f"  {label}: agg={agg} segreduce launches {launches}"


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    # --- some web-access data (strings! the compiler will reformat) -------
    rng = np.random.default_rng(0)
    urls = np.array([f"http://site{i % 23}.com/p{i % 7}" for i in rng.integers(0, 2000, 50_000)], dtype=object)

    # --- 1. the Session front door ----------------------------------------
    s = Session(n_parts=8, device=args.device)
    s.register("access", url=urls)
    print(f"session on {s.device}")

    # --- 2. SQL through the engine (paper §IV example 1) ------------------
    r_sql, sql_launches = launches_of(lambda: s.sql(QUERY))
    print(f"SQL: {len(r_sql.rows)} groups; top-3 by key: {sorted(r_sql.rows)[:3]}")
    print(plan_line("SQL", r_sql, sql_launches))
    print("\n=== planner EXPLAIN ===")
    print(s.explain(QUERY))

    # --- 3. the same logical query as a MapReduce job ---------------------
    # it maps onto the same IR, flows through the same planner, and HITS
    # the plan-cache entry the SQL query created
    r_mr, mr_launches = launches_of(lambda: s.mapreduce(MapReduceSpec.count("access", "url")))
    assert sorted(r_mr.rows) == sorted(r_sql.rows), "frontends disagree!"
    assert r_mr.cache_hit, "the MapReduce job missed the SQL query's plan-cache entry"
    print(f"\nMapReduce execution matches SQL ✓  (plan-cache hit: {r_mr.cache_hit})")
    print(plan_line("MapReduce", r_mr, mr_launches))
    print("plan cache:", s.cache_stats())

    # --- the raw pipeline still exists underneath -------------------------
    # frontend → forelem IR → optimize → plan.run, plus the reference
    # interpreter as the oracle (the IR's denotational semantics)
    from repro_torch import OptimizeOptions, optimize, sql_to_forelem
    from repro_torch.backends import ReferenceInterpreter
    from repro_torch.core import program_str

    prog = sql_to_forelem(QUERY, s.schemas())
    print("\n=== forelem IR (the single intermediate) ===")
    print(program_str(prog))
    res = optimize(prog, s.db, OptimizeOptions(n_parts=8, device=s.device))
    raw, raw_launches = launches_of(lambda: res.plan.run())
    torch_out = sorted(raw["R"])
    ref_out = sorted(ReferenceInterpreter(res.db).run(res.program)["R"])
    assert torch_out == ref_out == sorted(r_sql.rows)
    print("low-level pipeline and reference interpreter match ✓")
    print(f"  raw pipeline: segreduce launches {raw_launches}")
    return {
        "device": s.device,
        "rows": sorted(r_sql.rows),
        "mr_rows": sorted(r_mr.rows),
        "raw_rows": torch_out,
        "reference_rows": ref_out,
        "cache_hit": r_mr.cache_hit,
        "cache_stats": s.cache_stats(),
        "agg_methods": {"sql": r_sql.decision.chosen.agg_method, "mapreduce": r_mr.decision.chosen.agg_method},
        "launches": {"sql": sql_launches, "mapreduce": mr_launches, "raw": raw_launches},
        "session": s,
    }


if __name__ == "__main__":
    main()
