# End-to-end Big-Data analytics example of the PyTorch port (the paper's
# application class): a multi-query session over synthetic web logs
# through the unified query engine — one Session, both frontends (SQL *and*
# MapReduce), the cost-based planner choosing execution strategies per
# query (EXPLAIN shows estimates vs. choices), a shared plan cache,
# automatic reformatting (§III-C1), distribution optimization across
# queries (§III-A4) and fault-tolerant chunked execution (§III-A3) over the
# row space.  It runs on the card unless --device cpu.
#
# The counterpart of examples/bigdata_sql.py: the same tables (from
# default_rng(0)), queries, flags and printed lines, plus each query's
# segreduce launches.  ``main(argv)`` returns what it printed as a dict.
#
# Run:  PYTHONPATH=src python examples/torch_bigdata_sql.py [--rows 2000000]
#       [--planner cost|none] [--explain] [--device cpu]
import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import MapReduceSpec, Session
from repro_torch.kernels.segreduce import ops as segreduce_ops
from repro_torch.sched.fault_tolerant import HybridFaultTolerantScheduler, verify_coverage

N_SERVERS = 200

QUERIES = [
    # star-schema aggregate: GROUP BY over a two-table join — the
    # planner picks the unique-lookup join lowering for the dim table
    "SELECT s.region, COUNT(s.region), SUM(l.latency) FROM logs l, servers s "
    "WHERE l.server_id = s.id GROUP BY s.region",
    # duplicate-key join (fan-out 2, expansion lowering) + probe filter
    "SELECT l.url, m.host FROM logs l, mirrors m "
    "WHERE l.server_id = m.id AND l.status = 500",
    "SELECT url, COUNT(url) FROM logs GROUP BY url",
    "SELECT status, COUNT(status) FROM logs GROUP BY status",
    "SELECT status, SUM(latency) FROM logs GROUP BY status",
    "SELECT url FROM logs WHERE status = 500",
    "SELECT SUM(bytes) FROM logs WHERE status = 200",
    # top-k (ORDER BY/LIMIT) — the planner-relevant serving shape
    "SELECT url, COUNT(url) AS c FROM logs GROUP BY url ORDER BY c DESC LIMIT 5",
    # repeat the url-count query: identical (program, stats epoch) must
    # hit the plan cache on a cost-planned session
    "SELECT url, COUNT(url) FROM logs GROUP BY url",
]
MR_JOBS = [MapReduceSpec.count("logs", "url"), MapReduceSpec.aggregate("logs", "status", "latency", "max")]


def web_logs(n: int) -> Dict[str, Dict[str, np.ndarray]]:
    """The example's three tables, drawn from default_rng(0) in the JAX
    package's order."""
    rng = np.random.default_rng(0)
    logs = dict(
        url=np.array([f"http://s{u % 97}.com/p{u}" for u in rng.zipf(1.3, n) % 3000], dtype=object),
        status=rng.choice([200, 200, 200, 304, 404, 500], n).astype(np.int32),
        latency=rng.gamma(2.0, 30.0, n).astype(np.float32),
        bytes=rng.integers(100, 1 << 20, n).astype(np.int32),
        server_id=rng.integers(0, N_SERVERS, n).astype(np.int32),
    )
    # dimension table: unique server ids (the planner picks the cheap
    # unique-lookup join lowering for this side)
    servers = dict(id=np.arange(N_SERVERS, dtype=np.int32),
                   region=rng.integers(0, 16, N_SERVERS).astype(np.int32))
    # each server has two mirror rows — duplicate build keys force the
    # expansion join lowering
    mirrors = dict(id=np.repeat(np.arange(N_SERVERS, dtype=np.int32), 2),
                   host=rng.integers(0, 1000, 2 * N_SERVERS).astype(np.int32))
    return {"logs": logs, "servers": servers, "mirrors": mirrors}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--planner", choices=["cost", "none"], default="cost")
    ap.add_argument("--explain", action="store_true", help="print full EXPLAIN per query")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    n = args.rows
    s = Session(n_parts=8, planner=args.planner, expected_runs=12, device=args.device)
    tables = web_logs(n)
    for name, cols in tables.items():
        s.register(name, **cols)

    print(f"{n} log rows; running {len(QUERIES)} SQL queries + 2 MapReduce jobs "
          f"through the single IR (planner={args.planner}) on {s.device}\n")
    t_all = time.perf_counter()
    shown: List[Dict[str, Any]] = []

    def show(label: str, submit) -> None:
        before = dict(segreduce_ops.LAUNCHES)
        r = submit()
        launches = {k: v - before[k] for k, v in segreduce_ops.LAUNCHES.items()}
        key = next(iter(r.results))
        val = r.results[key]
        head = val[:2] if isinstance(val, list) else val
        print(f"  [{r.elapsed_s*1e3:7.1f} ms] {label}\n            -> {head}")
        entry: Dict[str, Any] = {"label": label, "results": r.results, "elapsed_s": r.elapsed_s,
                                 "cache_hit": r.cache_hit, "launches": launches, "plan": None}
        if r.decision is not None:
            c = r.decision.chosen
            pf = f"{c.partition_field[0]}.{c.partition_field[1]}" if c.partition_field else "-"
            hit = "cache HIT" if r.cache_hit else "cache MISS"
            jm = f" join={c.join_method}" if c.join_method else ""
            entry["plan"] = (f"plan: order={c.order} agg={c.agg_method} parallel={c.parallel} "
                             f"partition={pf}{jm} ({hit})")
            print(f"            {entry['plan']}")
            if args.explain and r.explain:
                print("\n".join("            " + ln for ln in r.explain.splitlines()))
        print(f"            segreduce launches {launches}")
        shown.append(entry)

    for q in QUERIES:
        show(q, lambda: s.sql(q))

    # --- MapReduce jobs through the SAME engine + planner + plan cache ------
    # the url-count job is logically identical to the SQL url-count query
    # above, so on a cost-planned session it is a plan-cache HIT
    for spec in MR_JOBS:
        show(f"MR {spec.name}({spec.table}.{spec.key_field})", lambda: s.mapreduce(spec))

    total_ms = (time.perf_counter() - t_all) * 1e3
    print(f"\nsession total: {total_ms:.1f} ms")
    out: Dict[str, Any] = {"device": s.device, "rows": n, "queries": shown, "session_ms": total_ms,
                           "session": s, "tables": tables}
    if args.planner == "cost":
        out["cache_stats"] = s.cache_stats()
        out["explain"] = s.explain(MR_JOBS[0])
        print(f"plan cache: {out['cache_stats']}")
        print("\n" + out["explain"])

    # --- the raw pipeline underneath (one low-level snippet) ----------------
    # distribution optimization across adjacent aggregates (§III-A4): the
    # two status group-by queries partition both on logs.status
    from dataclasses import replace

    from repro_torch import sql_to_forelem
    from repro_torch.core.distribution import optimize_distribution, partition_conflicts
    from repro_torch.core.ir import Program
    from repro_torch.core.transforms import iteration_space_expansion, orthogonalize

    schemas = s.schemas()
    p1 = sql_to_forelem(QUERIES[3], schemas)
    p2 = sql_to_forelem(QUERIES[4], schemas)
    combined = Program(p1.tables, p1.body + p2.body, ("R", "R2"), (), "session")
    body = list(combined.body)
    body[3] = replace(body[3], body=(replace(body[3].body[0], result="R2"),))
    combined = combined.with_body(body)
    c = orthogonalize(combined, "logs", "status", 8, which=[0])
    c = orthogonalize(c, "logs", "status", 8, partvar="k2", valvar="l2", which=[0])
    c = iteration_space_expansion(c)
    out["conflicts_before"] = len(partition_conflicts(c))
    print("\npartitioning conflicts before distribution optimization:", out["conflicts_before"])
    _, out["distribution"] = optimize_distribution(c, db=s.db)
    print("after reorder+fusion:", out["distribution"])

    # --- fault-tolerant chunked execution over the row space (§III-A3) ------
    sched = HybridFaultTolerantScheduler(total_iters=64, n_workers=8, iter_cost=0.02,
                                         checkpoint_period=0.5)
    res = sched.run(failures={3: 0.3})
    out["coverage"] = verify_coverage(res, 64)
    assert out["coverage"]
    out["schedule"] = res.summary()
    print(f"\nchunked execution with 1 injected node failure: {out['schedule']}")
    return out


if __name__ == "__main__":
    main()
