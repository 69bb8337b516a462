#!/usr/bin/env python
# Static analysis of a query from the command line, through the PyTorch
# port: verify the frontend-produced forelem IR and run the plan linter,
# without executing anything.  The session is bound to the card unless
# --device cpu.
#
#   PYTHONPATH=src python scripts/torch_irlint.py "SELECT url, COUNT(url) FROM access GROUP BY url" \
#       --csv access=access.csv
#   PYTHONPATH=src python scripts/torch_irlint.py --demo [--device cpu]
#   PYTHONPATH=src python scripts/torch_irlint.py "SELECT ..." --csv t=data.csv --explain -K 8
#
# The counterpart of scripts/irlint.py, with its flags and output.  Table
# sources are CSV files (numeric columns are parsed as numbers, everything
# else stays a string column); ``--demo`` lints a built-in query against a
# synthetic skewed access log so the output can be inspected without any
# data on disk.  Exit status: 0 clean, 1 lint warnings only, 2 verification
# failed.
from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import Any, Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.engine import Session  # noqa: E402


def load_csv(path: str) -> Dict[str, np.ndarray]:
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    if not rows:
        raise SystemExit(f"{path}: empty CSV")
    header, data = rows[0], rows[1:]
    cols: Dict[str, np.ndarray] = {}
    for i, name in enumerate(header):
        raw: List[Any] = [r[i] for r in data]
        try:
            cols[name] = np.array([int(v) for v in raw], dtype=np.int64)
        except ValueError:
            try:
                cols[name] = np.array([float(v) for v in raw])
            except ValueError:
                cols[name] = np.array(raw, dtype=object)
    return cols


def demo_session(n_parts: int, device: Optional[str]) -> "tuple[Session, str]":
    rng = np.random.default_rng(0)
    n = 2_000
    # one dominant URL (skew), an int8 size column (overflow), a dead column
    url = np.where(rng.random(n) < 0.8, "hot.html", "cold.html").astype(object)
    size = rng.integers(50, 120, size=n).astype(np.int8)
    session = Session(n_parts=n_parts, backend="partitioned", n_partitions=n_parts, device=device)
    session.register("access", url=url, size=size, referrer=np.arange(n))
    return session, "SELECT url, SUM(size) FROM access GROUP BY url"


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="verify + lint a query's forelem IR")
    ap.add_argument("query", nargs="?", help="SQL text (omit with --demo)")
    ap.add_argument(
        "--csv", action="append", default=[], metavar="NAME=PATH",
        help="register a table from a CSV file (repeatable)",
    )
    ap.add_argument("--demo", action="store_true", help="lint a built-in skewed demo query")
    ap.add_argument("-K", "--n-parts", type=int, default=8, help="partition count the skew rule assumes")
    ap.add_argument("--explain", action="store_true", help="also print EXPLAIN with the lint block")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    if args.demo:
        session, query = demo_session(args.n_parts, args.device)
    else:
        if not args.query:
            ap.error("a query is required unless --demo is given")
        if not args.csv:
            ap.error("at least one --csv NAME=PATH table is required")
        session = Session(n_parts=args.n_parts, backend="partitioned", n_partitions=args.n_parts,
                          device=args.device)
        for spec in args.csv:
            name, _, path = spec.partition("=")
            if not path:
                ap.error(f"--csv wants NAME=PATH, got {spec!r}")
            session.register(name, **load_csv(path))
        query = args.query

    report = session.check(query)
    print(report)
    if args.explain and report.ok:
        print(session.explain(query, lint=True))
    if not report.ok:
        return 2
    return 1 if report.warnings else 0


if __name__ == "__main__":
    raise SystemExit(main())
