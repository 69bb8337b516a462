#!/usr/bin/env python
# Hillclimb probe runner of the PyTorch port: reckon one dry-run cell
# (launch/dryrun.run_cell on the meta device, no card needed) and print its
# peak memory and terms a device, to compare variants.
#
#   PYTHONPATH=src python scripts/torch_probe.py ARCH SHAPE TAG ['{"probe": "json"}']
#   PYTHONPATH=src python scripts/torch_probe.py starcoder2-3b train_4k base
#
# The counterpart of scripts/probe.py: the same arguments and line, the
# record written under runs/probe_torch.  The port traces where the JAX
# package compiles, so the line ends with the trace's seconds.
# ``main(argv)`` returns the record.
import json
import os
import sys
from typing import Any, Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.launch.dryrun import run_cell  # noqa: E402

OUT_DIR = "runs/probe_torch"


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        raise SystemExit("usage: torch_probe.py ARCH SHAPE TAG [PROBE_JSON]")
    arch, shape, tag = argv[0], argv[1], argv[2]
    probe = json.loads(argv[3]) if len(argv) > 3 else {}
    rec = run_cell(arch, shape, False, OUT_DIR, probe=probe, tag=tag)
    h = rec.get("ops", {})
    print(f"{tag}: peak {rec['memory']['peak_device_bytes']/1e9:.2f} GB | "
          f"dot {h.get('dot_flops',0):.3e} | traffic {h.get('traffic_bytes',0):.3e} | "
          f"coll {sum(h.get('collective_bytes',{}).values()):.3e} | trace {rec['t_trace_s']}s")
    return rec


if __name__ == "__main__":
    main()
