# The PyTorch port stands alone: importing it and its main modules loads
# neither jax nor any module of the JAX package ``repro``.
import json
import os
import re
import subprocess
import sys

import pytest

from test_torch_threads import cap_torch_threads, subprocess_env

cap_torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")

_PROBE = """
import json, sys
import repro_torch
import repro_torch.engine.session
import repro_torch.core.passes
import repro_torch.planner
import repro_torch.backends.torch_vec
import repro_torch.backends.reference
import repro_torch.kernels.segreduce.ops
import repro_torch.kernels.segreduce.kernel
import repro_torch.frontends.sql
import repro_torch.frontends.mapreduce
import repro_torch.analysis
import repro_torch.obs
import repro_torch.kernels._build
import repro_torch.kernels._agreement
import repro_torch.kernels.flash.ops
import repro_torch.kernels.flash.kernel
import repro_torch.kernels.flash.ref
import repro_torch.kernels.wkv6.ops
import repro_torch.kernels.wkv6.kernel
import repro_torch.kernels.wkv6.ref
import repro_torch.models.rwkv6
import repro_torch.configs.base
import repro_torch.models.common
import repro_torch.models.mlp
import repro_torch.models.moe
import repro_torch.models.attention
import repro_torch.models.transformer
import repro_torch.models.convert
import repro_torch.serve.kvcache
import repro_torch.serve.step
import repro_torch.launch.serve
import repro_torch.sched
import repro_torch.sched.loop_schedule
import repro_torch.sched.fault_tolerant
import repro_torch.sched.elastic
import repro_torch.frontends.export_mr
import repro_torch.core.lower
import repro_torch.backends.partitioned
import repro_torch.engine.server
import repro_torch.data.pipeline
import repro_torch.train.optimizer
import repro_torch.train.grad_compress
import repro_torch.train.checkpoint
import repro_torch.train.step
import repro_torch.launch.train
import repro_torch.models.shardctx
import repro_torch.launch.mesh
import repro_torch.launch.sharding
import repro_torch.launch.specs
import repro_torch.launch.dryrun
import repro_torch.roofline.op_count
import repro_torch.roofline.analysis
from repro_torch import QueryServer
from repro_torch.configs.base import list_archs
assert len(list_archs()) == 10
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(json.dumps(bad))
"""


def test_import_loads_neither_jax_nor_repro():
    env = subprocess_env(PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, env=env, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_name_neither_jax_nor_repro():
    """No import line of the port or of chip_smoke.py names jax or repro."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as fh:
            for ln, line in enumerate(fh, 1):
                if _FORBIDDEN.match(line):
                    bad.append(f"{path}:{ln}: {line.strip()}")
    assert bad == []


# the port's examples and command-line tools (each runs on the card unless
# given --device cpu; the trace summary and the probe need no card)
TOOLS = [
    "examples/torch_quickstart.py",
    "examples/torch_bigdata_sql.py",
    "examples/torch_serve_lm.py",
    "examples/torch_train_lm.py",
    "scripts/torch_irlint.py",
    "scripts/torch_trace_summary.py",
    "scripts/torch_probe.py",
]

_LOAD_TOOLS = """
import importlib.util, json, sys
for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"tool{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(json.dumps(bad))
"""


@pytest.mark.parametrize("rel", TOOLS)
def test_tool_sources_name_neither_jax_nor_repro(rel):
    with open(os.path.join(ROOT, rel)) as fh:
        bad = [f"{rel}:{ln}: {line.strip()}" for ln, line in enumerate(fh, 1) if _FORBIDDEN.match(line)]
    assert bad == []


def test_loading_the_tools_loads_neither_jax_nor_repro():
    env = subprocess_env(PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _LOAD_TOOLS] + [os.path.join(ROOT, t) for t in TOOLS],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
