# The port's roofline (roofline/analysis.py) on the CPU: active_params and
# model_flops_for equal to the JAX package's for every arch and cell, the
# three terms of a synthetic record from the H100 SXM5 constants and the
# link rule (an axis group within one node of 8 GPUs over NVLink, else the
# network), and the dry run's and the analysis' command lines end to end.
import json
import os
import subprocess
import sys

import pytest

from repro.configs import base as jax_base
from repro.roofline import analysis as janalysis
from repro_torch.configs import base
from repro_torch.roofline import analysis
from test_torch_threads import cap_torch_threads, subprocess_env

cap_torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", base.list_archs())
def test_active_params_and_model_flops_equal_the_references(arch):
    cfg, jcfg = base.get_config(arch), jax_base.get_config(arch)
    assert analysis.active_params(cfg) == janalysis.active_params(jcfg)
    for shape in base.valid_cells(cfg):
        rec = {"shape": shape}
        assert analysis.model_flops_for(rec, cfg) == janalysis.model_flops_for(rec, jcfg), shape


def _record(mesh, axes, by_axes, **ops):
    sizes = [int(s) for s in mesh.split("x")]
    n = 1
    for s in sizes:
        n *= s
    return {"arch": "starcoder2-3b", "shape": "train_4k", "kind": "train", "mesh": mesh, "axes": axes,
            "n_devices": n, "n_params": 3e9, "ok": True, "memory": {"peak_device_bytes": 40e9},
            "ops": dict(ops, collective_bytes_by_axes=by_axes)}


def test_terms_from_the_h100_constants_and_the_link_rule():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.NVLINK_BW, analysis.NET_BW) == (989e12, 3.35e12, 450e9,
                                                                                           50e9)
    rec = _record("16x16", ["data", "model"], {"model": 3 * 50e9, "data": 50e9},
                  dot_flops=989e12, traffic_bytes=2 * 3.35e12, fused_traffic_bytes=3.35e12)
    row = analysis.analyze_record(rec)
    assert (row.compute_s, row.memory_s, row.memory_fused_s) == (1.0, 2.0, 1.0)
    # every axis of 16 x 16 spans more than one node of 8: the network
    assert row.collective_detail == {"model": 3.0, "data": 1.0} and row.collective_s == 4.0
    assert row.dominant == "collective" and row.roofline_frac == 0.25
    mf = analysis.model_flops_for(rec, base.get_config("starcoder2-3b"))
    assert row.model_flops == mf and row.useful_ratio == mf / (989e12 * 256)
    assert row.peak_gb == 40.0
    # 'model' of 8 within a node: NVLink; 'data' x 'model' = 256: the network
    rec = _record("32x8", ["data", "model"], {"model": 450e9, "data": 100e9}, dot_flops=989e12 * 4,
                  traffic_bytes=3.35e12, fused_traffic_bytes=3.35e12)
    row = analysis.analyze_record(rec)
    assert row.collective_detail == {"model": 1.0, "data": 2.0} and row.dominant == "compute"
    assert row.roofline_frac == 1.0
    # a group of two axes takes its outermost's rule
    assert analysis.link_bw(["pod", "data", "model"], [2, 16, 16], "pod,data") == analysis.NET_BW
    assert analysis.link_bw(["pod", "data", "model"], [1, 2, 4], "data") == analysis.NVLINK_BW
    assert analysis.analyze_record({"ok": False}) is None


def test_load_rows_and_render_table(tmp_path):
    good = _record("16x16", ["data", "model"], {"model": 50e9}, dot_flops=1e15, traffic_bytes=1e12,
                   fused_traffic_bytes=5e11)
    (tmp_path / "starcoder2-3b__train_4k__single.json").write_text(json.dumps(good))
    (tmp_path / "gemma2-9b__train_4k__single.json").write_text(json.dumps({"arch": "gemma2-9b", "ok": False}))
    rows = analysis.load_rows(str(tmp_path), "single")
    assert [r.arch for r in rows] == ["starcoder2-3b"]
    table = analysis.render_table(rows).splitlines()
    assert "fused_s" in table[0] and len(table) == 3 and "starcoder2-3b" in table[2]


def test_dryrun_and_analysis_command_lines(tmp_path):
    env = subprocess_env(PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "starcoder2-3b", "--shape",
                          "train_4k", "--mesh", "single", "--outdir", str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done: 1/1 cells ok" in out.stdout
    rec = json.loads((tmp_path / "starcoder2-3b__train_4k__single.json").read_text())
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["n_devices"] == 256 and rec["microbatches"] == 16
    assert rec["ops"]["kernels"]["flash_attention_bwd"]["calls"] == 16 * 30
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_device_bytes"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.roofline.analysis", "--outdir", str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "| starcoder2-3b " in out.stdout and "worst roofline fraction" in out.stdout
