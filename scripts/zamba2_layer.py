#!/usr/bin/env python3
"""One Mamba2 layer of zamba2-7b at chip_smoke.py phase 21's prefill shapes,
on one CUDA card: the device ms (CUDA events over repeated calls) of
``mamba2_block`` and of its parts (the input projection, the conv, the SSD,
the output projection), the SSD's costliest kernels under the profiler, and
the SSD at other chunk lengths beside the reference's 64 (their y against
chunk 64's, relative Frobenius).

    python3 scripts/zamba2_layer.py [--seed 0] [--out chiprun_out/zamba2_layer.json]

The layer's weights are drawn from ``--seed`` as phase 21 draws them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

SCENARIOS = {"a": (8, 2048), "b": (1, 16384)}  # batch, prompt
CHUNKS = (32, 64, 128)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "zamba2_layer.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("zamba2_layer: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_ms, device_us, nvidia_smi_line
    from repro_torch.configs.base import get_config
    from repro_torch.models import mamba2
    from repro_torch.models.common import init_params

    card = nvidia_smi_line()
    print(card, flush=True)
    cfg = get_config("zamba2-7b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    p = init_params(mamba2.mamba2_defs(cfg), gen, torch.device("cuda"))
    mamba2.spread_zero_inits_(p.items(), gen)
    d_in, H, P, N = mamba2.mamba2_dims(cfg)
    G = cfg.ssm.n_groups
    record: dict = {"card": card, "torch": torch.__version__}
    for name, (B, S) in SCENARIOS.items():
        x = torch.randn(B, S, cfg.d_model, device="cuda", generator=gen).to(torch.bfloat16)
        with torch.inference_mode():
            zxbcdt = mamba2.in_proj(x, p["w_in"])
            xbc = zxbcdt[..., d_in : 2 * d_in + 2 * G * N]
            conv, _ = mamba2._causal_conv1d(xbc, p["conv_w"], p["conv_b"])
            dt = mamba2._softplus(zxbcdt[..., -H:].float() + p["dt_bias"].float())
            log_decay = dt * -torch.exp(p["a_log"].float())
            xdt = conv[..., :d_in].reshape(B, S, H, P).float() * dt[..., None]
            Bg = conv[..., d_in : d_in + G * N].reshape(B, S, G, N).float()
            Cg = conv[..., d_in + G * N :].reshape(B, S, G, N).float()
            S0 = torch.zeros(B, H, P, N, device="cuda")
            y_out = torch.randn(B, S, d_in, device="cuda", generator=gen).to(torch.bfloat16)
            row = {
                "block_ms": device_ms(torch, lambda: mamba2.mamba2_block(p, x, cfg), reps=5),
                "in_proj_ms": device_ms(torch, lambda: mamba2.in_proj(x, p["w_in"]), reps=5),
                "conv_ms": device_ms(torch, lambda: mamba2._causal_conv1d(xbc, p["conv_w"], p["conv_b"]), reps=5),
                "out_proj_ms": device_ms(torch, lambda: mamba2.out_proj(y_out, p["w_out"]), reps=5),
            }
            want = mamba2.ssd_batched(xdt, log_decay, Bg, Cg, S0, 64)[0]
            for L in CHUNKS:
                row[f"ssd_L{L}_ms"] = device_ms(torch, lambda: mamba2.ssd_batched(xdt, log_decay, Bg, Cg, S0, L),
                                                reps=5)
                y = mamba2.ssd_batched(xdt, log_decay, Bg, Cg, S0, L)[0]
                row[f"ssd_L{L}_rel"] = float((y - want).norm() / want.norm())
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                mamba2.ssd_batched(xdt, log_decay, Bg, Cg, S0, 64)
                torch.cuda.synchronize()
            top = sorted(((device_us(ev) / 1e3, ev.count, ev.key) for ev in prof.key_averages()
                          if device_us(ev) > 0), reverse=True)
            row["ssd_top"] = [{"kernel": k[:100], "ms": ms, "launches": n} for ms, n, k in top[:12]]
        record[name] = row
        print(f"({name}) {B} x {S}: block {row['block_ms']:.3f} ms; in_proj {row['in_proj_ms']:.3f}, conv "
              f"{row['conv_ms']:.3f}, out_proj {row['out_proj_ms']:.3f}; SSD " + ", ".join(
                  f"L={L} {row[f'ssd_L{L}_ms']:.3f} ms (rel {row[f'ssd_L{L}_rel']:.2e})" for L in CHUNKS),
              flush=True)
        for t in row["ssd_top"]:
            print(f"    {t['ms']:8.3f} ms  x{t['launches']:<4} {t['kernel']}", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
