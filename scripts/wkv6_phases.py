#!/usr/bin/env python3
# Where the chunked WKV6 kernel's time goes inside a block: builds a copy of
# kernels/wkv6/csrc/wkv6.cu with clock64() marks written into the scan's
# chunk loop (thread 0 of every block adds the cycles of each phase of each
# chunk to device counters; the marks sit at anchors of the source, and the
# script stops if one is not found once), runs it at rwkv6-3b's serving
# shapes in one pass, and prints the cycles a chunk of each phase; then the
# SASS instruction mix of the scan's instance at K = 64, bf16 (cuobjdump).
# Needs one CUDA card.
#
#   python3 scripts/wkv6_phases.py [--out build/wkv6_phases.json]
import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.wkv6 import kernel  # noqa: E402

PHASES = {0: "wait for the ring", 1: "decayed operands", 3: "A", 4: "products"}  # the WKV_MARK numbers below
SHAPES = {"a": (8, 2048), "b": (1, 16384)}
H, K = 40, 64

# The counters and the marks, put before the first device function of the
# copy; WKV_MARK(p) adds the cycles since the last mark to phase p (none
# for p < 0), and [7] counts the chunks.
MARKS = """#define WKV_PHASES 8
__device__ unsigned long long wkv6_phase_cycles[WKV_PHASES];
#define WKV_MARK(phase)                                                                             \\
    do {                                                                                            \\
        const long long now_ = clock64();                                                           \\
        if (threadIdx.x == 0 && (phase) >= 0) atomicAdd(&wkv6_phase_cycles[(phase)], now_ - mark_); \\
        mark_ = now_;                                                                               \\
    } while (0)

"""
# Copies the counters out and clears them; appended to the copy.
READER = """
extern "C" int wkv6_phases(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, wkv6_phase_cycles, sizeof(unsigned long long) * WKV_PHASES);
    if (e != cudaSuccess) return (int)e;
    unsigned long long zero[WKV_PHASES] = {};
    return (int)cudaMemcpyToSymbol(wkv6_phase_cycles, zero, sizeof(zero));
}
"""
# (anchor in wkv6_chunks, what replaces it): the marks around each phase
ANCHORS = (
    ("    cp_async_commit();\n    for (int ci = 0; ci < n_chunks; ++ci) {\n        const int tc = t_begin + ci * L;\n",
     "    cp_async_commit();\n    long long mark_ = clock64();\n    for (int ci = 0; ci < n_chunks; ++ci) {\n"
     "        const int tc = t_begin + ci * L;\n        WKV_MARK(-1);\n"),
    ("        __syncthreads();  // this chunk has landed, and the last chunk's products are done\n",
     "        __syncthreads();  // this chunk has landed, and the last chunk's products are done\n"
     "        WKV_MARK(0);\n"),
    ("        __syncthreads();  // cum and R~, K~, for A\n",
     "        __syncthreads();  // cum and R~, K~, for A\n        WKV_MARK(1);\n"),
    ("        fence_async_smem();\n        __syncthreads();\n\n        // 3. the products",
     "        fence_async_smem();\n        __syncthreads();\n        WKV_MARK(3);\n\n        // 3. the products"),
    ("            }\n        }\n    }\n\n    if (holds && seg == n_seg - 1) {",
     "            }\n        }\n        WKV_MARK(4);\n        if (tid == 0) atomicAdd(&wkv6_phase_cycles[7], 1ull);\n"
     "    }\n\n    if (holds && seg == n_seg - 1) {"),
)


def profiled_source(text: str) -> str:
    """The kernel's source with the marks of ``ANCHORS`` and the counters."""
    for anchor, marked in ANCHORS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"wkv6_phases: the anchor {anchor!r} is not in the source once")
        text = text.replace(anchor, marked)
    first = text.index("__device__")
    return text[:first] + MARKS + text[first:] + READER


def _configure(lib: ctypes.CDLL) -> None:
    kernel.configure_launches(lib)
    lib.wkv6_phases.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.wkv6_phases.restype = ctypes.c_int


def sass_mix(so: str, listing: str = "") -> dict:
    """Opcode counts of the scan's instance (bf16, K = 64, with y) in the
    built library's SASS, whose text goes to ``listing`` when given."""
    name = f"_Z11wkv6_chunksI13__nv_bfloat16Li64ELi{kernel.CHUNK}E"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True).stdout
    body, text, inside = [], [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = name in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                body.append(m.group(2).split(".")[0])
                text.append(line)
    if listing:
        with open(listing, "w") as fh:
            fh.write("\n".join(text))
    return dict(collections.Counter(body).most_common())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "wkv6_phases.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wkv6_phases: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "build", "wkv6_profile", "wkv6.cu")
    os.makedirs(os.path.dirname(src), exist_ok=True)
    with open(kernel.SOURCE) as fh, open(src, "w") as out:
        out.write(profiled_source(fh.read()))
    lib = _build.variant(kernel.LIBRARY, "wkv6_profile", src, _configure)
    lib.load()
    record = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True).stdout.strip(), "chunk": kernel.CHUNK}
    print(record["card"], flush=True)
    counters = (ctypes.c_ulonglong * 8)()
    for name, (B, S) in SHAPES.items():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        r, k, v = ((0.5 * torch.randn(B, S, H, K, device="cuda", generator=gen)).bfloat16() for _ in range(3))
        lw = -torch.exp(torch.randn(B, S, H, K, device="cuda", generator=gen))
        u = 0.3 * torch.randn(H, K, device="cuda", generator=gen)
        kernel.launch(r, k, v, lw, u, None, lib=lib, n_seg=1)
        torch.cuda.synchronize()
        lib.load().wkv6_phases(counters)  # clears the warm-up's counts
        kernel.launch(r, k, v, lw, u, None, lib=lib, n_seg=1)
        torch.cuda.synchronize()
        if lib.load().wkv6_phases(counters) != 0:
            raise RuntimeError("wkv6_phases failed")
        chunks = max(counters[7], 1)
        per = {p: counters[i] / chunks for i, p in PHASES.items()}
        record[name] = {"chunks": counters[7], "cycles_a_chunk": per}
        print(f"({name}) B={B} S={S}, one pass, L={kernel.CHUNK}: {counters[7]} block-chunks; cycles a chunk: "
              + ", ".join(f"{p} {c:.0f}" for p, c in per.items()) + f"; total {sum(per.values()):.0f}", flush=True)
    so = str(lib.path())
    mix = sass_mix(so, os.path.splitext(args.out)[0] + ".sass")
    record["sass_mix"] = mix
    print(f"SASS of the scan (bf16, K=64, L={kernel.CHUNK}): {sum(mix.values())} instructions; "
          + ", ".join(f"{op} {n}" for op, n in list(mix.items())[:24]), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
