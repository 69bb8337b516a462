# Build and load of the port's hand-written CUDA kernels.
#
# Each kernel's source (``csrc/*.cu``) is compiled with nvcc into a shared
# library with a plain C interface at first use, into ``build/kernels/`` at
# the repository root, under a name keyed by a hash of the source, the
# headers beside it and the flags, and loaded with ctypes.  Nothing here
# runs at import time: the CPU tests import the kernel modules on machines
# that have no nvcc and no card.
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


class CudaLibrary:
    """One kernel source, built once per source hash and loaded once per
    process.  ``configure`` sets the ctypes signatures of the library's C
    functions.  ``build_seconds`` is the time the last build of this process
    took (0.0 when the library was already on disk)."""

    def __init__(self, name: str, source: Path, configure: Callable[[ctypes.CDLL], None]) -> None:
        self.name = name
        self.source = Path(source)
        self.configure = configure
        self.build_seconds = 0.0
        self.ptxas_log = ""
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        """Keyed by the source, the headers beside it (``*.cuh``, which it
        may include) and the flags."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            path = self.path()
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(self.source)],
                    capture_output=True, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {self.source}:\n{proc.stderr}")
                os.replace(tmp, path)
                self.build_seconds = time.perf_counter() - t0
                self.ptxas_log = proc.stderr
            lib = ctypes.CDLL(str(path))
            self.configure(lib)
            self._lib = lib
            return lib


def variant(library: CudaLibrary, name: str, source: Path,
            configure: Optional[Callable[[ctypes.CDLL], None]] = None) -> CudaLibrary:
    """A build of another source of ``library``'s kernel (an earlier version,
    or an edited copy) under ``name``, for timing beside it: bound by
    ``configure``, by default ``library``'s own, so the other source must
    keep the C functions that binds (pass one that binds fewer when it
    lacks some)."""
    return CudaLibrary(name, Path(source), configure or library.configure)
