"""Build CUDA sources into a shared library at first use and load it.

``nvcc`` compiles each library once per source content into
``build/kernels/`` at the root of the checkout, named by a hash of the
sources, and the library is loaded with ``ctypes``. The C entry points
take plain pointers and ints (no PyTorch headers), which keeps a build
to seconds.

Nothing here runs at import: :func:`load_library` is called by a kernel
wrapper the first time it launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "load_library"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``; raises when the toolkit is missing."""
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin): the CUDA kernels cannot be built")


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Compile ``sources`` into ``build/kernels/<name>-<hash>.so`` unless
    that file exists, then load it (once per process)."""
    sources = [Path(s) for s in sources]
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        out = BUILD_DIR / f"{name}-{_digest(sources)}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(s) for s in sources]]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}) for "
                                   f"{name}:\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _LOADED[name] = lib
        return lib
