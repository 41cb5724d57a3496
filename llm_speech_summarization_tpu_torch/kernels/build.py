"""Build a CUDA source into a shared library with ``nvcc`` and load it with
``ctypes``.

Each library exports plain C functions. The build runs at the first
launch, into ``kernels/_build/`` (git-ignored), under a file name keyed by a
hash of the sources and the flags, so a stale build is never loaded. A
missing ``nvcc`` or a failed compile raises with the compiler's output:
no caller falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[tuple, ctypes.CDLL] = {}  # (name, sources) → library, per process
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
        "the CUDA kernels cannot be built"
    )


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (once per content hash) and load ``csrc/<sources>`` as one
    shared library. ``sources`` are file names under ``csrc/``; headers they
    include must be listed too so that an edit to one changes the hash."""
    key = (name, tuple(sources))
    if key in _loaded:  # hashed once per process: this runs at every launch
        return _loaded[key]
    paths = [CSRC_DIR / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    digest = h.hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".lib{name}_{digest}.{os.getpid()}.so"
        cu = [str(p) for p in paths if p.suffix == ".cu"]
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        (BUILD_DIR / f"lib{name}_{digest}.log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed building {name} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(lib_path))
    _loaded[key] = lib
    return lib


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``: the serving path launches kernels
    from two threads (the prompt builder and the scheduler), and a bare
    ``+= 1`` may lose a count between them."""
    with _count_lock:
        wrapper.launches += 1


def check_status(status: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
