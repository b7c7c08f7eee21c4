"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles to one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu

Builds happen at first use, into ``build/workloads_torch/`` at the root
of the checkout (listed in .gitignore), or into the directory
``set_build_dir`` names (``faststart.enable_compile_cache``).  The file
name carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one is reused; ``cache_counts`` counts both
(``hits``: found built, ``misses``: a run of nvcc).  A failed build
raises with nvcc's stderr; ptxas's register and shared-memory report is
kept beside the library (``.log``).

Nothing here runs when the module is imported: the CPU tests import it
on hosts with no nvcc.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "workloads_torch"
KERNELS = ("paged_attention", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# Kernel libraries found built (hits) and built by nvcc (misses) in this
# process; faststart.cache_stats() reads them.
cache_counts = {"hits": 0, "misses": 0}
_counts_lock = threading.Lock()


def set_build_dir(path) -> None:
    """Build and look up libraries under ``path`` from now on (libraries
    this process loaded already stay loaded)."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def _count(key: str) -> None:
    with _counts_lock:
        cache_counts[key] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin): "
        "the port's CUDA kernels build on a host with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for the current source and flags."""
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> float:
    """Build ``name``'s library unless it is built already.  Returns the
    build seconds (0.0 when reused)."""
    out = library_path(name)
    if out.exists():
        _count("hits")
        return 0.0
    _count("misses")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stderr}{proc.stdout}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """ptxas's report for ``name``'s current build ('' before a build)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """``name``'s library, built first if needed and loaded once."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
