"""Build the CUDA kernels from ``ops/csrc/`` at first use.

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded through ``ctypes`` — a file that includes no PyTorch
header builds in seconds. Libraries land in ``ops/_build/`` (git-ignored),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one loads
straight away. :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them.

``nvcc`` is found through ``$CUDA_HOME``, then ``/usr/local/cuda``, then
``PATH``. The target is ``sm_90a`` (Hopper).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load_library", "sass", "BUILD_LOG"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("paged_decode", "paged_pool", "paged_chunk", "paged_chunk_tc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# name -> {"seconds": build time (0 if cached), "ptxas": compiler report
# (kept beside the library, so a cached build reports it too)}
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
            "radixmesh_tpu_torch/ops/csrc at first use"
        )
    return found


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built;
    returns ``(process, temp path, target, t0)`` or None."""
    target = _target(name)
    if target.exists():
        report = target.with_suffix(".ptxas.txt")
        BUILD_LOG.setdefault(name, {"seconds": 0.0,
                                    "ptxas": report.read_text() if report.exists() else ""})
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target, time.monotonic()


def _finish(name: str, started) -> None:
    proc, tmp, target, t0 = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")
    target.with_suffix(".ptxas.txt").write_text(out)  # for later loads of this build
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    BUILD_LOG[name] = {"seconds": time.monotonic() - t0, "ptxas": out}


def build_all() -> dict[str, dict]:
    """Build every kernel library, one ``nvcc`` per source, all started
    together. Returns :data:`BUILD_LOG`."""
    started = {name: _start(name) for name in SOURCES}
    for name, st in started.items():
        if st is not None:
            _finish(name, st)
    return BUILD_LOG


def _ensure_built(name: str) -> Path:
    st = _start(name)
    if st is not None:
        _finish(name, st)
    return _target(name)


def load_library(name: str) -> ctypes.CDLL:
    """Load kernel library ``name``, building it first if needed."""
    return ctypes.CDLL(str(_ensure_built(name)))


def sass(name: str) -> str:
    """``cuobjdump -sass`` of kernel library ``name`` (built first if
    needed): the machine code the card runs."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(_ensure_built(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
