"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/lib<name>.so`` (plain C entry points, no PyTorch headers, so a build
takes seconds) and loaded with ``ctypes``.  Nothing is built when the
package is imported: the CPU tests import every module on machines that
have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # name -> the compiler's messages (ptxas -v)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(src.stat().st_mtime > built for src in CSRC.iterdir()
               if src.suffix in (".cu", ".cuh"))


def build(names=None) -> float:
    """Compile the named sources (default: every ``csrc/*.cu``) in parallel,
    one nvcc each, all started together.  Returns the wall seconds taken and
    raises with the compiler's output if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    compiler = nvcc()
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing or
    older than the sources."""
    if name not in _loaded:
        if _stale(name):
            build([name])
        _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return _loaded[name]
