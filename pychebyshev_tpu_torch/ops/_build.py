"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, and loaded with
``ctypes``.  The build happens at first use, into
``pychebyshev_tpu_torch/_build/`` (git-ignored), under a name that
carries the hash of the source, so an edited source is rebuilt.  Only
the sources in this package are built.  ``ptxas``'s report of each
kernel's registers, spills and static shared memory is kept beside the
library (``build_log``).  A missing ``nvcc`` or a failed compile raises
with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "build_log", "find_nvcc", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install location.  Raises if none has it."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        candidates.append(Path(cuda_home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(_DEFAULT_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{_DEFAULT_NVCC}); the CUDA kernels of pychebyshev_tpu_torch "
        "are built from source at first use and need the CUDA toolkit")


def _compile(src: Path, out: Path) -> None:
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {src.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    log = build_log(out)
    log_tmp = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    log_tmp.write_text(proc.stdout + proc.stderr)
    os.replace(log_tmp, log)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half


def build_log(lib_path) -> Path:
    """Where the compiler's report of the library at ``lib_path`` is
    kept (``ptxas -v``: registers, spills, static shared memory)."""
    return Path(lib_path).with_suffix(".ptxas.txt")


@functools.lru_cache(maxsize=None)
def _load(name: str, digest: str) -> ctypes.CDLL:
    lib_path = _BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib_path.is_file():
        _compile(_CSRC / f"{name}.cu", lib_path)
    return ctypes.CDLL(str(lib_path))


def load_library(name: str) -> ctypes.CDLL:
    """The compiled ``csrc/<name>.cu``, built first if its source hash
    has no library yet.  The caller declares ``argtypes``/``restype``."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return _load(name, digest)
