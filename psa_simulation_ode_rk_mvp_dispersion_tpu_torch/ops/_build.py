"""Build the package's CUDA kernels at first use and load them with ctypes.

``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).  The
library lands in ``build/psa_torch_kernels/`` at the root of the checkout,
named by a hash of the sources and flags, so an unchanged source is built
once.  A missing ``nvcc`` or a failed build raises :class:`KernelBuildError`
with the compiler's output; there is no stand-in.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "psa_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the build log
)


class KernelBuildError(RuntimeError):
    """nvcc was not found or did not compile the kernels."""


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit's
    standard location (the search ``torch.utils.cpp_extension`` makes)."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise KernelBuildError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit or put nvcc on PATH")


@functools.lru_cache(maxsize=None)
def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library for these sources and flags
    exists; return its path.  The compiler's output goes to a ``.log``
    beside it."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libpsa_torch_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    """What nvcc printed when it built the current library (``-Xptxas -v``)."""
    log = build().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))
