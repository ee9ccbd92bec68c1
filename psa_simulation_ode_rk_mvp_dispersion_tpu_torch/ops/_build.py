"""Build the package's CUDA kernels at first use, load them with ctypes, and
count their launches.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds); the compilers of all sources run at the same time.  The libraries
land in ``build/psa_torch_kernels/`` at the root of the checkout, named by a
hash of the source, the ``csrc/*.cuh`` headers and the flags, so an
unchanged source is built once.  A
missing ``nvcc`` or a failed build raises :class:`KernelBuildError` with the
compiler's output; there is no stand-in.

:data:`LAUNCHES` counts kernel launches by kernel name (``fwm4_rk_f64``,
``fwm4_rk45_f32``, ``comb_rk_f64``, ``comb_rk45_f32``, ...; the SSFM
sources by route, ``gnlse_ssfm_nl_f64``, ``vgnlse_ssfm_coherent_f32``,
...).  Each wrapper adds one where it launches its kernel and nowhere else;
a run clears it and reads it back to show that its path went through the
kernels.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "psa_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the build log
)

# Per-source additions.  The rk45 kernels: no FMA contraction, so that the
# kernel rounds as its plain version (one torch operation per product and
# sum) and the two take the same adaptive steps; with contraction the fp32
# 4-wave kernel takes other steps on about a sixth of the lanes
# (chip_fma_ab.py builds both and compares them).
SOURCE_FLAGS = {"fwm4_rk45": ("-fmad=false",), "comb_rk45": ("-fmad=false",)}

LAUNCHES: "collections.Counter[str]" = collections.Counter()


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


def _flags(src: Path):
    return NVCC_FLAGS + SOURCE_FLAGS.get(src.stem, ())


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(" ".join(_flags(src)).encode())
    digest.update(src.name.encode())
    digest.update(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):   # headers a source may include
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no library for its source and
    flags yet, all at once; return ``{source stem: library path}``.  The
    compiler's output goes to a ``.log`` beside each library."""
    libs = {src.stem: (src, _library_path(src)) for src in sorted(CSRC_DIR.glob("*.cu"))}
    todo = [(src, lib) for src, lib in libs.values() if not lib.exists()]
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src, lib in todo:
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            procs.append((lib, tmp, subprocess.Popen(
                [nvcc, *_flags(src), "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for lib, tmp, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{lib.name}: nvcc failed with exit code {proc.returncode}:\n"
                              f"{out}{err}")
                continue
            lib.with_suffix(".log").write_text(out + err)
            os.replace(tmp, lib)
        if failed:
            raise KernelBuildError("\n".join(failed))
    return {name: lib for name, (_src, lib) in libs.items()}


def build_log() -> str:
    """What nvcc printed when it built the current libraries (``-Xptxas -v``)."""
    logs = (lib.with_suffix(".log") for lib in build().values())
    return "".join(log.read_text() for log in logs if log.exists())


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build()[name]))
