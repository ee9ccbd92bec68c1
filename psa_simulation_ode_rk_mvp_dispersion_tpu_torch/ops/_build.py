"""Build the package's CUDA kernels at first use, load them with ctypes, and
count their launches.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds); the compilers of all sources run at the same time.  The libraries
land in :data:`BUILD_DIR` (:func:`build_dir`: ``build/psa_torch_kernels/`` at
the root of a checkout, the user's cache directory for an installed
package), named by a hash of the source, the ``csrc/*.cuh`` headers and the
flags, so an unchanged source is built once.  A missing ``nvcc``, a build
directory that cannot be made or a failed build raises
:class:`KernelBuildError` with the reason; there is no stand-in.

:data:`LAUNCHES` counts kernel launches by kernel name (``fwm4_rk_f64``,
``fwm4_rk45_f32``, ``comb_rk_f64``, ``comb_rk45_f32``, ...; the SSFM
sources by route, ``gnlse_ssfm_nl_f64``, ``vgnlse_ssfm_coherent_f32``,
...).  Each wrapper adds one where it launches its kernel and nowhere else;
a run clears it and reads it back to show that its path went through the
kernels.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"


def build_dir(module_file=__file__) -> Path:
    """Where the libraries go, for this module at ``module_file``: in a
    checkout (a ``pyproject.toml`` beside the package)
    ``<checkout>/build/psa_torch_kernels``, which ``.gitignore`` lists;
    in an installed package, whose directory may be read-only,
    ``$XDG_CACHE_HOME/psa_torch_kernels`` (``~/.cache`` when that is not
    set)."""
    root = Path(module_file).resolve().parents[2]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "psa_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "psa_torch_kernels"


BUILD_DIR = build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the build log
)

# Per-source additions.  The comb rk45 kernel: no FMA contraction, so that
# the kernel rounds as its plain version (one torch operation per product
# and sum) and the two take the same adaptive steps.  The 4-wave rk45 kernel
# (fwm4_rk45.cu) keeps its float32 products apart in the source instead
# (__fmul_rn), which lets its float64 instantiation use FMA; with
# contraction in float32 it took other steps on about a sixth of the lanes
# (chip_fma_ab.py builds the source with and without -fmad=false).
#
# The two sources with the most kernels: ptxas compiles their kernels on
# every core at once, which cuts the longest compile of the build (the SASS
# is the one a single-threaded ptxas makes; PERF.md).  The two longest
# builds also run nvcc's own optimizer on every core (--split-compile):
# vgnlse_ssfm.cu, the build's longest, in 170 s instead of ~250 (its SASS
# differs in 194 of 1.5 million lines), ssfm_rk45.cu with the same SASS
# (chip_build_ab.py; PERF.md).
#
# The tangent kernel (fwm4_tangent.cu): no contraction either, its fused
# multiply-adds written out, so that its two designs (a lane-direction on
# one thread and on four) round alike, bit for bit.
SOURCE_FLAGS = {"comb_rk45": ("-fmad=false",),
                "fwm4_tangent": ("-fmad=false",),
                "gnlse_ssfm": ("-Xptxas", "--split-compile=0"),
                "ssfm_rk45": ("--split-compile=0",),
                "vgnlse_ssfm": ("--split-compile=0", "-Xptxas", "--split-compile=0")}

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


def _compile(nvcc: str, src: Path, lib: Path):
    """One source's nvcc run into a temporary file beside ``lib``: (the
    temporary path, the finished process, its seconds)."""
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *_flags(src), "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    return tmp, proc, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def build() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no library for its source and
    flags yet, all at once; return ``{source stem: library path}``.  The
    compiler's output goes to a ``.log`` beside each library, after a first
    line with the seconds its nvcc took (``nvcc <source>: <s> s``)."""
    libs = {src.stem: (src, _library_path(src)) for src in sorted(CSRC_DIR.glob("*.cu"))}
    todo = [(src, lib) for src, lib in libs.values() if not lib.exists()]
    if todo:
        nvcc = find_nvcc()
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            raise KernelBuildError(
                f"cannot make the kernel build directory {BUILD_DIR}: {e}") from e
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(todo)) as pool:
            runs = [(src, lib, pool.submit(_compile, nvcc, src, lib)) for src, lib in todo]
        failed = []
        for src, lib, run in runs:
            tmp, proc, seconds = run.result()
            if proc.returncode != 0:
                failed.append(f"{lib.name}: nvcc failed with exit code {proc.returncode}:\n"
                              f"{proc.stdout}{proc.stderr}")
                continue
            lib.with_suffix(".log").write_text(
                f"nvcc {src.name}: {seconds:.1f} s\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
        if failed:
            raise KernelBuildError("\n".join(failed))
    return {name: lib for name, (_src, lib) in libs.items()}


def build_seconds() -> Dict[str, float]:
    """The seconds each current library's nvcc took (the first line of its
    ``.log``), by source stem."""
    out = {}
    for name, lib in build().items():
        log = lib.with_suffix(".log")
        first = log.read_text().split("\n", 1)[0] if log.exists() else ""
        if first.startswith("nvcc ") and first.endswith(" s"):
            out[name] = float(first.rsplit(" ", 2)[-2])
    return out


def build_log() -> str:
    """What nvcc printed when it built the current libraries (``-Xptxas -v``)."""
    logs = (lib.with_suffix(".log") for lib in build().values())
    return "".join(log.read_text() for log in logs if log.exists())


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build()[name]))
