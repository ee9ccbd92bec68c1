"""Build the kernels with and without one extra nvcc flag on the card's
machine, and compare the build's seconds and the SASS.

    python3 chip_build_ab.py [--flag=--split-compile=0] [SOURCE ...]

The sources (stems of ``csrc/*.cu``; by default the three longest builds,
``vgnlse_ssfm``, ``ssfm_rk45`` and ``gnlse_ssfm``) get the flag on top of
``ops/_build``'s flags.  First every source is compiled at once, as
``_build.build`` does, those with the flag; then the chosen sources again
at once with ``_build``'s flags alone.  Prints each nvcc's seconds, the
first build's wall time, and for each chosen source whether
``cuobjdump -sass`` gives the same SASS both ways.  Needs ``nvcc`` and
``cuobjdump``; no card.
"""

import argparse
import concurrent.futures
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build


def compile_all(nvcc, jobs, out_dir):
    """``jobs``: ``{stem: extra flags}``; compile them all at once into
    ``out_dir``: ``({stem: seconds}, wall seconds)``."""
    def one(stem, extra):
        src = _build.CSRC_DIR / f"{stem}.cu"
        lib = out_dir / f"lib{stem}.so"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *_build._flags(src), *extra, "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {stem} {' '.join(extra)}: {proc.stderr[-3000:]}")
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        runs = {stem: pool.submit(one, stem, extra) for stem, extra in jobs.items()}
    return {stem: run.result() for stem, run in runs.items()}, time.perf_counter() - t0


def sass(cuobjdump, lib):
    """The library's SASS, without the lines that name the file."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return [ln for ln in text.splitlines() if "Fatbin" not in ln and ".so" not in ln]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flag", default="--split-compile=0")
    ap.add_argument("sources", nargs="*", default=["vgnlse_ssfm", "ssfm_rk45", "gnlse_ssfm"])
    args = ap.parse_args()
    nvcc = _build.find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    stems = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    with tempfile.TemporaryDirectory(prefix="psa_build_ab_") as tmp:
        new_dir, old_dir = Path(tmp, "new"), Path(tmp, "old")
        new_dir.mkdir()
        old_dir.mkdir()
        jobs = {s: [args.flag] if s in args.sources else [] for s in stems}
        secs, wall = compile_all(nvcc, jobs, new_dir)
        print(f"every source at once, {args.flag} on {', '.join(args.sources)}: {wall:.1f} s; "
              + ", ".join(f"{s} {secs[s]:.1f}" for s in sorted(secs, key=lambda s: -secs[s])))
        old, wall_old = compile_all(nvcc, {s: [] for s in args.sources}, old_dir)
        print(f"{', '.join(args.sources)} at once without it: {wall_old:.1f} s; "
              + ", ".join(f"{s} {old[s]:.1f}" for s in args.sources))
        same = True
        for s in args.sources:
            a, b = sass(cuobjdump, new_dir / f"lib{s}.so"), sass(cuobjdump, old_dir / f"lib{s}.so")
            diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            same &= diff == 0
            print(f"  {s}: SASS {'identical' if diff == 0 else 'DIFFERENT'} "
                  f"({len(a)} / {len(b)} lines, {diff} differ)")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
