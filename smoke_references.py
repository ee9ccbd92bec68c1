"""Compute ``chip_smoke.py``'s two slowest plain fp64 references on the CPU
and store them with their inputs (``chip_smoke.CPU_REFERENCES``):

    python3 smoke_references.py

Phase 6's 32-point rk45 spectrum at rtol 1e-11 and phase 21's 8 rk45
cavities through rk4ip45 at rtol 1e-10 (``chip_smoke.cpu_references``).
Run it again after a change to the plain solvers or to those inputs:
``chip_smoke.py`` refuses references whose inputs are not its own.  Takes
a few minutes; needs no card.
"""

import time

import numpy as np

import chip_smoke
import psa_torch as psa


def main():
    t0 = time.perf_counter()
    refs = chip_smoke.cpu_references(psa)
    np.savez_compressed(chip_smoke.CPU_REFERENCES, **refs)
    print(f"{chip_smoke.CPU_REFERENCES}: {', '.join(sorted(refs))} "
          f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
