"""Frozen operation and byte counts of the port's kernels, and the peaks of
the card they are held to.

Copied from ``chip_smoke.py`` at the commit that introduced this benchmark,
so that a later change to the program cannot move the yardstick.  Each
count is the least work the algorithm needs at its shapes, whatever the
kernel does; a fused multiply-add counts as two operations.
"""

from __future__ import annotations

# chip_smoke.py:252-253: peaks of one H100 SXM (NVIDIA data sheet, outside
# the tensor cores, at the 700 W limit) and its memory rate.
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# chip_smoke.py:262-265: one 4-wave RHS is 111 flop; an RK4 step is 4 RHS
# + 88 for the stage sums + the update (8 in float64, 32 compensated in
# float32); every save adds 16 (|y|^2 and the running max).
RHS_FLOP = 111
RK4_STEP_FLOP = {"float64": 4 * RHS_FLOP + 88 + 8, "float32": 4 * RHS_FLOP + 88 + 32}
SAVE_FLOP = 16


def fwm4_rk_work(lanes: int, n_steps: int, save_every: int, dtype: str = "float64"):
    """``(flop, bytes)`` of one K1/K2 launch over ``lanes`` 4-wave lanes
    (chip_smoke.py:3424-3425): the steps and saves of every lane; inputs
    A0 (8 reals), gamma, alpha, dbeta, outputs P_max (4), A_end (8) and a
    one-byte ok flag."""
    size = 8 if dtype == "float64" else 4
    flop = lanes * (n_steps * RK4_STEP_FLOP[dtype] + (n_steps // save_every) * SAVE_FLOP)
    return flop, lanes * ((3 + 8 + 4 + 8) * size + 1)


def comb_rhs_flop(n: int, L: int) -> int:
    """chip_smoke.py:278-282: one comb RHS, the cubic sum as two radix-2
    FFTs of 5 L log2(L) flop, 5 per bin for F|F|^2, 7 per component for the
    linear terms and the sum."""
    return 10 * L * (L.bit_length() - 1) + 5 * L + 14 * n


def comb_step_flop(n: int, L: int, method: str = "rk4", dtype: str = "float64") -> int:
    """chip_smoke.py:285-291: one fixed step, its RHS evaluations, the stage
    sums and the update (compensated in float32) per component of the
    2N-value state."""
    update = 4 if dtype == "float32" else 1
    per_component = {"rk4": 12, "ab4": 7, "abm4": 16}[method] + update
    n_rhs = {"rk4": 4, "ab4": 1, "abm4": 2}[method]
    return n_rhs * comb_rhs_flop(n, L) + 2 * n * per_component


def comb_fft_len(n: int) -> int:
    """The transform length the comb kernels' count uses: the smallest
    power of two of at least 2N - 1, and at least 128 (a 64-line comb is
    one warp whose first and last passes hold its own lines)."""
    need = max(2 * n - 1, 1)
    return max(128, 1 << (need - 1).bit_length())


def comb_rk_work(combs: int, n: int, n_steps: int, save_every: int,
                 dtype: str = "float64"):
    """``(flop, bytes)`` of one K4 launch over ``combs`` combs of ``n``
    lines (chip_smoke.py:3565-3568): the steps and the saves (3 flop a line);
    inputs A0 (2N), gamma, alpha, beta (N), outputs P_max (N), A_end (2N),
    a one-byte ok flag, and the float64 twiddles once."""
    size = 8 if dtype == "float64" else 4
    L = comb_fft_len(n)
    flop = combs * (n_steps * comb_step_flop(n, L, "rk4", dtype) + (n_steps // save_every) * 3 * n)
    return flop, combs * ((6 * n + 2) * size + 1) + 2 * L * 8


def least_seconds(flop: float, nbytes: float, dtype: str = "float64") -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate of ``dtype`` and the bytes at the memory rate."""
    return max(flop / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
