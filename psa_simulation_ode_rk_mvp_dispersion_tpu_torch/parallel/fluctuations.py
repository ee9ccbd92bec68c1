"""Longitudinal-fluctuation Monte Carlo: gain statistics of real fibers.

Real HNLF has a zero-dispersion wavelength that wanders along the spool, so
the phase mismatch seen by a parametric amplifier is not one number but a
stochastic process delta_beta(z); the resulting gain ripple / yield spread
is a primary production concern.  The reference's deterministic
single-delta-beta solver cannot address it; here an ensemble of B fibers,
each a piecewise-constant delta_beta realization with S segments
(correlation length = segment length), is propagated by composing S batched
solves -- every segment is one batched solve over all realizations (one
``csrc/fwm4_rk.cu`` launch on the card; ``fwm4_rk45.cu`` for rk45).

Exact segment composition: the lab-frame mixing term carries the ACCUMULATED
mismatch phase Phi_s = sum_{j<s} delta_beta_j * L_seg.  Restarting each
segment at z'=0 with its own delta_beta_s is exact if the sidebands are
rotated into the running frame first,

    A3, A4 *= exp(+i dPhi / 2),   dPhi = delta_beta_{s-1} * L_seg,

(substituting A_{3,4} -> A_{3,4} e^{i Phi_s/2} removes the constant phase
from BOTH the pump and sideband mixing terms; Kerr/loss are phase
invariant).  Oracle: with zero fluctuation the composed solve equals the
single continuous solve to integration roundoff (tests/test_fluctuations.py).

Counterpart of the JAX package's ``parallel/fluctuations.py``, plus
``device`` (``None``: the CUDA card).  The JAX package also has a fused
path (``_ripple_solver``: the S segments under one ``lax.scan`` so that XLA
launches once, taken by its ``engine='auto'``); the port takes the
host-composed path everywhere, one ``solve_batch`` a segment with the
sidebands rotated on the host between segments.  ``engine`` maps as
:func:`~.sweep.solve_batch` maps it (the JAX 'scan' is 'torch' here).
The realizations are drawn by ``np.random.default_rng(seed)`` as in the
JAX package, so the ensembles are its own, draw for draw.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..config import SimulationConfig
from ..models.fwm4 import make_initial_amplitudes
from ..ops.rhs import RHSCoeffs
from .sweep import solve_batch


@dataclasses.dataclass(frozen=True)
class GainRippleResult:
    """Ensemble gain statistics under delta_beta(z) fluctuations."""

    gain_db: np.ndarray        # (B,) per-realization signal gain [dB]
    gain_mean_db: float
    gain_mean_se_db: float     # standard error of the mean (std / sqrt(B))
    gain_std_db: float
    gain_p5_db: float          # 5th / 95th percentiles (yield band)
    gain_p95_db: float
    gain_p5_ci_db: tuple       # 95% CI of the 5th percentile (order stats)
    gain_p95_ci_db: tuple      # 95% CI of the 95th percentile
    gain_nominal_db: float     # fluctuation-free realization (lane 0)
    ok: np.ndarray             # (B,) bool
    n_segments: int
    sigma_dbeta_1_m: float
    elapsed_s: float


def _percentile_ci(x: np.ndarray, q: float, conf: float = 0.95):
    """Distribution-free CI of the q-th percentile from order statistics.

    The number of samples below the true percentile is Binomial(n, q/100);
    the normal approximation picks the order-statistic indices
    n q +- z sqrt(n q (1-q)).  Standard nonparametric quantile interval --
    no resampling, deterministic."""
    from statistics import NormalDist

    x = np.sort(np.asarray(x, dtype=np.float64))
    n = x.size
    frac = q / 100.0
    z = NormalDist().inv_cdf(0.5 + conf / 2.0)
    half = z * np.sqrt(n * frac * (1.0 - frac))
    lo = int(np.clip(np.floor(n * frac - half), 0, n - 1))
    hi = int(np.clip(np.ceil(n * frac + half), 0, n - 1))
    return (float(x[lo]), float(x[hi]))


def gain_ripple_monte_carlo(
    cfg: SimulationConfig,
    *,
    gamma: float,
    alpha: float,
    p_in: np.ndarray,
    phase_in: Optional[np.ndarray] = None,
    delta_beta_mean: float,
    sigma_dbeta: float,
    n_segments: int,
    n_realizations: int = 1024,
    seed: int = 0,
    mesh=None,
    engine: str = "auto",
    device=None,
) -> GainRippleResult:
    """Monte-Carlo gain statistics of a dual-pump amplifier whose phase
    mismatch fluctuates along the fiber.

    Each realization draws S = ``n_segments`` independent Gaussian values
    ``delta_beta ~ N(delta_beta_mean, sigma_dbeta^2)`` (internal per-meter
    units, like :func:`~.sweep.solve_batch`); segment length is
    ``cfg.z_max / n_segments`` and must hold a whole number of ``cfg.dz``
    steps.  Lane 0 is the fluctuation-free fiber.  Returns per-realization
    signal gains (end-of-fiber convention) and their ensemble statistics.
    ``device=None`` means the CUDA card; ``mesh`` splits each segment's
    solve over its slots (``parallel/mesh.Mesh``).
    """
    p_in = np.asarray(p_in, dtype=np.float64).reshape(4)
    if phase_in is None:
        phase_in = np.zeros(4)
    if p_in[2] <= 0.0:
        raise ValueError("signal needs nonzero input power to define gain")
    S = int(n_segments)
    if S < 1:
        raise ValueError("n_segments must be >= 1")
    if int(n_realizations) < 2:
        raise ValueError(
            "n_realizations must be >= 2 (the spread statistics need at "
            "least two fluctuating fibers)"
        )
    B = int(n_realizations) + 1
    steps_total = int(round(float(cfg.z_max) / float(cfg.dz)))
    if steps_total % S != 0:
        raise ValueError(
            f"z_max/dz = {steps_total} steps must divide into n_segments={S} "
            "whole segments"
        )
    steps_seg = steps_total // S
    if steps_seg % int(cfg.save_every) != 0:
        raise ValueError(
            "each segment must hold a whole number of save_every blocks "
            "(A_end sits on the saved grid)"
        )
    L_seg = float(cfg.dz) * steps_seg
    cfg_seg = dataclasses.replace(cfg, z_max=L_seg)

    rng = np.random.default_rng(seed)
    dbeta = rng.normal(float(delta_beta_mean), float(sigma_dbeta), (B, S))
    dbeta[0, :] = float(delta_beta_mean)        # nominal lane

    A = np.broadcast_to(
        np.asarray(make_initial_amplitudes(p_in, phase_in),
                   dtype=np.complex128),
        (B, 4),
    ).copy()
    gamma_b = np.full(B, float(gamma))
    alpha_b = np.full(B, float(alpha))

    t0 = time.perf_counter()
    # one batched solve per segment, sidebands rotated between segments by
    # the mismatch phase the previous segment accumulated (the product of
    # the incremental rotations is the total e^{i Phi_s/2} of the
    # derivation above; powers, hence gains, are unaffected)
    ok = np.ones(B, dtype=bool)
    for s in range(S):
        if s > 0:
            rot = np.exp(0.5j * dbeta[:, s - 1] * L_seg)
            A[:, 2] *= rot
            A[:, 3] *= rot
        res = solve_batch(
            cfg_seg,
            RHSCoeffs(gamma=gamma_b, alpha=alpha_b, delta_beta=dbeta[:, s]),
            A, mesh=mesh, engine=engine, device=device,
        )
        ok &= np.asarray(res.ok, dtype=bool)
        A = np.asarray(res.A_end).copy()  # rotated in place next iter
    # res.P_end is the overflow-guarded power solve_batch computed
    P_sig = np.asarray(res.P_end)[:, 2]
    elapsed = time.perf_counter() - t0
    with np.errstate(divide="ignore", invalid="ignore"):
        gain = np.where(ok, 10.0 * np.log10(P_sig / p_in[2]), np.nan)
    good = gain[1:][np.isfinite(gain[1:])]
    if good.size == 0:
        raise FloatingPointError("no realizations survived")
    std = float(good.std(ddof=1) if good.size > 1 else 0.0)
    return GainRippleResult(
        gain_db=gain[1:],
        gain_mean_db=float(good.mean()),
        gain_mean_se_db=std / float(np.sqrt(good.size)),
        gain_std_db=std,
        gain_p5_db=float(np.percentile(good, 5)),
        gain_p95_db=float(np.percentile(good, 95)),
        gain_p5_ci_db=_percentile_ci(good, 5),
        gain_p95_ci_db=_percentile_ci(good, 95),
        gain_nominal_db=float(gain[0]),
        ok=ok[1:],
        n_segments=S,
        sigma_dbeta_1_m=float(sigma_dbeta),
        elapsed_s=elapsed,
    )
