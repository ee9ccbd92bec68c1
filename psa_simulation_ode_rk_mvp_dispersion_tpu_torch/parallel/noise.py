"""Semiclassical (truncated-Wigner) quantum-noise Monte Carlo for every
model family: the measurement layer a deterministic solver cannot express,
riding the batched solvers (10^4-10^6 independent nonlinear solves in one
batched call, on the CUDA card through the port's kernels).

Counterpart of the JAX package's ``parallel/noise.py``, with the same
functions, arguments, defaults and result types, plus ``device`` (``None``:
the CUDA card; ``'cpu'`` for the CPU).  Where each ensemble runs:

- the 4-wave family (``noise_figure_monte_carlo``, ``noise_figure_spectrum``,
  ``psa_squeezing_monte_carlo``, ``epr_inseparability_monte_carlo``,
  ``pump_rin_transfer_monte_carlo``) through :func:`~.sweep.solve_batch`:
  ``csrc/fwm4_rk.cu`` (rk4/ab4/abm4, fp64 for ``x64``/``df32``, fp32 for
  ``x32``) or ``csrc/fwm4_rk45.cu`` (rk45);
- the pulse family through ``models.gnlse.solve_gnlse_batch``
  (``csrc/gnlse_ssfm.cu``, Kerr or ``nl``; ``csrc/ssfm_rk45.cu`` for rk45
  Kerr), the ``_evolution`` and moment measurements through the trajectory
  solve (plain torch: neither package has a kernel for it);
- the vector family through ``models.vgnlse.solve_vgnlse_batch``
  (``csrc/vgnlse_ssfm.cu``);
- the comb family through ``models.nwave.solve_comb_batch``
  (``csrc/comb_rk.cu``, ``csrc/comb_rk45.cu``).

Every random draw is made on the host by ``np.random.default_rng(seed)``,
in the JAX package's order and shapes, and each batch moves to the device
once: the ensembles are the JAX package's, draw for draw, and the port is
held to it at the solvers' own tolerance.  (A ``torch.Generator`` would
give another stream; the JAX package draws with no other.)  The Langevin
loss loops and the link's amplifiers keep the JAX semantics: solve, fetch,
draw on the host, solve again, once a segment.

Sections (in file order):

1. 4-wave amplifier noise: ``noise_figure_monte_carlo`` (PIA/PSA NF with
   jackknife SE), ``noise_figure_spectrum`` (NF(lambda), one batched
   solve), ``psa_squeezing_monte_carlo`` + ``quadrature_stats`` (noise
   ellipses);
2. distributed-loss (Langevin) machinery shared by all families:
   beamsplitter vacuum injection per segment, flat or spectral alpha;
3. pulse family (GNLSE): ``pulse_squeezing_monte_carlo`` / ``_evolution``
   (homodyne ellipses), ``pulse_photon_statistics`` (direct detection,
   spectral filters, out-of-sample optimal filter),
   ``pulse_squeezing_spectrum`` (sideband two-mode ellipses),
   ``pulse_coherence_monte_carlo`` (Dudley-Coen |g12|);
4. vector family: ``vector_pulse_squeezing_monte_carlo`` (Jones-mode LO)
   and ``vector_pulse_photon_statistics``;
5. comb family: ``comb_photon_statistics`` (per-line Fano + NF).

Method (truncated-Wigner / semiclassical): each selected wave's input
amplitude receives an independent complex Gaussian perturbation with the
symmetric-ordering vacuum variance of HALF A PHOTON per mode,

    <|dA|^2> = (1/2) hbar omega / T_mode   [W],

where ``t_mode_s`` is the measurement mode duration (n = P T_mode / hbar
omega photons).  The ensemble is propagated through the full nonlinear
solve and photon-number statistics of the measured wave(s) give

    NF = SNR_in / SNR_out,   SNR = <n>^2 / Var(n).

For mean photon numbers >> 1 the Wigner symmetric-ordering corrections
(half-photon offsets) are negligible and this reproduces the standard
quantum limits:

- ideal phase-insensitive amplification (signal in, idler vacuum):
  NF -> 2 - 1/G  (3 dB at high gain);
- ideal phase-sensitive amplification (signal + idler seeded at the
  max-gain phase, joint measurement): NF -> 1  (0 dB) -- the noiseless
  amplifier quantum mechanics allows.

Lane 0 of the batch is kept noise-free, giving the exact mean-field gain
alongside the ensemble.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SimulationConfig
from ..constants import hbar
from ..models.fwm4 import WAVE_ORDER, make_initial_amplitudes
from ..ops.rhs import RHSCoeffs
from ..utils.checks import as_f64
from .sweep import solve_batch

_WAVE_INDEX = {name: i for i, name in enumerate(WAVE_ORDER)}


@dataclasses.dataclass(frozen=True)
class NoiseFigureResult:
    """Monte-Carlo noise-figure estimate (all host scalars/arrays)."""

    nf_db: float             # SNR_in / SNR_out in dB for the measured wave(s)
    nf_se_db: float          # delete-block jackknife standard error of nf_db
    gain_db: float           # mean-field photon-number gain of the measurement
    snr_in_db: float
    snr_out_db: float
    n_in_photons: float      # mean-field input photon number (measured waves)
    n_out_photons: float
    n_samples: int           # noisy ensemble size (lane 0 excluded)
    ok_fraction: float
    t_mode_s: float
    measure: Tuple[str, ...]
    elapsed_s: float

    def __repr__(self) -> str:  # compact, the common interactive need
        return (
            f"NoiseFigureResult(nf={self.nf_db:.3f}+-{self.nf_se_db:.3f} dB, "
            f"gain={self.gain_db:.2f} dB, n_samples={self.n_samples}, "
            f"measure={'+'.join(self.measure)})"
        )


def _photon_stats(A: np.ndarray, omega: np.ndarray, idx: Sequence[int],
                  t_mode_s: float) -> Tuple[np.ndarray, float, float]:
    """Ensemble (mean, variance) of the summed photon number over ``idx``."""
    n = np.zeros(A.shape[0], dtype=np.float64)
    for j in idx:
        n = n + (np.abs(A[:, j]) ** 2) * t_mode_s / (hbar * float(omega[j]))
    return n, float(n.mean()), float(n.var(ddof=1) if n.size > 1 else 0.0)


def _nf_jackknife_se_db(n_in: np.ndarray, n_out: np.ndarray,
                        n_blocks: int = 32) -> float:
    """Delete-block jackknife standard error of the NF estimator [dB].

    The NF is a smooth function of four sample moments (means and variances
    of the in/out photon numbers), so the block jackknife is consistent:
    split the B noisy lanes into k blocks, recompute NF with each block
    deleted, SE^2 = (k-1)/k * sum (theta_i - theta_bar)^2.  A point estimate
    quoted without this is uninterpretable; the quantum-limit tests assert
    within a few SE instead of fixed tolerances.
    """
    B = int(n_in.shape[0])
    k = int(min(n_blocks, B // 2))
    if k < 2:
        return float("nan")
    m = (B // k) * k
    ni = np.asarray(n_in[:m], dtype=np.float64).reshape(k, -1)
    no = np.asarray(n_out[:m], dtype=np.float64).reshape(k, -1)
    c = ni.shape[1]

    def loo_moments(x):
        s1 = x.sum(axis=1)
        s2 = (x * x).sum(axis=1)
        S1, S2 = s1.sum(), s2.sum()
        n_loo = m - c
        mean = (S1 - s1) / n_loo
        var = ((S2 - s2) - n_loo * mean**2) / (n_loo - 1)
        return mean, var

    mi, vi = loo_moments(ni)
    mo, vo = loo_moments(no)
    with np.errstate(divide="ignore", invalid="ignore"):
        theta = 10.0 * np.log10((mi**2 / vi) / (mo**2 / vo))
    if not np.all(np.isfinite(theta)):
        return float("nan")
    tbar = theta.mean()
    return float(np.sqrt((k - 1) / k * ((theta - tbar) ** 2).sum()))


@dataclasses.dataclass(frozen=True)
class QuadratureStats:
    """Ensemble quadrature statistics of one measured mode combination, in
    PHOTON-NUMBER units (vacuum variance = 1/4 per quadrature).

    ``theta_min`` is the squeezing angle; ``v_min``/``v_max`` the variances
    of the minor/major quadratures of the noise ellipse; ``squeezing_db`` =
    10 log10(v_min / 0.25) is negative when the state is squeezed below
    vacuum; ``uncertainty_product`` = v_min * v_max (1/16 at minimum
    uncertainty -- preserved by ideal lossless PSA)."""

    v_min: float
    v_max: float
    theta_min: float
    squeezing_db: float
    antisqueezing_db: float
    uncertainty_product: float
    mean_re: float
    mean_im: float


def quadrature_stats(A: np.ndarray, omega_rad_s: float,
                     t_mode_s: float) -> QuadratureStats:
    """Noise-ellipse analysis of an ensemble of complex amplitudes (B,)
    for a single mode: convert to photon-number amplitude units, remove the
    mean, and diagonalize the 2x2 quadrature covariance.

    The Wigner samples give symmetric-ordering variances, directly
    comparable to the vacuum 1/4."""
    u = np.asarray(A, dtype=np.complex128) * np.sqrt(
        float(t_mode_s) / (hbar * float(omega_rad_s))
    )
    return quadrature_stats_u(u)


def quadrature_stats_u(u: np.ndarray) -> QuadratureStats:
    """Noise-ellipse analysis of an ensemble (B,) ALREADY in photon-number
    amplitude units (vacuum variance 1/2 per mode, 1/4 per quadrature)."""
    u = np.asarray(u, dtype=np.complex128)
    if u.ndim != 1 or u.size < 2:
        raise ValueError("need a 1-D ensemble of >= 2 samples")
    du = u - u.mean()
    x, y = du.real, du.imag
    cxx = float((x * x).mean())
    cyy = float((y * y).mean())
    cxy = float((x * y).mean())
    tr = cxx + cyy
    disc = np.sqrt(max((cxx - cyy) ** 2 / 4.0 + cxy * cxy, 0.0))
    v_max = tr / 2.0 + disc
    v_min = max(tr / 2.0 - disc, 0.0)
    theta = 0.5 * np.arctan2(2.0 * cxy, cxx - cyy)  # major axis angle
    return QuadratureStats(
        v_min=v_min, v_max=v_max,
        theta_min=float(theta + np.pi / 2.0),       # minor = major + 90 deg
        squeezing_db=10.0 * np.log10(max(v_min, 1e-300) / 0.25),
        antisqueezing_db=10.0 * np.log10(max(v_max, 1e-300) / 0.25),
        uncertainty_product=float(v_min * v_max),
        mean_re=float(u.real.mean()), mean_im=float(u.imag.mean()),
    )


def _fwm4_vacuum_ensemble(cfg, *, gamma, alpha, omega, p_pump_W, delta_beta,
                          t_mode_s, n_samples, seed, mesh, device, engine,
                          loss_model, n_loss_segments):
    """Shared vacuum-seeded 4-wave ensemble of the squeezing/EPR
    measurements: noiseless pumps, Wigner vacuum on signal+idler, every
    lane statistical (no mean-field lane).  Returns the surviving
    ``(A_end (B_ok, 4), omega)``."""
    if loss_model not in _LOSS_MODELS:
        raise ValueError(f"loss_model must be one of {_LOSS_MODELS}")
    omega = np.asarray(omega, dtype=np.float64).reshape(4)
    B = int(n_samples)
    if B < 16:
        raise ValueError("n_samples must be >= 16")
    noisy = (False, False, True, True)
    rng = np.random.default_rng(seed)
    xi = _vacuum_draws(rng, (B, 4), omega, t_mode_s, noisy)
    A_mean = np.asarray(
        make_initial_amplitudes([p_pump_W, p_pump_W, 0.0, 0.0], np.zeros(4)),
        dtype=np.complex128,
    )
    A0 = A_mean[None, :] + xi
    coeffs = RHSCoeffs(
        gamma=np.full(B, float(gamma)),
        alpha=np.full(B, float(alpha)),
        delta_beta=np.full(B, float(delta_beta)),
    )
    if loss_model == "langevin" and float(alpha) != 0.0:
        A_end, ok = _propagate_langevin_fwm4(
            cfg, coeffs, A0, omega=omega, t_mode_s=t_mode_s, noisy=noisy,
            n_segments=n_loss_segments, rng=rng, mesh=mesh, device=device, engine=engine,
            skip_lane0=False,
        )
    else:
        res = solve_batch(cfg, coeffs, A0, mesh=mesh, device=device, engine=engine)
        ok = np.asarray(res.ok, dtype=bool)
        A_end = np.asarray(res.A_end, dtype=np.complex128)
    if ok.sum() < 16:
        raise FloatingPointError("too few lanes survived for statistics")
    return A_end[ok], omega


def psa_squeezing_monte_carlo(
    cfg: SimulationConfig,
    *,
    gamma: float,
    alpha: float,
    omega: np.ndarray,
    p_pump_W: float,
    delta_beta: float = 0.0,
    t_mode_s: float = 1e-9,
    n_samples: int = 8192,
    seed: int = 0,
    mesh=None,
    device=None,
    engine: str = "auto",
    loss_model: str = "deterministic",
    n_loss_segments: int = 16,
) -> Tuple[QuadratureStats, QuadratureStats]:
    """Vacuum squeezing of a dual-pump PSA: propagate a VACUUM signal/idler
    (zero mean field, half-photon Wigner noise, pumps noiseless) and return
    the noise-ellipse statistics of the signal mode and of the +45-degree
    signal/idler superposition mode (a_+ = (a_s + a_i)/sqrt(2) -- the
    two-mode-squeezed quadrature that drops below vacuum).

    Oracle (tests/test_noise.py): the superposition mode squeezes below the
    vacuum by the parametric gain while v_min * v_max stays at the minimum
    uncertainty 1/16 (lossless PSA is a pure squeezer); the single signal
    mode alone shows a thermal (unsqueezed) ellipse.

    ``loss_model='langevin'`` injects distributed-loss vacuum per segment:
    a lossy VACUUM channel (gamma = 0) then stays the exact vacuum circle,
    whereas the deterministic default decays to eta/4 -- fake squeezing.
    """
    A_end, omega = _fwm4_vacuum_ensemble(
        cfg, gamma=gamma, alpha=alpha, omega=omega, p_pump_W=p_pump_W,
        delta_beta=delta_beta, t_mode_s=t_mode_s, n_samples=n_samples,
        seed=seed, mesh=mesh, device=device, engine=engine, loss_model=loss_model,
        n_loss_segments=n_loss_segments,
    )
    sig = quadrature_stats(A_end[:, 2], float(omega[2]), t_mode_s)
    # +45-deg superposition: photon-unit amplitudes combined, converted back
    # to a common-frequency W^1/2 scale for quadrature_stats
    om_c = 0.5 * (float(omega[2]) + float(omega[3]))
    us = A_end[:, 2] * np.sqrt(t_mode_s / (hbar * float(omega[2])))
    ui = A_end[:, 3] * np.sqrt(t_mode_s / (hbar * float(omega[3])))
    u_plus = (us + ui) / np.sqrt(2.0)
    A_plus = u_plus * np.sqrt(hbar * om_c / t_mode_s)
    joint = quadrature_stats(A_plus, om_c, t_mode_s)
    return sig, joint


@dataclasses.dataclass(frozen=True)
class NoiseFigureSpectrumResult:
    """NF(lambda) across the gain band (host numpy arrays, one row per
    signal wavelength; NaN rows where the frequency plan is invalid or the
    mean-field lane diverged)."""

    wavelength: np.ndarray     # (n,) x axis [return_wavelength_unit]
    nf_db: np.ndarray          # (n,)
    nf_se_db: np.ndarray       # (n,) jackknife standard error of nf_db
    gain_db: np.ndarray        # (n,) mean-field gain of the measured wave(s)
    dbeta_1_m: np.ndarray      # (n,) phase mismatch used per point
    ok: np.ndarray             # (n,) bool
    n_samples: int
    measure: Tuple[str, ...]
    elapsed_s: float
    points_per_s: float


def noise_figure_spectrum(
    cfg: SimulationConfig,
    *,
    lambda_p1_m: float,
    lambda_p2_m: float,
    lambda_signal_m,
    gamma: float,
    alpha: float,
    p_in: np.ndarray,
    phase_in: Optional[np.ndarray] = None,
    dispersion=None,
    phase_matching_cfg=None,
    length_unit: str = "m",
    t_mode_s: float = 1e-9,
    n_samples: int = 1024,
    noisy_waves: Sequence[bool] = (False, False, True, True),
    measure: str = "signal",
    seed: int = 0,
    mesh=None,
    device=None,
    engine: str = "auto",
    return_wavelength_unit: str = "nm",
) -> NoiseFigureSpectrumResult:
    """Noise figure vs signal wavelength across the FWM gain band.

    Every wavelength gets its own vacuum-seeded Monte-Carlo ensemble
    (``n_samples`` noisy lanes + one noise-free mean-field lane), its own
    dispersion-aware ``delta_beta`` (same plan/phase-matching machinery as
    the gain sweeps), and all ``n_lambda * (n_samples + 1)`` nonlinear
    solves run as ONE batched solve (one kernel launch on the card) -- an
    NF spectrum at 10^5+ total solves is a single call.  Physics units
    follow the sweep APIs (``length_unit`` boundary); defaults keep the
    pumps noiseless.  The plan and the mismatch are computed on the host
    in float64 (they set the vacuum draws' scales, drawn there).
    """
    from ..ops.phase_matching import (
        PhaseMatchingConfig,
        PhaseMatchingMethod,
    )
    from ..utils.units import length_scale_to_m, wavelength_scale
    from .sweep import _batched_delta_beta, _batched_plan_from_wavelengths

    lam3 = np.asarray(list(lambda_signal_m), dtype=float)
    n_l = lam3.shape[0]
    scale_to_m = length_scale_to_m(length_unit)
    gamma_m = float(gamma) / scale_to_m
    alpha_m = float(alpha) / scale_to_m
    cfg_m = dataclasses.replace(cfg, z_max=float(cfg.z_max) * scale_to_m,
                                dz=float(cfg.dz) * scale_to_m)

    p_in = np.asarray(p_in, dtype=np.float64).reshape(4)
    if phase_in is None:
        phase_in = np.zeros(4)
    noisy = np.asarray(noisy_waves, dtype=bool).reshape(4)
    names, idx = _parse_measure(measure, noisy)
    if not all(p_in[j] > 0.0 for j in idx):
        raise ValueError("every measured wave needs nonzero input power")
    if int(n_samples) < 2:
        raise ValueError("n_samples must be >= 2")
    if not float(t_mode_s) > 0.0:
        raise ValueError("t_mode_s must be positive")

    # per-wavelength plan + phase mismatch (internal meters)
    omegas_t, valid_t = _batched_plan_from_wavelengths(
        float(lambda_p1_m), float(lambda_p2_m), as_f64(lam3)
    )
    omegas = omegas_t.numpy()
    valid = valid_t.numpy()
    if dispersion is not None:
        disp_m = dispersion.scaled(scale_to_m).to("cpu")
        pm_cfg = (phase_matching_cfg or PhaseMatchingConfig(
            method=PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4),
            max_order=4,
        )).scaled(scale_to_m)
        dbeta_m = np.where(
            valid, _batched_delta_beta(omegas_t, disp_m, pm_cfg).numpy(), 0.0
        )
    else:
        dbeta_m = np.zeros(n_l)

    A_mean = np.asarray(make_initial_amplitudes(p_in, phase_in),
                        dtype=np.complex128)
    S1 = int(n_samples) + 1                       # lane 0 per block: no noise
    # per-wavelength omega quartets -> per-block vacuum scales
    xi = _vacuum_draws(np.random.default_rng(seed), (n_l, S1, 4),
                       np.asarray(omegas)[:, None, :], t_mode_s, noisy)
    xi[:, 0, :] = 0.0
    A0 = (A_mean[None, None, :] + xi).reshape(n_l * S1, 4)

    coeffs = RHSCoeffs(
        gamma=np.full(n_l * S1, gamma_m),
        alpha=np.full(n_l * S1, alpha_m),
        delta_beta=np.repeat(dbeta_m, S1),
    )
    t0 = time.perf_counter()
    res = solve_batch(cfg_m, coeffs, A0, mesh=mesh, device=device, engine=engine)
    elapsed = time.perf_counter() - t0

    A_in = A0.reshape(n_l, S1, 4)
    A_out = np.asarray(res.A_end).reshape(n_l, S1, 4)
    ok_l = np.asarray(res.ok, dtype=bool).reshape(n_l, S1)

    nf = np.full(n_l, np.nan)
    nf_se = np.full(n_l, np.nan)
    gdb = np.full(n_l, np.nan)
    point_ok = np.zeros(n_l, dtype=bool)
    for k in range(n_l):
        if not (valid[k] and ok_l[k, 0]):
            continue
        keep = ok_l[k].copy()
        keep[0] = False
        if keep.sum() < 2:
            continue
        om_k = np.asarray(omegas[k], dtype=np.float64)
        ni_all, ni_m, ni_v = _photon_stats(A_in[k][keep], om_k, idx, t_mode_s)
        no_all, no_m, no_v = _photon_stats(A_out[k][keep], om_k, idx,
                                           t_mode_s)
        _, ni_mf, _ = _photon_stats(A_in[k][:1], om_k, idx, t_mode_s)
        _, no_mf, _ = _photon_stats(A_out[k][:1], om_k, idx, t_mode_s)
        if ni_v <= 0.0 or no_v <= 0.0 or ni_mf <= 0.0:
            continue
        nf[k] = 10.0 * np.log10((ni_m**2 / ni_v) / (no_m**2 / no_v))
        nf_se[k] = _nf_jackknife_se_db(ni_all, no_all)
        gdb[k] = 10.0 * np.log10(no_mf / ni_mf)
        point_ok[k] = True

    return NoiseFigureSpectrumResult(
        wavelength=lam3 * wavelength_scale(return_wavelength_unit),
        nf_db=nf,
        nf_se_db=nf_se,
        gain_db=gdb,
        dbeta_1_m=np.where(valid, dbeta_m, np.nan),
        ok=point_ok,
        n_samples=int(n_samples),
        measure=names,
        elapsed_s=elapsed,
        points_per_s=n_l / elapsed if elapsed > 0 else float("inf"),
    )


def _parse_measure(measure, noisy):
    """Validate a '+'-joined measure spec against WAVE_ORDER and the
    noisy-wave mask; returns (names tuple, index list)."""
    names = tuple(str(measure).split("+"))
    bad = [m for m in names if m not in _WAVE_INDEX]
    if bad:
        raise ValueError(
            f"measure must combine {WAVE_ORDER} with '+', got {bad}"
        )
    quiet = [m for m in names if not noisy[_WAVE_INDEX[m]]]
    if quiet:
        raise ValueError(
            f"measured wave(s) {quiet} receive no vacuum noise "
            "(noisy_waves masks them out), so the input ensemble variance "
            "is zero and SNR_in is undefined"
        )
    return names, [_WAVE_INDEX[m] for m in names]


def _vacuum_draws(rng, shape, omega, t_mode_s, noisy):
    """Wigner vacuum draws for a (..., 4) block: complex Gaussian with
    <|dA|^2> = (1/2) hbar omega / T_mode per wave; masked waves get 0."""
    sigma2 = 0.5 * hbar * np.asarray(omega) / float(t_mode_s)
    xi = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    xi *= np.sqrt(sigma2 / 2.0)
    xi[..., ~np.asarray(noisy, dtype=bool)] = 0.0
    return xi


def noise_figure_monte_carlo(
    cfg: SimulationConfig,
    *,
    gamma: float,
    alpha: float,
    omega: np.ndarray,
    p_in: np.ndarray,
    phase_in: Optional[np.ndarray] = None,
    delta_beta: float = 0.0,
    t_mode_s: float = 1e-9,
    n_samples: int = 8192,
    noisy_waves: Sequence[bool] = (True, True, True, True),
    measure: str = "signal",
    seed: int = 0,
    mesh=None,
    device=None,
    engine: str = "auto",
    loss_model: str = "deterministic",
    n_loss_segments: int = 16,
) -> NoiseFigureResult:
    """Monte-Carlo noise figure of a 4-wave parametric amplifier.

    All quantities in internal per-meter units (``gamma`` [1/(W m)],
    ``alpha`` [1/m], ``delta_beta`` [1/m]; ``cfg.z_max``/``cfg.dz`` in
    meters), matching :func:`~.sweep.solve_batch`'s contract -- compute
    ``delta_beta`` with :func:`psa.compute_phase_mismatch` for
    dispersion-aware runs.

    ``measure`` selects the detected mode(s): one of ``WAVE_ORDER`` or a
    '+'-joined combination (e.g. ``'signal+idler'`` for the joint PSA
    measurement).  ``noisy_waves`` masks which inputs receive vacuum noise
    (pumps can be kept noiseless to isolate the ideal-amplifier limit).
    ``t_mode_s`` sets the photon-number scale n = P T/(hbar omega); results
    are t_mode-independent as long as n >> 1.

    ``loss_model='langevin'`` models the distributed loss ``alpha`` as a
    continuum of beamsplitters: the span is split into ``n_loss_segments``
    and every segment of power transmission ``eta`` injects fresh vacuum of
    variance ``(1 - eta)`` into the ``noisy_waves`` (a pure-loss channel
    then shows the exact NF = 1/eta; the default deterministic loss would
    unphysically report 0 dB).
    """
    omega = np.asarray(omega, dtype=np.float64).reshape(4)
    p_in = np.asarray(p_in, dtype=np.float64).reshape(4)
    if phase_in is None:
        phase_in = np.zeros(4)
    noisy = np.asarray(noisy_waves, dtype=bool).reshape(4)
    names, idx = _parse_measure(measure, noisy)
    if loss_model not in _LOSS_MODELS:
        raise ValueError(f"loss_model must be one of {_LOSS_MODELS}")
    if int(n_samples) < 2:
        raise ValueError("n_samples must be >= 2")
    if not float(t_mode_s) > 0.0:
        raise ValueError("t_mode_s must be positive")

    A_mean = np.asarray(make_initial_amplitudes(p_in, phase_in),
                        dtype=np.complex128)

    # vacuum (Wigner) seeding: half a photon per mode, quarter per quadrature
    B = int(n_samples) + 1                                  # lane 0 noise-free
    rng = np.random.default_rng(seed)
    xi = _vacuum_draws(rng, (B, 4), omega, t_mode_s, noisy)
    xi[0] = 0.0
    A0 = A_mean[None, :] + xi

    coeffs = RHSCoeffs(
        gamma=np.full(B, float(gamma)),
        alpha=np.full(B, float(alpha)),
        delta_beta=np.full(B, float(delta_beta)),
    )
    t0 = time.perf_counter()
    if loss_model == "langevin" and float(alpha) != 0.0:
        A_end, ok = _propagate_langevin_fwm4(
            cfg, coeffs, A0, omega=omega, t_mode_s=t_mode_s, noisy=noisy,
            n_segments=n_loss_segments, rng=rng, mesh=mesh, device=device, engine=engine,
            skip_lane0=True,
        )
    else:
        res = solve_batch(cfg, coeffs, A0, mesh=mesh, device=device, engine=engine)
        ok = np.asarray(res.ok, dtype=bool)
        A_end = np.asarray(res.A_end, dtype=np.complex128)
    elapsed = time.perf_counter() - t0
    if not ok[0]:
        raise FloatingPointError(
            "mean-field (noise-free) lane diverged; noise figure undefined"
        )
    keep = ok.copy()
    keep[0] = False                                         # stats: noisy lanes
    if keep.sum() < 2:
        raise FloatingPointError(
            "fewer than 2 noisy lanes survived; cannot estimate variance"
        )

    n_in_all, n_in_mean, n_in_var = _photon_stats(A0[keep], omega, idx,
                                                  t_mode_s)
    n_out_all, n_out_mean, n_out_var = _photon_stats(
        A_end[keep], omega, idx, t_mode_s
    )
    # mean-field photon numbers from the noise-free lane
    _, n_in_mf, _ = _photon_stats(A0[:1], omega, idx, t_mode_s)
    _, n_out_mf, _ = _photon_stats(A_end[:1], omega, idx, t_mode_s)
    if n_in_mf <= 0.0:
        raise ValueError(
            "measured wave(s) carry no input power; SNR_in undefined "
            "(seed the measured mode or measure a seeded one)"
        )

    snr_in = n_in_mean**2 / n_in_var
    snr_out = n_out_mean**2 / n_out_var
    return NoiseFigureResult(
        nf_db=10.0 * np.log10(snr_in / snr_out),
        nf_se_db=_nf_jackknife_se_db(n_in_all, n_out_all),
        gain_db=10.0 * np.log10(n_out_mf / n_in_mf),
        snr_in_db=10.0 * np.log10(snr_in),
        snr_out_db=10.0 * np.log10(snr_out),
        n_in_photons=n_in_mf,
        n_out_photons=n_out_mf,
        n_samples=int(keep.sum()),
        ok_fraction=float(ok.mean()),
        t_mode_s=float(t_mode_s),
        measure=names,
        elapsed_s=elapsed,
    )


# ---------------------------------------------------------------------------
# Distributed-loss (Langevin) vacuum injection
# ---------------------------------------------------------------------------
#
# A lossy channel is a continuum of beamsplitters: attenuating the field by
# power transmission eta REQUIRES admixing (1 - eta) of fresh vacuum, or the
# ensemble variance decays below the vacuum floor (unphysical).  Discretized
# over K segments the exact beamsplitter recursion v -> eta v + (1-eta)/4
# holds per segment, so a LINEAR lossy channel preserves the vacuum exactly
# for ANY K; K only controls the splitting error against the nonlinearity.

_LOSS_MODELS = ("deterministic", "langevin")


def _propagate_langevin_fwm4(cfg, coeffs, A0, *, omega, t_mode_s, noisy,
                             n_segments, rng, mesh, device, engine,
                             skip_lane0: bool):
    """Segmented 4-wave propagation with per-segment vacuum injection into
    the ``noisy`` waves (the beamsplitter model of the flat loss in
    ``coeffs.alpha``).  ``skip_lane0`` keeps lane 0 noise-free (the
    mean-field lane of the NF measurement); measurements whose every lane
    is statistical (squeezing/EPR on vacuum) inject everywhere.  Returns
    ``(A_end, ok)``; measurement point = last saved grid point."""
    alpha = np.asarray(coeffs.alpha, dtype=np.float64)
    a0 = float(alpha.reshape(-1)[0])
    if alpha.size and not np.all(alpha == a0):
        raise ValueError(
            "loss_model='langevin' needs a uniform alpha across the batch"
        )
    if a0 < 0.0:
        raise ValueError(
            "loss_model='langevin' needs alpha >= 0 (flat gain would "
            "require the amplifier Langevin term, which is not modeled)"
        )
    cfg_seg, z_seg = _loss_segment_cfg(cfg, n_segments)
    eta = float(np.exp(-a0 * z_seg))
    A = np.asarray(A0, dtype=np.complex128).copy()
    ok = np.ones(A.shape[0], dtype=bool)
    for _ in range(int(n_segments)):
        res = solve_batch(cfg_seg, coeffs, A, mesh=mesh, device=device, engine=engine)
        ok &= np.asarray(res.ok, dtype=bool)
        A = np.asarray(res.A_end, dtype=np.complex128).copy()
        dxi = _vacuum_draws(rng, A.shape, omega, t_mode_s, noisy)
        if skip_lane0:
            dxi[0] = 0.0
        A += np.sqrt(1.0 - eta) * dxi
    return A, ok


def _gnlse_vacuum_injection(rng, shape, eta, sigma2: float) -> np.ndarray:
    """Complex Gaussian draws (B, ..., T) with per-time-bin variance
    ``(1 - eta) * sigma2`` -- the vacuum a segment of power transmission
    ``eta`` must inject.  ``eta`` is a scalar (flat loss, time-domain
    injection) or an fft-ordered array matching the trailing axes --
    (T,) scalar-family / (2, T) per-polarization spectral loss; the draw
    is then colored in the frequency domain, where per-bin vacuum
    variance is ``sigma2 * T`` under the unnormalized DFT."""
    eta = np.asarray(eta, dtype=np.float64)
    xi = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    if eta.ndim == 0:
        return xi * np.sqrt(max(1.0 - float(eta), 0.0) * sigma2 / 2.0)
    T = shape[-1]
    var_f = np.maximum(1.0 - eta, 0.0) * sigma2 * T
    return np.fft.ifft(xi * np.sqrt(var_f / 2.0), axis=-1)


def _loss_segment_cfg(cfg, n_segments: int):
    """Segment config for langevin propagation, honoring the framework-wide
    save-decimation contract: the measurement point is the LAST SAVED grid
    point ``floor(n_steps / save_every) * save_every`` (trailing partial
    steps are not propagated -- unlike the deterministic path they carry no
    observable state here, only ok flips, which segmented measurement gives
    up).  Returns ``(cfg_seg, z_seg)``; ``n_segments`` must divide the
    observed step count."""
    K = int(n_segments)
    n_steps = int(round(float(cfg.z_max) / float(cfg.dz)))
    n_obs = (n_steps // int(cfg.save_every)) * int(cfg.save_every)
    if n_obs < 1:
        raise ValueError(
            f"no saved grid points: {n_steps} steps with "
            f"save_every={cfg.save_every}"
        )
    if K < 1 or n_obs % K != 0:
        raise ValueError(
            f"n_loss_segments must divide the {n_obs} observed fixed steps "
            f"(floor({n_steps}/save_every)*save_every), got {K}"
        )
    steps_seg = n_obs // K
    z_seg = steps_seg * float(cfg.dz)
    return dataclasses.replace(cfg, z_max=z_seg, save_every=steps_seg), z_seg


def _propagate_langevin_gnlse(cfg, coeffs, A_batch, *, sigma2: float,
                              n_segments: int, rng, nl, mesh, device,
                              boundaries: bool = False, solve_fn=None):
    """Segmented GNLSE-family propagation with vacuum injection into lanes
    1: after every segment (lane 0 stays the noise-free mean field -- the
    injection has zero mean).  ``solve_fn(cfg, coeffs, A, nl=, mesh=)``
    defaults to the scalar ``solve_gnlse_batch``; the state is (B, T)
    scalar or (B, 2, T) vector.  Returns ``(A_end, ok, outs, z_b)`` where
    ``outs`` is the list of post-injection states at the K+1 segment
    boundaries (input first) when ``boundaries`` else None.

    Spectral-alpha GAIN regions (alpha < 0) receive NO injection (the
    ``1 - eta`` clamp): deterministic amplification without amplifier
    noise -- the phase-insensitive-amplifier Langevin term is not modeled.
    """
    if solve_fn is None:
        from ..models.gnlse import solve_gnlse_batch as solve_fn

    K = int(n_segments)
    cfg_seg, z_seg = _loss_segment_cfg(cfg, K)
    alpha = as_f64(coeffs.alpha).cpu().numpy()   # a tensor on any device
    state_shape = A_batch.shape[1:]
    if alpha.ndim != 0 and alpha.shape != state_shape:
        raise ValueError(
            f"langevin loss needs a scalar or {state_shape} spectral alpha "
            f"(got shape {alpha.shape})"
        )
    eta = np.exp(-alpha * z_seg)
    A = np.asarray(A_batch, dtype=np.complex128).copy()
    ok_all = np.ones(A.shape[0], dtype=bool)
    outs = [A.copy()] if boundaries else None
    for _ in range(K):
        _pk, A_end, ok = solve_fn(cfg_seg, coeffs, A, nl=nl, mesh=mesh, device=device)
        ok_all &= np.asarray(ok, dtype=bool)
        A = np.asarray(A_end, dtype=np.complex128).copy()
        A[1:] += _gnlse_vacuum_injection(rng, A[1:].shape, eta, sigma2)
        if boundaries:
            outs.append(A.copy())
    z_b = np.arange(K + 1, dtype=np.float64) * z_seg
    return A, ok_all, outs, z_b


# ---------------------------------------------------------------------------
# Pulse-family (GNLSE) quantum noise: fiber Kerr / soliton squeezing
# ---------------------------------------------------------------------------

def _seed_wigner(A0, grid, *, omega0, n_samples, seed,
                 vector: bool = False):
    """Validate the launch state and build the Wigner ensemble: lane 0
    noise-free, iid half-photon-per-time-bin vacuum on every component.
    Returns ``(A0, A_batch (B+1, ...), scale, sigma2, rng)`` -- the one
    seeding convention shared by every pulse-family measurement."""
    if vector:
        A0 = np.asarray(A0, dtype=np.complex128)
        if A0.ndim != 2 or A0.shape[0] != 2:
            raise ValueError(f"A0 must have shape (2, T), got {A0.shape}")
    else:
        A0 = np.asarray(A0, dtype=np.complex128).reshape(-1)
    B = int(n_samples)
    if B < 16:
        raise ValueError("n_samples must be >= 16")
    dt = float(grid.dt_s)
    scale = np.sqrt(dt / (hbar * float(omega0)))   # W^1/2 -> photon units
    sigma2 = 0.5 * hbar * float(omega0) / dt       # vacuum variance [W]
    rng = np.random.default_rng(seed)
    shape = (B,) + A0.shape
    xi = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    xi *= np.sqrt(sigma2 / 2.0)
    return A0, np.concatenate([A0[None], A0[None] + xi], axis=0), \
        scale, sigma2, rng


def _pulse_wigner_ensemble(cfg, coeffs, A0, grid, *, omega0, n_samples,
                           seed, nl, mesh, device, loss_model, n_loss_segments,
                           vector: bool = False):
    """Seed a (1 + n_samples, ...) Wigner ensemble (lane 0 noise-free),
    add iid half-photon-per-time-bin vacuum to every state component,
    propagate through the batched GNLSE engine -- scalar (B, T) or, with
    ``vector=True``, the vector (B, 2, T) solver -- segmented with
    per-segment vacuum injection under ``loss_model='langevin'``.  Returns
    ``(A0, A_end (B+1, ...), ok, scale, elapsed_s)`` with ``scale`` the
    W^1/2 -> photon-amplitude conversion ``sqrt(dt / hbar omega0)``."""
    if loss_model not in _LOSS_MODELS:
        raise ValueError(f"loss_model must be one of {_LOSS_MODELS}")
    if vector:
        from ..models.vgnlse import solve_vgnlse_batch as solve_fn
    else:
        from ..models.gnlse import solve_gnlse_batch as solve_fn

    A0, A_batch, scale, sigma2, rng = _seed_wigner(
        A0, grid, omega0=omega0, n_samples=n_samples, seed=seed,
        vector=vector)

    t0 = time.perf_counter()
    if loss_model == "langevin":
        A_end, ok, _, _ = _propagate_langevin_gnlse(
            cfg, coeffs, A_batch, sigma2=sigma2,
            n_segments=n_loss_segments, rng=rng, nl=nl, mesh=mesh, device=device,
            solve_fn=solve_fn,
        )
    else:
        _pk, A_end, ok = solve_fn(cfg, coeffs, A_batch, nl=nl, mesh=mesh, device=device)
    elapsed = time.perf_counter() - t0
    ok = np.asarray(ok, dtype=bool)
    if not ok[0]:
        raise FloatingPointError("the noise-free mean-field lane diverged")
    if ok[1:].sum() < 16:
        raise FloatingPointError("too few lanes survived for statistics")
    return A0, np.asarray(A_end, dtype=np.complex128), ok, scale, elapsed


@dataclasses.dataclass(frozen=True)
class PulseSqueezingResult:
    """Truncated-Wigner quadrature statistics of one temporal mode of a
    propagated pulse ensemble.  ``stats`` is the noise ellipse in photon
    units (vacuum = 1/4 per quadrature); ``mean_photons`` the mean-field
    photon number of the measured mode (from the noise-free lane 0)."""

    stats: QuadratureStats
    mean_photons: float
    n_samples: int
    ok_fraction: float
    elapsed_s: float

    def __repr__(self) -> str:
        return (
            f"PulseSqueezingResult(squeezing={self.stats.squeezing_db:.2f} dB,"
            f" antisqueezing={self.stats.antisqueezing_db:.2f} dB, "
            f"n={self.mean_photons:.3g} photons, "
            f"n_samples={self.n_samples})"
        )


def pulse_squeezing_monte_carlo(
    cfg: SimulationConfig,
    coeffs,
    A0: np.ndarray,
    grid,
    *,
    omega0: float,
    n_samples: int = 4096,
    seed: int = 0,
    lo_mode="mean-output",
    nl=None,
    mesh=None,
    device=None,
    loss_model: str = "deterministic",
    n_loss_segments: int = 16,
) -> PulseSqueezingResult:
    """Quadrature squeezing of a propagated pulse (GNLSE family) by
    truncated-Wigner Monte Carlo: every TIME BIN of the input receives an
    independent complex Gaussian with the symmetric-ordering vacuum
    variance of half a photon per mode,

        <|dA|^2> = (1/2) hbar omega_0 / dt   [W],

    the ensemble is propagated through ``models.gnlse.solve_gnlse_batch``
    (one batched solve; lane 0 stays noise-free for the mean field), and the
    fluctuations are projected onto one temporal mode -- the balanced-
    homodyne measurement with local oscillator ``lo_mode``:

    - ``"mean-output"`` (default): the propagated mean field itself (the
      self-adapted LO of fiber-squeezing experiments);
    - ``"mean-input"``: the input pulse shape;
    - an explicit ``(T,)`` complex array (any scale; normalized here).

    Oracles (tests/test_pulse_noise.py): linear propagation (gamma=0, any
    dispersion) preserves the vacuum ellipse exactly; dispersion-free Kerr
    matches the linearized analytic ellipse V_min/max = 1 + 2 mu^2 -+
    2 mu sqrt(1+mu^2) (mu = gamma P z) to MC error; the fundamental
    soliton squeezes below vacuum at minimum-uncertainty-bounded product.

    Loss: ``loss_model='deterministic'`` (default) attenuates without noise
    -- exact for (near-)lossless spans, and the variance decays below the
    vacuum floor on lossy ones.  ``loss_model='langevin'`` splits the span
    into ``n_loss_segments`` and injects fresh vacuum with variance
    ``(1 - eta)`` per segment of power transmission ``eta`` (the
    beamsplitter model of distributed loss; supports flat AND spectral
    alpha) -- a LINEAR lossy channel then preserves the vacuum ellipse
    exactly for any segment count.  Physics: Carter & Drummond, PRL 58,
    1841 (1987) (squeezing of quantum solitons); Agrawal ch. 12 fiber
    squeezing.
    """
    A0, A_end, ok, scale, elapsed = _pulse_wigner_ensemble(
        cfg, coeffs, A0, grid, omega0=omega0, n_samples=n_samples,
        seed=seed, nl=nl, mesh=mesh, device=device, loss_model=loss_model,
        n_loss_segments=n_loss_segments,
    )
    f = _resolve_lo_mode(lo_mode, A_end[0], A0)
    stats, u_mf = _homodyne_stats(A_end[0], A_end[1:][ok[1:]], f, scale)
    return PulseSqueezingResult(
        stats=stats,
        mean_photons=u_mf**2,
        n_samples=int(ok[1:].sum()),
        ok_fraction=float(ok[1:].mean()),
        elapsed_s=elapsed,
    )


def _resolve_lo_mode(lo_mode, A_mean_out: np.ndarray,
                     A0: np.ndarray) -> np.ndarray:
    """Local-oscillator waveform [W^1/2] for ``lo_mode`` (see
    :func:`pulse_squeezing_monte_carlo`)."""
    if isinstance(lo_mode, str):
        if lo_mode == "mean-output":
            return A_mean_out
        if lo_mode == "mean-input":
            return A0
        raise ValueError(
            "lo_mode must be 'mean-output', 'mean-input' or an array of "
            f"the state shape {A0.shape}"
        )
    return np.asarray(lo_mode, dtype=np.complex128).reshape(A0.shape)


def _homodyne_stats(A_mean: np.ndarray, A_lanes: np.ndarray,
                    f: np.ndarray, scale: float):
    """Project the surviving lanes (B_ok, T) / (B_ok, 2, T) [W^1/2] onto
    the normalized LO mode ``f`` (matching trailing shape) and return
    ``(QuadratureStats, |mean-field amplitude|)`` in photon units."""
    u_f = f * scale
    norm = np.sqrt(np.sum(np.abs(u_f) ** 2))
    if norm == 0.0:
        raise ValueError("local-oscillator mode has zero power")
    f_hat = u_f / norm
    a = np.tensordot(A_lanes * scale, np.conj(f_hat), axes=f_hat.ndim)
    u_mf = float(np.abs(np.sum((A_mean * scale) * np.conj(f_hat))))
    return quadrature_stats_u(a), u_mf


@dataclasses.dataclass(frozen=True)
class PulseSqueezingEvolution:
    """Noise-ellipse evolution along the fiber: quadrature statistics of
    one temporal mode at every SAVED propagation distance (vacuum = 1/4
    per quadrature; dB values are relative to vacuum)."""

    z_m: np.ndarray               # (S+1,) saved grid [m]
    squeezing_db: np.ndarray      # (S+1,) 10 log10(4 v_min)
    antisqueezing_db: np.ndarray  # (S+1,) 10 log10(4 v_max)
    v_min: np.ndarray
    v_max: np.ndarray
    theta_min: np.ndarray         # (S+1,) squeezed-quadrature angle [rad]
    uncertainty_product: np.ndarray   # (S+1,) v_min * v_max (>= 1/16)
    mean_photons: np.ndarray      # (S+1,) mean-field photons in the LO mode
    n_samples: int
    ok_fraction: float
    elapsed_s: float

    @property
    def best_index(self) -> int:
        return int(np.argmin(self.squeezing_db))

    def __repr__(self) -> str:
        k = self.best_index
        return (
            f"PulseSqueezingEvolution(best {self.squeezing_db[k]:.2f} dB at "
            f"z={self.z_m[k]:.3g} m, {self.z_m.shape[0]} samples along z, "
            f"n_samples={self.n_samples})"
        )


def pulse_squeezing_evolution(
    cfg: SimulationConfig,
    coeffs,
    A0: np.ndarray,
    grid,
    *,
    omega0: float,
    n_samples: int = 2048,
    seed: int = 0,
    lo_mode="mean-output",
    nl=None,
    mesh=None,
    device=None,
    loss_model: str = "deterministic",
) -> PulseSqueezingEvolution:
    """Squeezing-vs-distance curve from ONE trajectory solve: the same
    truncated-Wigner ensemble as :func:`pulse_squeezing_monte_carlo`, but
    propagated with ``models.gnlse.solve_gnlse_batch_trajectories`` so the
    noise ellipse is measured at every saved z (row 0 = input, vacuum).
    With ``lo_mode='mean-output'`` the local oscillator self-adapts to the
    mean field AT EACH DISTANCE (the Carter-Drummond soliton-squeezing
    measurement); 'mean-input' or an explicit (T,) array keeps it fixed.

    ``loss_model='langevin'`` injects vacuum at EVERY saved interval (the
    segment grid is the save grid, so measurement and injection points
    coincide; requires save_every to divide the step count).  With the
    same seed and ``n_loss_segments`` equal to the number of saved
    intervals, the endpoint matches :func:`pulse_squeezing_monte_carlo`
    bitwise.

    Trajectory mode materializes S+1 copies of the batch state -- size
    n_samples for memory (B * (S+1) * T complex), not for speed.
    """
    from ..models.gnlse import solve_gnlse_batch_trajectories

    if loss_model not in _LOSS_MODELS:
        raise ValueError(f"loss_model must be one of {_LOSS_MODELS}")
    A0, A_batch, scale, sigma2, rng = _seed_wigner(
        A0, grid, omega0=omega0, n_samples=n_samples, seed=seed)

    t0 = time.perf_counter()
    if loss_model == "langevin":
        # injection points = the saved grid (trailing partial steps are
        # unobserved, the framework-wide save-decimation convention)
        n_steps = int(round(float(cfg.z_max) / float(cfg.dz)))
        n_chunks = n_steps // int(cfg.save_every)
        _, ok, outs, z = _propagate_langevin_gnlse(
            cfg, coeffs, A_batch, sigma2=sigma2, n_segments=max(n_chunks, 1),
            rng=rng, nl=nl, mesh=mesh, device=device, boundaries=True,
        )
        A_traj = np.stack(outs, axis=1)            # (B, S+1, T)
    else:
        z, A_traj, ok = solve_gnlse_batch_trajectories(cfg, coeffs, A_batch,
                                                       nl=nl, mesh=mesh, device=device)
    elapsed = time.perf_counter() - t0
    ok = np.asarray(ok, dtype=bool)
    if not ok[0]:
        raise FloatingPointError("the noise-free mean-field lane diverged")
    if ok[1:].sum() < 16:
        raise FloatingPointError("too few lanes survived for statistics")

    return _evolution_from_traj(z, np.asarray(A_traj, dtype=np.complex128),
                                ok, A0, scale, lo_mode, elapsed)


def _evolution_from_traj(z, A_traj, ok, A0, scale, lo_mode,
                         elapsed) -> PulseSqueezingEvolution:
    """Per-saved-z homodyne ellipses from a trajectory ensemble
    ``A_traj (B+1, S+1, ...)`` (lane 0 mean field; scalar or (2, T)
    vector states -- the LO/projection helpers handle both)."""
    lanes = A_traj[1:][ok[1:]]
    S1 = z.shape[0]
    sq = np.empty(S1)
    asq = np.empty(S1)
    vmin = np.empty(S1)
    vmax = np.empty(S1)
    th = np.empty(S1)
    up = np.empty(S1)
    nph = np.empty(S1)
    for s in range(S1):
        f = _resolve_lo_mode(lo_mode, A_traj[0, s], A0)
        stats, u_mf = _homodyne_stats(A_traj[0, s], lanes[:, s], f, scale)
        sq[s] = stats.squeezing_db
        asq[s] = stats.antisqueezing_db
        vmin[s] = stats.v_min
        vmax[s] = stats.v_max
        th[s] = stats.theta_min
        up[s] = stats.uncertainty_product
        nph[s] = u_mf**2
    return PulseSqueezingEvolution(
        z_m=np.asarray(z, dtype=float),
        squeezing_db=sq, antisqueezing_db=asq, v_min=vmin, v_max=vmax,
        theta_min=th, uncertainty_product=up, mean_photons=nph,
        n_samples=int(ok[1:].sum()),
        ok_fraction=float(ok[1:].mean()),
        elapsed_s=elapsed,
    )


def vector_pulse_squeezing_evolution(
    cfg: SimulationConfig,
    coeffs,
    A0: np.ndarray,
    grid,
    *,
    omega0: float,
    n_samples: int = 2048,
    seed: int = 0,
    lo_mode="mean-output",
    nl=None,
    loss_model: str = "deterministic",
    device=None,
) -> PulseSqueezingEvolution:
    """Vector (polarization-resolved) squeezing-vs-distance curve: the
    :func:`vector_pulse_squeezing_monte_carlo` measurement at every saved
    z from ONE trajectory solve
    (``models.vgnlse.solve_vgnlse_batch_trajectories``, plain torch:
    neither package has a kernel for it).  ``lo_mode`` is the
    Jones-resolved LO of the vector MC.  ``loss_model='langevin'`` injects
    on the saved grid; with the same
    seed and matching segment count the endpoint equals the single-shot
    vector MC bitwise."""
    from ..models.vgnlse import (
        solve_vgnlse_batch,
        solve_vgnlse_batch_trajectories,
    )

    if loss_model not in _LOSS_MODELS:
        raise ValueError(f"loss_model must be one of {_LOSS_MODELS}")
    A0, A_batch, scale, sigma2, rng = _seed_wigner(
        A0, grid, omega0=omega0, n_samples=n_samples, seed=seed,
        vector=True)

    t0 = time.perf_counter()
    if loss_model == "langevin":
        n_steps = int(round(float(cfg.z_max) / float(cfg.dz)))
        n_chunks = n_steps // int(cfg.save_every)
        _, ok, outs, z = _propagate_langevin_gnlse(
            cfg, coeffs, A_batch, sigma2=sigma2, n_segments=max(n_chunks, 1),
            rng=rng, nl=nl, mesh=None, device=device, boundaries=True,
            solve_fn=solve_vgnlse_batch,
        )
        A_traj = np.stack(outs, axis=1)            # (B, S+1, 2, T)
    else:
        z, A_traj, ok = solve_vgnlse_batch_trajectories(cfg, coeffs,
                                                        A_batch, nl=nl,
                                                        device=device)
    elapsed = time.perf_counter() - t0
    ok = np.asarray(ok, dtype=bool)
    if not ok[0]:
        raise FloatingPointError("the noise-free mean-field lane diverged")
    if ok[1:].sum() < 16:
        raise FloatingPointError("too few lanes survived for statistics")
    return _evolution_from_traj(z, np.asarray(A_traj, dtype=np.complex128),
                                ok, A0, scale, lo_mode, elapsed)


def vector_pulse_squeezing_monte_carlo(
    cfg: SimulationConfig,
    coeffs,
    A0: np.ndarray,
    grid,
    *,
    omega0: float,
    n_samples: int = 4096,
    seed: int = 0,
    lo_mode="mean-output",
    nl=None,
    mesh=None,
    device=None,
    loss_model: str = "deterministic",
    n_loss_segments: int = 16,
) -> PulseSqueezingResult:
    """Polarization-resolved quadrature squeezing (vector-GNLSE family):
    the truncated-Wigner measurement of :func:`pulse_squeezing_monte_carlo`
    with BOTH polarization components receiving independent per-time-bin
    vacuum, propagated through ``models.vgnlse.solve_vgnlse_batch``
    (``coeffs`` is a :class:`~..models.vgnlse.VGNLSECoeffs`; ``A0`` is the
    (2, T) Jones-resolved input).  ``lo_mode`` selects the measured mode:
    the self-adapted mean output, the input, or an explicit (2, T) Jones
    mode -- e.g. ``(x - y)/sqrt(2)`` to probe the polarization orthogonal
    to a +45deg pump.

    Oracle (tests/test_pulse_noise.py, exact by the Manakov U(2)
    invariance): an equal-split CW pump under dispersion-free Manakov
    coupling squeezes its +45deg mode on the SCALAR linearized Kerr
    ellipse with mu = gamma_eff P z, while the orthogonal -45deg mode --
    pure XPM on vacuum -- stays the exact vacuum circle.
    ``loss_model='langevin'`` injects distributed-loss vacuum per segment
    into both polarizations (flat or (2, T) spectral alpha)."""
    A0, A_end, ok, scale, elapsed = _pulse_wigner_ensemble(
        cfg, coeffs, A0, grid, omega0=omega0, n_samples=n_samples,
        seed=seed, nl=nl, mesh=mesh, device=device, loss_model=loss_model,
        n_loss_segments=n_loss_segments, vector=True,
    )
    f = _resolve_lo_mode(lo_mode, A_end[0], A0)
    stats, u_mf = _homodyne_stats(A_end[0], A_end[1:][ok[1:]], f, scale)
    return PulseSqueezingResult(
        stats=stats,
        mean_photons=u_mf**2,
        n_samples=int(ok[1:].sum()),
        ok_fraction=float(ok[1:].mean()),
        elapsed_s=elapsed,
    )


# ---------------------------------------------------------------------------
# Photon-number statistics / spectrally filtered direct detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PulsePhotonStatistics:
    """Wigner-corrected photon-number statistics of a propagated pulse
    ensemble, resolved over the fft-ordered spectral bins of the unitary
    DFT (each bin one bosonic mode).

    Symmetric (Wigner) moments convert exactly to normal-ordered ones:
    ``n = <|u|^2> - 1/2`` per mode and ``Var(n_hat) = Var_W - 1/4`` per
    mode (``- sum w_i^2 / 4`` for a weighted sum), so a coherent state
    shows ``fano == 1`` in every bin regardless of occupation.  Direct
    detection behind a spectral filter ``w`` measures ``sum w_i n_i``;
    ``fano < 1`` is photon-number squeezing."""

    omega: np.ndarray         # (T,) fft-ordered baseband offsets [rad/s]
    n_mean: np.ndarray        # (T,) per-bin mean photons (ensemble)
    fano: np.ndarray          # (T,) per-bin Fano factor (shot noise = 1)
    total_photons: float      # unfiltered total mean photons
    total_fano: float         # unfiltered direct-detection Fano
    filtered_photons: Optional[float]   # behind filter_w (None if no filter)
    filtered_fano: Optional[float]
    filter_w: Optional[np.ndarray]      # (T,) weights actually applied
    n_samples: int
    ok_fraction: float
    elapsed_s: float

    def __repr__(self) -> str:
        extra = ""
        if self.filtered_fano is not None:
            extra = (f", filtered_fano={self.filtered_fano:.3f} "
                     f"({self.filtered_photons:.3g} photons)")
        return (
            f"PulsePhotonStatistics(total_fano={self.total_fano:.3f}, "
            f"n={self.total_photons:.3g} photons, "
            f"n_samples={self.n_samples}{extra})"
        )


def _bin_stats(n_w: np.ndarray):
    """Per-mode Wigner-corrected photon mean and Fano from (B, M) Wigner
    occupations ``|u|^2`` (meaningful where ``n_mean > 0``; empty modes
    give nan)."""
    n_mean = n_w.mean(axis=0) - 0.5
    var_bin = n_w.var(axis=0, ddof=1) - 0.25
    with np.errstate(divide="ignore", invalid="ignore"):
        fano = np.where(n_mean > 0, var_bin / n_mean, np.nan)
    return n_mean, fano


def _weighted_photon_stats(n_w, w):
    """Mean photons and Wigner-corrected Fano of ``sum_i w_i |u_i|^2``
    given per-lane per-bin ``n_w = |u|^2`` (B, T) Wigner occupations."""
    w = np.asarray(w, dtype=np.float64)
    s = n_w @ w
    mean = float(s.mean() - 0.5 * w.sum())          # subtract half photons
    var = float(s.var(ddof=1) - 0.25 * (w * w).sum())
    return mean, var / mean if mean > 0 else float("nan")


def pulse_photon_statistics(
    cfg: SimulationConfig,
    coeffs,
    A0: np.ndarray,
    grid,
    *,
    omega0: float,
    n_samples: int = 4096,
    seed: int = 0,
    nl=None,
    mesh=None,
    device=None,
    loss_model: str = "deterministic",
    n_loss_segments: int = 16,
    filter_mask=None,
    optimal_filter: bool = False,
) -> PulsePhotonStatistics:
    """Photon-number statistics of a propagated pulse by truncated-Wigner
    Monte Carlo: the direct-detection counterpart of
    :func:`pulse_squeezing_monte_carlo`.  The output ensemble is resolved
    into unitary-DFT spectral modes and symmetric-ordering corrections are
    removed exactly, so a COHERENT state reads Fano = 1 in every bin and
    in total (the shot-noise oracle), and a lossless Kerr/soliton solve --
    which conserves each lane's total photon number identically -- reads
    total Fano = 1 to solver roundoff.

    ``filter_mask``: (T,) nonnegative weights on the fft-ordered spectral
    grid modeling direct detection behind a spectral filter --
    ``filtered_fano < 1`` is the spectrally-filtered photon-number
    squeezing of Spaelter et al., PRL 81, 786 (1998).
    ``optimal_filter=True`` derives the minimum-Fano linear filter from
    one half of the ensemble (w ~ C^-1 m on the Wigner-corrected
    covariance) and evaluates it on the other half (out-of-sample, no
    selection bias); the derived weights are returned in ``filter_w``.
    """
    A0, A_end, ok, scale, elapsed = _pulse_wigner_ensemble(
        cfg, coeffs, A0, grid, omega0=omega0, n_samples=n_samples,
        seed=seed, nl=nl, mesh=mesh, device=device, loss_model=loss_model,
        n_loss_segments=n_loss_segments,
    )
    T = A0.shape[0]
    lanes = A_end[1:][ok[1:]] * scale
    # unitary DFT: sum_i |u_i|^2 preserved, each bin a mode w/ vacuum 1/2
    U = np.fft.fft(lanes, axis=-1) / np.sqrt(T)
    n_w = np.abs(U) ** 2                                  # (B_ok, T)

    n_mean, fano = _bin_stats(n_w)
    tot_mean, tot_fano = _weighted_photon_stats(n_w, np.ones(T))

    filt_mean = filt_fano = None
    w_used = None
    if optimal_filter:
        if filter_mask is not None:
            raise ValueError("pass filter_mask OR optimal_filter, not both")
        B_ok = n_w.shape[0]
        if B_ok < 4 * T:
            raise ValueError(
                f"optimal_filter needs n_samples >= 4*T lanes for a usable "
                f"covariance (have {B_ok} ok lanes, T = {T})"
            )
        half = B_ok // 2
        train, test = n_w[:half], n_w[half:]
        m = train.mean(axis=0) - 0.5
        C = np.cov(train, rowvar=False, ddof=1) - 0.25 * np.eye(T)
        # scale-invariant ridge keeps the solve stable on empty bins and
        # damps the sampling noise of a (T x T) covariance from B/2 lanes
        ridge = 1e-3 * float(np.trace(C)) / T
        C_r = C + max(ridge, 0.25) * np.eye(T)
        w = np.linalg.solve(C_r, np.maximum(m, 0.0))
        w = np.maximum(w, 0.0)                  # physical filter: w >= 0
        if w.max() <= 0:
            raise FloatingPointError("optimal filter collapsed to zero")
        w /= w.max()
        filt_mean, filt_fano = _weighted_photon_stats(test, w)
        w_used = w
    elif filter_mask is not None:
        w = np.asarray(filter_mask, dtype=np.float64).reshape(T)
        if np.any(w < 0):
            raise ValueError("filter_mask weights must be >= 0")
        filt_mean, filt_fano = _weighted_photon_stats(n_w, w)
        w_used = w

    return PulsePhotonStatistics(
        omega=np.asarray(grid.omega(), dtype=np.float64),
        n_mean=n_mean, fano=fano,
        total_photons=tot_mean, total_fano=tot_fano,
        filtered_photons=filt_mean, filtered_fano=filt_fano,
        filter_w=w_used,
        n_samples=int(ok[1:].sum()),
        ok_fraction=float(ok[1:].mean()),
        elapsed_s=elapsed,
    )


def vector_pulse_photon_statistics(
    cfg: SimulationConfig,
    coeffs,
    A0: np.ndarray,
    grid,
    *,
    omega0: float,
    n_samples: int = 4096,
    seed: int = 0,
    nl=None,
    mesh=None,
    device=None,
    loss_model: str = "deterministic",
    n_loss_segments: int = 16,
    filter_mask=None,
) -> PulsePhotonStatistics:
    """Polarization-resolved photon-number statistics: the vector-family
    counterpart of :func:`pulse_photon_statistics`.  The (2, T) output is
    resolved into 2T unitary-DFT modes (x-polarization bins first); the
    per-bin arrays in the result are stacked (2, T) -> (2T,) in that
    order, and ``filter_mask`` accepts (T,) weights (applied to both
    polarizations) or explicit (2, T) per-polarization weights.  The
    symmetric-ordering corrections and oracles are the scalar ones;
    additionally the Manakov coupling conserves TOTAL photons per lane,
    so total Fano stays at the input shot noise exactly."""
    A0, A_end, ok, scale, elapsed = _pulse_wigner_ensemble(
        cfg, coeffs, A0, grid, omega0=omega0, n_samples=n_samples,
        seed=seed, nl=nl, mesh=mesh, device=device, loss_model=loss_model,
        n_loss_segments=n_loss_segments, vector=True,
    )
    T = A0.shape[1]
    lanes = A_end[1:][ok[1:]] * scale
    U = np.fft.fft(lanes, axis=-1) / np.sqrt(T)     # (B_ok, 2, T)
    n_w = np.abs(U.reshape(U.shape[0], 2 * T)) ** 2

    n_mean, fano = _bin_stats(n_w)
    tot_mean, tot_fano = _weighted_photon_stats(n_w, np.ones(2 * T))

    filt_mean = filt_fano = None
    w_used = None
    if filter_mask is not None:
        w = np.asarray(filter_mask, dtype=np.float64)
        if w.shape == (T,):
            w = np.broadcast_to(w, (2, T))
        if w.shape != (2, T):
            raise ValueError(
                f"filter_mask must have shape (T,) or (2, T), got {w.shape}"
            )
        if np.any(w < 0):
            raise ValueError("filter_mask weights must be >= 0")
        w = w.reshape(2 * T)
        filt_mean, filt_fano = _weighted_photon_stats(n_w, w)
        w_used = w

    return PulsePhotonStatistics(
        omega=np.asarray(grid.omega(), dtype=np.float64),
        n_mean=n_mean, fano=fano,
        total_photons=tot_mean, total_fano=tot_fano,
        filtered_photons=filt_mean, filtered_fano=filt_fano,
        filter_w=w_used,
        n_samples=int(ok[1:].sum()),
        ok_fraction=float(ok[1:].mean()),
        elapsed_s=elapsed,
    )


# ---------------------------------------------------------------------------
# Comb-family (N-wave) quantum noise
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CombPhotonStatistics:
    """Per-line Wigner photon statistics of a propagated comb ensemble,
    plus (when ``measure_lines`` is given) the Monte-Carlo noise figure of
    the summed photon number over those lines -- the N-wave generalization
    of :func:`noise_figure_monte_carlo`."""

    omega: np.ndarray         # (N,) absolute line frequencies [rad/s]
    n_mean: np.ndarray        # (N,) per-line mean photons (Wigner-corrected)
    fano: np.ndarray          # (N,) per-line Fano (shot noise = 1)
    nf_db: Optional[float]    # NF of the measured-line sum (None w/o lines)
    nf_se_db: Optional[float]
    gain_db: Optional[float]  # mean-field photon gain of the measurement
    measure_lines: Optional[Tuple[int, ...]]
    n_samples: int
    ok_fraction: float
    t_mode_s: float
    elapsed_s: float

    def __repr__(self) -> str:
        nf = ("" if self.nf_db is None else
              f", nf={self.nf_db:.3f}+-{self.nf_se_db:.3f} dB, "
              f"gain={self.gain_db:.2f} dB @lines{list(self.measure_lines)}")
        return (f"CombPhotonStatistics(N={self.omega.shape[0]}, "
                f"n_samples={self.n_samples}{nf})")


def comb_photon_statistics(
    cfg: SimulationConfig,
    coeffs,
    grid,
    A0: np.ndarray,
    *,
    t_mode_s: float = 1e-9,
    n_samples: int = 4096,
    seed: int = 0,
    noisy_lines=None,
    measure_lines=None,
    mesh=None,
    device=None,
    engine: str = "auto",
    coupling: str = "fft",
) -> CombPhotonStatistics:
    """Quantum-noise Monte Carlo for the N-wave comb family: every line
    gets an independent vacuum draw ``<|dA_j|^2> = (hbar w_j / 2)/T_mode``
    (mask with ``noisy_lines``, a bool (N,) array; default all), the
    ensemble rides ``models.nwave.solve_comb_batch`` (lane 0 noise-free),
    and per-line photon statistics are Wigner-corrected exactly
    (``n = <|u|^2> - 1/2``, ``Var(n_hat) = Var_W - 1/4``), so a linear
    comb reads Fano = 1 on every seeded line.

    ``measure_lines`` (indices) adds the direct-detection noise figure of
    the summed photon number over those lines -- in the undepleted PIA
    regime (two strong pumps at lines (j, k), weak signal at l, idler at
    j + k - l) this reproduces the 4-wave 2 - 1/G law, a cross-family
    consistency oracle (tests/test_pulse_noise.py)."""
    from ..models.nwave import solve_comb_batch

    A0 = np.asarray(A0, dtype=np.complex128).reshape(-1)
    N = A0.shape[0]
    omega_abs = np.asarray(grid.omegas(), dtype=np.float64)
    if omega_abs.shape != (N,):
        raise ValueError(
            f"A0 has {N} lines but the grid has {omega_abs.shape[0]}"
        )
    B = int(n_samples)
    if B < 16:
        raise ValueError("n_samples must be >= 16")
    if not float(t_mode_s) > 0.0:
        raise ValueError("t_mode_s must be positive")
    noisy = (np.ones(N, dtype=bool) if noisy_lines is None
             else np.asarray(noisy_lines, dtype=bool).reshape(N))

    sigma2 = 0.5 * hbar * omega_abs / float(t_mode_s)     # (N,) [W]
    rng = np.random.default_rng(seed)
    xi = (rng.standard_normal((B, N)) + 1j * rng.standard_normal((B, N)))
    xi *= np.sqrt(sigma2 / 2.0)
    xi[:, ~noisy] = 0.0
    A_batch = np.concatenate([A0[None], A0[None] + xi], axis=0)

    t0 = time.perf_counter()
    _pk, A_end, ok = solve_comb_batch(cfg, coeffs, A_batch, mesh=mesh, device=device,
                                      engine=engine, coupling=coupling)
    elapsed = time.perf_counter() - t0
    ok = np.asarray(ok, dtype=bool)
    if not ok[0]:
        raise FloatingPointError("the noise-free mean-field lane diverged")
    if ok[1:].sum() < 16:
        raise FloatingPointError("too few lanes survived for statistics")

    photon_scale = float(t_mode_s) / (hbar * omega_abs)   # (N,) W -> photons
    n_out = (np.abs(np.asarray(A_end)[1:][ok[1:]]) ** 2) * photon_scale
    n_mean, fano = _bin_stats(n_out)

    nf_db = nf_se = gain_db = None
    lines = None
    if measure_lines is not None:
        lines = tuple(int(j) for j in np.atleast_1d(measure_lines))
        bad = [j for j in lines if not (0 <= j < N) or not noisy[j]]
        if bad:
            raise ValueError(
                f"measure_lines {bad} out of range or masked by noisy_lines"
            )
        n_in = (np.abs(A_batch[1:][ok[1:]][:, lines]) ** 2
                * photon_scale[list(lines)]).sum(axis=1)
        n_o = n_out[:, lines].sum(axis=1)
        mf_in = float((np.abs(A0[list(lines)]) ** 2
                       * photon_scale[list(lines)]).sum())
        mf_out = float((np.abs(np.asarray(A_end)[0, list(lines)]) ** 2
                        * photon_scale[list(lines)]).sum())
        if mf_in <= 0.0:
            raise ValueError("measured line(s) carry no input power")
        snr_in = n_in.mean() ** 2 / n_in.var(ddof=1)
        snr_out = n_o.mean() ** 2 / n_o.var(ddof=1)
        nf_db = float(10.0 * np.log10(snr_in / snr_out))
        nf_se = _nf_jackknife_se_db(n_in, n_o)
        gain_db = float(10.0 * np.log10(mf_out / mf_in))

    return CombPhotonStatistics(
        omega=omega_abs, n_mean=n_mean, fano=fano,
        nf_db=nf_db, nf_se_db=nf_se, gain_db=gain_db, measure_lines=lines,
        n_samples=int(ok[1:].sum()),
        ok_fraction=float(ok[1:].mean()),
        t_mode_s=float(t_mode_s),
        elapsed_s=elapsed,
    )


# ---------------------------------------------------------------------------
# Frequency-resolved (sideband) squeezing spectrum
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SqueezingSpectrumResult:
    """Two-mode sideband noise ellipses vs baseband frequency: what a
    spectrum analyzer behind a balanced homodyne detector sweeps.  For
    each fft-ordered bin Omega the measured quantity is
    ``Re[e^{-i theta}(a_{+Omega} + a_{-Omega}^dagger)]``; its variance
    over theta traces an ellipse with extremes
    ``(m -+ |c|)/2`` where ``m = (<|a_+|^2> + <|a_-|^2>)/2`` and
    ``c = <a_+ a_->`` (the parametric sideband correlation).  Vacuum is
    1/4 at every Omega, matching :class:`QuadratureStats` units."""

    omega: np.ndarray          # (T,) fft-ordered baseband [rad/s]
    v_min: np.ndarray          # (T,)
    v_max: np.ndarray
    theta_min: np.ndarray      # (T,) squeezed-quadrature angle [rad]
    squeezing_db: np.ndarray
    antisqueezing_db: np.ndarray
    uncertainty_product: np.ndarray
    mean_photons: np.ndarray   # (T,) photons/bin of the mean-field lane
    n_samples: int
    ok_fraction: float
    elapsed_s: float

    @property
    def best_index(self) -> int:
        return int(np.nanargmin(self.squeezing_db))

    def __repr__(self) -> str:
        k = self.best_index
        return (
            f"SqueezingSpectrumResult(best {self.squeezing_db[k]:.2f} dB at "
            f"Omega={self.omega[k]:.3g} rad/s, "
            f"max antisqueezing {np.nanmax(self.antisqueezing_db):.2f} dB, "
            f"n_samples={self.n_samples})"
        )


def pulse_squeezing_spectrum(
    cfg: SimulationConfig,
    coeffs,
    A0: np.ndarray,
    grid,
    *,
    omega0: float,
    n_samples: int = 4096,
    seed: int = 0,
    nl=None,
    mesh=None,
    device=None,
    loss_model: str = "deterministic",
    n_loss_segments: int = 16,
    return_coherence: bool = False,
):
    """Sideband squeezing spectrum of a propagated field by truncated-
    Wigner Monte Carlo: the fluctuation relative to the noise-free
    mean-field lane is resolved into unitary-DFT sidebands, and each
    (+Omega, -Omega) pair's two-mode homodyne ellipse is computed from
    the second moments (phase-insensitive power ``m`` and parametric
    correlation ``c = <a_+ a_->``).

    ``return_coherence=True`` additionally reduces the SAME propagated
    ensemble to the |g12| spectral coherence (no second solve) and
    returns ``(SqueezingSpectrumResult, CoherenceResult)``.

    Oracles (tests/test_pulse_noise.py):

    - LINEAR propagation: vacuum (1/4, 1/4) at every Omega;
    - dispersion-free CW Kerr: EVERY sideband pair shows the single-mode
      linearized ellipse (all time bins transform identically);
    - CW modulation instability (anomalous beta2): antisqueezing peaks at
      the MI gain maximum Omega_c/sqrt(2), Omega_c = sqrt(4 gamma P /
      |beta2|), squeezing below vacuum across the band, and the lossless
      linearized dynamics stays at the minimum-uncertainty product 1/16.
    """
    A0, A_end, ok, scale, elapsed = _pulse_wigner_ensemble(
        cfg, coeffs, A0, grid, omega0=omega0, n_samples=n_samples,
        seed=seed, nl=nl, mesh=mesh, device=device, loss_model=loss_model,
        n_loss_segments=n_loss_segments,
    )
    T = A0.shape[0]
    du = (A_end[1:][ok[1:]] - A_end[0]) * scale    # fluctuation lanes
    a = np.fft.fft(du, axis=-1) / np.sqrt(T)       # (B_ok, T) photon units
    mirror = (-np.arange(T)) % T
    p2 = (np.abs(a) ** 2).mean(axis=0)             # <|a_Omega|^2>
    m = 0.5 * (p2 + p2[mirror])
    c = (a * a[:, mirror]).mean(axis=0)            # <a_+ a_->
    v_min = 0.5 * (m - np.abs(c))
    v_max = 0.5 * (m + np.abs(c))
    theta = 0.5 * np.angle(c) + np.pi / 2.0        # minimum-variance angle
    mean_ph = np.abs(np.fft.fft(A_end[0] * scale) / np.sqrt(T)) ** 2

    with np.errstate(divide="ignore"):
        sq_db = 10.0 * np.log10(np.maximum(v_min, 1e-300) / 0.25)
        asq_db = 10.0 * np.log10(np.maximum(v_max, 1e-300) / 0.25)
    sp = SqueezingSpectrumResult(
        omega=np.asarray(grid.omega(), dtype=np.float64),
        v_min=v_min, v_max=v_max, theta_min=theta,
        squeezing_db=sq_db, antisqueezing_db=asq_db,
        uncertainty_product=v_min * v_max,
        mean_photons=mean_ph,
        n_samples=int(ok[1:].sum()),
        ok_fraction=float(ok[1:].mean()),
        elapsed_s=elapsed,
    )
    if not return_coherence:
        return sp
    return sp, _reduce_coherence(A_end, ok, scale, grid, elapsed)


# ---------------------------------------------------------------------------
# Spectral first-order coherence |g12(omega)|
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CoherenceResult:
    """Shot-to-shot spectral coherence of a propagated pulse ensemble:
    the modulus of the complex degree of first-order coherence

        |g12(omega)| = |<A_i*(omega) A_j(omega)>_{i != j}| / <|A(omega)|^2>

    estimated over all independent lane pairs (Dudley & Coen, Opt. Lett.
    27, 1180 (2002) -- THE supercontinuum stability diagnostic).  1 means
    every shot has the same spectral phase (pulse-to-pulse interference
    fringes at full visibility); 0 means vacuum-seeded / incoherent."""

    omega: np.ndarray          # (T,) fft-ordered baseband [rad/s]
    g12: np.ndarray            # (T,) in [0, 1]
    mean_photons: np.ndarray   # (T,) ensemble-mean photons per bin
    g12_avg: float             # spectrum-weighted average coherence
    n_samples: int
    ok_fraction: float
    elapsed_s: float

    def __repr__(self) -> str:
        return (
            f"CoherenceResult(g12_avg={self.g12_avg:.4f}, "
            f"n_samples={self.n_samples})"
        )


def pulse_coherence_monte_carlo(
    cfg: SimulationConfig,
    coeffs,
    A0: np.ndarray,
    grid,
    *,
    omega0: float,
    n_samples: int = 128,
    seed: int = 0,
    nl=None,
    mesh=None,
    device=None,
    loss_model: str = "deterministic",
    n_loss_segments: int = 16,
) -> CoherenceResult:
    """First-order spectral coherence by truncated-Wigner Monte Carlo:
    the same per-time-bin vacuum ensemble as the squeezing measurements,
    reduced with the all-pairs estimator

        g12 = (|sum_i a_i|^2 - sum_i |a_i|^2) / ((B - 1) sum_i |a_i|^2)

    per unitary-DFT bin (noisy lanes only).  Bins dominated by the
    deterministic field read ~n/(n + 1/2) -> 1; bins built from amplified
    vacuum (e.g. the modulation-instability band, or decoherent
    supercontinuum regions) read ~0.  ``g12_avg`` weights by the mean
    spectrum, the single-number figure of merit of Dudley, Genty & Coen,
    RMP 78, 1135 (2006), Eq. (25)."""
    A0, A_end, ok, scale, elapsed = _pulse_wigner_ensemble(
        cfg, coeffs, A0, grid, omega0=omega0, n_samples=n_samples,
        seed=seed, nl=nl, mesh=mesh, device=device, loss_model=loss_model,
        n_loss_segments=n_loss_segments,
    )
    return _reduce_coherence(A_end, ok, scale, grid, elapsed)


def _g12_from_modes(a_flat, omega, ok_fraction, elapsed) -> CoherenceResult:
    """All-pairs |g12| over a (B_ok, M) mode matrix in photon units
    (``omega`` is the matching (M,) coordinate of each mode)."""
    B_ok = a_flat.shape[0]
    S1 = a_flat.sum(axis=0)
    S2 = (np.abs(a_flat) ** 2).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        g12 = np.where(S2 > 0,
                       np.abs(np.abs(S1) ** 2 - S2) / ((B_ok - 1) * S2),
                       0.0)
    g12 = np.clip(g12, 0.0, 1.0)
    n_mean = np.maximum(S2 / B_ok - 0.5, 0.0)
    w = n_mean.sum()
    g12_avg = float((g12 * n_mean).sum() / w) if w > 0 else float("nan")
    return CoherenceResult(
        omega=omega, g12=g12, mean_photons=n_mean, g12_avg=g12_avg,
        n_samples=int(B_ok),
        ok_fraction=ok_fraction,
        elapsed_s=elapsed,
    )


def _reduce_coherence(A_end, ok, scale, grid, elapsed) -> CoherenceResult:
    """All-pairs |g12| reduction of a propagated ensemble (noisy lanes)."""
    T = A_end.shape[-1]
    a = np.fft.fft(A_end[1:][ok[1:]] * scale, axis=-1) / np.sqrt(T)
    return _g12_from_modes(a, np.asarray(grid.omega(), dtype=np.float64),
                           float(ok[1:].mean()), elapsed)


# ---------------------------------------------------------------------------
# Continuous-variable entanglement: Duan-Simon EPR criterion
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EPRResult:
    """Duan-Simon inseparability of the signal/idler twin beams.

    ``duan`` is the minimized EPR sum Var_theta[(X_s + X_i)/sqrt2] +
    Var_{theta+90}[(X_s - X_i)/sqrt2]; separable states obey
    ``duan >= 1/2`` (two vacuum quadratures at 1/4), so ``duan < 1/2``
    VERIFIES entanglement (Duan et al. PRL 84, 2722; Simon PRL 84, 2726).
    An ideal two-mode squeezer gives ``exp(-2r)/2`` with
    ``sinh^2 r = n`` photons per beam.  ``entangled`` requires STATISTICAL
    significance: duan + 3 SE < 1/2 (a point estimate at the bound flips
    on MC noise ~half the time)."""

    duan: float
    duan_se: float              # delete-block jackknife standard error
    separable_bound: float      # 1/2 in these units
    entangled: bool             # duan + 3*duan_se < 1/2
    theta: float                # optimizing quadrature angle [rad]
    n_signal: float             # mean photons scattered into the signal
    duan_theory: float          # exp(-2r)/2 from n_signal (ideal TMSV)
    stats_plus: QuadratureStats
    stats_minus: QuadratureStats
    n_samples: int

    def __repr__(self) -> str:
        return (
            f"EPRResult(duan={self.duan:.4f}+-{self.duan_se:.4f} vs bound "
            f"0.5 -> {'ENTANGLED' if self.entangled else 'separable'}, "
            f"theory {self.duan_theory:.4f}, n={self.n_signal:.3g})"
        )


def epr_inseparability_monte_carlo(
    cfg: SimulationConfig,
    *,
    gamma: float,
    alpha: float,
    omega: np.ndarray,
    p_pump_W: float,
    delta_beta: float = 0.0,
    t_mode_s: float = 1e-9,
    n_samples: int = 8192,
    seed: int = 0,
    mesh=None,
    device=None,
    engine: str = "auto",
    loss_model: str = "deterministic",
    n_loss_segments: int = 16,
) -> EPRResult:
    """Verify continuous-variable entanglement of the vacuum-seeded
    signal/idler pair behind a dual-pump parametric amplifier: propagate
    the Wigner vacuum (pumps noiseless), form the +-45-degree
    superposition modes, and minimize the Duan sum over the common
    quadrature angle analytically,

        D(theta)  = Var_theta(u_+) + Var_{theta+90}(u_-)
        D_min     = (m_+ + m_-)/2 - |s_+ - s_-|/2,

    with m = <|u|^2>, s = <u^2> of the (zero-mean) mode amplitudes.
    D_min < 1/2 is impossible for ANY separable state.  Oracle
    (tests/test_noise.py): the lossless PSA's twin beams reach the ideal
    two-mode-squeezed value exp(-2r)/2 inferred from the scattered photon
    number sinh^2 r.

    ``loss_model='langevin'`` matters here more than anywhere: a lossy
    VACUUM channel under the deterministic default decays the ensemble
    below the vacuum floor and certifies FAKE entanglement (duan =
    eta/2 < 1/2 with no nonlinearity at all); the beamsplitter injection
    keeps it at exactly 1/2 (tests/test_noise.py)."""
    A_end, omega = _fwm4_vacuum_ensemble(
        cfg, gamma=gamma, alpha=alpha, omega=omega, p_pump_W=p_pump_W,
        delta_beta=delta_beta, t_mode_s=t_mode_s, n_samples=n_samples,
        seed=seed, mesh=mesh, device=device, engine=engine, loss_model=loss_model,
        n_loss_segments=n_loss_segments,
    )
    us = A_end[:, 2] * np.sqrt(t_mode_s / (hbar * float(omega[2])))
    ui = A_end[:, 3] * np.sqrt(t_mode_s / (hbar * float(omega[3])))
    u_p = (us + ui) / np.sqrt(2.0)
    u_m = (us - ui) / np.sqrt(2.0)

    def _duan(up, um):
        # D(theta) = (m_p + m_m)/2 + Re[e^{-2i theta}(s_p - s_m)]/2
        m = float((np.abs(up) ** 2).mean() + (np.abs(um) ** 2).mean())
        d = complex((up * up).mean() - (um * um).mean())
        return 0.5 * m - 0.5 * abs(d), d

    duan, d = _duan(u_p, u_m)
    # delete-block jackknife SE (the entanglement claim must be
    # statistically significant, not a point-estimate coin flip)
    Bk = u_p.shape[0]
    k = min(32, Bk // 2)
    mlen = (Bk // k) * k
    thetas = np.array([
        _duan(np.delete(u_p[:mlen].reshape(k, -1), j, axis=0).ravel(),
              np.delete(u_m[:mlen].reshape(k, -1), j, axis=0).ravel())[0]
        for j in range(k)
    ])
    duan_se = float(np.sqrt((k - 1) / k * ((thetas - thetas.mean()) ** 2)
                            .sum()))
    theta = 0.5 * (np.angle(-d)) if d != 0 else 0.0
    n_sig = max(float((np.abs(us) ** 2).mean()) - 0.5, 0.0)
    r = np.arcsinh(np.sqrt(n_sig))
    return EPRResult(
        duan=float(duan),
        duan_se=duan_se,
        separable_bound=0.5,
        entangled=bool(duan + 3.0 * duan_se < 0.5),
        theta=float(theta),
        n_signal=n_sig,
        duan_theory=float(0.5 * np.exp(-2.0 * r)),
        stats_plus=quadrature_stats_u(u_p),
        stats_minus=quadrature_stats_u(u_m),
        n_samples=int(A_end.shape[0]),
    )


def vector_pulse_coherence_monte_carlo(
    cfg: SimulationConfig,
    coeffs,
    A0: np.ndarray,
    grid,
    *,
    omega0: float,
    n_samples: int = 128,
    seed: int = 0,
    nl=None,
    mesh=None,
    device=None,
    loss_model: str = "deterministic",
    n_loss_segments: int = 16,
) -> CoherenceResult:
    """Polarization-resolved shot-to-shot spectral coherence: the
    :func:`pulse_coherence_monte_carlo` measurement per polarization
    component of the vector ensemble.  EVERY per-bin field stacks
    (2, T) -> (2T,) (x-polarization bins first, the vector photon-
    statistics convention) -- including ``omega``, which tiles the grid
    per polarization so the per-mode correspondence holds;
    ``g12_avg`` weights across both."""
    A0, A_end, ok, scale, elapsed = _pulse_wigner_ensemble(
        cfg, coeffs, A0, grid, omega0=omega0, n_samples=n_samples,
        seed=seed, nl=nl, mesh=mesh, device=device, loss_model=loss_model,
        n_loss_segments=n_loss_segments, vector=True,
    )
    T = A_end.shape[-1]
    # per-polarization unitary DFT, then the shared all-pairs estimator
    # over the stacked (2T,) mode axis; omega tiles per polarization so
    # every field keeps its per-mode correspondence
    a2 = np.fft.fft(A_end[1:][ok[1:]] * scale, axis=-1) / np.sqrt(T)
    om = np.asarray(grid.omega(), dtype=np.float64)
    return _g12_from_modes(a2.reshape(a2.shape[0], 2 * T),
                           np.concatenate([om, om]),
                           float(ok[1:].mean()), elapsed)


# ---------------------------------------------------------------------------
# Pump-RIN transfer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RINTransferResult:
    """Pump-RIN -> signal-gain transfer: Monte-Carlo regression slopes of
    the measured gain [dB] on each jittered launch power [dB], against
    the EXACT autodiff sensitivities
    (``calibrate.power_transfer_db_per_db``) -- a relative-intensity-
    noise budget for the amplifier."""

    transfer_db_per_db: np.ndarray     # (4,) MC regression slopes
    transfer_se: np.ndarray            # (4,) slope standard errors
    transfer_autodiff: np.ndarray      # (4,) exact gradient reference
    gain_std_db: float                 # induced gain spread at rel_sigma
    rel_sigma: float
    n_samples: int

    def __repr__(self) -> str:
        rows = ", ".join(
            f"{n}={t:+.2f}" for n, t in
            zip(("p1", "p2", "s", "i"), self.transfer_db_per_db))
        return (f"RINTransferResult({rows} dB/dB, "
                f"gain_std={self.gain_std_db:.4f} dB)")


def pump_rin_transfer_monte_carlo(
    cfg: SimulationConfig,
    *,
    gamma: float,
    alpha: float,
    delta_beta: float,
    p_in,
    phase_in=None,
    rel_sigma: float = 1e-3,
    n_samples: int = 4096,
    seed: int = 0,
    wave: int = 2,
    mesh=None,
    device=None,
    engine: str = "auto",
) -> RINTransferResult:
    """How pump relative-intensity noise maps into signal-gain noise:
    every lane's launch POWERS get independent log-normal jitter of
    relative width ``rel_sigma`` (each wave separately; zero-power waves
    stay zero), the batch rides ``sweep.solve_batch``, and the measured
    gain [dB] is regressed on each launch power [dB] jointly (ordinary
    least squares over the jittered designs).  Small-signal oracle: the
    slopes equal the autodiff sensitivities of
    :func:`~.calibrate.power_transfer_db_per_db` within the regression
    standard errors."""
    from .calibrate import power_transfer_db_per_db

    p_in = np.asarray(p_in, dtype=np.float64).reshape(4)
    if p_in[wave] <= 0.0:
        raise ValueError(f"wave {wave} carries no input power")
    B = int(n_samples)
    if B < 64:
        raise ValueError("n_samples must be >= 64 for the regression")
    if not 0.0 < float(rel_sigma) < 0.5:
        raise ValueError("rel_sigma must be in (0, 0.5)")
    rng = np.random.default_rng(seed)
    live = p_in > 0.0
    jitter = np.exp(rng.standard_normal((B, 4)) * float(rel_sigma))
    jitter[:, ~live] = 1.0
    P = p_in[None, :] * jitter

    phase = np.zeros(4) if phase_in is None else np.asarray(phase_in,
                                                            dtype=np.float64)
    A0 = np.sqrt(P) * np.exp(1j * phase)[None, :]
    coeffs = RHSCoeffs(
        gamma=np.full(B, float(gamma)),
        alpha=np.full(B, float(alpha)),
        delta_beta=np.full(B, float(delta_beta)),
    )
    res = solve_batch(cfg, coeffs, A0, mesh=mesh, device=device, engine=engine)
    ok = np.asarray(res.ok, dtype=bool)
    if ok.sum() < 64:
        raise FloatingPointError("too few lanes survived for regression")
    g_db = 10.0 * np.log10(np.abs(np.asarray(res.A_end)[ok, wave]) ** 2
                           / P[ok, wave])

    # joint OLS of gain on the live launch powers [dB] + intercept
    cols = np.where(live)[0]
    X = np.concatenate(
        [10.0 * np.log10(P[ok][:, cols]), np.ones((int(ok.sum()), 1))],
        axis=1,
    )
    beta, _, _, _ = np.linalg.lstsq(X, g_db, rcond=None)
    resid = g_db - X @ beta
    dof = X.shape[0] - X.shape[1]
    cov = (np.linalg.inv(X.T @ X)
           * float((resid ** 2).sum() / max(dof, 1)))
    slopes = np.zeros(4)
    ses = np.zeros(4)
    slopes[cols] = beta[:-1]
    ses[cols] = np.sqrt(np.diag(cov)[:-1])

    auto = power_transfer_db_per_db(
        cfg, gamma=gamma, alpha=alpha, delta_beta=delta_beta, p_in=p_in,
        phase_in=phase_in, wave=wave, device=device,
    )
    return RINTransferResult(
        transfer_db_per_db=slopes,
        transfer_se=ses,
        transfer_autodiff=np.asarray(auto),
        gain_std_db=float(g_db.std(ddof=1)),
        rel_sigma=float(rel_sigma),
        n_samples=int(ok.sum()),
    )


# ---------------------------------------------------------------------------
# Ensemble moment statistics: energy / timing / frequency jitter
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PulseMomentStatistics:
    """Shot-to-shot statistics of the pulse collective coordinates at
    every saved z: photon number (energy), power-weighted temporal
    centroid and spectral centroid -- the soliton jitter observables.

    Exact NLSE theorems give oracles with no linearization: per lane the
    photon number and the spectral centroid are conserved (lossless, no
    Raman), and the temporal centroid drifts as ``dt_c/dz = beta2 f_c``
    -- so ``Var_t(z) = Var_t(0) + 2 beta2 z Cov(t0, f) + (beta2 z)^2
    Var_f`` holds EXACTLY, while distributed-loss vacuum injection
    (``loss_model='langevin'``) adds frequency diffusion and the
    super-quadratic Gordon-Haus timing jitter."""

    z_m: np.ndarray             # (S+1,)
    energy_mean: np.ndarray     # (S+1,) photons
    energy_var: np.ndarray
    t_mean: np.ndarray          # (S+1,) s
    t_var: np.ndarray           # (S+1,) s^2
    f_mean: np.ndarray          # (S+1,) rad/s (baseband)
    f_var: np.ndarray           # (S+1,) (rad/s)^2
    tf_cov: np.ndarray          # (S+1,) s * rad/s
    n_samples: int
    ok_fraction: float
    elapsed_s: float

    def __repr__(self) -> str:
        return (
            f"PulseMomentStatistics(sigma_t {np.sqrt(self.t_var[0]):.3g} -> "
            f"{np.sqrt(self.t_var[-1]):.3g} s, sigma_f "
            f"{np.sqrt(self.f_var[0]):.3g} -> {np.sqrt(self.f_var[-1]):.3g} "
            f"rad/s, n_samples={self.n_samples})"
        )


def pulse_moment_statistics(
    cfg: SimulationConfig,
    coeffs,
    A0: np.ndarray,
    grid,
    *,
    omega0: float,
    n_samples: int = 1024,
    seed: int = 0,
    nl=None,
    mesh=None,
    device=None,
    loss_model: str = "deterministic",
) -> PulseMomentStatistics:
    """Timing / frequency / energy jitter of a pulse ensemble along the
    fiber (one trajectory solve; the measurement behind Gordon-Haus
    analyses).  Per lane and saved z:

        E   = sum |u|^2                (photons, unitary-DFT-consistent)
        t_c = sum t |A|^2 / sum |A|^2  (power-weighted centroid)
        f_c = sum w |Ã|^2 / sum |Ã|^2  (spectral centroid, baseband)

    and the ensemble mean/variance (+ t-f covariance) of each.  Noisy
    lanes only (lane 0 drives the solve but is excluded from statistics).
    """
    from ..models.gnlse import solve_gnlse_batch_trajectories

    if loss_model not in _LOSS_MODELS:
        raise ValueError(f"loss_model must be one of {_LOSS_MODELS}")
    A0, A_batch, scale, sigma2, rng = _seed_wigner(
        A0, grid, omega0=omega0, n_samples=n_samples, seed=seed)

    t0 = time.perf_counter()
    if loss_model == "langevin":
        n_steps = int(round(float(cfg.z_max) / float(cfg.dz)))
        n_chunks = n_steps // int(cfg.save_every)
        _, ok, outs, z = _propagate_langevin_gnlse(
            cfg, coeffs, A_batch, sigma2=sigma2, n_segments=max(n_chunks, 1),
            rng=rng, nl=nl, mesh=mesh, device=device, boundaries=True,
        )
        A_traj = np.stack(outs, axis=1)
    else:
        z, A_traj, ok = solve_gnlse_batch_trajectories(cfg, coeffs, A_batch,
                                                       nl=nl, mesh=mesh, device=device)
    elapsed = time.perf_counter() - t0
    return _moment_reduce(z, A_traj, ok, grid, scale, elapsed)


def _moment_reduce(z, A_traj, ok, grid, scale, elapsed) -> PulseMomentStatistics:
    """Collective-coordinate ensemble statistics from a stacked trajectory
    ``A_traj (B+1, S+1, T)`` (lane 0 the noise-free mean field, excluded)
    -- the shared reduction behind :func:`pulse_moment_statistics` and the
    multi-span link measurement (``parallel/link.py``)."""
    ok = np.asarray(ok, dtype=bool)
    if ok[1:].sum() < 16:
        raise FloatingPointError("too few lanes survived for statistics")

    lanes = np.asarray(A_traj, dtype=np.complex128)[1:][ok[1:]]  # (B,S+1,T)
    T = lanes.shape[-1]
    t = np.asarray(grid.t(), dtype=np.float64)
    om = np.asarray(grid.omega(), dtype=np.float64)
    P = np.abs(lanes) ** 2                                       # (B,S+1,T)
    Ptot = P.sum(axis=-1)
    S = np.abs(np.fft.fft(lanes, axis=-1)) ** 2 / T
    Stot = S.sum(axis=-1)
    E = Ptot * (scale ** 2)                                      # photons
    t_c = (P * t).sum(axis=-1) / Ptot
    f_c = (S * om).sum(axis=-1) / Stot

    def mv(x):
        return x.mean(axis=0), x.var(axis=0, ddof=1)

    e_m, e_v = mv(E)
    t_m, t_v = mv(t_c)
    f_m, f_v = mv(f_c)
    cov = ((t_c - t_m) * (f_c - f_m)).sum(axis=0) / (t_c.shape[0] - 1)
    return PulseMomentStatistics(
        z_m=np.asarray(z, dtype=float),
        energy_mean=e_m, energy_var=e_v,
        t_mean=t_m, t_var=t_v, f_mean=f_m, f_var=f_v, tf_cov=cov,
        n_samples=int(ok[1:].sum()),
        ok_fraction=float(ok[1:].mean()),
        elapsed_s=elapsed,
    )


def comb_pair_squeezing_monte_carlo(
    cfg: SimulationConfig,
    coeffs,
    grid,
    A0: np.ndarray,
    *,
    pair,
    t_mode_s: float = 1e-9,
    n_samples: int = 8192,
    seed: int = 0,
    noisy_lines=None,
    mesh=None,
    device=None,
    engine: str = "auto",
    coupling: str = "fft",
) -> Tuple[QuadratureStats, QuadratureStats]:
    """Two-mode squeezing of a comb line pair: the vacuum-seeded ensemble
    of :func:`comb_photon_statistics`, measured as the noise ellipses of
    the single line ``pair[0]`` and of the joint +45-degree superposition
    ``(a_j + a_k)/sqrt(2)`` -- the comb generalization of
    :func:`psa_squeezing_monte_carlo` (vacuum through a parametric comb:
    the pair straddling two pumps squeezes below vacuum at minimum
    uncertainty while each line alone is thermal).  Cross-family oracle:
    on a 4-line comb in the 4-wave configuration this reproduces the
    4-wave module's ellipses (tests/test_pulse_noise.py)."""
    from ..models.nwave import solve_comb_batch

    A0 = np.asarray(A0, dtype=np.complex128).reshape(-1)
    N = A0.shape[0]
    omega_abs = np.asarray(grid.omegas(), dtype=np.float64)
    j, k = (int(pair[0]), int(pair[1]))
    if not (0 <= j < N and 0 <= k < N):
        raise ValueError(f"pair {pair} out of range for {N} lines")
    B = int(n_samples)
    if B < 16:
        raise ValueError("n_samples must be >= 16")
    noisy = (np.ones(N, dtype=bool) if noisy_lines is None
             else np.asarray(noisy_lines, dtype=bool).reshape(N))
    sigma2 = 0.5 * hbar * omega_abs / float(t_mode_s)
    rng = np.random.default_rng(seed)
    xi = (rng.standard_normal((B, N)) + 1j * rng.standard_normal((B, N)))
    xi *= np.sqrt(sigma2 / 2.0)
    xi[:, ~noisy] = 0.0

    _pk, A_end, ok = solve_comb_batch(cfg, coeffs, A0[None] + xi, mesh=mesh, device=device,
                                      engine=engine, coupling=coupling)
    ok = np.asarray(ok, dtype=bool)
    if ok.sum() < 16:
        raise FloatingPointError("too few lanes survived for statistics")
    A_end = np.asarray(A_end)[ok]
    uj = A_end[:, j] * np.sqrt(t_mode_s / (hbar * omega_abs[j]))
    uk = A_end[:, k] * np.sqrt(t_mode_s / (hbar * omega_abs[k]))
    return (quadrature_stats_u(uj),
            quadrature_stats_u((uj + uk) / np.sqrt(2.0)))
