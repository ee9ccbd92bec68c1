"""The dual-pump 4-wave FWM / phase-sensitive-amplifier model: parameter
containers, lowering, and the single-run orchestrator.

Counterpart of the JAX package's ``models/fwm4.py``:

- parameter containers -- reference ``parameters.py``: ``WAVE_ORDER``,
  ``WavesParams``, ``FiberParams``, ``SimulationGrid``,
  ``PhaseMatchingParams``, ``CacheParams``, ``ModelParams`` and factories;
- runner -- reference ``simulation.py``: unit boundary,
  ``make_initial_amplitudes``, dispersion/phase-matching rescaling, the
  default phase-matching choice, ``run_single_simulation`` and the examples.

The rich containers are host-side frozen dataclasses validated eagerly, as in
the reference.  :func:`lower_params` distills them once into the small
:class:`~..ops.rhs.RHSCoeffs` tensors the RHS consumes, outside the step
loop.  A single run is one trajectory integrated with plain torch on the
requested device (``ops/integrators.py``, or ``ops/adaptive.py`` for rk45);
the JAX package runs it through ``lax.scan``/``lax.while_loop`` with no
kernel either.  ``device=None`` means the CUDA card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SimulationConfig, validate_config, reject_non_ode
from ..ops.dispersion import DispersionParams
from ..ops.frequency_plan import SymmetricPlan
from ..ops.adaptive import run_adaptive_trajectory
from ..ops.integrators import integrate_fixed_grid
from ..ops.phase_matching import (
    PhaseMatchingConfig,
    PhaseMatchingMethod,
    PhaseMatchingResult,
    compute_phase_mismatch,
)
from ..ops.rhs import RHSCoeffs, rhs_yaman, rhs_yaman_autonomous, rotating_to_lab
from ..utils.checks import resolve_device, to_scalar_float, validate_nonneg, validate_positive
from ..utils.precision import complex_dtype, real_dtype, validate_precision
from ..utils.units import length_scale_to_m


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


WAVE_ORDER: Tuple[str, str, str, str] = ("pump1", "pump2", "signal", "idler")

VALID_FRAMES = ("lab", "rotating")


# ---------------------------------------------------------------------------
# Input validation helpers (reference simulation.py:70-100)
# ---------------------------------------------------------------------------

def _to_omega_array(omega: Sequence[float]) -> np.ndarray:
    om = np.asarray(list(omega), dtype=float)
    if om.shape != (4,):
        raise ValueError(f"omega must have shape (4,), got {om.shape}")
    if not np.all(np.isfinite(om)):
        raise ValueError("omega must be finite")
    if np.any(om <= 0.0):
        raise ValueError("omega must be positive (rad/s)")
    return om


def _to_power_array(p_in: Sequence[float]) -> np.ndarray:
    p = np.asarray(list(p_in), dtype=float)
    if p.shape != (4,):
        raise ValueError(f"p_in must have shape (4,), got {p.shape}")
    if not np.all(np.isfinite(p)):
        raise ValueError("p_in must be finite")
    if np.any(p < 0.0):
        raise ValueError("p_in must be non-negative (W)")
    return p


def _to_phase_array(phase_in: Optional[Sequence[float]]) -> np.ndarray:
    if phase_in is None:
        return np.zeros(4, dtype=float)
    ph = np.asarray(list(phase_in), dtype=float)
    if ph.shape != (4,):
        raise ValueError(f"phase_in must have shape (4,), got {ph.shape}")
    if not np.all(np.isfinite(ph)):
        raise ValueError("phase_in must be finite")
    return ph


def make_initial_amplitudes(
    p_in: Sequence[float],
    phase_in: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """A0_j = sqrt(P_j) * exp(i phi_j), complex128 shape (4,).
    Parity: reference ``simulation.py:103-123``."""
    p = _to_power_array(p_in)
    ph = _to_phase_array(phase_in)
    amp = np.sqrt(p).astype(np.complex128, copy=False)
    if np.any(ph != 0.0):
        amp = amp * np.exp(1j * ph)
    return amp


# ---------------------------------------------------------------------------
# Parameter containers (host-side; reference parameters.py)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WavesParams:
    """Optical wave frequency plan; ``omega`` is (4,) in project wave order."""

    omega: np.ndarray
    symmetric: Optional[SymmetricPlan] = None

    def __post_init__(self):
        om = _to_omega_array(self.omega)
        object.__setattr__(self, "omega", om)
        if self.symmetric is not None:
            if not isinstance(self.symmetric, SymmetricPlan):
                raise TypeError("symmetric must be SymmetricPlan or None")
            om_sym = _host(self.symmetric.omegas())
            if not np.allclose(om, om_sym, rtol=1e-12, atol=0.0):
                raise ValueError(
                    "Provided symmetric plan is inconsistent with omega. "
                    f"omega={om}, omega(sym)={om_sym}"
                )

    @property
    def omega1(self) -> float:
        return float(self.omega[0])

    @property
    def omega2(self) -> float:
        return float(self.omega[1])

    @property
    def omega3(self) -> float:
        return float(self.omega[2])

    @property
    def omega4(self) -> float:
        return float(self.omega[3])

    @classmethod
    def from_symmetry(cls, omega_c: float, omega_d: float, Omega: float) -> "WavesParams":
        sp = SymmetricPlan(omega_c=float(omega_c), omega_d=float(omega_d),
                           Omega=float(Omega))
        return cls(omega=_host(sp.omegas()), symmetric=sp)

    @classmethod
    def from_omegas(
        cls, omega1: float, omega2: float, omega3: float, omega4: Optional[float] = None
    ) -> "WavesParams":
        from ..ops.frequency_plan import plan_from_omegas

        om = _host(plan_from_omegas(omega1, omega2, omega3, omega4))
        return cls(omega=om, symmetric=None)

    @classmethod
    def from_wavelengths(
        cls,
        lambda1_m: float,
        lambda2_m: float,
        lambda3_m: float,
        lambda4_m: Optional[float] = None,
    ) -> "WavesParams":
        from ..ops.frequency_plan import plan_from_wavelengths

        om = _host(plan_from_wavelengths(lambda1_m, lambda2_m, lambda3_m, lambda4_m))
        return cls(omega=om, symmetric=None)


@dataclass(frozen=True)
class FiberParams:
    """Fiber / waveguide parameters (per-meter units)."""

    length_m: float
    gamma_W_m: float
    alpha_1_m: float = 0.0
    dispersion: Optional[DispersionParams] = None
    beta_legacy_1_m: Optional[np.ndarray] = None

    def __post_init__(self):
        object.__setattr__(self, "length_m", validate_positive(self.length_m, name="length_m"))
        object.__setattr__(self, "gamma_W_m", to_scalar_float(self.gamma_W_m, name="gamma_W_m"))
        object.__setattr__(self, "alpha_1_m", validate_nonneg(self.alpha_1_m, name="alpha_1_m"))
        if self.dispersion is not None and not isinstance(self.dispersion, DispersionParams):
            raise TypeError("dispersion must be DispersionParams or None")
        if self.beta_legacy_1_m is not None:
            bl = np.asarray(list(self.beta_legacy_1_m), dtype=float)
            if bl.shape != (4,):
                raise ValueError(f"beta_legacy_1_m must have shape (4,), got {bl.shape}")
            if not np.all(np.isfinite(bl)):
                raise ValueError("beta_legacy_1_m must contain finite values")
            object.__setattr__(self, "beta_legacy_1_m", bl)


@dataclass(frozen=True)
class SimulationGrid:
    """Discretization parameters (meters)."""

    dz_m: float
    z0_m: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "dz_m", validate_positive(self.dz_m, name="dz_m"))
        object.__setattr__(self, "z0_m", to_scalar_float(self.z0_m, name="z0_m"))


@dataclass(frozen=True)
class PhaseMatchingParams:
    config: PhaseMatchingConfig

    def __post_init__(self):
        if not isinstance(self.config, PhaseMatchingConfig):
            raise TypeError("config must be a PhaseMatchingConfig")


@dataclass
class CacheParams:
    """Computed-phase-mismatch slot, filled at simulation start.

    Kept mutable for API parity with the reference's runtime cache
    (``parameters.py:236-251``); the functional alternative is
    :func:`with_phase_mismatch`.
    """

    delta_beta_1_m: Optional[float] = None
    symmetric: Optional[SymmetricPlan] = None

    def set_phase_mismatch(
        self, delta_beta_1_m: float, symmetric: Optional[SymmetricPlan] = None
    ) -> None:
        self.delta_beta_1_m = to_scalar_float(delta_beta_1_m, name="delta_beta_1_m")
        self.symmetric = symmetric


@dataclass(frozen=True)
class ModelParams:
    """Aggregated model parameters."""

    waves: WavesParams
    fiber: FiberParams
    grid: SimulationGrid
    phase_matching: PhaseMatchingParams
    cache: CacheParams

    def __post_init__(self):
        if not isinstance(self.cache, CacheParams):
            raise TypeError("cache must be a CacheParams (mutable cache object)")


def make_default_phase_matching_params(
    *, method: PhaseMatchingMethod = PhaseMatchingMethod.SYMMETRIC_EVEN
) -> PhaseMatchingParams:
    cfg = PhaseMatchingConfig(
        method=method, max_order=4, even_orders=(2, 4), atol=0.0, rtol=1e-12
    )
    return PhaseMatchingParams(config=cfg)


def make_model_params(
    *,
    waves: WavesParams,
    fiber: FiberParams,
    grid: SimulationGrid,
    phase_matching: Optional[PhaseMatchingParams] = None,
) -> ModelParams:
    pm = phase_matching if phase_matching is not None else make_default_phase_matching_params()
    cache = CacheParams(delta_beta_1_m=None, symmetric=waves.symmetric)
    return ModelParams(waves=waves, fiber=fiber, grid=grid, phase_matching=pm, cache=cache)


def with_phase_mismatch(
    params: ModelParams, delta_beta_1_m: float, symmetric: Optional[SymmetricPlan] = None
) -> ModelParams:
    """Functional alternative to ``params.cache.set_phase_mismatch``."""
    cache = CacheParams(
        delta_beta_1_m=to_scalar_float(delta_beta_1_m, name="delta_beta_1_m"),
        symmetric=symmetric,
    )
    return ModelParams(
        waves=params.waves,
        fiber=params.fiber,
        grid=params.grid,
        phase_matching=params.phase_matching,
        cache=cache,
    )


# ---------------------------------------------------------------------------
# Lowering: rich containers -> device coefficients (once per run)
# ---------------------------------------------------------------------------

def lower_params(params: ModelParams, *, precision: str = "x64", device=None) -> RHSCoeffs:
    """Extract (gamma, alpha, delta_beta) with the reference's priority rules
    (``yaman_model.py:59-116``): cached delta_beta, else legacy per-wave betas
    (dbeta = b3+b4-b1-b2).  Runs ONCE per solve, not once per RHS eval.
    ``device=None`` means the CUDA card.
    """
    fiber = params.fiber
    gamma = float(fiber.gamma_W_m)
    alpha = float(fiber.alpha_1_m)

    dbeta: Optional[float] = None
    if params.cache is not None and params.cache.delta_beta_1_m is not None:
        dbeta = float(params.cache.delta_beta_1_m)
    elif fiber.beta_legacy_1_m is not None:
        b = np.asarray(fiber.beta_legacy_1_m, dtype=float)
        dbeta = float((b[2] + b[3]) - (b[0] + b[1]))
    else:
        raise ValueError(
            "Phase mismatch dbeta is not available. Expected "
            "params.cache.delta_beta_1_m to be set (preferred), or "
            "fiber.beta_legacy_1_m for fallback."
        )

    rdt = real_dtype(validate_precision(precision))
    device = resolve_device(device)
    return RHSCoeffs(*(torch.tensor(v, dtype=rdt, device=device)
                       for v in (gamma, alpha, dbeta)))


def _default_phase_matching_cfg(
    *,
    dispersion: Optional[DispersionParams],
    beta_legacy: Optional[np.ndarray],
) -> PhaseMatchingConfig:
    """Default dbeta strategy (reference ``simulation.py:178-213``):
    dispersion -> SYMMETRIC_EVEN(2,4); legacy betas -> PROVIDED."""
    if dispersion is not None:
        return PhaseMatchingConfig(
            method=PhaseMatchingMethod.SYMMETRIC_EVEN,
            max_order=4,
            even_orders=(2, 4),
            atol=0.0,
            rtol=1e-12,
            provided_delta_beta=None,
        )
    if beta_legacy is not None:
        b = np.asarray(beta_legacy, dtype=float)
        if b.shape != (4,):
            raise ValueError("beta_legacy must have shape (4,)")
        db = float((b[2] + b[3]) - (b[0] + b[1]))
        return PhaseMatchingConfig(
            method=PhaseMatchingMethod.PROVIDED,
            max_order=0,
            even_orders=(2,),
            atol=0.0,
            rtol=1e-12,
            provided_delta_beta=db,
        )
    raise ValueError(
        "Provide either dispersion or beta_legacy (or an explicit phase_matching_cfg)."
    )


# ---------------------------------------------------------------------------
# Core single-run API (reference simulation.py:220-364)
# ---------------------------------------------------------------------------

def run_single_simulation(
    cfg: SimulationConfig,
    *,
    gamma: float,
    alpha: float,
    omega: Sequence[float],
    p_in: Sequence[float],
    phase_in: Optional[Sequence[float]] = None,
    dispersion: Optional[DispersionParams] = None,
    phase_matching_cfg: Optional[PhaseMatchingConfig] = None,
    beta_legacy: Optional[Sequence[float]] = None,
    length_unit: str = "m",
    return_length_unit: Optional[str] = None,
    frame: str = "lab",
    z0: float = 0.0,
    A_init: Optional[Sequence[complex]] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run a single scalar 4-wave FWM simulation; returns host arrays
    ``(z_out, A)`` with ``A`` complex128 of shape ``(N_saved, 4)``.

    Signature and unit semantics match the reference runner
    (``simulation.py:220-364``): ``cfg.z_max``/``cfg.dz``, ``gamma``,
    ``alpha``, dispersion coefficients, and a PROVIDED dbeta are interpreted
    per ``length_unit`` and converted to internal meters; ``return_length_unit``
    controls the output z unit.

    ``cfg.precision`` selects the dtype tier; ``frame='rotating'`` integrates
    the autonomous system and converts saved states back to the lab frame;
    ``z0``/``A_init`` resume from a saved (z, A) row over
    [z0, z0 + z_max] (z0 in ``length_unit``).  ``cfg.integrator='rk45'``
    integrates adaptively with ``cfg.rtol``/``atol``/``max_steps`` and
    returns the same decimated grid.  The trajectory is integrated on
    ``device`` (``None``: the CUDA card).
    """
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave runner")
    if frame not in VALID_FRAMES:
        raise ValueError(f"frame must be one of {VALID_FRAMES}, got {frame!r}")

    scale_to_m = length_scale_to_m(length_unit)

    om = _to_omega_array(omega)
    if A_init is not None:
        A0 = np.asarray(list(A_init), dtype=np.complex128)
        if A0.shape != (4,):
            raise ValueError(f"A_init must have shape (4,), got {A0.shape}")
        if not np.all(np.isfinite(A0)):
            raise ValueError("A_init must be finite")
    else:
        p = _to_power_array(p_in)
        A0 = make_initial_amplitudes(p, phase_in)
    z0_m = to_scalar_float(z0, name="z0") * scale_to_m

    beta_leg_m = None
    if beta_legacy is not None:
        b = np.asarray(list(beta_legacy), dtype=float)
        if b.shape != (4,):
            raise ValueError(f"beta_legacy must have shape (4,), got {b.shape}")
        if not np.all(np.isfinite(b)):
            raise ValueError("beta_legacy must be finite")
        beta_leg_m = b / scale_to_m

    disp_m = None
    if dispersion is not None:
        if not isinstance(dispersion, DispersionParams):
            raise TypeError("dispersion must be DispersionParams or None")
        disp_m = dispersion.scaled(scale_to_m)

    if phase_matching_cfg is not None:
        if not isinstance(phase_matching_cfg, PhaseMatchingConfig):
            raise TypeError("phase_matching_cfg must be PhaseMatchingConfig or None")
        # user-supplied PROVIDED dbeta is in 1/length_unit -> convert
        pm_cfg = phase_matching_cfg.scaled(scale_to_m)
    else:
        # built from already-converted per-meter inputs: NOT rescaled (the
        # reference double-scales here, simulation.py:305-312; not replicated)
        pm_cfg = _default_phase_matching_cfg(dispersion=disp_m, beta_legacy=beta_leg_m)

    fiber = FiberParams(
        length_m=float(cfg.z_max) * scale_to_m,
        gamma_W_m=float(gamma) / scale_to_m,
        alpha_1_m=float(alpha) / scale_to_m,
        dispersion=disp_m,
        beta_legacy_1_m=beta_leg_m,
    )
    waves = WavesParams(omega=om, symmetric=None)
    grid = SimulationGrid(dz_m=float(cfg.dz) * scale_to_m, z0_m=z0_m)
    params = make_model_params(
        waves=waves, fiber=fiber, grid=grid,
        phase_matching=PhaseMatchingParams(config=pm_cfg),
    )

    # Compute and cache dbeta once per run (reference simulation.py:338-346).
    res: PhaseMatchingResult = compute_phase_mismatch(
        params.waves.omega,
        params.fiber.dispersion,
        params.phase_matching.config,
        symmetric_hint=params.waves.symmetric,
    )
    params.cache.set_phase_mismatch(float(res.delta_beta), symmetric=res.symmetric)

    precision = validate_precision(cfg.precision)
    device = resolve_device(device)
    coeffs = lower_params(params, precision=precision, device=device)

    n_steps = int(round(params.fiber.length_m / params.grid.dz_m))

    if frame == "rotating" and z0_m != 0.0:
        # enter the rotating frame at z0 (A = B on sidebands; pumps rotated)
        db0 = float(params.cache.delta_beta_1_m)
        A0 = A0.copy()
        A0[:2] *= np.exp(-0.5j * db0 * z0_m)

    if cfg.integrator.lower() == "rk45":
        return run_adaptive_trajectory(
            cfg, params, coeffs, A0, frame=frame, length_unit=length_unit,
            return_length_unit=return_length_unit, z0_m=z0_m, device=device,
        )

    out = integrate_fixed_grid(
        rhs_yaman if frame == "lab" else rhs_yaman_autonomous,
        torch.as_tensor(A0, dtype=complex_dtype(precision), device=device),
        coeffs,
        z0=z0_m, dz=params.grid.dz_m, n_steps=n_steps,
        save_every=int(cfg.save_every), check_nan=bool(cfg.check_nan),
        method=cfg.integrator.lower(),
    )
    if cfg.check_nan and not bool(out.ok):
        bad = int(out.bad_step)
        raise FloatingPointError(
            f"NaN or Inf detected at step {bad}, "
            f"z = {z0_m + bad * params.grid.dz_m} m"
        )
    y_saved = out.y_saved
    if frame == "rotating":
        y_saved = rotating_to_lab(out.z_saved, y_saved, coeffs)
    y_saved = _host(y_saved.to(torch.complex128))

    # Output unit conversion (reference simulation.py:359-363); z is rebuilt
    # on the host in f64 so x32 runs still report exact grid locations.
    out_unit = length_unit if return_length_unit is None else return_length_unit
    out_scale = length_scale_to_m(out_unit)
    n_saved = y_saved.shape[0]
    z_m = z0_m + (np.arange(n_saved) * cfg.save_every) * params.grid.dz_m
    z_out = z_m / out_scale

    if cfg.verbose:
        P_out = np.abs(y_saved[-1]) ** 2
        print(
            f"[run_single_simulation] {n_steps} {cfg.integrator} steps ({frame} frame, "
            f"{cfg.precision}), dbeta = {params.cache.delta_beta_1_m:.6g} 1/m, "
            f"z_end = {z_out[-1]:.6g} {out_unit}, "
            f"P_out [W] = {np.array2string(P_out, precision=6)}"
        )

    return z_out, y_saved


# ---------------------------------------------------------------------------
# Example simulations (reference simulation.py:371-447)
# ---------------------------------------------------------------------------

def example_zero_signal(*, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Two pumps, zero signal/idler at input, dbeta forced to 0 (PROVIDED);
    on ``device`` (``None``: the CUDA card)."""
    from ..config import default_simulation_config
    from ..constants import c as c0

    cfg = default_simulation_config()
    omega0 = 2.0 * np.pi * c0 / 1.55e-6
    pm_cfg = PhaseMatchingConfig(
        method=PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.0
    )
    return run_single_simulation(
        cfg,
        gamma=1.3,  # 1/(W km)
        alpha=0.0,  # 1/km
        omega=np.full(4, omega0),
        p_in=np.array([0.5, 0.5, 0.0, 0.0]),
        phase_matching_cfg=pm_cfg,
        length_unit="km",
        return_length_unit="km",
        device=device,
    )


def custom_seeded_signal(*, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded signal/idler with dbeta specified explicitly (PROVIDED); on
    ``device`` (``None``: the CUDA card)."""
    from ..config import custom_simulation_config
    from ..constants import c as c0

    cfg = custom_simulation_config(z_max=0.5, dz=1e-4)
    omega0 = 2.0 * np.pi * c0 / 1.55e-6
    P1 = 1e-1
    pm_cfg = PhaseMatchingConfig(
        method=PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.0
    )
    return run_single_simulation(
        cfg,
        gamma=10.0,  # 1/(W km)
        alpha=0.0,
        omega=np.full(4, omega0),
        p_in=np.array([P1, P1, 1e-4, 1e-6]),
        phase_in=np.zeros(4),
        phase_matching_cfg=pm_cfg,
        length_unit="km",
        return_length_unit="km",
        device=device,
    )
