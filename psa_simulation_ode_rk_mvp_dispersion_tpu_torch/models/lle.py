"""Lugiato-Lefever equation (LLE): driven-damped Kerr-cavity combs.

Counterpart of the JAX package's ``models/lle.py``: the mean-field model of
a CW-pumped Kerr microresonator or fibre ring cavity in the standard
normalization (slow time ``t`` in photon lifetimes, fast time ``tau``
around the resonator; Coen & Erkintalo, Opt. Lett. 38, 1790 (2013)):

    dpsi/dt = -(1 + i Delta) psi + i |psi|^2 psi + i phi_d(omega) psi + F

with ``Delta`` the pump-resonance detuning, ``F`` the (complex) pump and
``phi_d(omega) = sum_{n>=2} d_n omega^n / n!`` the cavity dispersion in the
GNLSE family's ``lin_phase`` convention (``d2 < 0`` anomalous).

- The linear step is exact and affine: in the frequency domain
  ``dA/dt = Lam(omega) A + F`` with ``F`` constant in tau, so only the DC
  bin is driven and one step of length s is
  ``A <- ifft(e^{(-1 + i phi_d) s} fft(A)) e^{-i Delta s} + F (e^{Lam0 s} - 1)/Lam0``
  with ``Lam0 = -(1 + i Delta)``.  The Kerr substep is the exact rotation
  ``exp(i |psi|^2 s)`` (unit gamma).
- ``integrator='rk4'`` is the Strang split, ``'rk4ip'`` the
  interaction-picture RK4 with the drive in the nonlinear operator,
  ``'rk45'``/``'rk4ip45'`` their step-doubling adaptive versions over the
  GNLSE family's controller (``models/gnlse._advance_segment``).
- Save contract (as the GNLSE family's): each save chunk runs
  ``Lh, (K, Lf)^(k-1), K, Lh``; the trailing ``n_steps % save_every`` steps
  are integrated and feed only ``ok``; a lane whose chunk ends non-finite
  keeps its last good state and clears ``ok``.
- :func:`solve_lle_batch` and :func:`detuning_scan` run on a CUDA device
  through the hand-written kernels ``csrc/lle_ssfm.cu`` (Strang rk4,
  ``ops/cuda_lle.py``) and ``csrc/ssfm_rk45.cu``
  (its affine instantiation, rk45, ``ops/cuda_ssfm_adaptive.py``);
  :func:`lle_kernel_route` picks the route from the arguments.  The ramp,
  the trajectories, the single run and rk4ip/rk4ip45 have no kernel in
  either package and run plain torch on their device.
- ``precision='df32'`` is Strang only and runs in float64; ``device=None``
  means the CUDA card, and without one the solvers raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SimulationConfig, validate_config
from ..ops.integrators import rk4ip_step
from ..parallel.mesh import mesh_device, shard_batch
from ..parallel.sweep import VALID_ENGINES   # 'torch' is JAX's 'scan', 'cuda' its 'pallas'
from ..utils.checks import resolve_device
from ..utils.precision import (dtypes_for, require_f64_leaves, require_non_df32,
                               validate_precision)
from .fwm4 import _host
from .gnlse import (  # noqa: F401 -- TimeGrid is part of this module's API, as in JAX's
    TimeGrid,
    _finite_mask,
    _kerr_step,
    _lane_axis,
    _lfft,
    _scalar,
    _tensor,
    _times_i,
    adaptive_over_grid,
    fixed_over_grid,
)

# ---------------------------------------------------------------------------
# Coefficients
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LLECoeffs:
    """Normalized LLE coefficients (broadcastable over a leading B axis).

    ``detuning`` and the pump ``(pump_re, pump_im)`` are the scan axes
    (scalar or ``(B,)``); ``lin_phase`` is the dispersion-only phase rate
    ``phi_d(omega)`` on the fft-ordered grid (``(T,)`` or ``(B, T)``).  The
    detuning is kept apart so that a ramp is a scalar phase a step."""

    detuning: torch.Tensor   # () or (B,)
    pump_re: torch.Tensor    # () or (B,)
    pump_im: torch.Tensor    # () or (B,)
    lin_phase: torch.Tensor  # (T,) or (B, T)


def make_lle_coeffs(
    grid: TimeGrid,
    *,
    detuning,
    pump,
    d2: Optional[float] = None,
    dispersion_coeffs=None,
    precision: str = "x64",
    device=None,
) -> LLECoeffs:
    """Build :class:`LLECoeffs` on ``grid`` (one round trip of fast time in
    normalized units), as tensors of ``precision``'s real dtype (``df32``:
    float64) on ``device`` (``None``: the host).

    ``detuning`` and ``pump`` (real or complex) are scalars or ``(B,)``.
    Dispersion: a bare ``d2`` or ``dispersion_coeffs`` ``[d2, d3, ...]``
    from order 2, combined as ``phi_d = sum d_n omega^n / n!``."""
    rdt, _ = dtypes_for(precision)
    om = grid.omega()
    phase = np.zeros_like(om)
    if d2 is not None and dispersion_coeffs is not None:
        raise ValueError("pass d2 OR dispersion_coeffs, not both")
    if d2 is not None:
        dispersion_coeffs = [float(d2)]
    if dispersion_coeffs is not None:
        for n, dn in enumerate(np.asarray(dispersion_coeffs, dtype=float), start=2):
            phase = phase + (dn / math.factorial(n)) * om ** n
    if not np.all(np.isfinite(phase)):
        raise ValueError("dispersion phase must be finite on the grid")
    det = np.asarray(detuning, dtype=np.float64)
    F = np.asarray(pump, dtype=np.complex128)
    if det.ndim > 1 or F.ndim > 1:
        raise ValueError("detuning/pump must be scalar or (B,)")
    return LLECoeffs(detuning=_tensor(det, rdt, device), pump_re=_tensor(F.real, rdt, device),
                     pump_im=_tensor(F.imag, rdt, device), lin_phase=_tensor(phase, rdt, device))


# ---------------------------------------------------------------------------
# Analytic CW solutions, seeds and the physical normalization (host numpy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LLENormalization:
    """Normalized LLE parameters and the unit scales that map the solution
    back to a physical fibre-ring / microresonator cavity (host float64):
    slow time in photon lifetimes ``t_R/alpha``, fast time in
    ``sqrt(|beta2| L / alpha)``, field in ``sqrt(alpha / (gamma L))``,
    ``Delta = delta0/alpha``, ``F = sqrt(gamma L theta P_in / alpha^3)``,
    ``d2 = sign(beta2)`` (Leo et al., Nat. Photon. 4, 471 (2010))."""

    detuning: float           # Delta = delta0 / alpha
    pump: float               # F = sqrt(gamma L theta P_in / alpha^3)
    d2: float                 # sign(beta2): -1 anomalous, +1 normal
    photon_lifetime_s: float  # t_R / alpha (one unit of slow time)
    tau_scale_s: float        # sqrt(|beta2| L / alpha) (one unit of tau)
    field_scale_sqrtW: float  # sqrt(alpha / (gamma L)): E = psi * this


def normalize_ring_cavity(
    *,
    round_trip_length_m: float,
    t_roundtrip_s: float,
    gamma_W_m: float,
    beta2_s2_m: float,
    alpha_half_loss: float,
    coupling_theta: float,
    detuning_phase_rad: float,
    pump_power_W: float,
) -> LLENormalization:
    """Physical ring-cavity parameters -> :class:`LLENormalization`.

    ``alpha_half_loss`` is half the round-trip power loss including the
    coupler, ``coupling_theta`` the coupler's power transmission,
    ``detuning_phase_rad`` the round-trip phase detuning ``delta0``."""
    L = float(round_trip_length_m)
    a = float(alpha_half_loss)
    g = float(gamma_W_m)
    b2 = float(beta2_s2_m)
    th = float(coupling_theta)
    for name, v in (("round_trip_length_m", L), ("t_roundtrip_s", float(t_roundtrip_s)),
                    ("gamma_W_m", g), ("alpha_half_loss", a), ("coupling_theta", th)):
        if not (v > 0.0 and np.isfinite(v)):
            raise ValueError(f"{name} must be positive and finite")
    if b2 == 0.0:
        raise ValueError("beta2_s2_m must be nonzero (sets the tau scale)")
    if float(pump_power_W) < 0.0:
        raise ValueError("pump_power_W must be >= 0")
    return LLENormalization(
        detuning=float(detuning_phase_rad) / a,
        pump=float(np.sqrt(g * L * th * float(pump_power_W) / a ** 3)),
        d2=float(np.sign(b2)),
        photon_lifetime_s=float(t_roundtrip_s) / a,
        tau_scale_s=float(np.sqrt(abs(b2) * L / a)),
        field_scale_sqrtW=float(np.sqrt(a / (g * L))),
    )


def cw_steady_states(detuning: float, pump: float) -> np.ndarray:
    """Intracavity powers ``rho = |psi_s|^2`` of the homogeneous steady
    states: the real roots of ``rho^3 - 2 Delta rho^2 + (1 + Delta^2) rho
    = F^2`` (1 or 3; bistable for ``Delta > sqrt(3)``)."""
    d, f2 = float(detuning), float(pump) ** 2
    r = np.roots([1.0, -2.0 * d, 1.0 + d * d, -f2])
    r = r[np.abs(r.imag) < 1e-9 * np.maximum(1.0, np.abs(r.real))].real
    return np.sort(r[r >= 0.0])


def cw_state(detuning: float, pump: float, rho: float) -> complex:
    """The CW field ``psi_s = F / (1 + i (Delta - rho))`` on the branch of
    power ``rho`` (a root of :func:`cw_steady_states`)."""
    return complex(pump) / (1.0 + 1j * (float(detuning) - float(rho)))


def soliton_ansatz(grid: TimeGrid, detuning: float, pump: float, d2: float, *,
                   t0: float = 0.0) -> np.ndarray:
    """Bright dissipative-soliton seed for ``Delta >> 1`` (``d2 < 0``): the
    lower CW branch plus ``sqrt(2 Delta) sech(sqrt(2 Delta / |d2|) (tau -
    t0)) e^{i phi0}``, ``cos phi0 = sqrt(8 Delta) / (pi F)`` (Herr et al.,
    Nat. Photon. 8, 145 (2014)).  A seed, not an exact solution."""
    if d2 >= 0:
        raise ValueError("bright solitons need anomalous dispersion (d2 < 0)")
    rho = cw_steady_states(detuning, pump)[0]
    psi0 = cw_state(detuning, pump, rho)
    arg = np.sqrt(8.0 * detuning) / (np.pi * pump)
    if not (0.0 < arg <= 1.0):
        raise ValueError(f"no soliton at detuning={detuning}, pump={pump}: "
                         f"cos(phi0) = {arg:.3f} outside (0, 1]")
    phi0 = np.arccos(arg)
    sech = 1.0 / np.cosh(np.sqrt(2.0 * detuning / abs(d2)) * (grid.t() - t0))
    return psi0 + np.sqrt(2.0 * detuning) * sech * np.exp(1j * phi0)


def mi_gain_peak(detuning: float, rho: float) -> Tuple[float, float]:
    """Modulation-instability peak of a CW state of power ``rho``:
    ``(growth rate rho - 1, phi_d at the resonant sideband 2 rho - Delta)``."""
    return float(rho) - 1.0, 2.0 * float(rho) - float(detuning)


def comb_spectrum(psi: np.ndarray) -> np.ndarray:
    """Comb line powers ``|fft(psi)|^2 / T^2`` (line 0 = pump; fft order)."""
    psi = np.asarray(psi)
    return np.abs(np.fft.fft(psi, axis=-1) / psi.shape[-1]) ** 2


# ---------------------------------------------------------------------------
# Steppers, in the JAX scan's order of operations
# ---------------------------------------------------------------------------

def _lle_lin_factor(lin_phase: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Dispersion and loss over a step h: ``exp((-1 + i phi_d) h)`` (the
    detuning is applied as a scalar phase)."""
    decay = torch.exp(-h)
    ang = lin_phase * h
    return torch.complex(decay * torch.cos(ang), decay * torch.sin(ang))


def _det_phase(det: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The detuning rotation ``exp(-i Delta h)``."""
    ang = -det * h
    return torch.complex(torch.cos(ang), torch.sin(ang))


def _drive_offset(det: torch.Tensor, F: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The exact drive term ``F (e^{Lam0 h} - 1) / Lam0``, ``Lam0 = -(1 + i
    Delta)``: the DC bin's response to the linear step."""
    lam0 = torch.complex(-torch.ones_like(det), -det)
    return F * (torch.exp(lam0 * h) - 1.0) / lam0


def _chunk_strang(k: int, y, Lh, dp_h, dF_h, Lf, dp_f, dF_f, h):
    """k fused Strang steps ``Lh, (K, Lf)^(k-1), K, Lh``: two half-step
    affine maps compose exactly into the full-step one when ``phi_d(0) =
    0`` (the drive lives in the DC bin), so ``Lf`` is built directly for h."""
    if k == 0:
        return y
    y = _lfft(Lh, y) * dp_h + dF_h
    for _ in range(k - 1):
        y = _lfft(Lf, _kerr_step(y, 1.0, h)) * dp_f + dF_f
    return _lfft(Lh, _kerr_step(y, 1.0, h)) * dp_h + dF_h


def _kerr_drive(F):
    """The nonlinear operator of the interaction picture, ``N(a) = i|a|^2 a
    + F`` (the drive rides with Kerr; Hult 2007)."""
    def N(a):
        P = a.real * a.real + a.imag * a.imag
        return _times_i(P * a) + F
    return N


def _chunk_rk4ip(k: int, y, Lh, dp_h, F, h):
    """k RK4IP steps: the frame absorbs dispersion, loss and detuning."""
    N = _kerr_drive(F)
    for _ in range(k):
        y = rk4ip_step(lambda a: _lfft(Lh, a) * dp_h, N, y, h)
    return y


def lle_fixed(y0, detuning, pump, lin_phase, *, dt: float, n_steps: int, save_every: int,
              method: str = "strang", keep_rows: bool = False):
    """The fixed-step batched LLE over a ``(B, T)`` complex state
    (``_lle_solver`` of the JAX package): ``detuning`` ``(B,)`` real,
    ``pump`` ``(B,)`` complex, ``lin_phase`` ``(T,)`` or ``(B, T)``, of
    ``y0``'s dtypes on its device.  Returns ``models/gnlse.fixed_over_grid``'s
    ``(rows, peak_max, y_last, ok)``."""
    h = _scalar(dt, y0)
    det, F = detuning[:, None], pump[:, None]
    Lh = _lle_lin_factor(lin_phase, 0.5 * h)
    dp_h, dF_h = _det_phase(det, 0.5 * h), _drive_offset(det, F, 0.5 * h)
    if method == "rk4ip":
        def chunk(k, y):
            return _chunk_rk4ip(k, y, Lh, dp_h, F, h)
    else:
        Lf = _lle_lin_factor(lin_phase, h)
        dp_f, dF_f = _det_phase(det, h), _drive_offset(det, F, h)

        def chunk(k, y):
            return _chunk_strang(k, y, Lh, dp_h, dF_h, Lf, dp_f, dF_f, h)
    return fixed_over_grid(y0, chunk, n_steps=n_steps, save_every=save_every,
                           keep_rows=keep_rows)


def lle_ramp(y0, pump, lin_phase, *, dt: float, n_steps: int, save_every: int,
             det_start: float, det_step: float, step0: int):
    """Detuning-ramp Strang evolution (``_lle_ramp_solver`` of the JAX
    package): step j of the schedule runs at ``det_start + det_step j``, j
    the global step index from ``step0``, so a resumed ramp is bitwise the
    uninterrupted one.  A lane that turns non-finite freezes at once.
    Returns ``(rows, ok)``; the trailing ``n_steps % save_every`` steps are
    integrated and feed only ``ok``."""
    h = _scalar(dt, y0)
    half = 0.5 * h
    F = pump[:, None]
    Lh = _lle_lin_factor(lin_phase, half)
    d0, ds = _scalar(det_start, y0), _scalar(det_step, y0)
    y, ok, rows = y0, _finite_mask(y0), [y0]

    def advance(y, ok, j0, k):
        for j in range(j0, j0 + k):
            det = d0 + ds * _scalar(j, y0)
            dp, dF = _det_phase(det, half), _drive_offset(det, F, half)
            y_new = _lfft(Lh, _kerr_step(_lfft(Lh, y) * dp + dF, 1.0, h)) * dp + dF
            ok = ok & _finite_mask(y_new)
            y = torch.where(ok[:, None], y_new, y)
        return y, ok

    n_chunks, remainder = divmod(int(n_steps), int(save_every))
    for c in range(n_chunks):
        y, ok = advance(y, ok, step0 + c * save_every, save_every)
        rows.append(y)
    if remainder > 0:
        y, ok = advance(y, ok, step0 + n_chunks * save_every, remainder)
    return rows, ok


# ---------------------------------------------------------------------------
# Adaptive split-step (integrator='rk45'/'rk4ip45'): step doubling
# ---------------------------------------------------------------------------

def _lle_doubling_attempt(y, ph, det, F, hb):
    """One step-doubling attempt on the Strang step: (coarse h, two fused
    fine h/2).  One factor build (the half-step factor and detuning phase
    are the quarter-step ones squared), the drive offsets computed for h/4
    and h/2 directly, one forward transform shared: 9 transforms."""
    half = 0.5 * hb
    quarter = 0.25 * hb
    decay_q = torch.exp(-quarter)
    ang_q = ph * quarter
    Lq = torch.complex(decay_q * torch.cos(ang_q), decay_q * torch.sin(ang_q))
    Lh = Lq * Lq
    dp_q = _det_phase(det, quarter)
    dp_h = dp_q * dp_q
    dF_q, dF_h = _drive_offset(det, F, quarter), _drive_offset(det, F, half)
    fy = torch.fft.fft(y, dim=-1)

    def aff_h(S):
        return torch.fft.ifft(Lh * S, dim=-1) * dp_h + dF_h

    def aff_q(S):
        return torch.fft.ifft(Lq * S, dim=-1) * dp_q + dF_q

    yc = aff_h(torch.fft.fft(_kerr_step(aff_h(fy), 1.0, hb), dim=-1))
    yf = _kerr_step(aff_q(fy), 1.0, half)
    yf = _kerr_step(aff_h(torch.fft.fft(yf, dim=-1)), 1.0, half)
    return yc, aff_q(torch.fft.fft(yf, dim=-1))


def _lle_doubling_attempt_rk4ip(y, ph, det, F, hb):
    """Step-doubling attempt on the RK4IP step (``integrator='rk4ip45'``):
    the frame absorbs dispersion, loss and detuning, ``N`` carries the
    drive; local error O(h^5), so the controller runs with order 4."""
    half = 0.5 * hb
    quarter = 0.25 * hb
    ang_q = (ph - det) * quarter
    decay_q = torch.exp(-quarter)
    Lq = torch.complex(decay_q * torch.cos(ang_q), decay_q * torch.sin(ang_q))
    Lh = Lq * Lq
    N = _kerr_drive(F)
    Ny = N(y)
    yc = rk4ip_step(lambda a: _lfft(Lh, a), N, y, hb, Ny)
    yf = rk4ip_step(lambda a: _lfft(Lq, a), N, y, half, Ny)
    return yc, rk4ip_step(lambda a: _lfft(Lq, a), N, yf, half, N(yf))


# (attempt, method order p) per adaptive scheme
_ADAPTIVE_ATTEMPTS = {"strang": (_lle_doubling_attempt, 2),
                      "rk4ip": (_lle_doubling_attempt_rk4ip, 4)}


def lle_adaptive(y0, detuning, pump, lin_phase, *, dt: float, n_steps: int, save_every: int,
                 rtol: float, atol: float, max_steps: int, method: str = "strang",
                 keep_rows: bool = False):
    """The adaptive batched LLE over the save grid (``_lle_adaptive_solver``
    of the JAX package), from ``dt0 = dt``.  Inputs as :func:`lle_fixed`;
    returns ``models/gnlse.adaptive_over_grid``'s ``(rows, peak_max, y_last,
    ok, n_accepted, n_rejected)``."""
    attempt_fn, order = _ADAPTIVE_ATTEMPTS[method]
    det, F = detuning[:, None], pump[:, None]
    return adaptive_over_grid(
        y0, lambda y, hb: attempt_fn(y, lin_phase, det, F, hb), order, dz_m=dt,
        n_steps=n_steps, save_every=save_every, rtol=rtol, atol=atol, max_steps=max_steps,
        keep_rows=keep_rows)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

_METHODS = {"rk4": "strang", "rk4ip": "rk4ip", "rk45": "rk45", "rk4ip45": "rk4ip45"}


def _lle_method(cfg: SimulationConfig) -> str:
    integ = cfg.integrator.lower()
    if integ not in _METHODS:
        raise ValueError(
            f"integrator={cfg.integrator!r} is not supported by the LLE solvers; use 'rk4' "
            "(Strang split, exact affine drive), 'rk4ip' (interaction-picture RK4), 'rk45' "
            "(adaptive step-doubling Strang) or 'rk4ip45' (adaptive step-doubling RK4IP)")
    return _METHODS[integ]


def _adaptive_family(method: str) -> str:
    """'rk45' doubles Strang steps, 'rk4ip45' RK4IP steps."""
    return "rk4ip" if method == "rk4ip45" else "strang"


def _check_df32(coeffs: LLECoeffs, method: str) -> None:
    """The df32 tier is Strang only and needs float64 coefficients (built
    with ``make_lle_coeffs(precision='df32')``); anything else raises, as in
    the JAX package."""
    if method != "strang":
        raise ValueError("precision='df32' LLE solves are fixed-step Strang (integrator='rk4') "
                         "only (use x32/x64 for rk4ip/rk45/rk4ip45)")
    require_f64_leaves("LLE df32", **{f.name: getattr(coeffs, f.name)
                                      for f in dataclasses.fields(coeffs)})


def _setup(cfg: SimulationConfig, coeffs: LLECoeffs):
    """``(method, precision, dt, n_steps)`` of a solve, validated."""
    validate_config(cfg)
    method = _lle_method(cfg)
    precision = validate_precision(cfg.precision)
    if precision == "df32":
        _check_df32(coeffs, method)
    dt = float(cfg.dz)
    return method, precision, dt, int(round(float(cfg.z_max) / dt))


def _state(psi0, ndim: int, cdt: torch.dtype, device: torch.device) -> torch.Tensor:
    if not isinstance(psi0, torch.Tensor):
        psi0 = torch.from_numpy(np.array(psi0, dtype=np.complex128))
    if psi0.ndim != ndim:
        want = "a 1-D field (T,)" if ndim == 1 else "shape (B, T)"
        raise ValueError(f"psi0 must be {want}, got {tuple(psi0.shape)}")
    return psi0.to(device=device, dtype=cdt)


def lane_coeffs(coeffs: LLECoeffs, B: int, T: int, rdt: torch.dtype, device):
    """``(detuning (B,), pump (B,) complex, lin_phase (T,) or (B, T))`` of
    ``rdt`` on ``device``; a shared ``(T,)`` phase stays shared."""
    det = _tensor(coeffs.detuning, rdt, device).broadcast_to((B,)).contiguous()
    F = torch.complex(_tensor(coeffs.pump_re, rdt, device),
                      _tensor(coeffs.pump_im, rdt, device)).broadcast_to((B,)).contiguous()
    ph = _tensor(coeffs.lin_phase, rdt, device)
    if ph.shape[-1] != T:
        raise ValueError(f"lin_phase must have {T} samples, got shape {tuple(ph.shape)}")
    return det, F, (ph if ph.ndim == 1 else ph.broadcast_to((B, T)).contiguous())


def _saved_t(t0: float, n_steps: int, save_every: int, dt: float) -> np.ndarray:
    return t0 + np.arange(n_steps // save_every + 1, dtype=np.float64) * (save_every * dt)


def _trajectories(cfg, method, dt, n_steps, y0, lanes):
    """Trajectory solve of a ``(B, T)`` state: ``(rows (B, S+1, T), ok)``."""
    kw = dict(dt=dt, n_steps=n_steps, save_every=int(cfg.save_every), keep_rows=True)
    if method in ("rk45", "rk4ip45"):
        rows, _pk, _y, ok, _na, _nr = lle_adaptive(
            y0, *lanes, rtol=float(cfg.rtol), atol=float(cfg.atol),
            max_steps=int(cfg.max_steps), method=_adaptive_family(method), **kw)
    else:
        rows, _pk, _y, ok = lle_fixed(y0, *lanes, method=method, **kw)
    return torch.stack(rows, dim=1), ok


def run_lle_simulation(
    cfg: SimulationConfig,
    coeffs: LLECoeffs,
    psi0,
    *,
    t0: float = 0.0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Evolve one intracavity field over ``[t0, t0 + z_max]`` photon
    lifetimes (``cfg.dz`` the slow-time step, ``cfg.save_every`` the
    decimation); returns host ``(t_saved, psi_saved (S+1, T))``.

    The fixed-detuning LLE is autonomous, so ``t0`` only offsets the
    returned grid: pass the last saved row as ``psi0`` and its time as
    ``t0`` to resume (bitwise on the fixed-step methods; a ramp resumes
    through :func:`run_lle_ramp`).  Raises ``FloatingPointError`` on
    NaN/Inf (or, adaptive, a step-size underflow) when ``cfg.check_nan``.
    Plain torch on ``device`` (``None``: the CUDA card)."""
    method, precision, dt, n_steps = _setup(cfg, coeffs)
    t0 = float(t0)
    if not np.isfinite(t0):
        raise ValueError("t0 must be finite")
    device = resolve_device(device)
    rdt, cdt = dtypes_for(precision)
    y0 = _state(psi0, 1, cdt, device)[None]
    rows, ok = _trajectories(cfg, method, dt, n_steps, y0,
                             lane_coeffs(coeffs, 1, y0.shape[1], rdt, device))
    if cfg.check_nan and not bool(ok[0]):
        if method in ("rk45", "rk4ip45"):
            raise FloatingPointError(
                "NaN/Inf or step-size underflow during adaptive (rk45) LLE evolution")
        raise FloatingPointError("NaN or Inf detected during LLE evolution")
    return (_saved_t(t0, n_steps, int(cfg.save_every), dt),
            _host(rows[0].to(torch.complex128)))


def lle_kernel_route(integrator: str, T: int, rdt: torch.dtype, device: torch.device,
                     engine: str) -> Optional[str]:
    """Which kernel :func:`solve_lle_batch` launches: ``'lle_ssfm'`` (K7,
    Strang rk4 at any precision), ``'ssfm_rk45_lle'`` (K8's LLE route, rk45)
    or ``None`` (the plain torch version), decided from the arguments
    before any launch.  ``engine='cuda'`` raises for a call the kernels do
    not take (rk4ip, rk4ip45, a width they refuse)."""
    from ..ops import cuda_gnlse   # it imports the models

    if device.type != "cuda" or engine == "torch":
        return None
    if integrator == "rk4":
        why, name = cuda_gnlse.width_problem("lle_ssfm", T, rdt, device), "lle_ssfm"
    elif integrator == "rk45":
        why, name = cuda_gnlse.width_problem("ssfm_rk45", T, rdt, device), "ssfm_rk45_lle"
    else:
        why, name = ("engine='cuda' LLE kernel implements the fixed-step Strang split "
                     "(integrator='rk4') and the adaptive integrator='rk45' only"), None
    if why is None:
        return name
    if engine == "cuda":
        raise ValueError(why)
    return None


def solve_lle_batch(
    cfg: SimulationConfig,
    coeffs: LLECoeffs,
    psi0,
    *,
    mesh=None,
    engine: str = "auto",
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Evolve B cavities in one batched solve (reduce mode): returns host
    ``(peak_max (B,), psi_last (B, T), ok (B,))``, the running max over
    saved samples of max_tau |psi|^2 and the field at the last saved point:
    the detuning/pump scan engine.

    ``engine`` (the JAX package's 'scan' is 'torch' here, its 'pallas' is
    'cuda'):

    - ``'auto'``: on a CUDA device, Strang ``rk4`` runs the kernel
      ``csrc/lle_ssfm.cu`` (fp64 for ``x64``/``df32``, fp32 for ``x32``)
      and ``rk45`` the kernel ``csrc/ssfm_rk45.cu`` (affine), each
      for T a multiple of 128 up to 2,048 whose block fits in shared
      memory; ``rk4ip``/``rk4ip45`` and other widths run the plain torch
      version.  On any other device the plain versions run.
    - ``'torch'``: the plain torch versions on ``device``.
    - ``'cuda'``: the kernels; a call they do not take raises.

    ``df32`` is Strang rk4 only and runs in float64; ``device=None`` means
    the CUDA card.  ``mesh`` (``parallel/mesh.Mesh``) splits the cavities
    over its slots, one launch a slot, as
    :func:`~..parallel.sweep.solve_batch` does (a shared phase row put on
    each device once); ``device`` is then None or one the mesh uses."""
    from ..ops import cuda_lle, cuda_ssfm_adaptive   # they import this module

    method, precision, dt, n_steps = _setup(cfg, coeffs)
    if engine not in VALID_ENGINES:
        raise ValueError(f"engine must be one of {VALID_ENGINES}, got {engine!r}")
    device = mesh_device(mesh, device)
    if engine == "cuda" and device.type != "cuda":
        raise ValueError(f"engine='cuda' needs a CUDA device, got {device}")
    rdt, cdt = dtypes_for(precision)
    y0 = _state(psi0, 2, cdt, device)
    B, T = y0.shape
    det, F, phase = lane_coeffs(coeffs, B, T, rdt, device)
    kw = dict(dt=dt, n_steps=n_steps, save_every=int(cfg.save_every))
    if method in ("rk45", "rk4ip45"):
        kw.update(rtol=float(cfg.rtol), atol=float(cfg.atol), max_steps=int(cfg.max_steps))

    def solve(dev, y0, det, F, phase):
        route = lle_kernel_route(cfg.integrator.lower(), T, rdt, dev, engine)
        if route == "ssfm_rk45_lle":
            r = cuda_ssfm_adaptive.solve_lle_batch_rk45_cuda(y0, det, F, phase, **kw)
        elif method in ("rk45", "rk4ip45"):
            r = cuda_ssfm_adaptive.solve_lle_batch_rk45_torch(
                y0, det, F, phase, method=_adaptive_family(method), **kw)
        elif route == "lle_ssfm":
            r = cuda_lle.solve_lle_batch_cuda(y0, det, F, phase, **kw)
        else:
            r = cuda_lle.solve_lle_batch_torch(y0, det, F, phase, method=method, **kw)
        return r.peak_max.to(torch.float64), r.A_end.to(torch.complex128), r.ok

    args = (y0, det, F, phase)
    if mesh is None:
        return tuple(_host(t) for t in solve(device, *args))
    return shard_batch(mesh, solve, args, in_axes=(0, 0, 0, _lane_axis(phase)))


def solve_lle_batch_trajectories(
    cfg: SimulationConfig,
    coeffs: LLECoeffs,
    psi0,
    *,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched evolution returning the decimated trajectories ``(t (S+1,),
    psi (B, S+1, T), ok (B,))`` as host arrays.  Plain torch on ``device``
    (``None``: the CUDA card)."""
    method, precision, dt, n_steps = _setup(cfg, coeffs)
    device = resolve_device(device)
    rdt, cdt = dtypes_for(precision)
    y0 = _state(psi0, 2, cdt, device)
    B, T = y0.shape
    rows, ok = _trajectories(cfg, method, dt, n_steps, y0, lane_coeffs(coeffs, B, T, rdt, device))
    return (_saved_t(0.0, n_steps, int(cfg.save_every), dt), _host(rows.to(torch.complex128)),
            _host(ok))


def run_lle_ramp(
    cfg: SimulationConfig,
    coeffs: LLECoeffs,
    psi0,
    *,
    detuning_start: float,
    detuning_end: float,
    t0: float = 0.0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The laser-scan protocol: evolve with the detuning ramped linearly
    from ``detuning_start`` to ``detuning_end`` over ``cfg.z_max`` lifetimes
    (``coeffs.detuning`` is ignored).  Returns ``(t_saved, detuning_saved,
    psi_saved (S+1, T))``.

    Resume: keep the whole ramp (same ``z_max`` and endpoints) and pass the
    saved time as ``t0`` and the field saved there as ``psi0``; the
    per-step detunings come from the global step index, so the resumed rows
    are bitwise those of the uninterrupted run when ``t0`` is on a save
    boundary.  Strang (``integrator='rk4'``) only; ``df32`` raises, as in
    the JAX package.  Plain torch on ``device`` (``None``: the CUDA card)."""
    validate_config(cfg)
    if cfg.integrator.lower() != "rk4":
        raise ValueError("the LLE ramp protocol is integrator='rk4' only")
    rdt, cdt = dtypes_for(require_non_df32(cfg.precision, family="LLE ramp"))
    dt = float(cfg.dz)
    n_total = int(round(float(cfg.z_max) / dt))
    t0 = float(t0)
    step0 = int(round(t0 / dt)) if np.isfinite(t0) else -1
    if not 0 <= step0 <= n_total:
        raise ValueError(f"t0={t0} must lie inside the ramp [0, z_max={cfg.z_max}]")
    device = resolve_device(device)
    y0 = _state(psi0, 1, cdt, device)[None]
    n_steps = n_total - step0
    det_step = (float(detuning_end) - float(detuning_start)) / max(n_total, 1)
    _det, F, ph = lane_coeffs(coeffs, 1, y0.shape[1], rdt, device)
    rows, ok = lle_ramp(y0, F, ph, dt=dt, n_steps=n_steps, save_every=int(cfg.save_every),
                        det_start=float(detuning_start), det_step=det_step, step0=step0)
    if cfg.check_nan and not bool(ok[0]):
        raise FloatingPointError("NaN or Inf detected during LLE ramp")
    steps = step0 + np.arange(n_steps // int(cfg.save_every) + 1, dtype=np.float64) * int(
        cfg.save_every)
    return (steps * dt, float(detuning_start) + det_step * steps,
            _host(torch.cat(rows).to(torch.complex128)))


def detuning_scan(
    cfg: SimulationConfig,
    grid: TimeGrid,
    *,
    detunings,
    pump: float,
    d2: float,
    psi0=None,
    seed: Optional[int] = 0,
    noise_amplitude: float = 1e-3,
    mesh=None,
    precision: Optional[str] = None,
    engine: str = "auto",
    device=None,
):
    """Batched steady-state scan over a detuning grid at fixed pump: each
    lane evolves for ``cfg.z_max`` lifetimes from ``psi0`` (default: the
    lower CW branch plus complex noise from ``np.random.default_rng(seed)``,
    as in the JAX package).  Returns ``(detunings, mean_power (B,),
    peak_power (B,), psi_last (B, T), ok (B,))``.  ``precision`` overrides
    ``cfg.precision`` for the coefficients and the dispatch alike."""
    det = np.asarray(list(detunings), dtype=float)
    if det.ndim != 1 or det.size == 0:
        raise ValueError("detunings must be a non-empty 1-D grid")
    if precision is not None:
        cfg = dataclasses.replace(cfg, precision=precision)
    coeffs = make_lle_coeffs(grid, detuning=det, pump=pump, d2=d2, precision=cfg.precision)
    if psi0 is None:
        rho = np.array([cw_steady_states(d, pump)[0] for d in det])
        base = np.array([cw_state(d, pump, r) for d, r in zip(det, rho)])
        rng = np.random.default_rng(seed)
        T = int(grid.n_samples)
        noise = noise_amplitude * (rng.standard_normal((det.size, T))
                                   + 1j * rng.standard_normal((det.size, T)))
        psi0 = base[:, None] + noise
    pk, psi_last, ok = solve_lle_batch(cfg, coeffs, psi0, mesh=mesh, engine=engine,
                                       device=device)
    return det, np.mean(np.abs(psi_last) ** 2, axis=-1), pk, psi_last, ok
