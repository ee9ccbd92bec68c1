"""Generalized nonlinear Schrödinger (GNLSE) pulse-propagation model.

Counterpart of the JAX package's ``models/gnlse.py``: full field envelopes
``A(z, t)`` on a periodic time window, Taylor dispersion to any order, Kerr
self-phase modulation and loss in the co-moving frame

    dA/dz = -alpha/2 A - sum_{n>=2} beta_n (i^{n-1}/n!) d^n A/dt^n
            + i gamma |A|^2 A,

optionally generalized (:func:`make_nl_terms`) with the delayed Raman
response and self-steepening

    + i gamma (1 + (i/omega_0) d/dt) [ A ((1 - f_R)|A|^2 + f_R (h_R * |A|^2)) ].

The solver is the symmetric (Strang) split-step Fourier method: the linear
operator ``L(omega) = -alpha/2 + i sum beta_n omega^n / n!`` is diagonal in
the frequency domain (``omega = 2 pi fftfreq``, ``A_tilde = fft(A)``), the
Kerr operator is a phase rotation in the time domain.  ``integrator='rk4ip'``
is the interaction-picture RK4, ``'rk45'``/``'rk4ip45'`` the step-doubling
adaptive versions of the two.

- Each save chunk runs ``Lh, (NL, Lf)^(k-1), NL, Lh``; samples are row 0 and
  every ``save_every``-th step; the trailing ``n_steps % save_every`` steps
  are integrated but feed only ``ok``; a lane whose chunk ends non-finite
  keeps its last good state and clears ``ok``.
- Parameter objects are built on the host when no device is given
  (:func:`make_gnlse_coeffs`, :func:`make_nl_terms`), as the JAX package
  builds them with numpy.
- :func:`solve_gnlse_batch` runs on a CUDA device through the hand-written
  kernels ``csrc/gnlse_ssfm.cu`` (Strang rk4, ``ops/cuda_gnlse.py``) and
  ``csrc/ssfm_rk45.cu`` (Strang rk45, Kerr, flat loss,
  ``ops/cuda_ssfm_adaptive.py``); elsewhere, with ``engine='torch'``, or for
  a call the kernels do not take under ``engine='auto'``, the plain torch
  versions run.
- :func:`run_gnlse_simulation` and :func:`solve_gnlse_batch_trajectories`
  have no kernel in either package and run plain torch on their device.
- ``device=None`` means the CUDA card; without one the solvers raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SimulationConfig, reject_multistep, validate_config
from ..ops.dispersion import DispersionParams
from ..ops.integrators import rk4ip_step
from ..parallel.sweep import VALID_ENGINES   # 'torch' is JAX's 'scan', 'cuda' its 'pallas'
from ..utils.checks import resolve_device
from ..utils.precision import dtypes_for, real_dtype, validate_precision
from ..utils.units import length_scale_to_m
from .fwm4 import _host


# ---------------------------------------------------------------------------
# Grids and parameters
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TimeGrid:
    """Uniform periodic time window: ``n_samples`` points spanning
    ``t_window_s`` seconds (centered on t=0)."""

    n_samples: int
    t_window_s: float

    def __post_init__(self):
        if self.n_samples < 2:
            raise ValueError("n_samples must be >= 2")
        if not (self.t_window_s > 0.0 and np.isfinite(self.t_window_s)):
            raise ValueError("t_window_s must be positive and finite")

    @property
    def dt_s(self) -> float:
        return float(self.t_window_s) / int(self.n_samples)

    def t(self) -> np.ndarray:
        """Sample times [s], centered: t_k = (k - n//2) dt."""
        n = int(self.n_samples)
        return (np.arange(n) - n // 2) * self.dt_s

    def omega(self) -> np.ndarray:
        """Angular baseband frequencies [rad/s], fft-ordered."""
        return 2.0 * np.pi * np.fft.fftfreq(int(self.n_samples), d=self.dt_s)

    @classmethod
    def for_pulse(cls, t0_s: float, *, n_samples: int = 1024,
                  window_t0: float = 40.0) -> "TimeGrid":
        """Window sized to a pulse of duration ``t0_s`` (default 40 T0)."""
        return cls(n_samples=int(n_samples), t_window_s=float(window_t0) * float(t0_s))


@dataclasses.dataclass(frozen=True)
class GNLSECoeffs:
    """Per-instance GNLSE coefficients (broadcastable over a leading B axis).

    ``lin_phase`` is the omega-domain phase rate sum beta_n omega^n / n!
    [rad/m] on the fft-ordered grid; ``gamma`` [1/(W m)]; ``alpha`` [1/m],
    flat (scalar or per-instance ``(B,)``) or frequency-resolved on the
    fft-ordered grid (``(T,)`` single run, ``(B, T)`` batched).  Rank
    disambiguates: a 2-D alpha is spectral, a 1-D alpha at the batch
    boundary is per-instance unless it can only be spectral."""

    gamma: torch.Tensor      # () or (B,)
    alpha: torch.Tensor      # () / (B,) flat, or (T,) / (B, T) spectral
    lin_phase: torch.Tensor  # (T,) or (B, T)


def _tensor(v, rdt: torch.dtype, device) -> torch.Tensor:
    """A coefficient (number, array or tensor) as an ``rdt`` tensor on
    ``device`` (``None``: the host), through float64."""
    device = "cpu" if device is None else device
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float64).to(rdt)
    return torch.as_tensor(np.array(v, dtype=np.float64), device=device).to(rdt)


def make_gnlse_coeffs(
    grid: TimeGrid,
    dispersion: Optional[DispersionParams] = None,
    *,
    gamma_W_m: float,
    alpha_1_m: float = 0.0,
    alpha_spec_1_m=None,
    max_order: Optional[int] = None,
    precision: str = "x64",
    device=None,
) -> GNLSECoeffs:
    """Build :class:`GNLSECoeffs` from the framework dispersion model, as
    tensors of ``precision``'s real dtype (``df32``: float64) on ``device``
    (``None``: the host).

    Orders 0 and 1 of ``dispersion`` are ignored (the co-moving frame removes
    the absolute phase and group delay).  ``alpha_spec_1_m`` (``(T,)`` on the
    fft-ordered ``grid.omega()``) adds a frequency-dependent loss profile on
    top of the flat ``alpha_1_m``; ``max_order`` truncates the Taylor
    series."""
    rdt = real_dtype(validate_precision(precision))
    om = grid.omega()
    phase = np.zeros_like(om)
    if dispersion is not None:
        cf = dispersion.coeffs.cpu().numpy()
        hi = len(cf) if max_order is None else min(len(cf), int(max_order) + 1)
        for n in range(2, hi):
            phase = phase + (cf[n] / math.factorial(n)) * om ** n
    if not np.all(np.isfinite(phase)):
        raise ValueError("dispersion phase must be finite on the grid")
    if alpha_spec_1_m is None:
        alpha = np.float64(alpha_1_m)
    else:
        sp = np.asarray(alpha_spec_1_m, dtype=np.float64)
        if sp.shape != om.shape:
            raise ValueError(
                f"alpha_spec_1_m must have shape {om.shape} (the fft-ordered "
                f"frequency grid), got {sp.shape}")
        if not np.all(np.isfinite(sp)):
            raise ValueError("alpha_spec_1_m must be finite")
        alpha = np.float64(alpha_1_m) + sp
    return GNLSECoeffs(gamma=_tensor(float(gamma_W_m), rdt, device),
                       alpha=_tensor(alpha, rdt, device),
                       lin_phase=_tensor(phase, rdt, device))


# ---------------------------------------------------------------------------
# Initial conditions and comb embedding (host numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def gaussian_pulse(grid: TimeGrid, *, peak_W: float, t0_s: float,
                   chirp: float = 0.0) -> np.ndarray:
    """``sqrt(P0) exp(-(1+iC) t^2 / (2 T0^2))`` on the grid."""
    u = grid.t() / float(t0_s)
    env = np.sqrt(float(peak_W)) * np.exp(-0.5 * (1.0 + 1j * float(chirp)) * u * u)
    return env.astype(np.complex128)


def sech_pulse(grid: TimeGrid, *, peak_W: float, t0_s: float) -> np.ndarray:
    """``sqrt(P0) sech(t/T0)`` (the soliton profile for beta2 < 0 when
    ``P0 = |beta2| / (gamma T0^2)``)."""
    return (np.sqrt(float(peak_W)) / np.cosh(grid.t() / float(t0_s))).astype(np.complex128)


def soliton_peak_power(beta2_s2_m: float, gamma_W_m: float, t0_s: float) -> float:
    """Fundamental-soliton peak power ``|beta2| / (gamma T0^2)`` [W]."""
    if beta2_s2_m >= 0:
        raise ValueError("solitons require anomalous dispersion (beta2 < 0)")
    return abs(float(beta2_s2_m)) / (float(gamma_W_m) * float(t0_s) ** 2)


def comb_to_field(grid: TimeGrid, line_amps: np.ndarray, domega: float) -> np.ndarray:
    """Place comb lines (centered, spacing ``domega``) onto the time grid.

    Line j of N carries baseband frequency ``(j - N//2) domega``; the window
    must hold an integer number of beat periods.  Inverse of
    :func:`field_to_comb`."""
    amps = np.asarray(line_amps, dtype=np.complex128)
    spec = np.zeros(amps.shape[:-1] + (int(grid.n_samples),), dtype=np.complex128)
    spec[..., _comb_bins(grid, amps.shape[-1], domega)] = amps
    # fft-convention synthesis: A = ifft(spec) * n (so |line amp| = |A| line)
    return np.fft.ifft(spec, axis=-1) * int(grid.n_samples)


def field_to_comb(grid: TimeGrid, A: np.ndarray, n_lines: int, domega: float) -> np.ndarray:
    """Read centered comb-line amplitudes back out of a periodic field."""
    spec = np.fft.fft(np.asarray(A, dtype=np.complex128), axis=-1) / int(grid.n_samples)
    return spec[..., _comb_bins(grid, int(n_lines), domega)]


def _comb_bins(grid: TimeGrid, n_lines: int, domega: float) -> np.ndarray:
    step = float(domega) * float(grid.t_window_s) / (2.0 * np.pi)
    k = int(round(step))
    if abs(step - k) > 1e-9 or k < 1:
        raise ValueError(
            "domega must be a positive integer multiple of 2*pi/t_window "
            f"(got {step} bins/line)")
    offs = (np.arange(n_lines) - n_lines // 2) * k
    if np.any(np.abs(offs) > grid.n_samples // 2 - 1):
        raise ValueError("comb does not fit in the grid bandwidth")
    return offs % int(grid.n_samples)


# ---------------------------------------------------------------------------
# Extended nonlinearity: Raman response + self-steepening
# ---------------------------------------------------------------------------

# standard silica single-damped-oscillator Raman model (Agrawal eq. 2.3.40)
RAMAN_TAU1_S = 12.2e-15
RAMAN_TAU2_S = 32.0e-15
RAMAN_FRACTION_SILICA = 0.18


@dataclasses.dataclass(frozen=True)
class NLTerms:
    """Extended-nonlinearity terms: delayed Raman response and
    self-steepening.  Passed to a solver, they replace the Kerr phase
    rotation by an RK4 substep on the generalized nonlinear operator

        N(A) = i gamma (1 + (i/omega_0) d/dt) [ A ((1 - f_R)|A|^2 + f_R (h_R * |A|^2)) ].

    ``hr_re/hr_im`` hold H_R(omega) (the fft of the sampled response times
    dt, so H_R(0) = 1) on the fft-ordered grid; ``inv_w0`` is 1/omega_0 (0
    disables self-steepening); ``f_r`` the Raman fraction."""

    f_r: torch.Tensor      # ()
    inv_w0: torch.Tensor   # ()
    omega: torch.Tensor    # (T,) fft-ordered [rad/s]
    hr_re: torch.Tensor    # (T,)
    hr_im: torch.Tensor    # (T,)


def raman_response(grid: TimeGrid, *, tau1_s: float = RAMAN_TAU1_S,
                   tau2_s: float = RAMAN_TAU2_S) -> np.ndarray:
    """Causal silica Raman response h_R(t) sampled on [0, t_window),
    normalized so the discrete integral (sum * dt) is exactly 1."""
    t = np.arange(int(grid.n_samples)) * grid.dt_s
    h = ((tau1_s**2 + tau2_s**2) / (tau1_s * tau2_s**2)
         * np.exp(-t / tau2_s) * np.sin(t / tau1_s))
    return h / (h.sum() * grid.dt_s)


def make_nl_terms(
    grid: TimeGrid,
    *,
    f_raman: float = RAMAN_FRACTION_SILICA,
    omega0: Optional[float] = None,
    tau1_s: float = RAMAN_TAU1_S,
    tau2_s: float = RAMAN_TAU2_S,
    precision: str = "x64",
    device=None,
) -> NLTerms:
    """Build :class:`NLTerms` as tensors of ``precision``'s real dtype on
    ``device`` (``None``: the host).  ``omega0`` (the carrier frequency)
    enables self-steepening, None disables it; ``f_raman=0`` disables the
    Raman term (pure Kerr through the RK4 path)."""
    rdt = real_dtype(validate_precision(precision))
    if not (0.0 <= float(f_raman) < 1.0):
        raise ValueError("f_raman must be in [0, 1)")
    if omega0 is not None and not float(omega0) > 0.0:
        raise ValueError("omega0 must be positive (or None)")
    if float(f_raman) > 0.0:
        HR = np.fft.fft(raman_response(grid, tau1_s=tau1_s, tau2_s=tau2_s)) * grid.dt_s
    else:
        HR = np.zeros(int(grid.n_samples), dtype=np.complex128)
    return NLTerms(
        f_r=_tensor(float(f_raman), rdt, device),
        inv_w0=_tensor(0.0 if omega0 is None else 1.0 / float(omega0), rdt, device),
        omega=_tensor(grid.omega(), rdt, device),
        hr_re=_tensor(HR.real, rdt, device),
        hr_im=_tensor(HR.imag, rdt, device),
    )


def raman_t_r(grid: TimeGrid, nl: NLTerms) -> float:
    """First moment T_R = f_R * integral(t h_R(t) dt) [s] (the slope of
    Im H_R at omega=0; drives the Gordon soliton self-frequency shift)."""
    t = np.arange(int(grid.n_samples)) * grid.dt_s
    hr = np.fft.ifft(_np(nl.hr_re) + 1j * _np(nl.hr_im)).real / grid.dt_s
    return float(_np(nl.f_r)) * float((t * hr).sum() * grid.dt_s)


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _times_i(z: torch.Tensor) -> torch.Tensor:
    """i * z for complex z, as two real operations."""
    return torch.complex(-z.imag, z.real)


def _cast_nl(nl: Optional[NLTerms], rdt: torch.dtype, device) -> Optional[NLTerms]:
    if nl is None:
        return None
    return NLTerms(*(_tensor(getattr(nl, f.name), rdt, device) for f in dataclasses.fields(nl)))


def _nl_rhs(y: torch.Tensor, gamma: torch.Tensor, nl: NLTerms) -> torch.Tensor:
    """Generalized nonlinear operator N(A) over (..., T) complex state.

    The module's time axis is the REVERSE of Agrawal's retarded time T (the
    odd-order dispersion sign is pinned by the nwave-comb cross-oracle):
    under t = -T the causal Raman convolution becomes a correlation
    (conjugate H_R) and the optical-shock derivative flips sign.  Both signs
    are pinned by physics tests (Gordon red-shift; shock centroid drift)."""
    P = y.real * y.real + y.imag * y.imag
    # the delayed response as a correlation on the t axis: P and h_R are
    # real, so half-length transforms compute it
    T = P.shape[-1]
    h = T // 2 + 1
    HRc_half = torch.complex(nl.hr_re[..., :h], -nl.hr_im[..., :h])
    R = torch.fft.irfft(HRc_half * torch.fft.rfft(P, dim=-1), n=T, dim=-1)
    fac = (1.0 - nl.f_r) * P + nl.f_r * R
    W = torch.complex(y.real * fac, y.imag * fac)
    # self-steepening (i/omega_0) dW/dT = -(i/omega_0) dW/dt, with d/dt a
    # multiply by (i omega) in the fft domain
    F = torch.fft.fft(W, dim=-1)
    dWdt = torch.fft.ifft(_times_i(torch.complex(nl.omega * F.real, nl.omega * F.imag)), dim=-1)
    V = _times_i(dWdt)
    inner = torch.complex(W.real - nl.inv_w0 * V.real, W.imag - nl.inv_w0 * V.imag)
    return _times_i(torch.complex(gamma * inner.real, gamma * inner.imag))


def _kerr_step(y: torch.Tensor, gamma: torch.Tensor, h) -> torch.Tensor:
    """Time-domain Kerr phase rotation exp(i gamma |A|^2 h)."""
    P = y.real * y.real + y.imag * y.imag
    ang = gamma * P * h
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.complex(y.real * c - y.imag * s, y.real * s + y.imag * c)


def _kerr_rhs(y: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Kerr-only nonlinear operator N(A) = i gamma |A|^2 A (the derivative
    form of :func:`_kerr_step`'s exact rotation; RK4IP needs N itself)."""
    gP = gamma * (y.real * y.real + y.imag * y.imag)
    return _times_i(torch.complex(gP * y.real, gP * y.imag))


def _nl_substep(y: torch.Tensor, gamma: torch.Tensor, h, nl: Optional[NLTerms]) -> torch.Tensor:
    """One nonlinear split substep: the exact Kerr rotation when ``nl`` is
    None, RK4 on the generalized operator otherwise."""
    if nl is None:
        return _kerr_step(y, gamma, h)
    k1 = _nl_rhs(y, gamma, nl)
    k2 = _nl_rhs(y + (0.5 * h) * k1, gamma, nl)
    k3 = _nl_rhs(y + (0.5 * h) * k2, gamma, nl)
    k4 = _nl_rhs(y + h * k3, gamma, nl)
    return y + (h / 6.0) * (k1 + 2.0 * (k2 + k3) + k4)


# ---------------------------------------------------------------------------
# The split-step solver core
# ---------------------------------------------------------------------------

def _lin_factor(alpha: torch.Tensor, lin_phase: torch.Tensor, h) -> torch.Tensor:
    """Frequency-domain linear factor exp((-alpha/2 + i phi) h).

    ``alpha`` rank rule (normalized by the public runners): rank 2 is a
    spectral ``(B, T)`` loss used as it is; rank 1 is per-instance ``(B,)``
    and gains the trailing time axis; rank 0 is flat.  ``h`` is a scalar
    tensor or a ``(B, 1)`` per-lane step."""
    al = alpha[..., None] if alpha.ndim == 1 else alpha
    decay = torch.exp(-0.5 * al * h)
    ang = lin_phase * h
    return torch.complex(decay * torch.cos(ang), decay * torch.sin(ang))


def _lane_dims(y: torch.Tensor) -> tuple:
    """Every axis of a ``(B, ...)`` state but the batch axis: ``(T,)`` for a
    scalar envelope, ``(2, T)`` for a vector one."""
    return tuple(range(1, y.ndim))


def _lane(v: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A per-lane ``(B,)`` tensor shaped to broadcast over ``y``'s lanes."""
    return v.reshape(v.shape + (1,) * (y.ndim - 1))


def _finite_mask(y: torch.Tensor) -> torch.Tensor:
    """Per-lane all-finite flag over every non-batch axis."""
    return torch.isfinite(y).all(dim=_lane_dims(y))


def _peak(y: torch.Tensor) -> torch.Tensor:
    """Max over the time axis of |A|^2, a row at a time: ``(B,)`` for a
    scalar state, ``(B, 2)`` for a vector one (NaN propagates)."""
    return (y.real * y.real + y.imag * y.imag).amax(dim=-1)


def _lfft(L: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft(L * torch.fft.fft(a, dim=-1), dim=-1)


def _chunk_strang(k: int, y, Lh, Lf, gamma, h, nl=None):
    """k fused symmetric split steps: Lh, (NL, Lf)^(k-1), NL, Lh."""
    if k == 0:
        return y
    y = _lfft(Lh, y)
    for _ in range(k - 1):
        y = _lfft(Lf, _nl_substep(y, gamma, h, nl))
    return _lfft(Lh, _nl_substep(y, gamma, h, nl))


def _chunk_rk4ip(k: int, y, Lh, Lf, gamma, h, nl=None):
    """k RK4IP steps (interaction-picture RK4; Hult, J. Lightwave Technol.
    25(12):3770, 2007): fourth order in dz where Strang is second, at 4
    half-step linear applications and 4 N evaluations a step.  Needs only
    the half-step factor ``Lh``."""
    def N(a):
        return _kerr_rhs(a, gamma) if nl is None else _nl_rhs(a, gamma, nl)

    for _ in range(k):
        y = rk4ip_step(lambda a: _lfft(Lh, a), N, y, h)
    return y


_STEPPERS = {"strang": _chunk_strang, "rk4ip": _chunk_rk4ip}


def _ssfm_method(integrator: str) -> str:
    """'rk4' is the Strang split, 'rk4ip' the interaction-picture RK4."""
    return "rk4ip" if integrator == "rk4ip" else "strang"


def _adaptive_method(integrator: str) -> str:
    """'rk45' doubles Strang steps, 'rk4ip45' RK4IP steps."""
    return "rk4ip" if integrator == "rk4ip45" else "strang"


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-d tensor of ``like``'s real dtype and device,
    rounded once, as the JAX package's ``jnp.asarray(v, rdt)``."""
    return torch.tensor(float(v), dtype=like.real.dtype, device=like.device)


def fixed_over_grid(y0, chunk, *, n_steps: int, save_every: int, keep_rows: bool = False):
    """The save-grid contract of the fixed-step split-step solvers over a
    ``(B, T)`` or ``(B, 2, T)`` state, ``chunk(k, y)`` advancing k steps:
    returns ``(rows, peak_max, y_last, ok)``, the saved states (row 0 and
    every chunk; only with ``keep_rows``), the running max over saved
    samples of max_t |y|^2 (a row at a time), the state at the last saved
    grid point, and the per-lane flag.
    The NaN freeze happens per chunk; the trailing ``n_steps % save_every``
    steps are integrated and feed only ``ok``."""
    if save_every < 1 or n_steps < 0:
        raise ValueError("need n_steps >= 0 and save_every >= 1")
    n_chunks, remainder = divmod(int(n_steps), int(save_every))
    y, ok, pk = y0, _finite_mask(y0), _peak(y0)
    rows = [y0] if keep_rows else None
    for _ in range(n_chunks):
        y_new = chunk(int(save_every), y)
        ok = ok & _finite_mask(y_new)
        y = torch.where(_lane(ok, y), y_new, y)
        pk = torch.maximum(pk, _peak(y))
        if keep_rows:
            rows.append(y)
    if remainder > 0:
        ok = ok & _finite_mask(chunk(remainder, y))
    return rows, pk, y, ok


def gnlse_fixed(y0, gamma, alpha, lin_phase, *, dz_m: float, n_steps: int, save_every: int,
                nl: Optional[NLTerms] = None, method: str = "strang",
                keep_rows: bool = False):
    """The fixed-step batched SSFM over a ``(B, T)`` complex state
    (``_gnlse_solver`` and ``_gnlse_reduce_solver`` of the JAX package).

    ``gamma`` is ``(B,)``, ``alpha`` ``(B,)`` or ``(B, T)``, ``lin_phase``
    ``(T,)`` or ``(B, T)``, all of ``y0``'s real dtype on its device.
    Returns :func:`fixed_over_grid`'s ``(rows, peak_max, y_last, ok)``."""
    h = _scalar(dz_m, y0)
    g = gamma[:, None]
    Lh = _lin_factor(alpha, lin_phase, 0.5 * h)
    Lf = _lin_factor(alpha, lin_phase, h)
    step = _STEPPERS[method]
    return fixed_over_grid(y0, lambda k, y: step(k, y, Lh, Lf, g, h, nl), n_steps=n_steps,
                           save_every=save_every, keep_rows=keep_rows)


# ---------------------------------------------------------------------------
# Adaptive split-step (integrator='rk45'/'rk4ip45'): step-doubling control
# ---------------------------------------------------------------------------
#
# The "local error method" for SSFM (Sinkin et al., J. Lightwave Technol. 21,
# 2003): each attempt takes one coarse step of size h and two fine steps of
# size h/2; their global RMS distance estimates the local error, controls
# acceptance and the next step size (exponent -1/(p+1)), and the accepted
# state is the Richardson extrapolation (2^p yf - yc)/(2^p - 1).

SSFM_SAFETY = 0.9
SSFM_MIN_FACTOR = 0.2
SSFM_MAX_FACTOR = 5.0


def _doubling_attempt(y, alpha, lin_phase, gamma, hb, nl):
    """One step-doubling attempt: (coarse h step, two fused fine h/2 steps).

    One factor build per attempt (exp(L h/2) is the exact square of
    exp(L h/4)) and one forward transform shared by the coarse and fine
    first substeps: 9 FFTs an attempt."""
    Lf = _lin_factor(alpha, lin_phase, 0.25 * hb)   # exp(L h/4)
    Lc = Lf * Lf                                    # exp(L h/2)
    fy = torch.fft.fft(y, dim=-1)
    yc = _lfft(Lc, _nl_substep(torch.fft.ifft(Lc * fy, dim=-1), gamma, hb, nl))
    yf = _nl_substep(torch.fft.ifft(Lf * fy, dim=-1), gamma, 0.5 * hb, nl)
    yf = _nl_substep(_lfft(Lc, yf), gamma, 0.5 * hb, nl)
    return yc, _lfft(Lf, yf)


def _doubling_attempt_rk4ip(y, alpha, lin_phase, gamma, hb, nl):
    """Step-doubling attempt on the RK4IP step (``integrator='rk4ip45'``):
    local error O(h^5), so the controller runs with order 4.  The coarse
    and fine first stages share N(y)."""
    def N(a):
        return _kerr_rhs(a, gamma) if nl is None else _nl_rhs(a, gamma, nl)

    def ip_step(a, L, h, Na):
        return rk4ip_step(lambda v: _lfft(L, v), N, a, h, Na)

    Lf = _lin_factor(alpha, lin_phase, 0.25 * hb)
    Lc = Lf * Lf
    Ny = N(y)
    yc = ip_step(y, Lc, hb, Ny)
    yf = ip_step(y, Lf, 0.5 * hb, Ny)
    return yc, ip_step(yf, Lf, 0.5 * hb, N(yf))


# (attempt, method order p) per adaptive scheme
_ADAPTIVE_ATTEMPTS = {"strang": (_doubling_attempt, 2), "rk4ip": (_doubling_attempt_rk4ip, 4)}


def _lane_rms2(a: torch.Tensor) -> torch.Tensor:
    """Per-lane mean |a|^2 over every non-batch axis."""
    return (a.real * a.real + a.imag * a.imag).mean(dim=_lane_dims(a))


def _ssfm_error_norm(yc, yf, y_old, *, rtol: float, atol: float) -> torch.Tensor:
    """Per-lane global relative error ||yf - yc|| / (atol + rtol ||y||)
    (RMS over the window; <= 1 meets the tolerance).  The denominator is
    floored at the dtype's ``tiny`` so an all-zero lane under atol = 0
    reads 0, not 0/0."""
    d = torch.sqrt(_lane_rms2(yf - yc))
    s = torch.sqrt(torch.maximum(_lane_rms2(yf), _lane_rms2(y_old)))
    return d / torch.clamp_min(atol + rtol * s, torch.finfo(d.dtype).tiny)


def _advance_segment(y, z, dt, ok, z_start, z_end, attempt, *, rtol: float, atol: float,
                     max_steps: int, order: int):
    """Adaptively advance every lane from ``z`` to the shared ``z_end``
    (``_gnlse_advance_segment`` of the JAX package); returns ``(y, z, dt,
    ok, n_accepted, n_rejected)``.

    The loop runs while a lane is active (``z < z_end`` and ok) and at most
    ``max_steps`` times.  Every active lane makes one attempt an iteration
    and stays active from the segment's start until it finishes or fails,
    so ``max_steps`` bounds each lane's attempts in the segment: the count
    the CUDA kernel keeps per envelope."""
    rdt = y.real.dtype
    span = z_end - z_start + 1.0
    dt_min = _scalar(1e-12, y) * span
    err_exp = -1.0 / (order + 1.0)
    rich = float(2 ** order)
    na = torch.zeros(z.shape, dtype=torch.int32, device=y.device)
    nr = torch.zeros_like(na)
    half = _scalar(0.5, y)
    escape_at = _scalar(1e30, y)
    for _ in range(int(max_steps)):
        active = (z < z_end) & ok
        if not bool(active.any()):
            break
        clipped = (z_end - z) < dt
        h = torch.minimum(dt, z_end - z)
        yc, yf = attempt(y, _lane(h, y))
        enorm = _ssfm_error_norm(yc, yf, y, rtol=rtol, atol=atol)
        finite = torch.isfinite(enorm) & _finite_mask(yf) & _finite_mask(yc)
        accept = active & finite & (enorm <= 1.0)
        y_new = torch.complex((rich * yf.real - yc.real) / (rich - 1.0),
                              (rich * yf.imag - yc.imag) / (rich - 1.0))
        # runaway-gain escape: a purely linear blowup has zero split error at
        # any step, so a lane whose mean power passes 1e30 W fails now
        escape = _lane_rms2(y_new) > escape_at
        accept = accept & ~escape
        factor = torch.where(
            finite,
            torch.clamp(SSFM_SAFETY * torch.pow(torch.clamp_min(enorm, 1e-16), err_exp),
                        SSFM_MIN_FACTOR, SSFM_MAX_FACTOR),
            half)
        # an accepted boundary-clipped step keeps the converged dt
        base = torch.where(clipped & accept, dt, h * factor)
        dt = torch.where(active, torch.maximum(base, dt_min), dt)
        failed = active & ((~accept & (h <= dt_min)) | escape)
        z = torch.where(accept, z + h, z)
        y = torch.where(_lane(accept, y), y_new, y)
        ok = ok & ~failed
        na = na + accept.to(torch.int32)
        nr = nr + (active & ~accept).to(torch.int32)
    # a lane that exhausted max_steps short of z_end failed, not short-ran
    ok = ok & (z >= z_end)
    return y, z, dt, ok, na, nr


def save_segments(dz_m: float, n_steps: int, save_every: int):
    """The adaptive save grid: ``(n_chunks, seg, z_end, has_tail)`` with
    grid point i at ``i * seg`` (``seg = save_every * dz``), the end of the
    integration at ``n_steps * dz``, and whether a trailing unsaved span
    ``[n_chunks * seg, z_end]`` follows, as the JAX package forms them."""
    n_chunks = int(n_steps) // int(save_every)
    return (n_chunks, int(save_every) * float(dz_m), int(n_steps) * float(dz_m),
            int(n_steps) - n_chunks * int(save_every) > 0)


def adaptive_over_grid(y0, attempt, order: int, *, dz_m: float, n_steps: int, save_every: int,
                       rtol: float, atol: float, max_steps: int, keep_rows: bool = False):
    """The save-grid contract of the adaptive split-step solvers over a
    ``(B, T)`` or ``(B, 2, T)`` state, ``attempt(y, hb)`` returning the
    (coarse, fine) pair of a step-doubling attempt of a method of
    ``order`` (``hb`` shaped to broadcast over the state).  Returns ``(rows,
    peak_max, y_last, ok, n_accepted, n_rejected)``.  Each saved segment
    ``[z_i, z_{i+1}]`` runs in absolute z from ``dt0 = dz``, carried across
    segments; the trailing span ``[z_S, n_steps dz]`` is integrated for
    ``ok`` and the counters only."""
    if save_every < 1 or n_steps < 0:
        raise ValueError("need n_steps >= 0 and save_every >= 1")
    B = y0.shape[0]
    n_chunks, seg, z_end_m, has_tail = save_segments(dz_m, n_steps, save_every)
    zg = [_scalar(i * seg, y0) for i in range(n_chunks + 1)]
    y, ok, pk = y0, _finite_mask(y0), _peak(y0)
    dt = _scalar(dz_m, y0).expand(B).clone()
    na = torch.zeros(B, dtype=torch.int32, device=y0.device)
    nr = torch.zeros_like(na)
    rows = [y0] if keep_rows else None
    kw = dict(rtol=float(rtol), atol=float(atol), max_steps=int(max_steps), order=order)
    for i in range(n_chunks):
        z = zg[i].expand(B).clone()
        y, _z, dt, ok, a, r = _advance_segment(y, z, dt, ok, zg[i], zg[i + 1], attempt, **kw)
        pk = torch.maximum(pk, _peak(y))
        na, nr = na + a, nr + r
        if keep_rows:
            rows.append(y)
    if has_tail:
        z = zg[-1].expand(B).clone()
        _y, _z, _dt, ok, a, r = _advance_segment(y, z, dt, ok, zg[-1], _scalar(z_end_m, y0),
                                                 attempt, **kw)
        na, nr = na + a, nr + r
    return rows, pk, y, ok, na, nr


def gnlse_adaptive(y0, gamma, alpha, lin_phase, *, dz_m: float, n_steps: int, save_every: int,
                   rtol: float, atol: float, max_steps: int, nl: Optional[NLTerms] = None,
                   method: str = "strang", keep_rows: bool = False):
    """The adaptive batched SSFM over the save grid
    (``_gnlse_adaptive_solver`` of the JAX package).  Inputs as
    :func:`gnlse_fixed`; returns :func:`adaptive_over_grid`'s tuple."""
    attempt_fn, order = _ADAPTIVE_ATTEMPTS[method]
    g = gamma[:, None]
    return adaptive_over_grid(
        y0, lambda y, hb: attempt_fn(y, alpha, lin_phase, g, hb, nl), order, dz_m=dz_m,
        n_steps=n_steps, save_every=save_every, rtol=rtol, atol=atol, max_steps=max_steps,
        keep_rows=keep_rows)


# ---------------------------------------------------------------------------
# Public runners
# ---------------------------------------------------------------------------

def _ndim(v) -> int:
    return v.ndim if isinstance(v, torch.Tensor) else np.ndim(v)


def lane_coeffs(coeffs: GNLSECoeffs, B: int, T: int, rdt: torch.dtype, device):
    """``(gamma (B,), alpha (B,) or (B, T), lin_phase (T,) or (B, T))``
    tensors of ``rdt`` on ``device`` (``gnlse.py:1223-1232``): a 2-D alpha,
    or a 1-D one of length T when T != B, is spectral; any other alpha is
    flat per lane.  A shared ``(T,)`` phase stays shared."""
    gamma = _tensor(coeffs.gamma, rdt, device).broadcast_to((B,)).contiguous()
    al = _tensor(coeffs.alpha, rdt, device)
    if al.ndim == 2 or (al.ndim == 1 and al.shape[0] == T and T != B):
        alpha = al.broadcast_to((B, T)).contiguous()
    else:
        alpha = al.broadcast_to((B,)).contiguous()
    ph = _tensor(coeffs.lin_phase, rdt, device)
    phase = ph if ph.ndim == 1 else ph.broadcast_to((B, T)).contiguous()
    return gamma, alpha, phase


def _prepare(cfg: SimulationConfig, length_unit: str):
    validate_config(cfg)
    reject_multistep(cfg, "the GNLSE solvers")
    scale = length_scale_to_m(length_unit)
    dz_m = float(cfg.dz) * scale
    n_steps = int(round(float(cfg.z_max) * scale / dz_m))
    precision = validate_precision(cfg.precision)
    integrator = cfg.integrator.lower()
    if precision == "df32" and integrator != "rk4":
        raise ValueError(
            "precision='df32' GNLSE solves are fixed-step rk4 (Strang) "
            "only (use x32 for rk45/rk4ip, or x64)")
    return precision, integrator, dz_m, n_steps, scale


def _batch_state(A0, cdt: torch.dtype, device: torch.device) -> torch.Tensor:
    if not isinstance(A0, torch.Tensor):
        A0 = torch.from_numpy(np.array(A0, dtype=np.complex128))
    if A0.ndim != 2:
        raise ValueError(f"A0 must have shape (B, T), got {tuple(A0.shape)}")
    return A0.to(device=device, dtype=cdt)


def _reject_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported: multi-device solves land with ROADMAP slice I "
            "(torch.distributed batch split)")


def _saved_z(z0: float, n_steps: int, save_every: int, dz_m: float, scale: float) -> np.ndarray:
    n_chunks = n_steps // save_every
    return z0 + np.arange(n_chunks + 1, dtype=np.float64) * (save_every * dz_m) / scale


def _solve_trajectories(cfg, precision, integrator, dz_m, n_steps, y0, lanes, nl):
    """Trajectory solve of a ``(B, T)`` state: ``(rows (B, S+1, T), ok)``."""
    kw = dict(dz_m=dz_m, n_steps=n_steps, save_every=int(cfg.save_every), nl=nl,
              keep_rows=True)
    if integrator in ("rk45", "rk4ip45"):
        rows, _pk, _y, ok, _na, _nr = gnlse_adaptive(
            y0, *lanes, rtol=float(cfg.rtol), atol=float(cfg.atol),
            max_steps=int(cfg.max_steps), method=_adaptive_method(integrator), **kw)
    else:
        rows, _pk, _y, ok = gnlse_fixed(y0, *lanes, method=_ssfm_method(integrator), **kw)
    return torch.stack(rows, dim=1), ok


def run_gnlse_simulation(
    cfg: SimulationConfig,
    coeffs: GNLSECoeffs,
    A0,
    *,
    length_unit: str = "m",
    nl: Optional[NLTerms] = None,
    z0: float = 0.0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Integrate one envelope over [z0, z0 + z_max]; returns host ``(z_saved,
    A_saved (S+1, T))`` on the decimated save grid.

    ``nl`` (:func:`make_nl_terms`) switches the nonlinear substep from the
    exact Kerr rotation to an RK4 substep on the generalized operator.
    ``cfg.integrator``: ``'rk4'`` (Strang), ``'rk4ip'``, or the adaptive
    ``'rk45'``/``'rk4ip45'`` at ``cfg.rtol``/``cfg.atol`` on the same save
    grid.  ``df32`` is Strang rk4 only and runs in float64.

    Checkpoint/resume: pass the last saved row as ``A0`` and its coordinate
    as ``z0`` (in ``length_unit``).  The co-moving GNLSE is autonomous in z,
    so a resumed fixed-step run reproduces the uninterrupted trajectory
    bitwise from any saved grid point; rk45 resumes to tolerance (the
    controller restarts from dz).  ``z0`` only offsets the returned grid.

    Raises ``FloatingPointError`` on NaN/Inf (or, adaptive, a step-size
    underflow) when ``cfg.check_nan``.  Plain torch on ``device`` (``None``:
    the CUDA card).
    """
    precision, integrator, dz_m, n_steps, scale = _prepare(cfg, length_unit)
    z0 = float(z0)
    if not np.isfinite(z0):
        raise ValueError("z0 must be finite")
    if not isinstance(A0, torch.Tensor):
        A0 = np.asarray(A0, dtype=np.complex128)
    if A0.ndim != 1:
        raise ValueError(f"A0 must be a 1-D envelope (T,), got {tuple(A0.shape)}")
    T = int(A0.shape[0])
    al_nd = _ndim(coeffs.alpha)
    spectral = al_nd == 1 and len(coeffs.alpha) == T
    if (_ndim(coeffs.lin_phase) > 1 or _ndim(coeffs.gamma) > 0
            or (al_nd > 0 and not spectral)):
        raise ValueError(
            "run_gnlse_simulation takes unbatched coeffs (scalar gamma/alpha "
            "-- or a (T,) spectral alpha -- and (T,) lin_phase); use "
            "solve_gnlse_batch for batched solves")
    device = resolve_device(device)
    rdt, cdt = dtypes_for(precision)
    y0 = _batch_state(A0[None], cdt, device)
    lanes = lane_coeffs(coeffs if not spectral else dataclasses.replace(
        coeffs, alpha=_tensor(coeffs.alpha, rdt, device)[None, :]), 1, T, rdt, device)
    rows, ok = _solve_trajectories(cfg, precision, integrator, dz_m, n_steps, y0, lanes,
                                   _cast_nl(nl, rdt, device))
    if cfg.check_nan and not bool(ok[0]):
        if integrator in ("rk45", "rk4ip45"):
            raise FloatingPointError(
                "NaN/Inf or step-size underflow during adaptive "
                f"({cfg.integrator}) GNLSE integration")
        raise FloatingPointError("NaN or Inf detected during GNLSE integration")
    z = _saved_z(z0, n_steps, int(cfg.save_every), dz_m, scale)
    return z, _host(rows[0].to(torch.complex128))


def solve_gnlse_batch_trajectories(
    cfg: SimulationConfig,
    coeffs: GNLSECoeffs,
    A0,
    *,
    length_unit: str = "m",
    mesh=None,
    nl: Optional[NLTerms] = None,
    z0: float = 0.0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched solve returning full decimated trajectories ``(z (S+1,), A
    (B, S+1, T) complex, ok (B,))`` as host arrays -- use
    :func:`solve_gnlse_batch` for large sweeps.  ``z0`` offsets the returned
    grid (resume; the equation is autonomous).  Plain torch on ``device``
    (``None``: the CUDA card); ``mesh`` must be None."""
    precision, integrator, dz_m, n_steps, scale = _prepare(cfg, length_unit)
    _reject_mesh(mesh)
    device = resolve_device(device)
    rdt, cdt = dtypes_for(precision)
    y0 = _batch_state(A0, cdt, device)
    B, T = y0.shape
    rows, ok = _solve_trajectories(cfg, precision, integrator, dz_m, n_steps, y0,
                                   lane_coeffs(coeffs, B, T, rdt, device),
                                   _cast_nl(nl, rdt, device))
    z = _saved_z(float(z0), n_steps, int(cfg.save_every), dz_m, scale)
    return z, _host(rows.to(torch.complex128)), _host(ok)


def kernel_route(integrator: str, nl, alpha: torch.Tensor, T: int, rdt: torch.dtype,
                 device: torch.device, engine: str) -> Optional[str]:
    """Which kernel ``solve_gnlse_batch`` launches: ``'gnlse_ssfm'`` (K6),
    ``'ssfm_rk45'`` (K8) or ``None`` (the plain torch version), decided from
    the arguments before any launch.  ``engine='cuda'`` raises, with the
    JAX package's messages, for a call the kernels do not take."""
    from ..ops import cuda_gnlse   # it imports this module

    if device.type != "cuda" or engine == "torch":
        return None
    strict = engine == "cuda"
    if integrator == "rk4":
        why = cuda_gnlse.width_problem("gnlse_ssfm", T, rdt, device, nl=nl is not None)
        name = "gnlse_ssfm"
    elif integrator == "rk45":
        if nl is not None:
            why = ("the fused adaptive SSFM kernel is Kerr-only; use "
                   "engine='torch' for nl= with integrator='rk45'")
        elif alpha.ndim == 2:
            why = ("the fused adaptive SSFM kernel supports flat per-lane loss "
                   "only (spectral alpha: engine='torch')")
        else:
            why = cuda_gnlse.width_problem("ssfm_rk45", T, rdt, device)
        name = "ssfm_rk45"
    else:
        why = ("engine='cuda' SSFM kernel implements the fixed-step Strang split "
               "(integrator='rk4') and the adaptive integrator='rk45' only")
        name = None
    if why is None:
        return name
    if strict:
        raise ValueError(why)
    return None


def solve_gnlse_batch(
    cfg: SimulationConfig,
    coeffs: GNLSECoeffs,
    A0,
    *,
    length_unit: str = "m",
    mesh=None,
    nl: Optional[NLTerms] = None,
    engine: str = "auto",
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Solve B independent envelopes in one batched solve (reduce mode).

    ``A0`` is ``(B, T)`` complex; ``coeffs`` fields broadcast or carry a
    leading B axis.  Returns host ``(peak_max (B,), A_last (B, T), ok
    (B,))``: the running max over saved samples of the instantaneous peak
    power, and the field at the last saved grid point.  ``nl`` enables Raman
    and self-steepening (shared across the batch).

    ``engine`` (the JAX package's 'scan' is 'torch' here, its 'pallas' is
    'cuda'):

    - ``'auto'``: on a CUDA device, Strang ``rk4`` (Kerr or ``nl``, flat or
      spectral loss) runs the kernel ``csrc/gnlse_ssfm.cu`` (fp64 for
      ``x64``/``df32``, fp32 for ``x32``), and ``rk45`` with Kerr and flat
      per-lane loss the kernel ``csrc/ssfm_rk45.cu``, each for T a multiple
      of 128 up to 2,048 whose block fits in shared memory; every other call
      (``rk4ip``, ``rk4ip45``, ``rk45`` with ``nl`` or spectral loss, another
      T) runs the plain torch version, as the JAX package's 'auto' always
      runs its scan.  On any other device the plain versions run.
    - ``'torch'``: the plain torch versions on ``device``.
    - ``'cuda'``: the kernels; a call they do not take raises.

    ``cfg.integrator='rk45'`` runs the adaptive split-step; the peak is over
    the same saved grid, and the state stops at the last saved grid point.
    Checkpoint/resume: ``A_last`` is the restart state.  ``df32`` is Strang
    rk4 only and runs in float64.  ``mesh`` must be None; ``device=None``
    means the CUDA card.
    """
    from ..ops import cuda_gnlse, cuda_ssfm_adaptive   # they import this module

    precision, integrator, dz_m, n_steps, _scale = _prepare(cfg, length_unit)
    if engine not in VALID_ENGINES:
        raise ValueError(f"engine must be one of {VALID_ENGINES}, got {engine!r}")
    _reject_mesh(mesh)
    device = resolve_device(device)
    if engine == "cuda" and device.type != "cuda":
        raise ValueError(f"engine='cuda' needs a CUDA device, got {device}")
    rdt, cdt = dtypes_for(precision)
    y0 = _batch_state(A0, cdt, device)
    B, T = y0.shape
    gamma, alpha, phase = lane_coeffs(coeffs, B, T, rdt, device)
    nl_t = _cast_nl(nl, rdt, device)
    route = kernel_route(integrator, nl_t, alpha, T, rdt, device, engine)
    kw = dict(dz_m=dz_m, n_steps=n_steps, save_every=int(cfg.save_every))
    if integrator in ("rk45", "rk4ip45"):
        kw.update(rtol=float(cfg.rtol), atol=float(cfg.atol), max_steps=int(cfg.max_steps))
        if route == "ssfm_rk45":
            r = cuda_ssfm_adaptive.solve_gnlse_batch_rk45_cuda(y0, gamma, alpha, phase, **kw)
        else:
            r = cuda_ssfm_adaptive.solve_gnlse_batch_rk45_torch(
                y0, gamma, alpha, phase, nl=nl_t, method=_adaptive_method(integrator), **kw)
    elif route == "gnlse_ssfm":
        r = cuda_gnlse.solve_gnlse_batch_cuda(y0, gamma, alpha, phase, nl=nl_t, **kw)
    else:
        r = cuda_gnlse.solve_gnlse_batch_torch(y0, gamma, alpha, phase, nl=nl_t,
                                               method=_ssfm_method(integrator), **kw)
    return (_host(r.peak_max.to(torch.float64)), _host(r.A_end.to(torch.complex128)),
            _host(r.ok))


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------

def pulse_energy(grid: TimeGrid, A) -> np.ndarray:
    """Envelope energy integral |A|^2 dt [J] over the window."""
    return (np.abs(np.asarray(A)) ** 2).sum(axis=-1) * grid.dt_s


def spectrum_dbw(grid: TimeGrid, A, *, floor_dbw: float = -200.0):
    """(omega sorted, |A(omega)|^2 in dBW-per-bin): fftshifted power spectrum
    normalized so a single comb line recovers its line power."""
    spec = np.fft.fft(np.asarray(A, dtype=np.complex128), axis=-1)
    P = np.fft.fftshift(np.abs(spec / int(grid.n_samples)) ** 2, axes=-1)
    om = np.fft.fftshift(grid.omega())
    return om, 10.0 * np.log10(np.maximum(P, 10 ** (floor_dbw / 10.0)))
