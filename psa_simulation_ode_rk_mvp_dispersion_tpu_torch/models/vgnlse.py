"""Vector (two-polarization) GNLSE: the coupled NLSE and the Manakov limit.

Counterpart of the JAX package's ``models/vgnlse.py``: a two-component field
``A(z, t) = (A_x, A_y)`` on the scalar family's periodic time window, in the
co-moving frame

    dA_x/dz = -alpha/2 A_x
              + i [ +dbeta0/2 + (dbeta1/2) omega + sum_{n>=2} beta_n omega^n/n! ] A_x
              + i gamma (|A_x|^2 + b |A_y|^2) A_x
    dA_y/dz =  (the same with dbeta0, dbeta1 negated and x <-> y)

- ``coupling='cnlse'``: b = 2/3, the incoherent coupled NLSE of a linearly
  birefringent fiber; ``'manakov'``: b = 1 with gamma scaled by 8/9 (random
  birefringence); ``'isotropic'``: b = 2/3 plus the coherent four-wave term
  ``i gamma c A_p* A_q^2`` with c = 1/3 (the full isotropic Kerr tensor).
- The nonlinear split substep is the exact joint rotation
  ``exp(i gamma (P_p + b P_q) h)`` for the incoherent couplings, an RK4 on
  the coherent operator for ``'isotropic'``, and, with ``nl=``
  (:func:`~.gnlse.make_nl_terms`), an RK4 on the isotropic-Raman operator
  (the scalar delayed response acting on the total power) with
  self-steepening.
- The solvers, the save-grid contract (samples at row 0 and every
  ``save_every``-th step; the trailing ``n_steps % save_every`` steps are
  integrated but feed only ``ok``; a lane whose chunk ends non-finite keeps
  its last good state), the adaptive step-doubling controller
  (``models/gnlse.adaptive_over_grid``) and the ``(B, ...)`` batching are
  the scalar family's, over a ``(B, 2, T)`` state: ``ok`` is per lane over
  both polarizations, the running peak per polarization.
- :func:`solve_vgnlse_batch` runs on a CUDA device through the hand-written
  kernel ``csrc/vgnlse_ssfm.cu`` (Strang rk4, every coupling, Kerr or
  ``nl``; ``ops/cuda_vgnlse.py``); elsewhere, with ``engine='torch'``, or
  for a call the kernel does not take under ``engine='auto'``, the plain
  torch version runs.  :func:`run_vgnlse_simulation` and
  :func:`solve_vgnlse_batch_trajectories` have no kernel in either package
  and run plain torch on their device.
- ``precision='df32'`` is Strang rk4 only and runs in float64 (the JAX
  package's two-float engine, ``ops/df32_vgnlse.py``, is not ported);
  ``device=None`` means the CUDA card; ``mesh=`` raises.
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
from ..utils.precision import dtypes_for, real_dtype, require_f64_leaves, validate_precision
from ..utils.units import length_scale_to_m
from .fwm4 import _host
from .gnlse import (
    NLTerms,
    TimeGrid,
    _adaptive_method,
    _cast_nl,
    _lfft,
    _ndim,
    _reject_mesh,
    _saved_z,
    _scalar,
    _ssfm_method,
    _tensor,
    _times_i,
    adaptive_over_grid,
    fixed_over_grid,
)

XPM_LINEAR_BIREFRINGENT = 2.0 / 3.0
MANAKOV_GAMMA_FACTOR = 8.0 / 9.0


@dataclasses.dataclass(frozen=True)
class VGNLSECoeffs:
    """Per-instance vector-GNLSE coefficients.

    ``lin_phase`` is the omega-domain phase rate per polarization [(2, T) or
    (B, 2, T), rad/m] including the birefringent +-dbeta0/2 and
    +-(dbeta1/2) omega terms; ``gamma`` [1/(W m)] the effective Kerr
    coefficient (already scaled by 8/9 for Manakov); ``b_xpm`` the
    cross-phase ratio; ``alpha`` [1/m] flat (scalar or per-instance (B,)) or
    frequency-resolved on the fft-ordered grid ((2, T) or (B, 2, T)).  Rank
    disambiguates: a 1-D alpha is per-instance, a spectral one at least 2-D.
    ``coherent`` (a Python float) is the coherent four-wave ratio c: 0 for
    the incoherent couplings (exact-rotation substep), 1/3 for the isotropic
    one (RK4 substep)."""

    gamma: torch.Tensor      # () or (B,)
    alpha: torch.Tensor      # () / (B,) flat, or (2, T) / (B, 2, T) spectral
    b_xpm: torch.Tensor      # ()
    lin_phase: torch.Tensor  # (2, T) or (B, 2, T)
    coherent: float = 0.0


def make_vgnlse_coeffs(
    grid: TimeGrid,
    dispersion: Optional[DispersionParams] = None,
    *,
    gamma_W_m: float,
    alpha_1_m: float = 0.0,
    alpha_spec_1_m=None,
    dbeta0_1_m: float = 0.0,
    dbeta1_s_m: float = 0.0,
    coupling: str = "cnlse",
    max_order: Optional[int] = None,
    precision: str = "x64",
    device=None,
) -> VGNLSECoeffs:
    """Build :class:`VGNLSECoeffs` as tensors of ``precision``'s real dtype
    (``df32``: float64) on ``device`` (``None``: the host).

    ``coupling``: ``'cnlse'`` (b = 2/3, gamma as given), ``'isotropic'``
    (b = 2/3 and c = 1/3) or ``'manakov'`` (b = 1, gamma x 8/9).
    ``dbeta0_1_m``/``dbeta1_s_m`` are the full phase and group
    birefringence (x gets +half, y -half).  Orders 0 and 1 of
    ``dispersion`` are ignored (co-moving frame).  ``alpha_spec_1_m``
    ((T,) shared or (2, T) per polarization, on the fft-ordered
    ``grid.omega()``) adds a frequency-dependent loss to the flat
    ``alpha_1_m``; a shared profile is stored as (2, T)."""
    rdt = real_dtype(validate_precision(precision))
    coh = 0.0
    if coupling == "cnlse":
        b, g_eff = XPM_LINEAR_BIREFRINGENT, float(gamma_W_m)
    elif coupling == "isotropic":
        b, g_eff, coh = XPM_LINEAR_BIREFRINGENT, float(gamma_W_m), 1.0 / 3.0
    elif coupling == "manakov":
        b, g_eff = 1.0, MANAKOV_GAMMA_FACTOR * float(gamma_W_m)
    else:
        raise ValueError(f"coupling must be 'cnlse', 'isotropic' or 'manakov', got {coupling!r}")
    om = grid.omega()
    common = np.zeros_like(om)
    if dispersion is not None:
        cf = dispersion.coeffs.cpu().numpy()
        hi = len(cf) if max_order is None else min(len(cf), int(max_order) + 1)
        for n in range(2, hi):
            common = common + (cf[n] / math.factorial(n)) * om ** n
    bire = 0.5 * float(dbeta0_1_m) + 0.5 * float(dbeta1_s_m) * om
    phase = np.stack([common + bire, common - bire])
    if not np.all(np.isfinite(phase)):
        raise ValueError("dispersion phase must be finite on the grid")
    if alpha_spec_1_m is None:
        alpha = np.float64(alpha_1_m)
    else:
        sp = np.asarray(alpha_spec_1_m, dtype=np.float64)
        if sp.shape not in (om.shape, (2,) + om.shape):
            raise ValueError(
                f"alpha_spec_1_m must have shape {om.shape} or {(2,) + om.shape} (the "
                f"fft-ordered frequency grid, optionally per polarization), got {sp.shape}")
        if not np.all(np.isfinite(sp)):
            raise ValueError("alpha_spec_1_m must be finite")
        alpha = np.float64(alpha_1_m) + np.broadcast_to(sp, (2,) + om.shape)
    return VGNLSECoeffs(gamma=_tensor(g_eff, rdt, device), alpha=_tensor(alpha, rdt, device),
                        b_xpm=_tensor(b, rdt, device), lin_phase=_tensor(phase, rdt, device),
                        coherent=coh)


def polarized_pulse(A: np.ndarray, theta_rad: float, phi_rad: float = 0.0) -> np.ndarray:
    """Split a scalar envelope (T,) onto the two polarization axes:
    ``(cos theta, sin theta e^{i phi}) A`` -> (2, T)."""
    A = np.asarray(A, dtype=np.complex128)
    jones = np.array([np.cos(float(theta_rad)),
                      np.sin(float(theta_rad)) * np.exp(1j * float(phi_rad))])
    return jones[:, None] * A[None, :]


def manakov_soliton_peak_power(beta2_s2_m: float, gamma_W_m: float, t0_s: float) -> float:
    """Total peak power of the Manakov vector soliton,
    ``|beta2| / ((8/9) gamma T0^2)`` [W] (any polarization split)."""
    if beta2_s2_m >= 0:
        raise ValueError("solitons require anomalous dispersion (beta2 < 0)")
    return abs(float(beta2_s2_m)) / (MANAKOV_GAMMA_FACTOR * float(gamma_W_m) * float(t0_s) ** 2)


# ---------------------------------------------------------------------------
# The solver core over a (B, 2, T) complex state
# ---------------------------------------------------------------------------

def _lin_factor_v(alpha: torch.Tensor, lin_phase: torch.Tensor, h) -> torch.Tensor:
    """Frequency-domain factor exp((-alpha/2 + i phi) h) per polarization.

    ``alpha`` rank rule: rank >= 2 is a spectral (2, T) / (B, 2, T) loss
    used as it is; rank 1 is per-instance (B,) and gains the (pol, time)
    axes; rank 0 is flat.  ``h`` is a scalar tensor or a ``(B, 1, 1)``
    per-lane step."""
    al = alpha[..., None, None] if alpha.ndim == 1 else alpha
    decay = torch.exp(-0.5 * al * h)
    ang = lin_phase * h
    return torch.complex(decay * torch.cos(ang), decay * torch.sin(ang))


def _xpm_kerr_step(y: torch.Tensor, gamma, b, h) -> torch.Tensor:
    """The exact joint rotation exp(i gamma (P_self + b P_other) h) of each
    polarization (both powers are invariants of the incoherent flow)."""
    P = y.real * y.real + y.imag * y.imag
    ang = gamma * (P + b * P.flip(-2)) * h
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.complex(y.real * c - y.imag * s, y.real * s + y.imag * c)


def _coupling(y: torch.Tensor, b, c: float) -> torch.Tensor:
    """K_p = (P_p + b P_q) A_p + c A_p* A_q^2 (q the other polarization)."""
    P = y.real * y.real + y.imag * y.imag
    s = P + b * P.flip(-2)
    K = torch.complex(s * y.real, s * y.imag)
    if c != 0.0:
        yo = y.flip(-2)
        K = K + c * (torch.conj(y) * yo * yo)
    return K


def _v_nl_rhs(y: torch.Tensor, gamma, b, c: float) -> torch.Tensor:
    """The vector Kerr operator N(A)_p = i gamma [(P_p + b P_q) A_p + c A_p*
    A_q^2]; the c-term exchanges power between the polarizations pointwise
    and conserves |A_x|^2 + |A_y|^2."""
    K = _coupling(y, b, c)
    return _times_i(torch.complex(gamma * K.real, gamma * K.imag))


def _v_nl_rhs_gen(y: torch.Tensor, gamma, b, c: float, nl: NLTerms) -> torch.Tensor:
    """The vector operator with the delayed Raman response and
    self-steepening, in the isotropic-Raman approximation (the scalar
    response acts on the total power P_x + P_y):

        N(A)_p = i gamma (1 + (i/omega_0) d/dt) W_p,
        W_p = (1 - f_R) K_p + f_R A_p (h_R * (P_p + P_q)).

    With A_q = 0 it is the scalar ``gnlse._nl_rhs``; the time-axis sign
    conventions are the scalar operator's."""
    K = _coupling(y, b, c)
    P = y.real * y.real + y.imag * y.imag
    T = P.shape[-1]
    hl = T // 2 + 1
    HRc_half = torch.complex(nl.hr_re[..., :hl], -nl.hr_im[..., :hl])
    Pt = P.sum(dim=-2, keepdim=True)          # one real transform pair for both polarizations
    R = torch.fft.irfft(HRc_half * torch.fft.rfft(Pt, dim=-1), n=T, dim=-1)
    W = (1.0 - nl.f_r) * K + nl.f_r * torch.complex(R * y.real, R * y.imag)
    F = torch.fft.fft(W, dim=-1)
    dWdt = torch.fft.ifft(_times_i(torch.complex(nl.omega * F.real, nl.omega * F.imag)), dim=-1)
    V = _times_i(dWdt)
    inner = torch.complex(W.real - nl.inv_w0 * V.real, W.imag - nl.inv_w0 * V.imag)
    return _times_i(torch.complex(gamma * inner.real, gamma * inner.imag))


def _v_nl_substep(y, gamma, b, h, coherent: float, nl: Optional[NLTerms] = None):
    """One nonlinear split substep: the exact rotation for the incoherent
    couplings, RK4 on the coherent operator or, with ``nl``, on the
    generalized one."""
    if nl is None and coherent == 0.0:
        return _xpm_kerr_step(y, gamma, b, h)

    def rhs(a):
        return _v_nl_rhs(a, gamma, b, coherent) if nl is None else \
            _v_nl_rhs_gen(a, gamma, b, coherent, nl)

    k1 = rhs(y)
    k2 = rhs(y + (0.5 * h) * k1)
    k3 = rhs(y + (0.5 * h) * k2)
    k4 = rhs(y + h * k3)
    return y + (h / 6.0) * (k1 + 2.0 * (k2 + k3) + k4)


def _chunk_strang_v(k: int, y, Lh, Lf, gamma, b, h, coherent, nl=None):
    """k fused symmetric split steps: Lh, (NL, Lf)^(k-1), NL, Lh."""
    if k == 0:
        return y
    y = _lfft(Lh, y)
    for _ in range(k - 1):
        y = _lfft(Lf, _v_nl_substep(y, gamma, b, h, coherent, nl))
    return _lfft(Lh, _v_nl_substep(y, gamma, b, h, coherent, nl))


def _chunk_rk4ip_v(k: int, y, Lh, Lf, gamma, b, h, coherent, nl=None):
    """k RK4IP steps over the vector state (``gnlse._chunk_rk4ip``'s
    counterpart); only the half-step factor ``Lh`` is used."""
    def N(a):
        return _v_nl_rhs(a, gamma, b, coherent) if nl is None else \
            _v_nl_rhs_gen(a, gamma, b, coherent, nl)

    for _ in range(k):
        y = rk4ip_step(lambda a: _lfft(Lh, a), N, y, h)
    return y


_STEPPERS_V = {"strang": _chunk_strang_v, "rk4ip": _chunk_rk4ip_v}


def vgnlse_fixed(y0, gamma, alpha, b_xpm, lin_phase, coherent: float, *, dz_m: float,
                 n_steps: int, save_every: int, nl: Optional[NLTerms] = None,
                 method: str = "strang", keep_rows: bool = False):
    """The fixed-step batched vector SSFM over a ``(B, 2, T)`` complex state
    (``_vgnlse_solver`` of the JAX package).

    ``gamma`` is ``(B,)``, ``alpha`` ``(B,)``, ``(2, T)`` or ``(B, 2, T)``,
    ``b_xpm`` 0-d, ``lin_phase`` ``(2, T)`` or ``(B, 2, T)``, all of ``y0``'s
    real dtype on its device.  Returns ``models/gnlse.fixed_over_grid``'s
    ``(rows, peak_max (B, 2), y_last, ok)``."""
    h = _scalar(dz_m, y0)
    g = gamma[:, None, None]
    Lh = _lin_factor_v(alpha, lin_phase, 0.5 * h)
    Lf = _lin_factor_v(alpha, lin_phase, h)
    step = _STEPPERS_V[method]
    return fixed_over_grid(
        y0, lambda k, y: step(k, y, Lh, Lf, g, b_xpm, h, float(coherent), nl),
        n_steps=n_steps, save_every=save_every, keep_rows=keep_rows)


def _v_doubling_attempt(y, alpha, lin_phase, gamma, b, coherent, hb, nl):
    """(coarse h step, two fused fine h/2 steps) of the vector state, as
    ``gnlse._doubling_attempt``: one factor build (exp(L h/2) is the exact
    square of exp(L h/4)) and one forward transform shared by the coarse
    and fine first substeps."""
    Lf = _lin_factor_v(alpha, lin_phase, 0.25 * hb)
    Lc = Lf * Lf
    fy = torch.fft.fft(y, dim=-1)
    yc = _lfft(Lc, _v_nl_substep(torch.fft.ifft(Lc * fy, dim=-1), gamma, b, hb, coherent, nl))
    yf = _v_nl_substep(torch.fft.ifft(Lf * fy, dim=-1), gamma, b, 0.5 * hb, coherent, nl)
    yf = _v_nl_substep(_lfft(Lc, yf), gamma, b, 0.5 * hb, coherent, nl)
    return yc, _lfft(Lf, yf)


def _v_doubling_attempt_rk4ip(y, alpha, lin_phase, gamma, b, coherent, hb, nl):
    """Step-doubling attempt on the vector RK4IP step (``rk4ip45``, order
    4); the coarse and fine first stages share N(y)."""
    def N(a):
        return _v_nl_rhs(a, gamma, b, coherent) if nl is None else \
            _v_nl_rhs_gen(a, gamma, b, coherent, nl)

    def ip_step(a, L, h, Na):
        return rk4ip_step(lambda v: _lfft(L, v), N, a, h, Na)

    Lf = _lin_factor_v(alpha, lin_phase, 0.25 * hb)
    Lc = Lf * Lf
    Ny = N(y)
    yc = ip_step(y, Lc, hb, Ny)
    yf = ip_step(y, Lf, 0.5 * hb, Ny)
    return yc, ip_step(yf, Lf, 0.5 * hb, N(yf))


_V_ADAPTIVE_ATTEMPTS = {"strang": (_v_doubling_attempt, 2),
                        "rk4ip": (_v_doubling_attempt_rk4ip, 4)}


def vgnlse_adaptive(y0, gamma, alpha, b_xpm, lin_phase, coherent: float, *, dz_m: float,
                    n_steps: int, save_every: int, rtol: float, atol: float, max_steps: int,
                    nl: Optional[NLTerms] = None, method: str = "strang",
                    keep_rows: bool = False):
    """The adaptive batched vector SSFM over the save grid
    (``_vgnlse_adaptive_solver`` of the JAX package) through the scalar
    family's controller.  Inputs as :func:`vgnlse_fixed`; returns
    ``models/gnlse.adaptive_over_grid``'s tuple (the error norm is per lane
    over both polarizations)."""
    attempt_fn, order = _V_ADAPTIVE_ATTEMPTS[method]
    g = gamma[:, None, None]
    return adaptive_over_grid(
        y0, lambda y, hb: attempt_fn(y, alpha, lin_phase, g, b_xpm, float(coherent), hb, nl),
        order, dz_m=dz_m, n_steps=n_steps, save_every=save_every, rtol=rtol, atol=atol,
        max_steps=max_steps, keep_rows=keep_rows)


# ---------------------------------------------------------------------------
# Public runners (contracts mirror models/gnlse)
# ---------------------------------------------------------------------------

def lane_coeffs(coeffs: VGNLSECoeffs, B: int, T: int, rdt: torch.dtype, device):
    """``(gamma (B,), alpha (B,) or (2, T) or (B, 2, T), b_xpm (), lin_phase
    (2, T) or (B, 2, T))`` tensors of ``rdt`` on ``device``, by the rank
    rule (a 1-D alpha is per-instance, a 2-D or 3-D one spectral); shared
    planes stay shared."""
    gamma = _tensor(coeffs.gamma, rdt, device).broadcast_to((B,)).contiguous()
    al = _tensor(coeffs.alpha, rdt, device)
    if al.ndim == 3:
        alpha = al.broadcast_to((B, 2, T)).contiguous()
    elif al.ndim == 2:
        alpha = al.broadcast_to((2, T)).contiguous()
    else:
        alpha = al.broadcast_to((B,)).contiguous()
    ph = _tensor(coeffs.lin_phase, rdt, device)
    phase = ph.broadcast_to((2, T) if ph.ndim == 2 else (B, 2, T)).contiguous()
    return gamma, alpha, _tensor(coeffs.b_xpm, rdt, device).reshape(()), phase


def _prepare(cfg: SimulationConfig, coeffs: VGNLSECoeffs, length_unit: str):
    validate_config(cfg)
    reject_multistep(cfg, "the vector GNLSE solvers")
    scale = length_scale_to_m(length_unit)
    dz_m = float(cfg.dz) * scale
    n_steps = int(round(float(cfg.z_max) * scale / dz_m))
    precision = validate_precision(cfg.precision)
    integrator = cfg.integrator.lower()
    if precision == "df32":
        if integrator != "rk4":
            raise ValueError(
                "precision='df32' vector-GNLSE solves are fixed-step rk4 (Strang) only (use x32 "
                "for rk45/rk4ip, or x64)")
        require_f64_leaves("vector-GNLSE df32", gamma=coeffs.gamma, alpha=coeffs.alpha,
                           lin_phase=coeffs.lin_phase)
    return precision, integrator, dz_m, n_steps, scale


def _vector_state(A0, cdt: torch.dtype, device: torch.device) -> torch.Tensor:
    if not isinstance(A0, torch.Tensor):
        A0 = torch.from_numpy(np.array(A0, dtype=np.complex128))
    if A0.ndim != 3 or A0.shape[1] != 2:
        raise ValueError(f"A0 must have shape (B, 2, T), got {tuple(A0.shape)}")
    return A0.to(device=device, dtype=cdt)


def _solve_trajectories(cfg, integrator, dz_m, n_steps, y0, lanes, coherent, nl):
    """Trajectory solve of a ``(B, 2, T)`` state: ``(rows (B, S+1, 2, T), ok)``."""
    kw = dict(dz_m=dz_m, n_steps=n_steps, save_every=int(cfg.save_every), nl=nl,
              keep_rows=True)
    if integrator in ("rk45", "rk4ip45"):
        rows, _pk, _y, ok, _na, _nr = vgnlse_adaptive(
            y0, *lanes, coherent, rtol=float(cfg.rtol), atol=float(cfg.atol),
            max_steps=int(cfg.max_steps), method=_adaptive_method(integrator), **kw)
    else:
        rows, _pk, _y, ok = vgnlse_fixed(y0, *lanes, coherent,
                                         method=_ssfm_method(integrator), **kw)
    return torch.stack(rows, dim=1), ok


def run_vgnlse_simulation(
    cfg: SimulationConfig,
    coeffs: VGNLSECoeffs,
    A0,
    *,
    length_unit: str = "m",
    z0: float = 0.0,
    nl: Optional[NLTerms] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Integrate one vector envelope (2, T) over [z0, z0 + z_max]; returns
    host ``(z_saved, A_saved (S+1, 2, T))`` on the decimated save grid.

    ``cfg.integrator``: ``'rk4'`` (Strang), ``'rk4ip'``, or the adaptive
    ``'rk45'``/``'rk4ip45'`` on the same save grid.  ``nl``
    (:func:`~.gnlse.make_nl_terms`) enables Raman and self-steepening in the
    isotropic-Raman approximation.  Checkpoint/resume: pass the last saved
    row as ``A0`` and its coordinate as ``z0``; a resumed fixed-step run
    continues the uninterrupted trajectory bitwise (rk45: to tolerance).
    Raises ``FloatingPointError`` on NaN/Inf (adaptive: or a step-size
    underflow) when ``cfg.check_nan``.  Plain torch on ``device`` (``None``:
    the CUDA card); ``df32`` is Strang rk4 only and runs in float64."""
    precision, integrator, dz_m, n_steps, scale = _prepare(cfg, coeffs, length_unit)
    z0 = float(z0)
    if not np.isfinite(z0):
        raise ValueError("z0 must be finite")
    if not isinstance(A0, torch.Tensor):
        A0 = np.asarray(A0, dtype=np.complex128)
    if A0.ndim != 2 or A0.shape[0] != 2:
        raise ValueError(f"A0 must be a (2, T) vector envelope, got {tuple(A0.shape)}")
    if (_ndim(coeffs.lin_phase) > 2 or _ndim(coeffs.gamma) > 0
            or _ndim(coeffs.alpha) not in (0, 2)):
        raise ValueError(
            "run_vgnlse_simulation takes unbatched coeffs (scalar or (2, T) spectral alpha, "
            "scalar gamma, (2, T) lin_phase); use solve_vgnlse_batch for batches")
    device = resolve_device(device)
    rdt, cdt = dtypes_for(precision)
    y0 = _vector_state(A0[None], cdt, device)
    T = int(y0.shape[-1])
    rows, ok = _solve_trajectories(cfg, integrator, dz_m, n_steps, y0,
                                   lane_coeffs(coeffs, 1, T, rdt, device),
                                   float(coeffs.coherent), _cast_nl(nl, rdt, device))
    if cfg.check_nan and not bool(ok[0]):
        if integrator in ("rk45", "rk4ip45"):
            raise FloatingPointError(
                "NaN/Inf or step-size underflow during adaptive "
                f"({cfg.integrator}) vector-GNLSE integration")
        raise FloatingPointError("NaN or Inf detected during vector-GNLSE integration")
    z = _saved_z(z0, n_steps, int(cfg.save_every), dz_m, scale)
    return z, _host(rows[0].to(torch.complex128))


def solve_vgnlse_batch_trajectories(
    cfg: SimulationConfig,
    coeffs: VGNLSECoeffs,
    A0,
    *,
    length_unit: str = "m",
    z0: float = 0.0,
    nl: Optional[NLTerms] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched solve returning full decimated trajectories ``(z (S+1,), A
    (B, S+1, 2, T) complex, ok (B,))`` as host arrays -- use
    :func:`solve_vgnlse_batch` for large sweeps.  ``z0`` offsets the grid.
    Plain torch on ``device`` (``None``: the CUDA card)."""
    precision, integrator, dz_m, n_steps, scale = _prepare(cfg, coeffs, length_unit)
    device = resolve_device(device)
    rdt, cdt = dtypes_for(precision)
    y0 = _vector_state(A0, cdt, device)
    B, _, T = y0.shape
    rows, ok = _solve_trajectories(cfg, integrator, dz_m, n_steps, y0,
                                   lane_coeffs(coeffs, B, T, rdt, device),
                                   float(coeffs.coherent), _cast_nl(nl, rdt, device))
    z = _saved_z(float(z0), n_steps, int(cfg.save_every), dz_m, scale)
    return z, _host(rows.to(torch.complex128)), _host(ok)


def vgnlse_kernel_route(integrator: str, nl, coherent: float, T: int, rdt: torch.dtype,
                        device: torch.device, engine: str) -> Optional[str]:
    """Whether ``solve_vgnlse_batch`` launches ``'vgnlse_ssfm'`` (K9) or runs
    the plain torch version (``None``), decided from the arguments before
    any launch.  ``engine='cuda'`` raises for a call the kernel does not
    take: another integrator than Strang rk4, or a width or shared-memory
    size outside its limits (``ops/cuda_vgnlse.width_problem``)."""
    from ..ops import cuda_vgnlse   # it imports this module

    if device.type != "cuda" or engine == "torch":
        return None
    if integrator == "rk4":
        why = cuda_vgnlse.width_problem(T, rdt, device, cuda_vgnlse.body_of(coherent, nl))
    else:
        why = "engine='cuda' vector SSFM kernel implements fixed-step rk4 only"
    if why is None:
        return "vgnlse_ssfm"
    if engine == "cuda":
        raise ValueError(why)
    return None


def solve_vgnlse_batch(
    cfg: SimulationConfig,
    coeffs: VGNLSECoeffs,
    A0,
    *,
    length_unit: str = "m",
    mesh=None,
    engine: str = "auto",
    nl: Optional[NLTerms] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Solve B independent vector envelopes (B, 2, T) in one batched solve.

    Returns host ``(peak_max (B, 2), A_last (B, 2, T), ok (B,))``: the
    per-polarization running peak power over the saved samples, the field
    at the last saved grid point (the restart state: feed it back as ``A0``
    to continue bitwise at fixed step), and the per-instance flag.

    ``engine`` (the JAX package's 'scan' is 'torch' here, its 'pallas' is
    'cuda'):

    - ``'auto'``: on a CUDA device, Strang ``rk4`` (every coupling, Kerr or
      ``nl``, flat, per-instance or spectral loss) runs the kernel
      ``csrc/vgnlse_ssfm.cu`` (fp64 for ``x64``/``df32``, fp32 for ``x32``)
      for T a multiple of 128 up to 2,048 whose block fits in shared memory
      (``ops/cuda_vgnlse.py`` lists the widths); ``rk4ip``, ``rk45`` and
      ``rk4ip45``, which have no kernel in either package, and any other T
      run the plain torch version on the card.  The JAX package's 'auto' is
      its scan.  On any other device the plain version runs.
    - ``'torch'``: the plain torch version on ``device``.
    - ``'cuda'``: the kernel; a call it does not take raises.

    ``nl`` (:func:`~.gnlse.make_nl_terms`) enables Raman and
    self-steepening.  ``df32`` is Strang rk4 only and runs in float64.
    ``mesh`` must be None; ``device=None`` means the CUDA card."""
    from ..ops import cuda_vgnlse   # it imports this module

    precision, integrator, dz_m, n_steps, _scale = _prepare(cfg, coeffs, length_unit)
    if engine not in VALID_ENGINES:
        raise ValueError(f"engine must be one of {VALID_ENGINES}, got {engine!r}")
    _reject_mesh(mesh)
    device = resolve_device(device)
    if engine == "cuda" and device.type != "cuda":
        raise ValueError(f"engine='cuda' needs a CUDA device, got {device}")
    rdt, cdt = dtypes_for(precision)
    y0 = _vector_state(A0, cdt, device)
    B, _, T = y0.shape
    gamma, alpha, b, phase = lane_coeffs(coeffs, B, T, rdt, device)
    coherent = float(coeffs.coherent)
    nl_t = _cast_nl(nl, rdt, device)
    route = vgnlse_kernel_route(integrator, nl_t, coherent, T, rdt, device, engine)
    kw = dict(dz_m=dz_m, n_steps=n_steps, save_every=int(cfg.save_every), nl=nl_t)
    if integrator in ("rk45", "rk4ip45"):
        _rows, pk, y, ok, _na, _nr = vgnlse_adaptive(
            y0, gamma, alpha, b, phase, coherent, rtol=float(cfg.rtol), atol=float(cfg.atol),
            max_steps=int(cfg.max_steps), method=_adaptive_method(integrator), **kw)
        r = cuda_vgnlse.VGNLSEBatchResult(peak_max=pk, A_end=y, ok=ok)
    elif route == "vgnlse_ssfm":
        r = cuda_vgnlse.solve_vgnlse_batch_cuda(y0, gamma, alpha, b, phase, coherent, **kw)
    else:
        r = cuda_vgnlse.solve_vgnlse_batch_torch(y0, gamma, alpha, b, phase, coherent,
                                                 method=_ssfm_method(integrator), **kw)
    return (_host(r.peak_max.to(torch.float64)), _host(r.A_end.to(torch.complex128)),
            _host(r.ok))


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------

def stokes_parameters(A: np.ndarray) -> np.ndarray:
    """Time-resolved Stokes vector (S0, S1, S2, S3) of a (..., 2, T) field."""
    A = np.asarray(A)
    ax, ay = A[..., 0, :], A[..., 1, :]
    s0 = np.abs(ax) ** 2 + np.abs(ay) ** 2
    s1 = np.abs(ax) ** 2 - np.abs(ay) ** 2
    cross = ax * np.conj(ay)
    return np.stack([s0, s1, 2.0 * cross.real, -2.0 * cross.imag], axis=-2)


def degree_of_polarization(grid: TimeGrid, A: np.ndarray) -> np.ndarray:
    """Energy-weighted DOP of a (..., 2, T) field: |<(S1,S2,S3)>| / <S0>."""
    s = stokes_parameters(A)
    tot = s.sum(axis=-1) * grid.dt_s
    s0 = tot[..., 0]
    vec = np.sqrt((tot[..., 1:] ** 2).sum(axis=-1))
    return vec / np.maximum(s0, 1e-300)
