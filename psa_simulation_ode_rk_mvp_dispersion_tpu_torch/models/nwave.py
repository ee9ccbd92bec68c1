"""N-wave cascaded four-wave-mixing comb model.

Counterpart of the JAX package's ``models/nwave.py`` (BASELINE config 5):
N lines on a uniform angular-frequency grid ``omega_j = omega_0 + j *
domega`` obey the coupled-mode equations

    dA_j/dz = (-alpha/2 + i beta_j) A_j
              + i gamma * sum_{k,l,m : k+l-m=j} A_k A_l A_m^*

The cubic sum is a convolution-correlation, evaluated three ways
(``coupling``): ``'fft'`` (padded ``torch.fft`` transforms of length
``L >= 2N-1``), ``'dft'`` (the same transforms as dense DFT matrix
products) and ``'einsum'`` (the direct O(N^3) sum, for validation).  Both
transform forms use ``F^2 conj(F) = F |F|^2``.

- Parameter objects are built on the host when no device is given
  (:func:`make_comb_coeffs`), as the JAX package builds them with numpy;
  :func:`seed_comb` keeps numpy's ``default_rng(seed)``, so a seed gives the
  same ``A0`` in both packages.
- :func:`solve_comb_batch` runs on a CUDA device through the hand-written
  kernels ``csrc/comb_rk.cu`` (rk4/ab4/abm4, ``ops/cuda_comb.py``) and
  ``csrc/comb_rk45.cu`` (rk45, ``ops/cuda_comb_adaptive.py``); elsewhere, or
  with ``engine='torch'``, their plain torch versions run.
- :func:`run_comb_simulation` and :func:`solve_comb_batch_trajectories` have
  no kernel in either package and run plain torch on their device.
- ``device=None`` means the CUDA card; without one the solvers raise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..config import SimulationConfig, validate_config, reject_non_ode
from ..ops.adaptive import integrate_adaptive_grid
from ..ops.cuda_adaptive import save_grid
from ..ops.dispersion import DispersionParams, beta_taylor
from ..ops.integrators import integrate_fixed_grid
from ..utils.checks import as_f64, resolve_device
from ..utils.precision import dtypes_for, real_dtype, validate_precision
from ..utils.units import length_scale_to_m
from ..parallel.sweep import VALID_ENGINES   # 'torch' is JAX's 'scan', 'cuda' its 'pallas'
from .fwm4 import _host


@dataclasses.dataclass(frozen=True)
class NWaveCoeffs:
    """Lowered comb coefficients: tensors (or numbers and arrays, which the
    solvers convert).

    ``beta_lin`` is the per-line linear propagation constant [1/m] (possibly
    gauge-reduced); ``gamma`` [1/(W m)] and ``alpha`` [1/m] are scalars or
    carry a leading batch axis.
    """

    gamma: torch.Tensor      # scalar or (...,)
    alpha: torch.Tensor      # scalar or (...,)
    beta_lin: torch.Tensor   # (..., N)


def _fft_len(n_waves: int) -> int:
    """Smallest power of two >= 2N-1: alias-free for the kept outputs.

    The circular triple product aliases only when k+l-m-j = +-L; with
    k,l,m,j in [0, N-1] that combination spans [-(2N-2), 2N-2], so any
    L >= 2N-1 is exact for T[0:N]."""
    need = max(2 * n_waves - 1, 1)
    return 1 << (need - 1).bit_length()


def dft_roots(L: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(cos, sin)`` of ``2 pi k / L`` for k in [0, L), float64.  The dense
    DFT matrices of :func:`_dft_mats` and the twiddle table of the comb
    kernels both index these roots at ``(j * m) mod L``, so both use
    identical weights."""
    ang = (2.0 * np.pi / L) * np.arange(L)
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=32)
def _dft_mats(n_waves: int, dtype: torch.dtype, device: str):
    """Block DFT matrices over stacked real/imag rows, ``(Wf, Wi)``.

    ``[Fr | Fi] = [Ar | Ai] @ Wf`` with ``Wf`` ``(2N, 2L)``: the forward DFT
    of the N lines into L bins, ``F_j = sum_m A_m e^{-2 pi i jm/L}``;
    ``[Tr | Ti] = [Gr | Gi] @ Wi`` with ``Wi`` ``(2L, 2N)``: the inverse DFT
    of the L bins, 1/L included, kept at the N physical lines."""
    L = _fft_len(n_waves)
    c_k, s_k = dft_roots(L)
    idx = np.outer(np.arange(n_waves), np.arange(L)) % L     # (N, L): j*m mod L
    c, s = c_k[idx], s_k[idx]
    wf = np.block([[c, -s], [s, c]])                          # (2N, 2L)
    wi = np.block([[c.T, s.T], [-s.T, c.T]]) / L              # (2L, 2N)
    return (torch.as_tensor(wf, dtype=dtype, device=device),
            torch.as_tensor(wi, dtype=dtype, device=device))


def fwm_polarization(a: torch.Tensor) -> torch.Tensor:
    """T_j = sum_{k+l-m=j} A_k A_l A_m^* via padded FFTs (O(N log N))."""
    n = a.shape[-1]
    F = torch.fft.fft(a, n=_fft_len(n), dim=-1)
    return torch.fft.ifft(F * F * F.conj(), dim=-1)[..., :n]


def fwm_polarization_dft(a: torch.Tensor) -> torch.Tensor:
    """Same cubic sum as :func:`fwm_polarization`, with the transforms as
    two dense real matrix products over stacked ``[Ar | Ai]`` rows (the
    kernels' sums: ``8 N L`` real multiply-adds per state)."""
    n = a.shape[-1]
    wf, wi = _dft_mats(int(n), a.real.dtype, str(a.device))
    L = wf.shape[1] // 2
    F = torch.cat([a.real, a.imag], dim=-1) @ wf
    Fr, Fi = F[..., :L], F[..., L:]
    mag = Fr * Fr + Fi * Fi
    T = torch.cat([Fr * mag, Fi * mag], dim=-1) @ wi
    return torch.complex(T[..., :n], T[..., n:])


def fwm_polarization_direct(a: torch.Tensor) -> torch.Tensor:
    """Reference O(N^3) evaluation of the same sum (validation / small N):
    every product ``A_k A_l A_m^*`` with ``0 <= k+l-m < N`` added into its
    line ``j = k+l-m``."""
    n = a.shape[-1]
    k, l, m = (g.ravel() for g in np.meshgrid(*(np.arange(n),) * 3, indexing="ij"))
    j = k + l - m
    keep = (j >= 0) & (j < n)
    k, l, m, j = (torch.as_tensor(v[keep], device=a.device) for v in (k, l, m, j))
    prod = a[..., k] * a[..., l] * a[..., m].conj()
    return torch.zeros_like(a).index_add_(-1, j, prod)


VALID_COUPLINGS = ("fft", "dft", "einsum")

_COUPLING_FNS = {
    "fft": fwm_polarization,
    "dft": fwm_polarization_dft,
    "einsum": fwm_polarization_direct,
}


def _real(v, like: torch.Tensor) -> torch.Tensor:
    return (v if isinstance(v, torch.Tensor) else as_f64(v)).to(like.device, like.real.dtype)


def _coef(v, nb: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar-or-(batch,) coefficient in ``like``'s real dtype, shaped to
    broadcast against the ``(..., N)`` state."""
    c = _real(v, like)
    return c.reshape(c.shape + (1,) * (1 + nb - c.ndim)) if c.ndim > 0 else c


def make_rhs_nwave(coupling: str = "fft"):
    """Comb RHS factory over ``(..., N)`` complex state; autonomous.

    ``coupling`` selects the evaluation of the cubic sum: 'fft', 'dft'
    (dense DFT matrix products) or 'einsum' (O(N^3) reference).  The terms
    are added in the order of the comb kernels:
    ``d_re = (-a/2 Ar - beta Ai) - gamma Ti``, ``d_im = (-a/2 Ai + beta Ar)
    + gamma Tr``."""
    if coupling not in VALID_COUPLINGS:
        raise ValueError(f"coupling must be one of {VALID_COUPLINGS}, got {coupling!r}")
    rhs = _rhs_of(_COUPLING_FNS[coupling])
    rhs.__name__ = f"rhs_nwave_{coupling}"
    return rhs


def _rhs_of(pol):
    """The comb RHS over ``(..., N)`` complex state with the cubic sum
    ``pol(a)``, the terms in the order of :func:`make_rhs_nwave`."""

    def rhs(z, a: torch.Tensor, p: NWaveCoeffs) -> torch.Tensor:
        nb = a.ndim - 1
        g = _coef(p.gamma, nb, a)
        nha = -0.5 * _coef(p.alpha, nb, a)
        beta = _real(p.beta_lin, a)          # (..., N) broadcasts against the state
        T = pol(a)
        ar, ai = a.real, a.imag
        d_re = (nha * ar - beta * ai) - g * T.imag
        d_im = (nha * ai + beta * ar) + g * T.real
        return torch.complex(d_re, d_im)

    return rhs


rhs_nwave = make_rhs_nwave("fft")
rhs_nwave_direct = make_rhs_nwave("einsum")


# ---------------------------------------------------------------------------
# Parameter construction (host side unless a device is given)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CombGrid:
    """Uniform comb frequency grid: omega_j = omega_0 + j * domega."""

    omega_0: float     # [rad/s] first line
    domega: float      # [rad/s] line spacing
    n_waves: int

    def omegas(self) -> np.ndarray:
        return self.omega_0 + np.arange(self.n_waves) * self.domega

    @classmethod
    def centered(cls, omega_c: float, domega: float, n_waves: int) -> "CombGrid":
        """Grid centered on omega_c (line index n_waves//2 at omega_c)."""
        return cls(
            omega_0=float(omega_c) - (n_waves // 2) * float(domega),
            domega=float(domega),
            n_waves=int(n_waves),
        )


def comb_beta_lin(
    grid: CombGrid,
    dispersion: DispersionParams,
    *,
    max_order: int = 4,
    remove_linear: bool = True,
) -> np.ndarray:
    """Per-line beta(omega_j) [1/m] from the Taylor dispersion model, as a
    host float64 array.

    ``remove_linear=True`` subtracts the constant and group-delay terms
    (beta_0 + beta_1*(omega_j - omega_ref)): a gauge transformation that
    leaves every |A_j| and every energy-conserving mixing product's phase
    mismatch invariant, while removing the fastest phase rotations."""
    om = grid.omegas()
    beta = beta_taylor(om, dispersion, max_order=max_order).cpu().numpy()
    if remove_linear:
        dw = om - float(dispersion.omega_ref)
        b0 = float(dispersion.get_beta_n(0))
        b1 = float(dispersion.get_beta_n(1))
        beta = beta - (b0 + b1 * dw)
    return beta


def make_comb_coeffs(
    grid: CombGrid,
    dispersion: DispersionParams,
    *,
    gamma_W_m: float,
    alpha_1_m: float = 0.0,
    max_order: int = 4,
    remove_linear: bool = True,
    precision: str = "x64",
    device=None,
) -> NWaveCoeffs:
    """Comb coefficients as tensors of ``precision``'s real dtype on
    ``device`` (``None``: the host, as the port's other parameter
    builders)."""
    rdt = real_dtype(validate_precision(precision))
    dev = "cpu" if device is None else device

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64), device=dev).to(rdt)

    return NWaveCoeffs(
        gamma=t(float(gamma_W_m)),
        alpha=t(float(alpha_1_m)),
        beta_lin=t(comb_beta_lin(grid, dispersion, max_order=max_order,
                                 remove_linear=remove_linear)),
    )


def seed_comb(
    grid: CombGrid,
    *,
    pump_lines: dict,
    noise_floor_W: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Initial comb state (host complex128): ``pump_lines`` maps line index
    -> power [W] (or (power, phase) tuples); optionally a random-phase noise
    floor from ``numpy.random.default_rng(seed)`` seeds the remaining lines
    (cascade growth needs nonzero seeds in a coherent model)."""
    n = grid.n_waves
    A0 = np.zeros(n, dtype=np.complex128)
    if noise_floor_W > 0.0:
        rng = np.random.default_rng(seed)
        A0 += np.sqrt(noise_floor_W) * np.exp(2j * np.pi * rng.random(n))
    for j, spec in pump_lines.items():
        if not (0 <= int(j) < n):
            raise ValueError(f"pump line index {j} outside comb of {n} lines")
        if isinstance(spec, (tuple, list)):
            p, ph = float(spec[0]), float(spec[1])
        else:
            p, ph = float(spec), 0.0
        if p < 0:
            raise ValueError("pump line power must be >= 0")
        A0[int(j)] = np.sqrt(p) * np.exp(1j * ph)
    return A0


def comb_spectrum_db(A: np.ndarray, *, floor_dbw: float = -200.0) -> np.ndarray:
    """Per-line power spectrum in dBW with a floor (for plotting)."""
    P = np.abs(np.asarray(A)) ** 2
    return 10.0 * np.log10(np.maximum(P, 10 ** (floor_dbw / 10.0)))


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------

def _prepare(cfg: SimulationConfig, length_unit: str, coupling: str):
    """Validate a comb solve: ``(precision, integrator, dz_m, n_steps,
    length scale)``."""
    validate_config(cfg)
    reject_non_ode(cfg, "the comb engines")
    if coupling not in VALID_COUPLINGS:
        raise ValueError(f"coupling must be one of {VALID_COUPLINGS}, got {coupling!r}")
    scale = length_scale_to_m(length_unit)
    dz_m = float(cfg.dz) * scale
    n_steps = int(round(float(cfg.z_max) * scale / dz_m))
    return validate_precision(cfg.precision), cfg.integrator.lower(), dz_m, n_steps, scale


def _reject_df32_trajectory(precision: str) -> None:
    if precision == "df32":
        raise ValueError(
            "precision='df32' is reduce-mode only for combs: use "
            "solve_comb_batch (it computes P_max/A_end, not trajectories); "
            "for trajectories use 'x64' or 'x32'"
        )


def _batch_state(A0, cdt: torch.dtype, device: torch.device) -> torch.Tensor:
    if not isinstance(A0, torch.Tensor):
        A0 = torch.from_numpy(np.array(A0, dtype=np.complex128))
    A0 = A0.to(device=device, dtype=cdt)
    if A0.ndim != 2:
        raise ValueError(f"A0 must have shape (B, N), got {tuple(A0.shape)}")
    return A0


def _tensor(v, rdt: torch.dtype, device: torch.device) -> torch.Tensor:
    """A coefficient (number, array or tensor) as an ``rdt`` tensor on
    ``device``; arrays are copied (a broadcast view is read-only)."""
    v = v if isinstance(v, torch.Tensor) else np.array(v, dtype=np.float64)
    return as_f64(v).to(device, rdt)


def _lanes(coeffs: NWaveCoeffs, B: int, N: int, rdt: torch.dtype, device: torch.device):
    """``(gamma (B,), alpha (B,), beta_lin (B, N))`` tensors of ``rdt`` on
    ``device``: scalars and ``(N,)`` beta broadcast (``nwave.py:680-682``)."""
    def lane(v, shape):
        return _tensor(v, rdt, device).broadcast_to(shape).contiguous()

    return lane(coeffs.gamma, (B,)), lane(coeffs.alpha, (B,)), lane(coeffs.beta_lin, (B, N))


def run_comb_simulation(
    cfg: SimulationConfig,
    coeffs: NWaveCoeffs,
    A0,
    *,
    length_unit: str = "m",
    unroll: int = 2,
    coupling: str = "fft",
    z0: float = 0.0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Integrate a comb over [z0, z0 + z_max]; returns host ``(z, A (S+1,
    N))``.

    ``cfg.integrator`` selects rk4/ab4/abm4 or adaptive rk45 (output on the
    decimated save grid).  ``z0`` (in ``length_unit``) supports
    checkpoint/resume: the comb equation is autonomous, so ``z0`` only
    offsets the returned grid; pass the last saved row as ``A0`` and its
    coordinate as ``z0``.  Plain torch on ``device`` (``None``: the CUDA
    card); ``unroll`` is accepted for API parity and has no effect.
    """
    precision, integrator, dz_m, n_steps, scale = _prepare(cfg, length_unit, coupling)
    z0 = float(z0)
    if not np.isfinite(z0):
        raise ValueError("z0 must be finite")
    if np.ndim(A0) != 1:
        raise ValueError("A0 must be a 1-D array of N complex line amplitudes")
    _reject_df32_trajectory(precision)
    device = resolve_device(device)
    rdt, cdt = dtypes_for(precision)
    y0 = torch.as_tensor(np.asarray(A0, dtype=np.complex128), device=device).to(cdt)
    params = NWaveCoeffs(*(_tensor(v, rdt, device)
                           for v in (coeffs.gamma, coeffs.alpha, coeffs.beta_lin)))
    rhs = make_rhs_nwave(coupling)
    save_every = int(cfg.save_every)
    if integrator == "rk45":
        # the trailing n_steps % save_every span (z_final): integrated, unsaved, ok only
        z_grid, z_final = save_grid(dz_m, n_steps, save_every)
        res = integrate_adaptive_grid(
            rhs, y0, params, z_grid=z_grid, z_final=z_final, rtol=float(cfg.rtol),
            atol=float(cfg.atol), max_steps_per_segment=int(cfg.max_steps))
        z_out = z_grid / scale
    else:
        res = integrate_fixed_grid(
            rhs, y0, params, z0=0.0, dz=dz_m, n_steps=n_steps, save_every=save_every,
            check_nan=bool(cfg.check_nan), method=integrator)
        z_out = _host(res.z_saved).astype(np.float64) / scale
    if cfg.check_nan and not bool(res.ok):
        raise FloatingPointError("NaN or Inf detected during comb integration")
    return z0 + z_out, _host(res.y_saved.to(torch.complex128))


def solve_comb_batch_trajectories(
    cfg: SimulationConfig,
    coeffs: NWaveCoeffs,
    A0,
    *,
    length_unit: str = "m",
    unroll: int = 2,
    coupling: str = "fft",
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched comb solve returning full decimated trajectories
    ``(z (S+1,), A (B, S+1, N) complex, ok (B,))`` as host arrays -- use
    :func:`solve_comb_batch` for large sweeps.  ``cfg.integrator`` selects
    rk4/ab4/abm4 or rk45.  Plain torch on ``device`` (``None``: the CUDA
    card); ``unroll`` has no effect."""
    precision, integrator, dz_m, n_steps, scale = _prepare(cfg, length_unit, coupling)
    _reject_df32_trajectory(precision)
    device = resolve_device(device)
    rdt, cdt = dtypes_for(precision)
    y0 = _batch_state(A0, cdt, device)
    B, N = y0.shape
    params = NWaveCoeffs(*_lanes(coeffs, B, N, rdt, device))
    rhs = make_rhs_nwave(coupling)
    save_every = int(cfg.save_every)
    z_grid, z_final = save_grid(dz_m, n_steps, save_every)
    if integrator == "rk45":
        res = integrate_adaptive_grid(
            rhs, y0, params, z_grid=z_grid, z_final=z_final, rtol=float(cfg.rtol),
            atol=float(cfg.atol), max_steps_per_segment=int(cfg.max_steps), batch_ndim=1)
    else:
        res = integrate_fixed_grid(
            rhs, y0, params, z0=0.0, dz=dz_m, n_steps=n_steps, save_every=save_every,
            check_nan=True, method=integrator, batch_ndim=1)
    return z_grid / scale, _host(res.y_saved.to(torch.complex128)), _host(res.ok)


def _check_mxu_precision(mxu_precision: str) -> None:
    if mxu_precision in ("x3", "default"):
        raise ValueError(
            f"mxu_precision={mxu_precision!r} selects a TPU bf16 dot split, which the "
            "CUDA kernels do not have: they sum in the working precision; use 'highest'")
    if mxu_precision != "highest":
        raise ValueError(f"mxu_precision must be 'highest', got {mxu_precision!r}")


def solve_comb_batch(
    cfg: SimulationConfig,
    coeffs: NWaveCoeffs,
    A0,
    *,
    length_unit: str = "m",
    mesh=None,
    unroll: int = 2,
    coupling: str = "fft",
    engine: str = "auto",
    mxu_precision: str = "highest",
    device=None,
):
    """Solve B independent combs in one batched solve.

    ``A0`` is ``(B, N)`` complex; ``coeffs`` fields broadcast or carry a
    leading B axis (``gamma``/``alpha`` scalars or ``(B,)``, ``beta_lin``
    ``(N,)`` or ``(B, N)``).  Returns host ``(P_max (B, N), A_final (B, N),
    ok (B,))``: per-line running max power over the saved samples (row 0
    included) and the state at the last saved grid point; trailing
    ``n_steps % save_every`` steps are integrated (they can clear ``ok``) but
    not observed.

    ``engine`` (the JAX package's 'scan' is 'torch' here, its 'pallas' is
    'cuda'):

    - ``'auto'``: on a CUDA device the kernels -- ``csrc/comb_rk.cu`` for
      rk4/ab4/abm4, ``csrc/comb_rk45.cu`` for rk45; ``x64`` and ``df32`` in
      fp64, ``x32`` in fp32.  The three couplings compute the same sum;
      both kernels evaluate it through FFTs in their own bodies, so they
      ignore ``coupling``.  On any other device the plain torch versions run.
    - ``'torch'``: the plain torch versions on ``device``, honouring
      ``coupling``.
    - ``'cuda'``: the kernels; a non-CUDA device raises.

    ``df32`` is rk4 only, as in the JAX package.  ``cfg.check_nan`` applies
    to the fixed-step methods; the adaptive solve always masks a failed
    lane.  The rk45 error is controlled by ``cfg.rtol``/``atol`` down to the
    working precision's accumulation floor, which grows with the cascade's
    gain ``gamma P z``: below it, per-line weak powers need ``x64``/``df32``
    (see the JAX docstring for its measured floors).  ``mxu_precision``
    accepts only 'highest' (API parity); ``mesh`` must be None;
    ``unroll`` has no effect.  ``device=None`` means the CUDA card.
    """
    from ..ops import cuda_comb, cuda_comb_adaptive   # they import this module

    precision, integrator, dz_m, n_steps, _scale = _prepare(cfg, length_unit, coupling)
    if engine not in VALID_ENGINES:
        raise ValueError(f"engine must be one of {VALID_ENGINES}, got {engine!r}")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported: multi-device solves land with ROADMAP slice I "
            "(torch.distributed batch split)")
    _check_mxu_precision(mxu_precision)
    if precision == "df32" and integrator != "rk4":
        raise ValueError(
            "precision='df32' comb solves are fixed-step rk4 only "
            "(as in the JAX package; use 'x64' for the other integrators)")
    device = resolve_device(device)
    if engine == "cuda" and device.type != "cuda":
        raise ValueError(f"engine='cuda' needs a CUDA device, got {device}")

    rdt, cdt = dtypes_for(precision)
    y0 = _batch_state(A0, cdt, device)
    B, N = y0.shape
    lanes = _lanes(coeffs, B, N, rdt, device)
    kw = dict(dz_m=dz_m, n_steps=n_steps, save_every=int(cfg.save_every))
    use_kernel = device.type == "cuda" and engine in ("auto", "cuda")
    if integrator == "rk45":
        kw.update(rtol=float(cfg.rtol), atol=float(cfg.atol), max_steps=int(cfg.max_steps))
        if use_kernel:
            r = cuda_comb_adaptive.solve_comb_batch_rk45_cuda(y0, *lanes, **kw)
        else:
            r = cuda_comb_adaptive.solve_comb_batch_rk45_torch(y0, *lanes, coupling=coupling, **kw)
    else:
        kw.update(integrator=integrator, check_nan=bool(cfg.check_nan))
        if use_kernel:
            r = cuda_comb.solve_comb_batch_cuda(y0, *lanes, **kw)
        else:
            r = cuda_comb.solve_comb_batch_torch(y0, *lanes, coupling=coupling, **kw)
    return (_host(r.P_max.to(torch.float64)), _host(r.A_end.to(torch.complex128)),
            _host(r.ok))
