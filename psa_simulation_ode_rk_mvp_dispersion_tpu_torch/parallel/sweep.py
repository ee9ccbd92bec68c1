"""Batched parameter sweeps: a whole gain spectrum in one batched solve.

Counterpart of the JAX package's ``parallel/sweep.py`` (reference sweep
layer ``scan_mismtach.py``): :func:`solve_batch`, :func:`gain_and_dbeta_spectrum`,
:func:`gain_spectrum` and :func:`dbeta_spectrum`.

- The (B,) parameter grid is built as float64 tensors on the solve's device
  (frequency plans, dbeta), then one batched solve integrates every point.
- ``engine`` picks the solver.  On a CUDA device the rotating frame runs the
  hand-written kernel (``ops/cuda_solver.solve_batch_cuda``); the lab frame
  has no kernel (the JAX package has none either) and runs plain torch on
  the card.  On any other device the plain torch version runs.
- Failure semantics: invalid points (inferred idler frequency <= 0) are
  masked up front, and NaN/Inf during integration clears the per-instance
  ``ok`` flag; both surface as NaN gain.
- Results come back to the host as numpy arrays, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SimulationConfig, validate_config, reject_non_ode
from ..constants import c as C0, TWO_PI
from ..models.fwm4 import RK45_NOT_PORTED, VALID_FRAMES, _to_phase_array, _to_power_array
from ..ops.cuda_solver import (
    reduce_pmax_last,
    solve_batch_cuda,
    solve_batch_torch,
)
from ..ops.dispersion import DispersionParams, delta_beta_from_omegas, delta_beta_symmetric
from ..ops.frequency_plan import omega_from_lambda
from ..ops.phase_matching import PhaseMatchingConfig, PhaseMatchingMethod
from ..ops.rhs import RHSCoeffs, rhs_yaman
from ..utils.checks import as_f64
from ..utils.precision import dtypes_for, validate_precision
from ..utils.units import length_scale_to_m, wavelength_scale

GainMode = str  # "end" | "max"
VALID_GAIN_MODES = ("end", "max")
VALID_GAIN_UNITS = ("db", "linear")
VALID_ENGINES = ("auto", "torch", "cuda")


# ---------------------------------------------------------------------------
# Result containers (host-side data)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BatchSolveResult:
    """Per-instance summaries of a batched solve (host numpy)."""

    P_max: np.ndarray    # (B, 4) max power over saved samples [W]
    P_end: np.ndarray    # (B, 4) power at last saved sample [W]
    A_end: np.ndarray    # (B, 4) complex lab-frame state at last saved sample
    ok: np.ndarray       # (B,) bool
    elapsed_s: float
    instances_per_s: float


@dataclass(frozen=True)
class SweepResult:
    """A 1-D sweep: x grid + gain (+ optional dbeta) with NaN for failures."""

    x: np.ndarray
    gain: np.ndarray
    dbeta: Optional[np.ndarray]
    ok: np.ndarray
    gain_unit: str
    elapsed_s: float
    points_per_s: float

    @property
    def best_index(self) -> int:
        if not np.any(np.isfinite(self.gain)):
            raise ValueError(
                "best_index undefined: every sweep point failed "
                "(gain is all-NaN; check the ok mask)"
            )
        return int(np.nanargmax(self.gain))


# ---------------------------------------------------------------------------
# The batched solver core
# ---------------------------------------------------------------------------

def _default_progress(done: int, total: int, elapsed: float) -> None:
    """Reference-style live instrumentation (scan_mismtach.py:162-180):
    elapsed total / avg per point / throughput, printed per dispatched chunk."""
    pts = done / elapsed if elapsed > 0 else float("inf")
    avg_ms = 1e3 * elapsed / max(done, 1)
    print(
        f"[sweep {done}/{total}] elapsed {elapsed:8.2f} s | "
        f"avg {avg_ms:7.3f} ms/pt | {pts:10.1f} pt/s",
        flush=True,
    )


def _resolve_device(device) -> torch.device:
    return torch.get_default_device() if device is None else torch.device(device)


def solve_batch(
    cfg: SimulationConfig,
    coeffs: RHSCoeffs,
    A0,
    *,
    frame: str = "rotating",
    mesh=None,
    engine: str = "auto",
    progress=None,
    progress_chunk: int = 16384,
    device=None,
) -> BatchSolveResult:
    """Solve B independent 4-wave instances in one batched solve.

    ``coeffs`` fields and ``A0`` share the leading batch dimension (scalars
    broadcast); all quantities are per meter (``cfg.z_max``/``cfg.dz`` in
    meters -- callers handle the unit boundary).

    ``engine``:

    - ``'auto'``: the CUDA kernel for the rotating frame on a CUDA device,
      plain torch otherwise (the lab frame has no kernel);
    - ``'torch'``: the plain torch version on ``device`` (for A/B on a card);
    - ``'cuda'``: the kernel; a non-CUDA device or the lab frame raise.

    ``device=None`` means ``torch.get_default_device()``.  ``mesh`` must be
    None: multi-device solves are not ported yet.
    """
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave sweep engine")
    integrator = cfg.integrator.lower()
    if integrator == "rk45":
        raise NotImplementedError(RK45_NOT_PORTED)
    if engine not in VALID_ENGINES:
        raise ValueError(f"engine must be one of {VALID_ENGINES}, got {engine!r}")
    if frame not in VALID_FRAMES:
        raise ValueError(f"frame must be one of {VALID_FRAMES}, got {frame!r}")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported: multi-device solves land with ROADMAP slice I "
            "(torch.distributed batch split)")
    device = _resolve_device(device)
    if engine == "cuda" and device.type != "cuda":
        raise ValueError(f"engine='cuda' needs a CUDA device, got {device}")
    if engine == "cuda" and frame != "rotating":
        raise ValueError("engine='cuda' implements the rotating frame only; "
                         "use engine='auto' or 'torch' for frame='lab'")
    rdt, cdt = dtypes_for(validate_precision(cfg.precision))

    if not isinstance(A0, torch.Tensor):
        A0 = torch.from_numpy(np.array(A0))  # a writable copy of any numpy view
    A0 = A0.to(device=device, dtype=cdt)
    if A0.ndim != 2 or A0.shape[1] != 4:
        raise ValueError(f"A0 must have shape (B, 4), got {tuple(A0.shape)}")
    B = A0.shape[0]

    def lanes(v):
        return as_f64(v, device=device).to(device).broadcast_to((B,)).to(rdt).contiguous()

    gamma, alpha, dbeta = lanes(coeffs.gamma), lanes(coeffs.alpha), lanes(coeffs.delta_beta)

    if progress is not None and B > int(progress_chunk):
        # Chunked dispatch with live instrumentation (reference
        # scan_mismtach.py:162-180); every chunk is padded to one shape.
        chunk = int(progress_chunk)
        t0 = time.perf_counter()
        parts = []
        for s in range(0, B, chunk):
            e = min(s + chunk, B)
            pad = chunk - (e - s)

            def padded(x):
                return torch.cat([x[s:e], x[e - 1:e].expand(pad, *x.shape[1:])])

            sub = solve_batch(
                cfg,
                RHSCoeffs(gamma=padded(gamma), alpha=padded(alpha), delta_beta=padded(dbeta)),
                padded(A0), frame=frame, engine=engine, device=device,
            )
            parts.append((sub, e - s))
            progress(e, B, time.perf_counter() - t0)
        elapsed = time.perf_counter() - t0
        return BatchSolveResult(
            P_max=np.concatenate([r.P_max[:n] for r, n in parts]),
            P_end=np.concatenate([r.P_end[:n] for r, n in parts]),
            A_end=np.concatenate([r.A_end[:n] for r, n in parts]),
            ok=np.concatenate([r.ok[:n] for r, n in parts]),
            elapsed_s=elapsed,
            instances_per_s=B / elapsed if elapsed > 0 else float("inf"),
        )

    n_steps = int(round(cfg.z_max / cfg.dz))
    kw = dict(dz_m=float(cfg.dz), n_steps=n_steps, save_every=int(cfg.save_every),
              integrator=integrator, check_nan=bool(cfg.check_nan))
    t0 = time.perf_counter()
    if frame == "rotating":
        use_kernel = device.type == "cuda" and engine in ("auto", "cuda")
        solve = solve_batch_cuda if use_kernel else solve_batch_torch
        r = solve(A0, gamma, alpha, dbeta, **kw)
        pmax, A_end, ok = r.P_max, r.A_end, r.ok
    else:
        pmax, A_end, ok = reduce_pmax_last(rhs_yaman, A0, RHSCoeffs(gamma, alpha, dbeta), **kw)
    # host result assembly: one copy of each summary
    pmax = pmax.to(torch.float64).cpu().numpy()
    A_end = A_end.to(torch.complex128).cpu().numpy()
    ok = ok.cpu().numpy()
    elapsed = time.perf_counter() - t0
    # not-ok lanes are frozen at their last finite state, which can be large
    # enough that |A|^2 overflows to inf -- fine (the ok mask governs use)
    with np.errstate(over="ignore"):
        P_end = np.abs(A_end) ** 2
    return BatchSolveResult(
        P_max=pmax, P_end=P_end, A_end=A_end, ok=ok, elapsed_s=elapsed,
        instances_per_s=B / elapsed if elapsed > 0 else float("inf"),
    )


# ---------------------------------------------------------------------------
# Frequency-plan batching helpers (masked, float64 tensors)
# ---------------------------------------------------------------------------

def _batched_plan_from_wavelengths(lam1: float, lam2: float, lam3: torch.Tensor):
    """(B,) lambda3 -> ((B, 4) omegas, (B,) valid mask).

    Points whose inferred idler frequency is non-positive are masked instead
    of raised (the batched analog of the reference's per-point try/except ->
    NaN, ``scan_mismtach.py:391-392``).
    """
    w1 = TWO_PI * C0 / float(lam1)
    w2 = TWO_PI * C0 / float(lam2)
    w3 = omega_from_lambda(lam3)
    w4 = w1 + w2 - w3
    valid = torch.isfinite(w3) & (w3 > 0) & torch.isfinite(w4) & (w4 > 0)
    w4_safe = torch.where(valid, w4, w3)  # placeholder keeps math finite
    om = torch.stack([torch.full_like(w3, w1), torch.full_like(w3, w2), w3, w4_safe], dim=-1)
    return om, valid


def _batched_delta_beta(
    omegas_m: torch.Tensor,
    disp_m: Optional[DispersionParams],
    pm_cfg: PhaseMatchingConfig,
) -> torch.Tensor:
    """Vectorized dbeta [1/m] for a (B, 4) plan."""
    if pm_cfg.method == PhaseMatchingMethod.PROVIDED:
        return as_f64(pm_cfg.provided_delta_beta, device=omegas_m.device).to(
            omegas_m.device).broadcast_to(omegas_m.shape[:-1]).clone()
    if disp_m is None:
        raise ValueError("dispersion must be provided unless method == 'provided'")
    if pm_cfg.method == PhaseMatchingMethod.GENERAL_TAYLOR:
        return delta_beta_from_omegas(
            omegas_m, disp_m, max_order=pm_cfg.max_order,
            atol=pm_cfg.atol, rtol=max(pm_cfg.rtol, 1e-9),
        )
    if pm_cfg.method == PhaseMatchingMethod.SYMMETRIC_EVEN:
        oc = 0.5 * (omegas_m[..., 0] + omegas_m[..., 1])
        od = 0.5 * (omegas_m[..., 0] - omegas_m[..., 1])
        Om = omegas_m[..., 2] - oc
        return delta_beta_symmetric(oc, od, Om, disp_m, even_orders=pm_cfg.even_orders)
    raise ValueError(f"Unsupported phase-matching method: {pm_cfg.method!r}")


def _gain_from_power(
    P_metric: np.ndarray, P3_0: float, ok: np.ndarray, gain_unit: str
) -> np.ndarray:
    g = np.where(ok, P_metric / P3_0, np.nan)
    g = np.where(np.isfinite(g) & (g > 0), g, np.nan)
    if gain_unit == "db":
        with np.errstate(invalid="ignore"):
            return 10.0 * np.log10(g)
    return g


def _norm_gain_unit(gain_unit: str) -> str:
    gu = str(gain_unit).strip().lower()
    if gu not in VALID_GAIN_UNITS:
        raise ValueError("gain_unit must be 'dB' or 'linear'")
    return gu


# ---------------------------------------------------------------------------
# Public sweep APIs
# ---------------------------------------------------------------------------

def gain_and_dbeta_spectrum(
    *,
    cfg: SimulationConfig,
    lambda_p1_m: float,
    lambda_p2_m: float,
    lambda_signal_m: Sequence[float],
    gamma: float,
    alpha: float,
    p_in: Sequence[float],
    phase_in: Optional[Sequence[float]] = None,
    dispersion: Optional[DispersionParams] = None,
    phase_matching_cfg: Optional[PhaseMatchingConfig] = None,
    length_unit: str = "m",
    return_wavelength_unit: str = "nm",
    gain_unit: str = "dB",
    gain_mode: GainMode = "max",
    frame: str = "rotating",
    mesh=None,
    compute_dbeta: bool = True,
    verbose: bool = False,
    engine: str = "auto",
    device=None,
) -> SweepResult:
    """Sweep the signal wavelength lambda3, computing max (or end) signal
    gain and (optionally) dbeta(lambda3) -- the batched re-design of the
    reference's ``plot_max_gain_and_dbeta_vs_lambda_signal``
    (``scan_mismtach.py:588-783``).

    All B wavelength points integrate in one batched solve on ``device``
    (``None``: ``torch.get_default_device()``); ``engine`` as in
    :func:`solve_batch`.
    """
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave sweep engine")
    gu = _norm_gain_unit(gain_unit)
    if gain_mode not in VALID_GAIN_MODES:
        raise ValueError(f"Unknown gain_mode={gain_mode!r}. Use 'end' or 'max'.")
    lam3 = np.asarray(list(lambda_signal_m), dtype=float)
    if lam3.ndim != 1 or lam3.size == 0:
        raise ValueError("lambda_signal_m must be a non-empty 1D sequence")
    if not np.all(np.isfinite(lam3)) or np.any(lam3 <= 0.0):
        raise ValueError("lambda_signal_m must contain finite positive wavelengths (m)")

    p0 = _to_power_array(p_in)
    if p0[2] <= 0.0:
        raise ValueError("p_in[2] (signal seed power) must be > 0 to define gain")
    ph0 = _to_phase_array(phase_in)

    device = _resolve_device(device)
    scale_to_m = length_scale_to_m(length_unit)

    disp_m = dispersion.scaled(scale_to_m).to(device) if dispersion is not None else None
    pm_cfg = phase_matching_cfg
    if pm_cfg is None:
        if disp_m is None:
            raise ValueError("Provide dispersion or an explicit phase_matching_cfg")
        pm_cfg = PhaseMatchingConfig(
            method=PhaseMatchingMethod.SYMMETRIC_EVEN, max_order=4,
            even_orders=(2, 4), atol=0.0, rtol=1e-12,
        )
    pm_cfg = pm_cfg.scaled(scale_to_m)

    omegas, valid = _batched_plan_from_wavelengths(
        float(lambda_p1_m), float(lambda_p2_m), as_f64(lam3, device=device)
    )
    dbeta_m = _batched_delta_beta(omegas, disp_m, pm_cfg)

    B = lam3.size
    a0 = np.sqrt(p0).astype(np.complex128) * np.exp(1j * ph0)
    A0 = torch.as_tensor(a0, device=device).expand(B, 4)

    cfg_m = cfg if scale_to_m == 1.0 else dataclasses.replace(
        cfg, z_max=cfg.z_max * scale_to_m, dz=cfg.dz * scale_to_m
    )
    coeffs = RHSCoeffs(
        gamma=torch.full((B,), float(gamma) / scale_to_m, dtype=torch.float64, device=device),
        alpha=torch.full((B,), float(alpha) / scale_to_m, dtype=torch.float64, device=device),
        delta_beta=dbeta_m,
    )
    res = solve_batch(
        cfg_m, coeffs, A0, frame=frame, mesh=mesh, engine=engine,
        progress=_default_progress if verbose else None, device=device,
    )
    valid = valid.cpu().numpy()
    P3_metric = res.P_max[:, 2] if gain_mode == "max" else res.P_end[:, 2]
    ok = res.ok & valid
    gain = _gain_from_power(P3_metric, float(p0[2]), ok, gu)

    dbeta_out = None
    if compute_dbeta:
        # report in 1/length_unit (consistent with gamma), like the reference
        dbeta_out = np.where(valid, dbeta_m.cpu().numpy() * scale_to_m, np.nan)

    x = lam3 * wavelength_scale(return_wavelength_unit)
    pts = B / res.elapsed_s if res.elapsed_s > 0 else float("inf")
    if verbose:
        print(
            f"[sweep] {B} points in {res.elapsed_s:.3f} s "
            f"({pts:.1f} pt/s, {B * int(round(cfg.z_max / cfg.dz))} {cfg.integrator} "
            "steps total)"
        )
    return SweepResult(
        x=x, gain=gain, dbeta=dbeta_out, ok=ok, gain_unit=gu,
        elapsed_s=res.elapsed_s, points_per_s=pts,
    )


def gain_spectrum(**kwargs) -> SweepResult:
    """Signal-wavelength gain sweep (no dbeta track): batched re-design of
    reference ``plot_max_signal_gain_vs_lambda_signal`` (scan_mismtach.py:262)."""
    kwargs.setdefault("compute_dbeta", False)
    return gain_and_dbeta_spectrum(**kwargs)


def dbeta_spectrum(
    *,
    lambda_p1_m: float,
    lambda_p2_m: float,
    lambda_signal_m: Sequence[float],
    dispersion: DispersionParams,
    phase_matching_cfg: Optional[PhaseMatchingConfig] = None,
    length_unit: str = "m",
    return_wavelength_unit: str = "nm",
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """dbeta(lambda3) alone, in the project-wide sign convention
    dbeta = beta(w3)+beta(w4)-beta(w1)-beta(w2) (the reference's helper
    stack for this, scan_mismtach.py:433-470, is broken)."""
    lam3 = np.asarray(list(lambda_signal_m), dtype=float)
    device = _resolve_device(device)
    scale_to_m = length_scale_to_m(length_unit)
    disp_m = dispersion.scaled(scale_to_m).to(device)
    pm_cfg = phase_matching_cfg or PhaseMatchingConfig(
        method=PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4
    )
    omegas, valid = _batched_plan_from_wavelengths(
        float(lambda_p1_m), float(lambda_p2_m), as_f64(lam3, device=device)
    )
    dbeta_m = _batched_delta_beta(omegas, disp_m, pm_cfg.scaled(scale_to_m))
    dbeta_out = np.where(valid.cpu().numpy(), dbeta_m.cpu().numpy() * scale_to_m, np.nan)
    return lam3 * wavelength_scale(return_wavelength_unit), dbeta_out
