"""Batched parameter sweeps: a whole gain spectrum in one batched solve.

Counterpart of the JAX package's ``parallel/sweep.py`` (reference sweep
layer ``scan_mismtach.py``): :func:`solve_batch`,
:func:`solve_batch_trajectories`, :func:`gain_and_dbeta_spectrum`,
:func:`gain_spectrum`, :func:`dbeta_spectrum`, :func:`mismatch_scan`,
:func:`psa_phase_sweep` and :func:`gain_map_power_wavelength`.

- The (B,) parameter grid is built as float64 tensors on the solve's device
  (frequency plans, dbeta), then one batched solve integrates every point.
- ``device=None`` means the CUDA card; without one it raises (pass
  ``device='cpu'`` for the CPU).
- ``engine`` picks the solver.  On a CUDA device the rotating frame runs the
  hand-written kernels: ``ops/cuda_solver.solve_batch_cuda`` for
  rk4/ab4/abm4 and ``ops/cuda_adaptive.solve_batch_rk45_cuda`` for rk45.
  The lab frame has no kernel (the JAX package has none either) and runs
  plain torch on the card.  On any other device the plain torch versions
  run.  ``df32`` runs in float64 at every integrator (the JAX package's
  two-float engines are not part of the port).
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
from ..models.fwm4 import VALID_FRAMES, _to_phase_array, _to_power_array
from ..ops.adaptive import integrate_adaptive_grid
from ..ops.cuda_adaptive import (
    rk45_reduce, save_grid, solve_batch_rk45_cuda, solve_batch_rk45_torch,
)
from ..ops.cuda_solver import (
    reduce_pmax_last,
    solve_batch_cuda,
    solve_batch_torch,
)
from ..ops.dispersion import DispersionParams, delta_beta_from_omegas, delta_beta_symmetric
from ..ops.frequency_plan import omega_from_lambda
from ..ops.integrators import integrate_fixed_grid
from ..ops.phase_matching import PhaseMatchingConfig, PhaseMatchingMethod
from ..ops.rhs import RHSCoeffs, rhs_yaman, rhs_yaman_autonomous, rotating_to_lab
from ..utils.checks import as_f64, resolve_device
from ..utils.precision import dtypes_for, validate_precision
from ..utils.units import length_scale_to_m, wavelength_scale
from .mesh import fetch_global, mesh_device, shard_batch

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
class GainMapResult:
    """A 2-D (pump power x wavelength) gain map with per-cell ok mask.

    Iterates as ``(x, pump_powers, gain)``."""

    x: np.ndarray             # (Nl,) wavelengths [return_wavelength_unit]
    pump_powers: np.ndarray   # (Np,) [W]
    gain: np.ndarray          # (Np, Nl), NaN where failed/invalid
    ok: np.ndarray            # (Np, Nl) bool
    gain_unit: str
    elapsed_s: float
    points_per_s: float

    def __iter__(self):
        return iter((self.x, self.pump_powers, self.gain))

    @property
    def best_index(self):
        """(ip, il) of the maximum finite gain; a descriptive ``ValueError``
        when every cell failed."""
        if not np.any(np.isfinite(self.gain)):
            raise ValueError(
                "best_index undefined: every gain-map cell failed "
                "(gain is all-NaN; check the ok mask)"
            )
        return np.unravel_index(int(np.nanargmax(self.gain)), self.gain.shape)


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


def _batch_inputs(cfg: SimulationConfig, coeffs: RHSCoeffs, A0, *, frame: str, mesh, device):
    """Validate a batched solve's arguments and put its inputs on its
    device (with a mesh, this process's first slot): ``(device, A0 (B, 4)
    complex, gamma, alpha, dbeta (B,) real)`` in the dtypes of
    ``cfg.precision``."""
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave sweep engine")
    if frame not in VALID_FRAMES:
        raise ValueError(f"frame must be one of {VALID_FRAMES}, got {frame!r}")
    device = mesh_device(mesh, device)
    rdt, cdt = dtypes_for(validate_precision(cfg.precision))
    if not isinstance(A0, torch.Tensor):
        A0 = torch.from_numpy(np.array(A0))  # a writable copy of any numpy view
    A0 = A0.to(device=device, dtype=cdt)
    if A0.ndim != 2 or A0.shape[1] != 4:
        raise ValueError(f"A0 must have shape (B, 4), got {tuple(A0.shape)}")
    B = A0.shape[0]

    def lanes(v):
        return as_f64(v, device=device).to(device).broadcast_to((B,)).to(rdt).contiguous()

    return device, A0, lanes(coeffs.gamma), lanes(coeffs.alpha), lanes(coeffs.delta_beta)


def solve_batch(
    cfg: SimulationConfig,
    coeffs: RHSCoeffs,
    A0,
    *,
    frame: str = "rotating",
    mesh=None,
    unroll: int = 4,
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

    ``cfg.integrator`` picks the kernel: ``fwm4_rk.cu`` for rk4/ab4/abm4,
    ``fwm4_rk45.cu`` for rk45 (with ``cfg.rtol``/``atol``/``max_steps``;
    ``check_nan`` does not apply, the adaptive solve always masks a failed
    lane).  ``device=None`` means the CUDA card.  ``mesh``
    (``parallel/mesh.Mesh``) splits the batch over its slots: padded to a
    multiple of them, one launch a slot on the slot's device, every launch
    before any fetch, gathered and trimmed; ``device`` is then None or one
    the mesh uses.  ``unroll`` (the JAX scan's unroll factor) is accepted
    for API parity and has no effect.
    """
    if engine not in VALID_ENGINES:
        raise ValueError(f"engine must be one of {VALID_ENGINES}, got {engine!r}")
    device, A0, gamma, alpha, dbeta = _batch_inputs(cfg, coeffs, A0, frame=frame, mesh=mesh,
                                                    device=device)
    if engine == "cuda" and device.type != "cuda":
        raise ValueError(f"engine='cuda' needs a CUDA device, got {device}")
    if engine == "cuda" and frame != "rotating":
        raise ValueError("engine='cuda' implements the rotating frame only; "
                         "use engine='auto' or 'torch' for frame='lab'")
    integrator = cfg.integrator.lower()
    B = A0.shape[0]

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
                padded(A0), frame=frame, mesh=mesh, engine=engine, device=device,
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
    kw = dict(dz_m=float(cfg.dz), n_steps=n_steps, save_every=int(cfg.save_every))
    use_kernel = frame == "rotating" and device.type == "cuda" and engine in ("auto", "cuda")
    if integrator == "rk45":
        kw.update(rtol=float(cfg.rtol), atol=float(cfg.atol), max_steps=int(cfg.max_steps))
    else:
        kw.update(integrator=integrator, check_nan=bool(cfg.check_nan))

    def solve(_dev, A0, gamma, alpha, dbeta):
        """One launch (or plain solve) over the rows given, not fetched."""
        if frame == "rotating":
            if integrator == "rk45":
                solver = solve_batch_rk45_cuda if use_kernel else solve_batch_rk45_torch
            else:
                solver = solve_batch_cuda if use_kernel else solve_batch_torch
            r = solver(A0, gamma, alpha, dbeta, **kw)
            pmax, A_end, ok = r.P_max, r.A_end, r.ok
        elif integrator == "rk45":
            pmax, A_end, ok, _na, _nr = rk45_reduce(
                rhs_yaman, A0, RHSCoeffs(gamma, alpha, dbeta), **kw)
        else:
            pmax, A_end, ok = reduce_pmax_last(
                rhs_yaman, A0, RHSCoeffs(gamma, alpha, dbeta), **kw)
        return pmax.to(torch.float64), A_end.to(torch.complex128), ok

    t0 = time.perf_counter()
    # host result assembly: one copy of each summary (a mesh: each shard's,
    # after every shard was launched)
    if mesh is None:
        pmax, A_end, ok = (t.cpu().numpy() for t in solve(device, A0, gamma, alpha, dbeta))
    else:
        pmax, A_end, ok = shard_batch(mesh, solve, (A0, gamma, alpha, dbeta))
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
# Trajectory-mode batched solve (moderate B; full decimated trajectories)
# ---------------------------------------------------------------------------

def solve_batch_trajectories(
    cfg: SimulationConfig,
    coeffs: RHSCoeffs,
    A0,
    *,
    frame: str = "rotating",
    mesh=None,
    unroll: int = 4,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched solve returning full decimated trajectories
    ``(z (S+1,), A (B, S+1, 4) complex, ok (B,))``, as host numpy arrays.

    ``cfg.integrator`` may be 'rk4', 'ab4', 'abm4' or 'rk45'.  Plain torch
    on ``device`` (``None``: the CUDA card): neither package has a kernel
    for this mode.  ``df32`` runs in float64 (the JAX package refuses it
    here: it has no two-float trajectory engine).  ``mesh`` splits the
    batch over its slots as in :func:`solve_batch` (the trajectories gather
    back to the host); ``unroll`` is accepted for API parity and has no
    effect.
    """
    device, A0, gamma, alpha, dbeta = _batch_inputs(cfg, coeffs, A0, frame=frame, mesh=mesh,
                                                    device=device)
    rhs = rhs_yaman if frame == "lab" else rhs_yaman_autonomous
    n_steps = int(round(cfg.z_max / cfg.dz))
    save_every = int(cfg.save_every)

    def solve(_dev, A0, gamma, alpha, dbeta):
        params = RHSCoeffs(gamma, alpha, dbeta)
        if cfg.integrator.lower() == "rk45":
            # the trailing n_steps % save_every span (z_final): integrated, unsaved, ok only
            z_grid, z_final = save_grid(float(cfg.dz), n_steps, save_every)
            res = integrate_adaptive_grid(
                rhs, A0, params, z_grid=z_grid, z_final=z_final, rtol=float(cfg.rtol),
                atol=float(cfg.atol), max_steps_per_segment=int(cfg.max_steps), batch_ndim=1,
            )
            z_out = z_grid
        else:
            res = integrate_fixed_grid(
                rhs, A0, params, z0=0.0, dz=float(cfg.dz), n_steps=n_steps,
                save_every=save_every, check_nan=bool(cfg.check_nan),
                method=cfg.integrator.lower(), batch_ndim=1,
            )
            z_out = res.z_saved.to(torch.float64)
        y_saved = res.y_saved
        if frame == "rotating":
            y_saved = rotating_to_lab(res.z_saved, y_saved,
                                      RHSCoeffs(None, None, params.delta_beta[:, None]))
        return z_out, y_saved.to(torch.complex128), res.ok

    if mesh is None:
        return tuple(fetch_global(t) for t in solve(device, A0, gamma, alpha, dbeta))
    return shard_batch(mesh, solve, (A0, gamma, alpha, dbeta), out_axes=(None, 0, 0))


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


def _cfg_in_m(cfg: SimulationConfig, scale_to_m: float) -> SimulationConfig:
    """``cfg`` with ``z_max``/``dz`` converted to meters."""
    if scale_to_m == 1.0:
        return cfg
    return dataclasses.replace(cfg, z_max=cfg.z_max * scale_to_m, dz=cfg.dz * scale_to_m)


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
    (``None``: the CUDA card); ``engine`` and ``mesh`` as in
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

    device = mesh_device(mesh, device)
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

    cfg_m = _cfg_in_m(cfg, scale_to_m)
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
    stack for this, scan_mismtach.py:433-470, is broken).  Computed on
    ``device`` (``None``: the CUDA card)."""
    lam3 = np.asarray(list(lambda_signal_m), dtype=float)
    device = resolve_device(device)
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


def mismatch_scan(
    *,
    cfg: SimulationConfig,
    gamma: float,
    alpha: float,
    p_in: Sequence[float],
    delta_beta_values: Sequence[float],
    phase_in: Optional[Sequence[float]] = None,
    gain_mode: GainMode = "end",
    gain_unit: str = "linear",
    length_unit: str = "km",
    frame: str = "rotating",
    mesh=None,
    verbose: bool = False,
    engine: str = "auto",
    device=None,
) -> Tuple[SweepResult, SweepResult]:
    """Sweep an explicit list of phase-mismatch values (one dbeta per
    instance) and return the (signal_gain, idler_transfer) sweeps -- the
    batched realization of the reference's stale ``scan_mismatch_seeded_signal``
    (``scan_mismtach.py:43-259``).  Gs = P3_metric/P3(0), Gi = P4_metric/P3(0)
    (the idler normalized to the signal seed, since its own seed may be 0).
    ``device`` (``None``: the CUDA card), ``engine`` and ``mesh`` as in
    :func:`solve_batch`."""
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave sweep engine")
    gu = _norm_gain_unit(gain_unit)
    if gain_mode not in VALID_GAIN_MODES:
        raise ValueError(f"Unknown gain_mode={gain_mode!r}. Use 'end' or 'max'.")
    db = np.asarray(list(delta_beta_values), dtype=float)
    if db.ndim != 1 or db.size == 0:
        raise ValueError("delta_beta_values must be a non-empty 1D sequence")
    p0 = _to_power_array(p_in)
    if p0[2] <= 0.0:
        raise ValueError("p_in[2] (signal seed power) must be > 0 to define gain")
    ph0 = _to_phase_array(phase_in)

    scale_to_m = length_scale_to_m(length_unit)
    B = db.size
    A0 = np.broadcast_to(np.sqrt(p0).astype(np.complex128) * np.exp(1j * ph0), (B, 4))
    coeffs = RHSCoeffs(
        gamma=np.full(B, float(gamma) / scale_to_m),
        alpha=np.full(B, float(alpha) / scale_to_m),
        delta_beta=db / scale_to_m,
    )
    res = solve_batch(
        _cfg_in_m(cfg, scale_to_m), coeffs, A0, frame=frame, mesh=mesh, engine=engine,
        progress=_default_progress if verbose else None, device=device,
    )
    P3 = res.P_max[:, 2] if gain_mode == "max" else res.P_end[:, 2]
    P4 = res.P_max[:, 3] if gain_mode == "max" else res.P_end[:, 3]
    gs = _gain_from_power(P3, float(p0[2]), res.ok, gu)
    gi = _gain_from_power(P4, float(p0[2]), res.ok, gu)
    pts = B / res.elapsed_s if res.elapsed_s > 0 else float("inf")
    if verbose:
        print(f"[mismatch_scan] {B} points in {res.elapsed_s:.3f} s ({pts:.1f} pt/s)")
    sig = SweepResult(x=db, gain=gs, dbeta=None, ok=res.ok, gain_unit=gu,
                      elapsed_s=res.elapsed_s, points_per_s=pts)
    idl = SweepResult(x=db, gain=gi, dbeta=None, ok=res.ok, gain_unit=gu,
                      elapsed_s=res.elapsed_s, points_per_s=pts)
    return sig, idl


def psa_phase_sweep(
    *,
    cfg: SimulationConfig,
    gamma: float,
    alpha: float,
    p_in: Sequence[float],
    signal_phases: Sequence[float],
    delta_beta: float = 0.0,
    base_phase_in: Optional[Sequence[float]] = None,
    omega: Optional[Sequence[float]] = None,
    dispersion: Optional[DispersionParams] = None,
    phase_matching_cfg: Optional[PhaseMatchingConfig] = None,
    gain_mode: GainMode = "end",
    gain_unit: str = "dB",
    length_unit: str = "m",
    frame: str = "rotating",
    mesh=None,
    engine: str = "auto",
    device=None,
) -> SweepResult:
    """Phase-sensitive amplification: gain vs input *signal phase* with both
    pumps and (optionally) an idler seed fixed -- BASELINE.json config 3.
    Each phase point is an instance with the signal seed rotated, A3(0) =
    sqrt(P3) e^{i phi}, all in one batched solve on ``device`` (``None``:
    the CUDA card)."""
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave sweep engine")
    gu = _norm_gain_unit(gain_unit)
    phases = np.asarray(list(signal_phases), dtype=float)
    if phases.ndim != 1 or phases.size == 0:
        raise ValueError("signal_phases must be a non-empty 1D sequence")
    p0 = _to_power_array(p_in)
    if p0[2] <= 0.0:
        raise ValueError("p_in[2] (signal seed power) must be > 0 to define gain")
    ph_base = _to_phase_array(base_phase_in)
    device = mesh_device(mesh, device)

    scale_to_m = length_scale_to_m(length_unit)
    if phase_matching_cfg is not None or dispersion is not None:
        pm = (phase_matching_cfg or PhaseMatchingConfig()).scaled(scale_to_m)
        if pm.method == PhaseMatchingMethod.PROVIDED:
            pdb = np.asarray(pm.provided_delta_beta, dtype=float)
            if pdb.size != 1:
                raise ValueError(
                    "psa_phase_sweep needs a scalar provided_delta_beta "
                    f"(all phase instances share one dbeta); got shape {pdb.shape}"
                )
            db_m = float(pdb.reshape(()))
        else:
            if omega is None:
                raise ValueError(
                    "omega is required when using dispersion-aware phase matching"
                )
            om = as_f64(np.asarray(list(omega), dtype=float)[None, :], device=device)
            disp_m = dispersion.scaled(scale_to_m).to(device) if dispersion is not None else None
            db_m = float(_batched_delta_beta(om, disp_m, pm)[0])
    else:
        db_m = float(delta_beta) / scale_to_m

    B = phases.size
    ph = np.broadcast_to(ph_base, (B, 4)).copy()
    ph[:, 2] = ph_base[2] + phases
    A0 = np.sqrt(p0)[None, :] * np.exp(1j * ph)
    coeffs = RHSCoeffs(
        gamma=np.full(B, float(gamma) / scale_to_m),
        alpha=np.full(B, float(alpha) / scale_to_m),
        delta_beta=np.full(B, db_m),
    )
    res = solve_batch(_cfg_in_m(cfg, scale_to_m), coeffs, A0.astype(np.complex128),
                      frame=frame, mesh=mesh, engine=engine, device=device)
    P3 = res.P_max[:, 2] if gain_mode == "max" else res.P_end[:, 2]
    gain = _gain_from_power(P3, float(p0[2]), res.ok, gu)
    pts = B / res.elapsed_s if res.elapsed_s > 0 else float("inf")
    return SweepResult(x=phases, gain=gain, dbeta=None, ok=res.ok, gain_unit=gu,
                       elapsed_s=res.elapsed_s, points_per_s=pts)


def gain_map_power_wavelength(
    *,
    cfg: SimulationConfig,
    lambda_p1_m: float,
    lambda_p2_m: float,
    lambda_signal_m: Sequence[float],
    pump_powers_W: Sequence[float],
    gamma: float,
    alpha: float,
    p_seed: Tuple[float, float] = (1e-7, 0.0),
    phase_in: Optional[Sequence[float]] = None,
    dispersion: Optional[DispersionParams] = None,
    phase_matching_cfg: Optional[PhaseMatchingConfig] = None,
    length_unit: str = "m",
    return_wavelength_unit: str = "nm",
    gain_unit: str = "dB",
    gain_mode: GainMode = "max",
    frame: str = "rotating",
    mesh=None,
    engine: str = "auto",
    verbose: bool = False,
    device=None,
) -> GainMapResult:
    """2-D scan: (pump power) x (signal wavelength) -> gain map, every cell
    in one batched solve on ``device`` (``None``: the CUDA card) --
    BASELINE.json config 4 (``mesh`` as in :func:`solve_batch`).  Cell
    ``(ip, il)`` is instance ``ip * Nl + il``.
    Persist it with ``io_fwm.save_gain_map_npz``."""
    validate_config(cfg)
    reject_non_ode(cfg, "the 4-wave sweep engine")
    gu = _norm_gain_unit(gain_unit)
    lam3 = np.asarray(list(lambda_signal_m), dtype=float)
    pows = np.asarray(list(pump_powers_W), dtype=float)
    if np.any(pows < 0) or not np.all(np.isfinite(pows)):
        raise ValueError("pump_powers_W must be finite and non-negative")
    p_sig, p_idl = float(p_seed[0]), float(p_seed[1])
    if p_sig <= 0:
        raise ValueError("p_seed[0] (signal seed) must be > 0 to define gain")
    ph0 = _to_phase_array(phase_in)
    device = mesh_device(mesh, device)

    scale_to_m = length_scale_to_m(length_unit)
    disp_m = dispersion.scaled(scale_to_m).to(device) if dispersion is not None else None
    pm_cfg = phase_matching_cfg or PhaseMatchingConfig(
        method=PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4
    )
    omegas, valid_l = _batched_plan_from_wavelengths(
        float(lambda_p1_m), float(lambda_p2_m), as_f64(lam3, device=device)
    )
    dbeta_l = _batched_delta_beta(omegas, disp_m, pm_cfg.scaled(scale_to_m)).cpu().numpy()

    Np, Nl = pows.size, lam3.size
    B = Np * Nl
    valid_flat = np.tile(valid_l.cpu().numpy(), Np)
    p_grid = np.repeat(pows, Nl)
    P0 = np.stack([p_grid, p_grid, np.full(B, p_sig), np.full(B, p_idl)], axis=-1)
    A0 = np.sqrt(P0) * np.exp(1j * ph0)[None, :]
    coeffs = RHSCoeffs(
        gamma=np.full(B, float(gamma) / scale_to_m),
        alpha=np.full(B, float(alpha) / scale_to_m),
        delta_beta=np.tile(dbeta_l, Np),
    )
    res = solve_batch(
        _cfg_in_m(cfg, scale_to_m), coeffs, A0.astype(np.complex128), frame=frame,
        mesh=mesh, engine=engine, progress=_default_progress if verbose else None,
        device=device,
    )
    P3 = res.P_max[:, 2] if gain_mode == "max" else res.P_end[:, 2]
    ok = res.ok & valid_flat
    gain = _gain_from_power(P3, p_sig, ok, gu)
    pts = B / res.elapsed_s if res.elapsed_s > 0 else float("inf")
    return GainMapResult(
        x=lam3 * wavelength_scale(return_wavelength_unit),
        pump_powers=pows,
        gain=gain.reshape(Np, Nl),
        ok=ok.reshape(Np, Nl),
        gain_unit=gu,
        elapsed_s=res.elapsed_s,
        points_per_s=pts,
    )
