"""Differentiable solver surface and gradient-based parameter calibration.

Counterpart of the JAX package's ``parallel/calibrate.py``, with the same
names, signatures (plus ``device``) and numbers:

- :func:`make_gain_model` -- ``gain_db(RHSCoeffs)``, the signal gain at the
  last saved grid point, differentiable by ``torch.autograd`` in every
  coefficient; a field may be a scalar or a ``(B,)`` tensor, so one call
  covers a whole grid (the JAX package ``vmap``s);
- :func:`fit_gain_curve` -- calibrate ``(gamma, alpha, delta_beta offset)``
  against a measured gain-vs-mismatch curve by full-batch adam through the
  integrator, or, with ``precision='df32'``, the JAX package's hybrid: the
  adam explore, then a derivative-free Levenberg-Marquardt polish whose
  residuals run through the production batch engine (``sweep.solve_batch``);
- :func:`make_launch_gain_model`, :func:`power_transfer_db_per_db` and
  :func:`phase_transfer_db_per_rad` -- the gain differentiated in the
  launch powers and phases;
- :func:`make_pulse_model` and :func:`fit_pulse_spectrum` -- the GNLSE on
  the production split-step stepper (``models/gnlse._chunk_strang``) and a
  fit of (gamma, beta_n) to an output power spectrum.

Where the gradients come from.  The 4-wave models integrate through
``ops/cuda_tangent.rk4_end_state``: on the card, one launch of
``csrc/fwm4_tangent.cu`` computes the rotating-frame RK4 state and its
tangents along the directions the caller differentiates (3 coefficients
for a fit, 8 launch components for a transfer), and the backward contracts
with them; on the CPU its plain version does the same in torch.  That is
the exact derivative of the same discrete RK4 map ``jax.grad`` differentiates
in the JAX package (``lax.scan`` through ``integrate_reduce`` with
``check_nan=False``), so both packages agree to rounding.  ``frame='lab'``
has no kernel: it runs plain torch autograd through
``ops/integrators.integrate_reduce`` and the lab-frame RHS.  The pulse
models run plain torch autograd through the GNLSE stepper on the device,
as no kernel of either package has a backward.

Precision tiers.  ``None`` is ``'x64'`` on the card too: the H100 has FP64
(the JAX package's x32 default and its x64 refusal on a TPU backend are
rules of the TPU and are not copied).  ``'x32'`` runs float32.  The model
functions (``make_*_model``) refuse ``'df32'`` with the JAX message, which points to the
hybrid.  In the hybrid, the explore runs at x64 (through the tangent kernel
on the card) and the polish through ``sweep.solve_batch``: at ``'df32'`` on
the card (the fp64 4-wave kernel, one batched 7-variant launch an LM
iteration and one a trial step), at ``'x64'`` plain torch on the CPU, as the
JAX package's CPU branch runs it.

The adam steps are ``optax.adam(optax.cosine_decay_schedule(lr, max(steps,
1)))`` in optax's own order of operations (:class:`_Adam`), so the loss
histories of the two packages agree step for step.  Measurement
convention: every model measures at the LAST SAVED grid point,
``floor(n_steps / save_every) * save_every`` steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import SimulationConfig, validate_config
from ..models.fwm4 import make_initial_amplitudes
from ..models.gnlse import _tensor
from ..ops.cuda_tangent import rk4_end_state
from ..ops.rhs import RHSCoeffs, make_rhs_yaman, rhs_yaman_autonomous
from ..utils.checks import resolve_device
from ..utils.precision import complex_dtype, real_dtype, validate_precision


def _resolve_precision(precision: Optional[str], what: str) -> str:
    """``None`` means ``'x64'`` (the card has FP64); ``'df32'`` raises, as
    in the JAX package, pointing to the hybrid of :func:`fit_gain_curve`."""
    prec = validate_precision("x64" if precision is None else precision)
    if prec == "df32":
        raise ValueError(
            f"{what} does not support precision='df32': reverse-mode AD "
            "through the compensated two-float tape still accumulates the "
            "backward pass in plain f32, so it cannot beat the x32 gradient "
            "noise floor -- use 'x32' here, or fit_gain_curve("
            "precision='df32') for the matched-tolerance hybrid (x32 "
            "explore + derivative-free LM polish on the df32 engine)"
        )
    return prec


def _observed_steps(cfg: SimulationConfig) -> int:
    """Steps to the last SAVED grid point (framework convention)."""
    n_steps = int(round(float(cfg.z_max) / float(cfg.dz)))
    n_obs = (n_steps // int(cfg.save_every)) * int(cfg.save_every)
    if n_obs < 1:
        raise ValueError(
            f"no saved grid points: {n_steps} steps with "
            f"save_every={cfg.save_every}"
        )
    return n_obs


def _end_state(rhs, coef, y0, *, dz: float, n_steps: int):
    """The state after ``n_steps`` RK4 steps of ``(B, 4)`` lanes with the
    coefficients ``coef (B, 3)``, differentiable in both: the tangent
    kernel (or its plain version) for the rotating-frame RHS, plain torch
    autograd through ``integrate_reduce`` for the lab frame's."""
    if rhs is rhs_yaman_autonomous:
        return rk4_end_state(coef, y0, dz_m=dz, n_steps=n_steps)
    from ..ops.integrators import integrate_reduce

    res = integrate_reduce(
        rhs, y0, RHSCoeffs(coef[:, 0], coef[:, 1], coef[:, 2]), z0=0.0, dz=dz,
        n_steps=n_steps, save_every=n_steps, reduce_init=None,
        reduce_fn=lambda acc, _y: acc, check_nan=False, batch_ndim=1,
    )
    return res.y_final


def make_gain_model(
    cfg: SimulationConfig,
    *,
    p_in,
    phase_in=None,
    frame: str = "rotating",
    wave: int = 2,
    precision: Optional[str] = None,
    device=None,
):
    """Build a differentiable ``gain_db(coeffs: RHSCoeffs) -> dB`` for the
    launch condition ``(p_in, phase_in)``: signal-power gain at the LAST
    SAVED grid point (the point ``sweep.solve_batch`` reports as
    ``A_end``).  The fields of ``coeffs`` are scalars or ``(B,)`` tensors
    (numbers or arrays are taken as constants); the result has their
    broadcast shape and is differentiable by ``torch.autograd`` in every
    field.  On the card, one call is one launch of the tangent kernel, with
    a direction for each coefficient that needs a gradient.
    ``frame='rotating'`` (autonomous) is the natural gauge for
    differentiation; powers are frame-invariant.

    ``precision``: 'x64' (the default) or 'x32'."""
    validate_config(cfg)
    prec = _resolve_precision(precision, "make_gain_model")
    rhs = make_rhs_yaman(frame=frame)
    rdt, cdt = real_dtype(prec), complex_dtype(prec)
    device = resolve_device(device)
    A0h = np.asarray(make_initial_amplitudes(p_in, phase_in), dtype=np.complex128)
    n_steps = _observed_steps(cfg)
    p0 = float(np.abs(A0h[wave]) ** 2)
    if p0 <= 0.0:
        raise ValueError(f"wave {wave} carries no input power")
    A0 = torch.tensor(A0h, device=device).to(cdt)
    p0_t = torch.tensor(p0, dtype=rdt, device=device)
    dz = float(cfg.dz)

    def gain_db(coeffs: RHSCoeffs):
        fields = torch.broadcast_tensors(*(_tensor(v, rdt, device) for v in (
            coeffs.gamma, coeffs.alpha, coeffs.delta_beta)))
        shape = fields[0].shape
        coef = torch.stack([f.reshape(-1) for f in fields], dim=-1)
        y_end = _end_state(rhs, coef, A0.expand(coef.shape[0], 4), dz=dz, n_steps=n_steps)
        p_out = y_end[:, wave].abs() ** 2
        return (10.0 * torch.log10(p_out / p0_t)).reshape(shape)

    return gain_db


@dataclasses.dataclass(frozen=True)
class FitResult:
    """Gradient-descent calibration result (host scalars/arrays)."""

    params: Dict[str, float]       # fitted gamma, alpha, dbeta_offset
    loss_db2: float                # final mean squared residual [dB^2]
    loss_history: np.ndarray       # (n_steps+1,)
    gain_db: np.ndarray            # model curve at the fitted parameters
    n_steps: int

    def __repr__(self) -> str:
        p = ", ".join(f"{k}={v:.6g}" for k, v in self.params.items())
        return f"FitResult({p}, rms={np.sqrt(self.loss_db2):.4g} dB)"


class _Adam:
    """``optax.adam(optax.cosine_decay_schedule(learning_rate, max(steps,
    1)))`` on one parameter tensor, in optax's order of operations:
    ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, the bias
    corrections ``1 - b^count`` (count after the increment) divided out,
    ``u = mu_hat / (sqrt(nu_hat + eps_root) + eps)``, and the update
    ``theta + (-lr(count)) u`` with the schedule read at the count before
    it, ``lr(c) = lr0 * 0.5 (1 + cos(pi min(c, T) / T))``.  Defaults b1 0.9,
    b2 0.999, eps 1e-8, eps_root 0."""

    B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0

    def __init__(self, learning_rate: float, steps: int, like: torch.Tensor):
        self.lr0 = float(learning_rate)
        self.decay_steps = float(max(int(steps), 1))
        self.mu = torch.zeros_like(like)
        self.nu = torch.zeros_like(like)
        self.count = 0

    def rate(self, count: int) -> float:
        c = min(float(count), self.decay_steps)
        return self.lr0 * (0.5 * (1 + math.cos(math.pi * c / self.decay_steps)))

    def _scalar(self, v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=self.mu.dtype, device=self.mu.device)

    def update(self, theta: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        self.mu = (1 - self.B1) * grad + self.B1 * self.mu
        self.nu = (1 - self.B2) * (grad * grad) + self.B2 * self.nu
        step = self.rate(self.count)
        self.count += 1
        mu_hat = self.mu / self._scalar(1 - self.B1 ** self.count)
        nu_hat = self.nu / self._scalar(1 - self.B2 ** self.count)
        u = mu_hat / (torch.sqrt(nu_hat + self.EPS_ROOT) + self.EPS)
        return theta + self._scalar(-step) * u


def _adam_fit(loss_fn, theta: torch.Tensor, *, steps: int, learning_rate: float,
              tol_db: float):
    """The JAX package's fit loop: ``history[0]`` is the loss at theta_0,
    each step appends its pre-update loss, and the fit stops early below
    ``tol_db**2``.  Returns ``(theta, history)``."""
    opt = _Adam(learning_rate, steps, theta)
    history = []
    for _ in range(int(steps)):
        th = theta.detach().requires_grad_(True)
        loss = loss_fn(th)
        (grad,) = torch.autograd.grad(loss, th)
        value = float(loss.detach())
        if not history:
            history.append(value)   # the loss at theta_0: the first step's own
        theta = opt.update(theta.detach(), grad)
        history.append(value)
        if not np.isfinite(history[-1]):
            raise FloatingPointError(
                f"fit diverged at step {len(history) - 1}; lower the "
                f"learning rate or improve init"
            )
        if history[-1] < float(tol_db) ** 2:
            break
    if not history:
        with torch.no_grad():
            history.append(float(loss_fn(theta)))
    return theta.detach(), history


def _engine_gain_curve_fn(
    cfg: SimulationConfig,
    db_grid: np.ndarray,
    *,
    p_in,
    phase_in,
    wave: int,
    forward_precision: str,
    device=None,
):
    """Batched ``theta_stack -> gain_db (K, N)`` through the PRODUCTION
    batch engine (``sweep.solve_batch``): K normalized parameter triples
    ``(log_gamma, alpha*z, dphi*z)`` x N grid points solved as ONE
    ``K*N``-instance call -- the matched-tolerance forward of the LM
    polish (the fp64 4-wave kernel on the card, the plain version on the
    CPU).  Measures at the last SAVED grid point like
    :func:`make_gain_model`."""
    from . import sweep as _sweep

    # rk4 fixed-step: the stepper make_gain_model differentiates; the
    # polish must measure the SAME model as the explore stage
    cfg_fwd = dataclasses.replace(
        cfg, precision=forward_precision, integrator="rk4"
    )
    A0h = np.asarray(make_initial_amplitudes(p_in, phase_in),
                     dtype=np.complex128)
    p0 = float(np.abs(A0h[wave]) ** 2)
    if p0 <= 0.0:
        raise ValueError(f"wave {wave} carries no input power")
    db = np.asarray(db_grid, dtype=np.float64)
    n_pts = db.shape[0]
    z_span = float(cfg.z_max)

    def gain_curves(theta_stack: np.ndarray) -> np.ndarray:
        th = np.asarray(theta_stack, dtype=np.float64).reshape(-1, 3)
        k = th.shape[0]
        gam = np.repeat(np.exp(th[:, 0]), n_pts)
        alp = np.repeat(th[:, 1] / z_span, n_pts)
        dbe = (db[None, :] + (th[:, 2] / z_span)[:, None]).reshape(-1)
        res = _sweep.solve_batch(
            cfg_fwd,
            RHSCoeffs(gamma=gam, alpha=alp, delta_beta=dbe),
            np.tile(A0h[None, :], (k * n_pts, 1)),
            device=device,
        )
        if not bool(np.all(res.ok)):
            raise FloatingPointError(
                "matched-tolerance polish forward diverged (NaN lanes); "
                "the explore stage left the basin -- improve init or "
                "lower the learning rate"
            )
        return (10.0 * np.log10(res.P_end[:, wave] / p0)).reshape(k, n_pts)

    return gain_curves


def _lm_polish_gain_curve(
    gain_curves,
    theta0: np.ndarray,
    target: np.ndarray,
    *,
    tol_db: float,
    max_iters: int = 12,
    h: float = 1e-3,
) -> Tuple[np.ndarray, list]:
    """Derivative-free Levenberg-Marquardt on the dB residual in the
    normalized (log_gamma, alpha*z, dphi*z) coordinates: the Jacobian is
    central finite differences with step ``h`` (optimal for a <=1e-9
    forward: truncation ~h^2 and roundoff ~eps/h balance near 1e-3), and
    every iteration's 7 variants (center + 6 offsets) evaluate as one
    batched engine call.  Returns the polished theta and the per-iteration
    rms^2 history (accepted steps only)."""
    th = np.asarray(theta0, dtype=np.float64).copy()
    tgt = np.asarray(target, dtype=np.float64)
    lam = 1e-3
    history: list = []
    eye = np.eye(3)
    stack0 = np.concatenate(
        [np.zeros((1, 3))] + [s * h * eye[k:k + 1]
                              for k in range(3) for s in (+1.0, -1.0)],
        axis=0,
    )
    for _ in range(int(max_iters)):
        curves = gain_curves(th[None, :] + stack0)
        r = curves[0] - tgt
        loss = float(np.mean(r ** 2))
        history.append(loss)
        if loss < float(tol_db) ** 2:
            break
        jac = np.stack(
            [(curves[1 + 2 * k] - curves[2 + 2 * k]) / (2.0 * h)
             for k in range(3)], axis=1,
        )
        jtj = jac.T @ jac
        jtr = jac.T @ r
        accepted = False
        for _try in range(4):
            delta = np.linalg.solve(
                jtj + lam * np.diag(np.maximum(np.diag(jtj), 1e-12)), -jtr
            )
            cand = th + delta
            loss_c = float(np.mean((gain_curves(cand[None, :])[0]
                                    - tgt) ** 2))
            if np.isfinite(loss_c) and loss_c < loss:
                th, lam, accepted = cand, max(lam * 0.3, 1e-12), True
                break
            lam *= 10.0
        if not accepted or float(np.linalg.norm(delta)) < 1e-10:
            break
    history.append(float(np.mean((gain_curves(th[None, :])[0]
                                  - tgt) ** 2)))
    return th, history


def fit_gain_curve(
    cfg: SimulationConfig,
    *,
    delta_beta_grid,
    measured_gain_db,
    p_in,
    phase_in=None,
    init: Optional[Dict[str, float]] = None,
    steps: int = 600,
    learning_rate: float = 0.05,
    tol_db: float = 1e-4,
    wave: int = 2,
    precision: Optional[str] = None,
    polish_iters: int = 12,
    device=None,
) -> FitResult:
    """Calibrate ``gamma`` [1/(W m)], ``alpha`` [1/m] and a constant
    phase-mismatch offset [1/m] against a measured gain-vs-mismatch curve
    (the fiber-characterization inverse problem): full-batch adam on the
    mean squared dB residual, with gradients through the whole RK4 solve
    at every grid point (one launch of the tangent kernel a step on the
    card); stops early when the rms residual drops below ``tol_db``.

    Parameters are optimized in NORMALIZED coordinates so adam's uniform
    step size is meaningful: log gamma (positivity), alpha * z_max (total
    nepers) and dbeta_offset * z_max (total mismatch phase) are all O(1)
    for realistic fibers.  ``init`` defaults to ``{'gamma': 1e-2,
    'alpha': 0.0, 'dbeta_offset': 0.0}`` (physical units).

    ``precision``: 'x64' (the default) or 'x32' for the adam fit;
    ``'df32'`` is the matched-tolerance hybrid: the x64 adam explore, then
    ``polish_iters`` of derivative-free Levenberg-Marquardt whose residuals
    and central-difference Jacobian run through ``sweep.solve_batch`` (the
    fp64 4-wave kernel on the card, the plain version at x64 on the CPU),
    one batched 7-variant solve an iteration."""
    device = resolve_device(device)
    if precision is not None and validate_precision(precision) == "df32":
        on_cpu = device.type == "cpu"
        explore = fit_gain_curve(
            cfg, delta_beta_grid=delta_beta_grid,
            measured_gain_db=measured_gain_db, p_in=p_in,
            phase_in=phase_in, init=init, steps=steps,
            learning_rate=learning_rate, tol_db=tol_db, wave=wave,
            precision="x64", device=device,
        )
        z_span = float(cfg.z_max)
        theta0 = np.array([
            np.log(explore.params["gamma"]),
            explore.params["alpha"] * z_span,
            explore.params["dbeta_offset"] * z_span,
        ])
        gain_curves = _engine_gain_curve_fn(
            cfg, np.asarray(delta_beta_grid, dtype=np.float64),
            p_in=p_in, phase_in=phase_in, wave=wave,
            forward_precision="x64" if on_cpu else "df32", device=device,
        )
        target_np = np.asarray(measured_gain_db, dtype=np.float64)
        theta, lm_hist = _lm_polish_gain_curve(
            gain_curves, theta0, target_np,
            tol_db=tol_db, max_iters=polish_iters,
        )
        curve = gain_curves(theta[None, :])[0]
        return FitResult(
            params={
                "gamma": float(np.exp(theta[0])),
                "alpha": float(theta[1]) / z_span,
                "dbeta_offset": float(theta[2]) / z_span,
            },
            loss_db2=float(np.mean((curve - target_np) ** 2)),
            loss_history=np.concatenate(
                [explore.loss_history, np.asarray(lm_hist)]),
            gain_db=curve,
            n_steps=explore.n_steps + len(lm_hist) - 1,
        )

    prec = _resolve_precision(precision, "fit_gain_curve")
    rdt = real_dtype(prec)
    db_np = np.asarray(delta_beta_grid, dtype=np.float64)
    tg_np = np.asarray(measured_gain_db, dtype=np.float64)
    if db_np.shape != tg_np.shape or db_np.ndim != 1:
        raise ValueError("delta_beta_grid and measured_gain_db must be "
                         "matching 1-D arrays")
    init = dict(init or {})
    g0 = float(init.pop("gamma", 1e-2))
    a0 = float(init.pop("alpha", 0.0))
    o0 = float(init.pop("dbeta_offset", 0.0))
    if init:
        raise ValueError(f"unknown init keys: {sorted(init)}")
    if g0 <= 0.0:
        raise ValueError("init gamma must be positive")

    z_span = float(cfg.z_max)
    gain_fn = make_gain_model(cfg, p_in=p_in, phase_in=phase_in, wave=wave,
                              precision=prec, device=device)
    db_grid = torch.tensor(db_np, dtype=rdt, device=device)
    target = torch.tensor(tg_np, dtype=rdt, device=device)
    inv_span = torch.tensor(1.0 / z_span, dtype=rdt, device=device)

    def gain_curve(th):
        # th: (log_gamma, alpha * z_max, dbeta_offset * z_max)
        return gain_fn(RHSCoeffs(gamma=torch.exp(th[0]), alpha=th[1] * inv_span,
                                 delta_beta=db_grid + th[2] * inv_span))

    def loss_fn(th):
        return torch.mean((gain_curve(th) - target) ** 2)

    theta = torch.tensor([np.log(g0), a0 * z_span, o0 * z_span], dtype=rdt, device=device)
    # cosine-decayed adam: the late small steps settle the nearly
    # degenerate (gamma, alpha) valley instead of orbiting it
    theta, history = _adam_fit(loss_fn, theta, steps=steps, learning_rate=learning_rate,
                               tol_db=tol_db)
    th = theta.cpu().numpy()
    fitted = {
        "gamma": float(np.exp(th[0])),
        "alpha": float(th[1]) / z_span,
        "dbeta_offset": float(th[2]) / z_span,
    }
    with torch.no_grad():
        curve = gain_curve(theta).cpu().numpy().astype(np.float64)
    # loss AT the returned parameters (each step reports its pre-update loss)
    loss_final = float(np.mean((curve - target.cpu().numpy()) ** 2))
    return FitResult(
        params=fitted,
        loss_db2=loss_final,
        loss_history=np.asarray(history),
        gain_db=curve,
        n_steps=len(history) - 1,
    )


def make_pulse_model(
    cfg: SimulationConfig,
    grid,
    A0,
    *,
    nl=None,
    alpha_1_m: float = 0.0,
    precision: Optional[str] = None,
    device=None,
):
    """Differentiable GNLSE propagation on the PRODUCTION split-step
    stepper (``models.gnlse._chunk_strang`` in ``cfg.save_every``-sized
    chunks, as the batched solver steps): returns ``field(theta) -> (T,)
    complex`` at the last saved grid point, with ``theta = {'gamma': 1/(W
    m), 'beta2': s^2/m[, 'beta3': ...]}``, differentiable by
    ``torch.autograd`` in every parameter, the dispersion orders included
    (the frequency-domain phase is built from them on each call).  Plain
    torch on ``device``: the SSFM kernels have no backward."""
    from ..models.gnlse import _cast_nl, _chunk_strang, _lin_factor

    validate_config(cfg)
    prec = _resolve_precision(precision, "make_pulse_model")
    rdt = real_dtype(prec)
    device = resolve_device(device)
    om = torch.tensor(np.asarray(grid.omega(), dtype=np.float64), dtype=rdt, device=device)
    A0h = np.asarray(A0, dtype=np.complex128).reshape(-1)
    if A0h.shape[0] != om.shape[0]:
        raise ValueError(
            f"A0 has {A0h.shape[0]} samples but the grid has {om.shape[0]}"
        )
    A0c = torch.complex(torch.tensor(A0h.real, dtype=rdt, device=device),
                        torch.tensor(A0h.imag, dtype=rdt, device=device))
    save_every = int(cfg.save_every)
    n_chunks = _observed_steps(cfg) // save_every
    nl_c = _cast_nl(nl, rdt, device)
    h = torch.tensor(float(cfg.dz), dtype=rdt, device=device)
    alpha = torch.tensor(float(alpha_1_m), dtype=rdt, device=device)

    def field(theta):
        lin = torch.zeros_like(om)
        for key, val in theta.items():
            if key == "gamma":
                continue
            if not key.startswith("beta"):
                raise ValueError(f"unknown theta key {key!r}")
            n = int(key[4:])
            fact = torch.tensor(float(math.factorial(n)), dtype=rdt, device=device)
            lin = lin + (_tensor(val, rdt, device) / fact) * om ** n
        gamma = _tensor(theta["gamma"], rdt, device)
        Lh = _lin_factor(alpha, lin, 0.5 * h)
        Lf = _lin_factor(alpha, lin, h)
        y = A0c
        for _ in range(n_chunks):
            y = _chunk_strang(save_every, y, Lh, Lf, gamma, h, nl_c)
        return y

    return field


def fit_pulse_spectrum(
    cfg: SimulationConfig,
    grid,
    A0,
    measured_db,
    *,
    init: Dict[str, float],
    nl=None,
    alpha_1_m: float = 0.0,
    steps: int = 300,
    learning_rate: float = 0.05,
    tol_db: float = 1e-4,
    floor_db: float = -50.0,
    precision: Optional[str] = None,
    device=None,
):
    """Calibrate GNLSE parameters against a measured OUTPUT POWER SPECTRUM
    (dB, fft-ordered, any reference level): adam through the split-step
    solve in normalized coordinates -- log gamma and span-integrated
    dispersion phases ``beta_n * om_char^n * z / n!`` are all O(1), with
    ``om_char`` the input pulse's rms spectral width.  Bins more than
    ``floor_db`` below the spectral peak are excluded from the residual
    (measurement floor), and the dB intercept is free (solved analytically
    at each evaluation).  Returns a :class:`FitResult` whose ``gain_db``
    field carries the fitted model spectrum [dB].

    This is a LOCAL optimizer on a nonconvex landscape: a power spectrum
    of a (time-)symmetric input is nearly invariant under beta2 -> -beta2,
    so initialize inside the right dispersion-sign basin."""
    prec = _resolve_precision(precision, "fit_pulse_spectrum")
    rdt = real_dtype(prec)
    device = resolve_device(device)
    target = torch.tensor(np.asarray(measured_db, dtype=np.float64), dtype=rdt,
                          device=device)
    om = np.asarray(grid.omega(), dtype=np.float64)
    if tuple(target.shape) != om.shape:
        raise ValueError("measured_db must be (T,) on the fft-ordered grid")
    init = dict(init)
    if "gamma" not in init or float(init["gamma"]) <= 0.0:
        raise ValueError("init must contain a positive 'gamma'")
    orders = sorted(int(k[4:]) for k in init if k.startswith("beta"))
    if set(init) - {"gamma"} - {f"beta{n}" for n in orders}:
        raise ValueError(f"unknown init keys: {sorted(set(init) - {'gamma'})}")

    z = float(cfg.z_max)
    # normalize dispersion orders by the PULSE bandwidth, not the grid
    # Nyquist: the rms input width makes beta_n * om_char^n * z / n! an
    # O(1) phase
    S0 = np.abs(np.fft.fft(np.asarray(A0, dtype=np.complex128)
                           .reshape(-1))) ** 2
    om_char = float(np.sqrt((S0 * om ** 2).sum() / S0.sum()))
    if not om_char > 0.0:
        raise ValueError("input pulse has zero spectral width")
    scales = [om_char ** n * z / math.factorial(n) for n in orders]
    scale_t = [torch.tensor(s, dtype=rdt, device=device) for s in scales]
    field = make_pulse_model(cfg, grid, A0, nl=nl, alpha_1_m=alpha_1_m,
                             precision=prec, device=device)
    mask = target > (float(target.max()) + float(floor_db))
    n_mask = mask.sum()
    s_floor = 1e-300 if prec == "x64" else 1e-37

    def spectrum_db(theta_n):
        # theta_n: (log_gamma, beta{n}_n for n in orders)
        theta = {"gamma": torch.exp(theta_n[0])}
        for j, n in enumerate(orders):
            theta[f"beta{n}"] = theta_n[1 + j] / scale_t[j]
        y = field(theta)
        S = torch.abs(torch.fft.fft(y)) ** 2
        return 10.0 * torch.log10(torch.clamp(S, min=s_floor))

    def _offset(model_db):
        # free dB intercept: the optimal constant offset is the masked mean
        # residual, solved analytically per evaluation
        return ((target - model_db) * mask).sum() / n_mask

    def loss_fn(theta_n):
        m_db = spectrum_db(theta_n)
        r = torch.where(mask, m_db + _offset(m_db) - target, 0.0)
        return (r ** 2).sum() / n_mask

    theta_n = torch.tensor([np.log(float(init["gamma"]))]
                           + [float(init[f"beta{n}"]) * s for n, s in zip(orders, scales)],
                           dtype=rdt, device=device)
    theta_n, history = _adam_fit(loss_fn, theta_n, steps=steps,
                                 learning_rate=learning_rate, tol_db=tol_db)
    th = theta_n.cpu().numpy()
    fitted = {"gamma": float(np.exp(th[0]))}
    for j, n in enumerate(orders):
        fitted[f"beta{n}"] = float(th[1 + j]) / scales[j]
    with torch.no_grad():
        m_db = spectrum_db(theta_n)
        model_db = (m_db + _offset(m_db)).cpu().numpy().astype(np.float64)
    mask_np = mask.cpu().numpy()
    loss_final = float(
        (((model_db - target.cpu().numpy()) * mask_np) ** 2).sum() / mask_np.sum()
    )
    return FitResult(
        params=fitted,
        loss_db2=loss_final,
        loss_history=np.asarray(history),
        gain_db=model_db,
        n_steps=len(history) - 1,
    )


def make_launch_gain_model(
    cfg: SimulationConfig,
    *,
    frame: str = "rotating",
    wave: int = 2,
    precision: Optional[str] = None,
    device=None,
):
    """Like :func:`make_gain_model` but differentiable in the LAUNCH
    CONDITION too: returns ``gain_db(p_in (4,), phase_in (4,), coeffs)``
    with the initial amplitudes built from them (``sqrt(p) e^{i phase}``)
    -- the surface behind the pump-noise budget (``d gain_dB /
    d pump_dB`` and ``d gain_dB / d phase``).  On the card, one call is one
    launch of the tangent kernel along the 8 launch components (and the
    coefficients that need a gradient).  Measures at the last saved grid
    point, like the batched engines."""
    validate_config(cfg)
    prec = _resolve_precision(precision, "make_launch_gain_model")
    rhs = make_rhs_yaman(frame=frame)
    rdt = real_dtype(prec)
    device = resolve_device(device)
    n_steps = _observed_steps(cfg)
    dz = float(cfg.dz)
    # the tiny floor keeps d sqrt/dp finite at exactly-zero launches
    # (vacuum idler): the dB-transfer of a zero-power wave is 0 anyway
    p_floor = 1e-300 if prec == "x64" else 1e-30

    def gain_db(p_in, phase_in, coeffs: RHSCoeffs):
        p = _tensor(p_in, rdt, device)
        ph = _tensor(phase_in, rdt, device)
        A0 = torch.sqrt(torch.clamp(p, min=p_floor)) * torch.complex(
            torch.cos(ph), torch.sin(ph))
        coef = torch.stack([_tensor(v, rdt, device).reshape(()) for v in (
            coeffs.gamma, coeffs.alpha, coeffs.delta_beta)])[None]
        y_end = _end_state(rhs, coef, A0[None], dz=dz, n_steps=n_steps)
        p_out = y_end[0, wave].abs() ** 2
        return 10.0 * torch.log10(p_out / p[wave])

    return gain_db


def power_transfer_db_per_db(
    cfg: SimulationConfig,
    *,
    gamma: float,
    alpha: float,
    delta_beta: float,
    p_in,
    phase_in=None,
    wave: int = 2,
    precision: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """EXACT small-signal transfer of each launch power to the measured
    gain, in dB-per-dB (``d gain_dB / d P_j_dB``), by one gradient through
    the solver: the pump-RIN transfer coefficients of the amplifier.
    Oracle: the Monte-Carlo regression
    (``noise.pump_rin_transfer_monte_carlo``) reproduces these slopes
    within its standard errors."""
    prec = _resolve_precision(precision, "power_transfer_db_per_db")
    rdt = real_dtype(prec)
    device = resolve_device(device)
    gain = make_launch_gain_model(cfg, wave=wave, precision=prec, device=device)
    coeffs = RHSCoeffs(*(torch.tensor(float(v), dtype=rdt, device=device)
                         for v in (gamma, alpha, delta_beta)))
    p = np.asarray(p_in, dtype=np.float64).reshape(4)
    ph = _tensor(np.zeros(4) if phase_in is None else phase_in, rdt, device)
    if p[wave] <= 0.0:
        raise ValueError(f"wave {wave} carries no input power")
    pv = torch.tensor(p, dtype=rdt, device=device, requires_grad=True)
    (g,) = torch.autograd.grad(gain(pv, ph, coeffs), pv)
    g = g.cpu().numpy().astype(np.float64)
    # dG/d(10 log10 P_j) = dG/dP_j * P_j ln(10)/10; exactly-zero launches
    # have zero dB-transfer by definition
    return np.where(p > 0.0, g * p * (np.log(10.0) / 10.0), 0.0)


def phase_transfer_db_per_rad(
    cfg: SimulationConfig,
    *,
    gamma: float,
    alpha: float,
    delta_beta: float,
    p_in,
    phase_in=None,
    wave: int = 2,
    precision: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """EXACT transfer of each launch PHASE to the measured gain [dB/rad]
    by one gradient through the solver -- zero for a phase-insensitive
    amplifier (signal-only seed: the PIA gain cannot depend on any
    absolute phase), large for the PSA near its max-gain phase crossing
    (the phase-noise budget of phase-sensitive operation)."""
    prec = _resolve_precision(precision, "phase_transfer_db_per_rad")
    rdt = real_dtype(prec)
    device = resolve_device(device)
    gain = make_launch_gain_model(cfg, wave=wave, precision=prec, device=device)
    coeffs = RHSCoeffs(*(torch.tensor(float(v), dtype=rdt, device=device)
                         for v in (gamma, alpha, delta_beta)))
    p = _tensor(np.asarray(p_in, dtype=np.float64).reshape(4), rdt, device)
    ph0 = np.zeros(4) if phase_in is None else np.asarray(phase_in, dtype=np.float64)
    if float(p[wave]) <= 0.0:
        raise ValueError(f"wave {wave} carries no input power")
    phv = torch.tensor(ph0, dtype=rdt, device=device, requires_grad=True)
    (g,) = torch.autograd.grad(gain(p, phv, coeffs), phv)
    return g.cpu().numpy().astype(np.float64)
