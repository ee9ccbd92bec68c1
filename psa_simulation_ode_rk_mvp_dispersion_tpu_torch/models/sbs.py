"""FWM + stimulated Brillouin scattering (SBS): forward + backward waves.

Counterpart of the JAX package's ``models/sbs.py``.  Each forward wave A_j
drives a counter-propagating Stokes wave B_j (steady-state SBS, amplitude
form; Agrawal, Nonlinear Fiber Optics, ch. 9):

    dA_j/dz = FWM_RHS(A)_j - (gB/2) |B_j|^2 A_j
    dB_j/dz = +(alpha/2) B_j - (gB/2) |A_j|^2 B_j        (B travels in -z)

with the two-point boundary conditions A(0) = A0, B(L) = B_L.  The FWM part
is the rotating-frame 4-wave RHS, so the system stays autonomous.

The boundary-value problem is solved by relaxation, as in the JAX package:
repeat (1) integrate A forward over [0, L] with B(z) frozen, (2) integrate
B backward over [L, 0] with A(z) frozen, each a fixed-step RK4 whose frozen
field is sampled at the step's ends and midpoint, until the sup-norm change
of B drops to ``tol`` or the sweep budget is spent.  ``damping`` < 1
under-relaxes, B <- (1-w) B_old + w B_new, which restores convergence above
the SBS threshold.

Neither package has a kernel for this model: it runs as plain torch on the
chosen device.  Each sweep is sequential in z, and the opposing field is
frozen for the whole sweep, so its powers at every step's ends and midpoint
are computed in one vectorized operation before the sweep.  The forward
sweep is then a loop of RK4 steps on the ``(B, 4)`` complex state (held
as ``(B, 2, 2)`` pairs).  The
backward equation is linear in B with a real frozen coefficient, so each of
its RK4 steps multiplies B by a real factor that depends on the frozen
powers alone: the factors of all steps are computed at once and the sweep
is their running product from z = L.  Lanes of a batch relax independently:
a lane whose residual has dropped to ``tol`` is frozen while the others go
on, so a batch equals its lanes solved alone, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import SimulationConfig, validate_config
from ..ops.rhs import RHSCoeffs
from ..parallel.mesh import mesh_device, shard_batch
from ..utils.checks import resolve_device
from ..utils.precision import dtypes_for, require_non_df32
from ..utils.units import length_scale_to_m
from .fwm4 import make_initial_amplitudes


@dataclasses.dataclass(frozen=True)
class SBSCoeffs:
    """FWM coefficients + Brillouin gain gB [1/(W m)] (scalars or (B,)
    tensors)."""

    fwm: RHSCoeffs
    g_B: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SBSResult:
    """Host-side result of a relaxation solve."""

    z: np.ndarray         # (S+1,) saved grid [output length unit]
    A: np.ndarray         # (S+1, 4) complex forward waves (lab frame)
    B: np.ndarray         # (S+1, 4) complex backward waves
    residual: float       # final sup-norm change of B between sweeps
    n_iterations: int
    reflectivity: np.ndarray  # (4,) |B_j(0)|^2 / |A_j(0)|^2 Stokes return


def _power(x: torch.Tensor) -> torch.Tensor:
    return x.real * x.real + x.imag * x.imag


def _forward_rhs(a, lin, nig):
    """dA/dz of the rotating-frame FWM, the SBS depletion folded into
    ``lin = -alpha/2 - (gB/2)|B|^2 - i (dbeta/2)[1, 1, 0, 0]``, on the state
    laid out as pairs, ``a`` (B, 2, 2) = [[A1, A2], [A3, A4]]:
    ``lin a + i g [F a + 2 conj(partner) s]``, with ``nig = -i g``, the
    Kerr factors ``F = 2 sum(P) - P`` and ``s`` the product of the other
    pair.  The powers stay complex (``a conj(a)`` has an exactly zero
    imaginary part), which saves the dispatches of taking parts: this loop
    is bound by the count of operations, not by their size."""
    P = a * a.conj()
    neg_F = torch.add(P, P.sum(dim=(-2, -1), keepdim=True), alpha=-2.0)
    s = a.prod(dim=-1, keepdim=True).flip(-2)
    neg_inner = torch.addcmul(neg_F * a, a.flip(-1).conj(), s, value=-2.0)
    return torch.addcmul(lin * a, nig, neg_inner)


def _forward_sweep(a0, b_pow, c: SBSCoeffs, dz):
    """A over the step grid ((n+1, B, 4)) with the backward powers ``b_pow``
    frozen; RK4 with the frozen field at each step's ends and midpoint."""
    gamma, dbeta = c.fwm.gamma, c.fwm.delta_beta
    half_gb = 0.5 * c.g_B
    loss = -0.5 * c.fwm.alpha
    # the linear coefficient at every step's ends and midpoints, at once
    lin_end = loss - half_gb * b_pow
    lin_mid = loss - half_gb * (0.5 * (b_pow[:-1] + b_pow[1:]))
    det = torch.cat([-0.5 * dbeta.expand(-1, 2), torch.zeros_like(dbeta).expand(-1, 2)], dim=-1)
    pairs = (a0.shape[0], 2, 2)
    lin_end = torch.complex(lin_end, det.expand_as(lin_end)).reshape((-1,) + pairs).unbind(0)
    lin_mid = torch.complex(lin_mid, det.expand_as(lin_mid)).reshape((-1,) + pairs).unbind(0)
    nig = torch.complex(torch.zeros_like(gamma), -gamma)[:, :, None]
    a = a0.reshape(pairs)
    rows = [a]
    h2, h6 = 0.5 * dz, dz / 6.0
    for i in range(len(lin_mid)):
        lm = lin_mid[i]
        k1 = _forward_rhs(a, lin_end[i], nig)
        k2 = _forward_rhs(torch.add(a, k1, alpha=h2), lm, nig)
        k3 = _forward_rhs(torch.add(a, k2, alpha=h2), lm, nig)
        k4 = _forward_rhs(torch.add(a, k3, alpha=dz), lin_end[i + 1], nig)
        a = torch.add(a, torch.add(k1, k2 + k3, alpha=2.0) + k4, alpha=h6)
        rows.append(a)
    return torch.stack(rows).reshape((len(rows),) + tuple(a0.shape))


def _backward_sweep(bL, a_pow, c: SBSCoeffs, dz):
    """B over the step grid ((n+1, B, 4)) with the forward powers ``a_pow``
    frozen, integrated from z = L down to 0.  dB/dz = q(z) B with the real
    frozen coefficient q = alpha/2 - (gB/2)|A|^2, so the RK4 step from
    grid point j+1 to j is B_j = R_j B_{j+1} with R_j a polynomial in q at
    the step's ends and midpoint."""
    half_gb = 0.5 * c.g_B
    gain = 0.5 * c.fwm.alpha
    q_start = gain - half_gb * a_pow[1:]                      # at z_{j+1}
    q_mid = gain - half_gb * (0.5 * (a_pow[:-1] + a_pow[1:]))
    q_end = gain - half_gb * a_pow[:-1]                       # at z_j
    h = -dz
    k2 = q_mid * (1.0 + (0.5 * h) * q_start)
    k3 = q_mid * (1.0 + (0.5 * h) * k2)
    k4 = q_end * (1.0 + h * k3)
    R = 1.0 + (h / 6.0) * (q_start + 2.0 * (k2 + k3) + k4)
    # B_j = bL * R_{n-1} * ... * R_j: the running product from z = L
    run = torch.cumprod(R.flip(0), dim=0).flip(0)
    return torch.cat([bL * run, bL[None]], dim=0)


@torch.inference_mode()
def _relax(a0, bL, b_init, c, dz, *, max_iterations, damping, tol):
    """Relaxation over a batch: ``a0``, ``bL`` (B, 4), ``b_init`` (n+1, B, 4)
    complex; ``c`` the coefficients, (B, 1) real tensors per meter.
    Returns the trajectories (n+1, B, 4), the residuals and sweep counts (B,)."""
    rdt = a0.real.dtype
    B_traj = b_init.clone()
    B_traj[-1] = bL
    A_traj = torch.zeros_like(B_traj)
    nb = a0.shape[0]
    resid = torch.full((nb,), float("inf"), dtype=rdt, device=a0.device)
    n_it = torch.zeros((nb,), dtype=torch.int32, device=a0.device)
    w = torch.tensor(damping, dtype=rdt, device=a0.device)
    while True:
        active = (resid > tol) & (n_it < max_iterations)
        if not bool(active.any()):
            break
        A_new = _forward_sweep(a0, _power(B_traj), c, dz)
        B_swept = _backward_sweep(bL, _power(A_new), c, dz)
        # under-relaxation, with the boundary value B(L) = bL pinned
        B_new = (1.0 - w) * B_traj + w * B_swept
        B_new[-1] = bL
        resid_new = torch.abs(B_new - B_traj).amax(dim=(0, 2))
        # a lane that has converged (or spent its budget) stays as it is
        keep = active[None, :, None]
        B_traj = torch.where(keep, B_new, B_traj)
        A_traj = torch.where(keep, A_new, A_traj)
        resid = torch.where(active, resid_new, resid)
        n_it = n_it + active.to(torch.int32)
    return A_traj, B_traj, resid, n_it


def _b_init_on_step_grid(B_init, n_steps: int, save_every: int) -> np.ndarray:
    """Lift a saved-grid backward trajectory (..., S, 4) onto the full step
    grid (..., n_steps+1, 4) by linear interpolation (exact when
    save_every == 1; otherwise the warm start is approximate -- the
    relaxation converges to the same fixed point either way, just faster
    than from zero)."""
    B_init = np.asarray(B_init, dtype=np.complex128)
    n_saved = n_steps // save_every + 1
    if B_init.shape[-2:] != (n_saved, 4):
        raise ValueError(
            f"B_init must have shape (..., {n_saved}, 4) (the saved grid of "
            f"this cfg), got {B_init.shape}"
        )
    if not np.all(np.isfinite(B_init)):
        raise ValueError("B_init must be finite")
    z_saved = np.arange(n_saved, dtype=np.float64) * save_every
    z_all = np.arange(n_steps + 1, dtype=np.float64)
    flat = B_init.reshape(-1, n_saved, 4)
    out = np.empty(flat.shape[:1] + (n_steps + 1, 4), dtype=np.complex128)
    for b in range(flat.shape[0]):
        for j in range(4):
            out[b, :, j] = (
                np.interp(z_all, z_saved, flat[b, :, j].real)
                + 1j * np.interp(z_all, z_saved, flat[b, :, j].imag)
            )
    return out.reshape(B_init.shape[:-2] + (n_steps + 1, 4))


def _check_controls(cfg: SimulationConfig, n_iterations, damping, tol, max_iterations) -> int:
    if not (0.0 < damping <= 1.0):
        raise ValueError("damping must be in (0, 1]")
    if tol < 0.0:
        raise ValueError("tol must be >= 0")
    max_it = int(n_iterations if max_iterations is None else max_iterations)
    if max_it <= 0:
        raise ValueError("max_iterations must be positive")
    validate_config(cfg)
    if cfg.integrator.lower() != "rk4":
        raise ValueError("SBS relaxation currently supports integrator='rk4'")
    return max_it


def _solve(cfg, A0, BL, b_init, g, al, db, gb, dz_m, *, max_it, damping, tol, device):
    """Put the (B, 4) boundary values, the (B, n+1, 4) start trajectory and
    the (B,) per-meter coefficients on ``device`` in the tier's dtypes and
    relax; host ``(A, B (B, S+1, 4) complex128, residual, n_iterations)``."""
    precision = require_non_df32(cfg.precision, family="SBS relaxation")
    rdt, cdt = dtypes_for(precision)

    def lanes(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64), device=device).to(rdt)[:, None]

    def field(v):
        return torch.as_tensor(np.asarray(v), device=device).to(cdt)

    coeffs = SBSCoeffs(fwm=RHSCoeffs(gamma=lanes(g), alpha=lanes(al), delta_beta=lanes(db)),
                       g_B=lanes(gb))
    # the relaxation works with the z axis first: (n+1, B, 4)
    A_t, B_t, resid, n_it = _relax(
        field(A0), field(BL), field(b_init).transpose(0, 1).contiguous(), coeffs,
        float(torch.tensor(dz_m, dtype=rdt)), max_iterations=max_it, damping=float(damping),
        tol=float(tol))
    sl = slice(0, A_t.shape[0], int(cfg.save_every))

    def host(t):
        return t[sl].transpose(0, 1).to(torch.complex128).cpu().numpy()

    return (host(A_t), host(B_t), resid.to(torch.float64).cpu().numpy(),
            n_it.cpu().numpy().astype(np.int32))


def run_sbs_simulation(
    cfg: SimulationConfig,
    *,
    gamma: float,
    alpha: float,
    g_B: float,
    delta_beta: float,
    p_in: Sequence[float],
    p_stokes_seed: Sequence[float],
    phase_in: Optional[Sequence[float]] = None,
    length_unit: str = "m",
    return_length_unit: Optional[str] = None,
    n_iterations: int = 20,
    damping: float = 1.0,
    tol: float = 0.0,
    max_iterations: Optional[int] = None,
    B_init: Optional[np.ndarray] = None,
    device=None,
) -> SBSResult:
    """Solve the coupled FWM + SBS two-point BVP on [0, z_max].

    ``p_in``: forward powers at z=0 (wave order [p1, p2, s, i]);
    ``p_stokes_seed``: backward Stokes powers entering at z=L.
    All rate coefficients are per ``length_unit`` (converted internally).
    ``damping`` < 1 under-relaxes the sweeps -- required for convergence in
    the strong-coupling / above-threshold regime.

    Relaxation runs until the sup-norm change of B between sweeps drops to
    ``tol`` (amplitude units, sqrt(W)) or ``max_iterations`` sweeps
    (defaults to ``n_iterations``), whichever comes first;
    ``SBSResult.residual`` / ``.n_iterations`` report what actually
    happened.  ``tol=0`` runs exactly the iteration budget.

    Checkpoint/resume: pass a previous :attr:`SBSResult.B` (saved-grid
    backward trajectory, shape (S+1, 4)) as ``B_init`` to warm-start the
    relaxation -- the fixed point is unchanged; a converged guess
    re-converges in one sweep (the forward field A is recomputed from B, so
    B alone is the full relaxation state).  With ``save_every == 1`` the
    warm start is exact; otherwise the guess is linearly interpolated onto
    the step grid.  ``df32`` raises (no two-float engine, as in the JAX
    package).  Plain torch on ``device`` (``None``: the CUDA card).
    """
    max_it = _check_controls(cfg, n_iterations, damping, tol, max_iterations)
    require_non_df32(cfg.precision, family="SBS relaxation")
    device = resolve_device(device)

    scale = length_scale_to_m(length_unit)
    dz_m = float(cfg.dz) * scale
    n_steps = int(round(float(cfg.z_max) * scale / dz_m))

    A0 = make_initial_amplitudes(p_in, phase_in)
    BL = make_initial_amplitudes(p_stokes_seed, None)
    if B_init is None:
        b_init = np.zeros((n_steps + 1, 4), dtype=np.complex128)
    else:
        b_init = _b_init_on_step_grid(B_init, n_steps, int(cfg.save_every))

    def per_m(v):
        return np.array([float(v) / scale])

    A, B, resid, n_it = _solve(
        cfg, A0[None], BL[None], b_init[None], per_m(gamma), per_m(alpha),
        per_m(delta_beta), per_m(g_B), dz_m, max_it=max_it, damping=damping, tol=tol,
        device=device)
    A, B = A[0], B[0]
    if cfg.check_nan and not (np.all(np.isfinite(A)) and np.all(np.isfinite(B))):
        raise FloatingPointError("NaN or Inf in SBS relaxation solve")

    # convert the rotating-frame forward waves back to lab frame
    n_saved = A.shape[0]
    z_m = np.arange(n_saved) * cfg.save_every * dz_m
    db_m = float(delta_beta) / scale
    rot = np.exp(0.5j * db_m * z_m)
    A[:, 0] *= rot
    A[:, 1] *= rot

    out_unit = length_unit if return_length_unit is None else return_length_unit
    z_out = z_m / length_scale_to_m(out_unit)

    P_A0 = np.abs(A[0]) ** 2
    refl = np.where(P_A0 > 0, np.abs(B[0]) ** 2 / np.maximum(P_A0, 1e-300), 0.0)
    return SBSResult(
        z=z_out, A=A, B=B,
        residual=float(resid[0]),
        n_iterations=int(n_it[0]),
        reflectivity=refl,
    )


def run_sbs_batch(
    cfg: SimulationConfig,
    *,
    gamma,
    alpha,
    g_B,
    delta_beta,
    P_in: np.ndarray,
    P_stokes_seed: np.ndarray,
    length_unit: str = "m",
    return_length_unit: Optional[str] = None,
    n_iterations: int = 20,
    damping: float = 1.0,
    tol: float = 0.0,
    max_iterations: Optional[int] = None,
    mesh=None,
    B_init: Optional[np.ndarray] = None,
    device=None,
):
    """Solve B independent FWM+SBS boundary-value problems in one batch.

    ``P_in``/``P_stokes_seed`` are ``(B, 4)`` power arrays; the rate
    coefficients broadcast or carry a leading B axis.  Returns ``(z, A
    (B,S,4), B_waves (B,S,4), residuals (B,), reflectivity (B,4), ok (B,),
    n_iters (B,))`` -- NaN instances are flagged in ``ok``, not raised.
    Per-lane convergence control as in :func:`run_sbs_simulation` (``tol`` /
    ``max_iterations``): converged lanes freeze (bit-identical to solving
    them alone) while slow lanes keep relaxing.  ``B_init`` (shape (B, S+1,
    4)) warm-starts every lane from a previous call's backward trajectories
    (checkpoint/resume; see :func:`run_sbs_simulation`).  Plain torch on
    ``device`` (``None``: the CUDA card).  ``mesh`` (``parallel/mesh.Mesh``)
    splits the lanes over its slots, padded to a multiple of them with edge
    rows; each slot's lanes relax on its device, one slot after another
    (the relaxation reads its residuals back every sweep), and the results
    gather back trimmed, each lane's iteration count its own.  ``device``
    is then None or one the mesh uses.
    """
    max_it = _check_controls(cfg, n_iterations, damping, tol, max_iterations)
    require_non_df32(cfg.precision, family="SBS relaxation")
    device = mesh_device(mesh, device)
    scale = length_scale_to_m(length_unit)
    dz_m = float(cfg.dz) * scale
    n_steps = int(round(float(cfg.z_max) * scale / dz_m))

    P_in = np.asarray(P_in, dtype=float)
    P_st = np.asarray(P_stokes_seed, dtype=float)
    if P_in.ndim != 2 or P_in.shape[1] != 4 or P_st.shape != P_in.shape:
        raise ValueError("P_in and P_stokes_seed must both have shape (B, 4)")
    if np.any(P_in < 0) or np.any(P_st < 0):
        raise ValueError("powers must be non-negative")
    nb = P_in.shape[0]
    A0 = np.sqrt(P_in).astype(np.complex128)
    BL = np.sqrt(P_st).astype(np.complex128)

    def bcast(x):
        return np.broadcast_to(np.asarray(x, dtype=float), (nb,))

    g = bcast(gamma) / scale
    al = bcast(alpha) / scale
    gb = bcast(g_B) / scale
    db = bcast(delta_beta) / scale

    if B_init is None:
        b_init = np.zeros((nb, n_steps + 1, 4), dtype=np.complex128)
    else:
        B_init = np.asarray(B_init, dtype=np.complex128)
        if B_init.ndim != 3 or B_init.shape[0] != nb:
            raise ValueError(
                f"B_init must have shape (B={nb}, S+1, 4), got {B_init.shape}"
            )
        b_init = _b_init_on_step_grid(B_init, n_steps, int(cfg.save_every))
    def solve(dev, A0, BL, b_init, g, al, db, gb):
        return _solve(cfg, A0, BL, b_init, g, al, db, gb, dz_m, max_it=max_it,
                      damping=damping, tol=tol, device=dev)

    args = (A0, BL, b_init, g, al, db, gb)
    A, Bw, resid, n_it = solve(device, *args) if mesh is None else shard_batch(mesh, solve, args)

    # batch semantics: NaN instances are flagged, not raised (the per-instance
    # analog of run_sbs_simulation's FloatingPointError)
    ok = np.all(np.isfinite(A.reshape(A.shape[0], -1)), axis=1) & np.all(
        np.isfinite(Bw.reshape(Bw.shape[0], -1)), axis=1
    )

    n_saved = A.shape[1]
    z_m = np.arange(n_saved) * cfg.save_every * dz_m
    rot = np.exp(0.5j * db[:, None] * z_m[None, :])
    A[:, :, 0] *= rot
    A[:, :, 1] *= rot

    out_unit = length_unit if return_length_unit is None else return_length_unit
    z_out = z_m / length_scale_to_m(out_unit)
    P_A0 = np.abs(A[:, 0]) ** 2
    refl = np.where(P_A0 > 0, np.abs(Bw[:, 0]) ** 2 / np.maximum(P_A0, 1e-300), 0.0)
    return (z_out, A, Bw, np.asarray(resid, dtype=float), refl, ok,
            np.asarray(n_it, dtype=np.int32))
