"""4-wave FWM experiments: reference main.py parity entry points plus
the sweep/scan/map extensions (SURVEY layers L5/L6).

Counterpart of the JAX package's ``experiments/fwm4.py``, with its defaults
and file names.  Each experiment takes ``device`` (``None``: the CUDA card)
and forwards it to every solve; the sweeps run on the card through the
4-wave kernels (``csrc/fwm4_rk.cu`` for rk4/ab4/abm4, ``csrc/fwm4_rk45.cu``
for rk45).  ``mesh`` (``parallel/mesh.Mesh``) splits each sweep's batch
over its slots."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import plotting
from ..config import custom_simulation_config
from ..io_fwm import make_run_metadata, save_run_bundle, save_sweep_npz
from ..models.fwm4 import run_single_simulation
from ..ops.frequency_plan import describe_plan
from ..ops.phase_matching import PhaseMatchingConfig, PhaseMatchingMethod
from ..parallel import sweep as sweeps
from ..utils.units import alpha_db_per_km_to_1_m
from ._shared import _PM_DEFAULT, _dispersion_at_pump_center


def single_simulation(
    *,
    lambda_p1: float = 1550e-9,
    lambda_p2: float = 1560e-9,
    lambda_signal: float = 1555e-9,
    z_max_m: float = 1000.0,
    dz_m: float = 0.1,
    D: float = 0.02,
    S: float = 0.02,
    gamma_km: float = 11.5,
    alpha_db_per_km: float = 0.9,
    p_in=(0.5, 0.5, 1e-5, 1e-5),
    precision: str = "x64",
    integrator: str = "rk4",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Single dual-pump run with dispersion-aware phase matching; prints the
    plan and result summary, plots powers in dBW.  Defaults reproduce
    reference ``main_single_simulation`` (main.py:22-117; 45.292 dB anchor)."""
    cfg = custom_simulation_config(
        z_max=z_max_m, dz=dz_m, precision=precision, integrator=integrator
    )
    omega, sp, disp = _dispersion_at_pump_center(
        lambda_p1, lambda_p2, lambda_signal, D=D, S=S
    )
    if verbose:
        print(describe_plan(omega))

    gamma_m = gamma_km / 1000.0
    alpha_m = alpha_db_per_km_to_1_m(alpha_db_per_km)
    p_in = np.asarray(p_in, dtype=float)

    z, A = run_single_simulation(
        cfg, gamma=gamma_m, alpha=alpha_m, omega=omega, p_in=p_in,
        phase_in=np.zeros(4), dispersion=disp, phase_matching_cfg=_PM_DEFAULT,
        length_unit="m", return_length_unit="m", device=device,
    )

    P_out = np.abs(A[-1]) ** 2
    gain_db = 10.0 * np.log10(P_out[2] / p_in[2])
    from ..ops.dispersion import delta_beta_from_omegas, delta_beta_symmetric

    db = float(delta_beta_from_omegas(omega, disp))
    db_sym = float(delta_beta_symmetric(sp.omega_c, sp.omega_d, sp.Omega, disp))
    if verbose:
        print("\n--- Results ---")
        print(f"z_end = {z[-1]:.3f} m")
        print(f"P_in  [W] = {p_in}")
        print(f"P_out [W] = {P_out}")
        print(f"Signal gain = {gain_db:.3f} dB")
        print(f"dbeta = {db:.6g} m^-1   dbeta_sym = {db_sym:.6g} m^-1")
        print(f"gamma(P1 + P2) = {gamma_m * (p_in[0] + p_in[1]):.6g} m^-1")

    if save_dir is not None:
        save_run_bundle(
            save_dir, "single_simulation", z, A,
            metadata=make_run_metadata(
                {"gain_db": gain_db, "dbeta_1_m": db}, config=cfg
            ),
            overwrite=True,
        )
    plotting.plot_fwm_sbs_powers_forward(
        z, A, scale="dbW", z_unit="m", show=show,
        save_path=None if save_dir is None else f"{save_dir}/single_simulation.png",
    )
    return z, A


def gain_spectrum(
    *,
    lambda_p1: float = 1550e-9,
    lambda_p2: float = 1555e-9,
    lambda_signal_range: Tuple[float, float] = (1540e-9, 1650e-9),
    n_points: int = 100,
    z_max_m: float = 500.0,
    dz_m: float = 0.2,
    D: float = 0.2,
    S: float = 0.02,
    gamma_km: float = 11.5,
    alpha_db_per_km: float = 0.5,
    p_in=(0.5, 0.5, 1e-7, 1e-7),
    precision: str = "x64",
    integrator: str = "rk4",
    mesh=None,
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Signal-wavelength gain spectrum (defaults: reference
    ``main_gain_spectrum``, main.py:119-203) -- one batched solve."""
    cfg = custom_simulation_config(
        z_max=z_max_m, dz=dz_m, precision=precision, integrator=integrator
    )
    lam3 = np.linspace(*lambda_signal_range, n_points)
    _, _, disp = _dispersion_at_pump_center(lambda_p1, lambda_p2, float(lam3[0]), D=D, S=S)
    res = sweeps.gain_spectrum(
        cfg=cfg, lambda_p1_m=lambda_p1, lambda_p2_m=lambda_p2,
        lambda_signal_m=lam3, gamma=gamma_km / 1000.0,
        alpha=alpha_db_per_km_to_1_m(alpha_db_per_km),
        p_in=np.asarray(p_in, dtype=float), phase_in=np.zeros(4),
        dispersion=disp, phase_matching_cfg=_PM_DEFAULT,
        length_unit="m", gain_unit="dB", mesh=mesh, verbose=verbose,
        device=device,
    )
    if save_dir is not None:
        save_sweep_npz(f"{save_dir}/gain_spectrum.npz", res,
                       metadata=make_run_metadata(config=cfg), overwrite=True)
    plotting.plot_gain_spectrum(
        res, show=show,
        save_path=None if save_dir is None else f"{save_dir}/gain_spectrum.png",
    )
    return res


def gain_spectrum_dbeta(
    *,
    lambda_p1: float = 1550e-9,
    lambda_p2: float = 1558e-9,
    lambda_signal_range: Tuple[float, float] = (1540e-9, 1565e-9),
    n_points: int = 30,
    z_max_m: float = 500.0,
    dz_m: float = 0.2,
    D: float = 0.1,
    S: float = 0.02,
    gamma_km: float = 11.5,
    alpha_db_per_km: float = 0.5,
    p_in=(0.1, 0.1, 1e-7, 1e-7),
    precision: str = "x64",
    integrator: str = "rk4",
    mesh=None,
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Combined gain + dbeta spectrum with the -gamma(P1+P2) overlay
    (defaults: reference ``main_gain_spectrum_dbeta``, main.py:206-280)."""
    cfg = custom_simulation_config(
        z_max=z_max_m, dz=dz_m, precision=precision, integrator=integrator
    )
    lam3 = np.linspace(*lambda_signal_range, n_points)
    _, _, disp = _dispersion_at_pump_center(lambda_p1, lambda_p2, float(lam3[0]), D=D, S=S)
    p0 = np.asarray(p_in, dtype=float)
    gamma_m = gamma_km / 1000.0
    res = sweeps.gain_and_dbeta_spectrum(
        cfg=cfg, lambda_p1_m=lambda_p1, lambda_p2_m=lambda_p2,
        lambda_signal_m=lam3, gamma=gamma_m,
        alpha=alpha_db_per_km_to_1_m(alpha_db_per_km),
        p_in=p0, phase_in=np.zeros(4), dispersion=disp,
        phase_matching_cfg=_PM_DEFAULT, length_unit="m", gain_unit="dB",
        mesh=mesh, verbose=verbose, device=device,
    )
    if save_dir is not None:
        save_sweep_npz(f"{save_dir}/gain_spectrum_dbeta.npz", res,
                       metadata=make_run_metadata(config=cfg), overwrite=True)
    plotting.plot_gain_and_dbeta(
        res, gamma=gamma_m, p_pump_total=float(p0[0] + p0[1]), length_unit="m",
        show=show,
        save_path=None if save_dir is None else f"{save_dir}/gain_spectrum_dbeta.png",
    )
    return res


def mismatch_scan(
    *,
    span: float = 40.0,
    n_points: int = 200,
    z_max_km: float = 0.5,
    dz_km: float = 1e-3,
    gamma_km: float = 10.0,
    p_pump: float = 0.1,
    p_signal: float = 1e-5,
    gain_mode: str = "end",
    precision: str = "x64",
    integrator: str = "rk4",
    mesh=None,
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Gain vs provided phase mismatch (the working realization of the
    reference's stale ``scan_mismatch_seeded_signal``, scan_mismtach.py:43-259:
    same physics defaults, batched)."""
    cfg = custom_simulation_config(
        z_max=z_max_km, dz=dz_km, precision=precision, integrator=integrator
    )
    db = np.linspace(-span, span, n_points)
    sig, idl = sweeps.mismatch_scan(
        cfg=cfg, gamma=gamma_km, alpha=0.0,
        p_in=[p_pump, p_pump, p_signal, 0.0],
        delta_beta_values=db, gain_mode=gain_mode, gain_unit="linear",
        length_unit="km", mesh=mesh, verbose=verbose, device=device,
    )
    all_failed = not np.any(np.isfinite(sig.gain))
    if all_failed:
        if verbose:
            print("mismatch_scan: every instance failed (all gains NaN)")
        return sig, idl

    b = sig.best_index
    if verbose:
        print(f"best delta_beta = {db[b]:.6g} 1/km, Gs = {sig.gain[b]:.6g}")
        lo, hi = max(0, b - 3), min(len(db), b + 4)
        for j in range(lo, hi):
            print(f"  delta={db[j]: .6g}  Gs={sig.gain[j]: .6g}  Gi={idl.gain[j]: .6g}")
    if save_dir is not None:
        save_sweep_npz(f"{save_dir}/mismatch_scan.npz", sig,
                       metadata=make_run_metadata(config=cfg), overwrite=True)
    plotting.plot_mismatch_scan(
        sig, idl, length_unit="km", show=show,
        save_path=None if save_dir is None else f"{save_dir}/mismatch_scan.png",
    )

    if show or save_dir is not None:
        # re-run the best point and plot its trajectories (reference
        # scan_mismtach.py:222-246 behavior); skipped for purely programmatic
        # use where neither display nor artifacts are requested
        from ..constants import c as _c

        omega0 = 2 * np.pi * _c / 1.55e-6
        z_b, A_b = run_single_simulation(
            cfg, gamma=gamma_km, alpha=0.0, omega=np.full(4, omega0),
            p_in=[p_pump, p_pump, p_signal, 0.0],
            phase_matching_cfg=PhaseMatchingConfig(
                method=PhaseMatchingMethod.PROVIDED,
                provided_delta_beta=float(db[b]),
            ),
            length_unit="km", return_length_unit="km", device=device,
        )
        plotting.plot_signal_and_idler(
            z_b, A_b, title=f"Best delta = {db[b]:.3g} 1/km", z_unit="km",
            show=show,
            save_path=None if save_dir is None else f"{save_dir}/mismatch_best_si.png",
        )
        plotting.plot_powers(
            z_b, A_b, title=f"Powers at best delta = {db[b]:.3g} 1/km",
            z_unit="km", show=show,
            save_path=None if save_dir is None else f"{save_dir}/mismatch_best_powers.png",
        )
    return sig, idl


def psa_phase_sweep(
    *,
    n_points: int = 181,
    z_max_km: float = 0.2,
    dz_km: float = 1e-3,
    gamma_km: float = 10.0,
    p_pump: float = 0.1,
    p_signal: float = 1e-4,
    p_idler: float = 1e-4,
    delta_beta_km: float = 0.0,
    precision: str = "x64",
    integrator: str = "rk4",
    mesh=None,
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Phase-sensitive gain vs input signal phase (BASELINE config 3)."""
    cfg = custom_simulation_config(
        z_max=z_max_km, dz=dz_km, precision=precision, integrator=integrator
    )
    phases = np.linspace(0.0, 2 * np.pi, n_points)
    res = sweeps.psa_phase_sweep(
        cfg=cfg, gamma=gamma_km, alpha=0.0,
        p_in=[p_pump, p_pump, p_signal, p_idler],
        signal_phases=phases, delta_beta=delta_beta_km,
        gain_unit="dB", length_unit="km", mesh=mesh, device=device,
    )
    if verbose:
        print(
            f"PSA extinction: max {np.nanmax(res.gain):.2f} dB, "
            f"min {np.nanmin(res.gain):.2f} dB"
        )
    if save_dir is not None:
        save_sweep_npz(f"{save_dir}/psa_phase_sweep.npz", res,
                       metadata=make_run_metadata(config=cfg), overwrite=True)
    plotting.plot_phase_sweep(
        res, show=show,
        save_path=None if save_dir is None else f"{save_dir}/psa_phase_sweep.png",
    )
    return res


def gain_map(
    *,
    lambda_p1: float = 1550e-9,
    lambda_p2: float = 1558e-9,
    lambda_signal_range: Tuple[float, float] = (1540e-9, 1575e-9),
    n_wavelengths: int = 100,
    pump_powers=(0.05, 0.1, 0.2, 0.4),
    z_max_m: float = 500.0,
    dz_m: float = 0.2,
    D: float = 0.1,
    S: float = 0.02,
    gamma_km: float = 11.5,
    alpha_db_per_km: float = 0.5,
    precision: str = "x64",
    integrator: str = "rk4",
    mesh=None,
    show: bool = True,
    save_dir: Optional[str] = None,
    device=None,
):
    """2-D pump-power x wavelength gain map (BASELINE config 4)."""
    cfg = custom_simulation_config(
        z_max=z_max_m, dz=dz_m, precision=precision, integrator=integrator
    )
    lam3 = np.linspace(*lambda_signal_range, n_wavelengths)
    _, _, disp = _dispersion_at_pump_center(lambda_p1, lambda_p2, float(lam3[0]), D=D, S=S)
    x, pows, gm = sweeps.gain_map_power_wavelength(
        cfg=cfg, lambda_p1_m=lambda_p1, lambda_p2_m=lambda_p2,
        lambda_signal_m=lam3, pump_powers_W=list(pump_powers),
        gamma=gamma_km / 1000.0, alpha=alpha_db_per_km_to_1_m(alpha_db_per_km),
        dispersion=disp, phase_matching_cfg=_PM_DEFAULT, length_unit="m",
        gain_unit="dB", mesh=mesh, device=device,
    )
    if save_dir is not None:
        # the map is saved as its figure alone: make the directory, which
        # the JAX package's experiment leaves to the caller
        Path(save_dir).mkdir(parents=True, exist_ok=True)
    plotting.plot_gain_map(
        x, pows, gm, show=show,
        save_path=None if save_dir is None else f"{save_dir}/gain_map.png",
    )
    return x, pows, gm
