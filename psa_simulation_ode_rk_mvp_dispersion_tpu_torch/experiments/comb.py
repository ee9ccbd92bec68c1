"""N-wave cascaded-FWM comb experiment (BASELINE config 5).

Counterpart of the JAX package's ``experiments/comb.py``: the single-run
trajectory (``models/nwave.run_comb_simulation``), plain torch on
``device`` (``None``: the CUDA card), as it is a scan in the JAX package;
the batched comb kernels serve ``solve_comb_batch``, not this run.  With
``save_dir`` it writes ``comb.npz``, ``comb.csv`` (a column per line) and
``comb.json``, which the JAX package's experiment cannot: its CSV takes
the 4-wave labels, so it raises for any ``n_lines`` other than 4."""

from __future__ import annotations

from typing import Optional


from .. import plotting
from ..config import custom_simulation_config
from ..io_fwm import (make_run_metadata, save_metadata_json, save_result_npz,
                      save_summary_csv)
from ..ops.dispersion import dispersion_params_from_D_S
from ..utils.units import alpha_db_per_km_to_1_m


def comb(
    *,
    n_lines: int = 64,
    line_spacing_hz: float = 100e9,
    lambda_center: float = 1550e-9,
    pump_power: float = 0.5,
    noise_floor_W: float = 1e-12,
    z_max_m: float = 100.0,
    dz_m: float = 1e-3,
    D: float = 0.5,
    S: float = 0.02,
    gamma_km: float = 11.5,
    alpha_db_per_km: float = 0.5,
    integrator: str = "rk45",
    coupling: str = "fft",
    precision: str = "x64",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Dual-pump cascaded FWM comb generation (BASELINE config 5): two pump
    lines seed a cascade over ``n_lines`` comb lines; adaptive RK45 by
    default."""
    import numpy as _np

    from ..models import nwave as nw
    from ..ops.frequency_plan import omega_from_lambda

    omega_c = float(omega_from_lambda(lambda_center))
    grid = nw.CombGrid.centered(omega_c, 2 * _np.pi * line_spacing_hz, n_lines)
    disp = dispersion_params_from_D_S(
        lambda_ref_m=lambda_center, D=D, S=S, dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=omega_c,
    )
    coeffs = nw.make_comb_coeffs(
        grid, disp, gamma_W_m=gamma_km / 1000.0,
        alpha_1_m=alpha_db_per_km_to_1_m(alpha_db_per_km),
        precision=precision,
    )
    c = n_lines // 2
    A0 = nw.seed_comb(
        grid, pump_lines={c - 1: pump_power, c + 1: pump_power},
        noise_floor_W=noise_floor_W,
    )
    cfg = custom_simulation_config(
        z_max=z_max_m, dz=dz_m, save_every=max(1, int(round(z_max_m / dz_m)) // 50),
        integrator=integrator, precision=precision,
    )
    z, A = nw.run_comb_simulation(cfg, coeffs, A0, coupling=coupling, device=device)
    if verbose:
        P_end = _np.abs(A[-1]) ** 2
        n_above = int((P_end > 1e-9).sum())
        print(f"comb: {n_above}/{n_lines} lines above 1 nW after {z_max_m} m")
    if save_dir is not None:
        # the bundle of save_run_bundle (comb.npz/.csv/.json), with one CSV
        # column per comb line: the JAX package's call passes the 4-wave
        # labels and fails for any n_lines other than 4
        from pathlib import Path

        out = Path(save_dir)
        md = make_run_metadata(config=cfg)
        save_result_npz(out / "comb.npz", z, A, metadata=md, overwrite=True)
        save_summary_csv(out / "comb.csv", z, A, overwrite=True,
                         wave_labels=tuple(f"line{k}" for k in range(n_lines)))
        save_metadata_json(out / "comb.json", md, overwrite=True)
    plotting.plot_comb_spectrum(
        [A[0], A[-1]], label=["input", "output"], show=show,
        save_path=None if save_dir is None else f"{save_dir}/comb.png",
    )
    return z, A
