"""Coupled FWM + SBS forward/backward experiment.

Counterpart of the JAX package's ``experiments/sbs.py``: the relaxation of
``models/sbs``, plain torch on ``device`` (``None``: the CUDA card)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import plotting
from ..config import custom_simulation_config
from ..io_fwm import make_run_metadata, save_run_bundle
from ..utils.units import alpha_db_per_km_to_1_m


def fwm_sbs(
    *,
    z_max_m: float = 200.0,
    dz_m: float = 0.02,
    gamma_km: float = 11.5,
    alpha_db_per_km: float = 0.5,
    g_B_km: float = 150.0,
    delta_beta: float = 0.0,
    p_in=(0.5, 0.5, 1e-5, 0.0),
    p_stokes_seed=(1e-6, 1e-6, 0.0, 0.0),
    n_iterations: int = 40,
    damping: float = 1.0,
    tol: float = 0.0,
    max_iterations=None,
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Coupled FWM + SBS forward/backward solve (the A/B two-wave view the
    reference's plotting layer anticipates, plotting.py:552-613)."""
    from ..models import sbs as sbs_model

    cfg = custom_simulation_config(z_max=z_max_m, dz=dz_m, save_every=50)
    res = sbs_model.run_sbs_simulation(
        cfg, gamma=gamma_km / 1000.0,
        alpha=alpha_db_per_km_to_1_m(alpha_db_per_km),
        g_B=g_B_km / 1000.0, delta_beta=delta_beta,
        p_in=list(p_in), p_stokes_seed=list(p_stokes_seed),
        length_unit="m", n_iterations=n_iterations, damping=damping,
        tol=tol, max_iterations=max_iterations, device=device,
    )
    if verbose:
        print(f"SBS relaxation: residual {res.residual:.2e} after {res.n_iterations} sweeps")
        print(f"Stokes reflectivity per wave: {np.round(res.reflectivity, 4)}")
    if save_dir is not None:
        save_run_bundle(save_dir, "fwm_sbs_forward", res.z, res.A,
                        metadata=make_run_metadata(config=cfg), overwrite=True)
        save_run_bundle(save_dir, "fwm_sbs_backward", res.z, res.B,
                        metadata=make_run_metadata(config=cfg), overwrite=True)
    sp = None if save_dir is None else f"{save_dir}/fwm_sbs_totals.png"
    plotting.plot_total_powers_AB(res.z, res.A, res.B, scale="log", show=show,
                                  save_path=sp)
    plotting.plot_fwm_sbs_powers_forward(
        res.z, res.A, scale="dbW", z_unit="m", show=show,
        save_path=None if save_dir is None else f"{save_dir}/fwm_sbs_fwd.png")
    plotting.plot_fwm_sbs_powers_backward(
        res.z, res.B, scale="dbW", z_unit="m", show=show,
        save_path=None if save_dir is None else f"{save_dir}/fwm_sbs_bwd.png")
    return res
