"""Fiber characterization from saved sweep artifacts (gradient descent
through the solver, ``parallel/calibrate.py``).

Counterpart of the JAX package's ``experiments/fitting.py``, with its
defaults and file names.  On the card each adam step of the fit is one
launch of the tangent kernel (``csrc/fwm4_tangent.cu``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import plotting
from ..config import custom_simulation_config


def fit_gain(
    npz_path: str,
    *,
    p_pump_W: float = 0.1,
    p_signal_W: float = 1e-5,
    init_gamma_km: float = 8.0,
    init_alpha_db_km: float = 0.0,
    steps: int = 500,
    learning_rate: float = 0.05,
    precision: str = "x64",          # accepted for CLI symmetry; x64-only
    mesh=None,                        # accepted for CLI symmetry; host fit
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Calibrate (gamma, alpha, delta-beta offset) from a saved
    ``mismatch`` sweep artifact (``save_sweep_npz`` layout: x = provided
    delta-beta [1/km], gain in the recorded ``gain_unit``, config in km)
    by gradient descent through the RK4 solver on ``device`` (``None``: the
    CUDA card).  Assumes the sweep measured ``gain_mode='end'`` (the model's
    last-saved-point convention) and the launch powers given here (they
    are not recorded in the artifact).  ``precision`` and ``mesh`` are
    ignored, as in the JAX package: the fit runs at x64 on one device."""
    from ..io_fwm import load_sweep_npz
    from ..parallel.calibrate import fit_gain_curve
    from ..utils.units import alpha_db_per_km_to_1_m

    del precision, mesh  # documented no-ops, as in the JAX package
    x, gain, _dbeta, ok, md = load_sweep_npz(npz_path)
    cfg_md = dict(md.get("config") or {})
    if not cfg_md:
        raise ValueError(f"{npz_path} carries no config metadata")
    cfg = custom_simulation_config(
        z_max=float(cfg_md["z_max"]) * 1e3,
        dz=float(cfg_md["dz"]) * 1e3,
        save_every=int(cfg_md.get("save_every", 1)),
    )
    unit = str(md.get("gain_unit", "linear")).lower()
    if unit in ("db", "dbs"):
        g_db = np.asarray(gain, dtype=float)
    elif unit == "linear":
        g_db = 10.0 * np.log10(np.asarray(gain, dtype=float))
    else:
        raise ValueError(f"unsupported gain_unit {unit!r}")
    keep = np.asarray(ok, dtype=bool) & np.isfinite(g_db)
    if keep.sum() < 4:
        raise ValueError("fewer than 4 finite sweep points to fit")

    fit = fit_gain_curve(
        cfg,
        delta_beta_grid=np.asarray(x, dtype=float)[keep] / 1e3,  # 1/km->1/m
        measured_gain_db=g_db[keep],
        p_in=[p_pump_W, p_pump_W, p_signal_W, 0.0],
        init=dict(gamma=float(init_gamma_km) / 1e3,
                  alpha=alpha_db_per_km_to_1_m(float(init_alpha_db_km)),
                  dbeta_offset=0.0),
        steps=steps, learning_rate=learning_rate, device=device,
    )
    if verbose:
        g_km = fit.params["gamma"] * 1e3
        a_db = fit.params["alpha"] / alpha_db_per_km_to_1_m(1.0)
        off_km = fit.params["dbeta_offset"] * 1e3
        print(
            f"fitted over {int(keep.sum())} points in {fit.n_steps} steps: "
            f"gamma = {g_km:.4g} 1/(W km), alpha = {a_db:.4g} dB/km, "
            f"delta-beta offset = {off_km:.4g} 1/km "
            f"(rms residual {np.sqrt(fit.loss_db2):.4g} dB)"
        )
    if save_dir is not None:
        from pathlib import Path

        Path(save_dir).mkdir(parents=True, exist_ok=True)
        np.savez(
            f"{save_dir}/fit_gain.npz",
            delta_beta_1_km=np.asarray(x, dtype=float)[keep],
            measured_gain_db=g_db[keep], model_gain_db=fit.gain_db,
            loss_history=fit.loss_history,
            **{k: v for k, v in fit.params.items()},
        )
    plotting.plot_lines(
        np.asarray(x, dtype=float)[keep],
        np.stack([g_db[keep], fit.gain_db], axis=1),
        labels=("measured", "fitted model"),
        xlabel="provided delta-beta (1/km)", ylabel="signal gain [dB]",
        title="Gain-curve calibration (gradient descent through the solver)",
        show=show,
        save_path=None if save_dir is None else f"{save_dir}/fit_gain.png",
    )
    return fit
