"""Fiber-yield experiment: gain statistics under longitudinal delta-beta
wander (``parallel/fluctuations.gain_ripple_monte_carlo``).

Counterpart of the JAX package's ``experiments/fluctuations.py``, plus
``device`` (``None``: the CUDA card): one batched solve a segment, one
``csrc/fwm4_rk.cu`` launch each on the card."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import plotting
from ..config import custom_simulation_config
from ..utils.units import alpha_db_per_km_to_1_m


def gain_ripple(
    *,
    z_max_m: float = 500.0,
    dz_m: float = 0.25,
    gamma_km: float = 11.5,
    alpha_db_per_km: float = 0.5,
    p_pump_W: float = 0.3,
    p_signal_W: float = 1e-5,
    delta_beta_mean: float = 0.0,
    sigma_dbeta_1_m: float = 0.02,
    n_segments: int = 20,
    n_realizations: int = 4096,
    seed: int = 0,
    mesh=None,
    precision: str = "x64",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Monte-Carlo yield statistics of a dual-pump amplifier whose phase
    mismatch wanders along the spool (piecewise-constant delta_beta(z) with
    ``n_segments`` correlation segments).  Prints the ensemble mean (+- SE),
    sigma, and the p5/p95 yield band with order-statistic CIs; plots the
    gain histogram.  The production question the reference's deterministic
    single-delta-beta solver cannot answer."""
    import dataclasses as dc

    from ..parallel.fluctuations import gain_ripple_monte_carlo

    steps_total = int(round(z_max_m / dz_m))
    if steps_total % int(n_segments) != 0:
        raise ValueError(
            f"z_max/dz = {steps_total} steps must divide into "
            f"{n_segments} segments"
        )
    # one saved sample per segment boundary (the MC only observes A_end)
    cfg = dc.replace(
        custom_simulation_config(
            z_max=z_max_m, dz=dz_m,
            save_every=steps_total // int(n_segments),
        ),
        precision=precision,
    )

    res = gain_ripple_monte_carlo(
        cfg, gamma=gamma_km / 1000.0,
        alpha=alpha_db_per_km_to_1_m(alpha_db_per_km),
        p_in=[p_pump_W, p_pump_W, p_signal_W, 0.0],
        delta_beta_mean=delta_beta_mean, sigma_dbeta=sigma_dbeta_1_m,
        n_segments=n_segments, n_realizations=n_realizations, seed=seed,
        mesh=mesh, device=device,
    )
    if verbose:
        print(
            f"gain ripple ({n_realizations} fibers, {n_segments} segments, "
            f"sigma_dbeta = {sigma_dbeta_1_m:g} 1/m):"
        )
        print(
            f"  nominal {res.gain_nominal_db:.3f} dB | mean "
            f"{res.gain_mean_db:.3f} +- {res.gain_mean_se_db:.4f} dB | "
            f"sigma {res.gain_std_db:.3f} dB"
        )
        print(
            f"  yield band p5 {res.gain_p5_db:.3f} dB "
            f"(95% CI [{res.gain_p5_ci_db[0]:.3f}, {res.gain_p5_ci_db[1]:.3f}])"
            f" / p95 {res.gain_p95_db:.3f} dB "
            f"(CI [{res.gain_p95_ci_db[0]:.3f}, {res.gain_p95_ci_db[1]:.3f}])"
        )
        print(f"  survived: {int(res.ok.sum())}/{res.ok.size} "
              f"({res.elapsed_s:.2f} s)")
    if save_dir is not None:
        from pathlib import Path

        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        np.savez(
            out / "gain_ripple.npz",
            gain_db=res.gain_db, ok=res.ok,
            gain_nominal_db=res.gain_nominal_db,
            gain_mean_db=res.gain_mean_db,
            gain_mean_se_db=res.gain_mean_se_db,
            gain_std_db=res.gain_std_db,
            gain_p5_db=res.gain_p5_db, gain_p95_db=res.gain_p95_db,
            gain_p5_ci_db=np.asarray(res.gain_p5_ci_db),
            gain_p95_ci_db=np.asarray(res.gain_p95_ci_db),
            sigma_dbeta_1_m=res.sigma_dbeta_1_m, n_segments=res.n_segments,
        )
    plotting.plot_gain_ripple(
        res, show=show,
        save_path=None if save_dir is None else f"{save_dir}/gain_ripple.png",
    )
    return res
