"""Kerr-microresonator (LLE) experiment: the laser-scan soliton protocol.

Ramp the pump detuning across the cavity resonance at fixed drive (the
standard soliton-comb generation protocol, Herr et al., Nat. Photon. 8,
145 (2014)) and record the intracavity-power trace: the MI/chaotic peak,
the drop onto the soliton step, and the final single/multi-soliton comb.
Normalized LLE units (slow time in photon lifetimes).

Counterpart of the JAX package's ``experiments/lle.py``: the ramp and the
hold are single-run trajectories (``run_lle_ramp``,
``run_lle_simulation``), plain torch on ``device`` (``None``: the CUDA
card), as they are scans in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import plotting
from ..config import custom_simulation_config
from ..io_fwm import make_run_metadata, save_result_npz


def kerr_cavity(
    *,
    pump: float = 2.0,
    detuning_start: float = -2.0,
    detuning_end: float = 4.5,
    lifetimes: float = 150.0,
    dt: float = 0.01,
    n_samples: int = 256,
    d2: float = -1.0,
    hold_lifetimes: float = 30.0,
    seed: int = 0,
    noise_amplitude: float = 1e-3,
    precision: str = "x64",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Detuning-ramp soliton generation + a hold segment at the final
    detuning (checkpoint/resume across the two segments: the hold
    continues from the ramp's last saved state).  Returns
    ``(detuning_trace, mean_power_trace, psi_final)``."""
    from ..models import lle

    grid = lle.TimeGrid(n_samples=int(n_samples), t_window_s=20.0)
    rng = np.random.default_rng(seed)
    psi0 = noise_amplitude * (rng.standard_normal(n_samples)
                              + 1j * rng.standard_normal(n_samples))
    cfg = custom_simulation_config(
        z_max=float(lifetimes), dz=float(dt),
        save_every=max(1, int(round(lifetimes / dt)) // 400),
        precision=precision,
    )
    coeffs = lle.make_lle_coeffs(grid, detuning=detuning_end, pump=pump,
                                 d2=d2, precision=precision)
    t, det, psi = lle.run_lle_ramp(
        cfg, coeffs, psi0,
        detuning_start=detuning_start, detuning_end=detuning_end, device=device,
    )
    mean_p = np.mean(np.abs(psi) ** 2, axis=-1)

    # hold at the final detuning to converge the soliton state (resume
    # from the ramp's last saved field)
    cfg_hold = custom_simulation_config(
        z_max=float(hold_lifetimes), dz=float(dt),
        save_every=int(round(hold_lifetimes / dt)), precision=precision,
    )
    _, psi_hold = lle.run_lle_simulation(cfg_hold, coeffs, psi[-1], device=device)
    psi_f = psi_hold[-1]

    if verbose:
        pk = float(np.max(np.abs(psi_f) ** 2))
        bg = lle.cw_steady_states(detuning_end, pump)[0]
        state = "soliton" if pk > 4.0 * bg else "CW"
        print(
            f"kerr-cavity: ramp Delta {detuning_start} -> {detuning_end} at "
            f"F={pump}; MI peak mean power {mean_p.max():.3f}, final state "
            f"{state} (peak {pk:.2f}, CW branch {bg:.3f})"
        )
    if save_dir is not None:
        # no CSV: the per-wave summary table is 4-wave-specific; the field
        # trajectory goes to NPZ with full provenance metadata
        from pathlib import Path

        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        md = make_run_metadata(config=cfg)
        md["lle"] = {"pump": float(pump), "d2": float(d2),
                     "detuning_start": float(detuning_start),
                     "detuning_end": float(detuning_end)}
        save_result_npz(out / "kerr_cavity.npz", t, psi, metadata=md,
                        overwrite=True)
    base = None if save_dir is None else f"{save_dir}/kerr_cavity"
    plotting.plot_lle_scan(
        det, mean_p, show=show,
        save_path=None if base is None else f"{base}_scan.png",
    )
    lines = np.fft.fft(psi_f) / psi_f.shape[-1]
    plotting.plot_comb_spectrum(
        np.fft.fftshift(lines), title="Kerr-cavity soliton comb",
        show=show,
        save_path=None if base is None else f"{base}_comb.png",
    )
    return det, mean_p, psi_f
