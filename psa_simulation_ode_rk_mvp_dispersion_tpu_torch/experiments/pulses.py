"""GNLSE-family pulse experiments: scalar/vector solitons and the
Dudley supercontinuum showcase.

Counterpart of the JAX package's ``experiments/pulses.py``: each experiment
is a single-run trajectory (``run_gnlse_simulation``,
``run_vgnlse_simulation``), plain torch on ``device`` (``None``: the CUDA
card), as it is a scan in the JAX package; the batched SSFM kernels serve
``solve_gnlse_batch`` and ``solve_vgnlse_batch``, not these runs.  The
spectral-coherence measurement of :func:`supercontinuum`
(``coherence_samples > 0``) is a batched ensemble of
``parallel/noise.pulse_coherence_monte_carlo``."""

from __future__ import annotations

from typing import Optional


from .. import plotting
from ..config import custom_simulation_config
from ..io_fwm import make_run_metadata
from ..ops.dispersion import DispersionParams
from ..utils.units import alpha_db_per_km_to_1_m


def gnlse_pulse(
    *,
    t0_ps: float = 1.0,
    n_soliton: float = 3.0,
    beta2_ps2_km: float = -20.0,
    gamma_km: float = 2.0,
    alpha_db_per_km: float = 0.0,
    n_periods: float = 1.0,
    n_samples: int = 1024,
    n_steps: int = 4000,
    lambda_center: float = 1550e-9,
    raman: bool = False,
    steepening: bool = False,
    f_raman: Optional[float] = None,  # default: gnlse.RAMAN_FRACTION_SILICA
    integrator: str = "rk4",
    precision: str = "x64",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """GNLSE pulse propagation (``models/gnlse``): an N-soliton sech pulse
    over ``n_periods`` soliton periods -- N=1 is shape-invariant, N>=2
    breathes (periodic temporal compression), the classic split-step demo.
    ``raman``/``steepening`` switch on the generalized nonlinearity
    (silica delayed Raman response; optical-shock term at the carrier)."""
    import numpy as _np

    from ..models import gnlse as gnl
    from ..ops.frequency_plan import omega_from_lambda

    t0 = t0_ps * 1e-12
    beta2 = beta2_ps2_km * 1e-24 / 1e3  # ps^2/km -> s^2/m
    gamma = gamma_km / 1e3
    omega_c = float(omega_from_lambda(lambda_center))
    disp = DispersionParams.from_betas(omega_c, beta2=beta2)
    grid = gnl.TimeGrid.for_pulse(t0, n_samples=n_samples)
    coeffs = gnl.make_gnlse_coeffs(
        grid, disp, gamma_W_m=gamma,
        alpha_1_m=alpha_db_per_km_to_1_m(alpha_db_per_km), precision=precision,
    )
    P0 = float(n_soliton) ** 2 * gnl.soliton_peak_power(beta2, gamma, t0)
    z_period = 0.5 * _np.pi * t0**2 / abs(beta2)
    z_max = float(n_periods) * z_period
    cfg = custom_simulation_config(
        z_max=z_max, dz=z_max / n_steps,
        save_every=max(1, n_steps // 100), precision=precision,
        integrator=integrator,
    )
    nl = None
    if raman or steepening:
        if f_raman is None:
            f_raman = gnl.RAMAN_FRACTION_SILICA
        nl = gnl.make_nl_terms(
            grid,
            f_raman=float(f_raman) if raman else 0.0,
            omega0=omega_c if steepening else None,
            precision=precision,
        )
    z, A = gnl.run_gnlse_simulation(cfg, coeffs,
                                    gnl.sech_pulse(grid, peak_W=P0, t0_s=t0), nl=nl,
                                    device=device)
    if verbose:
        Pk = (_np.abs(A) ** 2).max(axis=-1)
        tags = (" +raman" if raman else "") + (" +steepening" if steepening else "")
        print(
            f"gnlse{tags}: N={n_soliton} soliton, P0={P0:.3f} W, "
            f"period {z_period:.1f} m; "
            f"peak power {Pk[0]:.2f} -> max {Pk.max():.2f} -> {Pk[-1]:.2f} W"
        )
    if save_dir is not None:
        # no CSV: the per-wave summary table is 4-wave-specific; the envelope
        # trajectory goes to NPZ with full provenance metadata
        from pathlib import Path

        from ..io_fwm import save_result_npz

        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        save_result_npz(
            out / "gnlse.npz", z, A,
            metadata=make_run_metadata(config=cfg),
            overwrite=True,
        )
    plotting.plot_pulse_evolution(
        z, grid.t(), A, show=show,
        title=f"N={n_soliton:g} soliton evolution",
        save_path=None if save_dir is None else f"{save_dir}/gnlse.png",
    )
    return z, A


def vector_pulse(
    *,
    t0_ps: float = 1.0,
    n_soliton: float = 1.0,
    theta_deg: float = 30.0,
    beta2_ps2_km: float = -20.0,
    gamma_km: float = 2.0,
    coupling: str = "manakov",    # 'manakov' | 'cnlse' | 'isotropic'
    dbeta1_ps_km: float = 0.0,
    n_periods: float = 1.0,
    n_samples: int = 1024,
    n_steps: int = 4000,
    integrator: str = "rk4",
    precision: str = "x64",
    raman: bool = False,
    steepening: bool = False,
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Vector (two-polarization) pulse propagation (``models/vgnlse``): a
    sech pulse split at ``theta_deg`` onto the polarization axes under the
    Manakov (random-birefringence) or cnlse (linear-birefringence, b=2/3)
    coupling, optionally with group-velocity walk-off ``dbeta1_ps_km``.
    At N=1 under 'manakov' the vector soliton is shape-invariant at any
    angle (the integrable limit); under 'cnlse' the same split deforms.
    ``raman`` / ``steepening`` enable the generalized nonlinearity
    (isotropic-Raman approximation, ``models/vgnlse._v_nl_rhs_gen``) --
    with Raman on, both polarizations red-shift together (the vector
    Gordon soliton self-frequency shift)."""
    import numpy as _np

    from ..models import gnlse as gnl
    from ..models import vgnlse as vgl

    t0 = t0_ps * 1e-12
    beta2 = beta2_ps2_km * 1e-24 / 1e3
    gamma = gamma_km / 1e3
    disp = DispersionParams.from_betas(1.2e15, beta2=beta2)
    grid = gnl.TimeGrid.for_pulse(t0, n_samples=n_samples)
    coeffs = vgl.make_vgnlse_coeffs(
        grid, disp, gamma_W_m=gamma, coupling=coupling,
        dbeta1_s_m=dbeta1_ps_km * 1e-12 / 1e3, precision=precision,
    )
    P0 = (float(n_soliton) ** 2
          * vgl.manakov_soliton_peak_power(beta2, gamma, t0))
    z_period = 0.5 * _np.pi * t0**2 / abs(beta2)
    z_max = float(n_periods) * z_period
    cfg = custom_simulation_config(
        z_max=z_max, dz=z_max / n_steps,
        save_every=max(1, n_steps // 100), precision=precision,
        integrator=integrator,
    )
    A0 = vgl.polarized_pulse(
        gnl.sech_pulse(grid, peak_W=P0, t0_s=t0), _np.deg2rad(theta_deg)
    )
    nl = None
    if raman or steepening:
        nl = gnl.make_nl_terms(
            grid, f_raman=0.18 if raman else 0.0,
            omega0=1.2e15 if steepening else None, precision=precision,
        )
    z, A = vgl.run_vgnlse_simulation(cfg, coeffs, A0, nl=nl, device=device)
    if verbose:
        dop = vgl.degree_of_polarization(grid, A[-1])
        Pk = (_np.abs(A) ** 2).sum(axis=1).max(axis=-1)
        print(
            f"vgnlse [{coupling}] theta={theta_deg:g} deg: N={n_soliton:g}, "
            f"P0={P0:.3f} W; total peak {Pk[0]:.2f} -> {Pk[-1]:.2f} W; "
            f"output DOP {dop:.4f}"
        )
    if save_dir is not None:
        from pathlib import Path

        from ..io_fwm import save_result_npz

        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        save_result_npz(out / "vgnlse.npz", z, A.reshape(A.shape[0], -1),
                        metadata=make_run_metadata(config=cfg), overwrite=True)
    plotting.plot_pulse_evolution(
        z, grid.t(), _np.sqrt((_np.abs(A) ** 2).sum(axis=1)), show=show,
        title=f"Vector pulse ({coupling}, theta={theta_deg:g} deg): total power",
        save_path=None if save_dir is None else f"{save_dir}/vgnlse.png",
    )
    return z, A


# classic PCF supercontinuum parameters (Dudley, Genty & Coen, Rev. Mod.
# Phys. 78, 1135 (2006), Fig. 3): 835 nm pump, betas in ps^n/km
_SC_BETAS_PS_KM = {
    2: -11.830, 3: 8.1038e-2, 4: -9.5205e-5, 5: 2.0737e-7,
    6: -5.3943e-10, 7: 1.3486e-12,
}


def supercontinuum(
    *,
    t0_fs: float = 28.4,
    peak_kW: float = 10.0,
    lambda_pump: float = 835e-9,
    gamma_W_m: float = 0.11,
    length_m: float = 0.15,
    f_raman: Optional[float] = None,  # default: gnlse.RAMAN_FRACTION_SILICA
    n_samples: int = 8192,
    window_ps: float = 10.0,
    rtol: float = 1e-6,
    n_saved: int = 100,
    integrator: str = "rk45",
    coherence_samples: int = 0,
    seed: int = 0,
    mesh=None,
    precision: str = "x64",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Supercontinuum generation by soliton fission in a photonic-crystal
    fiber: the classic GNLSE showcase (Dudley et al., RMP 2006, Fig. 3) --
    a femtosecond pump in the anomalous regime splits into fundamental
    solitons that red-shift by the Raman effect while shedding blue
    dispersive waves, spanning more than an octave in 15 cm.  Exercises
    every generalized-nonlinearity ingredient at once: dispersion orders
    2-7, delayed Raman response, self-steepening, adaptive stepping.

    ``coherence_samples > 0`` adds the shot-to-shot spectral coherence
    measurement |g12(omega)| (truncated-Wigner ensemble of that many
    vacuum-seeded shots, one batched solve; Dudley & Coen OL 27, 1180):
    long-pump / high-soliton-number continua decohere, short-pump ones
    stay |g12| ~ 1 -- the figure of merit of Dudley RMP 2006 Eq. (25).
    The ensemble is ``parallel/noise.pulse_coherence_monte_carlo`` on
    ``device``: rk45 with Raman and steepening has no kernel in either
    package, so it runs the plain torch controller there; ``mesh`` splits
    that ensemble (``parallel/mesh.Mesh``)."""
    import numpy as _np

    from ..models import gnlse as gnl
    from ..ops.frequency_plan import omega_from_lambda
    from ..parallel.mesh import check_mesh

    if mesh is not None:
        check_mesh(mesh)   # before the run, which the mesh's ensemble follows
    t0 = float(t0_fs) * 1e-15
    omega_c = float(omega_from_lambda(lambda_pump))
    # ps^n/km -> s^n/m
    betas = {n: b * (1e-12 ** n) * 1e-3 for n, b in _SC_BETAS_PS_KM.items()}
    disp = DispersionParams.from_betas(omega_c, extra=betas)
    grid = gnl.TimeGrid(n_samples=int(n_samples),
                        t_window_s=float(window_ps) * 1e-12)
    coeffs = gnl.make_gnlse_coeffs(grid, disp, gamma_W_m=float(gamma_W_m),
                                   precision=precision)
    if f_raman is None:
        f_raman = gnl.RAMAN_FRACTION_SILICA
    nl = gnl.make_nl_terms(grid, f_raman=float(f_raman), omega0=omega_c,
                           precision=precision)
    P0 = float(peak_kW) * 1e3
    n_sol = _np.sqrt(
        float(gamma_W_m) * P0 * t0**2 / abs(betas[2])
    )
    n_steps = int(n_saved) * 100
    cfg = custom_simulation_config(
        z_max=float(length_m), dz=float(length_m) / n_steps,
        save_every=n_steps // int(n_saved), precision=precision,
        integrator=integrator, rtol=float(rtol), atol=1e-12,
    )
    z, A = gnl.run_gnlse_simulation(cfg, coeffs,
                                    gnl.sech_pulse(grid, peak_W=P0, t0_s=t0),
                                    nl=nl, device=device)
    if verbose:
        S0 = _np.abs(_np.fft.fft(A[0])) ** 2
        S1 = _np.abs(_np.fft.fft(A[-1])) ** 2

        def bw30(S):
            keep = S > S.max() * 1e-3
            om = _np.fft.fftshift(grid.omega())
            sh = _np.fft.fftshift(keep)
            idx = _np.nonzero(sh)[0]
            return (om[idx[-1]] - om[idx[0]]) / (2 * _np.pi) * 1e-12
        print(
            f"supercontinuum: N={n_sol:.1f} soliton input, "
            f"-30 dB bandwidth {bw30(S0):.1f} -> {bw30(S1):.1f} THz "
            f"over {length_m*100:.0f} cm"
        )
    if save_dir is not None:
        from pathlib import Path

        from ..io_fwm import save_result_npz

        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        save_result_npz(out / "supercontinuum.npz", z, A,
                        metadata=make_run_metadata(config=cfg), overwrite=True)
    plotting.plot_spectral_evolution(
        z, grid.omega(), A, lambda0_m=lambda_pump,
        title="Supercontinuum generation (soliton fission)", show=show,
        save_path=None if save_dir is None else f"{save_dir}/supercontinuum.png",
    )
    plotting.plot_pulse_evolution(
        z, grid.t(), A, t_unit="ps", show=show,
        title="Supercontinuum temporal evolution",
        save_path=None if save_dir is None else f"{save_dir}/supercontinuum_t.png",
    )
    coh = None
    if int(coherence_samples) > 0:
        from ..parallel import noise as _nz

        coh = _nz.pulse_coherence_monte_carlo(
            cfg, coeffs, gnl.sech_pulse(grid, peak_W=P0, t0_s=t0), grid,
            omega0=omega_c, n_samples=int(coherence_samples), seed=seed,
            nl=nl, mesh=mesh, device=device,
        )
        if verbose:
            print(
                f"spectral coherence over {coh.n_samples} shots: "
                f"<|g12|> = {coh.g12_avg:.4f}"
            )
        if save_dir is not None:
            _np.savez(f"{save_dir}/supercontinuum_coherence.npz",
                      omega=coh.omega, g12=coh.g12,
                      mean_photons=coh.mean_photons, g12_avg=coh.g12_avg,
                      n_samples=coh.n_samples)
        plotting.plot_spectral_coherence(
            coh, show=show,
            save_path=None if save_dir is None
            else f"{save_dir}/supercontinuum_coherence.png",
        )
    return (z, A) if coh is None else (z, A, coh)


def vector_supercontinuum(
    *,
    t0_fs: float = 28.4,
    peak_kW: float = 10.0,
    theta_deg: float = 30.0,
    lambda_pump: float = 835e-9,
    gamma_W_m: float = 0.11,
    length_m: float = 0.15,
    f_raman: Optional[float] = None,
    n_samples: int = 8192,
    window_ps: float = 10.0,
    rtol: float = 1e-6,
    n_saved: int = 100,
    integrator: str = "rk45",
    precision: str = "x64",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Polarization-resolved supercontinuum: the Dudley PCF configuration
    propagated as a VECTOR field under the Manakov (random-birefringence)
    coupling with the isotropic-Raman response on the total power
    (``models/vgnlse._v_nl_rhs_gen``) -- the pump split at ``theta_deg``
    onto the polarization axes.  In the Manakov + isotropic-Raman limit
    the dynamics depend only on the total power, so the SC is the scalar
    one at gamma_eff = (8/9) gamma and the polarization state (hence the
    spectrally-resolved DOP) is preserved -- a nontrivial prediction this
    experiment makes visible; birefringent perturbations break it."""
    import numpy as _np

    from ..models import gnlse as gnl
    from ..models import vgnlse as vgl
    from ..ops.frequency_plan import omega_from_lambda

    t0 = float(t0_fs) * 1e-15
    omega_c = float(omega_from_lambda(lambda_pump))
    betas = {n: b * (1e-12 ** n) * 1e-3 for n, b in _SC_BETAS_PS_KM.items()}
    disp = DispersionParams.from_betas(omega_c, extra=betas)
    grid = gnl.TimeGrid(n_samples=int(n_samples),
                        t_window_s=float(window_ps) * 1e-12)
    coeffs = vgl.make_vgnlse_coeffs(grid, disp, gamma_W_m=float(gamma_W_m),
                                    coupling="manakov", precision=precision)
    if f_raman is None:
        f_raman = gnl.RAMAN_FRACTION_SILICA
    nl = gnl.make_nl_terms(grid, f_raman=float(f_raman), omega0=omega_c,
                           precision=precision)
    P0 = float(peak_kW) * 1e3
    n_steps = int(n_saved) * 100
    cfg = custom_simulation_config(
        z_max=float(length_m), dz=float(length_m) / n_steps,
        save_every=n_steps // int(n_saved), precision=precision,
        integrator=integrator, rtol=float(rtol), atol=1e-12,
    )
    A0 = vgl.polarized_pulse(gnl.sech_pulse(grid, peak_W=P0, t0_s=t0),
                             _np.deg2rad(theta_deg))
    z, A = vgl.run_vgnlse_simulation(cfg, coeffs, A0, nl=nl, device=device)
    if verbose:
        dop = vgl.degree_of_polarization(grid, A[-1])

        def bw30(field):
            S = _np.abs(_np.fft.fft(field)) ** 2
            keep = S > S.max() * 1e-3
            om = _np.fft.fftshift(grid.omega())
            idx = _np.nonzero(_np.fft.fftshift(keep))[0]
            return (om[idx[-1]] - om[idx[0]]) / (2 * _np.pi) * 1e-12
        print(
            f"vector supercontinuum [manakov] theta={theta_deg:g} deg: "
            f"-30 dB bandwidth x {bw30(A[0][0]):.1f} -> {bw30(A[-1][0]):.1f}"
            f" THz, y {bw30(A[0][1]):.1f} -> {bw30(A[-1][1]):.1f} THz; "
            f"output DOP {dop:.4f}"
        )
    if save_dir is not None:
        from pathlib import Path

        from ..io_fwm import save_result_npz

        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        save_result_npz(out / "vector_supercontinuum.npz", z,
                        A.reshape(A.shape[0], -1),
                        metadata=make_run_metadata(config=cfg),
                        overwrite=True)
    for p, name in ((0, "x"), (1, "y")):
        plotting.plot_spectral_evolution(
            z, grid.omega(), A[:, p], lambda0_m=lambda_pump,
            title=f"Vector supercontinuum ({name} polarization)", show=show,
            save_path=(None if save_dir is None
                       else f"{save_dir}/vector_supercontinuum_{name}.png"),
        )
    return z, A
