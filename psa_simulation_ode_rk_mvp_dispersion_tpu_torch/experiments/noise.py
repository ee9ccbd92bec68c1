"""Quantum-noise experiments (Wigner Monte Carlo).

Counterpart of the JAX package's ``experiments/noise.py``: the same
functions, defaults, printed lines, data files and figures, plus
``device`` (``None``: the CUDA card), forwarded to every solve
(``parallel/noise.py``, ``parallel/link.py``).  The ensembles are the JAX
package's, draw for draw (``np.random.default_rng`` on the host)."""

from __future__ import annotations

from typing import Optional


from .. import plotting
from ..config import custom_simulation_config
from ..ops.frequency_plan import plan_from_wavelengths
from ._shared import _dispersion_at_pump_center


def noise_figure(
    *,
    z_max_m: float = 200.0,
    dz_m: float = 0.05,
    gamma_km: float = 5.0,
    alpha_db_km: float = 0.0,
    loss_model: str = "deterministic",
    n_loss_segments: int = 16,
    p_pump_W: float = 0.5,
    p_signal_W: float = 1e-6,
    n_samples: int = 8192,
    t_mode_s: float = 1e-9,
    phase_points: int = 17,
    spectrum_points: int = 0,
    seed: int = 0,
    mesh=None,
    precision: str = "x64",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Quantum-limited noise figures by Wigner Monte Carlo
    (``parallel/noise.py``): the PIA noise figure against the exact
    2 - 1/G law, the joint-detection PSA noise figure at the max-gain
    phase (the 0 dB quantum limit), and the NF-vs-input-phase curve --
    ``n_samples`` independent nonlinear solves per point, one batched
    solve each (one ``csrc/fwm4_rk.cu`` launch on the card; the measurement
    the reference's deterministic solver cannot make)."""
    import numpy as _np

    from ..models.fwm4 import make_initial_amplitudes
    from ..ops.rhs import RHSCoeffs
    from ..parallel import noise as nz
    from ..parallel.sweep import solve_batch
    from ..utils.units import alpha_db_per_km_to_1_m

    omega = _np.asarray(plan_from_wavelengths(1550e-9, 1552e-9, 1551.0e-9))
    cfg = custom_simulation_config(z_max=z_max_m, dz=dz_m, save_every=50,
                                   precision=precision)
    gam = gamma_km / 1e3
    al = alpha_db_per_km_to_1_m(alpha_db_km)
    common = dict(gamma=gam, alpha=al, omega=omega, delta_beta=0.0,
                  t_mode_s=t_mode_s, n_samples=n_samples,
                  noisy_waves=(False, False, True, True), mesh=mesh, device=device,
                  loss_model=loss_model, n_loss_segments=n_loss_segments)

    pia = nz.noise_figure_monte_carlo(
        cfg, p_in=[p_pump_W, p_pump_W, p_signal_W, 0.0],
        measure="signal", seed=seed, **common,
    )
    G = 10.0 ** (pia.gain_db / 10.0)
    pia_theory = 10.0 * _np.log10(2.0 - 1.0 / G)

    # max-gain phase from a mean-field scan, then the joint-detection PSA NF
    phases = _np.linspace(0.0, 2.0 * _np.pi, 65)
    A0 = _np.stack([
        _np.asarray(make_initial_amplitudes(
            [p_pump_W, p_pump_W, p_signal_W / 2, p_signal_W / 2],
            [0, 0, ph, 0]))
        for ph in phases
    ])
    co = RHSCoeffs(gamma=_np.full(65, gam), alpha=_np.full(65, al),
                   delta_beta=_np.zeros(65))
    mf = solve_batch(cfg, co, A0, device=device)
    ph_max = float(phases[_np.argmax(mf.P_end[:, 2] + mf.P_end[:, 3])])
    psa_r = nz.noise_figure_monte_carlo(
        cfg, p_in=[p_pump_W, p_pump_W, p_signal_W / 2, p_signal_W / 2],
        phase_in=[0, 0, ph_max, 0], measure="signal+idler",
        seed=seed + 1, **common,
    )
    if verbose:
        print(
            f"PIA:  gain {pia.gain_db:6.2f} dB  NF {pia.nf_db:6.3f} "
            f"+- {pia.nf_se_db:.3f} dB  "
            f"(theory 2-1/G: {pia_theory:.3f} dB)  [{pia.n_samples} samples]"
        )
        print(
            f"PSA:  gain {psa_r.gain_db:6.2f} dB  NF {psa_r.nf_db:6.3f} "
            f"+- {psa_r.nf_se_db:.3f} dB  "
            f"(quantum limit: 0 dB)  at phase {_np.rad2deg(ph_max):.1f} deg"
        )

    if save_dir is not None:
        from pathlib import Path

        Path(save_dir).mkdir(parents=True, exist_ok=True)
    curve = None
    if phase_points and phase_points > 0:
        ph_grid = _np.linspace(0.0, _np.pi, int(phase_points))
        nf_c, g_c = [], []
        for k, ph in enumerate(ph_grid):
            r = nz.noise_figure_monte_carlo(
                cfg, p_in=[p_pump_W, p_pump_W, p_signal_W / 2, p_signal_W / 2],
                phase_in=[0, 0, float(ph), 0], measure="signal+idler",
                seed=seed + 100 + k, **common,
            )
            nf_c.append(r.nf_db)
            g_c.append(r.gain_db)
        curve = (ph_grid, _np.asarray(nf_c), _np.asarray(g_c))
        if save_dir is not None:
            _np.savez(
                f"{save_dir}/noise_figure.npz",
                phase_rad=ph_grid, nf_db=curve[1], gain_db=curve[2],
                pia_nf_db=pia.nf_db, pia_gain_db=pia.gain_db,
                pia_nf_theory_db=pia_theory,
                psa_nf_db=psa_r.nf_db, psa_gain_db=psa_r.gain_db,
                n_samples=n_samples,
            )
        plotting.plot_noise_figure_sweep(
            ph_grid, curve[1], curve[2], pia_nf_db=pia_theory, show=show,
            save_path=None if save_dir is None else f"{save_dir}/noise_figure.png",
        )

    spec = None
    if spectrum_points and spectrum_points > 0:
        if loss_model == "langevin" and al != 0.0 and verbose:
            print(
                "note: the NF(lambda) spectrum panel attenuates "
                "deterministically (noise_figure_spectrum has no langevin "
                "path); headline PIA/PSA numbers above DO include the "
                "loss-model noise"
            )
        # NF(lambda) across a dispersion-shaped gain band (PIA measurement);
        # dispersion expanded at the pump-center frequency, the expansion
        # point the symmetric-even delta-beta formula assumes
        lam3 = _np.linspace(1545e-9, 1640e-9, int(spectrum_points))
        _, _, disp = _dispersion_at_pump_center(
            1550e-9, 1555e-9, float(lam3[0]), D=0.2, S=0.02
        )
        spec = nz.noise_figure_spectrum(
            cfg,
            lambda_p1_m=1550e-9, lambda_p2_m=1555e-9, lambda_signal_m=lam3,
            gamma=gam, alpha=al, p_in=[p_pump_W, p_pump_W, p_signal_W, 0.0],
            dispersion=disp, length_unit="m", t_mode_s=t_mode_s,
            n_samples=n_samples, measure="signal",
            seed=seed + 10_000_019,  # disjoint from the phase-curve seeds
            mesh=mesh, device=device,
        )
        G_l = 10.0 ** (spec.gain_db / 10.0)
        nf_t = 10.0 * _np.log10(2.0 - 1.0 / _np.maximum(G_l, 1.0 + 1e-12))
        if verbose:
            dev = _np.nanmax(_np.abs(spec.nf_db - nf_t))
            print(
                f"NF spectrum: {int(spectrum_points)} wavelengths, max "
                f"|NF - (2-1/G)| = {dev:.3f} dB"
            )
        if save_dir is not None:
            _np.savez(f"{save_dir}/noise_figure_spectrum.npz",
                      wavelength=spec.wavelength, nf_db=spec.nf_db,
                      gain_db=spec.gain_db, dbeta_1_m=spec.dbeta_1_m,
                      nf_theory_db=nf_t, n_samples=n_samples)
        plotting.plot_noise_figure_spectrum(
            spec.wavelength, spec.nf_db, spec.gain_db, nf_theory_db=nf_t,
            show=show,
            save_path=None if save_dir is None
            else f"{save_dir}/noise_figure_spectrum.png",
        )
    return pia, psa_r, curve, spec


def squeezing(
    *,
    z_max_m: float = 150.0,
    dz_m: float = 0.05,
    gamma_km: float = 5.0,
    p_pump_W: float = 0.5,
    n_samples: int = 8192,
    t_mode_s: float = 1e-9,
    seed: int = 0,
    mesh=None,
    precision: str = "x64",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Vacuum squeezing of a dual-pump PSA
    (``parallel/noise.psa_squeezing_monte_carlo``): propagate vacuum
    signal/idler modes through the amplifier and measure the quadrature
    noise ellipses -- the joint (+45 deg) superposition squeezes below the
    vacuum while staying at minimum uncertainty; the single signal mode
    alone shows a thermal ellipse.  Plots both ellipses against the vacuum
    circle."""
    import numpy as _np

    from ..parallel import noise as nz

    omega = _np.asarray(plan_from_wavelengths(1550e-9, 1552e-9, 1551e-9))
    cfg = custom_simulation_config(z_max=z_max_m, dz=dz_m, save_every=50,
                                  precision=precision)
    sig, joint = nz.psa_squeezing_monte_carlo(
        cfg, gamma=gamma_km / 1e3, alpha=0.0, omega=omega,
        p_pump_W=p_pump_W, t_mode_s=t_mode_s, n_samples=n_samples,
        seed=seed, mesh=mesh, device=device,
    )
    if verbose:
        print(
            f"joint (s+i)/sqrt2 mode: squeezing {joint.squeezing_db:+.2f} dB, "
            f"antisqueezing {joint.antisqueezing_db:+.2f} dB, "
            f"v_min*v_max = {joint.uncertainty_product:.5f} "
            f"(min uncertainty 1/16 = {1/16:.5f})"
        )
        print(
            f"signal mode alone:      squeezing {sig.squeezing_db:+.2f} dB "
            f"(thermal, no single-mode squeezing)"
        )
    if save_dir is not None:
        from pathlib import Path

        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        _np.savez(
            out / "squeezing.npz",
            **{f"sig_{k}": getattr(sig, k) for k in
               ("v_min", "v_max", "theta_min", "squeezing_db",
                "antisqueezing_db", "uncertainty_product")},
            **{f"joint_{k}": getattr(joint, k) for k in
               ("v_min", "v_max", "theta_min", "squeezing_db",
                "antisqueezing_db", "uncertainty_product")},
            n_samples=n_samples,
        )
    plotting.plot_squeezing_ellipses(
        sig, joint, show=show,
        save_path=None if save_dir is None else f"{save_dir}/squeezing.png",
    )
    return sig, joint


def soliton_squeezing(
    *,
    t0_s: float = 1e-12,
    beta2_s2_m: float = -2.0e-26,
    gamma_W_m: float = 2e-3,
    omega0_rad_s: float = 1.2e15,
    periods: float = 3.0,
    points: int = 24,
    n_samples: int = 2048,
    n_t: int = 256,
    seed: int = 0,
    mesh=None,
    precision: str = "x64",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Quantum squeezing of a fundamental soliton along the fiber
    (``parallel/noise.pulse_squeezing_evolution``): a truncated-Wigner
    vacuum ensemble rides the batched GNLSE engine through ``periods``
    soliton periods and the self-adapted homodyne ellipse is measured at
    ``points`` distances -- the Carter & Drummond (PRL 58, 1841) fiber
    soliton squeezing experiment the reference's CW 4-wave solver cannot
    express."""
    import numpy as _np

    from ..models import gnlse as _gn
    from ..models.gnlse import sech_pulse, soliton_peak_power
    from ..ops.dispersion import DispersionParams
    from ..parallel import noise as nz

    grid = _gn.TimeGrid.for_pulse(t0_s, n_samples=n_t)
    disp = DispersionParams.from_betas(omega0_rad_s, beta2=beta2_s2_m)
    co = _gn.make_gnlse_coeffs(grid, disp, gamma_W_m=gamma_W_m,
                               precision=precision)
    P0 = soliton_peak_power(beta2_s2_m, gamma_W_m, t0_s)
    A0 = _np.asarray(sech_pulse(grid, peak_W=P0, t0_s=t0_s))
    z_period = 0.5 * _np.pi * t0_s**2 / abs(beta2_s2_m)
    z_max = float(periods) * z_period
    # ~40 fixed steps between measurements keeps the soliton resolved
    save_every = 40
    dz = z_max / (int(points) * save_every)
    cfg = custom_simulation_config(z_max=z_max, dz=dz,
                                   save_every=save_every,
                                   precision=precision)
    ev = nz.pulse_squeezing_evolution(
        cfg, co, A0, grid, omega0=omega0_rad_s, n_samples=n_samples,
        seed=seed, mesh=mesh, device=device,
    )
    # direct-detection counterpart: photon statistics behind the
    # out-of-sample optimal spectral filter (needs >= 4*n_t lanes)
    ph = None
    if int(n_samples) >= 4 * int(n_t):
        try:
            ph = nz.pulse_photon_statistics(
                cfg, co, A0, grid, omega0=omega0_rad_s, n_samples=n_samples,
                seed=seed + 1, mesh=mesh, device=device, optimal_filter=True,
            )
        except (ValueError, FloatingPointError) as e:
            # diverged lanes can drop the surviving count below the 4*T
            # covariance floor; keep the squeezing result rather than
            # losing the whole experiment
            if verbose:
                print(f"photon statistics skipped: {e}")
    if verbose:
        k = ev.best_index
        print(
            f"fundamental soliton: P0 = {P0*1e3:.3g} mW, period "
            f"z0 = {z_period:.3g} m, N = {n_samples} Wigner samples"
        )
        print(
            f"best squeezing {ev.squeezing_db[k]:+.2f} dB at "
            f"z = {ev.z_m[k]:.3g} m ({ev.z_m[k]/z_period:.2f} periods); "
            f"antisqueezing {ev.antisqueezing_db[k]:+.2f} dB; "
            f"uncertainty product {ev.uncertainty_product[k]:.4f} "
            f"(bound 1/16 = {1/16:.4f})"
        )
        if ph is not None:
            print(
                f"direct detection: total Fano {ph.total_fano:.3f} (shot "
                f"noise 1); optimally filtered Fano {ph.filtered_fano:.3f} "
                f"({ph.filtered_photons:.3g} photons)"
            )
    if save_dir is not None:
        from pathlib import Path

        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        _np.savez(
            out / "soliton_squeezing.npz",
            z_m=ev.z_m, squeezing_db=ev.squeezing_db,
            antisqueezing_db=ev.antisqueezing_db, v_min=ev.v_min,
            v_max=ev.v_max, theta_min=ev.theta_min,
            uncertainty_product=ev.uncertainty_product,
            mean_photons=ev.mean_photons, n_samples=ev.n_samples,
            z_period_m=z_period, peak_W=P0,
            **({} if ph is None else dict(
                photon_omega=ph.omega, photon_n_mean=ph.n_mean,
                photon_fano=ph.fano, photon_total_fano=ph.total_fano,
                photon_filter_w=ph.filter_w,
                photon_filtered_fano=ph.filtered_fano)),
        )
    plotting.plot_pulse_squeezing_evolution(
        ev, show=show,
        save_path=None if save_dir is None
        else f"{save_dir}/soliton_squeezing.png",
    )
    if ph is not None:
        plotting.plot_photon_statistics(
            ph, show=show,
            save_path=None if save_dir is None
            else f"{save_dir}/soliton_photon_statistics.png",
        )
    return ev


def mi_sideband_noise(
    *,
    p_pump_W: float = 1.0,
    gamma_W_m: float = 2e-3,
    beta2_s2_m: float = -2.0e-26,
    omega0_rad_s: float = 1.2e15,
    nonlinear_lengths: float = 3.0,
    n_t: int = 256,
    n_samples: int = 4096,
    seed: int = 0,
    mesh=None,
    precision: str = "x64",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Quantum noise of modulation instability: a CW pump in the
    anomalous regime parametrically amplifies vacuum sidebands -- the
    measurement sweeps the sideband squeezing spectrum
    (``pulse_squeezing_spectrum``) and the shot-to-shot coherence
    (``pulse_coherence_monte_carlo``) across the MI band and checks the
    antisqueezing peak against the classical MI gain maximum
    Omega_c/sqrt(2), Omega_c = sqrt(4 gamma P / |beta2|)."""
    import numpy as _np

    from ..models import gnlse as _gn
    from ..parallel import noise as nz

    from ..ops.dispersion import DispersionParams

    grid = _gn.TimeGrid.for_pulse(1e-12, n_samples=int(n_t))
    disp = DispersionParams.from_betas(omega0_rad_s, beta2=beta2_s2_m)
    co = _gn.make_gnlse_coeffs(grid, disp, gamma_W_m=gamma_W_m,
                               precision=precision)
    A0 = _np.full(int(n_t), _np.sqrt(p_pump_W), dtype=complex)
    z = float(nonlinear_lengths) / (gamma_W_m * p_pump_W)
    steps = 400
    cfg = custom_simulation_config(z_max=z, dz=z / steps, save_every=steps,
                                   precision=precision)
    # ONE propagated ensemble; both statistics are reductions of it
    sp, coh = nz.pulse_squeezing_spectrum(cfg, co, A0, grid,
                                          omega0=omega0_rad_s,
                                          n_samples=n_samples, seed=seed,
                                          mesh=mesh, device=device, return_coherence=True)
    om = grid.omega()
    Oc = _np.sqrt(4.0 * gamma_W_m * p_pump_W / abs(beta2_s2_m))
    k = int(_np.nanargmax(sp.antisqueezing_db))
    if verbose:
        print(
            f"MI band edge Omega_c = {Oc:.4g} rad/s; antisqueezing peak at "
            f"|Omega| = {abs(om[k]):.4g} (theory Omega_c/sqrt2 = "
            f"{Oc/_np.sqrt(2):.4g}), {sp.antisqueezing_db[k]:+.1f} dB; "
            f"squeezing there {sp.squeezing_db[k]:+.1f} dB "
            f"(uncertainty product {sp.uncertainty_product[k]:.4f})"
        )
        inband = (_np.abs(om) > 0.3 * Oc) & (_np.abs(om) < 0.9 * Oc)
        print(
            f"coherence: pump line |g12| = {coh.g12[0]:.4f}; MI band mean "
            f"|g12| = {coh.g12[inband].mean():.4f} (vacuum-seeded, "
            f"incoherent)"
        )
    if save_dir is not None:
        from pathlib import Path

        Path(save_dir).mkdir(parents=True, exist_ok=True)
        _np.savez(
            f"{save_dir}/mi_noise.npz",
            omega=sp.omega, v_min=sp.v_min, v_max=sp.v_max,
            squeezing_db=sp.squeezing_db,
            antisqueezing_db=sp.antisqueezing_db,
            uncertainty_product=sp.uncertainty_product,
            g12=coh.g12, g12_avg=coh.g12_avg, omega_c=Oc,
            n_samples=n_samples,
        )
    plotting.plot_squeezing_spectrum(
        sp, title="Modulation-instability sideband noise", show=show,
        save_path=None if save_dir is None else f"{save_dir}/mi_noise.png",
    )
    plotting.plot_spectral_coherence(
        coh, title="Modulation-instability spectral coherence", show=show,
        save_path=None if save_dir is None
        else f"{save_dir}/mi_coherence.png",
    )
    return sp, coh


def soliton_jitter(
    *,
    t0_s: float = 1e-12,
    beta2_s2_m: float = -2.0e-26,
    gamma_W_m: float = 2e-3,
    omega0_rad_s: float = 1.2e15,
    alpha_db_km: float = 8.7,
    periods: float = 3.0,
    points: int = 16,
    n_samples: int = 1024,
    n_t: int = 256,
    seed: int = 0,
    mesh=None,
    precision: str = "x64",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Soliton timing / frequency / energy jitter along the fiber
    (``parallel/noise.pulse_moment_statistics``): a vacuum-seeded Wigner
    ensemble of fundamental solitons is propagated twice -- lossless,
    where exact per-lane NLSE theorems pin every curve (photon number
    and spectral centroid conserved; the timing variance follows the
    dispersive law Var_t(z) = Var_t(0) - 2 beta2 z Cov(t,f) +
    (beta2 z)^2 Var_f with NO linearization), and with distributed loss
    (``loss_model='langevin'``), where each loss segment injects fresh
    vacuum that diffuses the soliton's center frequency -- the
    Gordon-Haus timing-jitter mechanism (Gordon & Haus, Opt. Lett. 11,
    665) that limits soliton links.  The reference's CW 4-wave solver
    has no pulse, no quantum noise, and no loss-noise coupling to
    express any of this."""
    import numpy as _np

    from ..models import gnlse as _gn
    from ..models.gnlse import sech_pulse, soliton_peak_power
    from ..ops.dispersion import DispersionParams
    from ..parallel import noise as nz
    from ..utils.units import alpha_db_per_km_to_1_m

    grid = _gn.TimeGrid.for_pulse(t0_s, n_samples=n_t)
    disp = DispersionParams.from_betas(omega0_rad_s, beta2=beta2_s2_m)
    P0 = soliton_peak_power(beta2_s2_m, gamma_W_m, t0_s)
    A0 = _np.asarray(sech_pulse(grid, peak_W=P0, t0_s=t0_s))
    z_period = 0.5 * _np.pi * t0_s**2 / abs(beta2_s2_m)
    z_max = float(periods) * z_period
    save_every = 40
    dz = z_max / (int(points) * save_every)
    cfg = custom_simulation_config(z_max=z_max, dz=dz,
                                   save_every=save_every,
                                   precision=precision)
    co = _gn.make_gnlse_coeffs(grid, disp, gamma_W_m=gamma_W_m,
                               precision=precision)
    ms = nz.pulse_moment_statistics(
        cfg, co, A0, grid, omega0=omega0_rad_s, n_samples=n_samples,
        seed=seed, mesh=mesh, device=device)
    alpha = alpha_db_per_km_to_1_m(alpha_db_km)
    col = _gn.make_gnlse_coeffs(grid, disp, gamma_W_m=gamma_W_m,
                                alpha_1_m=alpha, precision=precision)
    ml = nz.pulse_moment_statistics(
        cfg, col, A0, grid, omega0=omega0_rad_s, n_samples=n_samples,
        seed=seed, mesh=mesh, device=device, loss_model="langevin")
    if verbose:
        z = ms.z_m
        pred = (ms.t_var[0] - 2.0 * beta2_s2_m * z * ms.tf_cov[0]
                + (beta2_s2_m * z) ** 2 * ms.f_var[0])
        law_err = float(_np.max(_np.abs(ms.t_var / pred - 1.0)))
        print(
            f"fundamental soliton: P0 = {P0*1e3:.3g} mW, period "
            f"z0 = {z_period:.3g} m, N = {ms.n_samples} Wigner samples"
        )
        print(
            f"lossless: energy conserved to "
            f"{float(_np.max(_np.abs(ms.energy_mean/ms.energy_mean[0]-1))):.1e}, "
            f"f_var flat to "
            f"{float(_np.max(_np.abs(ms.f_var/ms.f_var[0]-1))):.1e}; "
            f"timing spread {_np.sqrt(ms.t_var[0])*1e15:.2f} -> "
            f"{_np.sqrt(ms.t_var[-1])*1e15:.2f} fs on the exact "
            f"dispersive law (max dev {law_err:.1e})"
        )
        print(
            f"langevin loss {alpha_db_km:g} dB/km: frequency diffusion "
            f"Var_f x{float(ml.f_var[-1]/ml.f_var[0]):.2f} drives timing "
            f"spread to {_np.sqrt(ml.t_var[-1])*1e15:.2f} fs "
            f"(+{100*float(_np.sqrt(ml.t_var[-1]/ms.t_var[-1])-1):.0f}% "
            f"over lossless -- the Gordon-Haus mechanism)"
        )
    if save_dir is not None:
        from pathlib import Path

        Path(save_dir).mkdir(parents=True, exist_ok=True)
        _np.savez(
            f"{save_dir}/soliton_jitter.npz",
            z_m=ms.z_m, t_var=ms.t_var, f_var=ms.f_var,
            tf_cov=ms.tf_cov, energy_mean=ms.energy_mean,
            energy_var=ms.energy_var,
            t_var_loss=ml.t_var, f_var_loss=ml.f_var,
            tf_cov_loss=ml.tf_cov, energy_mean_loss=ml.energy_mean,
            beta2_s2_m=beta2_s2_m, alpha_db_km=alpha_db_km,
            z_period_m=z_period, peak_W=P0, n_samples=ms.n_samples,
        )
    plotting.plot_moment_statistics(
        ms, ml, beta2_s2_m=beta2_s2_m,
        labels=("lossless", f"langevin {alpha_db_km:g} dB/km"),
        title="Soliton timing / frequency jitter (Gordon-Haus)",
        show=show,
        save_path=None if save_dir is None
        else f"{save_dir}/soliton_jitter.png",
    )
    return ms, ml


def soliton_link(
    *,
    t0_s: float = 1e-12,
    beta2_s2_m: float = -2.0e-26,
    gamma_W_m: float = 2e-3,
    omega0_rad_s: float = 1.2e15,
    span_m: float = 50.0,
    n_spans: int = 20,
    alpha_db_km: float = 21.7,
    n_sp: float = 1.0,
    steps_per_span: int = 25,
    n_samples: int = 2048,
    n_t: int = 256,
    seed: int = 0,
    mesh=None,
    precision: str = "x64",
    show: bool = True,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
):
    """Soliton transmission over a chain of lossy spans and lumped
    amplifiers (``parallel/link.pulse_link_monte_carlo``): each
    amplifier restores the span loss exactly but must inject ASE, whose
    frequency kicks dispersion converts into the cubically accumulating
    Gordon-Haus timing jitter (Gordon & Haus, Opt. Lett. 11, 665) -- the
    fundamental bit-error floor of amplified soliton links.  The same
    chain with the ASE (unphysically) switched off is run as the control:
    its frequency spread stays frozen at the LAUNCH vacuum level, so its
    timing jitter grows only by the quadratic dispersive conversion of
    the launch noise -- the cubic ASE excess on top of it is the
    Gordon-Haus signature."""
    import numpy as _np

    from ..models import gnlse as _gn
    from ..models.gnlse import sech_pulse, soliton_peak_power
    from ..ops.dispersion import DispersionParams
    from ..parallel.link import pulse_link_monte_carlo, span_observed_length_m
    from ..utils.units import alpha_db_per_km_to_1_m

    grid = _gn.TimeGrid.for_pulse(t0_s, n_samples=n_t)
    disp = DispersionParams.from_betas(omega0_rad_s, beta2=beta2_s2_m)
    alpha = alpha_db_per_km_to_1_m(alpha_db_km)
    co = _gn.make_gnlse_coeffs(grid, disp, gamma_W_m=gamma_W_m,
                               alpha_1_m=alpha, precision=precision)
    P0 = soliton_peak_power(beta2_s2_m, gamma_W_m, t0_s)
    A0 = _np.asarray(sech_pulse(grid, peak_W=P0, t0_s=t0_s))
    cfg = custom_simulation_config(
        z_max=float(span_m), dz=float(span_m) / int(steps_per_span),
        save_every=int(steps_per_span), precision=precision)
    kw = dict(omega0=omega0_rad_s, n_spans=int(n_spans), n_sp=float(n_sp),
              n_samples=n_samples, seed=seed, mesh=mesh, device=device)
    ms = pulse_link_monte_carlo(cfg, co, A0, grid, **kw)
    mc = pulse_link_monte_carlo(cfg, co, A0, grid, ase=False, **kw)
    z_span = span_observed_length_m(cfg)
    G_db = 10.0 * _np.log10(_np.exp(alpha * z_span))
    if verbose:
        z_period = 0.5 * _np.pi * t0_s**2 / abs(beta2_s2_m)
        print(
            f"soliton link: {n_spans} x {z_span:g} m spans "
            f"({n_spans*z_span/z_period:.1f} soliton periods), span loss = "
            f"amp gain = {G_db:.2f} dB, n_sp = {n_sp:g}, "
            f"N = {ms.n_samples} Wigner samples"
        )
        print(
            f"ASE frequency diffusion: Var_f x{float(ms.f_var[-1]/ms.f_var[0]):.1f} "
            f"(control x{float(mc.f_var[-1]/mc.f_var[0]):.2f}); timing jitter "
            f"{_np.sqrt(ms.t_var[0])*1e15:.2f} -> {_np.sqrt(ms.t_var[-1])*1e15:.2f} fs "
            f"(control {_np.sqrt(mc.t_var[-1])*1e15:.2f} fs) -- the "
            f"Gordon-Haus accumulation"
        )
    if save_dir is not None:
        from pathlib import Path

        Path(save_dir).mkdir(parents=True, exist_ok=True)
        _np.savez(
            f"{save_dir}/soliton_link.npz",
            z_m=ms.z_m, t_var=ms.t_var, f_var=ms.f_var, tf_cov=ms.tf_cov,
            energy_mean=ms.energy_mean, energy_var=ms.energy_var,
            t_var_control=mc.t_var, f_var_control=mc.f_var,
            span_m=z_span, n_spans=n_spans, amp_gain_db=G_db, n_sp=n_sp,
            beta2_s2_m=beta2_s2_m, alpha_db_km=alpha_db_km,
            peak_W=P0, n_samples=ms.n_samples,
        )
    plotting.plot_moment_statistics(
        ms, mc, beta2_s2_m=beta2_s2_m,
        labels=("amplified link (ASE)", "ASE off (control)"),
        title="Soliton link: Gordon-Haus timing jitter",
        show=show,
        save_path=None if save_dir is None
        else f"{save_dir}/soliton_link.png",
    )
    return ms, mc
