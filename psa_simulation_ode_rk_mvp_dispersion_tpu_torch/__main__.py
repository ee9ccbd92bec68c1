"""Command-line entry point: ``python -m psa_simulation_ode_rk_mvp_dispersion_tpu_torch``.

Counterpart of the JAX package's ``__main__.py``: the same subcommands,
flags and defaults for every experiment the port has, plus one global
option, ``--device`` (default ``cuda``), forwarded to every experiment.  The
command line runs on the CUDA card; without one it stops with an error
unless ``--device cpu`` is given.  The 4-wave sweeps (``spectrum``,
``spectrum-dbeta``, ``gain-map``, ``mismatch``, ``psa-phase``) run through
the kernels ``csrc/fwm4_rk.cu`` (rk4, ab4, abm4) and ``csrc/fwm4_rk45.cu``
(rk45); the Monte-Carlo subcommands (``noise-figure``, ``gain-ripple``,
``squeezing``, ``soliton-squeezing``, ``jitter``, ``link``, ``mi-noise``,
and ``supercontinuum --coherence N``) run their ensembles through the
4-wave kernel and the GNLSE kernel ``csrc/gnlse_ssfm.cu``; ``fit-gain``
fits a ``mismatch`` archive with one launch of the tangent kernel
``csrc/fwm4_tangent.cu`` an adam step.
``--shard`` splits each batch over the cards of ``--device``
(``parallel/mesh.default_mesh``); on one card it runs unsharded, as in the
JAX package.

Examples:
    python -m psa_simulation_ode_rk_mvp_dispersion_tpu_torch single --no-show
    python -m psa_simulation_ode_rk_mvp_dispersion_tpu_torch spectrum \
        --points 10000 --precision df32 --save-dir out --no-show
    python -m psa_simulation_ode_rk_mvp_dispersion_tpu_torch --device cpu \
        mismatch --span 60 --no-show
    python -m psa_simulation_ode_rk_mvp_dispersion_tpu_torch noise-figure \
        --spectrum-points 64 --save-dir out --no-show
    python -m psa_simulation_ode_rk_mvp_dispersion_tpu_torch fit-gain \
        out/mismatch_scan.npz --save-dir out --no-show
"""

from __future__ import annotations

import argparse
import sys

# Subcommands of the JAX package that wait for a later slice of the port,
# with the ROADMAP item that brings each.
WAITING = {
    "bench": 7,       # the port's benchmark
}


class NoCardError(RuntimeError):
    """The command line was asked to run on a CUDA card that is not there."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="psa-torch",
        description="PyTorch / CUDA four-wave-mixing / PSA simulator",
    )
    p.add_argument("--precision", default="x64", choices=("x64", "x32", "df32"),
                   help="dtype tier (x64 = float64, reference parity; x32 = float32; "
                        "df32 = the JAX package's two-float tier, run in float64 on "
                        "the card)")
    p.add_argument("--integrator", default=None,
                   choices=("rk4", "rk45", "ab4", "abm4", "rk4ip", "rk4ip45"),
                   help="stepper (default: rk4, except supercontinuum which "
                        "defaults to rk45; ab4/abm4 = Adams multistep, ODE "
                        "families; rk4ip/rk4ip45 = fixed/adaptive "
                        "interaction-picture RK4, split-step families; "
                        "commands/families that cannot honor an explicit "
                        "choice raise)")
    p.add_argument("--shard", action="store_true",
                   help="shard the batch over all local devices (default_mesh over "
                        "the cards of --device; one card runs unsharded)")
    p.add_argument("--device", default="cuda",
                   help="torch device every solve runs on (default: the CUDA card; "
                        "'cpu' for the CPU)")
    p.add_argument("--save-dir", default=None, help="write result bundles here")
    p.add_argument("--no-show", action="store_true", help="do not open plot windows")
    p.add_argument("--quiet", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("single", help="single dual-pump simulation (45.292 dB anchor)")
    s.add_argument("--z-max", type=float, default=1000.0, help="fiber length [m]")
    s.add_argument("--dz", type=float, default=0.1, help="step [m]")
    s.add_argument("--lambda-signal", type=float, default=1555e-9)

    s = sub.add_parser("spectrum", help="signal-wavelength gain spectrum")
    s.add_argument("--points", type=int, default=100)

    s = sub.add_parser("spectrum-dbeta", help="gain + dbeta spectrum")
    s.add_argument("--points", type=int, default=30)

    s = sub.add_parser("mismatch", help="gain vs provided phase mismatch")
    s.add_argument("--span", type=float, default=40.0, help="+-span [1/km]")
    s.add_argument("--points", type=int, default=200)
    s.add_argument("--gain-mode", default="end", choices=("end", "max"))

    s = sub.add_parser("psa-phase", help="PSA gain vs input signal phase")
    s.add_argument("--points", type=int, default=181)

    s = sub.add_parser("gain-map", help="2-D pump power x wavelength gain map")
    s.add_argument("--wavelengths", type=int, default=100)

    s = sub.add_parser("comb", help="N-wave cascaded FWM comb generation")
    s.add_argument("--lines", type=int, default=64)
    s.add_argument("--z-max", type=float, default=100.0, help="fiber length [m]")
    s.add_argument("--comb-integrator", default="rk45",
                   choices=("rk4", "rk45", "ab4", "abm4"))
    s.add_argument("--coupling", default="fft", choices=("fft", "dft", "einsum"),
                   help="cubic-sum evaluation (dft = dense matmuls)")

    s = sub.add_parser("kerr-cavity",
                       help="LLE microresonator soliton comb (laser-scan "
                            "protocol, normalized units)")
    s.add_argument("--pump", type=float, default=2.0,
                   help="normalized pump amplitude F")
    s.add_argument("--det-start", type=float, default=-2.0)
    s.add_argument("--det-end", type=float, default=4.5,
                   help="final detuning (soliton existence needs Delta <= pi^2 F^2 / 8)")
    s.add_argument("--lifetimes", type=float, default=150.0,
                   help="ramp duration [photon lifetimes]")
    s.add_argument("--samples", type=int, default=256,
                   help="fast-time samples (comb lines)")
    s.add_argument("--d2", type=float, default=-1.0,
                   help="normalized GVD (negative = anomalous)")

    s = sub.add_parser("gnlse", help="GNLSE pulse propagation (split-step Fourier)")
    s.add_argument("--t0", type=float, default=1.0, help="pulse duration T0 [ps]")
    s.add_argument("--n-soliton", type=float, default=3.0,
                   help="soliton order N (peak power = N^2 |beta2|/gamma/T0^2)")
    s.add_argument("--beta2", type=float, default=-20.0, help="beta2 [ps^2/km]")
    s.add_argument("--periods", type=float, default=1.0,
                   help="propagation length in soliton periods")
    s.add_argument("--samples", type=int, default=1024, help="time samples")
    s.add_argument("--steps", type=int, default=4000, help="split steps")
    s.add_argument("--raman", action="store_true",
                   help="delayed silica Raman response (f_R=0.18)")
    s.add_argument("--steepening", action="store_true",
                   help="self-steepening / optical-shock term at the carrier")

    s = sub.add_parser("vgnlse", help="vector (two-polarization) pulse "
                                      "propagation (Manakov / coupled NLSE)")
    s.add_argument("--t0", type=float, default=1.0, help="pulse T0 [ps]")
    s.add_argument("--n-soliton", type=float, default=1.0, help="soliton order")
    s.add_argument("--theta", type=float, default=30.0,
                   help="polarization angle [deg]")
    s.add_argument("--coupling", default="manakov",
                   choices=("manakov", "cnlse", "isotropic"))
    s.add_argument("--dbeta1", type=float, default=0.0,
                   help="group birefringence [ps/km]")
    s.add_argument("--periods", type=float, default=1.0,
                   help="propagation length in soliton periods")
    s.add_argument("--raman", action="store_true",
                   help="delayed Raman response on the total power "
                        "(isotropic-Raman approximation, f_R=0.18)")
    s.add_argument("--steepening", action="store_true",
                   help="self-steepening / optical-shock term")

    s = sub.add_parser("supercontinuum",
                       help="PCF supercontinuum by soliton fission (GNLSE "
                            "with Raman + shock + beta2..7, adaptive rk45)")
    s.add_argument("--t0", type=float, default=28.4, help="pulse T0 [fs]")
    s.add_argument("--peak", type=float, default=10.0, help="peak power [kW]")
    s.add_argument("--length", type=float, default=0.15, help="fiber [m]")
    s.add_argument("--samples", type=int, default=8192, help="time samples")
    s.add_argument("--rtol", type=float, default=1e-6,
                   help="adaptive relative tolerance")
    s.add_argument("--vector", action="store_true",
                   help="polarization-resolved (Manakov + isotropic-Raman "
                        "vector propagation)")
    s.add_argument("--coherence", type=int, default=0, metavar="N",
                   help="also measure shot-to-shot spectral coherence over N "
                        "vacuum-seeded shots (0 disables; scalar only)")
    s.add_argument("--theta", type=float, default=30.0,
                   help="pump polarization angle [deg] (with --vector)")

    s = sub.add_parser("sbs", help="coupled FWM + SBS forward/backward solve")
    s.add_argument("--z-max", type=float, default=200.0, help="fiber length [m]")
    s.add_argument("--gb", type=float, default=150.0, help="Brillouin gain [1/(W km)]")
    s.add_argument("--tol", type=float, default=1e-10,
                   help="relaxation stops when the B-field residual drops below this")
    s.add_argument("--damping", type=float, default=1.0,
                   help="under-relaxation factor (use <1 above SBS threshold)")
    s.add_argument("--max-iterations", type=int, default=200)

    s = sub.add_parser("noise-figure",
                       help="quantum-limited NF by Wigner Monte Carlo "
                            "(PIA 3 dB law, PSA 0 dB limit, NF vs phase)")
    s.add_argument("--samples", type=int, default=8192,
                   help="Monte-Carlo ensemble size per point")
    s.add_argument("--z-max", type=float, default=200.0, help="fiber [m]")
    s.add_argument("--phase-points", type=int, default=17,
                   help="NF-vs-phase curve resolution (0 disables)")
    s.add_argument("--spectrum-points", type=int, default=0,
                   help="NF-vs-wavelength spectrum resolution (0 disables)")
    s.add_argument("--alpha-db-km", type=float, default=0.0,
                   help="fiber loss [dB/km]")
    s.add_argument("--loss-model", default="deterministic",
                   choices=("deterministic", "langevin"),
                   help="'langevin' injects distributed-loss vacuum "
                        "(beamsplitter model; quantum-correct NF)")
    s.add_argument("--loss-segments", type=int, default=16,
                   help="langevin injection segments (must divide the "
                        "observed step count)")

    s = sub.add_parser("gain-ripple",
                       help="fiber-yield Monte Carlo: gain statistics under "
                            "longitudinal delta-beta wander")
    s.add_argument("--realizations", type=int, default=4096)
    s.add_argument("--segments", type=int, default=20,
                   help="delta-beta correlation segments along the fiber")
    s.add_argument("--sigma", type=float, default=0.02,
                   help="delta-beta standard deviation [1/m]")

    s = sub.add_parser("squeezing",
                       help="PSA vacuum squeezing: quadrature noise "
                            "ellipses by Wigner Monte Carlo")
    s.add_argument("--samples", type=int, default=8192)
    s.add_argument("--z-max", type=float, default=150.0, help="fiber [m]")

    s = sub.add_parser("soliton-squeezing",
                       help="quantum soliton squeezing along the fiber "
                            "(truncated-Wigner MC on the GNLSE solver)")
    s.add_argument("--samples", type=int, default=2048,
                   help="Wigner ensemble size")
    s.add_argument("--periods", type=float, default=3.0,
                   help="propagation length in soliton periods")
    s.add_argument("--points", type=int, default=24,
                   help="measurement distances along the fiber")

    s = sub.add_parser("jitter",
                       help="soliton timing/frequency jitter statistics: "
                            "exact dispersive law vs Gordon-Haus onset "
                            "under langevin loss")
    s.add_argument("--samples", type=int, default=1024,
                   help="Wigner ensemble size")
    s.add_argument("--periods", type=float, default=3.0,
                   help="propagation length in soliton periods")
    s.add_argument("--points", type=int, default=16,
                   help="measurement distances along the fiber")
    s.add_argument("--alpha-db-km", type=float, default=8.7,
                   help="distributed loss for the langevin run [dB/km]")

    s = sub.add_parser("link",
                       help="soliton transmission over lossy spans + lumped "
                            "amplifiers: Gordon-Haus jitter accumulation "
                            "(ASE vs noiseless control)")
    s.add_argument("--samples", type=int, default=2048,
                   help="Wigner ensemble size")
    s.add_argument("--spans", type=int, default=20,
                   help="number of fiber spans / amplifiers")
    s.add_argument("--span-m", type=float, default=50.0,
                   help="span length [m]")
    s.add_argument("--alpha-db-km", type=float, default=21.7,
                   help="span loss [dB/km] (amp gain restores it)")
    s.add_argument("--nsp", type=float, default=1.0,
                   help="amplifier spontaneous factor (>= 1)")

    s = sub.add_parser("mi-noise",
                       help="modulation-instability quantum sidebands: "
                            "squeezing spectrum + shot-to-shot coherence")
    s.add_argument("--samples", type=int, default=4096)
    s.add_argument("--nonlinear-lengths", type=float, default=3.0,
                   help="propagation distance in units of 1/(gamma P)")

    s = sub.add_parser("fit-gain",
                       help="calibrate (gamma, alpha, delta-beta offset) "
                            "from a saved mismatch sweep NPZ by gradient "
                            "descent through the solver")
    s.add_argument("npz", help="mismatch_scan.npz artifact (gain_mode=end)")
    s.add_argument("--p-pump", type=float, default=0.1,
                   help="per-pump launch power [W] used in the sweep")
    s.add_argument("--p-signal", type=float, default=1e-5)
    s.add_argument("--init-gamma", type=float, default=8.0,
                   help="starting gamma [1/(W km)]")
    s.add_argument("--steps", type=int, default=500)
    s.add_argument("--lr", type=float, default=0.05)
    return p


def _subcommand(parser: argparse.ArgumentParser, argv) -> str:
    """The first word of ``argv`` that is neither a global option nor the
    value of one."""
    takes_value = {s for a in parser._actions if a.nargs != 0 for s in a.option_strings}
    words = iter(argv)
    for w in words:
        if w in takes_value:
            next(words, None)
        elif not w.startswith("-"):
            return w
    return ""


def main(argv=None) -> int:
    parser = build_parser()
    if argv is None:
        argv = sys.argv[1:]
    if not list(argv):
        # zero-argument parity with the reference entry point (reference
        # main.py:283-284 runs the dbeta + gain spectrum with no arguments):
        # default to the spectrum-dbeta demo, on the card like every run
        # (PSA_TPU_DEMO_POINTS trims the grid for smoke tests)
        import os as _os

        argv = ["spectrum-dbeta",
                "--points", _os.environ.get("PSA_TPU_DEMO_POINTS", "30")]
    cmd = _subcommand(parser, argv)
    if cmd in WAITING:
        parser.error(f"'{cmd}' is not ported yet: it comes with ROADMAP item {WAITING[cmd]}")
    args = parser.parse_args(argv)
    if args.integrator is not None and args.cmd in (
            "sbs", "noise-figure", "comb", "gain-ripple", "squeezing",
            "soliton-squeezing", "jitter", "link", "mi-noise", "fit-gain", "kerr-cavity"):
        parser.error(
            f"--integrator is not honored by '{args.cmd}'"
            + (" (use --comb-integrator)" if args.cmd == "comb" else "")
        )
    if args.cmd == "supercontinuum" and args.vector and args.coherence:
        parser.error("--coherence is scalar-only (drop --vector)")

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise NoCardError(
            f"no CUDA card is available, and the command line runs on one "
            f"(--device {args.device}); pass --device cpu to run on the CPU "
            "(device='cpu' in the Python API)")
    from . import experiments as ex

    mesh = None
    if args.shard:
        from .parallel.mesh import default_mesh

        mesh = default_mesh(device=args.device)
    common = dict(
        precision=args.precision,
        show=not args.no_show,
        save_dir=args.save_dir,
        device=args.device,
    )
    sweep_common = dict(common, integrator=args.integrator or "rk4", mesh=mesh)
    verbose = not args.quiet

    if args.cmd == "single":
        ex.single_simulation(
            z_max_m=args.z_max, dz_m=args.dz, lambda_signal=args.lambda_signal,
            verbose=verbose, integrator=args.integrator or "rk4", **common,
        )
    elif args.cmd == "spectrum":
        ex.gain_spectrum(n_points=args.points, verbose=verbose, **sweep_common)
    elif args.cmd == "spectrum-dbeta":
        ex.gain_spectrum_dbeta(n_points=args.points, verbose=verbose, **sweep_common)
    elif args.cmd == "mismatch":
        ex.mismatch_scan(
            span=args.span, n_points=args.points, gain_mode=args.gain_mode,
            verbose=verbose, **sweep_common,
        )
    elif args.cmd == "psa-phase":
        ex.psa_phase_sweep(n_points=args.points, verbose=verbose, **sweep_common)
    elif args.cmd == "gain-map":
        ex.gain_map(n_wavelengths=args.wavelengths, **sweep_common)
    elif args.cmd == "comb":
        ex.comb(n_lines=args.lines, z_max_m=args.z_max,
                integrator=args.comb_integrator, coupling=args.coupling,
                verbose=verbose, **common)
    elif args.cmd == "kerr-cavity":
        ex.kerr_cavity(
            pump=args.pump, detuning_start=args.det_start,
            detuning_end=args.det_end, lifetimes=args.lifetimes,
            n_samples=args.samples, d2=args.d2, verbose=verbose, **common,
        )
    elif args.cmd == "gnlse":
        ex.gnlse_pulse(
            t0_ps=args.t0, n_soliton=args.n_soliton, beta2_ps2_km=args.beta2,
            n_periods=args.periods, n_samples=args.samples, n_steps=args.steps,
            raman=args.raman, steepening=args.steepening,
            integrator=args.integrator or "rk4", verbose=verbose, **common,
        )
    elif args.cmd == "vgnlse":
        ex.vector_pulse(
            t0_ps=args.t0, n_soliton=args.n_soliton, theta_deg=args.theta,
            coupling=args.coupling, dbeta1_ps_km=args.dbeta1,
            n_periods=args.periods, integrator=args.integrator or "rk4",
            raman=args.raman, steepening=args.steepening,
            verbose=verbose, **common,
        )
    elif args.cmd == "supercontinuum":
        fn = (ex.vector_supercontinuum if args.vector
              else ex.supercontinuum)
        kw = (dict(theta_deg=args.theta) if args.vector
              else dict(coherence_samples=args.coherence, mesh=mesh))
        fn(
            t0_fs=args.t0, peak_kW=args.peak, length_m=args.length,
            n_samples=args.samples, rtol=args.rtol,
            integrator=args.integrator or "rk45",
            verbose=verbose, **kw, **common,
        )
    elif args.cmd == "sbs":
        ex.fwm_sbs(z_max_m=args.z_max, g_B_km=args.gb, verbose=verbose,
                   tol=args.tol, damping=args.damping,
                   max_iterations=args.max_iterations,
                   **{k: v for k, v in common.items() if k != "precision"})
    elif args.cmd == "noise-figure":
        ex.noise_figure(
            z_max_m=args.z_max, n_samples=args.samples,
            phase_points=args.phase_points,
            spectrum_points=args.spectrum_points,
            alpha_db_km=args.alpha_db_km, loss_model=args.loss_model,
            n_loss_segments=args.loss_segments, mesh=mesh, verbose=verbose, **common,
        )
    elif args.cmd == "gain-ripple":
        ex.gain_ripple(
            n_realizations=args.realizations, n_segments=args.segments,
            sigma_dbeta_1_m=args.sigma, mesh=mesh, verbose=verbose, **common,
        )
    elif args.cmd == "squeezing":
        ex.squeezing(n_samples=args.samples, z_max_m=args.z_max, mesh=mesh,
                     verbose=verbose, **common)
    elif args.cmd == "soliton-squeezing":
        ex.soliton_squeezing(
            n_samples=args.samples, periods=args.periods, points=args.points,
            mesh=mesh, verbose=verbose, **common,
        )
    elif args.cmd == "jitter":
        ex.soliton_jitter(
            n_samples=args.samples, periods=args.periods, points=args.points,
            alpha_db_km=args.alpha_db_km, mesh=mesh, verbose=verbose, **common,
        )
    elif args.cmd == "link":
        ex.soliton_link(
            n_samples=args.samples, n_spans=args.spans, span_m=args.span_m,
            alpha_db_km=args.alpha_db_km, n_sp=args.nsp, mesh=mesh, verbose=verbose,
            **common,
        )
    elif args.cmd == "mi-noise":
        ex.mi_sideband_noise(
            n_samples=args.samples, nonlinear_lengths=args.nonlinear_lengths, mesh=mesh,
            verbose=verbose, **common,
        )
    elif args.cmd == "fit-gain":
        ex.fit_gain(
            args.npz, p_pump_W=args.p_pump, p_signal_W=args.p_signal,
            init_gamma_km=args.init_gamma, steps=args.steps,
            learning_rate=args.lr, verbose=verbose, **common,
        )
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NoCardError as e:
        sys.exit(f"psa-torch: error: {e}")
