"""Command-line entry point: ``python -m psa_simulation_ode_rk_mvp_dispersion_tpu_torch``.

Counterpart of the JAX package's ``__main__.py``: the same subcommands,
flags and defaults for every experiment the port has, plus one global
option, ``--device`` (default ``cuda``), forwarded to every experiment.  The
command line runs on the CUDA card; without one it stops with an error
unless ``--device cpu`` is given.  The 4-wave sweeps (``spectrum``,
``spectrum-dbeta``, ``gain-map``, ``mismatch``, ``psa-phase``) run through
the kernels ``csrc/fwm4_rk.cu`` (rk4, ab4, abm4) and ``csrc/fwm4_rk45.cu``
(rk45).

Examples:
    python -m psa_simulation_ode_rk_mvp_dispersion_tpu_torch single --no-show
    python -m psa_simulation_ode_rk_mvp_dispersion_tpu_torch spectrum \
        --points 10000 --precision df32 --save-dir out --no-show
    python -m psa_simulation_ode_rk_mvp_dispersion_tpu_torch --device cpu \
        mismatch --span 60 --no-show
"""

from __future__ import annotations

import argparse
import sys

# Subcommands of the JAX package that wait for a later slice of the port,
# with the ROADMAP item that brings each.
WAITING = {
    "noise-figure": 15, "gain-ripple": 15, "squeezing": 15, "soliton-squeezing": 15,
    "jitter": 15, "link": 15, "mi-noise": 15,   # the Monte-Carlo noise slice
    "fit-gain": 16,                             # calibration
    "bench": 7,                                 # the port's benchmark
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
                   help="shard the batch over all local devices (not ported yet: "
                        "refused, ROADMAP item 17)")
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
                        "vacuum-seeded shots (not ported yet: N > 0 is refused, "
                        "ROADMAP item 15)")
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
    if args.integrator is not None and args.cmd in ("sbs", "comb", "kerr-cavity"):
        parser.error(
            f"--integrator is not honored by '{args.cmd}'"
            + (" (use --comb-integrator)" if args.cmd == "comb" else "")
        )
    if args.shard:
        parser.error("--shard is not ported: multi-device solves land with ROADMAP "
                     "item 17 (slice I)")
    if args.cmd == "supercontinuum" and args.coherence > 0:
        parser.error("--coherence needs the Monte-Carlo noise module, which is not "
                     "ported yet: ROADMAP item 15")

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise NoCardError(
            f"no CUDA card is available, and the command line runs on one "
            f"(--device {args.device}); pass --device cpu to run on the CPU "
            "(device='cpu' in the Python API)")
    from . import experiments as ex

    common = dict(
        precision=args.precision,
        show=not args.no_show,
        save_dir=args.save_dir,
        device=args.device,
    )
    sweep_common = dict(common, integrator=args.integrator or "rk4")
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
        kw = dict(theta_deg=args.theta) if args.vector else {}
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
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NoCardError as e:
        sys.exit(f"psa-torch: error: {e}")
