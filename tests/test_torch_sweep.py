"""The slice as a whole: the port's gain-spectrum sweep and single-run
runner vs the JAX package and vs the golden data of the executed NumPy
reference.

Tolerances:

- port vs JAX at x64 on the same inputs: rtol 1e-12 on gain and dbeta (the
  same float64 arithmetic; ulp-level rounding differences accumulate over
  the steps);
- lab frame vs the reference goldens: rtol 1e-9, the bar of
  ``tests/test_sweep.py`` and ``tests/test_simulation_parity.py`` (the lab
  frame is the reference's own discretization);
- x32 vs x64 in linear gain: 1e-4 (the float32 class).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402

torch.set_num_threads(1)

GOLDEN_DIR = Path(__file__).parent / "golden"


def _max_rel_err(A, A_ref):
    return float(np.max(np.abs(A - A_ref) / np.maximum(np.abs(A_ref), 1e-30)))


def _spectrum_kwargs(pkg, golden, *, frame, n=None, z_max=500.0, **cfg_kw):
    g = np.load(GOLDEN_DIR / golden)
    disp = pkg.dispersion_params_from_D_S(
        lambda_ref_m=float(g["lambda_c"]), D=float(g["D"]), S=float(g["S"]), dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=float(g["omega_c"]), compat_reference_beta4_bug=True,
    )
    lam3 = np.asarray(g["lam3"])[:n]
    return dict(
        cfg=pkg.custom_simulation_config(z_max=z_max, dz=0.2, **cfg_kw),
        lambda_p1_m=float(g["lam1"]), lambda_p2_m=float(g["lam2"]),
        lambda_signal_m=lam3, gamma=float(g["gamma"]), alpha=float(g["alpha"]),
        p_in=np.asarray(g["p_in"]), phase_in=np.zeros(4), dispersion=disp,
        phase_matching_cfg=pkg.PhaseMatchingConfig(
            method=pkg.PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4),
        length_unit="m", gain_unit="dB", frame=frame,
    ), g


@pytest.mark.parametrize("frame", ["lab", "rotating"])
@pytest.mark.parametrize("integrator", ["rk4", "abm4"])
def test_gain_and_dbeta_spectrum_matches_jax(frame, integrator):
    """Includes a signal at 700 nm, whose inferred idler frequency is
    negative: masked to NaN in gain and dbeta by both packages."""
    kw_t, g = _spectrum_kwargs(T, "golden_spectrum.npz", frame=frame, n=8, z_max=50.0,
                               integrator=integrator)
    kw_j, _ = _spectrum_kwargs(J, "golden_spectrum.npz", frame=frame, n=8, z_max=50.0,
                               integrator=integrator)
    lam3 = np.append(np.asarray(g["lam3"])[:8], 700e-9)
    kw_t["lambda_signal_m"] = kw_j["lambda_signal_m"] = lam3
    rt = T.gain_and_dbeta_spectrum(**kw_t, device="cpu")
    rj = J.gain_and_dbeta_spectrum(**kw_j, engine="scan")
    assert np.isnan(rt.gain[-1]) and np.isnan(rt.dbeta[-1]) and not rt.ok[-1]
    np.testing.assert_array_equal(rt.ok, rj.ok)
    np.testing.assert_array_equal(rt.x, rj.x)
    np.testing.assert_allclose(rt.gain, rj.gain, rtol=1e-12, atol=0)
    np.testing.assert_allclose(rt.dbeta, rj.dbeta, rtol=1e-12, atol=0)
    x_t, db_t = T.dbeta_spectrum(**{k: kw_t[k] for k in (
        "lambda_p1_m", "lambda_p2_m", "lambda_signal_m", "dispersion", "phase_matching_cfg")},
        device="cpu")
    np.testing.assert_allclose(db_t, rj.dbeta, rtol=1e-12, atol=0)


def test_bench_config_gain_spectrum_golden():
    """The main path's configuration (bench.py:190-220), 16 points, lab
    frame, against the executed reference (tests/test_sweep.py:259-284)."""
    kw, g = _spectrum_kwargs(T, "golden_bench_config.npz", frame="lab")
    res = T.gain_spectrum(**kw, device="cpu")
    assert res.dbeta is None and res.ok.all()
    np.testing.assert_allclose(res.gain, np.asarray(g["gain_db"]), rtol=1e-9, atol=1e-8)


def test_gain_and_dbeta_spectrum_golden():
    kw, g = _spectrum_kwargs(T, "golden_spectrum.npz", frame="lab", n=16)
    res = T.gain_and_dbeta_spectrum(**kw, device="cpu")
    np.testing.assert_allclose(res.x, np.asarray(g["lam3"]) * 1e9, rtol=1e-12)
    np.testing.assert_allclose(res.gain, np.asarray(g["gain_db"]), rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(res.dbeta, np.asarray(g["dbeta"]), rtol=1e-9)


def test_x32_tier_tracks_x64():
    kw, _ = _spectrum_kwargs(T, "golden_bench_config.npz", frame="rotating", n=6, z_max=200.0)
    kw["device"] = "cpu"
    ref = T.gain_spectrum(**kw)
    kw["cfg"] = T.custom_simulation_config(z_max=200.0, dz=0.2, precision="x32")
    fast = T.gain_spectrum(**kw)
    err = np.max(np.abs(10 ** (fast.gain / 10) / 10 ** (ref.gain / 10) - 1))
    assert err < 1e-4
    kw["cfg"] = T.custom_simulation_config(z_max=200.0, dz=0.2, precision="df32")
    np.testing.assert_array_equal(T.gain_spectrum(**kw).gain, ref.gain)


def test_solve_batch_engines_and_chunked_progress():
    B = 40
    cfg = T.custom_simulation_config(z_max=5.0, dz=0.1, save_every=10)
    coeffs = T.RHSCoeffs(np.full(B, 0.0115), np.full(B, 1e-4), np.linspace(-0.5, 0.5, B))
    A0 = np.broadcast_to(np.sqrt([0.3, 0.3, 1e-6, 0.0]).astype(np.complex128), (B, 4))
    one = T.solve_batch(cfg, coeffs, A0, device="cpu")
    plain = T.solve_batch(cfg, coeffs, A0, engine="torch", device="cpu")
    seen = []
    chunked = T.solve_batch(cfg, coeffs, A0, device="cpu", progress_chunk=16,
                            progress=lambda d, t, e: seen.append((d, t)))
    assert seen == [(16, B), (32, B), (40, B)]
    for f in ("P_max", "P_end", "A_end", "ok"):
        np.testing.assert_array_equal(getattr(plain, f), getattr(one, f))
    # torch's CPU kernels round a SIMD body and its scalar tail differently,
    # so a lane's last bit can depend on where it sits in the batch
    np.testing.assert_array_equal(chunked.ok, one.ok)
    for f in ("P_max", "A_end"):
        np.testing.assert_allclose(getattr(chunked, f), getattr(one, f), rtol=1e-13, atol=0)


# ---------------------------------------------------------------------------
# single-run runner
# ---------------------------------------------------------------------------

def _anchor(pkg):
    """The main_single_simulation configuration
    (tests/test_simulation_parity.py:47-65)."""
    omega = np.asarray(J.plan_from_wavelengths(1550e-9, 1560e-9, 1555e-9))
    sp = J.infer_symmetry_from_omegas(*omega)
    disp = pkg.dispersion_params_from_D_S(
        lambda_ref_m=float(J.lambda_from_omega(sp.omega_c)), D=0.02, S=0.02, dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=float(np.asarray(sp.omega_c)), compat_reference_beta4_bug=True,
    )
    return dict(
        gamma=11.5 / 1000.0, alpha=(np.log(10.0) / 10.0) * 0.9 / 1000.0, omega=omega,
        p_in=np.array([0.5, 0.5, 1e-5, 1e-5]), phase_in=np.zeros(4), dispersion=disp,
        phase_matching_cfg=pkg.PhaseMatchingConfig(
            method=pkg.PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4),
        length_unit="m", return_length_unit="m",
    )


def test_anchor_trajectory_golden():
    g = np.load(GOLDEN_DIR / "golden_anchor.npz")
    z, A = T.run_single_simulation(T.custom_simulation_config(z_max=1000.0, dz=0.1),
                                   **_anchor(T), device="cpu")
    np.testing.assert_allclose(z, g["z"], rtol=1e-12)
    assert _max_rel_err(A, g["A"]) < 1e-9
    gain_db = 10 * np.log10(np.abs(A[-1, 2]) ** 2 / 1e-5)
    assert gain_db == pytest.approx(float(g["gain_db"]), abs=1e-6)
    assert gain_db == pytest.approx(45.292, abs=1e-3)


@pytest.mark.parametrize("name,golden", [("example_zero_signal", "golden_zero_signal.npz"),
                                         ("custom_seeded_signal", "golden_seeded.npz")])
def test_example_runs_golden(name, golden):
    g = np.load(GOLDEN_DIR / golden)
    z, A = getattr(T, name)(device="cpu")
    np.testing.assert_allclose(z, g["z"], rtol=1e-12)
    assert _max_rel_err(A, g["A"]) < 1e-9


@pytest.mark.parametrize("frame", ["lab", "rotating"])
@pytest.mark.parametrize("integrator", ["rk4", "ab4"])
def test_run_single_matches_jax_and_resumes(frame, integrator):
    kw_t, kw_j = _anchor(T), _anchor(J)
    cfg_t = T.custom_simulation_config(z_max=60.0, dz=0.2, save_every=7, integrator=integrator)
    cfg_j = J.custom_simulation_config(z_max=60.0, dz=0.2, save_every=7, integrator=integrator)
    z_t, A_t = T.run_single_simulation(cfg_t, **kw_t, frame=frame, device="cpu")
    z_j, A_j = J.run_single_simulation(cfg_j, **kw_j, frame=frame)
    np.testing.assert_array_equal(z_t, z_j)
    np.testing.assert_allclose(A_t, A_j, rtol=1e-12, atol=0)
    # resume from the last saved row: continues with lab-frame phase continuity
    cfg2 = T.custom_simulation_config(z_max=14.0, dz=0.2, save_every=7, integrator=integrator)
    z2, A2 = T.run_single_simulation(cfg2, **kw_t, frame=frame, z0=z_t[-1], A_init=A_t[-1],
                                     device="cpu")
    z2j, A2j = J.run_single_simulation(
        J.custom_simulation_config(z_max=14.0, dz=0.2, save_every=7, integrator=integrator),
        **kw_j, frame=frame, z0=z_j[-1], A_init=A_j[-1])
    np.testing.assert_allclose(z2, z2j, rtol=1e-15)
    np.testing.assert_allclose(A2, A2j, rtol=1e-12, atol=0)


def test_run_single_errors():
    pm = T.PhaseMatchingConfig(method="provided", provided_delta_beta=0.0)
    cfg = T.custom_simulation_config(z_max=10.0, dz=0.5)
    with pytest.raises(FloatingPointError, match="step"):
        T.run_single_simulation(cfg, gamma=1e3, alpha=0.0, omega=np.full(4, 1.2e15),
                                p_in=[1e8, 1e8, 1.0, 0.0], phase_matching_cfg=pm, device="cpu")
    with pytest.raises(ValueError):
        T.run_single_simulation(cfg, gamma=1.0, alpha=0.0, omega=np.full(3, 1.2e15),
                                p_in=[0.1, 0.1, 0, 0], phase_matching_cfg=pm, device="cpu")
    with pytest.raises(ValueError):
        T.run_single_simulation(cfg, gamma=1.0, alpha=0.0, omega=np.full(4, 1.2e15),
                                p_in=[0.1, 0.1, 0, 0], phase_matching_cfg=pm,
                                length_unit="miles", device="cpu")
    with pytest.raises(ValueError):
        T.run_single_simulation(cfg, gamma=1.0, alpha=0.0, omega=np.full(4, 1.2e15),
                                p_in=[0.1, 0.1, 0, 0], device="cpu")
