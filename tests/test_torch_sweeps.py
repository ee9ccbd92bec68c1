"""The port's remaining sweeps at fixed step, against the JAX package:
``mismatch_scan``, ``psa_phase_sweep``, ``gain_map_power_wavelength`` and
``solve_batch_trajectories`` (rk4, x64, the JAX scan engine), plus the
``GainMapResult`` container.

Tolerance: 1e-12 relative on gains and states (the same float64
arithmetic; ulp-level differences accumulate over the steps).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402

torch.set_num_threads(1)

GOLDEN_DIR = Path(__file__).parent / "golden"
RTOL = 1e-12


def _map_kwargs(pkg, n=5):
    g = np.load(GOLDEN_DIR / "golden_spectrum.npz")
    disp = pkg.dispersion_params_from_D_S(
        lambda_ref_m=float(g["lambda_c"]), D=float(g["D"]), S=float(g["S"]), dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=float(g["omega_c"]), compat_reference_beta4_bug=True,
    )
    lam3 = np.append(np.asarray(g["lam3"])[:n], 700e-9)   # the last one is invalid
    return dict(
        cfg=pkg.custom_simulation_config(z_max=60.0, dz=0.2, save_every=10),
        lambda_p1_m=float(g["lam1"]), lambda_p2_m=float(g["lam2"]), lambda_signal_m=lam3,
        pump_powers_W=[0.05, 0.1, 0.2], gamma=float(g["gamma"]), alpha=float(g["alpha"]),
        dispersion=disp,
        phase_matching_cfg=pkg.PhaseMatchingConfig(
            method=pkg.PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4),
        length_unit="m", gain_unit="dB",
    )


@pytest.mark.parametrize("gain_mode", ["end", "max"])
@pytest.mark.parametrize("frame", ["rotating", "lab"])
def test_mismatch_scan_matches_jax(gain_mode, frame):
    common = dict(gamma=10.0, alpha=0.1, p_in=[0.05, 0.05, 1e-5, 0.0],
                  delta_beta_values=np.linspace(-40.0, 40.0, 11), gain_mode=gain_mode,
                  gain_unit="linear", length_unit="km", frame=frame)
    sig, idl = T.mismatch_scan(cfg=T.custom_simulation_config(z_max=0.2, dz=1e-3), **common,
                               device="cpu")
    sj, ij = J.mismatch_scan(cfg=J.custom_simulation_config(z_max=0.2, dz=1e-3), **common,
                             engine="scan")
    np.testing.assert_array_equal(sig.x, sj.x)
    np.testing.assert_array_equal(sig.ok, sj.ok)
    assert sig.ok.all() and sig.gain_unit == sj.gain_unit == "linear"
    np.testing.assert_allclose(sig.gain, sj.gain, rtol=RTOL)
    np.testing.assert_allclose(idl.gain, ij.gain, rtol=RTOL)
    assert sig.best_index == sj.best_index


@pytest.mark.parametrize("phase_source", ["delta_beta", "provided", "dispersion"])
def test_psa_phase_sweep_matches_jax(phase_source):
    kw = dict(gamma=10.0, alpha=0.0, p_in=[0.1, 0.1, 1e-4, 1e-4],
              signal_phases=np.linspace(0, 2 * np.pi, 9), gain_unit="linear",
              length_unit="km")

    def extra(pkg):
        if phase_source == "delta_beta":
            return dict(delta_beta=3.0)
        if phase_source == "provided":
            return dict(phase_matching_cfg=pkg.PhaseMatchingConfig(
                method=pkg.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.5))
        om = np.asarray(J.plan_from_wavelengths(1550e-9, 1555e-9, 1560e-9))
        return dict(omega=om, dispersion=pkg.dispersion_params_from_D_S(
            1.5525e-6, 0.2, 0.02, D_units="ps/nm/km", S_units="ps/nm^2/km"))

    rt = T.psa_phase_sweep(cfg=T.custom_simulation_config(z_max=0.1, dz=1e-3), **kw,
                           **extra(T), device="cpu")
    rj = J.psa_phase_sweep(cfg=J.custom_simulation_config(z_max=0.1, dz=1e-3), **kw,
                           **extra(J), engine="scan")
    np.testing.assert_array_equal(rt.x, rj.x)
    np.testing.assert_array_equal(rt.ok, rj.ok)
    np.testing.assert_allclose(rt.gain, rj.gain, rtol=RTOL)
    assert rt.gain.max() / rt.gain.min() > 1.1       # phase-sensitive


def test_psa_phase_sweep_rejects_what_jax_rejects():
    kw = dict(cfg=T.custom_simulation_config(z_max=0.1, dz=1e-3), gamma=10.0, alpha=0.0,
              p_in=[0.1, 0.1, 1e-4, 1e-4], signal_phases=[0.0, 1.0], length_unit="km",
              device="cpu")
    with pytest.raises(ValueError, match="omega"):
        T.psa_phase_sweep(**kw, dispersion=T.dispersion_params_from_D_S(
            1.5525e-6, 0.2, 0.02, D_units="ps/nm/km", S_units="ps/nm^2/km"))
    with pytest.raises(ValueError, match="scalar"):
        T.psa_phase_sweep(**kw, phase_matching_cfg=T.PhaseMatchingConfig(
            method="provided", provided_delta_beta=[0.1, 0.2]))
    with pytest.raises(ValueError, match="signal seed"):
        T.psa_phase_sweep(**{**kw, "p_in": [0.1, 0.1, 0.0, 1e-4]})


@pytest.mark.parametrize("frame", ["rotating", "lab"])
def test_gain_map_power_wavelength_matches_jax(frame):
    gm = T.gain_map_power_wavelength(**_map_kwargs(T), frame=frame, device="cpu")
    gj = J.gain_map_power_wavelength(**_map_kwargs(J), frame=frame, engine="scan")
    assert isinstance(gm, T.GainMapResult) and gm.gain.shape == (3, 6)
    np.testing.assert_array_equal(gm.x, gj.x)
    np.testing.assert_array_equal(gm.pump_powers, gj.pump_powers)
    np.testing.assert_array_equal(gm.ok, gj.ok)
    assert not gm.ok[:, -1].any() and gm.ok[:, :-1].all()
    np.testing.assert_allclose(gm.gain, gj.gain, rtol=RTOL)
    assert gm.best_index == gj.best_index
    x, pows, gain = gm
    np.testing.assert_array_equal(gain, gm.gain)
    assert np.nanmax(gm.gain[2]) > np.nanmax(gm.gain[0])    # more pump, more gain


def test_gain_map_result_all_failed_raises():
    gm = T.GainMapResult(x=np.arange(3.0), pump_powers=np.ones(2), gain=np.full((2, 3), np.nan),
                         ok=np.zeros((2, 3), bool), gain_unit="db", elapsed_s=0.0,
                         points_per_s=0.0)
    with pytest.raises(ValueError, match="every gain-map cell failed"):
        gm.best_index


@pytest.mark.parametrize("integrator", ["rk4", "abm4"])
@pytest.mark.parametrize("frame", ["rotating", "lab"])
def test_solve_batch_trajectories_matches_jax(integrator, frame):
    B = 6
    rng = np.random.default_rng(0)
    co = dict(gamma=np.full(B, 0.01), alpha=np.full(B, 1e-4),
              delta_beta=rng.uniform(-0.5, 0.5, B))
    A0 = (np.sqrt([0.3, 0.3, 1e-5, 0.0])[None, :] * np.ones((B, 1))).astype(np.complex128)
    kw = dict(z_max=20.0, dz=0.1, save_every=10, integrator=integrator)
    z, A, ok = T.solve_batch_trajectories(T.custom_simulation_config(**kw), T.RHSCoeffs(**co),
                                          A0, frame=frame, device="cpu")
    zj, Aj, okj = J.solve_batch_trajectories(J.custom_simulation_config(**kw),
                                             J.RHSCoeffs(**co), A0, frame=frame)
    assert A.shape == (B, 21, 4) and A.dtype == np.complex128 and ok.all()
    np.testing.assert_array_equal(z, zj)
    np.testing.assert_array_equal(ok, okj)
    np.testing.assert_allclose(A, Aj, rtol=RTOL, atol=0)
    # the trajectory's summaries are solve_batch's
    r = T.solve_batch(T.custom_simulation_config(**kw), T.RHSCoeffs(**co), A0, frame=frame,
                      device="cpu")
    np.testing.assert_allclose(r.P_max, np.max(np.abs(A) ** 2, axis=1), rtol=RTOL)
    np.testing.assert_allclose(r.A_end, A[:, -1], rtol=RTOL)


def test_solve_batch_trajectories_x32_and_refusals():
    B = 3
    co = T.RHSCoeffs(np.full(B, 0.01), np.zeros(B), np.zeros(B))
    A0 = np.ones((B, 4), dtype=np.complex128) * 0.1
    cfg = T.custom_simulation_config(z_max=2.0, dz=0.1, save_every=5, precision="x32")
    z, A, ok = T.solve_batch_trajectories(cfg, co, A0, device="cpu")
    ref = T.solve_batch_trajectories(T.custom_simulation_config(z_max=2.0, dz=0.1, save_every=5),
                                     co, A0, device="cpu")[1]
    assert z.shape == (5,) and ok.all()
    np.testing.assert_allclose(A, ref, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="mesh"):
        T.solve_batch_trajectories(cfg, co, A0, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="frame"):
        T.solve_batch_trajectories(cfg, co, A0, frame="moving", device="cpu")
