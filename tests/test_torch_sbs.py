"""The port's FWM + SBS relaxation (``models/sbs.py``) on the CPU: the cases
of the JAX package's ``tests/test_sbs.py`` and the warm start of
``tests/test_resume_observability.py`` on the port, and the port against
the JAX package on the same relaxation.

Tolerances: the golden ``solve_bvp`` oracle within 1e-6 (the JAX test's
bar; the frozen-field RK4 interpolation limits it); the port against the
JAX package at x64 within 1e-12 relative, with the same sweep count where
a ``tol`` above 0 stops the run (both run the same RK4 in float64; they
round the FWM products and the backward sweep's running product
differently); a batch equal to its lanes solved alone bit for bit.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import sbs as jsbs  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import sbs  # noqa: E402

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden" / "golden_sbs_bvp.npz"


def _run(g_B, p_stokes=1e-6, alpha=0.0, gamma=2.0, db=0.5, z_max=10.0,
         dz=0.01, p_in=(0.1, 0.1, 1e-5, 0.0), iters=20):
    cfg = T.custom_simulation_config(z_max=z_max, dz=dz, save_every=10)
    return sbs.run_sbs_simulation(
        cfg, gamma=gamma, alpha=alpha, g_B=g_B, delta_beta=db,
        p_in=list(p_in), p_stokes_seed=[0.0, 0.0, p_stokes, 0.0],
        length_unit="m", n_iterations=iters, device="cpu",
    )


def test_fully_coupled_depleted_matches_solve_bvp_golden_and_jax():
    """The scipy solve_bvp oracle (54% pump depletion, 63% Stokes
    reflectivity) within 1e-6, converged; and the JAX package's relaxation
    on the same inputs: the same sweep count, A and B within 1e-12."""
    g = np.load(GOLDEN)
    kw = dict(gamma=float(g["gamma"]), alpha=float(g["alpha"]), g_B=float(g["g_B"]),
              delta_beta=float(g["delta_beta"]), p_in=g["p_in"], p_stokes_seed=g["p_stokes"],
              length_unit="m", damping=0.5, tol=1e-13, max_iterations=2000)
    res = sbs.run_sbs_simulation(
        T.custom_simulation_config(z_max=float(g["L"]), dz=0.002, save_every=50), **kw,
        device="cpu")
    A_ref = g["A_re"] + 1j * g["A_im"]
    B_ref = g["B_re"] + 1j * g["B_im"]
    np.testing.assert_allclose(res.z, g["z"], atol=1e-12)
    assert res.residual < 1e-12          # converged, not budget-capped
    assert res.n_iterations < 2000
    assert np.max(np.abs(res.A - A_ref)) < 1e-6
    assert np.max(np.abs(res.B - B_ref)) < 1e-6

    ref = jsbs.run_sbs_simulation(
        J.custom_simulation_config(z_max=float(g["L"]), dz=0.002, save_every=50), **kw)
    assert res.n_iterations == ref.n_iterations
    np.testing.assert_array_equal(res.z, ref.z)
    np.testing.assert_allclose(res.A, ref.A, rtol=1e-12, atol=0)
    np.testing.assert_allclose(res.B, ref.B, rtol=1e-12, atol=0)
    np.testing.assert_allclose(res.reflectivity, ref.reflectivity, rtol=1e-12, atol=0)


def test_gb_zero_forward_equals_plain_fwm():
    """With g_B=0 the forward waves must match the plain 4-wave solver."""
    res = _run(g_B=0.0, alpha=0.01)
    pm = T.PhaseMatchingConfig(method=T.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.5)
    omega0 = 2 * np.pi * T.constants.c / 1.55e-6
    cfg = T.custom_simulation_config(z_max=10.0, dz=0.01, save_every=10)
    z, A = T.run_single_simulation(
        cfg, gamma=2.0, alpha=0.01, omega=np.full(4, omega0),
        p_in=[0.1, 0.1, 1e-5, 0.0], phase_matching_cfg=pm, length_unit="m",
        frame="rotating", device="cpu",
    )
    np.testing.assert_allclose(res.z, z, rtol=1e-12)
    np.testing.assert_allclose(res.A, A, rtol=1e-9, atol=1e-14)


def test_gb_zero_backward_is_analytic():
    """g_B=0: B decouples, dB/dz = (alpha/2) B, B(L) given
    -> |B(z)|^2 = P_L e^{alpha (z - L)}."""
    alpha, L, P_L = 0.05, 10.0, 1e-6
    res = _run(g_B=0.0, alpha=alpha, p_stokes=P_L)
    P_B = np.abs(res.B[:, 2]) ** 2
    np.testing.assert_allclose(P_B, P_L * np.exp(alpha * (res.z - L)), rtol=1e-7)


def test_undepleted_pump_stokes_gain():
    """Weak Stokes on a strong quasi-constant forward wave: Brillouin
    amplification |B(0)|^2 = P_L e^{(gB P_A - alpha) L} to first order."""
    gB, PA, L = 0.4, 0.2, 10.0
    cfg = T.custom_simulation_config(z_max=L, dz=0.01, save_every=10)
    res = sbs.run_sbs_simulation(
        cfg, gamma=0.0, alpha=0.0, g_B=gB, delta_beta=0.0,
        p_in=[PA, 0.0, 0.0, 0.0], p_stokes_seed=[1e-8, 0.0, 0.0, 0.0],
        length_unit="m", n_iterations=25, device="cpu",
    )
    got = np.abs(res.B[0, 0]) ** 2
    assert got == pytest.approx(1e-8 * np.exp(gB * PA * L), rel=0.02)
    assert res.residual < 1e-10


def test_pump_depletion_energy_bookkeeping():
    """Strong SBS: the forward wave loses exactly the power the Stokes gains
    (lossless medium, photon-energy-degenerate approximation):
    d/dz (P_A - P_B) = 0 along z."""
    cfg = T.custom_simulation_config(z_max=5.0, dz=0.005, save_every=20)
    res = sbs.run_sbs_simulation(
        cfg, gamma=0.0, alpha=0.0, g_B=2.0, delta_beta=0.0,
        p_in=[0.5, 0.0, 0.0, 0.0], p_stokes_seed=[2e-3, 0.0, 0.0, 0.0],
        length_unit="m", n_iterations=90, device="cpu",
    )
    P_A = np.abs(res.A[:, 0]) ** 2
    P_B = np.abs(res.B[:, 0]) ** 2
    invariant = P_A - P_B
    np.testing.assert_allclose(invariant, invariant[0], rtol=1e-5)
    assert P_A[-1] < 0.95 * P_A[0]
    assert res.residual < 1e-8
    assert res.reflectivity[0] > 0.05


def test_convergence_residual_reported():
    r5 = _run(g_B=1.0, p_stokes=1e-5, iters=3)
    r20 = _run(g_B=1.0, p_stokes=1e-5, iters=20)
    assert r20.residual <= r5.residual
    assert r20.residual < 1e-10
    assert r5.n_iterations == 3 and r20.n_iterations <= 20


def test_strong_coupling_requires_damping_and_converges_and_matches_jax():
    """Above the SBS threshold (gB*P*L = 10) plain alternating sweeps
    oscillate; under-relaxation restores convergence with heavy pump
    depletion and conserved P_A - P_B; the damped run's A, B and
    reflectivity are the JAX package's within 1e-12.  The sweep counts are
    not held: with ``tol`` 0 a run stops early only at a residual of
    exactly 0, which one package may reach and the other, a rounding
    apart, may not (both then sit at the rounding's level)."""
    common = dict(gamma=0.0, alpha=0.0, g_B=2.0, delta_beta=0.0,
                  p_in=[0.5, 0, 0, 0], p_stokes_seed=[2e-3, 0, 0, 0], length_unit="m")
    cfg = T.custom_simulation_config(z_max=10.0, dz=0.01, save_every=10)
    undamped = sbs.run_sbs_simulation(cfg, n_iterations=60, **common, device="cpu")
    assert undamped.residual > 1e-2  # oscillating, reported honestly

    damped = sbs.run_sbs_simulation(cfg, n_iterations=400, damping=0.3, **common,
                                    device="cpu")
    assert damped.residual < 1e-10
    assert damped.reflectivity[0] > 0.5  # strong Stokes conversion
    P_A = np.abs(damped.A[:, 0]) ** 2
    P_B = np.abs(damped.B[:, 0]) ** 2
    inv = P_A - P_B
    np.testing.assert_allclose(inv, inv[0], rtol=1e-5)

    ref = jsbs.run_sbs_simulation(J.custom_simulation_config(z_max=10.0, dz=0.01, save_every=10),
                                  n_iterations=400, damping=0.3, **common)
    np.testing.assert_array_equal(damped.z, ref.z)
    np.testing.assert_allclose(damped.A, ref.A, rtol=1e-12, atol=0)
    np.testing.assert_allclose(damped.B, ref.B, rtol=1e-12, atol=0)
    np.testing.assert_allclose(damped.reflectivity, ref.reflectivity, rtol=1e-12, atol=0)
    assert ref.residual < 1e-12 and damped.residual < 1e-12


def test_damping_validation():
    cfg = T.custom_simulation_config(z_max=1.0, dz=0.01)
    kw = dict(gamma=0.0, alpha=0.0, g_B=1.0, delta_beta=0.0,
              p_in=[0.1, 0, 0, 0], p_stokes_seed=[1e-6, 0, 0, 0], device="cpu")
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="damping"):
            sbs.run_sbs_simulation(cfg, damping=bad, **kw)
    with pytest.raises(ValueError, match="tol"):
        sbs.run_sbs_simulation(cfg, tol=-1.0, **kw)
    with pytest.raises(ValueError, match="max_iterations"):
        sbs.run_sbs_simulation(cfg, max_iterations=0, **kw)
    with pytest.raises(ValueError, match="rk4"):
        sbs.run_sbs_simulation(dataclasses.replace(cfg, integrator="rk45"), **kw)


def test_run_sbs_batch_matches_singles():
    """The batched relaxation matches per-instance solves."""
    B = 3
    gB = np.array([0.0, 0.5, 1.0])
    P_in = np.broadcast_to([0.1, 0.1, 1e-5, 0.0], (B, 4)).copy()
    P_st = np.broadcast_to([0.0, 0.0, 1e-6, 0.0], (B, 4)).copy()
    cfg = T.custom_simulation_config(z_max=5.0, dz=0.01, save_every=10)
    z, A, Bw, resid, refl, ok, n_iters = sbs.run_sbs_batch(
        cfg, gamma=2.0, alpha=0.01, g_B=gB, delta_beta=0.5,
        P_in=P_in, P_stokes_seed=P_st, length_unit="m", n_iterations=20, device="cpu",
    )
    assert A.shape == (B, len(z), 4) and Bw.shape == A.shape
    for i in range(B):
        res_i = sbs.run_sbs_simulation(
            cfg, gamma=2.0, alpha=0.01, g_B=float(gB[i]), delta_beta=0.5,
            p_in=list(P_in[i]), p_stokes_seed=list(P_st[i]),
            length_unit="m", n_iterations=20, device="cpu",
        )
        np.testing.assert_allclose(A[i], res_i.A, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(Bw[i], res_i.B, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(refl[i], res_i.reflectivity, rtol=1e-12)
    assert np.all(resid < 1e-8)
    assert np.all(ok)


def test_batch_convergence_masking_matches_singles_and_jax():
    """Lanes converging at different sweep counts must be bit-identical to
    solving each alone (a converged lane is frozen), with the JAX package's
    per-lane sweep counts."""
    B = 3
    gB = np.array([0.1, 1.0, 2.0])  # very different convergence speeds
    P_in = np.broadcast_to([0.2, 0.1, 1e-5, 0.0], (B, 4)).copy()
    P_st = np.broadcast_to([1e-3, 0.0, 0.0, 0.0], (B, 4)).copy()
    kw = dict(gamma=0.5, alpha=0.01, g_B=gB, delta_beta=0.2, P_in=P_in, P_stokes_seed=P_st,
              length_unit="m", tol=1e-11, max_iterations=200)
    cfg = T.custom_simulation_config(z_max=3.0, dz=0.01, save_every=30)
    z, A, Bw, resid, refl, ok, n_iters = sbs.run_sbs_batch(cfg, **kw, device="cpu")
    assert np.all(ok)
    assert n_iters[0] != n_iters[2]  # genuinely different lane schedules
    for i in range(B):
        res_i = sbs.run_sbs_simulation(
            cfg, gamma=0.5, alpha=0.01, g_B=float(gB[i]), delta_beta=0.2,
            p_in=list(P_in[i]), p_stokes_seed=list(P_st[i]), length_unit="m",
            tol=1e-11, max_iterations=200, device="cpu",
        )
        assert int(n_iters[i]) == res_i.n_iterations
        np.testing.assert_array_equal(A[i], res_i.A)
        np.testing.assert_array_equal(Bw[i], res_i.B)
    zj, Aj, Bj, rj, fj, okj, nj = jsbs.run_sbs_batch(
        J.custom_simulation_config(z_max=3.0, dz=0.01, save_every=30), **kw)
    np.testing.assert_array_equal(n_iters, nj)
    np.testing.assert_allclose(A, Aj, rtol=1e-12, atol=0)
    np.testing.assert_allclose(Bw, Bj, rtol=1e-12, atol=0)


def test_tol_stops_iteration_early():
    """tol > 0 stops as soon as the residual drops below it; the loose solve
    uses strictly fewer sweeps and still reports its actual residual."""
    cfg = T.custom_simulation_config(z_max=5.0, dz=0.01, save_every=10)
    common = dict(
        gamma=0.5, alpha=0.01, g_B=1.0, delta_beta=0.0,
        p_in=[0.2, 0.1, 1e-5, 0.0], p_stokes_seed=[1e-4, 0, 0, 0],
        length_unit="m", device="cpu",
    )
    tight = sbs.run_sbs_simulation(cfg, tol=1e-12, max_iterations=100, **common)
    loose = sbs.run_sbs_simulation(cfg, tol=1e-4, max_iterations=100, **common)
    assert tight.residual <= 1e-12
    assert loose.n_iterations < tight.n_iterations
    assert loose.residual <= 1e-4
    np.testing.assert_allclose(loose.A, tight.A, atol=1e-3)


def test_df32_rejected_with_clear_error():
    """SBS relaxation has no two-float engine; df32 must raise, as in the
    JAX package, in both entry points."""
    cfg = dataclasses.replace(
        T.custom_simulation_config(z_max=10.0, dz=0.5, save_every=1), precision="df32")
    with pytest.raises(ValueError, match="df32"):
        sbs.run_sbs_simulation(
            cfg, gamma=1e-3, alpha=0.0, g_B=0.01, delta_beta=0.0,
            p_in=[0.1, 0.1, 0.0, 0.0], p_stokes_seed=[1e-5] * 4, device="cpu",
        )
    with pytest.raises(ValueError, match="df32"):
        sbs.run_sbs_batch(cfg, gamma=1e-3, alpha=0.0, g_B=0.01, delta_beta=0.0,
                          P_in=[[0.1, 0.1, 0.0, 0.0]], P_stokes_seed=[[1e-5] * 4],
                          device="cpu")


def test_mesh_raises():
    cfg = T.custom_simulation_config(z_max=1.0, dz=0.1)
    with pytest.raises(TypeError, match="mesh must be"):
        sbs.run_sbs_batch(cfg, gamma=1e-3, alpha=0.0, g_B=0.01, delta_beta=0.0,
                          P_in=[[0.1, 0.1, 0.0, 0.0]], P_stokes_seed=[[1e-5] * 4],
                          mesh=object(), device="cpu")


def test_x32_runs_in_float32_close_to_x64():
    kw = dict(g_B=1.0, p_stokes=1e-5, z_max=2.0)
    r64 = _run(**kw)
    cfg = T.custom_simulation_config(z_max=2.0, dz=0.01, save_every=10, precision="x32")
    r32 = sbs.run_sbs_simulation(
        cfg, gamma=2.0, alpha=0.0, g_B=1.0, delta_beta=0.5, p_in=[0.1, 0.1, 1e-5, 0.0],
        p_stokes_seed=[0.0, 0.0, 1e-5, 0.0], length_unit="m", n_iterations=20, device="cpu")
    assert r32.A.dtype == np.complex128 and r32.residual <= 1e-5
    assert np.max(np.abs(r32.A - r64.A)) / np.max(np.abs(r64.A)) < 1e-5
    assert np.max(np.abs(r32.B - r64.B)) / np.max(np.abs(r64.B)) < 1e-5


def test_sbs_warm_start_resumes_relaxation():
    """Warm-starting from a converged B trajectory reaches the same fixed
    point in fewer sweeps (B alone is the full relaxation state)."""
    cfg = T.custom_simulation_config(z_max=100.0, dz=0.5, save_every=10)
    kw = dict(gamma=3e-3, alpha=2e-4, g_B=0.1, delta_beta=0.05,
              p_in=[0.3, 0.3, 1e-3, 0.0], p_stokes_seed=[1e-4] * 4, device="cpu")
    r1 = sbs.run_sbs_simulation(cfg, **kw, tol=1e-12, max_iterations=60, damping=0.7)
    r2 = sbs.run_sbs_simulation(cfg, **kw, tol=1e-12, max_iterations=60, damping=0.7,
                                B_init=r1.B)
    assert r2.n_iterations < r1.n_iterations
    np.testing.assert_allclose(r2.A, r1.A, atol=1e-10)
    np.testing.assert_allclose(r2.B, r1.B, atol=1e-10)

    # exact warm start (save_every=1): a converged guess re-converges in one
    # sweep
    cfg1 = T.custom_simulation_config(z_max=100.0, dz=0.5, save_every=1)
    r3 = sbs.run_sbs_simulation(cfg1, **kw, tol=1e-12, max_iterations=60, damping=0.7)
    r4 = sbs.run_sbs_simulation(cfg1, **kw, tol=1e-12, max_iterations=60, damping=0.7,
                                B_init=r3.B)
    assert r4.n_iterations <= 2
    np.testing.assert_allclose(r4.B, r3.B, atol=1e-11)

    # batch warm start
    P_in = np.tile([0.3, 0.3, 1e-3, 0.0], (3, 1))
    P_st = np.tile([1e-4] * 4, (3, 1))
    bkw = dict(gamma=3e-3, alpha=2e-4, g_B=0.1, delta_beta=0.05,
               P_in=P_in, P_stokes_seed=P_st, tol=1e-12, max_iterations=60,
               damping=0.7, device="cpu")
    z, A, Bw, resid, refl, ok, n_it = sbs.run_sbs_batch(cfg, **bkw)
    out2 = sbs.run_sbs_batch(cfg, **bkw, B_init=Bw)
    assert (out2[6] < n_it).all()
    np.testing.assert_allclose(out2[1], A, atol=1e-10)
    assert out2[5].all()


def test_sbs_b_init_validation():
    cfg = T.custom_simulation_config(z_max=100.0, dz=0.5, save_every=10)
    kw = dict(gamma=3e-3, alpha=2e-4, g_B=0.1, delta_beta=0.05,
              p_in=[0.3, 0.3, 1e-3, 0.0], p_stokes_seed=[1e-4] * 4, device="cpu")
    with pytest.raises(ValueError, match="B_init"):
        sbs.run_sbs_simulation(cfg, **kw, B_init=np.zeros((7, 4)))
    bad = np.full((21, 4), np.nan, dtype=complex)
    with pytest.raises(ValueError, match="finite"):
        sbs.run_sbs_simulation(cfg, **kw, B_init=bad)
    with pytest.raises(ValueError, match="B_init"):
        sbs.run_sbs_batch(cfg, gamma=3e-3, alpha=2e-4, g_B=0.1, delta_beta=0.05,
                          P_in=np.tile([0.3, 0.3, 1e-3, 0.0], (2, 1)),
                          P_stokes_seed=np.tile([1e-4] * 4, (2, 1)),
                          B_init=np.zeros((3, 21, 4)), device="cpu")


def test_nan_lane_is_flagged_not_raised():
    """A batch flags a lane whose relaxation overflows in ``ok``; the single
    run raises for it."""
    cfg = T.custom_simulation_config(z_max=5.0, dz=0.5, save_every=1)
    kw = dict(gamma=2e-3, alpha=0.0, g_B=0.1, delta_beta=0.0, n_iterations=3, device="cpu")
    P_in = np.array([[0.1, 0.1, 1e-5, 0.0], [1e150, 1e150, 1.0, 0.0]])
    out = sbs.run_sbs_batch(cfg, **kw, P_in=P_in, P_stokes_seed=np.full((2, 4), 1e-6))
    assert out[5].tolist() == [True, False]
    with pytest.raises(FloatingPointError, match="SBS"):
        sbs.run_sbs_simulation(cfg, **kw, p_in=list(P_in[1]), p_stokes_seed=[1e-6] * 4)
