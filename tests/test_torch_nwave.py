"""The port's comb model, ``models/nwave.py``, against the JAX package's on
the same seeded numpy inputs, on the CPU.

Tolerances:

- parameter builders: ``seed_comb`` bit-equal (both use numpy's
  ``default_rng``); ``comb_beta_lin`` and ``make_comb_coeffs`` bit-equal
  (the same float64 Horner evaluation);
- the three couplings: 1e-12 of the largest output value against JAX x64
  (the DFT sums round differently from the FFT's; an output line is summed
  from terms the size of the largest one, so a weak line's own relative
  error is larger and the comparison is normwise);
- fixed-step solves: 1e-12 of each comb's largest amplitude against JAX
  x64 (weak noise-seeded lines sit 10^-5 below the pumps in amplitude and
  carry the DFT's rounding relative to the pumps);
- rk45 at rtol 1e-10: 1e-7 of the largest amplitude (the port integrates
  each segment in local z, so its steps differ from the JAX scan's in
  their last bits);
- a resumed rk4 run equals the straight run bit for bit; ab4/abm4 (which
  restart from an RK4 bootstrap) and rk45 (which restarts from its first
  step) within 1e-7 of the largest amplitude;
- the degenerate 3-wave oracle: cosh^2/sinh^2 gains to 1e-7/1e-6, as
  ``tests/test_nwave.py`` asserts.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import nwave as jn  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import interop  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import nwave as tn  # noqa: E402

torch.set_num_threads(1)

OMEGA_C = 2 * np.pi * 193.1e12
DOMEGA = 2 * np.pi * 50e9


def _normwise(a, b, axis=None):
    """max |a - b| / max |b| (over ``axis``, then the worst)."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.max(np.abs(a - b), axis=axis) / np.max(np.abs(b), axis=axis)))


def _disp(pkg):
    return pkg.DispersionParams.from_betas(OMEGA_C, beta2=-1e-27, beta3=1.2e-41)


def _comb(n=16, B=4, seed=0):
    """A bench-like comb (bench_comb.py:94-115) at small size: two pumps, a
    noise floor, a gamma grid."""
    grid = jn.CombGrid.centered(OMEGA_C, DOMEGA, n)
    beta = jn.comb_beta_lin(grid, _disp(J))
    A0 = jn.seed_comb(grid, pump_lines={n // 4: 0.4, 3 * n // 4: 0.4}, noise_floor_W=1e-9,
                      seed=seed)
    co = dict(gamma=np.linspace(5e-3, 15e-3, B), alpha=np.full(B, 5e-5),
              beta_lin=np.broadcast_to(beta, (B, n)))
    return np.broadcast_to(A0, (B, n)).copy(), co


def test_parameter_builders_match_jax():
    n = 33
    tg, jg = tn.CombGrid.centered(OMEGA_C, DOMEGA, n), jn.CombGrid.centered(OMEGA_C, DOMEGA, n)
    assert np.array_equal(tg.omegas(), jg.omegas())
    disp_t = T.DispersionParams.from_betas(OMEGA_C, beta0=3.0, beta1=4.9e-9, beta2=-1e-27,
                                           beta3=1.2e-41)
    disp_j = J.DispersionParams.from_betas(OMEGA_C, beta0=3.0, beta1=4.9e-9, beta2=-1e-27,
                                           beta3=1.2e-41)
    for rl in (True, False):
        bt = tn.comb_beta_lin(tg, disp_t, remove_linear=rl)
        bj = jn.comb_beta_lin(jg, disp_j, remove_linear=rl)
        assert isinstance(bt, np.ndarray) and np.array_equal(bt, bj)
    for precision, dt in (("x64", torch.float64), ("x32", torch.float32)):
        ct = tn.make_comb_coeffs(tg, disp_t, gamma_W_m=1e-2, alpha_1_m=5e-5, precision=precision)
        cj = jn.make_comb_coeffs(jg, disp_j, gamma_W_m=1e-2, alpha_1_m=5e-5, precision=precision)
        for f in ("gamma", "alpha", "beta_lin"):
            t = getattr(ct, f)
            assert t.dtype == dt and t.device.type == "cpu"
            assert np.array_equal(t.numpy(), np.asarray(getattr(cj, f)))
    kw = dict(pump_lines={3: 0.5, 29: (0.25, np.pi / 3)}, noise_floor_W=1e-9, seed=7)
    assert np.array_equal(tn.seed_comb(tg, **kw), jn.seed_comb(jg, **kw))
    A = tn.seed_comb(tg, **kw)
    assert np.array_equal(tn.comb_spectrum_db(A), jn.comb_spectrum_db(A))
    with pytest.raises(ValueError, match="outside"):
        tn.seed_comb(tg, pump_lines={n: 0.1})
    with pytest.raises(ValueError, match=">= 0"):
        tn.seed_comb(tg, pump_lines={2: -0.1})


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 16, 33, 64])
@pytest.mark.parametrize("coupling", ["fft", "dft", "einsum"])
def test_couplings_match_jax(n, coupling):
    rng = np.random.default_rng(n)
    a = rng.normal(size=(3, n)) * 0.3 + 1j * rng.normal(size=(3, n)) * 0.3
    co = dict(gamma=np.array([0.5, 1.0, 2.0]), alpha=np.full(3, 0.02),
              beta_lin=rng.uniform(-0.3, 0.3, (3, n)))
    t = tn.make_rhs_nwave(coupling)(0.0, torch.as_tensor(a), tn.NWaveCoeffs(
        *(torch.as_tensor(v) for v in co.values())))
    j = jn.make_rhs_nwave(coupling)(0.0, jnp.asarray(a), jn.NWaveCoeffs(
        *(jnp.asarray(v) for v in co.values())))
    assert t.dtype == torch.complex128 and t.shape == (3, n)
    assert _normwise(t.numpy(), j) <= 1e-12
    # the cubic sum alone, one unbatched state, against the JAX FFT path
    p = tn._COUPLING_FNS[coupling](torch.as_tensor(a[0])).numpy()
    assert _normwise(p, jn.fwm_polarization(jnp.asarray(a[0]))) <= 1e-12
    with pytest.raises(ValueError, match="coupling"):
        tn.make_rhs_nwave("bogus")


@pytest.mark.parametrize("integrator", ["rk4", "ab4", "abm4", "rk45"])
def test_run_comb_simulation_matches_jax_and_resumes(integrator):
    A0, co = _comb(n=16, B=1)
    c1 = dict(gamma=co["gamma"][0], alpha=co["alpha"][0], beta_lin=co["beta_lin"][0])
    kw = dict(z_max=400.0, dz=5.0, save_every=10, integrator=integrator, rtol=1e-10, atol=1e-14)
    z_t, A_t = tn.run_comb_simulation(T.custom_simulation_config(**kw), tn.NWaveCoeffs(**c1),
                                      A0[0], coupling="dft", device="cpu")
    z_j, A_j = jn.run_comb_simulation(J.custom_simulation_config(**kw), jn.NWaveCoeffs(**c1),
                                      A0[0], coupling="dft")
    assert A_t.shape == (9, 16) and np.array_equal(z_t, z_j)
    assert _normwise(A_t, A_j) <= (1e-7 if integrator == "rk45" else 1e-12)
    # resume from the middle saved row: the same rows, offset grid
    half = dataclasses.replace(T.custom_simulation_config(**kw), z_max=200.0)
    z_a, A_a = tn.run_comb_simulation(half, tn.NWaveCoeffs(**c1), A0[0], coupling="dft",
                                      device="cpu")
    z_b, A_b = tn.run_comb_simulation(half, tn.NWaveCoeffs(**c1), A_a[-1], coupling="dft",
                                      z0=z_a[-1], device="cpu")
    np.testing.assert_allclose(z_b, z_t[4:], rtol=1e-15)
    if integrator == "rk4":
        assert np.array_equal(A_b, A_t[4:])
    else:   # the Adams methods restart from an RK4 bootstrap; rk45 from dt0
        assert _normwise(A_b, A_t[4:]) <= 1e-7


def test_run_comb_simulation_x32_and_units():
    A0, co = _comb(n=8, B=1)
    c1 = dict(gamma=co["gamma"][0], alpha=0.0, beta_lin=co["beta_lin"][0])
    kw = dict(z_max=0.4, dz=0.005, save_every=20, precision="x32")  # km; coefficients per m
    z_t, A_t = tn.run_comb_simulation(T.custom_simulation_config(**kw), tn.NWaveCoeffs(**c1),
                                      A0[0], length_unit="km", device="cpu")
    z_j, A_j = jn.run_comb_simulation(J.custom_simulation_config(**kw), jn.NWaveCoeffs(**c1),
                                      A0[0], length_unit="km")
    np.testing.assert_allclose(z_t, z_j, rtol=1e-7)
    assert _normwise(A_t, A_j) <= 2e-5


@pytest.mark.parametrize("integrator", ["rk4", "rk45"])
def test_batch_trajectories_match_jax(integrator):
    A0, co = _comb(n=16, B=3)
    kw = dict(z_max=205.0, dz=5.0, save_every=10, integrator=integrator, rtol=1e-10,
              atol=1e-14)
    z_t, A_t, ok_t = tn.solve_comb_batch_trajectories(
        T.custom_simulation_config(**kw), tn.NWaveCoeffs(**co), A0, device="cpu")
    z_j, A_j, ok_j = jn.solve_comb_batch_trajectories(
        J.custom_simulation_config(**kw), jn.NWaveCoeffs(**co), A0)
    assert A_t.shape == (3, 5, 16) and ok_t.all() and ok_j.all()
    np.testing.assert_allclose(z_t, z_j, rtol=1e-15)
    assert _normwise(A_t, A_j, axis=(1, 2)) <= (1e-7 if integrator == "rk45" else 1e-12)
    # reduce mode ends at the last saved row
    _P, A_fin, _ok = tn.solve_comb_batch(T.custom_simulation_config(**kw), tn.NWaveCoeffs(**co),
                                         A0, device="cpu")
    assert _normwise(A_fin, A_t[:, -1], axis=1) <= (1e-9 if integrator == "rk45" else 1e-13)


def test_solve_comb_batch_refusals():
    A0, co = _comb(n=8, B=2)
    coeffs = tn.NWaveCoeffs(**co)
    cfg = T.custom_simulation_config(z_max=10.0, dz=1.0)
    df32 = dataclasses.replace(cfg, precision="df32")
    with pytest.raises(ValueError, match="reduce-mode"):
        tn.run_comb_simulation(df32, coeffs, A0[0], device="cpu")
    with pytest.raises(ValueError, match="reduce-mode"):
        tn.solve_comb_batch_trajectories(df32, coeffs, A0, device="cpu")
    with pytest.raises(ValueError, match="rk4 only"):
        tn.solve_comb_batch(dataclasses.replace(df32, integrator="rk45"), coeffs, A0, device="cpu")
    with pytest.raises(NotImplementedError, match="slice I"):
        tn.solve_comb_batch(cfg, coeffs, A0, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tn.solve_comb_batch(cfg, coeffs, A0, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tn.solve_comb_batch(cfg, coeffs, A0, engine="cuda", device="cpu")
    for mxu in ("x3", "default"):
        with pytest.raises(ValueError, match="bf16"):
            tn.solve_comb_batch(cfg, coeffs, A0, mxu_precision=mxu, device="cpu")
    with pytest.raises(ValueError, match="mxu_precision"):
        tn.solve_comb_batch(cfg, coeffs, A0, mxu_precision="x9", device="cpu")
    with pytest.raises(ValueError, match="rk4ip"):
        tn.solve_comb_batch(dataclasses.replace(cfg, integrator="rk4ip"), coeffs, A0,
                            device="cpu")
    with pytest.raises(ValueError, match="coupling"):
        tn.solve_comb_batch(cfg, coeffs, A0, coupling="bogus", device="cpu")
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        tn.solve_comb_batch(cfg, coeffs, A0[0], device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        tn.run_comb_simulation(cfg, coeffs, A0, device="cpu")
    # df32 rk4 runs in float64 and equals x64
    P64, A64, _ = tn.solve_comb_batch(cfg, coeffs, A0, device="cpu")
    Pdf, Adf, _ = tn.solve_comb_batch(df32, coeffs, A0, device="cpu")
    assert np.array_equal(A64, Adf) and np.array_equal(P64, Pdf)


def test_degenerate_single_pump_3wave_analytic():
    """The degenerate single-pump amplifier is the N=3 comb; at kappa = 0
    the undepleted-pump gains are cosh^2 and sinh^2 (tests/test_nwave.py:380)."""
    gamma, P, L = 0.01, 0.5, 50.0
    g = gamma * P
    Ps_in = 1e-8
    A0 = np.array([[np.sqrt(Ps_in), np.sqrt(P), 0.0]], dtype=complex)
    beta = np.array([-gamma * P, 0.0, -gamma * P])
    cfg = T.custom_simulation_config(z_max=L, dz=0.01, save_every=100)
    co = tn.NWaveCoeffs(gamma=np.array([gamma]), alpha=np.array([0.0]), beta_lin=beta[None, :])
    _P_max, A_end, ok = tn.solve_comb_batch(cfg, co, A0, coupling="fft", device="cpu")
    assert ok.all()
    assert np.abs(A_end[0, 0]) ** 2 / Ps_in == pytest.approx(np.cosh(g * L) ** 2, rel=1e-7)
    assert np.abs(A_end[0, 2]) ** 2 / Ps_in == pytest.approx(np.sinh(g * L) ** 2, rel=1e-6)


def test_from_reference_gives_the_same_comb():
    jg = jn.CombGrid.centered(OMEGA_C, DOMEGA, 16)
    jc = jn.make_comb_coeffs(jg, _disp(J), gamma_W_m=1e-2, alpha_1_m=5e-5)
    tg = interop.from_reference(jg, device="cpu")
    tc = interop.from_reference(jc, device="cpu")
    assert isinstance(tg, tn.CombGrid) and tg == tn.CombGrid(**dataclasses.asdict(jg))
    assert isinstance(tc, tn.NWaveCoeffs) and tc.beta_lin.dtype == torch.float64
    A0 = jn.seed_comb(jg, pump_lines={4: 0.4, 12: 0.4}, noise_floor_W=1e-9)
    assert np.array_equal(tn.seed_comb(tg, pump_lines={4: 0.4, 12: 0.4}, noise_floor_W=1e-9), A0)
    kw = dict(z_max=200.0, dz=5.0, save_every=10)
    z_t, A_t = tn.run_comb_simulation(T.custom_simulation_config(**kw), tc, A0, device="cpu")
    z_j, A_j = jn.run_comb_simulation(J.custom_simulation_config(**kw), jc, A0)
    assert _normwise(A_t, A_j) <= 1e-12
