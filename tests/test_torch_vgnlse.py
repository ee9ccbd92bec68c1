"""The port's vector (two-polarization) GNLSE, ``models/vgnlse.py``, against
the JAX package's on the same seeded numpy inputs, on the CPU, and the JAX
tests' exact oracles on the port alone.

Tolerances:

- parameter builders, pulses and the Stokes quantities: bit-equal (the same
  float64 numpy);
- fixed-step solves (each coupling, Kerr and the Raman/steepening ``nl``,
  Strang and RK4IP, birefringence, spectral (2, T) and per-instance loss,
  per-instance phase and gamma, a NaN lane, a trailing partial chunk):
  1e-12 of each instance's largest amplitude against the JAX x64 scan
  (``torch.fft`` and XLA's FFT round differently); ``df32`` (float64 in the
  port) against the JAX x64 scan at the same bar, inside the JAX df32
  tests' 1e-9 class;
- ``rk45``/``rk4ip45``: equal step counters and ``ok``, results within
  1e-10 (the scalar family's class);
- a resumed fixed-step run equals the straight run bit for bit; with
  ``A_y = 0`` the vector Kerr solve equals the port's scalar solve bit for
  bit (``nl``: 1e-12, ``tests/test_vgnlse_nl.py``'s bar);
- the oracles keep the JAX tests' bars (``tests/test_vgnlse.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import gnlse as jg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import vgnlse as jv  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.utils.packing import ri_pack_host  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import interop  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import gnlse as tg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import vgnlse as tv  # noqa: E402

torch.set_num_threads(1)

T0 = 1e-12
BETA2 = -2.0e-26
OMEGA_REF = 1.2e15
GAMMA = 2e-3
N = 128
CPU = torch.device("cpu")


def _normwise(a, b):
    """Worst over instances of max |a - b| / max |b| (both polarizations)."""
    a, b = np.asarray(a), np.asarray(b)
    ax = tuple(range(1, a.ndim))
    return float(np.max(np.max(np.abs(a - b), axis=ax) / np.max(np.abs(b), axis=ax)))


def _grids(n=N):
    g = jg.TimeGrid.for_pulse(T0, n_samples=n)
    return g, tg.TimeGrid(n_samples=g.n_samples, t_window_s=g.t_window_s)


def _coeffs(n=N, **kw):
    jgrid, tgrid = _grids(n)
    jc = jv.make_vgnlse_coeffs(jgrid, J.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2), **kw)
    tc = tv.make_vgnlse_coeffs(tgrid, T.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2), **kw)
    return jgrid, tgrid, jc, tc


def _pulses(grid, B, seed=0):
    """Sech envelopes at 0.5-1.5 x the Manakov soliton power split at theta
    = 0.4 with a relative phase, and a seeded phase ripple."""
    rng = np.random.default_rng(seed)
    P0 = jv.manakov_soliton_peak_power(BETA2, GAMMA, T0)
    A = np.sqrt(np.linspace(0.5, 1.5, B) * P0)[:, None] / np.cosh(grid.t()[None, :] / T0)
    A0 = np.stack([np.cos(0.4) * A, np.sin(0.4) * np.exp(0.7j) * A], axis=1)
    return (A0 * np.exp(0.1j * rng.standard_normal(A0.shape))).astype(np.complex128)


def _nl(jgrid, tgrid, case, precision="x64"):
    if case is None:
        return None, None
    f_r, w0 = case
    return (jg.make_nl_terms(jgrid, f_raman=f_r, omega0=w0, precision=precision),
            tg.make_nl_terms(tgrid, f_raman=f_r, omega0=w0, precision=precision))


def _cfgs(**kw):
    base = dict(z_max=0.11, dz=0.01, save_every=3, rtol=1e-8, atol=1e-12)
    base.update(kw)
    return J.custom_simulation_config(**base), T.custom_simulation_config(**base)


BIRE = dict(gamma_W_m=GAMMA, alpha_1_m=5e-5, dbeta0_1_m=0.3, dbeta1_s_m=1e-13)


# ---------------------------------------------------------------------------
# Parameters, pulses and derived quantities
# ---------------------------------------------------------------------------

def test_parameter_builders_and_helpers_are_bit_equal():
    jgrid, tgrid = _grids()
    om = jgrid.omega()
    spec = 1e-4 * (om / np.abs(om).max()) ** 2
    disp = dict(beta2=BETA2, beta3=1.2e-40)
    for kw in (dict(coupling="cnlse"), dict(coupling="manakov", max_order=2),
               dict(coupling="isotropic", alpha_spec_1_m=spec),
               dict(coupling="cnlse", alpha_spec_1_m=np.stack([spec, 2 * spec]))):
        jc = jv.make_vgnlse_coeffs(jgrid, J.DispersionParams.from_betas(OMEGA_REF, **disp), **BIRE,
                                   **kw)
        tc = tv.make_vgnlse_coeffs(tgrid, T.DispersionParams.from_betas(OMEGA_REF, **disp), **BIRE,
                                   **kw)
        assert tc.coherent == jc.coherent and isinstance(tc.coherent, float)
        for f in ("gamma", "alpha", "b_xpm", "lin_phase"):
            t = getattr(tc, f)
            assert t.dtype == torch.float64 and t.device.type == "cpu"
            assert np.array_equal(t.numpy(), np.asarray(getattr(jc, f))), (kw, f)
        got = interop.from_reference(jc, device="cpu")
        assert isinstance(got, tv.VGNLSECoeffs) and got.coherent == jc.coherent
        for f in ("gamma", "alpha", "b_xpm", "lin_phase"):
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(jc, f)))
    assert tv.make_vgnlse_coeffs(tgrid, None, gamma_W_m=1.0, precision="x32").gamma.dtype == \
        torch.float32
    assert tv.make_vgnlse_coeffs(tgrid, None, gamma_W_m=1.0, precision="df32").alpha.dtype == \
        torch.float64
    assert (tv.XPM_LINEAR_BIREFRINGENT, tv.MANAKOV_GAMMA_FACTOR) == \
        (jv.XPM_LINEAR_BIREFRINGENT, jv.MANAKOV_GAMMA_FACTOR)
    assert tv.manakov_soliton_peak_power(BETA2, GAMMA, T0) == \
        jv.manakov_soliton_peak_power(BETA2, GAMMA, T0)
    A = jg.sech_pulse(jgrid, peak_W=2.0, t0_s=T0)
    assert np.array_equal(tv.polarized_pulse(A, 0.3, 0.8), jv.polarized_pulse(A, 0.3, 0.8))
    A0 = _pulses(jgrid, 3)
    assert np.array_equal(tv.stokes_parameters(A0), jv.stokes_parameters(A0))
    assert np.array_equal(tv.degree_of_polarization(tgrid, A0),
                          jv.degree_of_polarization(jgrid, A0))
    with pytest.raises(ValueError, match="coupling"):
        tv.make_vgnlse_coeffs(tgrid, None, gamma_W_m=GAMMA, coupling="elliptic")
    with pytest.raises(ValueError, match="alpha_spec"):
        tv.make_vgnlse_coeffs(tgrid, None, gamma_W_m=0.0, alpha_spec_1_m=np.zeros(32))
    with pytest.raises(ValueError, match="finite"):
        tv.make_vgnlse_coeffs(tgrid, None, gamma_W_m=0.0, alpha_spec_1_m=np.full((2, N), np.nan))
    with pytest.raises(ValueError, match="anomalous"):
        tv.manakov_soliton_peak_power(-BETA2, GAMMA, T0)


# ---------------------------------------------------------------------------
# Solvers against the JAX x64 scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coupling,case,integrator", [
    ("cnlse", None, "rk4"), ("manakov", None, "rk4"), ("isotropic", None, "rk4"),
    ("manakov", (0.18, OMEGA_REF), "rk4"), ("isotropic", (0.18, OMEGA_REF), "rk4"),
    ("cnlse", (0.0, OMEGA_REF), "rk4"), ("cnlse", (0.18, None), "rk4"),
    ("cnlse", None, "rk4ip"), ("isotropic", (0.18, OMEGA_REF), "rk4ip"),
])
def test_fixed_step_matches_jax_x64(coupling, case, integrator):
    """11 steps at save_every=3 with birefringence: three chunks and a
    trailing partial one."""
    jgrid, tgrid, jc, tc = _coeffs(coupling=coupling, **BIRE)
    jnl, tnl = _nl(jgrid, tgrid, case)
    A0 = _pulses(jgrid, 3)
    jcfg, tcfg = _cfgs(integrator=integrator)
    pj, Aj, okj = jv.solve_vgnlse_batch(jcfg, jc, A0, nl=jnl)
    pt, At, okt = tv.solve_vgnlse_batch(tcfg, tc, A0, nl=tnl, device="cpu")
    assert At.dtype == np.complex128 and pt.shape == (3, 2) and okt.all() and okj.all()
    assert _normwise(At, Aj) <= 1e-12
    np.testing.assert_allclose(pt, pj, rtol=1e-12)


def _jax_adaptive(cfg, co, A0, nl):
    """The JAX scan's adaptive reduce solve with its step counters
    (``vgnlse.py:905-914``)."""
    B, _, Tn = A0.shape
    n_steps = int(round(cfg.z_max / cfg.dz))
    n_chunks = n_steps // cfg.save_every
    solver = jv._vgnlse_adaptive_solver("float64", cfg.rtol, cfg.atol, cfg.max_steps, True,
                                        jg._adaptive_method(cfg), n_steps % cfg.save_every > 0)
    cb = jv.VGNLSECoeffs(gamma=jnp.asarray(np.broadcast_to(np.asarray(co.gamma), (B,))),
                         alpha=jnp.asarray(np.broadcast_to(np.asarray(co.alpha), (B,))),
                         b_xpm=jnp.asarray(co.b_xpm),
                         lin_phase=jnp.asarray(np.broadcast_to(np.asarray(co.lin_phase),
                                                               (B, 2, Tn))),
                         coherent=co.coherent)
    z_grid = jnp.asarray(np.arange(n_chunks + 1) * (cfg.save_every * cfg.dz))
    out = solver(
        jnp.asarray(ri_pack_host(A0, np.float64)), cb, z_grid, jnp.asarray(cfg.dz), nl,
        jnp.asarray(n_steps * cfg.dz))
    pk, y_ri, ok, na, nr = jg._split_reduce_pack(out, 2 * Tn, counters=True)
    y_ri = np.asarray(y_ri).reshape(-1, 2, Tn, 2)
    return pk, y_ri[..., 0] + 1j * y_ri[..., 1], ok, na, nr


@pytest.mark.parametrize("integrator,coupling,case", [
    ("rk45", "manakov", None), ("rk45", "isotropic", (0.18, OMEGA_REF)),
    ("rk4ip45", "cnlse", None), ("rk4ip45", "isotropic", None),
])
def test_adaptive_matches_jax_x64_with_equal_counters(integrator, coupling, case):
    """11 steps of 0.01 m at save_every=3: a trailing span; the controller's
    error norm is per lane over both polarizations in both packages."""
    jgrid, tgrid, jc, tc = _coeffs(coupling=coupling, **BIRE)
    jnl, tnl = _nl(jgrid, tgrid, case)
    A0 = _pulses(jgrid, 3, seed=1)
    jcfg, tcfg = _cfgs(integrator=integrator, rtol=1e-7, atol=1e-10)
    pj, Aj, okj, naj, nrj = _jax_adaptive(jcfg, jc, A0, jnl)
    B, _, Tn = A0.shape
    lanes = tv.lane_coeffs(tc, B, Tn, torch.float64, CPU)
    _rows, pk, y, ok, na, nr = tv.vgnlse_adaptive(
        torch.as_tensor(A0), *lanes, tc.coherent, dz_m=0.01, n_steps=11, save_every=3,
        rtol=1e-7, atol=1e-10, max_steps=tcfg.max_steps, nl=tnl,
        method=tg._adaptive_method(integrator))
    assert ok.numpy().tolist() == okj.tolist() and okj.all()
    assert na.numpy().tolist() == naj.tolist() and nr.numpy().tolist() == nrj.tolist()
    assert (naj > 3).all()
    assert _normwise(y.numpy(), Aj) <= 1e-10
    np.testing.assert_allclose(pk.numpy(), pj, rtol=1e-10)
    pt, At, okt = tv.solve_vgnlse_batch(tcfg, tc, A0, nl=tnl, device="cpu")
    assert np.array_equal(At, y.numpy()) and okt.all() and pt.shape == (3, 2)


def test_spectral_and_per_instance_coefficients_match_jax():
    """(2, T) spectral loss with a shared phase; per-instance gamma, flat
    alpha (B,) and phase (B, 2, T); (B, 2, T) spectral loss."""
    jgrid, tgrid, jc, tc = _coeffs(**BIRE)
    om = jgrid.omega()
    spec = np.stack([1e-2 * (om / np.abs(om).max()) ** 2, 2e-2 * (om / np.abs(om).max()) ** 2])
    B = 4
    A0 = _pulses(jgrid, B, seed=2)
    gam = np.linspace(1e-3, 3e-3, B)
    phase_b = np.asarray(jc.lin_phase)[None] * np.linspace(0.9, 1.1, B)[:, None, None]
    cases = [
        dict(alpha=np.asarray(jc.alpha) + spec),
        dict(gamma=gam, alpha=np.linspace(0.0, 0.05, B), lin_phase=phase_b),
        dict(gamma=gam, alpha=(np.asarray(jc.alpha) + spec)[None] * np.linspace(0.5, 1.5, B)[
            :, None, None]),
    ]
    jcfg, tcfg = _cfgs(z_max=1.1, dz=0.1)
    for kw in cases:
        jc2 = dataclasses.replace(jc, **{k: jnp.asarray(v) for k, v in kw.items()})
        tc2 = dataclasses.replace(tc, **{k: torch.as_tensor(v) for k, v in kw.items()})
        pj, Aj, _ = jv.solve_vgnlse_batch(jcfg, jc2, A0)
        pt, At, _ = tv.solve_vgnlse_batch(tcfg, tc2, A0, device="cpu")
        assert _normwise(At, Aj) <= 1e-12
        np.testing.assert_allclose(pt, pj, rtol=1e-12)


def test_nan_lane_freezes_like_jax():
    """A runaway-gain lane (negative alpha) overflows; it keeps its last
    finite chunk state and clears ok, as in the JAX scan; the single run
    raises under ``check_nan``."""
    jgrid, tgrid = _grids()
    A0 = _pulses(jgrid, 3, seed=3)
    alpha = np.array([5e-5, -2e4, 5e-5])
    kw = dict(gamma=np.full(3, GAMMA), alpha=alpha, b_xpm=np.asarray(2.0 / 3.0),
              lin_phase=np.zeros((3, 2, N)))
    jc = jv.VGNLSECoeffs(**{k: jnp.asarray(v) for k, v in kw.items()})
    tc = tv.VGNLSECoeffs(**{k: torch.as_tensor(v) for k, v in kw.items()})
    jcfg, tcfg = _cfgs(z_max=1.0, dz=0.01, save_every=10, check_nan=False)
    with np.errstate(all="ignore"):
        pj, Aj, okj = jv.solve_vgnlse_batch(jcfg, jc, A0)
    pt, At, okt = tv.solve_vgnlse_batch(tcfg, tc, A0, device="cpu")
    assert okt.tolist() == okj.tolist() == [True, False, True]
    assert np.isfinite(At).all() and _normwise(At, Aj) <= 1e-12
    np.testing.assert_allclose(pt, pj, rtol=1e-12)
    bad = tv.make_vgnlse_coeffs(tgrid, None, gamma_W_m=1e-6, alpha_1_m=-2e4)
    with pytest.raises(FloatingPointError):
        tv.run_vgnlse_simulation(T.custom_simulation_config(z_max=1.0, dz=0.01, save_every=10),
                                 bad, A0[0], device="cpu")


def test_single_run_trajectories_and_resume():
    """run_vgnlse_simulation (with z0) and the batched trajectories against
    the JAX scan, Strang and rk45; a split fixed-step run equals the straight
    run bit for bit (``test_resume_observability.py:225-253``)."""
    jgrid, tgrid, jc, tc = _coeffs(coupling="cnlse", gamma_W_m=1e-2, dbeta0_1_m=0.1)
    A0 = _pulses(jgrid, 2, seed=4)
    for integrator in ("rk4", "rk45"):
        jcfg, tcfg = _cfgs(z_max=0.5, dz=0.01, save_every=10, integrator=integrator)
        zj, Aj = jv.run_vgnlse_simulation(jcfg, jc, A0[0], z0=1.5)
        zt, At = tv.run_vgnlse_simulation(tcfg, tc, A0[0], z0=1.5, device="cpu")
        assert np.array_equal(zt, zj) and At.shape == Aj.shape == (6, 2, N)
        assert _normwise(At, Aj) <= (1e-12 if integrator == "rk4" else 1e-10)
        zbj, Abj, okj = jv.solve_vgnlse_batch_trajectories(jcfg, jc, A0)
        zbt, Abt, okt = tv.solve_vgnlse_batch_trajectories(tcfg, tc, A0, device="cpu")
        assert np.array_equal(zbt, zbj) and Abt.shape == (2, 6, 2, N) and okt.all() and okj.all()
        assert _normwise(Abt.reshape(2, -1), Abj.reshape(2, -1)) <= (
            1e-12 if integrator == "rk4" else 1e-10)
        assert np.array_equal(Abt[0], tv.run_vgnlse_simulation(tcfg, tc, A0[0],
                                                               device="cpu")[1])
    cfg = T.custom_simulation_config(z_max=1.0, dz=0.01, save_every=10)
    cfg_h = T.custom_simulation_config(z_max=0.5, dz=0.01, save_every=10)
    z_f, A_f = tv.run_vgnlse_simulation(cfg, tc, A0[0], device="cpu")
    z1, A1 = tv.run_vgnlse_simulation(cfg_h, tc, A0[0], device="cpu")
    z2, A2 = tv.run_vgnlse_simulation(cfg_h, tc, A1[-1], z0=float(z1[-1]), device="cpu")
    assert np.array_equal(A_f, np.concatenate([A1, A2[1:]], axis=0))
    np.testing.assert_allclose(np.concatenate([z1, z2[1:]]), z_f, rtol=1e-12)
    pk_f, Al_f, _ = tv.solve_vgnlse_batch(cfg, tc, A0, device="cpu")
    pk1, Al1, _ = tv.solve_vgnlse_batch(cfg_h, tc, A0, device="cpu")
    pk2, Al2, _ = tv.solve_vgnlse_batch(cfg_h, tc, Al1, device="cpu")
    assert np.array_equal(Al_f, Al2)
    np.testing.assert_allclose(np.maximum(pk1, pk2), pk_f, rtol=1e-12)


def test_df32_runs_in_float64_and_matches_jax_x64():
    """The port's df32 is Strang rk4 in float64: against the JAX x64 scan
    to 1e-12 (the JAX df32 engine's own bar is 1e-9); it refuses other
    integrators and float32 coefficients, as the JAX package does."""
    jgrid, tgrid, jc, tc = _coeffs(coupling="isotropic", precision="df32", **BIRE)
    jc64 = jv.make_vgnlse_coeffs(jgrid, J.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2),
                                 coupling="isotropic", **BIRE)
    A0 = _pulses(jgrid, 2, seed=5)
    jcfg, tcfg = _cfgs(precision="df32")
    jcfg64, _ = _cfgs()
    _pj, Aj, _ = jv.solve_vgnlse_batch(jcfg64, jc64, A0)
    _pt, At, okt = tv.solve_vgnlse_batch(tcfg, tc, A0, device="cpu")
    assert okt.all() and _normwise(At, Aj) <= 1e-12
    _z, Ar = tv.run_vgnlse_simulation(tcfg, tc, A0[0], device="cpu")
    assert np.array_equal(Ar[-1], At[0])
    with pytest.raises(ValueError, match="rk4"):
        tv.solve_vgnlse_batch(_cfgs(precision="df32", integrator="rk45")[1], tc, A0,
                              device="cpu")
    c32 = tv.make_vgnlse_coeffs(tgrid, None, gamma_W_m=GAMMA, precision="x32")
    with pytest.raises(ValueError, match="float64"):
        tv.solve_vgnlse_batch(tcfg, c32, A0, device="cpu")


@pytest.mark.parametrize("case", [None, (0.18, OMEGA_REF)], ids=["kerr", "nl"])
def test_empty_polarization_reduces_to_the_scalar_port(case):
    """All power in x: the vector solve is the port's scalar solve (Kerr: bit
    for bit, the same rotation and transforms; nl: the operator forms W in
    another order, 1e-12) and y stays exactly 0."""
    jgrid, tgrid = _grids()
    disp = T.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2)
    cv = tv.make_vgnlse_coeffs(tgrid, disp, gamma_W_m=GAMMA, alpha_1_m=5e-5)
    cs = tg.make_gnlse_coeffs(tgrid, disp, gamma_W_m=GAMMA, alpha_1_m=5e-5)
    _jnl, tnl = _nl(jgrid, tgrid, case)
    a = _pulses(jgrid, 3, seed=6)[:, 0] / np.cos(0.4)
    cfg = T.custom_simulation_config(z_max=0.5, dz=0.01, save_every=10)
    pv, Av, okv = tv.solve_vgnlse_batch(cfg, cv, np.stack([a, np.zeros_like(a)], axis=1),
                                        nl=tnl, device="cpu")
    ps, As, oks = tg.solve_gnlse_batch(cfg, cs, a, nl=tnl, device="cpu")
    assert okv.all() and oks.all() and np.abs(Av[:, 1]).max() == 0.0
    if case is None:
        assert np.array_equal(Av[:, 0], As) and np.array_equal(pv[:, 0], ps)
    else:
        assert _normwise(Av[:, 0], As) <= 1e-12
        np.testing.assert_allclose(pv[:, 0], ps, rtol=1e-12)


# ---------------------------------------------------------------------------
# The JAX tests' oracles on the port alone
# ---------------------------------------------------------------------------

def test_cw_xpm_phases_walkoff_and_birefringent_rotation():
    """tests/test_vgnlse.py:39-56, 115-154: exact XPM phases on CW for both
    incoherent couplings; dbeta1 translates the polarizations by exactly
    -+(dbeta1/2) z; dbeta0 rotates the Stokes vector about S1 (and the DOP
    stays 1)."""
    _jgrid, grid = _grids(64)
    Px, Py, L = 3.0, 1.5, 10.0
    cfg = T.custom_simulation_config(z_max=L, dz=0.05, save_every=50)
    A0 = np.stack([np.full(64, np.sqrt(Px)), np.full(64, np.sqrt(Py))]).astype(complex)
    for coupling, b, geff in (("cnlse", 2.0 / 3.0, GAMMA), ("manakov", 1.0, GAMMA * 8.0 / 9.0)):
        co = tv.make_vgnlse_coeffs(grid, None, gamma_W_m=GAMMA, coupling=coupling)
        _z, A = tv.run_vgnlse_simulation(cfg, co, A0, device="cpu")
        np.testing.assert_allclose(A[-1, 0], np.sqrt(Px) * np.exp(1j * geff * (Px + b * Py) * L),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(A[-1, 1], np.sqrt(Py) * np.exp(1j * geff * (Py + b * Px) * L),
                                   rtol=0, atol=1e-12)
    _jgrid, grid = _grids(N)
    shift = 8
    co = tv.make_vgnlse_coeffs(grid, None, gamma_W_m=0.0, dbeta1_s_m=2.0 * shift * grid.dt_s / L)
    A = tg.gaussian_pulse(grid, peak_W=1.0, t0_s=T0)
    _z, out = tv.run_vgnlse_simulation(cfg, co, np.stack([A, A]), device="cpu")
    np.testing.assert_allclose(out[-1, 0], np.roll(A, -shift), rtol=0, atol=1e-13)
    np.testing.assert_allclose(out[-1, 1], np.roll(A, shift), rtol=0, atol=1e-13)
    _jgrid, grid = _grids(64)
    db0, L = 0.1, 2.5 * np.pi
    co = tv.make_vgnlse_coeffs(grid, None, gamma_W_m=0.0, dbeta0_1_m=db0)
    cfg = T.custom_simulation_config(z_max=L, dz=L / 100, save_every=100)
    _z, out = tv.run_vgnlse_simulation(
        cfg, co, tv.polarized_pulse(np.full(64, 1.0 + 0j), np.pi / 4), device="cpu")
    s = tv.stokes_parameters(out[-1])
    np.testing.assert_allclose(s[0], 1.0, rtol=1e-12)
    np.testing.assert_allclose(s[1], 0.0, atol=1e-12)
    np.testing.assert_allclose(s[2], np.cos(db0 * L), rtol=1e-9)
    np.testing.assert_allclose(s[3], -np.sin(db0 * L), rtol=1e-9)
    assert tv.degree_of_polarization(grid, out[-1]) == pytest.approx(1.0)


def test_isotropic_rotation_invariance_and_power_exchange():
    """tests/test_vgnlse.py:206-245: the isotropic coupling commutes with a
    polarization rotation (the incoherent one does not); the coherent term
    conserves the total power pointwise and moves power between the
    polarizations."""
    _jgrid, grid = _grids(N)
    cfg = T.custom_simulation_config(z_max=10.0, dz=0.02, save_every=100)
    base = tg.sech_pulse(grid, peak_W=8.0, t0_s=T0)
    A0 = np.stack([base, 0.6 * base * np.exp(0.4j)])
    c, s = np.cos(0.7), np.sin(0.7)

    def rot(A):
        return np.stack([c * A[0] - s * A[1], s * A[0] + c * A[1]])

    co = tv.make_vgnlse_coeffs(grid, None, gamma_W_m=GAMMA, coupling="isotropic")
    _, A_f = tv.run_vgnlse_simulation(cfg, co, A0, device="cpu")
    _, A_r = tv.run_vgnlse_simulation(cfg, co, rot(A0), device="cpu")
    scale = np.abs(A0).max()
    np.testing.assert_allclose(A_r[-1], rot(A_f[-1]), rtol=0, atol=1e-11 * scale)
    co_inc = tv.make_vgnlse_coeffs(grid, None, gamma_W_m=GAMMA)
    _, B_f = tv.run_vgnlse_simulation(cfg, co_inc, A0, device="cpu")
    _, B_r = tv.run_vgnlse_simulation(cfg, co_inc, rot(A0), device="cpu")
    assert np.abs(B_r[-1] - rot(B_f[-1])).max() > 1e-3 * scale
    Pt0, PtL = (np.abs(A_f[0]) ** 2).sum(axis=0), (np.abs(A_f[-1]) ** 2).sum(axis=0)
    np.testing.assert_allclose(PtL, Pt0, rtol=0, atol=1e-11 * Pt0.max())
    assert np.abs(np.abs(A_f[-1][0]) ** 2 - np.abs(A_f[0][0]) ** 2).max() > 0.05


def test_validation():
    _jgrid, tgrid, _jc, tc = _coeffs(**BIRE)
    A = tg.gaussian_pulse(tgrid, peak_W=1.0, t0_s=T0)
    cfg = T.custom_simulation_config(z_max=0.1, dz=0.01)
    with pytest.raises(ValueError, match=r"\(2, T\)"):
        tv.run_vgnlse_simulation(cfg, tc, A, device="cpu")
    with pytest.raises(ValueError, match=r"\(B, 2, T\)"):
        tv.solve_vgnlse_batch(cfg, tc, np.stack([A, A]), device="cpu")
    batched = tv.VGNLSECoeffs(gamma=torch.full((2,), GAMMA), alpha=torch.zeros(2),
                              b_xpm=torch.tensor(1.0), lin_phase=torch.zeros(2, 2, N))
    with pytest.raises(ValueError, match="unbatched"):
        tv.run_vgnlse_simulation(cfg, batched, np.stack([A, A]), device="cpu")
    A0 = np.stack([A, A])[None]
    with pytest.raises(ValueError, match="engine"):
        tv.solve_vgnlse_batch(cfg, tc, A0, engine="scan", device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        tv.solve_vgnlse_batch(cfg, tc, A0, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tv.solve_vgnlse_batch(cfg, tc, A0, engine="cuda", device="cpu")
