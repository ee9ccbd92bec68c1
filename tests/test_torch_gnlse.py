"""The port's GNLSE pulse model, ``models/gnlse.py``, against the JAX
package's on the same seeded numpy inputs, on the CPU, and a few of the JAX
package's physics oracles on the port alone.

Tolerances:

- parameter builders and pulses: bit-equal (the same float64 numpy);
- fixed-step solves (Strang with Kerr and the four ``nl`` term combinations,
  RK4IP, spectral and per-instance loss and gamma, a NaN lane, a trailing
  partial chunk): 1e-12 of each envelope's largest amplitude against the
  JAX x64 scan (``torch.fft`` and XLA's FFT round differently);
- ``rk45``/``rk4ip45`` with a trailing span: equal step counters and
  ``ok``, results within 1e-10;
- a resumed fixed-step run equals the straight run bit for bit;
- the oracles keep the JAX tests' bars (``tests/test_gnlse.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import gnlse as jg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.utils.packing import ri_pack_host  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import gnlse as tg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import nwave as tn  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_ssfm_adaptive as tsa  # noqa: E402

torch.set_num_threads(1)

T0 = 1e-12
BETA2 = -2.0e-26
OMEGA_REF = 1.2e15
GAMMA = 2e-3
NL_CASES = [(0.18, OMEGA_REF), (0.18, None), (0.0, OMEGA_REF), (0.0, None)]


def _normwise(a, b):
    """Worst over envelopes of max_t |a - b| / max_t |b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.max(np.abs(a - b), axis=-1) / np.max(np.abs(b), axis=-1)))


def _grids(n):
    g = jg.TimeGrid.for_pulse(T0, n_samples=n)
    return g, tg.TimeGrid(n_samples=g.n_samples, t_window_s=g.t_window_s)


def _coeffs(n, **kw):
    jgrid, tgrid = _grids(n)
    jc = jg.make_gnlse_coeffs(jgrid, J.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2), **kw)
    tc = tg.make_gnlse_coeffs(tgrid, T.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2), **kw)
    return jgrid, tgrid, jc, tc


def _pulses(grid, B, seed=0):
    """Sech envelopes at 0.5-1.5 x the soliton power with a seeded phase
    ripple (bench_gnlse.py:115-118 at small size)."""
    rng = np.random.default_rng(seed)
    P0 = jg.soliton_peak_power(BETA2, GAMMA, T0)
    A0 = np.sqrt(np.linspace(0.5, 1.5, B) * P0)[:, None] / np.cosh(grid.t()[None, :] / T0)
    return (A0 * np.exp(0.1j * rng.standard_normal((B, grid.n_samples)))).astype(np.complex128)


def _nl(jgrid, tgrid, case):
    if case is None:
        return None, None
    f_r, w0 = case
    return (jg.make_nl_terms(jgrid, f_raman=f_r, omega0=w0),
            tg.make_nl_terms(tgrid, f_raman=f_r, omega0=w0))


def _cfgs(**kw):
    base = dict(z_max=0.11, dz=0.01, save_every=3, rtol=1e-8, atol=1e-12)
    base.update(kw)
    return J.custom_simulation_config(**base), T.custom_simulation_config(**base)


# ---------------------------------------------------------------------------
# Parameters, pulses and the comb embedding
# ---------------------------------------------------------------------------

def test_parameter_builders_are_bit_equal():
    jgrid, tgrid = _grids(256)
    assert np.array_equal(jgrid.t(), tgrid.t()) and np.array_equal(jgrid.omega(), tgrid.omega())
    spec = 1e-4 * (jgrid.omega() / np.abs(jgrid.omega()).max()) ** 2
    disp = dict(beta2=BETA2, beta3=1.2e-40, beta4=-3e-55)
    for kw in (dict(), dict(alpha_spec_1_m=spec), dict(max_order=3)):
        jc = jg.make_gnlse_coeffs(jgrid, J.DispersionParams.from_betas(OMEGA_REF, **disp),
                                  gamma_W_m=GAMMA, alpha_1_m=5e-5, **kw)
        tc = tg.make_gnlse_coeffs(tgrid, T.DispersionParams.from_betas(OMEGA_REF, **disp),
                                  gamma_W_m=GAMMA, alpha_1_m=5e-5, **kw)
        for f in ("gamma", "alpha", "lin_phase"):
            t = getattr(tc, f)
            assert t.dtype == torch.float64 and t.device.type == "cpu"
            assert np.array_equal(t.numpy(), np.asarray(getattr(jc, f)))
    assert tg.make_gnlse_coeffs(tgrid, None, gamma_W_m=1.0, precision="x32").gamma.dtype == \
        torch.float32
    for f_r, w0 in NL_CASES:
        jn_ = jg.make_nl_terms(jgrid, f_raman=f_r, omega0=w0)
        tn_ = tg.make_nl_terms(tgrid, f_raman=f_r, omega0=w0)
        for f in ("f_r", "inv_w0", "omega", "hr_re", "hr_im"):
            assert np.array_equal(getattr(tn_, f).numpy(), np.asarray(getattr(jn_, f)))
    assert np.array_equal(tg.raman_response(tgrid), jg.raman_response(jgrid))
    nl = tg.make_nl_terms(tgrid)
    assert tg.raman_t_r(tgrid, nl) == jg.raman_t_r(jgrid, jg.make_nl_terms(jgrid))
    with pytest.raises(ValueError, match="f_raman"):
        tg.make_nl_terms(tgrid, f_raman=1.0)
    with pytest.raises(ValueError, match="alpha_spec_1_m"):
        tg.make_gnlse_coeffs(tgrid, None, gamma_W_m=1.0, alpha_spec_1_m=np.zeros(3))


def test_pulses_comb_embedding_and_spectrum_are_bit_equal():
    jgrid, tgrid = _grids(256)
    for fn, kw in ((jg.gaussian_pulse, dict(peak_W=2.0, t0_s=T0, chirp=0.5)),
                   (jg.sech_pulse, dict(peak_W=3.0, t0_s=T0))):
        assert np.array_equal(getattr(tg, fn.__name__)(tgrid, **kw), fn(jgrid, **kw))
    assert tg.soliton_peak_power(BETA2, GAMMA, T0) == jg.soliton_peak_power(BETA2, GAMMA, T0)
    g_j = jg.TimeGrid(n_samples=256, t_window_s=1e-10)
    g_t = tg.TimeGrid(n_samples=256, t_window_s=1e-10)
    domega = 2 * np.pi * 8 / 1e-10
    amps = np.random.default_rng(0).normal(size=(2, 9)) + 0j
    field = tg.comb_to_field(g_t, amps, domega)
    assert np.array_equal(field, jg.comb_to_field(g_j, amps, domega))
    assert np.array_equal(tg.field_to_comb(g_t, field, 9, domega),
                          jg.field_to_comb(g_j, field, 9, domega))
    for a, b in zip(tg.spectrum_dbw(g_t, field), jg.spectrum_dbw(g_j, field)):
        assert np.array_equal(a, b)
    assert np.array_equal(tg.pulse_energy(g_t, field), jg.pulse_energy(g_j, field))
    with pytest.raises(ValueError, match="integer multiple"):
        tg.comb_to_field(g_t, amps, domega * 1.01)
    with pytest.raises(ValueError, match="anomalous"):
        tg.soliton_peak_power(-BETA2, GAMMA, T0)


# ---------------------------------------------------------------------------
# Solvers against the JAX x64 scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integrator", ["rk4", "rk4ip"])
@pytest.mark.parametrize("case", [None] + NL_CASES)
def test_fixed_step_matches_jax_x64(integrator, case):
    """11 steps at save_every=3: three chunks and a trailing partial one."""
    jgrid, tgrid, jc, tc = _coeffs(256, gamma_W_m=GAMMA, alpha_1_m=5e-5)
    jnl, tnl = _nl(jgrid, tgrid, case)
    A0 = _pulses(jgrid, 5)
    jcfg, tcfg = _cfgs(integrator=integrator)
    pj, Aj, okj = jg.solve_gnlse_batch(jcfg, jc, A0, nl=jnl)
    pt, At, okt = tg.solve_gnlse_batch(tcfg, tc, A0, nl=tnl, device="cpu")
    assert At.dtype == np.complex128 and okt.all() and okj.all()
    assert _normwise(At, Aj) <= 1e-12
    np.testing.assert_allclose(pt, pj, rtol=1e-12)


def _jax_adaptive(cfg, co, A0, nl):
    """The JAX scan's adaptive reduce solve with its step counters
    (``gnlse.py:1246-1272``)."""
    B, Tn = A0.shape
    n_steps = int(round(cfg.z_max / cfg.dz))
    n_chunks = n_steps // cfg.save_every
    solver = jg._gnlse_adaptive_solver("float64", cfg.rtol, cfg.atol, cfg.max_steps, True,
                                       jg._adaptive_method(cfg), n_steps % cfg.save_every > 0)
    al = np.asarray(co.alpha, dtype=float)
    alpha = np.broadcast_to(al, (B, Tn) if al.ndim == 2 or al.shape == (Tn,) else (B,))
    cb = jg.GNLSECoeffs(gamma=jnp.asarray(np.broadcast_to(np.asarray(co.gamma), (B,))),
                        alpha=jnp.asarray(alpha),
                        lin_phase=jnp.asarray(np.broadcast_to(np.asarray(co.lin_phase), (B, Tn))))
    z_grid = jnp.asarray(np.arange(n_chunks + 1) * (cfg.save_every * cfg.dz))
    out = solver(jnp.asarray(ri_pack_host(A0, np.float64)), cb, z_grid, jnp.asarray(cfg.dz), nl,
                 jnp.asarray(n_steps * cfg.dz))
    pk, y_ri, ok, na, nr = jg._split_reduce_pack(out, Tn, counters=True)
    return pk[:, 0], y_ri[..., 0] + 1j * y_ri[..., 1], ok, na, nr


def _port_adaptive(cfg, co, A0, nl, method):
    B, Tn = A0.shape
    lanes = tg.lane_coeffs(co, B, Tn, torch.float64, torch.device("cpu"))
    return tsa.solve_gnlse_batch_rk45_torch(
        torch.as_tensor(A0), *lanes, dz_m=cfg.dz, n_steps=int(round(cfg.z_max / cfg.dz)),
        save_every=cfg.save_every, rtol=cfg.rtol, atol=cfg.atol, max_steps=cfg.max_steps,
        nl=tg._cast_nl(nl, torch.float64, "cpu"), method=method)


@pytest.mark.parametrize("integrator,case,max_steps", [
    ("rk45", None, 10_000), ("rk45", (0.18, OMEGA_REF), 10_000), ("rk4ip45", None, 10_000),
    ("rk4ip45", (0.18, None), 10_000), ("rk45", None, 1)])
def test_adaptive_matches_jax_x64_with_equal_counters(integrator, case, max_steps):
    """11 steps of 0.01 m at save_every=3: a trailing span; ``max_steps=1``
    binds, and the lanes it stops fail in both packages alike."""
    jgrid, tgrid, jc, tc = _coeffs(256, gamma_W_m=GAMMA, alpha_1_m=5e-5)
    jnl, tnl = _nl(jgrid, tgrid, case)
    A0 = _pulses(jgrid, 4, seed=1)
    jcfg, tcfg = _cfgs(integrator=integrator, rtol=1e-7, atol=1e-10, max_steps=max_steps)
    pj, Aj, okj, naj, nrj = _jax_adaptive(jcfg, jc, A0, jnl)
    r = _port_adaptive(tcfg, tc, A0, tnl, tg._adaptive_method(integrator))
    assert r.ok.numpy().tolist() == okj.tolist()
    assert r.n_accepted.numpy().tolist() == naj.tolist()
    assert r.n_rejected.numpy().tolist() == nrj.tolist()
    assert r.n_accepted.dtype == torch.int32
    if max_steps == 1:
        assert not okj.any()
        return
    assert okj.all() and (naj > 3).all()
    assert _normwise(r.A_end.numpy(), Aj) <= 1e-10
    np.testing.assert_allclose(r.peak_max.numpy(), pj, rtol=1e-10)
    # the public entry point returns the same numbers
    pt, At, okt = tg.solve_gnlse_batch(tcfg, tc, A0, nl=tnl, device="cpu")
    assert np.array_equal(At, r.A_end.numpy()) and okt.all()


@pytest.mark.parametrize("shape", ["(T,)", "(B,T)"])
def test_spectral_and_per_instance_coefficients_match_jax(shape):
    jgrid, tgrid = _grids(256)
    om = jgrid.omega()
    spec = 1e-2 * (om / np.abs(om).max()) ** 2
    jc = jg.make_gnlse_coeffs(jgrid, J.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2),
                              gamma_W_m=GAMMA, alpha_1_m=2e-3, alpha_spec_1_m=spec)
    B = 5
    gam = np.linspace(1e-3, 3e-3, B)
    if shape == "(B,T)":
        alpha = np.asarray(jc.alpha)[None, :] * np.linspace(0.5, 1.5, B)[:, None]
    else:
        alpha = np.asarray(jc.alpha)
    A0 = _pulses(jgrid, B, seed=2)
    jcfg, tcfg = _cfgs(z_max=1.1, dz=0.1)
    jc2 = dataclasses.replace(jc, gamma=jnp.asarray(gam), alpha=jnp.asarray(alpha))
    tc2 = tg.GNLSECoeffs(gamma=gam, alpha=alpha, lin_phase=np.asarray(jc.lin_phase))
    for integrator in ("rk4", "rk4ip"):
        jcfg, tcfg = (dataclasses.replace(c, integrator=integrator) for c in (jcfg, tcfg))
        pj, Aj, _ = jg.solve_gnlse_batch(jcfg, jc2, A0)
        pt, At, _ = tg.solve_gnlse_batch(tcfg, tc2, A0, device="cpu")
        assert _normwise(At, Aj) <= 1e-12
        np.testing.assert_allclose(pt, pj, rtol=1e-12)
    # per-instance flat alpha (B,)
    jc3 = dataclasses.replace(jc, gamma=jnp.asarray(gam), alpha=jnp.linspace(0.0, 0.05, B))
    tc3 = tg.GNLSECoeffs(gamma=gam, alpha=np.linspace(0.0, 0.05, B),
                         lin_phase=np.asarray(jc.lin_phase))
    assert _normwise(tg.solve_gnlse_batch(tcfg, tc3, A0, device="cpu")[1],
                     jg.solve_gnlse_batch(jcfg, jc3, A0)[1]) <= 1e-12


def test_nan_lane_freezes_like_jax():
    """A runaway-gain lane (negative alpha) overflows; it keeps its last
    finite chunk state and clears ok, as in the JAX scan."""
    jgrid, tgrid = _grids(128)
    A0 = _pulses(jgrid, 3, seed=3)
    alpha = np.array([5e-5, -2e4, 5e-5])
    jc = jg.GNLSECoeffs(gamma=jnp.full(3, GAMMA), alpha=jnp.asarray(alpha),
                        lin_phase=jnp.zeros((3, 128)))
    tc = tg.GNLSECoeffs(gamma=np.full(3, GAMMA), alpha=alpha, lin_phase=np.zeros((3, 128)))
    jcfg, tcfg = _cfgs(z_max=1.0, dz=0.01, save_every=10, check_nan=False)
    with np.errstate(all="ignore"):
        pj, Aj, okj = jg.solve_gnlse_batch(jcfg, jc, A0)
    pt, At, okt = tg.solve_gnlse_batch(tcfg, tc, A0, device="cpu")
    assert okt.tolist() == okj.tolist() == [True, False, True]
    assert np.isfinite(At).all()
    assert _normwise(At, Aj) <= 1e-12
    np.testing.assert_allclose(pt, pj, rtol=1e-12)
    with pytest.raises(FloatingPointError):
        tg.run_gnlse_simulation(dataclasses.replace(tcfg, check_nan=True),
                                tg.GNLSECoeffs(gamma=GAMMA, alpha=-2e4,
                                               lin_phase=np.zeros(128)), A0[1], device="cpu")


def test_run_gnlse_simulation_matches_jax_and_resumes_bitwise():
    jgrid, tgrid, jc, tc = _coeffs(256, gamma_W_m=GAMMA, alpha_1_m=5e-5)
    jnl, tnl = _nl(jgrid, tgrid, (0.18, OMEGA_REF))
    A0 = _pulses(jgrid, 1, seed=4)[0]
    jcfg, tcfg = _cfgs(z_max=0.12)
    zj, Aj = jg.run_gnlse_simulation(jcfg, jc, A0, nl=jnl, z0=2.0)
    zt, At = tg.run_gnlse_simulation(tcfg, tc, A0, nl=tnl, z0=2.0, device="cpu")
    assert np.array_equal(zt, zj) and At.shape == (5, 256)
    assert _normwise(At, Aj) <= 1e-12
    # resume from the second saved row: bitwise the rest of the straight run
    zr, Ar = tg.run_gnlse_simulation(dataclasses.replace(tcfg, z_max=0.06), tc, At[2], nl=tnl,
                                     z0=zt[2], device="cpu")
    assert np.array_equal(Ar, At[2:]) and np.allclose(zr, zt[2:], rtol=0, atol=1e-15)
    # adaptive single runs and a spectral (T,) alpha
    sc = dataclasses.replace(tc, alpha=tc.alpha + 1e-3 * torch.arange(256) / 256)
    jsc = dataclasses.replace(jc, alpha=jnp.asarray(sc.alpha.numpy()))
    for integrator in ("rk45", "rk4"):
        jc45, tc45 = _cfgs(z_max=0.11, integrator=integrator, rtol=1e-8, atol=1e-11)
        assert _normwise(tg.run_gnlse_simulation(tc45, sc, A0, device="cpu")[1],
                         jg.run_gnlse_simulation(jc45, jsc, A0)[1]) <= 1e-10
    with pytest.raises(ValueError, match="unbatched"):
        tg.run_gnlse_simulation(tcfg, tg.GNLSECoeffs(gamma=np.ones(2), alpha=0.0,
                                                     lin_phase=np.zeros(256)), A0, device="cpu")
    with pytest.raises(ValueError, match=r"\(T,\)"):
        tg.run_gnlse_simulation(tcfg, tc, A0[None], device="cpu")


@pytest.mark.parametrize("integrator", ["rk4", "rk45"])
def test_batch_trajectories_match_jax(integrator):
    jgrid, tgrid, jc, tc = _coeffs(256, gamma_W_m=GAMMA, alpha_1_m=5e-5)
    A0 = _pulses(jgrid, 3, seed=5)
    jcfg, tcfg = _cfgs(integrator=integrator, rtol=1e-8, atol=1e-11)
    zj, Aj, okj = jg.solve_gnlse_batch_trajectories(jcfg, jc, A0, z0=1.0)
    zt, At, okt = tg.solve_gnlse_batch_trajectories(tcfg, tc, A0, z0=1.0, device="cpu")
    assert np.array_equal(zt, zj) and At.shape == Aj.shape == (3, 4, 256)
    assert okt.tolist() == okj.tolist()
    assert _normwise(At.reshape(-1, 256), Aj.reshape(-1, 256)) <= 1e-10
    # the last row is solve_gnlse_batch's A_last
    assert np.array_equal(tg.solve_gnlse_batch(tcfg, tc, A0, device="cpu")[1], At[:, -1])


def test_validation_matches_jax():
    jgrid, tgrid, jc, tc = _coeffs(128, gamma_W_m=GAMMA)
    A0 = _pulses(jgrid, 2)
    for integ in ("rk45", "rk4ip"):
        cfg = T.custom_simulation_config(z_max=0.1, dz=0.01, precision="df32", integrator=integ)
        with pytest.raises(ValueError, match="df32"):
            tg.solve_gnlse_batch(cfg, tc, A0, device="cpu")
    cfg = T.custom_simulation_config(z_max=0.1, dz=0.01)
    with pytest.raises(ValueError, match=r"\(B, T\)"):
        tg.solve_gnlse_batch(cfg, tc, A0[0], device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tg.solve_gnlse_batch(cfg, tc, A0, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tg.solve_gnlse_batch(cfg, tc, A0, engine="cuda", device="cpu")
    with pytest.raises(TypeError, match="mesh must be"):
        tg.solve_gnlse_batch(cfg, tc, A0, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="ab4"):
        tg.solve_gnlse_batch(T.custom_simulation_config(z_max=0.1, dz=0.01, integrator="ab4"),
                             tc, A0, device="cpu")
    # df32 runs Strang rk4 in float64: the x64 numbers
    x64 = tg.solve_gnlse_batch(cfg, tc, A0, device="cpu")
    df32 = tg.solve_gnlse_batch(dataclasses.replace(cfg, precision="df32"), tc, A0, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(x64, df32))


# ---------------------------------------------------------------------------
# Physics oracles of tests/test_gnlse.py, on the port alone
# ---------------------------------------------------------------------------

def test_spm_only_exact_phase_and_loss_decay():
    _, grid = _grids(512)
    cfg = T.custom_simulation_config(z_max=100.0, dz=1.0, save_every=100)
    A0 = tg.gaussian_pulse(grid, peak_W=5.0, t0_s=T0, chirp=0.5)
    _, A = tg.run_gnlse_simulation(cfg, tg.make_gnlse_coeffs(grid, None, gamma_W_m=2e-3), A0,
                                   device="cpu")
    np.testing.assert_allclose(A[-1], A0 * np.exp(1j * 2e-3 * np.abs(A0) ** 2 * 100.0),
                               rtol=0, atol=1e-12)
    A0 = tg.gaussian_pulse(grid, peak_W=2.0, t0_s=T0)
    z, A = tg.run_gnlse_simulation(
        cfg, tg.make_gnlse_coeffs(grid, None, gamma_W_m=0.0, alpha_1_m=0.01), A0, device="cpu")
    np.testing.assert_allclose(A[-1], A0 * np.exp(-0.5 * 0.01 * 100.0), rtol=0, atol=1e-12)
    E = tg.pulse_energy(grid, A)
    np.testing.assert_allclose(E / E[0], np.exp(-0.01 * z), rtol=1e-12)


def test_fundamental_soliton_shape_invariant():
    _, grid = _grids(1024)
    P0 = tg.soliton_peak_power(BETA2, GAMMA, T0)
    co = tg.make_gnlse_coeffs(grid, T.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2),
                              gamma_W_m=GAMMA)
    zper = 0.5 * np.pi * T0 ** 2 / abs(BETA2)
    cfg = T.custom_simulation_config(z_max=zper, dz=zper / 1000, save_every=250)
    Asol = tg.sech_pulse(grid, peak_W=P0, t0_s=T0)
    _, A = tg.run_gnlse_simulation(cfg, co, Asol, device="cpu")
    for row in A:
        np.testing.assert_allclose(np.abs(row), np.abs(Asol), rtol=0, atol=3e-7 * np.sqrt(P0))


def test_raman_soliton_red_shift_gordon():
    """The spectral centroid of a Raman soliton moves to lower frequency at
    Gordon's rate (10%): pins the sign of conj(H_R) on the reversed time
    axis."""
    t0 = 1e-13
    grid = tg.TimeGrid.for_pulse(t0, n_samples=1024)
    P0 = tg.soliton_peak_power(BETA2, GAMMA, t0)
    co = tg.make_gnlse_coeffs(grid, T.DispersionParams.from_betas(OMEGA_REF, beta2=BETA2),
                              gamma_W_m=GAMMA)
    nl = tg.make_nl_terms(grid, f_raman=0.18)
    t_r = tg.raman_t_r(grid, nl)
    L = 10.0
    cfg = T.custom_simulation_config(z_max=L, dz=0.005, save_every=2000)
    _, A = tg.run_gnlse_simulation(cfg, co, tg.sech_pulse(grid, peak_W=P0, t0_s=t0), nl=nl,
                                   device="cpu")
    om = grid.omega()

    def centroid(a):
        S = np.abs(np.fft.fft(a)) ** 2
        return (om * S).sum() / S.sum()

    shift = centroid(A[-1]) - centroid(A[0])
    assert shift < 0
    np.testing.assert_allclose(shift, -8.0 * abs(BETA2) * t_r / (15.0 * t0 ** 4) * L, rtol=0.1)


def test_gnlse_matches_the_ports_nwave_comb():
    """A periodic-window GNLSE with comb-line initial conditions is the
    N-wave comb ODE system: the port's two solvers agree on every
    significant line (``tests/test_gnlse.py:122``)."""
    omega_c = 2 * np.pi * 193.1e12
    domega = 2 * np.pi * 50e9
    N = 65
    cgrid = tn.CombGrid.centered(omega_c, domega, N)
    gam, al = 10e-3, 5e-5
    c = N // 2
    A0 = tn.seed_comb(cgrid, pump_lines={c - 1: 0.3, c + 1: 0.3, c + 4: 1e-5})
    disp = T.DispersionParams.from_betas(omega_c, beta2=-1.0e-27, beta3=1.2e-41)
    cfg = T.custom_simulation_config(z_max=60.0, dz=0.02, save_every=3000)
    _, Acomb = tn.run_comb_simulation(cfg, tn.make_comb_coeffs(cgrid, disp, gamma_W_m=gam,
                                                               alpha_1_m=al), A0, device="cpu")
    tgrid = tg.TimeGrid(n_samples=1024, t_window_s=2 * np.pi / domega * 8)
    _, Af = tg.run_gnlse_simulation(
        cfg, tg.make_gnlse_coeffs(tgrid, disp, gamma_W_m=gam, alpha_1_m=al),
        tg.comb_to_field(tgrid, A0, domega), device="cpu")
    lines = tg.field_to_comb(tgrid, Af[-1], N, domega)
    ref = Acomb[-1]
    sig = np.abs(ref) ** 2 > 1e-9
    assert sig.sum() >= 5
    np.testing.assert_allclose(lines[sig], ref[sig], rtol=1e-6)
