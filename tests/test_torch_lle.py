"""The port's Lugiato-Lefever cavity model, ``models/lle.py``, against the
JAX package's on the same seeded numpy inputs, on the CPU, and the JAX
package's analytic oracles (``tests/test_lle.py``) on the port alone.

Tolerances:

- coefficient builders, oracles and seeds: bit-equal (the same float64
  numpy);
- fixed-step solves (Strang and RK4IP, shared and per-cavity phase, a
  complex pump, a trailing partial chunk, a NaN or overflowing cavity, the
  ramp, the trajectories, the detuning scan): 1e-12 of each cavity's
  largest amplitude against the JAX x64 scan (``torch.fft`` and XLA's FFT
  round differently);
- ``rk45``/``rk4ip45`` with a trailing span: equal step counters and
  ``ok``, results within 1e-10;
- a resumed ramp equals the straight one bit for bit;
- ``df32`` (float64 here): within 1e-9 of the JAX two-float engine
  (``ops/df32_lle.py``, run eagerly) and 1e-12 of the JAX x64 scan;
- the oracles keep the JAX tests' bars, at smaller sizes where the state is
  flat.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import gnlse as jg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import lle as jl  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops import df32_lle as jdf  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops.twofloat import (  # noqa: E402
    ctf_from_c128,
    ctf_to_c128,
    tf_to_f64,
)
from psa_simulation_ode_rk_mvp_dispersion_tpu.utils.packing import ri_pack_host  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import lle as tl  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_ssfm_adaptive as tsa  # noqa: E402

torch.set_num_threads(1)

JGRID = jl.TimeGrid(n_samples=256, t_window_s=20.0)
TGRID = tl.TimeGrid(n_samples=256, t_window_s=20.0)
PUMP = 2.0 * np.exp(0.3j)


def _normwise(a, b):
    """Worst over cavities of max_tau |a - b| / max_tau |b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.max(np.abs(a - b), axis=-1) / np.max(np.abs(b), axis=-1)))


def _cfgs(**kw):
    base = dict(z_max=0.11, dz=0.01, save_every=3, rtol=1e-8, atol=1e-11)
    base.update(kw)
    return J.custom_simulation_config(**base), T.custom_simulation_config(**base)


def _coeffs(dets, pump=PUMP, rows=False, **kw):
    """The same coefficients in both packages; ``rows``: a per-cavity
    ``(B, T)`` phase (dispersion scaled 0.8-1.2 across the batch)."""
    jc = jl.make_lle_coeffs(JGRID, detuning=dets, pump=pump, d2=-1.0, **kw)
    tc = tl.make_lle_coeffs(TGRID, detuning=dets, pump=pump, d2=-1.0, **kw)
    if rows:
        ph = np.asarray(jc.lin_phase)[None] * np.linspace(0.8, 1.2, len(dets))[:, None]
        jc = dataclasses.replace(jc, lin_phase=jnp.asarray(ph))
        tc = dataclasses.replace(tc, lin_phase=torch.as_tensor(ph))
    return jc, tc


def _solitons(dets, pump=2.0):
    return np.stack([jl.soliton_ansatz(JGRID, d, pump, -1.0) for d in dets])


# ---------------------------------------------------------------------------
# Coefficients, oracles and seeds
# ---------------------------------------------------------------------------

def test_coefficients_oracles_and_seeds_are_bit_equal():
    for kw in (dict(detuning=1.5, pump=2.0, d2=-1.0),
               dict(detuning=np.linspace(0, 4, 5), pump=PUMP, dispersion_coeffs=[-1.0, 0.1, 0.02]),
               dict(detuning=[1.0, 2.0], pump=[1.0, 1.5j])):
        jc = jl.make_lle_coeffs(JGRID, **kw)
        tc = tl.make_lle_coeffs(TGRID, **kw)
        for f in ("detuning", "pump_re", "pump_im", "lin_phase"):
            t = getattr(tc, f)
            assert t.dtype == torch.float64 and t.device.type == "cpu"
            assert np.array_equal(t.numpy(), np.asarray(getattr(jc, f)))
    assert tl.make_lle_coeffs(TGRID, detuning=1.0, pump=1.0, precision="x32").lin_phase.dtype == \
        torch.float32
    assert tl.make_lle_coeffs(TGRID, detuning=1.0, pump=1.0, precision="df32").pump_re.dtype == \
        torch.float64
    for bad, msg in ((dict(d2=-1.0, dispersion_coeffs=[1.0]), "not both"),
                     (dict(detuning=np.zeros((2, 2))), "scalar or"),
                     (dict(dispersion_coeffs=[1e308, 1e308]), "finite")):
        kw = dict(detuning=1.0, pump=1.0)
        kw.update(bad)
        with pytest.raises(ValueError, match=msg), np.errstate(all="ignore"):
            tl.make_lle_coeffs(TGRID, **kw)
    for det, F in ((1.0, 1.1), (3.0, 1.9), (4.0, 2.0)):
        roots = tl.cw_steady_states(det, F)
        assert np.array_equal(roots, jl.cw_steady_states(det, F))
        for r in roots:
            assert tl.cw_state(det, F, r) == jl.cw_state(det, F, r)
            assert tl.mi_gain_peak(det, r) == jl.mi_gain_peak(det, r)
    seed = tl.soliton_ansatz(TGRID, 4.0, 2.0, -1.0, t0=1.5)
    assert np.array_equal(seed, jl.soliton_ansatz(JGRID, 4.0, 2.0, -1.0, t0=1.5))
    assert np.array_equal(tl.comb_spectrum(seed), jl.comb_spectrum(seed))
    with pytest.raises(ValueError, match="anomalous"):
        tl.soliton_ansatz(TGRID, 4.0, 2.0, 1.0)
    with pytest.raises(ValueError, match="no soliton"):
        tl.soliton_ansatz(TGRID, 4.0, 0.5, -1.0)
    kw = dict(round_trip_length_m=100.0, t_roundtrip_s=5e-7, gamma_W_m=1.2e-3,
              beta2_s2_m=-21e-27, alpha_half_loss=0.1, coupling_theta=0.08,
              detuning_phase_rad=0.3, pump_power_W=1.5)
    assert dataclasses.asdict(tl.normalize_ring_cavity(**kw)) == \
        dataclasses.asdict(jl.normalize_ring_cavity(**kw))
    for bad, msg in ((dict(beta2_s2_m=0.0), "beta2"), (dict(gamma_W_m=-1.0), "gamma_W_m"),
                     (dict(pump_power_W=-1.0), "pump_power_W")):
        with pytest.raises(ValueError, match=msg):
            tl.normalize_ring_cavity(**{**kw, **bad})


# ---------------------------------------------------------------------------
# Solvers against the JAX x64 scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integrator", ["rk4", "rk4ip"])
@pytest.mark.parametrize("rows", [False, True], ids=["shared_phase", "phase_rows"])
def test_fixed_step_matches_jax_x64(integrator, rows):
    """11 steps at save_every=3: three chunks and a trailing partial one;
    per-cavity detuning, a complex pump."""
    dets = np.linspace(3.5, 4.5, 5)
    jc, tc = _coeffs(dets, rows=rows)
    psi0 = _solitons(dets)
    jcfg, tcfg = _cfgs(integrator=integrator)
    pj, Aj, okj = jl.solve_lle_batch(jcfg, jc, psi0)
    pt, At, okt = tl.solve_lle_batch(tcfg, tc, psi0, device="cpu")
    assert At.dtype == np.complex128 and pt.dtype == np.float64
    assert okt.all() and okj.all()
    assert _normwise(At, Aj) <= 1e-12
    np.testing.assert_allclose(pt, pj, rtol=1e-12)


def _jax_adaptive(cfg, co, psi0):
    """The JAX scan's adaptive reduce solve with its step counters
    (``lle.py:998-1006``)."""
    B, Tn = psi0.shape
    n_steps = int(round(cfg.z_max / cfg.dz))
    n_chunks = n_steps // cfg.save_every
    solver = jl._lle_adaptive_solver("float64", cfg.rtol, cfg.atol, cfg.max_steps, True,
                                     n_steps % cfg.save_every > 0,
                                     jl._lle_adaptive_family(jl._lle_method(cfg)))
    det, fr, fi, ph = jl._norm_batch(co, B, Tn, np.float64)
    cb = jl.LLECoeffs(detuning=jnp.asarray(det), pump_re=jnp.asarray(fr),
                      pump_im=jnp.asarray(fi), lin_phase=jnp.asarray(ph))
    t_grid = jnp.asarray(np.arange(n_chunks + 1) * (cfg.save_every * cfg.dz))
    out = solver(jnp.asarray(ri_pack_host(psi0, np.float64)), cb, t_grid, jnp.asarray(cfg.dz),
                 jnp.asarray(n_steps * cfg.dz))
    pk, y_ri, ok, na, nr = jg._split_reduce_pack(out, Tn, counters=True)
    return pk[:, 0], y_ri[..., 0] + 1j * y_ri[..., 1], ok, na, nr


@pytest.mark.parametrize("integrator,max_steps", [("rk45", 100_000), ("rk4ip45", 100_000),
                                                  ("rk45", 1)])
def test_adaptive_matches_jax_x64_with_equal_counters(integrator, max_steps):
    """11 steps of 0.01 at save_every=3: a trailing span; ``max_steps=1``
    binds, and the cavities it stops fail in both packages alike."""
    dets = np.linspace(3.6, 4.4, 4)
    jc, tc = _coeffs(dets)
    psi0 = _solitons(dets)
    jcfg, tcfg = _cfgs(integrator=integrator, rtol=1e-7, atol=1e-10, max_steps=max_steps)
    pj, Aj, okj, naj, nrj = _jax_adaptive(jcfg, jc, psi0)
    det, F, ph = tl.lane_coeffs(tc, 4, 256, torch.float64, "cpu")
    r = tsa.solve_lle_batch_rk45_torch(
        torch.as_tensor(psi0), det, F, ph, dt=tcfg.dz, n_steps=11, save_every=3,
        rtol=tcfg.rtol, atol=tcfg.atol, max_steps=max_steps,
        method=tl._adaptive_family(integrator))
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
    pt, At, okt = tl.solve_lle_batch(tcfg, tc, psi0, device="cpu")
    assert np.array_equal(At, r.A_end.numpy()) and okt.all()


@pytest.mark.parametrize("integrator", ["rk4", "rk45"])
def test_trajectories_match_jax_and_the_reduce_mode(integrator):
    dets = np.array([1.0, 2.0, 4.0])
    jc, tc = _coeffs(dets, pump=2.0)
    psi0 = np.stack([np.full(256, 0.1 + 0j), np.full(256, 0.2 + 0j),
                     jl.soliton_ansatz(JGRID, 4.0, 2.0, -1.0)])
    jcfg, tcfg = _cfgs(z_max=0.5, dz=0.01, save_every=20, integrator=integrator)
    tj, Aj, okj = jl.solve_lle_batch_trajectories(jcfg, jc, psi0)
    tt, At, okt = tl.solve_lle_batch_trajectories(tcfg, tc, psi0, device="cpu")
    assert np.array_equal(tt, tj) and At.shape == Aj.shape == (3, 3, 256)
    assert okt.tolist() == okj.tolist() == [True] * 3
    assert _normwise(At.reshape(-1, 256), Aj.reshape(-1, 256)) <= 1e-10
    pk, A_last, ok = tl.solve_lle_batch(tcfg, tc, psi0, device="cpu")
    assert np.array_equal(A_last, At[:, -1]) and ok.all()
    np.testing.assert_allclose(pk, np.max(np.abs(At) ** 2, axis=(1, 2)), rtol=1e-12)


def test_ramp_matches_jax_resumes_bitwise_and_integrates_the_tail():
    """105 steps at save_every=10: ten saved chunks and five trailing
    steps; a resume from a saved row is bitwise the straight ramp."""
    rng = np.random.default_rng(1)
    p0 = 1e-3 * (rng.standard_normal(256) + 1j * rng.standard_normal(256))
    jc, tc = _coeffs(0.0, pump=2.0)
    jcfg, tcfg = _cfgs(z_max=1.05, dz=0.01, save_every=10)
    kw = dict(detuning_start=-2.0, detuning_end=5.0)
    tj, dj, Pj = jl.run_lle_ramp(jcfg, jc, p0, **kw)
    tt, dt_, Pt = tl.run_lle_ramp(tcfg, tc, p0, device="cpu", **kw)
    assert np.array_equal(tt, tj) and np.array_equal(dt_, dj) and Pt.shape == (11, 256)
    assert _normwise(Pt, Pj) <= 1e-12
    tr, dr, Pr = tl.run_lle_ramp(tcfg, tc, Pt[4], t0=tt[4], device="cpu", **kw)
    assert np.array_equal(Pr, Pt[4:]) and np.array_equal(dr, dt_[4:])
    assert np.allclose(tr, tt[4:], rtol=0, atol=1e-15)
    # every step is trailing: a diverging field still raises (x32 overflow)
    cfg32 = T.custom_simulation_config(z_max=0.05, dz=0.01, save_every=10, precision="x32")
    with pytest.raises(FloatingPointError):
        tl.run_lle_ramp(cfg32, tc, np.full(256, 1e20 + 0j), detuning_start=0.0,
                        detuning_end=1.0, device="cpu")


def test_detuning_scan_matches_jax_from_the_same_seed():
    jcfg, tcfg = _cfgs(z_max=0.6, dz=0.01, save_every=20)
    kw = dict(detunings=np.linspace(-1.0, 4.5, 6), pump=2.0, d2=-1.0, seed=3)
    jr = jl.detuning_scan(jcfg, JGRID, **kw)
    tr = tl.detuning_scan(tcfg, TGRID, device="cpu", **kw)
    assert np.array_equal(tr[0], jr[0]) and tr[4].all() and jr[4].all()
    assert _normwise(tr[3], jr[3]) <= 1e-12
    for a, b in ((tr[1], jr[1]), (tr[2], jr[2])):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    # the precision override reaches the coefficients and the dispatch
    r32 = tl.detuning_scan(tcfg, TGRID, precision="x32", device="cpu", **kw)
    assert np.max(np.abs(r32[3] - tr[3])) / np.max(np.abs(tr[3])) < 1e-4
    with pytest.raises(ValueError, match="non-empty"):
        tl.detuning_scan(tcfg, TGRID, detunings=[], pump=2.0, d2=-1.0, device="cpu")


def test_run_lle_simulation_matches_jax_and_checks_nan():
    jc, tc = _coeffs(4.0)
    seed = jl.soliton_ansatz(JGRID, 4.0, 2.0, -1.0)
    for integrator, bar in (("rk4", 1e-12), ("rk4ip", 1e-12), ("rk45", 1e-10)):
        jcfg, tcfg = _cfgs(z_max=0.12, integrator=integrator)
        tj, Pj = jl.run_lle_simulation(jcfg, jc, seed, t0=2.5)
        tt, Pt = tl.run_lle_simulation(tcfg, tc, seed, t0=2.5, device="cpu")
        assert np.array_equal(tt, tj) and Pt.shape == Pj.shape == (5, 256)
        assert _normwise(Pt, Pj) <= bar
    # resume from a saved row: bitwise the rest of the straight run
    _jcfg, tcfg = _cfgs(z_max=0.12)
    tt, Pt = tl.run_lle_simulation(tcfg, tc, seed, device="cpu")
    _tr, Pr = tl.run_lle_simulation(dataclasses.replace(tcfg, z_max=0.06), tc, Pt[2], t0=tt[2],
                                    device="cpu")
    assert np.array_equal(Pr, Pt[2:])
    for integrator in ("rk4", "rk45"):
        with pytest.raises(FloatingPointError):
            tl.run_lle_simulation(_cfgs(integrator=integrator)[1], tc, np.full(256, np.nan + 0j),
                                  device="cpu")
    with pytest.raises(ValueError, match="t0"):
        tl.run_lle_simulation(tcfg, tc, seed, t0=np.inf, device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        tl.run_lle_simulation(tcfg, tc, seed[None], device="cpu")


@pytest.mark.parametrize("bad", [np.nan, 1e160], ids=["nan", "overflow"])
def test_failed_cavity_freezes_like_jax(bad):
    """A NaN seed fails before any step; a 1e160 seed overflows |psi|^2 in
    float64 in the first Kerr substep: either keeps its input and clears
    ok, in both packages, while the others are untouched."""
    dets = np.array([1.0, 1.0, 1.0])
    jc, tc = _coeffs(dets, pump=1.1)
    psi0 = np.full((3, 256), 0.1 + 0j)
    psi0[1] = bad
    jcfg, tcfg = _cfgs(z_max=0.25, dz=0.01, save_every=5, check_nan=False)
    with np.errstate(all="ignore"):
        pj, Aj, okj = jl.solve_lle_batch(jcfg, jc, psi0)
    pt, At, okt = tl.solve_lle_batch(tcfg, tc, psi0, device="cpu")
    assert okt.tolist() == okj.tolist() == [True, False, True]
    assert np.array_equal(At[1], psi0[1], equal_nan=True)
    good = okt
    assert _normwise(At[good], Aj[good]) <= 1e-12


def test_df32_matches_the_jax_two_float_engine_and_x64():
    """df32 runs in float64 here: within the JAX df32 engine's 1e-9 and
    within 1e-12 of the JAX x64 scan (``tests/test_df32_lle.py:76-105``)."""
    grid_j = jl.TimeGrid(n_samples=64, t_window_s=20.0)
    grid_t = tl.TimeGrid(n_samples=64, t_window_s=20.0)
    det, F = 2.0, 1.4
    rng = np.random.default_rng(7)
    base = jl.cw_state(det, F, jl.cw_steady_states(det, F)[0])
    psi0 = base + 0.05 * (rng.standard_normal((3, 64)) + 1j * rng.standard_normal((3, 64)))
    dt, n_steps, save_every = 0.02, 40, 10
    cfg = dict(z_max=dt * n_steps, dz=dt, save_every=save_every)
    pt, At, okt = tl.solve_lle_batch(T.custom_simulation_config(precision="df32", **cfg),
                                     tl.make_lle_coeffs(grid_t, detuning=det, pump=F, d2=-1.0,
                                                        precision="df32"), psi0, device="cpu")
    co_j = jl.make_lle_coeffs(grid_j, detuning=det, pump=F, d2=-1.0, precision="df32")
    co = jdf.make_df32_lle_coeffs(det, F, np.asarray(co_j.lin_phase), dt=dt, B=3, T=64)
    pk, y, ok = jdf.run_reduce_eager(ctf_from_c128(psi0), co, n_steps, save_every)
    assert okt.all() and np.all(np.asarray(ok))
    A_df = ctf_to_c128(y)
    assert np.max(np.abs(At - A_df)) / np.max(np.abs(A_df)) <= 1e-9
    np.testing.assert_allclose(pt, tf_to_f64(pk), rtol=1e-9)
    p64, A64, _ = jl.solve_lle_batch(J.custom_simulation_config(**cfg),
                                     jl.make_lle_coeffs(grid_j, detuning=det, pump=F, d2=-1.0),
                                     psi0)
    assert _normwise(At, A64) <= 1e-12
    np.testing.assert_allclose(pt, p64, rtol=1e-12)


def test_every_error_the_jax_module_raises():
    jc, tc = _coeffs(1.0, pump=1.0)
    psi0 = np.zeros(256, complex)
    tcfg = _cfgs()[1]
    for integ in ("ab4", "abm4"):
        with pytest.raises(ValueError, match="not supported by the LLE"):
            tl.run_lle_simulation(dataclasses.replace(tcfg, integrator=integ), tc, psi0,
                                  device="cpu")
    with pytest.raises(ValueError, match="rk4"):
        tl.run_lle_ramp(dataclasses.replace(tcfg, integrator="rk4ip"), tc, psi0,
                        detuning_start=0.0, detuning_end=1.0, device="cpu")
    co_df = tl.make_lle_coeffs(TGRID, detuning=1.0, pump=1.0, d2=-1.0, precision="df32")
    df32 = dataclasses.replace(tcfg, precision="df32")
    for integ in ("rk4ip", "rk45", "rk4ip45"):
        with pytest.raises(ValueError, match="df32"):
            tl.run_lle_simulation(dataclasses.replace(df32, integrator=integ), co_df, psi0,
                                  device="cpu")
        with pytest.raises(ValueError, match="df32"):
            tl.solve_lle_batch(dataclasses.replace(df32, integrator=integ), co_df, psi0[None],
                               device="cpu")
    with pytest.raises(ValueError, match="df32"):
        tl.run_lle_ramp(df32, co_df, psi0, detuning_start=0.0, detuning_end=1.0, device="cpu")
    co32 = tl.make_lle_coeffs(TGRID, detuning=1.0, pump=1.0, d2=-1.0, precision="x32")
    with pytest.raises(ValueError, match="float64"):
        tl.run_lle_simulation(df32, co32, psi0, device="cpu")
    for t0 in (-1.0, 5.0, np.nan):
        with pytest.raises(ValueError, match="inside the ramp"):
            tl.run_lle_ramp(tcfg, tc, psi0, detuning_start=0.0, detuning_end=1.0, t0=t0,
                            device="cpu")
    with pytest.raises(ValueError, match=r"\(B, T\)"):
        tl.solve_lle_batch(tcfg, tc, psi0, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tl.solve_lle_batch(tcfg, tc, psi0[None], engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tl.solve_lle_batch(tcfg, tc, psi0[None], engine="cuda", device="cpu")
    with pytest.raises(TypeError, match="mesh must be"):
        tl.solve_lle_batch(tcfg, tc, psi0[None], mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="lin_phase"):
        tl.solve_lle_batch(tcfg, tc, np.zeros((2, 128), complex), device="cpu")
    # df32 runs Strang rk4 in float64: the x64 numbers
    co64 = tl.make_lle_coeffs(TGRID, detuning=1.0, pump=1.0, d2=-1.0)
    x64 = tl.solve_lle_batch(tcfg, co64, np.full((2, 256), 0.1 + 0j), device="cpu")
    d = tl.solve_lle_batch(df32, co64, np.full((2, 256), 0.1 + 0j), device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(x64, d))


# ---------------------------------------------------------------------------
# Oracles of tests/test_lle.py, on the port alone
# ---------------------------------------------------------------------------

def _flat_grid(n=16):
    return tl.TimeGrid(n_samples=n, t_window_s=20.0)


def test_linear_transient_is_exact():
    """No Kerr: the affine linear step is exact at any dz."""
    det, F = 0.7, 1e-6
    co = tl.make_lle_coeffs(TGRID, detuning=det, pump=F, d2=-1.0)
    cfg = T.custom_simulation_config(z_max=3.0, dz=0.05, save_every=10)
    t, psi = tl.run_lle_simulation(cfg, co, np.zeros(256, complex), device="cpu")
    psi_s = F / (1 + 1j * det)
    ana = psi_s * (1 - np.exp(-(1 + 1j * det) * t))
    assert np.max(np.abs(psi[:, 0] - ana)) / abs(psi_s) < 1e-10
    assert np.max(np.abs(psi[-1] - psi[-1, 0])) < 1e-18


def test_cw_root_bistability_and_strang_order():
    """rk4ip lands on the cubic root (both branches when bistable);
    Strang's steady-state bias is second order in dz."""
    grid = _flat_grid()
    det, F = 1.0, 1.1
    root = tl.cw_steady_states(det, F)
    co = tl.make_lle_coeffs(grid, detuning=det, pump=F, d2=-1.0)
    cfg = T.custom_simulation_config(z_max=40.0, dz=0.01, save_every=4000, integrator="rk4ip")
    _, psi = tl.run_lle_simulation(cfg, co, np.full(16, 0.1 + 0j), device="cpu")
    np.testing.assert_allclose(abs(psi[-1, 0]) ** 2, root[0], rtol=1e-8)
    np.testing.assert_allclose(psi[-1, 0], tl.cw_state(det, F, root[0]), rtol=1e-7)
    biases = {}
    for dz in (0.02, 0.01):
        cfg_s = T.custom_simulation_config(z_max=40.0, dz=dz, save_every=int(round(40 / dz)))
        _, psi_s = tl.run_lle_simulation(cfg_s, co, np.full(16, 0.1 + 0j), device="cpu")
        biases[dz] = abs(abs(psi_s[-1, 0]) ** 2 - root[0])
    assert 2.5 < biases[0.02] / biases[0.01] < 5.5, biases
    det, F = 3.0, 1.9
    roots = tl.cw_steady_states(det, F)
    assert roots.size == 3
    co = tl.make_lle_coeffs(grid, detuning=det, pump=F, d2=-1.0)
    cfg = T.custom_simulation_config(z_max=60.0, dz=0.01, save_every=6000, integrator="rk4ip")
    _, lo = tl.run_lle_simulation(cfg, co, np.zeros(16, complex), device="cpu")
    np.testing.assert_allclose(abs(lo[-1, 0]) ** 2, roots[0], rtol=1e-6)
    _, hi = tl.run_lle_simulation(cfg, co, np.full(16, tl.cw_state(det, F, roots[2])),
                                  device="cpu")
    np.testing.assert_allclose(abs(hi[-1, 0]) ** 2, roots[2], rtol=1e-6)


def test_mi_threshold_and_growth_rate():
    """rho > 1: a seeded sideband grows at rho - 1; rho < 1: it decays."""
    om = TGRID.omega()

    def grow(det, F, which):
        roots = tl.cw_steady_states(det, F)
        rho = roots[-1 if which == "upper" else 0]
        psi_s = tl.cw_state(det, F, rho)
        rate, phi_star = tl.mi_gain_peak(det, rho)
        k_idx = int(np.argmin(np.abs(om - np.sqrt(max(2.0 * phi_star, 0.0)))))
        if k_idx == 0:
            k_idx = 256 // 8
        psi0 = psi_s * (1.0 + 1e-6 * np.cos(om[k_idx] * TGRID.t()))
        co = tl.make_lle_coeffs(TGRID, detuning=det, pump=F, d2=-1.0)
        cfg = T.custom_simulation_config(z_max=2.0, dz=0.005, save_every=40)
        t, psi = tl.run_lle_simulation(cfg, co, psi0, device="cpu")
        spec = np.abs(np.fft.fft(psi - psi[:, :1], axis=-1)) ** 2
        e = np.maximum(spec[:, k_idx] + spec[:, -k_idx % 256], 1e-300)
        sl = np.polyfit(t[len(t) // 2:], np.log(e[len(t) // 2:]), 1)[0] / 2.0
        return sl, rate, e

    sl, rate, _ = grow(2.5, 1.8, "upper")
    assert rate > 0.1
    np.testing.assert_allclose(sl, rate, rtol=0.1)
    _, rate2, e2 = grow(0.5, 0.5, "lower")
    assert rate2 < 0.0 and e2[-1] < 0.05 * e2[0]


def test_soliton_persistence_and_power_balance():
    det, F = 4.0, 2.0
    co = tl.make_lle_coeffs(TGRID, detuning=det, pump=F, d2=-1.0)
    cfg = T.custom_simulation_config(z_max=30.0, dz=0.005, save_every=6000)
    _, psi = tl.run_lle_simulation(cfg, co, tl.soliton_ansatz(TGRID, det, F, -1.0),
                                   device="cpu")
    pk = np.max(np.abs(psi[-1]) ** 2)
    assert abs(pk - 2 * det) / (2 * det) < 0.15
    assert pk > 10 * tl.cw_steady_states(det, F)[0]
    m = np.mean(np.abs(psi[-1]) ** 2)
    np.testing.assert_allclose(m, np.real(F * np.mean(np.conj(psi[-1]))), rtol=1e-4)
    spec = tl.comb_spectrum(psi[-1] - np.mean(psi[-1]))
    assert spec[1] > spec[4] > spec[12]


def test_normalization_round_trip():
    """The normalized cubic roots, mapped back to physical powers, satisfy
    the physical bistability relation (alpha^2 + (delta0 - gamma L P)^2) P
    = theta P_in."""
    rng = np.random.default_rng(2)
    for _ in range(20):
        L = float(rng.uniform(10.0, 200.0))
        g = float(rng.uniform(1e-3, 20e-3))
        b2 = float(rng.uniform(-30e-27, -1e-27))
        a = float(rng.uniform(0.05, 0.3))
        th = float(rng.uniform(0.02, 2 * a))
        d0 = float(rng.uniform(-0.2, 0.8))
        P_in = float(rng.uniform(0.01, 5.0))
        nm = tl.normalize_ring_cavity(
            round_trip_length_m=L, t_roundtrip_s=L / 2e8, gamma_W_m=g, beta2_s2_m=b2,
            alpha_half_loss=a, coupling_theta=th, detuning_phase_rad=d0, pump_power_W=P_in)
        assert nm.d2 == -1.0
        for rho in tl.cw_steady_states(nm.detuning, nm.pump):
            P = rho * nm.field_scale_sqrtW ** 2
            np.testing.assert_allclose((a ** 2 + (d0 - g * L * P) ** 2) * P, th * P_in,
                                       rtol=1e-10)
