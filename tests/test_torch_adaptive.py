"""The port's adaptive integrator, ``ops/adaptive.py``, against the JAX
package's ``ops/adaptive.py`` on the same seeded inputs, in float64.

Tolerances:

- one DP45 step and the error norm: 1e-13 relative (the same operations;
  ``|z|`` is ``sqrt(re^2 + im^2)`` here and ``hypot`` in JAX, an ulp apart);
  the error estimate, a difference of terms the size of the state, to
  1e-13 of the state's size;
- whole integrations at rtol 1e-9: equal ``ok`` flags, step counters equal
  on at least 90% of the lanes, states within 10 x rtol.  The two are not
  held bit for bit: the port integrates each segment in local z, the JAX
  scan in global z, so step sizes differ in their last bits and a step near
  the acceptance threshold can go either way.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops import adaptive as jad  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops import rhs as jrhs  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import adaptive as tad  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import rhs as trhs  # noqa: E402

torch.set_num_threads(1)

RHS = {"rotating": (trhs.rhs_yaman_autonomous, jrhs.rhs_yaman_autonomous),
       "lab": (trhs.rhs_yaman, jrhs.rhs_yaman)}


def _lanes(B=12, seed=0, bad=None):
    """Bench-like lanes with a spread of mismatch; lane ``bad`` blows up."""
    rng = np.random.default_rng(seed)
    A0 = np.broadcast_to(np.sqrt([0.5, 0.5, 1e-7, 1e-7]).astype(np.complex128), (B, 4)).copy()
    A0 *= np.exp(1j * rng.uniform(0, 2 * np.pi, (B, 4)))
    g = np.full(B, 0.0115)
    a = np.full(B, 1.15e-4)
    db = np.sort(rng.uniform(-0.6, 0.6, B))
    if bad is not None:
        A0[bad], g[bad] = [1e4, 1e4, 1.0, 0.0], 1e3
    return A0, g, a, db


def _coeffs(g, a, db):
    return (T.RHSCoeffs(*(torch.as_tensor(v) for v in (g, a, db))),
            J.RHSCoeffs(gamma=jnp.asarray(g), alpha=jnp.asarray(a), delta_beta=jnp.asarray(db)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.mark.parametrize("frame", ["rotating", "lab"])
def test_rk45_step_matches_jax(frame):
    rng = np.random.default_rng(1)
    A0, g, a, db = _lanes(16, seed=1)
    y = A0 * (1 + 0.3 * rng.normal(size=A0.shape))
    tc, jc = _coeffs(g, a, db)
    ft, fj = RHS[frame]
    for z, dz in ((0.0, 0.37), (12.5, 1.3e-3)):
        y5_t, err_t = tad.rk45_step(ft, z, torch.as_tensor(y), dz, tc)
        y5_j, err_j = jad.rk45_step(fj, z, jnp.asarray(y), dz, jc)
        assert _rel(y5_t.numpy(), y5_j) <= 1e-13
        # the estimate is a difference of O(|y|) terms: its rounding scales
        # with the state, not with its own size
        scale = np.abs(y).max(axis=1, keepdims=True)
        assert np.max(np.abs(err_t.numpy() - np.asarray(err_j)) / scale) <= 1e-13


def test_error_norm_matches_jax_with_dark_waves():
    rng = np.random.default_rng(2)
    B = 32
    y = rng.normal(size=(B, 4)) + 1j * rng.normal(size=(B, 4))
    y_new = y * (1 + 1e-7 * rng.normal(size=(B, 4)))
    err = 1e-9 * (rng.normal(size=(B, 4)) + 1j * rng.normal(size=(B, 4)))
    y[:4, 2:] = y_new[:4, 2:] = err[:4, 2:] = 0.0          # dark waves
    for atol in (1e-12, 0.0):
        nt = tad._error_norm(*(torch.as_tensor(v) for v in (err, y, y_new)),
                             atol=atol, rtol=1e-9, batch_ndim=1)
        nj = jax.vmap(lambda e, a, b: jad._error_norm(e, a, b, atol=atol, rtol=1e-9))(
            err, y, y_new)
        assert np.isfinite(nt.numpy()).all()
        assert _rel(nt.numpy(), nj) <= 1e-13


def _jax_batch(f, A0, jc, *, mode, z_grid, z_final=None, rtol, atol, max_steps=10_000):
    P0 = np.abs(A0) ** 2

    def one(y0, c):
        if mode == "grid":
            r = jad.integrate_adaptive_grid(f, y0, c, z_grid=z_grid, rtol=rtol, atol=atol,
                                            z_final=z_final, max_steps_per_segment=max_steps)
            return r.y_saved, r.ok, r.n_accepted, r.n_rejected
        r = jad.integrate_adaptive_reduce(
            f, y0, c, z_grid=z_grid, rtol=rtol, atol=atol, z_final=z_final,
            reduce_init=jnp.abs(y0) ** 2,
            reduce_fn=lambda acc, y: jnp.maximum(acc, jnp.abs(y) ** 2),
            max_steps_per_segment=max_steps)
        return r.reduction, r.ok, r.n_accepted, r.n_rejected

    del P0
    return [np.asarray(x) for x in jax.vmap(one)(jnp.asarray(A0), jc)]


def _torch_batch(f, A0, tc, *, mode, z_grid, z_final=None, rtol, atol, max_steps=10_000):
    y0 = torch.as_tensor(A0)
    if mode == "grid":
        r = tad.integrate_adaptive_grid(f, y0, tc, z_grid=z_grid, rtol=rtol, atol=atol,
                                        z_final=z_final, max_steps_per_segment=max_steps,
                                        batch_ndim=1)
        out = r.y_saved
    else:
        r = tad.integrate_adaptive_reduce(
            f, y0, tc, z_grid=z_grid, rtol=rtol, atol=atol, z_final=z_final,
            reduce_init=y0.abs() ** 2,
            reduce_fn=lambda acc, y: torch.maximum(acc, y.abs() ** 2),
            max_steps_per_segment=max_steps, batch_ndim=1)
        out = r.reduction
    return [x.numpy() for x in (out, r.ok, r.n_accepted, r.n_rejected)]


@pytest.mark.parametrize("mode", ["grid", "reduce"])
@pytest.mark.parametrize("frame", ["rotating", "lab"])
def test_integration_matches_jax(mode, frame):
    rtol = 1e-9
    A0, g, a, db = _lanes(12, seed=3)
    tc, jc = _coeffs(g, a, db)
    z_grid = np.arange(6) * 8.0
    kw = dict(mode=mode, z_grid=z_grid, rtol=rtol, atol=1e-12)
    out_t, ok_t, na_t, nr_t = _torch_batch(RHS[frame][0], A0, tc, **kw)
    out_j, ok_j, na_j, nr_j = _jax_batch(RHS[frame][1], A0, jc, **kw)
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_t.all() and (na_t > 0).all()
    assert np.mean((na_t == na_j) & (nr_t == nr_j)) >= 0.9
    assert _rel(out_t, out_j) <= 10 * rtol


def test_trailing_span_feeds_only_ok_and_counters():
    A0, g, a, db = _lanes(6, seed=4)
    tc, _ = _coeffs(g, a, db)
    f = trhs.rhs_yaman_autonomous
    kw = dict(mode="grid", z_grid=np.arange(4) * 5.0, rtol=1e-9, atol=1e-12)
    y_g, ok_g, na_g, _ = _torch_batch(f, A0, tc, **kw)
    y_t, ok_t, na_t, _ = _torch_batch(f, A0, tc, z_final=18.0, **kw)
    np.testing.assert_array_equal(y_t, y_g)
    assert ok_t.all() and ok_g.all() and (na_t > na_g).all()
    # a failure confined to the tail clears ok, the saved rows stay put:
    # lane 2's runaway gain needs more than max_steps attempts there
    A0b, gb, ab, dbb = _lanes(6, seed=4)
    ab = ab.copy()
    ab[2] = -4.0
    tcb, jcb = _coeffs(gb, ab, dbb)
    kwb = dict(mode="grid", z_grid=np.arange(2) * 0.5, rtol=1e-9, atol=1e-12, max_steps=300)
    _, ok_short, _, _ = _torch_batch(f, A0b, tcb, **kwb)
    y_b, ok_b, _, _ = _torch_batch(f, A0b, tcb, z_final=40.0, **kwb)
    _, ok_bj, _, _ = _jax_batch(jrhs.rhs_yaman_autonomous, A0b, jcb, z_final=40.0, **kwb)
    assert ok_short.all() and not ok_b[2] and ok_b[np.arange(6) != 2].all()
    np.testing.assert_array_equal(ok_b, ok_bj)
    assert np.isfinite(y_b).all()


def test_nan_lane_is_frozen_finite_and_flagged():
    A0, g, a, db = _lanes(8, seed=5, bad=3)
    tc, jc = _coeffs(g, a, db)
    kw = dict(mode="grid", z_grid=np.arange(3) * 2.0, rtol=1e-9, atol=1e-12)
    y_t, ok_t, na_t, nr_t = _torch_batch(trhs.rhs_yaman_autonomous, A0, tc, **kw)
    _, ok_j, _, _ = _jax_batch(jrhs.rhs_yaman_autonomous, A0, jc, **kw)
    assert not ok_t[3] and ok_t[np.arange(8) != 3].all()
    np.testing.assert_array_equal(ok_t, ok_j)
    assert np.isfinite(y_t).all() and nr_t[3] > 0


def test_max_steps_exhaustion_fails_the_lane():
    A0, g, a, db = _lanes(4, seed=6)
    tc, jc = _coeffs(g, a, db)
    kw = dict(mode="reduce", z_grid=np.array([0.0, 50.0]), rtol=1e-9, atol=1e-12,
              max_steps=3)
    _, ok_t, na_t, nr_t = _torch_batch(trhs.rhs_yaman_autonomous, A0, tc, **kw)
    _, ok_j, _, _ = _jax_batch(jrhs.rhs_yaman_autonomous, A0, jc, **kw)
    assert not ok_t.any() and not ok_j.any()
    np.testing.assert_array_equal(na_t + nr_t, 3)


def _single_kwargs(pkg):
    omega0 = 2 * np.pi * 299792458.0 / 1.55e-6
    return dict(
        gamma=10.0, alpha=0.05, omega=np.full(4, omega0), p_in=[0.1, 0.1, 1e-5, 0.0],
        phase_matching_cfg=pkg.PhaseMatchingConfig(
            method=pkg.PhaseMatchingMethod.PROVIDED, provided_delta_beta=0.8),
        length_unit="m",
    )


@pytest.mark.parametrize("frame", ["lab", "rotating"])
def test_run_adaptive_trajectory_matches_jax_and_resumes(frame):
    """run_single_simulation(integrator='rk45') against JAX, and a run split
    at a saved row equals the whole run (rtol 1e-11: both halves resume from
    a saved state)."""
    def mk(pkg, z):
        return pkg.custom_simulation_config(z_max=z, dz=0.01, save_every=10, integrator="rk45",
                                            rtol=1e-11, atol=1e-14)

    z_full, A_full = T.run_single_simulation(mk(T, 2.0), **_single_kwargs(T), frame=frame,
                                             device="cpu")
    z_j, A_j = J.run_single_simulation(mk(J, 2.0), **_single_kwargs(J), frame=frame)
    np.testing.assert_allclose(z_full, z_j, rtol=1e-15)
    assert _rel(A_full, A_j) <= 1e-9
    z1, A1 = T.run_single_simulation(mk(T, 1.0), **_single_kwargs(T), frame=frame, device="cpu")
    z2, A2 = T.run_single_simulation(mk(T, 1.0), **_single_kwargs(T), frame=frame, device="cpu",
                                     z0=float(z1[-1]), A_init=A1[-1])
    assert z2[0] == pytest.approx(1.0) and z2[-1] == pytest.approx(2.0)
    np.testing.assert_allclose(np.concatenate([A1, A2[1:]]), A_full, rtol=1e-8, atol=1e-13)


def test_run_adaptive_trajectory_edge_cases():
    kw = _single_kwargs(T)
    # save_every beyond the run: the saved grid is row 0, the ICs
    cfg = T.custom_simulation_config(z_max=0.05, dz=0.01, save_every=100, integrator="rk45")
    z, A = T.run_single_simulation(cfg, **kw, device="cpu")
    cfg4 = T.custom_simulation_config(z_max=0.05, dz=0.01, save_every=100)
    z4, A4 = T.run_single_simulation(cfg4, **kw, device="cpu")
    np.testing.assert_array_equal(z, z4)
    np.testing.assert_array_equal(A, A4)
    # atol=0 with dark idler and signal: 0/0 reads as 0
    cfg0 = T.custom_simulation_config(z_max=1.0, dz=0.01, integrator="rk45", rtol=1e-9, atol=0.0)
    z0, A0 = T.run_single_simulation(cfg0, **{**kw, "p_in": [0.2, 0.2, 0.0, 0.0]}, device="cpu")
    assert np.isfinite(A0).all()
    np.testing.assert_array_equal(np.abs(A0[:, 2:]), 0.0)
    # a run that blows up raises, as with the fixed-step integrators
    with pytest.raises(FloatingPointError, match="rk45"):
        T.run_single_simulation(
            T.custom_simulation_config(z_max=1.0, dz=0.1, integrator="rk45", max_steps=50),
            **{**kw, "gamma": 1e3, "p_in": [1e8, 1e8, 1.0, 0.0]}, device="cpu")
