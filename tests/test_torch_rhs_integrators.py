"""PyTorch port vs the JAX package: the 4-wave RHS, the frame rotation, the
analytic oracles and the fixed-step integrators.

Inputs are drawn from a seeded numpy generator and handed to both packages
as float64/complex128.  Tolerances:

- RHS terms, rotation, oracles: rtol 1e-14 -- the same IEEE float64
  operations, up to one rounding of summation order;
- integration (rk4/ab4/abm4, up to 60 steps): rtol 1e-12 -- per-step
  rounding differences of ~1e-16 accumulate over the steps.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops import analytic as janalytic  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops import integrators as jint  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops import rhs as jrhs  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import analytic as tanalytic  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import rhs as trhs  # noqa: E402

torch.set_num_threads(1)

RHS_RTOL = 1e-14
INT_RTOL = 1e-12


def _state(B=6, seed=0, scale=0.4):
    rng = np.random.default_rng(seed)
    y = scale * (rng.normal(size=(B, 4)) + 1j * rng.normal(size=(B, 4)))
    g = rng.uniform(0.005, 0.02, B)
    a = rng.uniform(0.0, 2e-4, B)
    db = rng.uniform(-0.5, 0.5, B)
    return y, g, a, db


def _coeffs(pkg, g, a, db):
    if pkg is T:
        return T.RHSCoeffs(*(torch.as_tensor(v) for v in (g, a, db)))
    return J.RHSCoeffs(gamma=g, alpha=a, delta_beta=db)


def _close(actual, desired, rtol):
    actual = actual.numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    desired = np.asarray(desired)
    np.testing.assert_allclose(actual, desired, rtol=rtol, atol=rtol * np.abs(desired).max())


@pytest.mark.parametrize("name", ["rhs_yaman", "rhs_yaman_autonomous"])
def test_rhs_matches_jax(name):
    y, g, a, db = _state()
    z = 123.4
    out_t = getattr(trhs, name)(z, torch.as_tensor(y), _coeffs(T, g, a, db))
    out_j = getattr(jrhs, name)(z, y, _coeffs(J, g, a, db))
    assert out_t.dtype == torch.complex128 and out_t.shape == (6, 4)
    _close(out_t, out_j, RHS_RTOL)


def test_rhs_scalar_coeffs_and_custom_kerr_match_jax():
    y, g, a, db = _state(B=1, seed=1)
    y = y[0]
    for frame in ("lab", "rotating"):
        f_t = T.make_rhs_yaman(frame=frame, kerr_self=2 / 3, kerr_cross=4 / 3)
        f_j = J.make_rhs_yaman(frame=frame, kerr_self=2 / 3, kerr_cross=4 / 3)
        _close(f_t(7.0, torch.as_tensor(y), T.RHSCoeffs(g[0], a[0], db[0])),
               f_j(7.0, y, J.RHSCoeffs(gamma=g[0], alpha=a[0], delta_beta=db[0])), RHS_RTOL)
    _close(T.kerr_factors(torch.as_tensor(y)), J.kerr_factors(y), RHS_RTOL)
    with pytest.raises(ValueError):
        T.make_rhs_yaman(frame="moving")


def test_rhs_x32_dtype():
    y, g, a, db = _state()
    out = T.rhs_yaman_autonomous(0.0, torch.as_tensor(y, dtype=torch.complex64),
                                 T.RHSCoeffs(*(torch.as_tensor(v, dtype=torch.float32)
                                               for v in (g, a, db))))
    assert out.dtype == torch.complex64
    ref = J.rhs_yaman_autonomous(0.0, y, J.RHSCoeffs(gamma=g, alpha=a, delta_beta=db))
    _close(out, ref, 1e-5)


def test_rotating_to_lab_matches_jax():
    y, g, a, db = _state()
    z = np.linspace(0.0, 500.0, 6)
    # batch of states at per-row z, and one trajectory of a single instance
    _close(T.rotating_to_lab(torch.as_tensor(z), torch.as_tensor(y), _coeffs(T, g, a, db)),
           J.rotating_to_lab(z, y, _coeffs(J, g, a, db)), RHS_RTOL)
    _close(T.rotating_to_lab(torch.as_tensor(z), torch.as_tensor(y), T.RHSCoeffs(g[0], a[0], db[0])),
           J.rotating_to_lab(z, y, J.RHSCoeffs(gamma=g[0], alpha=a[0], delta_beta=db[0])),
           RHS_RTOL)


def test_analytic_oracles_match_jax():
    z = np.linspace(0.0, 800.0, 9)
    for db in (-0.02, -0.0115, 0.0, 0.3):
        _close(tanalytic.pia_signal_gain(z, 0.0115, 0.5, 0.5, db),
               janalytic.pia_signal_gain(z, 0.0115, 0.5, 0.5, db), RHS_RTOL)
    for got, want in zip(tanalytic.psa_gain_extrema(z, 0.0115, 0.3, 0.5),
                         janalytic.psa_gain_extrema(z, 0.0115, 0.3, 0.5)):
        _close(got, want, RHS_RTOL)


# ---------------------------------------------------------------------------
# integrators
# ---------------------------------------------------------------------------

def _fold_t(acc, y):
    pmax, _ = acc
    return torch.maximum(pmax, y.real ** 2 + y.imag ** 2), y


def _fold_j(acc, y):
    pmax, _ = acc
    return jax.numpy.maximum(pmax, y.real ** 2 + y.imag ** 2), y


def _jax_reduce(y0, g, a, db, *, n_steps, save_every, method, dz):
    def one(y, gi, ai, di):
        res = jint.integrate_reduce(
            jrhs.rhs_yaman, y, jrhs.RHSCoeffs(gamma=gi, alpha=ai, delta_beta=di),
            z0=0.0, dz=dz, n_steps=n_steps, save_every=save_every,
            reduce_init=(jax.numpy.abs(y) ** 2, y), reduce_fn=_fold_j, method=method,
        )
        return res.reduction, res.y_final, res.ok, res.bad_step

    return jax.jit(jax.vmap(one))(y0, g, a, db)


@pytest.mark.parametrize("method", ["rk4", "ab4", "abm4"])
@pytest.mark.parametrize("n_steps", [60, 57, 7], ids=["exact", "remainder", "short"])
def test_integrate_reduce_matches_jax(method, n_steps):
    """Lab-frame batched reduce with a NaN lane (lane 0 blows up within a
    few steps), a remainder of n_steps % save_every steps, and a run
    shorter than one save interval."""
    y, g, a, db = _state(B=5, seed=2)
    y[0] = [1e4, 1e4, 1.0, 0.0]
    g[0] = 1e3
    dz, save_every = 2.0, 10
    rt = T.integrate_reduce(
        T.rhs_yaman, torch.as_tensor(y), _coeffs(T, g, a, db), z0=0.0, dz=dz,
        n_steps=n_steps, save_every=save_every,
        reduce_init=(torch.as_tensor(np.abs(y) ** 2), torch.as_tensor(y)),
        reduce_fn=_fold_t, method=method, batch_ndim=1,
    )
    (pmax_j, last_j), yf_j, ok_j, bad_j = _jax_reduce(
        y, g, a, db, n_steps=n_steps, save_every=save_every, method=method, dz=dz)
    pmax_t, last_t = rt.reduction
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(rt.bad_step.numpy(), np.asarray(bad_j))
    assert not bool(rt.ok[0]) and bool(rt.ok[1:].all())
    assert torch.isfinite(rt.y_final).all() and torch.isfinite(pmax_t).all()
    for got, want in ((pmax_t, pmax_j), (last_t, last_j), (rt.y_final, yf_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=INT_RTOL, atol=0)


@pytest.mark.parametrize("method", ["rk4", "abm4"])
def test_integrate_fixed_grid_matches_jax(method):
    y, g, a, db = _state(B=1, seed=3)
    kw = dict(z0=5.0, dz=0.5, n_steps=43, save_every=4, method=method)
    rt = T.integrate_fixed_grid(T.rhs_yaman, torch.as_tensor(y[0]),
                                T.RHSCoeffs(g[0], a[0], db[0]), **kw)
    rj = J.integrate_fixed_grid(J.rhs_yaman, y[0],
                                J.RHSCoeffs(gamma=g[0], alpha=a[0], delta_beta=db[0]), **kw)
    assert rt.y_saved.shape == (11, 4)
    np.testing.assert_array_equal(rt.z_saved.numpy(), np.asarray(rj.z_saved))
    np.testing.assert_allclose(rt.y_saved.numpy(), np.asarray(rj.y_saved), rtol=INT_RTOL)
    np.testing.assert_allclose(rt.y_final.numpy(), np.asarray(rj.y_final), rtol=INT_RTOL)
    assert bool(rt.ok) and int(rt.bad_step) == -1


def test_integrate_interval_and_errors_match_jax():
    y, g, a, db = _state(B=1, seed=4)
    c_t, c_j = T.RHSCoeffs(g[0], a[0], db[0]), J.RHSCoeffs(gamma=g[0], alpha=a[0], delta_beta=db[0])
    z_t, y_t = T.integrate_interval(T.rhs_yaman, 10.0, 0.25, torch.as_tensor(y[0]), c_t,
                                    save_every=8)
    z_j, y_j = J.integrate_interval(J.rhs_yaman, 10.0, 0.25, y[0], c_j, save_every=8)
    np.testing.assert_array_equal(z_t, z_j)
    np.testing.assert_allclose(y_t, y_j, rtol=INT_RTOL)
    blow = np.array([1e4, 1e4, 1.0, 0.0], dtype=complex)
    for pkg, yb in ((T, torch.as_tensor(blow)), (J, blow)):
        with pytest.raises(FloatingPointError):
            pkg.integrate_interval(pkg.rhs_yaman, 10.0, 0.5, yb, _coeffs(pkg, 1e3, 0.0, 0.0))
    with pytest.raises(ValueError, match="method"):
        T.integrate_reduce(T.rhs_yaman, torch.as_tensor(y[0]), c_t, z0=0.0, dz=0.1, n_steps=3,
                           reduce_fn=_fold_t, method="rk45")


def test_rk4_tracks_pia_oracle():
    """Physics check of the port alone: an undepleted-pump PIA run follows
    the closed-form gain (weak signal, strong lossless pumps)."""
    p, g, L = 0.5, 0.0115, 400.0
    dbeta = -0.6 * g * p
    y0 = torch.as_tensor(np.sqrt([p, p, 1e-9, 0.0]).astype(complex))
    r = T.integrate_fixed_grid(T.rhs_yaman, y0, T.RHSCoeffs(g, 0.0, dbeta), z0=0.0, dz=0.5,
                               n_steps=int(L / 0.5), save_every=100)
    gain = (r.y_saved[:, 2].abs() ** 2 / 1e-9).numpy()
    want = tanalytic.pia_signal_gain(r.z_saved, g, p, p, dbeta).numpy()
    np.testing.assert_allclose(gain, want, rtol=1e-3)
