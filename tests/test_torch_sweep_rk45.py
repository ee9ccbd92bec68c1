"""The adaptive (rk45) tier of the port's sweeps and runner, against the JAX
package (mirrors ``tests/test_sweep_rk45.py``).

On the CPU the port runs the plain versions: ``ops/cuda_adaptive.
solve_batch_rk45_torch`` for the rotating frame, ``ops/adaptive.py`` for the
lab frame and the trajectories.  The CUDA kernel is held against the plain
version on the card (``tests/test_torch_kernel.py``, ``chip_smoke.py``).

Tolerances:

- port vs the JAX scan, both rk45 in float64 at rtol 1e-10: 1e-7 in gain,
  the JAX file's rk45-vs-rk4 bar (the two take steps that differ in their
  last bits: local vs global z);
- rk45 vs rk4 within the port: the JAX file's bars (1e-7 in dB; 5e-6 for
  the mismatch scan, where rk4's own truncation error sets the bar);
- the plain float32 version vs the JAX K3 kernel in interpret mode: 5e-4
  in ``P_max`` against each other and against an x64 truth (the bar of
  ``tests/test_sweep_rk45.py:214-234``), at ``save_every=10``, where the
  two engines' first-step rules agree;
- where the port computes the same saved summaries twice (a trailing span,
  ``df32`` vs ``x64``), equality.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops import pallas_adaptive as jpa  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.parallel import sweep as jsw  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_adaptive as ca  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import rhs as trhs  # noqa: E402

torch.set_num_threads(1)

GOLDEN_DIR = Path(__file__).parent / "golden"


def _rk45(cfg, rtol=1e-10, atol=1e-13):
    return dataclasses.replace(cfg, integrator="rk45", rtol=rtol, atol=atol)


def _spectrum(pkg, n=6, z_max=100.0, frame="rotating"):
    """The kwargs of tests/test_sweep.py::_spectrum_inputs, shortened."""
    g = np.load(GOLDEN_DIR / "golden_spectrum.npz")
    disp = pkg.dispersion_params_from_D_S(
        lambda_ref_m=float(g["lambda_c"]), D=float(g["D"]), S=float(g["S"]), dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
        omega_ref=float(g["omega_c"]), compat_reference_beta4_bug=True,
    )
    return dict(
        cfg=pkg.custom_simulation_config(z_max=z_max, dz=0.2),
        lambda_p1_m=float(g["lam1"]), lambda_p2_m=float(g["lam2"]),
        lambda_signal_m=np.asarray(g["lam3"])[:n], gamma=float(g["gamma"]),
        alpha=float(g["alpha"]), p_in=np.asarray(g["p_in"]), phase_in=np.zeros(4),
        dispersion=disp,
        phase_matching_cfg=pkg.PhaseMatchingConfig(
            method=pkg.PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4),
        length_unit="m", gain_unit="dB", frame=frame,
    )


def _lin(db):
    return 10.0 ** (np.asarray(db) / 10.0)


@pytest.mark.parametrize("frame", ["rotating", "lab"])
def test_gain_spectrum_rk45_matches_jax_and_rk4(frame):
    kt, kj = _spectrum(T, frame=frame), _spectrum(J, frame=frame)
    kt["cfg"], kj["cfg"] = _rk45(kt["cfg"]), _rk45(kj["cfg"])
    rt = T.gain_and_dbeta_spectrum(**kt, device="cpu")
    rj = J.gain_and_dbeta_spectrum(**kj, engine="scan")
    np.testing.assert_array_equal(rt.ok, rj.ok)
    assert rt.ok.all()
    np.testing.assert_allclose(_lin(rt.gain), _lin(rj.gain), rtol=1e-7)
    np.testing.assert_allclose(rt.dbeta, rj.dbeta, rtol=1e-12)
    r4 = T.gain_and_dbeta_spectrum(**_spectrum(T, frame=frame), device="cpu")
    np.testing.assert_allclose(rt.gain, r4.gain, rtol=1e-7, atol=1e-7)


def test_mismatch_scan_rk45_matches_jax_and_rk4():
    common = dict(gamma=10.0, alpha=0.0, p_in=[0.5, 0.5, 1e-4, 0.0],
                  delta_beta_values=np.linspace(-30.0, 10.0, 9), gain_mode="end",
                  gain_unit="linear", length_unit="km")
    cfg_t = T.custom_simulation_config(z_max=0.5, dz=1e-3, save_every=10)
    cfg_j = J.custom_simulation_config(z_max=0.5, dz=1e-3, save_every=10)
    s45, i45 = T.mismatch_scan(cfg=_rk45(cfg_t), **common, device="cpu")
    s45j, i45j = J.mismatch_scan(cfg=_rk45(cfg_j), **common, engine="scan")
    np.testing.assert_allclose(s45.gain, s45j.gain, rtol=1e-7)
    np.testing.assert_allclose(i45.gain, i45j.gain, rtol=1e-7)
    s4, i4 = T.mismatch_scan(cfg=cfg_t, **common, device="cpu")
    np.testing.assert_allclose(s45.gain, s4.gain, rtol=5e-6)
    np.testing.assert_allclose(i45.gain, i4.gain, rtol=5e-6)


def test_psa_phase_sweep_rk45_matches_jax_and_rk4():
    common = dict(gamma=10.0, alpha=0.0, p_in=[0.3, 0.3, 1e-3, 1e-3],
                  signal_phases=np.linspace(0.0, 2 * np.pi, 13), delta_beta=0.0,
                  gain_unit="dB", length_unit="km")
    cfg_t = T.custom_simulation_config(z_max=0.2, dz=1e-3)
    r45 = T.psa_phase_sweep(cfg=_rk45(cfg_t), **common, device="cpu")
    r45j = J.psa_phase_sweep(cfg=_rk45(J.custom_simulation_config(z_max=0.2, dz=1e-3)),
                             **common, engine="scan")
    np.testing.assert_allclose(_lin(r45.gain), _lin(r45j.gain), rtol=1e-7)
    r4 = T.psa_phase_sweep(cfg=cfg_t, **common, device="cpu")
    np.testing.assert_allclose(r45.gain, r4.gain, rtol=1e-6, atol=1e-6)


def test_solve_batch_trajectories_rk45_matches_jax_and_rk4():
    B = 5
    rng = np.random.default_rng(7)
    coeffs = dict(gamma=np.full(B, 0.01), alpha=np.full(B, 1e-4),
                  delta_beta=rng.uniform(-0.5, 0.5, B))
    A0 = (np.sqrt([0.3, 0.3, 1e-5, 0.0])[None, :] * np.ones((B, 1))).astype(np.complex128)
    cfg_t = T.custom_simulation_config(z_max=50.0, dz=0.1, save_every=50)
    cfg_j = J.custom_simulation_config(z_max=50.0, dz=0.1, save_every=50)
    z, A, ok = T.solve_batch_trajectories(_rk45(cfg_t), T.RHSCoeffs(**coeffs), A0, frame="lab",
                                          device="cpu")
    zj, Aj, okj = J.solve_batch_trajectories(_rk45(cfg_j), J.RHSCoeffs(**coeffs), A0,
                                             frame="lab")
    np.testing.assert_array_equal(z, zj)
    assert ok.all() and okj.all() and A.shape == (B, 11, 4)
    np.testing.assert_allclose(A, Aj, rtol=1e-8, atol=1e-12)
    z4, A4, _ = T.solve_batch_trajectories(cfg_t, T.RHSCoeffs(**coeffs), A0, frame="lab",
                                           device="cpu")
    np.testing.assert_allclose(z, z4, rtol=0, atol=1e-12)
    np.testing.assert_allclose(A, A4, rtol=1e-7, atol=1e-9)


def test_rk45_save_every_exceeding_steps_returns_the_initial_values():
    cfg = T.custom_simulation_config(z_max=1.0, dz=0.1, save_every=20)
    B = 5
    A0 = (np.sqrt([0.5, 0.5, 1e-4, 0.0])[None, :] * np.ones((B, 1))).astype(np.complex128)
    coeffs = T.RHSCoeffs(np.full(B, 10.0), np.zeros(B), np.linspace(-5.0, 5.0, B))
    r4 = T.solve_batch(cfg, coeffs, A0, device="cpu")
    r45 = T.solve_batch(_rk45(cfg), coeffs, A0, device="cpu")
    P0 = np.abs(A0) ** 2
    for r in (r4, r45):
        np.testing.assert_array_equal(r.P_max, P0)
        np.testing.assert_array_equal(r.A_end, A0)
    # rk4 at dz=0.1 overflows in two lanes' unsaved steps; rk45 adapts
    assert r45.ok.all()
    z4, A4t, _ = T.solve_batch_trajectories(cfg, coeffs, A0, device="cpu")
    z45, A45t, ok45 = T.solve_batch_trajectories(_rk45(cfg), coeffs, A0, device="cpu")
    np.testing.assert_array_equal(z4, [0.0])
    np.testing.assert_array_equal(z45, [0.0])
    np.testing.assert_array_equal(A45t, A4t)
    assert ok45.all()


def _adaptive_inputs(B=8):
    gamma = np.full(B, 11.5e-3)
    alpha = np.full(B, 1.15e-4)
    dbeta = np.linspace(-0.5, 0.5, B)
    A0 = np.tile(np.sqrt(np.array([0.5, 0.5, 1e-7, 1e-7])) + 0j, (B, 1))
    return gamma, alpha, dbeta, A0


def test_rk45_trailing_partial_steps():
    """The trailing n_steps % save_every span is integrated but unsaved:
    the saved summaries equal a run that ends on the grid, and a failure
    confined to the tail still clears ok."""
    gamma, alpha, dbeta, A0 = _adaptive_inputs(8)
    co = T.RHSCoeffs(gamma, alpha, dbeta)

    def mk(n):
        return T.custom_simulation_config(z_max=float(n), dz=1.0, save_every=40,
                                          integrator="rk45", rtol=1e-9, atol=1e-12)

    r_grid = T.solve_batch(mk(80), co, A0, device="cpu")
    r_tail = T.solve_batch(mk(100), co, A0, device="cpu")
    np.testing.assert_array_equal(r_tail.P_max, r_grid.P_max)
    np.testing.assert_array_equal(r_tail.A_end, r_grid.A_end)
    assert r_tail.ok.all()
    alpha2 = alpha.copy()
    alpha2[2] = -2.0                      # runaway gain, lane 2
    cfg_short = dataclasses.replace(mk(45), max_steps=400)
    rb = T.solve_batch(cfg_short, T.RHSCoeffs(gamma, alpha2, dbeta), A0, device="cpu")
    assert not rb.ok[2] and rb.ok[np.arange(8) != 2].all()
    assert np.isfinite(rb.P_max).all()


def test_rk45_df32_runs_float64():
    """df32 + rk45 runs the float64 path (the port has no two-float engine):
    the same numbers as x64."""
    kw = _spectrum(T, n=4, z_max=40.0)
    kw["cfg"] = _rk45(kw["cfg"])
    x64 = T.gain_spectrum(**kw, device="cpu")
    kw["cfg"] = dataclasses.replace(kw["cfg"], precision="df32")
    df32 = T.gain_spectrum(**kw, device="cpu")
    np.testing.assert_array_equal(df32.gain, x64.gain)


def test_rk45_rejects_pallas_engine():
    kw = _spectrum(T, n=2, z_max=10.0)
    kw["cfg"] = _rk45(kw["cfg"])
    with pytest.raises(ValueError, match="pallas"):
        T.gain_spectrum(**kw, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        T.gain_spectrum(**kw, engine="cuda", device="cpu")


def test_kernel_order_rhs_matches_the_rotating_frame_rhs():
    """``rhs_yaman_autonomous``, written in the kernels' real arithmetic,
    against the model's complex formula in numpy, per lane, to 1e-14."""
    rng = np.random.default_rng(9)
    B = 16
    y = rng.normal(size=(B, 4)) + 1j * rng.normal(size=(B, 4))
    g, a, db = (rng.uniform(lo, hi, (B, 1)) for lo, hi in
                ((0.0, 0.1), (0.0, 0.01), (-2.0, 2.0)))
    P = np.abs(y) ** 2
    partner = np.conj(y[:, [1, 0, 3, 2]])
    s = np.stack([y[:, 2] * y[:, 3]] * 2 + [y[:, 0] * y[:, 1]] * 2, axis=1)
    pumps = np.array([1.0, 1.0, 0.0, 0.0])
    want = (-0.5 * a * y + 1j * g * ((2 * P.sum(1, keepdims=True) - P) * y + 2 * partner * s)
            - 0.5j * db * pumps * y)
    got = trhs.rhs_yaman_autonomous(
        0.0, torch.as_tensor(y), T.RHSCoeffs(*(torch.as_tensor(v[:, 0]) for v in (g, a, db))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-15)


def test_plain_rk45_matches_jax_scan_and_counts_steps():
    gamma, alpha, dbeta, A0 = _adaptive_inputs(8)
    kw = dict(dz_m=1.0, n_steps=200, save_every=50, rtol=1e-9, atol=1e-12)
    t = (torch.as_tensor(A0), *(torch.as_tensor(v) for v in (gamma, alpha, dbeta)))
    r = ca.solve_batch_rk45_torch(*t, **kw)
    cfg = J.custom_simulation_config(z_max=200.0, dz=1.0, save_every=50, integrator="rk45",
                                     rtol=1e-9, atol=1e-12)
    rj = jsw.solve_batch(cfg, J.RHSCoeffs(gamma=gamma, alpha=alpha, delta_beta=dbeta), A0,
                         engine="scan")
    np.testing.assert_array_equal(r.ok.numpy(), rj.ok)
    np.testing.assert_allclose(r.P_max.numpy(), rj.P_max, rtol=1e-8)
    np.testing.assert_allclose(r.A_end.numpy(), rj.A_end, rtol=1e-8, atol=1e-15)
    assert (r.n_accepted.numpy() > 0).all() and r.n_accepted.dtype == torch.int32


def test_plain_fp32_rk45_matches_jax_kernel_interpret():
    """The plain float32 version against the JAX K3 kernel in interpret mode
    and against an x64 truth, at save_every=10 (both start from dt0 = dz)."""
    gamma, alpha, dbeta, A0 = _adaptive_inputs(16)
    kw = dict(dz_m=1.0, n_steps=200, save_every=10, rtol=1e-6, atol=1e-10)
    t32 = (torch.as_tensor(A0, dtype=torch.complex64),
           *(torch.as_tensor(v, dtype=torch.float32) for v in (gamma, alpha, dbeta)))
    r = ca.solve_batch_rk45_torch(*t32, **kw)
    rp = jpa.solve_batch_rk45_pallas(A0, gamma, alpha, dbeta, interpret=True, **kw)
    t64 = (torch.as_tensor(A0), *(torch.as_tensor(v) for v in (gamma, alpha, dbeta)))
    truth = ca.solve_batch_rk45_torch(*t64, **{**kw, "rtol": 1e-11, "atol": 1e-14})
    P, Pp, Pt = r.P_max.double().numpy(), rp.P_max, truth.P_max.numpy()
    assert r.ok.numpy().all() and rp.ok.all()
    assert np.max(np.abs(P / Pp - 1)) < 5e-4
    assert np.max(np.abs(P / Pt - 1)) < 5e-4
    np.testing.assert_allclose(r.A_end.numpy(), rp.A_end, rtol=5e-3, atol=1e-7)
