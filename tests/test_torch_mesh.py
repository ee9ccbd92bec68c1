"""The port's multi-device layer, ``parallel/mesh.py``, on the CPU: the mesh
unit tests of ``tests/test_multihost.py`` on the port, ``pad_batch`` against
the JAX package's, and every family's sharded batch solve.

Each family's sharded call runs over 4 CPU slots of one process (a slot may
repeat a device; the shards then run one after the other) at a batch that
is not a multiple of 4, so the edge-row padding is exercised and trimmed.
It is held

- to the port's unsharded call at the JAX mesh tests' bars (sweep, comb
  and trajectories rtol 1e-12; GNLSE and vector peak rtol 1e-11 and state
  atol 1e-11; LLE rtol 1e-12, rk45 1e-9; SBS rtol 1e-12 / atol 1e-14 with
  the iteration counts and ``ok`` equal; the Monte Carlo field by field
  within 1e-12), with ``ok`` equal;
- to the JAX package's sharded call on the 8-device virtual CPU mesh of the
  repo-root ``conftest.py``, at the family's x64 class (the bars of the
  port's per-family tests): fixed step 1e-12 (normwise where the state has
  weak samples), rk45 1e-7 in linear gain on the 4-wave sweep, 1e-8 on its
  trajectories, 1e-10 normwise on the SSFM families.
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
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import nwave as jn  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import sbs as jsbs  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import vgnlse as jv  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.parallel import mesh as JM  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import gnlse as tg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import lle as tl  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import nwave as tn  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import sbs as tsbs  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import vgnlse as tv  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import mesh as TM  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import noise as TN  # noqa: E402

torch.set_num_threads(1)

T0 = 1e-12
BETA2 = -2.0e-26
OMEGA_REF = 1.2e15
GAMMA = 2e-3


def _mesh(n=4):
    """``n`` CPU slots of this process."""
    return TM.default_mesh(n, device="cpu")


def _jmesh():
    """The JAX package's mesh over the 8 virtual CPU devices."""
    mesh = JM.default_mesh()
    assert mesh is not None and int(np.prod(list(mesh.shape.values()))) == 8
    return mesh


def _normwise(a, b):
    """Worst over instances of max |a - b| / max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    ax = tuple(range(1, a.ndim))
    return float(np.max(np.max(np.abs(a - b), axis=ax) / np.max(np.abs(b), axis=ax)))


# ---------------------------------------------------------------------------
# The mesh itself (tests/test_multihost.py:56-103 on the port)
# ---------------------------------------------------------------------------

def test_initialize_distributed_noop_single_process(monkeypatch):
    """Without a coordinator configured it is a safe no-op."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert TM.initialize_distributed() is False
    assert TM.initialize_distributed(auto_detect=False) is False
    assert not torch.distributed.is_initialized()


def test_multihost_mesh_single_process_fallback():
    mesh = TM.multihost_mesh(device=["cpu"] * 4)
    # single process: the plain 1-D local mesh over this process's slots
    assert mesh is not None and tuple(mesh.axis_names) == ("batch",)
    assert int(np.prod(list(mesh.shape.values()))) == 4 and not mesh.spans_processes
    assert TM.multihost_mesh(device="cpu") is None


def test_put_and_fetch_global_single_process_roundtrip():
    mesh = _mesh()
    sh = TM.batch_sharding(mesh)
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    arr = TM.put_global(x, sh)
    assert arr.sharding.is_fully_addressable and arr.shape == (16, 2)
    assert [tuple(s.shape) for s in arr.shards] == [(4, 2)] * 4
    np.testing.assert_array_equal(TM.fetch_global(arr), x)
    tree = TM.put_global_tree({"a": x, "b": (x[:8], None)}, sh)
    np.testing.assert_array_equal(TM.fetch_global(tree["b"][0]), x[:8])
    assert tree["b"][1] is None
    rep = TM.put_global(x, TM.replicated_sharding(mesh))
    assert [tuple(s.shape) for s in rep.shards] == [(16, 2)] * 4
    np.testing.assert_array_equal(TM.fetch_global(rep), x)
    with pytest.raises(ValueError, match="pad it first"):
        TM.put_global(x[:13], sh)


def test_batch_sharding_honors_axis_name():
    mesh = TM.Mesh([["cpu"] * 4] * 2, ("dcn", "batch"))
    assert dict(mesh.shape) == {"dcn": 2, "batch": 4}
    assert TM.batch_sharding(mesh).spec == ("dcn", "batch")
    assert TM.batch_sharding(mesh, axis_name="batch").spec == ("batch",)
    assert TM.batch_sharding(mesh, axis_name=("dcn",)).spec == ("dcn",)
    with pytest.raises(ValueError, match="not in mesh axes"):
        TM.batch_sharding(mesh, axis_name="nope")
    # split over 'batch' only: replicated along 'dcn', each block fetched once
    x = np.arange(8.0)
    arr = TM.put_global(x, TM.batch_sharding(mesh, axis_name="batch"))
    assert [s.tolist() for s in arr.shards] == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0],
                                                [6.0, 7.0]] * 2
    np.testing.assert_array_equal(TM.fetch_global(arr), x)
    arr = TM.put_global(x, TM.batch_sharding(mesh))
    assert [s.tolist() for s in arr.shards] == [[float(i)] for i in range(8)]


def test_mesh_checks_and_device_agreement(monkeypatch):
    with pytest.raises(ValueError, match="axis_types"):
        TM.Mesh(["cpu"], ("batch",), axis_types=("explicit",))
    with pytest.raises(ValueError, match="do not fit"):
        TM.Mesh(["cpu", "cpu"], ("dcn", "batch"))
    assert TM.default_mesh(device="cpu") is None and TM.default_mesh(1, device="cpu") is None
    mesh = TM.default_mesh(3, device="cpu")
    assert dict(mesh.shape) == {"batch": 3} and mesh.size == 3
    with pytest.raises(TypeError, match="mesh must be"):
        TM.mesh_device(object(), None)
    with pytest.raises(ValueError, match="disagrees"):
        TM.mesh_device(mesh, "cuda")
    assert TM.mesh_device(mesh, "cpu") == TM.mesh_device(mesh, None) == torch.device("cpu")
    # no card: a CUDA slot raises, and so does a mesh of the process's cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        TM.Mesh(["cuda:0", "cuda:0"], ("batch",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.default_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.multihost_mesh()


@pytest.mark.parametrize("shape, multiple", [
    ((10,), 8), ((8,), 8), ((13, 4), 4), ((5, 2, 3), 3), ((3,), 1), ((7,), 0),
])
def test_pad_batch_matches_jax(shape, multiple):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    pt, nt = TM.pad_batch(a, multiple)
    pj, nj = JM.pad_batch(a, multiple)
    assert nt == nj == shape[0] and pt.dtype == pj.dtype
    np.testing.assert_array_equal(pt, pj)


# ---------------------------------------------------------------------------
# The 4-wave sweeps (K1/K2, K3 on the card)
# ---------------------------------------------------------------------------

def _spectrum_kwargs(pkg, integrator):
    disp = pkg.dispersion_params_from_D_S(
        lambda_ref_m=1552e-9, D=0.1, S=0.02, dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km")
    cfg = pkg.custom_simulation_config(z_max=10.0, dz=0.2, save_every=5, integrator=integrator,
                                       rtol=1e-10, atol=1e-13)
    return dict(cfg=cfg, lambda_p1_m=1550e-9, lambda_p2_m=1555e-9,
                lambda_signal_m=np.linspace(1549e-9, 1561e-9, 13), gamma=0.0115,
                alpha=1.15e-4, p_in=[0.5, 0.5, 1e-7, 1e-7], dispersion=disp, length_unit="m",
                gain_unit="linear")


@pytest.mark.parametrize("integrator, jax_bar", [("rk4", 1e-12), ("rk45", 1e-7)])
def test_gain_spectrum_sharded(integrator, jax_bar):
    kw = _spectrum_kwargs(T, integrator)
    plain = T.gain_spectrum(device="cpu", **kw)
    sharded = T.gain_spectrum(mesh=_mesh(), **kw)
    assert sharded.ok.all() and sharded.gain.shape == (13,)
    np.testing.assert_array_equal(sharded.ok, plain.ok)
    np.testing.assert_allclose(sharded.gain, plain.gain, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(sharded.x, plain.x)
    rj = J.gain_spectrum(mesh=_jmesh(), **_spectrum_kwargs(J, integrator))
    np.testing.assert_array_equal(sharded.ok, rj.ok)
    np.testing.assert_allclose(sharded.gain, rj.gain, rtol=jax_bar)


@pytest.mark.parametrize("frame, integrator, jax_bar", [
    ("lab", "rk4", 1e-12), ("rotating", "rk45", 1e-8),
])
def test_solve_batch_trajectories_sharded(frame, integrator, jax_bar):
    B = 11
    rng = np.random.default_rng(4)
    co = dict(gamma=np.full(B, 0.01), alpha=np.full(B, 1e-4),
              delta_beta=rng.uniform(-0.5, 0.5, B))
    A0 = (np.sqrt([0.3, 0.3, 1e-5, 0.0])[None, :] * np.ones((B, 1))).astype(np.complex128)
    ckw = dict(z_max=20.0, dz=0.1, save_every=20, integrator=integrator, rtol=1e-10,
               atol=1e-13)
    cfg = T.custom_simulation_config(**ckw)
    z1, A1, ok1 = T.solve_batch_trajectories(cfg, T.RHSCoeffs(**co), A0, frame=frame,
                                             device="cpu")
    z2, A2, ok2 = T.solve_batch_trajectories(cfg, T.RHSCoeffs(**co), A0, frame=frame,
                                             mesh=_mesh())
    assert ok2.all() and A2.shape == A1.shape == (B, 11, 4)
    np.testing.assert_array_equal(z2, z1)
    np.testing.assert_array_equal(ok2, ok1)
    np.testing.assert_allclose(A2, A1, rtol=1e-12)
    zj, Aj, okj = J.solve_batch_trajectories(J.custom_simulation_config(**ckw),
                                             J.RHSCoeffs(**co), A0, frame=frame,
                                             mesh=_jmesh())
    np.testing.assert_allclose(z2, zj, rtol=1e-15)
    np.testing.assert_array_equal(ok2, okj)
    np.testing.assert_allclose(A2, Aj, rtol=jax_bar, atol=1e-12)


# ---------------------------------------------------------------------------
# The comb (K4)
# ---------------------------------------------------------------------------

def test_comb_sharded():
    n, B = 16, 5
    grid = jn.CombGrid.centered(1.2e15, 2 * np.pi * 100e9, n)
    beta = jn.comb_beta_lin(grid, J.DispersionParams.from_betas(1.2e15, beta2=-2e-26))
    gammas = np.linspace(2.0, 10.0, B)
    A0 = np.stack([jn.seed_comb(grid, pump_lines={7: 0.3, 9: 0.3}, noise_floor_W=1e-10,
                                seed=s) for s in range(B)])
    betas = np.broadcast_to(beta, (B, n)).copy()
    ckw = dict(z_max=0.4, dz=1e-3, save_every=100)
    cfg = T.custom_simulation_config(**ckw)
    co = tn.NWaveCoeffs(gamma=torch.as_tensor(gammas), alpha=torch.zeros(B, dtype=torch.float64),
                        beta_lin=torch.as_tensor(betas))
    P1, A1, ok1 = tn.solve_comb_batch(cfg, co, A0, device="cpu")
    P2, A2, ok2 = tn.solve_comb_batch(cfg, co, A0, mesh=_mesh())
    assert ok2.all() and P2.shape == (B, n)
    np.testing.assert_array_equal(ok2, ok1)
    np.testing.assert_allclose(P2, P1, rtol=1e-12)
    assert _normwise(A2, A1) <= 1e-12
    cj = jn.NWaveCoeffs(gamma=jnp.asarray(gammas), alpha=jnp.zeros(B),
                        beta_lin=jnp.asarray(betas))
    Pj, Aj, okj = jn.solve_comb_batch(J.custom_simulation_config(**ckw), cj, A0, mesh=_jmesh())
    np.testing.assert_array_equal(ok2, okj)
    assert _normwise(A2, Aj) <= 1e-12 and _normwise(P2, Pj) <= 1e-12


# ---------------------------------------------------------------------------
# The GNLSE (K6 Kerr, K6 nl, K8)
# ---------------------------------------------------------------------------

def _gnlse_setup(B=7):
    jgrid = jg.TimeGrid.for_pulse(T0, n_samples=64)
    tgrid = tg.TimeGrid(n_samples=jgrid.n_samples, t_window_s=jgrid.t_window_s)
    disp = dict(omega_ref=OMEGA_REF, beta2=BETA2)
    jc = jg.make_gnlse_coeffs(jgrid, J.DispersionParams.from_betas(**disp), gamma_W_m=GAMMA)
    tc = tg.make_gnlse_coeffs(tgrid, T.DispersionParams.from_betas(**disp), gamma_W_m=GAMMA)
    peaks = np.linspace(0.5, 2.0, B) * jg.soliton_peak_power(BETA2, GAMMA, T0)
    A0 = np.stack([np.asarray(jg.sech_pulse(jgrid, peak_W=p, t0_s=T0)) for p in peaks])
    return jgrid, tgrid, jc, tc, A0


@pytest.mark.parametrize("case", ["kerr", "nl", "rk45"])
def test_gnlse_sharded(case):
    jgrid, tgrid, jc, tc, A0 = _gnlse_setup()
    ckw = dict(z_max=10.0, dz=0.05, save_every=50)
    if case == "rk45":
        ckw.update(integrator="rk45", rtol=1e-8, atol=1e-10)
    jnl = tnl = None
    if case == "nl":
        jnl = jg.make_nl_terms(jgrid, f_raman=0.18, omega0=OMEGA_REF)
        tnl = tg.make_nl_terms(tgrid, f_raman=0.18, omega0=OMEGA_REF)
    cfg = T.custom_simulation_config(**ckw)
    pk1, A1, ok1 = tg.solve_gnlse_batch(cfg, tc, A0, nl=tnl, device="cpu")
    pk2, A2, ok2 = tg.solve_gnlse_batch(cfg, tc, A0, nl=tnl, mesh=_mesh())
    assert ok2.all() and A2.shape == A0.shape
    np.testing.assert_array_equal(ok2, ok1)
    np.testing.assert_allclose(pk2, pk1, rtol=1e-11)
    np.testing.assert_allclose(A2, A1, rtol=0, atol=1e-11)
    pkj, Aj, okj = jg.solve_gnlse_batch(J.custom_simulation_config(**ckw), jc, A0, nl=jnl,
                                        mesh=_jmesh())
    bar = 1e-10 if case == "rk45" else 1e-12
    np.testing.assert_array_equal(ok2, okj)
    assert _normwise(A2, Aj) <= bar
    np.testing.assert_allclose(pk2, pkj, rtol=bar)
    if case == "kerr":   # the trajectories too
        z1, R1, okt1 = tg.solve_gnlse_batch_trajectories(cfg, tc, A0, device="cpu")
        z2, R2, okt2 = tg.solve_gnlse_batch_trajectories(cfg, tc, A0, mesh=_mesh(3))
        np.testing.assert_array_equal(z2, z1)
        np.testing.assert_array_equal(okt2, okt1)
        np.testing.assert_allclose(R2, R1, rtol=0, atol=1e-12)
        np.testing.assert_allclose(R2[:, -1], A2, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# The LLE (K7, K8-LLE)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integrator", ["rk4", "rk45"])
def test_lle_sharded(integrator):
    jgrid = jl.TimeGrid(n_samples=64, t_window_s=20.0)
    tgrid = tl.TimeGrid(n_samples=64, t_window_s=20.0)
    dets = np.linspace(3.5, 4.5, 7)
    jc = jl.make_lle_coeffs(jgrid, detuning=dets, pump=2.2, d2=-1.0)
    tc = tl.make_lle_coeffs(tgrid, detuning=dets, pump=2.2, d2=-1.0)
    psi0 = np.stack([jl.soliton_ansatz(jgrid, d, 2.2, -1.0) for d in dets])
    ckw = (dict(z_max=1.0, dz=0.01, save_every=25) if integrator == "rk4" else
           dict(z_max=0.5, dz=0.05, save_every=5, integrator="rk45", rtol=1e-7, atol=1e-10))
    cfg = T.custom_simulation_config(**ckw)
    pk1, A1, ok1 = tl.solve_lle_batch(cfg, tc, psi0, device="cpu")
    pk2, A2, ok2 = tl.solve_lle_batch(cfg, tc, psi0, mesh=_mesh())
    assert ok2.all() and A2.shape == psi0.shape
    np.testing.assert_array_equal(ok2, ok1)
    if integrator == "rk4":
        np.testing.assert_allclose(pk2, pk1, rtol=1e-12)
        np.testing.assert_allclose(A2, A1, rtol=1e-12, atol=1e-18)
    else:
        np.testing.assert_allclose(pk2, pk1, rtol=1e-9)
        np.testing.assert_allclose(A2, A1, rtol=0, atol=1e-9 * np.max(np.abs(A1)))
    pkj, Aj, okj = jl.solve_lle_batch(J.custom_simulation_config(**ckw), jc, psi0,
                                      mesh=_jmesh())
    bar = 1e-12 if integrator == "rk4" else 1e-10
    np.testing.assert_array_equal(ok2, okj)
    assert _normwise(A2, Aj) <= bar
    np.testing.assert_allclose(pk2, pkj, rtol=bar)


# ---------------------------------------------------------------------------
# The vector GNLSE (K9)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coupling", ["manakov", "isotropic"])
def test_vgnlse_sharded(coupling):
    jgrid = jg.TimeGrid.for_pulse(T0, n_samples=64)
    tgrid = tg.TimeGrid(n_samples=jgrid.n_samples, t_window_s=jgrid.t_window_s)
    disp = dict(omega_ref=OMEGA_REF, beta2=BETA2)
    jc = jv.make_vgnlse_coeffs(jgrid, J.DispersionParams.from_betas(**disp), gamma_W_m=GAMMA,
                               coupling=coupling)
    tc = tv.make_vgnlse_coeffs(tgrid, T.DispersionParams.from_betas(**disp), gamma_W_m=GAMMA,
                               coupling=coupling)
    sech = jg.sech_pulse(jgrid, peak_W=jv.manakov_soliton_peak_power(BETA2, GAMMA, T0),
                         t0_s=T0)
    A0 = np.stack([np.asarray(jv.polarized_pulse(s * sech, th))
                   for s, th in zip(np.linspace(0.6, 1.4, 5), np.linspace(0, np.pi / 2, 5))])
    ckw = dict(z_max=10.0, dz=0.05, save_every=50)
    cfg = T.custom_simulation_config(**ckw)
    pk1, A1, ok1 = tv.solve_vgnlse_batch(cfg, tc, A0, device="cpu")
    pk2, A2, ok2 = tv.solve_vgnlse_batch(cfg, tc, A0, mesh=_mesh())
    assert ok2.all() and pk2.shape == (5, 2) and A2.shape == A0.shape
    np.testing.assert_array_equal(ok2, ok1)
    np.testing.assert_allclose(pk2, pk1, rtol=1e-11)
    np.testing.assert_allclose(A2, A1, rtol=0, atol=1e-11)
    pkj, Aj, okj = jv.solve_vgnlse_batch(J.custom_simulation_config(**ckw), jc, A0,
                                         mesh=_jmesh())
    np.testing.assert_array_equal(ok2, okj)
    assert _normwise(A2, Aj) <= 1e-12
    np.testing.assert_allclose(pk2, pkj, rtol=1e-12)


# ---------------------------------------------------------------------------
# SBS (plain torch) and one Monte-Carlo entry
# ---------------------------------------------------------------------------

def test_sbs_sharded():
    B = 11
    kw = dict(gamma=0.5, alpha=0.01, g_B=np.linspace(0.1, 1.2, B), delta_beta=0.2,
              P_in=np.broadcast_to([0.2, 0.1, 1e-5, 0.0], (B, 4)).copy(),
              P_stokes_seed=np.broadcast_to([1e-4, 0.0, 0.0, 0.0], (B, 4)).copy(),
              length_unit="m", tol=1e-11, max_iterations=150)
    ckw = dict(z_max=1.0, dz=0.01, save_every=20)
    cfg = T.custom_simulation_config(**ckw)
    z1, A1, B1, r1, f1, ok1, n1 = tsbs.run_sbs_batch(cfg, device="cpu", **kw)
    z2, A2, B2, r2, f2, ok2, n2 = tsbs.run_sbs_batch(cfg, mesh=_mesh(), **kw)
    assert ok2.all() and A2.shape == A1.shape and n2.shape == (B,)
    np.testing.assert_array_equal(z2, z1)
    np.testing.assert_array_equal(n2, n1)
    np.testing.assert_array_equal(ok2, ok1)
    for got, ref in ((A2, A1), (B2, B1), (f2, f1)):
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    zj, Aj, Bj, rj, fj, okj, nj = jsbs.run_sbs_batch(J.custom_simulation_config(**ckw),
                                                     mesh=_jmesh(), **kw)
    np.testing.assert_array_equal(n2, nj)
    np.testing.assert_array_equal(ok2, okj)
    for got, ref in ((A2, Aj), (B2, Bj)):
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)


def test_noise_figure_monte_carlo_sharded():
    """The ensemble's draws come from the host in the same order either way,
    so the sharded noise figure is the unsharded one."""
    cfg = T.custom_simulation_config(z_max=20.0, dz=0.05, save_every=50)
    kw = dict(gamma=5e-3, alpha=0.0, delta_beta=0.0, n_samples=62, p_in=[0.5, 0.5, 1e-6, 0.0],
              omega=np.asarray(T.plan_from_wavelengths(1550e-9, 1552e-9, 1551e-9)),
              noisy_waves=(False, False, True, True))
    plain = TN.noise_figure_monte_carlo(cfg, device="cpu", **kw)
    sharded = TN.noise_figure_monte_carlo(cfg, mesh=_mesh(), **kw)
    assert sharded.n_samples == 62 and sharded.ok_fraction == 1.0
    for f in dataclasses.fields(plain):
        got, ref = getattr(sharded, f.name), getattr(plain, f.name)
        if f.name == "elapsed_s":
            continue
        if isinstance(ref, float):
            np.testing.assert_allclose(got, ref, rtol=1e-12, err_msg=f.name)
        else:
            assert got == ref, f.name
