"""The LLE kernel modules of the PyTorch port, ``ops/cuda_lle.py`` (K7) and
the LLE route of ``ops/cuda_ssfm_adaptive.py`` (K8), through their plain
versions on the CPU, and the dispatch of ``models/lle.solve_lle_batch``.

Tolerances:

- the K7 plain version in float32 against the JAX K7 kernel
  (``ops/pallas_lle.py``) in interpret mode, at the JAX tests' size and bars
  (``tests/test_pallas_lle.py:42-58, 102-115``): B = 5, T = 256, 10 steps at
  ``save_every=3``, a complex pump at phase 0.3, the peak to rtol 1e-4 and
  the state to 1e-4 of its largest amplitude; a shared and a per-cavity
  phase; a cavity whose |psi|^2 overflows float32 fails in both alike;
- the K8 plain version in float32 against the JAX K8 kernel's LLE route in
  interpret mode (``tests/test_pallas_ssfm_adaptive.py:33-50``): three
  cavities, 5e-4 normwise and in the peak; the two controllers differ (the
  JAX kernel never shrinks an accepted step), so step counts are not
  compared;
- host helpers: the factor rows bit for bit the plain version's and within
  4 ulp of float64 numpy; the affine scalars within 4 ulp of the JAX scan's
  and of the JAX kernel driver's numpy.

The CUDA kernels themselves are compared with these plain versions on the
card in ``tests/test_torch_kernel.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import psa_torch as T  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import lle as jl  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops.pallas_lle import solve_lle_batch_pallas  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops.pallas_ssfm_adaptive import (  # noqa: E402
    solve_lle_batch_rk45_pallas,
)
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import lle as tl  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_gnlse as cg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_lle as cl  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_ssfm_adaptive as csa  # noqa: E402

torch.set_num_threads(1)

DET, PUMP, D2 = 4.0, 2.2, -1.0
CPU = torch.device("cpu")
EPS = np.finfo(float).eps


def _normwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.max(np.abs(a - b), axis=-1) / np.max(np.abs(b), axis=-1)))


def _setup(B, T_=256, window=24.0, dets=None, pump=PUMP):
    """tests/test_pallas_lle.py:27-35: detuning-scan cavities from the
    soliton ansatz."""
    grid = tl.TimeGrid(n_samples=T_, t_window_s=window)
    dets = np.linspace(DET - 0.5, DET + 0.5, B) if dets is None else np.asarray(dets)
    co = tl.make_lle_coeffs(grid, detuning=dets, pump=pump, d2=D2)
    psi0 = np.stack([tl.soliton_ansatz(grid, d, abs(pump), D2) for d in dets])
    return grid, co, psi0


def _lanes(co, psi0, rdt=torch.float32, rows=False):
    B, n = psi0.shape
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    det, F, ph = tl.lane_coeffs(co, B, n, rdt, CPU)
    if rows:
        ph = (ph[None] * torch.linspace(0.8, 1.2, B, dtype=rdt)[:, None]).contiguous()
    return torch.as_tensor(psi0).to(cdt), det, F, ph


@pytest.mark.parametrize("case", ["complex_pump", "phase_rows", "overflow"])
def test_k7_plain_fp32_matches_the_jax_kernel_in_interpret_mode(case):
    pump = PUMP * np.exp(0.3j) if case != "overflow" else PUMP
    _grid, co, psi0 = _setup(B=5 if case != "overflow" else 3, pump=pump)
    if case == "overflow":
        psi0[1] *= 1e25          # |psi|^2 overflows float32 in the first Kerr substep
    t = _lanes(co, psi0, rows=case == "phase_rows")
    kw = dict(n_steps=10 if case != "overflow" else 12, save_every=3)
    r = cl.solve_lle_batch_torch(*t, dt=0.05, **kw)
    with np.errstate(all="ignore"):
        pk, Af, ok = solve_lle_batch_pallas(
            psi0, co.detuning.numpy(), pump.real, pump.imag, t[3].numpy().astype(np.float64),
            dt=0.05, interpret=True, **kw)
    assert r.peak_max.dtype == torch.float32 and r.ok.numpy().tolist() == ok.tolist()
    assert ok.sum() == len(ok) - (case == "overflow")
    good = ok
    np.testing.assert_allclose(r.peak_max.numpy()[good], pk[good], rtol=1e-4)
    np.testing.assert_allclose(r.A_end.numpy()[good], Af[good], rtol=0,
                               atol=1e-4 * np.max(np.abs(Af[good])))


def test_k8_lle_plain_fp32_matches_the_jax_kernel_in_interpret_mode():
    """tests/test_pallas_ssfm_adaptive.py:33-50: T = 256, 20 steps of 0.05,
    rtol 1e-6."""
    _grid, co, psi0 = _setup(3, window=20.0, dets=[4.0, 3.8, 4.2], pump=2.0)
    kw = dict(n_steps=20, save_every=10, rtol=1e-6, atol=1e-9)
    r = csa.solve_lle_batch_rk45_torch(*_lanes(co, psi0), dt=0.05, **kw)
    rk = solve_lle_batch_rk45_pallas(psi0, co.detuning.numpy(), 2.0, 0.0, co.lin_phase.numpy(),
                                     dt=0.05, interpret=True, **kw)
    assert r.ok.all() and rk.ok.all() and bool((r.n_accepted > 20).all())
    assert _normwise(r.A_end.numpy(), rk.A_end) < 5e-4
    np.testing.assert_allclose(r.peak_max.numpy(), rk.peak_max, rtol=5e-4)


def test_plain_versions_hold_the_save_contract():
    """No steps, fewer steps than one chunk, and a trailing span: the state
    stays at the last saved point, the span still feeds ok and the
    counters."""
    _grid, co, psi0 = _setup(2, T_=128)
    t = _lanes(co, psi0, torch.float64)
    ctl = dict(rtol=1e-8, atol=1e-11)
    for n_steps in (0, 2):
        r = cl.solve_lle_batch_torch(*t, dt=0.01, n_steps=n_steps, save_every=3)
        r45 = csa.solve_lle_batch_rk45_torch(*t, dt=0.01, n_steps=n_steps, save_every=3, **ctl)
        for res in (r, r45):
            assert torch.equal(res.A_end, t[0]) and res.ok.all()
            assert torch.equal(res.peak_max, (t[0].real ** 2 + t[0].imag ** 2).amax(-1))
        assert bool((r45.n_accepted > 0).all()) == (n_steps > 0)
    grid9 = csa.solve_lle_batch_rk45_torch(*t, dt=0.01, n_steps=9, save_every=3, **ctl)
    tail = csa.solve_lle_batch_rk45_torch(*t, dt=0.01, n_steps=11, save_every=3, **ctl)
    assert torch.equal(tail.A_end, grid9.A_end) and torch.equal(tail.peak_max, grid9.peak_max)
    assert bool((tail.n_accepted > grid9.n_accepted).all())
    fix9 = cl.solve_lle_batch_torch(*t, dt=0.01, n_steps=9, save_every=3)
    fix11 = cl.solve_lle_batch_torch(*t, dt=0.01, n_steps=11, save_every=3)
    assert torch.equal(fix11.A_end, fix9.A_end) and torch.equal(fix11.ok, fix9.ok)


@pytest.mark.parametrize("bad", [np.nan, 1e160], ids=["nan", "overflow"])
def test_failed_cavity_fails_fast_under_rk45(bad):
    """A NaN seed fails with no attempt; a 1e160 seed (|psi|^2 overflows
    float64) is rejected down to dt_min within a few dozen attempts."""
    _grid, co, psi0 = _setup(3, T_=128)
    psi0[1] = bad
    t = _lanes(co, psi0, torch.float64)
    r = csa.solve_lle_batch_rk45_torch(*t, dt=0.01, n_steps=20, save_every=10, rtol=1e-8,
                                       atol=1e-11)
    assert r.ok.tolist() == [True, False, True]
    assert int(r.n_accepted[1]) == 0 and int(r.n_rejected[1]) == (0 if np.isnan(bad) else 35)
    assert torch.equal(r.A_end[1].isnan(), t[0][1].isnan())


# ---------------------------------------------------------------------------
# Host helpers
# ---------------------------------------------------------------------------

def test_factor_rows_and_affine_scalars_equal_the_jax_ones():
    grid, co, psi0 = _setup(3)
    y0, det, F, ph = _lanes(co, psi0, torch.float64)
    Lh, Lf, stride = cl.factor_rows(ph, 0.05, y0)
    assert stride == 0 and Lh.shape == (1, 256)
    h = tl._scalar(0.05, y0)
    assert torch.equal(Lh[0], tl._lle_lin_factor(ph, 0.5 * h))
    assert torch.equal(Lf[0], tl._lle_lin_factor(ph, h))
    np.testing.assert_allclose(Lf[0].numpy(), np.exp((-1.0 + 1j * ph.numpy()) * 0.05),
                               rtol=4 * EPS, atol=0)
    rows = (ph[None] * torch.linspace(0.8, 1.2, 3, dtype=torch.float64)[:, None]).contiguous()
    Lh2, _Lf2, stride2 = cl.factor_rows(rows, 0.05, y0)
    assert stride2 == 256 and Lh2.shape == (3, 256)
    aff = cl.affine_scalars(det, F, 0.05).numpy()
    assert aff.shape == (3, 4) and aff.dtype == np.complex128
    jc = jl.make_lle_coeffs(jl.TimeGrid(256, 24.0), detuning=co.detuning.numpy(), pump=PUMP,
                            d2=D2)
    jdet = jnp.asarray(jc.detuning)
    for i, s in enumerate((0.025, 0.025, 0.05, 0.05)):
        hs = jnp.asarray(s)
        ref = (jl._det_phase(jdet, hs, jnp.float64) if i % 2 == 0
               else jl._drive_offset(jc, jdet, hs, jnp.float64))
        np.testing.assert_allclose(aff[:, i], np.asarray(ref), rtol=4 * EPS, atol=0)
    # the JAX kernel driver's numpy (ops/pallas_lle.py:151-158)
    d = co.detuning.numpy()
    lam0 = -(1.0 + 1j * d)
    np.testing.assert_allclose(aff[:, 2], np.exp(-1j * d * 0.05), rtol=4 * EPS, atol=0)
    np.testing.assert_allclose(aff[:, 3], PUMP * (np.exp(lam0 * 0.05) - 1.0) / lam0,
                               rtol=8 * EPS, atol=0)


def test_shared_memory_sizes_and_width_refusal():
    """K7 holds the state and its partner, as K6 Kerr does, K8's LLE route
    K8's four buffers; widths as the JAX kernels take them."""
    assert cg.shared_bytes("lle_ssfm", 256, torch.float64) == 8 * (32 + 4 * 256)
    assert cg.shared_bytes("gnlse_ssfm", 256, torch.float64) == 8 * (32 + 4 * 256)
    assert cg.shared_bytes("ssfm_rk45", 2048, torch.float32) == 4 * (32 + 8 * 2048)
    limit = 232_448
    for kernel in ("lle_ssfm", "gnlse_ssfm", "ssfm_rk45"):
        assert cg.shared_memory_problem(kernel, 2048, torch.float64, False, limit) is None


# ---------------------------------------------------------------------------
# Dispatch of solve_lle_batch
# ---------------------------------------------------------------------------

class _Props:
    shared_memory_per_block_optin = 232_448


@pytest.fixture
def fake_card(monkeypatch):
    """The shared-memory query of the route, without a card."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    return torch.device("cuda")


@pytest.mark.parametrize("integrator,rdt,n,want,msg", [
    ("rk4", torch.float64, 256, "lle_ssfm", None),
    ("rk4", torch.float32, 2048, "lle_ssfm", None),
    ("rk45", torch.float64, 256, "ssfm_rk45_lle", None),
    ("rk45", torch.float32, 384, "ssfm_rk45_lle", None),
    ("rk4ip", torch.float64, 256, None, "fixed-step Strang split"),
    ("rk4ip45", torch.float64, 256, None, "fixed-step Strang split"),
    ("rk4", torch.float64, 200, None, "multiple of 128"),
    ("rk4", torch.float64, 4096, None, "too wide"),
    ("rk45", torch.float64, 4096, None, "at most 2048"),
])
def test_route_table(fake_card, integrator, rdt, n, want, msg):
    """Each row of the dispatch table: 'auto' launches the kernel or runs
    the plain version; 'cuda' launches it or raises with the JAX message."""
    assert tl.lle_kernel_route(integrator, n, rdt, fake_card, "auto") == want
    assert tl.lle_kernel_route(integrator, n, rdt, fake_card, "torch") is None
    if msg is None:
        assert tl.lle_kernel_route(integrator, n, rdt, fake_card, "cuda") == want
    else:
        with pytest.raises(ValueError, match=msg):
            tl.lle_kernel_route(integrator, n, rdt, fake_card, "cuda")
    assert tl.lle_kernel_route(integrator, n, rdt, CPU, "auto") is None


def test_cpu_runs_the_plain_versions_and_wrappers_refuse_cpu_tensors():
    _grid, co, psi0 = _setup(3, T_=128)
    cfg = T.custom_simulation_config(z_max=0.05, dz=0.01, save_every=2, precision="x32")
    launches = dict(_build.LAUNCHES)
    pk, A, ok = tl.solve_lle_batch(cfg, co, psi0, device="cpu")
    t = _lanes(co, psi0)
    r = cl.solve_lle_batch_torch(*t, dt=0.01, n_steps=5, save_every=2)
    assert np.array_equal(A, r.A_end.numpy().astype(np.complex128)) and ok.all()
    with pytest.raises(ValueError, match="CUDA"):
        cl.solve_lle_batch_cuda(*t, dt=0.01, n_steps=5, save_every=2)
    with pytest.raises(ValueError, match="CUDA"):
        csa.solve_lle_batch_rk45_cuda(*t, dt=0.01, n_steps=5, save_every=2, rtol=1e-5,
                                      atol=1e-9)
    with pytest.raises(ValueError, match="lin_phase"):
        cl.solve_lle_batch_torch(*t[:3], t[3][:100].contiguous(), dt=0.01, n_steps=5,
                                 save_every=2)
    with pytest.raises(ValueError, match="pump"):
        cl.solve_lle_batch_torch(t[0], t[1], t[2].to(torch.complex128), t[3], dt=0.01, n_steps=5,
                                 save_every=2)
    with pytest.raises(ValueError, match="detuning"):
        cl.solve_lle_batch_torch(t[0], t[1].double(), *t[2:], dt=0.01, n_steps=5, save_every=2)
    with pytest.raises(ValueError, match="rtol"):
        csa.solve_lle_batch_rk45_torch(*t, dt=0.01, n_steps=5, save_every=2, rtol=0.0,
                                       atol=1e-9)
    assert dict(_build.LAUNCHES) == launches
