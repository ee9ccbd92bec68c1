"""The split-step kernel modules of the PyTorch port, ``ops/cuda_gnlse.py``
(K6) and ``ops/cuda_ssfm_adaptive.py`` (K8, GNLSE route), through their
plain versions on the CPU, and the dispatch of ``solve_gnlse_batch``.

Tolerances:

- the K6 plain version in float32 against the JAX K6 kernel
  (``ops/pallas_gnlse.py``) in interpret mode, at the JAX tests' size and
  bars (``tests/test_pallas_gnlse.py:46-57, 99-113``): T = 256, 10 steps,
  the peak to rtol 1e-4 and the state to 1e-4 of its largest amplitude,
  Kerr and the four ``nl`` term combinations;
- the K8 plain version in float32 against the JAX K8 kernel in interpret
  mode (``tests/test_pallas_ssfm_adaptive.py:136-155``): T = 512, 5e-4
  normwise; the two controllers differ (the JAX kernel never shrinks an
  accepted step), so step counts are not compared;
- host helpers: the float64 twiddle table bit for bit against numpy; the
  kernels' factor planes bit for bit the plain version's, and within 4 ulp
  of float64 numpy.

The CUDA kernels themselves are compared with these plain versions on the
card in ``tests/test_torch_kernel.py`` and ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import gnlse as jg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops.pallas_gnlse import solve_gnlse_batch_pallas  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops.pallas_ssfm_adaptive import (  # noqa: E402
    solve_gnlse_batch_rk45_pallas,
)
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import gnlse as tg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_gnlse as cg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_ssfm_adaptive as csa  # noqa: E402

torch.set_num_threads(1)

T0 = 1e-12
BETA2 = -2.0e-26
GAMMA = 2e-3
ALPHA = 5e-5
CPU = torch.device("cpu")


def _normwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.max(np.abs(a - b), axis=-1) / np.max(np.abs(b), axis=-1)))


def _setup(B, n=256):
    """tests/test_pallas_gnlse.py:28-37: sech envelopes at 0.5-1.5 x the
    soliton power, x32 coefficients."""
    grid = tg.TimeGrid.for_pulse(T0, n_samples=n)
    co = tg.make_gnlse_coeffs(grid, T.DispersionParams.from_betas(1.2e15, beta2=BETA2),
                              gamma_W_m=GAMMA, alpha_1_m=ALPHA, precision="x32")
    P0 = tg.soliton_peak_power(BETA2, GAMMA, T0)
    A0 = (np.sqrt(np.linspace(0.5, 1.5, B) * P0)[:, None]
          / np.cosh(grid.t()[None, :] / T0)).astype(np.complex128)
    return grid, co, A0


def _lanes(co, A0, rdt=torch.float32):
    B, n = A0.shape
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    return (torch.as_tensor(A0).to(cdt),) + tg.lane_coeffs(co, B, n, rdt, CPU)


@pytest.mark.parametrize("case", [None, (0.18, 1.2e15), (0.18, None), (0.0, 1.2e15),
                                  (0.0, None)])
def test_k6_plain_fp32_matches_the_jax_kernel_in_interpret_mode(case):
    grid, co, A0 = _setup(B=5 if case is None else 4)
    nl = None if case is None else tg.make_nl_terms(grid, f_raman=case[0], omega0=case[1],
                                                    precision="x32")
    kw = dict(dz_m=0.01, n_steps=10, save_every=3)
    r = cg.solve_gnlse_batch_torch(*_lanes(co, A0), nl=nl, **kw)
    jnl = None if case is None else jg.make_nl_terms(
        jg.TimeGrid(grid.n_samples, grid.t_window_s), f_raman=case[0], omega0=case[1],
        precision="x32")
    pk, Af, ok = solve_gnlse_batch_pallas(A0, GAMMA, ALPHA, co.lin_phase.numpy(),
                                          interpret=True, nl=jnl, **kw)
    assert r.peak_max.dtype == torch.float32 and r.ok.numpy().tolist() == ok.tolist()
    np.testing.assert_allclose(r.peak_max.numpy(), pk, rtol=1e-4)
    np.testing.assert_allclose(r.A_end.numpy(), Af, rtol=0, atol=1e-4 * np.max(np.abs(Af)))


def test_k8_plain_fp32_matches_the_jax_kernel_in_interpret_mode():
    """tests/test_pallas_ssfm_adaptive.py:136-155: T = 512, 40 steps of
    0.5 m, rtol 1e-6."""
    g = tg.TimeGrid.for_pulse(1e-12, n_samples=512)
    co = tg.make_gnlse_coeffs(g, T.DispersionParams.from_betas(2 * np.pi * 193.1e12,
                                                               beta2=-2e-26),
                              gamma_W_m=1.3e-3, alpha_1_m=5e-5, precision="x32")
    A0 = np.stack([tg.sech_pulse(g, peak_W=p, t0_s=1e-12) for p in (50.0, 80.0)])
    kw = dict(dz_m=0.5, n_steps=40, save_every=10, rtol=1e-6, atol=1e-9)
    r = csa.solve_gnlse_batch_rk45_torch(*_lanes(co, A0), **kw)
    rk = solve_gnlse_batch_rk45_pallas(A0, 1.3e-3, 5e-5, co.lin_phase.numpy(), interpret=True,
                                       **kw)
    assert r.ok.all() and rk.ok.all() and bool((r.n_accepted > 0).all())
    assert _normwise(r.A_end.numpy(), rk.A_end) < 5e-4
    np.testing.assert_allclose(r.peak_max.numpy(), rk.peak_max, rtol=5e-4)


def test_plain_versions_hold_the_save_contract():
    """No steps, fewer steps than one chunk, and a trailing span: the state
    stays at the last saved point, the span still feeds ok and the
    counters."""
    _grid, co, A0 = _setup(B=2, n=128)
    t = _lanes(co, A0, torch.float64)
    for n_steps in (0, 2):
        r = cg.solve_gnlse_batch_torch(*t, dz_m=0.01, n_steps=n_steps, save_every=3)
        r45 = csa.solve_gnlse_batch_rk45_torch(*t, dz_m=0.01, n_steps=n_steps, save_every=3,
                                               rtol=1e-8, atol=1e-12)
        for res in (r, r45):
            assert torch.equal(res.A_end, t[0]) and res.ok.all()
            assert torch.equal(res.peak_max, (t[0].abs() ** 2).amax(-1))
        assert bool((r45.n_accepted > 0).all()) == (n_steps > 0)
    grid9 = csa.solve_gnlse_batch_rk45_torch(*t, dz_m=0.01, n_steps=9, save_every=3, rtol=1e-8,
                                             atol=1e-12)
    tail = csa.solve_gnlse_batch_rk45_torch(*t, dz_m=0.01, n_steps=11, save_every=3, rtol=1e-8,
                                            atol=1e-12)
    assert torch.equal(tail.A_end, grid9.A_end) and torch.equal(tail.peak_max, grid9.peak_max)
    assert bool((tail.n_accepted > grid9.n_accepted).all())


def test_nonfinite_input_fails_without_steps():
    _grid, co, A0 = _setup(B=3, n=128)
    A0[1, 5] = np.nan
    t = _lanes(co, A0, torch.float64)
    r = cg.solve_gnlse_batch_torch(*t, dz_m=0.01, n_steps=6, save_every=3)
    r45 = csa.solve_gnlse_batch_rk45_torch(*t, dz_m=0.01, n_steps=6, save_every=3, rtol=1e-8,
                                           atol=1e-12)
    for res in (r, r45):
        assert res.ok.tolist() == [True, False, True]
        assert torch.equal(res.A_end[1].isnan(), t[0][1].isnan())
        assert bool(res.peak_max[1].isnan())
    assert int(r45.n_accepted[1]) == 0 and int(r45.n_rejected[1]) == 0


# ---------------------------------------------------------------------------
# Host helpers
# ---------------------------------------------------------------------------

def test_twiddles_and_factor_planes():
    for n in (128, 384, 2048):
        ang = (2.0 * np.pi / n) * np.arange(n)
        tw = cg.twiddles(n, "cpu")
        assert tw.dtype == torch.float64
        assert np.array_equal(tw.numpy(), np.stack([np.cos(ang), np.sin(ang)], axis=1))
    grid, co, A0 = _setup(B=3)
    A, g, a, ph = _lanes(tg.make_gnlse_coeffs(
        grid, T.DispersionParams.from_betas(1.2e15, beta2=BETA2), gamma_W_m=GAMMA,
        alpha_1_m=ALPHA), A0, torch.float64)
    Lh, Lf, stride = cg.factor_planes(a, ph, 0.01, A)
    assert stride == 0 and Lh.shape == (1, 256)           # every lane shares one row
    assert torch.equal(Lh, tg._lin_factor(a, ph, 0.5 * tg._scalar(0.01, A))[:1])
    assert torch.equal(Lf, tg._lin_factor(a, ph, tg._scalar(0.01, A))[:1])
    ref = np.exp((-0.5 * ALPHA + 1j * ph.numpy()) * 0.01)
    np.testing.assert_allclose(Lf[0].numpy(), ref, rtol=4 * np.finfo(float).eps, atol=0)
    a2 = a.clone()
    a2[1] = 1e-3                                           # per-lane loss: one row a lane
    Lh2, _, stride2 = cg.factor_planes(a2, ph, 0.01, A)
    assert stride2 == 256 and Lh2.shape == (3, 256)
    assert torch.equal(Lh2[0], Lh[0])


def test_shared_memory_sizes_and_refusal():
    assert cg.shared_bytes("gnlse_ssfm", 1024, torch.float64) == 8 * (32 + 4 * 1024)
    assert cg.shared_bytes("gnlse_ssfm", 1024, torch.float32, nl=True) == 4 * (32 + 6 * 1024)
    assert cg.shared_bytes("gnlse_ssfm", 640, torch.float64, nl=True) == 8 * (32 + 6 * 640)
    assert cg.shared_bytes("ssfm_rk45", 2048, torch.float64) == 8 * (32 + 8 * 2048)
    limit = 232_448                                        # a Hopper block's opt-in limit
    assert cg.shared_memory_problem("gnlse_ssfm", 2048, torch.float64, True, limit) is None
    msg = cg.shared_memory_problem("gnlse_ssfm", 2048, torch.float64, True, 90_000)
    assert "98560 bytes" in msg and "allows 90000" in msg


# ---------------------------------------------------------------------------
# Dispatch of solve_gnlse_batch
# ---------------------------------------------------------------------------

class _Props:
    shared_memory_per_block_optin = 232_448


@pytest.fixture
def fake_card(monkeypatch):
    """The shared-memory query of the route, without a card."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    return torch.device("cuda")


@pytest.mark.parametrize("integrator,nl,spectral,n,want,msg", [
    ("rk4", False, False, 1024, "gnlse_ssfm", None),
    ("rk4", True, True, 384, "gnlse_ssfm", None),
    ("rk4", True, False, 2048, "gnlse_ssfm", None),
    ("rk4", True, False, 640, "gnlse_ssfm", None),
    ("rk45", False, False, 1024, "ssfm_rk45", None),
    ("rk4ip", False, False, 1024, None, "fixed-step Strang split"),
    ("rk4ip45", False, False, 1024, None, "fixed-step Strang split"),
    ("rk45", True, False, 1024, None, "Kerr-only"),
    ("rk45", False, True, 1024, None, "flat per-lane loss"),
    ("rk4", False, False, 200, None, "multiple of 128"),
    ("rk4", False, False, 4096, None, "too wide"),
    ("rk45", False, False, 4096, None, "at most 2048"),
])
def test_route_table(fake_card, integrator, nl, spectral, n, want, msg):
    """Each row of the dispatch table: 'auto' launches the kernel or runs
    the plain version; 'cuda' launches it or raises with the JAX message."""
    alpha = torch.zeros((4, n) if spectral else (4,), dtype=torch.float64)
    nl_t = object() if nl else None
    args = (integrator, nl_t, alpha, n, torch.float64, fake_card)
    assert tg.kernel_route(*args, "auto") == want
    assert tg.kernel_route(*args, "torch") is None
    if msg is None:
        assert tg.kernel_route(*args, "cuda") == want
    else:
        with pytest.raises(ValueError, match=msg):
            tg.kernel_route(*args, "cuda")
    assert tg.kernel_route(integrator, nl_t, alpha, n, torch.float64, CPU, "auto") is None


def test_route_refuses_a_block_too_large_for_the_card(fake_card, monkeypatch):
    # between the fp32 nl block at 2048 (98,432 bytes) and the fp64 one (98,560)
    monkeypatch.setattr(_Props, "shared_memory_per_block_optin", 98_500)
    args = ("rk4", object(), torch.zeros(2, dtype=torch.float64), 2048, torch.float64, fake_card)
    assert tg.kernel_route(*args, "auto") is None
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tg.kernel_route(*args, "cuda")
    assert tg.kernel_route("rk4", object(), torch.zeros(2), 2048, torch.float32, fake_card,
                           "auto") == "gnlse_ssfm"


def test_cpu_runs_the_plain_versions_and_wrappers_refuse_cpu_tensors():
    grid, co, A0 = _setup(B=3, n=128)
    cfg = T.custom_simulation_config(z_max=0.05, dz=0.01, save_every=2, precision="x32")
    launches = dict(_build.LAUNCHES)
    pk, A, ok = tg.solve_gnlse_batch(cfg, co, A0, device="cpu")
    r = cg.solve_gnlse_batch_torch(*_lanes(co, A0), dz_m=0.01, n_steps=5, save_every=2)
    assert np.array_equal(A, r.A_end.numpy().astype(np.complex128)) and ok.all()
    t = _lanes(co, A0)
    with pytest.raises(ValueError, match="CUDA"):
        cg.solve_gnlse_batch_cuda(*t, dz_m=0.01, n_steps=5, save_every=2)
    with pytest.raises(ValueError, match="CUDA"):
        csa.solve_gnlse_batch_rk45_cuda(*t, dz_m=0.01, n_steps=5, save_every=2, rtol=1e-5,
                                        atol=1e-9)
    with pytest.raises(ValueError, match="lin_phase"):
        cg.solve_gnlse_batch_torch(*t[:3], t[3][:100].contiguous(), dz_m=0.01, n_steps=5,
                                   save_every=2)
    with pytest.raises(ValueError, match="gamma"):
        cg.solve_gnlse_batch_torch(t[0], t[1].double(), *t[2:], dz_m=0.01, n_steps=5,
                                   save_every=2)
    with pytest.raises(ValueError, match="rtol"):
        csa.solve_gnlse_batch_rk45_torch(*t, dz_m=0.01, n_steps=5, save_every=2, rtol=0.0,
                                         atol=1e-9)
    assert dict(_build.LAUNCHES) == launches
    assert dataclasses.is_dataclass(csa.SSFMAdaptiveResult)
