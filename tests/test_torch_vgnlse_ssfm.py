"""The vector split-step kernel module of the PyTorch port,
``ops/cuda_vgnlse.py`` (K9), through its plain version on the CPU, and the
dispatch of ``solve_vgnlse_batch``.

Tolerances:

- the K9 plain version in float32 against the JAX K9 kernel
  (``ops/pallas_vgnlse.py``) in interpret mode, at the JAX tests' size and
  bars (``tests/test_pallas_vgnlse.py``): T = 256, 10 steps at
  ``save_every=3``, the peak to rtol 1e-4 and the state to 1e-4 of its
  largest amplitude; each coupling with birefringence, the coherent
  isotropic body, two ``nl`` term combinations, (2, T) spectral loss with
  per-instance phase, and a NaN lane.  The JAX kernel starts ``ok`` from
  ones and squares ``Lh`` for ``Lf``; the port follows the JAX scan, which
  these inputs cannot tell apart at this bar;
- host helpers: the kernel's factor planes bit for bit the plain version's;
  the shared-memory sizes from the buffer counts of the CUDA source.

The CUDA kernel itself is compared with this plain version on the card in
``tests/test_torch_kernel.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.models import gnlse as jg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops.pallas_vgnlse import (  # noqa: E402
    solve_vgnlse_batch_pallas,
)
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import gnlse as tg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import vgnlse as tv  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_vgnlse as cv  # noqa: E402

torch.set_num_threads(1)

T0 = 1e-12
BETA2 = -2.0e-26
GAMMA = 2e-3
ALPHA = 5e-5
CPU = torch.device("cpu")


def _setup(B, n=256, coupling="cnlse", theta=0.4, precision="x32", **kw):
    """tests/test_pallas_vgnlse.py:28-40: sech envelopes at 0.5-1.5 x the
    Manakov soliton power split at theta."""
    grid = tv.TimeGrid.for_pulse(T0, n_samples=n)
    co = tv.make_vgnlse_coeffs(grid, T.DispersionParams.from_betas(1.2e15, beta2=BETA2),
                               gamma_W_m=GAMMA, alpha_1_m=ALPHA, coupling=coupling,
                               precision=precision, **kw)
    P0 = tv.manakov_soliton_peak_power(BETA2, GAMMA, T0)
    A = (np.sqrt(np.linspace(0.5, 1.5, B) * P0)[:, None]
         / np.cosh(grid.t()[None, :] / T0)).astype(np.complex128)
    return grid, co, np.stack([np.cos(theta) * A, np.sin(theta) * A], axis=1)


def _lanes(co, A0, rdt=torch.float32):
    B, _, n = A0.shape
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    return (torch.as_tensor(A0).to(cdt),) + tv.lane_coeffs(co, B, n, rdt, CPU)


def _jax_kernel(co, A0, lanes=None, nl=None, **kw):
    gamma, alpha, b, phase = (v.numpy().astype(float) for v in (lanes or _lanes(co, A0))[1:])
    return solve_vgnlse_batch_pallas(A0, gamma, alpha, phase, float(b), coherent=co.coherent,
                                     interpret=True, nl=nl, **kw)


KW = dict(dz_m=0.01, n_steps=10, save_every=3)


@pytest.mark.parametrize("coupling,case", [
    ("cnlse", None), ("manakov", None), ("isotropic", None), ("manakov", (0.18, None)),
    ("isotropic", (0.18, 1.2e15)),
])
def test_k9_plain_fp32_matches_the_jax_kernel_in_interpret_mode(coupling, case):
    """Birefringence (dbeta0 8 /m for the coherent exchange, 0.3 /m and a
    group splitting otherwise) and a trailing partial chunk."""
    bire = dict(dbeta0_1_m=8.0) if coupling == "isotropic" else dict(dbeta0_1_m=0.3,
                                                                      dbeta1_s_m=1e-13)
    grid, co, A0 = _setup(B=4, coupling=coupling, theta=0.35, **bire)
    nl = jnl = None
    if case is not None:
        nl = tg.make_nl_terms(grid, f_raman=case[0], omega0=case[1], precision="x32")
        jnl = jg.make_nl_terms(jg.TimeGrid(grid.n_samples, grid.t_window_s), f_raman=case[0],
                               omega0=case[1], precision="x32")
    r = cv.solve_vgnlse_batch_torch(*_lanes(co, A0), co.coherent, nl=nl, **KW)
    pk, Af, ok = _jax_kernel(co, A0, nl=jnl, **KW)
    assert r.peak_max.dtype == torch.float32 and r.peak_max.shape == (4, 2)
    assert r.ok.numpy().tolist() == ok.tolist() and ok.all()
    np.testing.assert_allclose(r.peak_max.numpy(), pk, rtol=1e-4)
    np.testing.assert_allclose(r.A_end.numpy(), Af, rtol=0, atol=1e-4 * np.max(np.abs(Af)))


def test_k9_plain_spectral_loss_per_instance_phase_and_nan_lane():
    """tests/test_pallas_vgnlse.py:58-80, 184-207: (2, T) spectral loss with
    (B, 2, T) per-instance phase planes; a lane whose gain overflows float32
    freezes at its last good chunk in both."""
    B, n = 3, 256
    grid, co, A0 = _setup(B=B)
    al_spec = np.abs(np.random.default_rng(7).normal(0.0, 1e-4, size=(2, n)))
    co = tv.make_vgnlse_coeffs(grid, T.DispersionParams.from_betas(1.2e15, beta2=BETA2),
                               gamma_W_m=GAMMA, alpha_1_m=ALPHA, alpha_spec_1_m=al_spec,
                               precision="x32")
    t = _lanes(co, A0)
    phase_b = (t[4][None] * torch.linspace(0.9, 1.1, B)[:, None, None]).contiguous()
    t = t[:4] + (phase_b,)
    r = cv.solve_vgnlse_batch_torch(*t, co.coherent, **KW)
    pk, Af, ok = _jax_kernel(co, A0, lanes=t, **KW)
    assert r.ok.numpy().tolist() == ok.tolist() and ok.all()
    np.testing.assert_allclose(r.A_end.numpy(), Af, rtol=0, atol=1e-4 * np.max(np.abs(Af)))
    _grid, co, A0 = _setup(B=4)
    t = list(_lanes(co, A0))
    t[2] = torch.tensor([ALPHA, ALPHA, -4000.0, ALPHA])
    kw = dict(dz_m=0.1, n_steps=12, save_every=3)
    r = cv.solve_vgnlse_batch_torch(*t, co.coherent, **kw)
    pk, Af, ok = _jax_kernel(co, A0, lanes=t, **kw)
    assert r.ok.numpy().tolist() == ok.tolist() == [True, True, False, True]
    assert torch.isfinite(r.A_end).all()
    good = [0, 1, 3]
    np.testing.assert_allclose(r.A_end.numpy()[good], Af[good], rtol=0,
                               atol=1e-4 * np.max(np.abs(Af[good])))


def test_plain_version_holds_the_save_contract():
    """No steps, fewer steps than one chunk, a trailing span and a
    non-finite input: the state stays at the last saved point, the span
    feeds only ok, a bad input fails without steps."""
    _grid, co, A0 = _setup(B=3, n=128, precision="x64")
    t = _lanes(co, A0, torch.float64)
    for n_steps in (0, 2):
        r = cv.solve_vgnlse_batch_torch(*t, dz_m=0.01, n_steps=n_steps, save_every=3)
        assert torch.equal(r.A_end, t[0]) and r.ok.all()
        assert torch.equal(r.peak_max, (t[0].abs() ** 2).amax(-1))
    r9 = cv.solve_vgnlse_batch_torch(*t, dz_m=0.01, n_steps=9, save_every=3)
    r11 = cv.solve_vgnlse_batch_torch(*t, dz_m=0.01, n_steps=11, save_every=3)
    assert torch.equal(r9.A_end, r11.A_end) and torch.equal(r9.peak_max, r11.peak_max)
    A1 = t[0].clone()
    A1[1, 1, 5] = float("nan")
    r = cv.solve_vgnlse_batch_torch(A1, *t[1:], dz_m=0.01, n_steps=6, save_every=3)
    assert r.ok.tolist() == [True, False, True]
    assert torch.equal(r.A_end[1].isnan(), A1[1].isnan())
    assert bool(r.peak_max[1, 1].isnan()) and not bool(r.peak_max[1, 0].isnan())


# ---------------------------------------------------------------------------
# Host helpers
# ---------------------------------------------------------------------------

def test_factor_planes_are_the_plain_versions():
    grid, co, A0 = _setup(B=3, precision="x64", dbeta0_1_m=0.3)
    A, g, a, b, ph = _lanes(co, A0, torch.float64)
    h = tg._scalar(0.01, A)
    Lh, Lf, stride = cv.factor_planes(a, ph, 0.01, A)
    assert stride == 0 and Lh.shape == (2, 256)               # one shared plane
    assert torch.equal(Lh, tv._lin_factor_v(a, ph, 0.5 * h)[0])
    assert torch.equal(Lf, tv._lin_factor_v(a, ph, h)[0])
    np.testing.assert_allclose(Lf.numpy(), np.exp((-0.5 * ALPHA + 1j * ph.numpy()) * 0.01),
                               rtol=4 * np.finfo(float).eps, atol=0)
    spec = torch.rand(2, 256, dtype=torch.float64) * 1e-3      # shared spectral plane
    Ls, _, stride_s = cv.factor_planes(spec, ph, 0.01, A)
    assert stride_s == 0 and torch.equal(Ls, tv._lin_factor_v(spec, ph, 0.5 * h))
    a2 = a.clone()
    a2[1] = 1e-3                                               # per-instance loss
    Lh2, _, stride2 = cv.factor_planes(a2, ph, 0.01, A)
    assert stride2 == 512 and Lh2.shape == (3, 2, 256)
    assert torch.equal(Lh2, tv._lin_factor_v(a2, ph, 0.5 * h))
    assert torch.equal(Lh2[0], Lh)
    ph3 = ph.broadcast_to((3, 2, 256)).contiguous()            # per-instance phase
    Lh3, _, stride3 = cv.factor_planes(a, ph3, 0.01, A)
    assert stride3 == 512 and torch.equal(Lh3[2], Lh)


@pytest.mark.parametrize("body,n,rdt,want", [
    ("rotation", 256, torch.float64, 8 * (32 + 8 * 256)),
    ("coherent", 2048, torch.float64, 8 * (32 + 8 * 2048)),
    ("nl", 1024, torch.float64, 98_560),
    ("nl", 2048, torch.float32, 4 * (32 + 12 * 2048)),
    ("nl", 2048, torch.float64, 8 * (32 + 12 * 2048)),
    ("nl", 640, torch.float64, 8 * (32 + 12 * 640)),
])
def test_shared_memory_sizes(body, n, rdt, want):
    """Four buffers of T complex values (the state and its transform
    partner, both polarizations) for the rotation and coherent bodies, six
    for nl (the state and a transform pair; its RK4 sums are registers); a
    Hopper block's opt-in limit is 232,448 bytes."""
    assert cv.shared_bytes(n, rdt, body) == want
    msg = cv.shared_memory_problem(n, rdt, body, 232_448)
    assert (msg is None) == (want <= 232_448)
    if msg is not None:
        assert f"{want} bytes" in msg and "allows 232448" in msg
    # a card one byte short refuses the block with the numbers
    msg = cv.shared_memory_problem(n, rdt, body, want - 1)
    assert f"{want} bytes" in msg and f"allows {want - 1}" in msg


# ---------------------------------------------------------------------------
# Dispatch of solve_vgnlse_batch
# ---------------------------------------------------------------------------

class _Props:
    shared_memory_per_block_optin = 232_448


@pytest.fixture
def fake_card(monkeypatch):
    """The shared-memory query of the route, without a card."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Props())
    return torch.device("cuda")


@pytest.mark.parametrize("integrator,coherent,nl,n,rdt,want,msg", [
    ("rk4", 0.0, False, 1024, torch.float64, "vgnlse_ssfm", None),
    ("rk4", 1 / 3, False, 2048, torch.float64, "vgnlse_ssfm", None),
    ("rk4", 0.0, True, 1024, torch.float64, "vgnlse_ssfm", None),
    ("rk4", 1 / 3, True, 2048, torch.float32, "vgnlse_ssfm", None),
    ("rk4", 0.0, True, 2048, torch.float64, "vgnlse_ssfm", None),
    ("rk4", 1 / 3, True, 640, torch.float64, "vgnlse_ssfm", None),
    ("rk4", 0.0, False, 200, torch.float64, None, "multiple of 128"),
    ("rk4", 0.0, False, 4096, torch.float32, None, "too wide"),
    ("rk4ip", 0.0, False, 1024, torch.float64, None, "rk4 only"),
    ("rk45", 0.0, False, 1024, torch.float64, None, "rk4 only"),
    ("rk4ip45", 1 / 3, True, 256, torch.float32, None, "rk4 only"),
])
def test_route_table(fake_card, integrator, coherent, nl, n, rdt, want, msg):
    """Each row of the dispatch table: 'auto' launches the kernel or runs
    the plain version; 'cuda' launches it or raises with the limit in the
    message; 'torch' and the CPU never launch it."""
    nl_t = object() if nl else None
    args = (integrator, nl_t, coherent, n, rdt, fake_card)
    assert tv.vgnlse_kernel_route(*args, "auto") == want
    assert tv.vgnlse_kernel_route(*args, "torch") is None
    if msg is None:
        assert tv.vgnlse_kernel_route(*args, "cuda") == want
    else:
        with pytest.raises(ValueError, match=msg):
            tv.vgnlse_kernel_route(*args, "cuda")
    assert tv.vgnlse_kernel_route(integrator, nl_t, coherent, n, rdt, CPU, "auto") is None


def test_cpu_runs_the_plain_version_and_the_wrapper_refuses_cpu_tensors():
    grid, co, A0 = _setup(B=3, n=128)
    cfg = T.custom_simulation_config(z_max=0.05, dz=0.01, save_every=2, precision="x32")
    launches = dict(_build.LAUNCHES)
    pk, A, ok = tv.solve_vgnlse_batch(cfg, co, A0, device="cpu")
    r = cv.solve_vgnlse_batch_torch(*_lanes(co, A0), dz_m=0.01, n_steps=5, save_every=2)
    assert np.array_equal(A, r.A_end.numpy().astype(np.complex128)) and ok.all()
    assert np.array_equal(pk, r.peak_max.numpy().astype(np.float64))
    t = _lanes(co, A0)
    with pytest.raises(ValueError, match="CUDA"):
        cv.solve_vgnlse_batch_cuda(*t, dz_m=0.01, n_steps=5, save_every=2)
    with pytest.raises(ValueError, match="lin_phase"):
        cv.solve_vgnlse_batch_torch(*t[:4], t[4][:, :100].contiguous(), dz_m=0.01, n_steps=5,
                                    save_every=2)
    with pytest.raises(ValueError, match="b_xpm"):
        cv.solve_vgnlse_batch_torch(*t[:3], t[3].double(), t[4], dz_m=0.01, n_steps=5,
                                    save_every=2)
    with pytest.raises(ValueError, match=r"\(B, 2, T\)"):
        cv.solve_vgnlse_batch_torch(t[0][:, 0], *t[1:], dz_m=0.01, n_steps=5, save_every=2)
    assert dict(_build.LAUNCHES) == launches
    assert (cv.body_of(0.0, None), cv.body_of(1 / 3, None), cv.body_of(0.0, object())) == \
        ("rotation", "coherent", "nl")
    # the JAX kernel's width refusal, for reference
    _g, co_w, A0_w = _setup(B=2, n=200)
    with pytest.raises(ValueError, match="multiple of 128"):
        _jax_kernel(co_w, A0_w, **KW)
