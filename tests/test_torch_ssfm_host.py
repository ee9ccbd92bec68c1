"""Every body of csrc/gnlse_ssfm.cu (K6: Kerr and nl) and csrc/vgnlse_ssfm.cu
(K9: rotation, coherent and nl), the LLE kernel csrc/lle_ssfm.cu (K7) and both
routes of csrc/ssfm_rk45.cu (K8),
compiled as host C++ with each block's
threads run as host threads (``ssfm_host_rehearsal.py``: ``__syncthreads`` a
``std::barrier``), against their plain versions on the CPU.  The CUDA kernels
themselves run only on the card (``tests/test_torch_kernel.py``); this holds
their source's arithmetic, the threads' ownership of samples and the barriers
between the wide transform's passes to the plain versions here.  Needs g++
with C++20."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import ssfm_host_rehearsal as host
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import gnlse as tg
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import lle as tl
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import vgnlse as tv
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_gnlse as cg
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_lle as cl
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_ssfm_adaptive as csa
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_vgnlse as cv
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops.dispersion import DispersionParams

# fp64 to rounding; fp32 against the plain fp32 version (cuFFT's and the
# kernel's transforms round differently)
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CDT = {torch.float64: torch.complex128, torch.float32: torch.complex64}
DISP = DispersionParams.from_betas(1.2e15, beta2=-2e-26)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host build of the kernels needs g++")
    out = tmp_path_factory.mktemp("host_kernels")
    return {name: host.build(name, out)
            for name in ("gnlse_ssfm", "lle_ssfm", "vgnlse_ssfm", "ssfm_rk45")}


def _pulses(n, B):
    grid = tg.TimeGrid.for_pulse(1e-12, n_samples=n)
    P0 = tg.soliton_peak_power(-2e-26, 2e-3, 1e-12)
    A = np.sqrt(np.linspace(0.5, 1.5, B) * P0)[:, None] / np.cosh(grid.t()[None, :] / 1e-12)
    return grid, A.astype(np.complex128)


def _check(k, p, bad, rdt):
    assert k[2].tolist() == p.ok.tolist() and not bool(k[2][bad])
    good = p.ok
    dims = tuple(range(1, p.A_end.ndim))
    err = ((k[1][good] - p.A_end[good]).abs().amax(dims) / p.A_end[good].abs().amax(dims)).max()
    assert float(err) <= TOL[rdt]
    torch.testing.assert_close(k[0][good], p.peak_max[good], rtol=TOL[rdt], atol=0)


# The slotted Strang bodies (csrc/strang.cuh) at r = 1 and 3, 4 samples a
# thread (n = 128: one warp; 1,024: 256 threads) and 8 (n = 2,048)
STRANG_WIDTHS = [128, 384, 1024, 2048]


def _overflowing(A0, rdt, bad):
    """A0 with envelope ``bad`` scaled so that |A|^2 overflows the type: it
    starts finite and fails in its first chunk."""
    A0 = A0.copy()
    A0[bad] *= 1e160 if rdt == torch.float64 else 1e25
    return A0


# (n, threads, samples a thread, passes a transform) of the Strang block:
# 4 samples a thread up to n = 1,024, 8 above, at most 256 threads; a radix-2
# pass when log2 of n's power of two is odd, the r-odd tail
STRANG_BLOCKS = [(128, 32, 4, 4), (384, 96, 4, 5), (640, 160, 4, 5), (1024, 256, 4, 5),
                 (2048, 256, 8, 6), (4096, 0, 8, 6)]


@pytest.mark.parametrize("source", ["gnlse_ssfm", "vgnlse_ssfm"])
@pytest.mark.parametrize("n,threads,slots,passes", STRANG_BLOCKS)
def test_strang_block_is_the_launched_block(libs, source, n, threads, slots, passes):
    """``<source>_strang_block``, which the launchers take their block
    from and ``chip_smoke.py`` reports, at each width class."""
    fn = getattr(libs[source], f"{source}_strang_block")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    s, p = ctypes.c_int(), ctypes.c_int()
    assert (fn(n, ctypes.byref(s), ctypes.byref(p)), s.value, p.value) == (threads, slots, passes)


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("rows", [False, True], ids=["shared", "rows"])
@pytest.mark.parametrize("n", STRANG_WIDTHS)
def test_gnlse_kerr_route_matches_plain_version(libs, rdt, rows, n):
    """K6 Kerr on the slotted Strang body: a shared factor row or one row
    an envelope (per-envelope phase), one envelope overflowing (frozen at
    its input), 10 steps at save_every=4 (a trailing partial chunk)."""
    grid, A0 = _pulses(n, 3)
    co = tg.make_gnlse_coeffs(grid, DISP, gamma_W_m=2e-3, alpha_1_m=5e-5)
    g, a, ph = tg.lane_coeffs(co, 3, n, rdt, "cpu")
    if rows:
        ph = (ph[None] * torch.linspace(0.9, 1.1, 3, dtype=rdt)[:, None]).contiguous()
    assert cg.factor_planes(a, ph, 0.02, torch.zeros(3, n))[2] == (n if rows else 0)
    y0 = torch.as_tensor(_overflowing(A0, rdt, 1)).to(CDT[rdt])
    k = host.k6(libs["gnlse_ssfm"], y0, g, a, ph, None, 0.02, 10, 4)
    p = cg.solve_gnlse_batch_torch(y0, g, a, ph, dz_m=0.02, n_steps=10, save_every=4)
    _check(k, p, 1, rdt)
    assert torch.equal(k[1][1], y0[1])


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("rows", [False, True], ids=["shared", "rows"])
@pytest.mark.parametrize("n", STRANG_WIDTHS)
@pytest.mark.parametrize("coupling", ["manakov", "cnlse", "isotropic"])
def test_vgnlse_strang_bodies_match_plain_version(libs, coupling, rdt, rows, n):
    """K9's rotation body (manakov, cnlse with birefringence) and coherent
    body (isotropic) on the slotted Strang body: a shared factor plane or
    one an instance, one instance overflowing (frozen at its input), 10
    steps at save_every=4 (a trailing partial chunk)."""
    grid, A = _pulses(n, 3)
    A0 = np.stack([np.cos(0.4) * A, np.sin(0.4) * np.exp(0.5j) * A], axis=1)
    bire = {} if coupling == "manakov" else dict(dbeta0_1_m=8.0, dbeta1_s_m=1e-13)
    co = tv.make_vgnlse_coeffs(grid, DISP, gamma_W_m=2e-3, alpha_1_m=5e-5, coupling=coupling,
                               **bire)
    g, a, b, ph = tv.lane_coeffs(co, 3, n, rdt, "cpu")
    if rows:
        ph = (ph[None] * torch.linspace(0.9, 1.1, 3, dtype=rdt)[:, None, None]).contiguous()
    assert cv.body_of(co.coherent, None) == ("coherent" if coupling == "isotropic" else "rotation")
    y0 = torch.as_tensor(_overflowing(A0, rdt, 1)).to(CDT[rdt])
    k = host.k9(libs["vgnlse_ssfm"], y0, g, a, b, ph, co.coherent, None, 0.02, 10, 4)
    p = cv.solve_vgnlse_batch_torch(y0, g, a, b, ph, co.coherent, dz_m=0.02, n_steps=10,
                                    save_every=4)
    _check(k, p, 1, rdt)
    assert torch.equal(k[1][1], y0[1])


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("coupling", ["manakov", "cnlse"])
@pytest.mark.parametrize("n", [384, 1024])
def test_vgnlse_rotation_with_an_empty_polarization_is_the_gnlse_kerr_route(libs, coupling,
                                                                            rdt, n):
    """A_y = 0, no birefringence: K9's rotation body gives K6 Kerr's
    outputs on A_x bit for bit, both types (each polarization goes through
    the Strang body's passes with the operations of K6's one, and the angle
    with P_y = 0 is K6's), and A_y stays 0."""
    grid, A = _pulses(n, 3)
    A0 = np.stack([A, np.zeros_like(A)], axis=1)
    co = tv.make_vgnlse_coeffs(grid, DISP, gamma_W_m=2e-3, alpha_1_m=5e-5, coupling=coupling)
    g, a, b, ph = tv.lane_coeffs(co, 3, n, rdt, "cpu")
    y0 = torch.as_tensor(A0).to(CDT[rdt])
    kv = host.k9(libs["vgnlse_ssfm"], y0, g, a, b, ph, co.coherent, None, 0.02, 10, 4)
    ks = host.k6(libs["gnlse_ssfm"], y0[:, 0].contiguous(), g, a, ph[0].contiguous(), None,
                 0.02, 10, 4)
    assert bool(kv[2].all()) and torch.equal(kv[2], ks[2])
    assert torch.equal(kv[1][:, 0], ks[1]) and torch.equal(kv[0][:, 0], ks[0])
    assert not bool(kv[1][:, 1].abs().any())


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [128, 384])
def test_gnlse_nl_body_matches_plain_version(libs, rdt, n):
    """K6 nl with Raman and steepening, r = 1 and r = 3, one envelope
    overflowing, 10 steps at save_every=4 (a trailing partial chunk)."""
    grid, A0 = _pulses(n, 3)
    co = tg.make_gnlse_coeffs(grid, DISP, gamma_W_m=2e-3, alpha_1_m=5e-5)
    g, a, ph = tg.lane_coeffs(co, 3, n, rdt, "cpu")
    a = a.clone()
    a[1] = -4e6
    nl = tg._cast_nl(tg.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15), rdt, "cpu")
    y0 = torch.as_tensor(A0).to(CDT[rdt])
    k = host.k6(libs["gnlse_ssfm"], y0, g, a, ph, nl, 0.02, 10, 4)
    p = cg.solve_gnlse_batch_torch(y0, g, a, ph, dz_m=0.02, n_steps=10, save_every=4, nl=nl)
    _check(k, p, 1, rdt)
    assert torch.equal(k[1][1], y0[1])


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [128, 384, 640])
def test_vgnlse_nl_body_matches_plain_version(libs, rdt, n):
    """K9 nl on the isotropic coupling (its coherent term) with Raman and
    steepening, per-instance factor planes, one instance overflowing; at
    n = 640 in fp64 a block of 96 threads, 8 samples a thread."""
    grid, A = _pulses(n, 3)
    A0 = np.stack([np.cos(0.4) * A, np.sin(0.4) * np.exp(0.5j) * A], axis=1)
    co = tv.make_vgnlse_coeffs(grid, DISP, gamma_W_m=2e-3, alpha_1_m=5e-5, coupling="isotropic",
                               dbeta0_1_m=8.0)
    g, a, b, ph = tv.lane_coeffs(co, 3, n, rdt, "cpu")
    a = a.clone()
    a[1] = -4e6
    ph = (ph[None] * torch.linspace(0.9, 1.1, 3, dtype=rdt)[:, None, None]).contiguous()
    nl = tg._cast_nl(tg.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15), rdt, "cpu")
    y0 = torch.as_tensor(A0).to(CDT[rdt])
    k = host.k9(libs["vgnlse_ssfm"], y0, g, a, b, ph, co.coherent, nl, 0.02, 10, 4)
    p = cv.solve_vgnlse_batch_torch(y0, g, a, b, ph, co.coherent, dz_m=0.02, n_steps=10,
                                    save_every=4, nl=nl)
    _check(k, p, 1, rdt)
    assert torch.equal(k[1][1], y0[1])


def test_vgnlse_nl_body_with_an_empty_polarization_is_the_gnlse_nl_body(libs):
    """A_y = 0 on the cnlse coupling: K9's nl body is K6's on A_x at the same
    gamma, f_R and 1/omega_0, to rounding (the two form W in another order),
    and A_y stays 0."""
    n = 256
    grid, A = _pulses(n, 2)
    A0 = np.stack([A, np.zeros_like(A)], axis=1)
    co = tv.make_vgnlse_coeffs(grid, DISP, gamma_W_m=2e-3, alpha_1_m=5e-5, coupling="cnlse")
    g, a, b, ph = tv.lane_coeffs(co, 2, n, torch.float64, "cpu")
    nl = tg._cast_nl(tg.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15), torch.float64, "cpu")
    y0 = torch.as_tensor(A0)
    kv = host.k9(libs["vgnlse_ssfm"], y0, g, a, b, ph, co.coherent, nl, 0.02, 8, 4)
    ks = host.k6(libs["gnlse_ssfm"], y0[:, 0].contiguous(), g, a, ph[0].contiguous(), nl, 0.02,
                 8, 4)
    assert not bool(kv[1][:, 1].abs().any()) and bool(kv[2].all())
    err = ((kv[1][:, 0] - ks[1]).abs().amax(-1) / ks[1].abs().amax(-1)).max()
    assert float(err) <= 1e-13


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("rows", [False, True], ids=["shared_phase", "phase_rows"])
@pytest.mark.parametrize("n", [256, 384, 512, 1024, 2048])
@pytest.mark.parametrize("n_steps", [12, 14])
def test_lle_kernel_matches_plain_version(libs, rdt, rows, n, n_steps):
    """K7 at r = 1 and r = 3 (n = 384), the width's own block: 64 threads a
    cavity at n = 256, 128 at 512, 256 at 1,024 (4 samples a thread) and
    2,048 (8 samples a thread).  Soliton-ansatz cavities with a complex
    pump, one cavity whose |psi|^2 overflows (frozen at its input), 12 and
    14 steps at save_every=4 (a trailing partial chunk)."""
    grid = tl.TimeGrid(n_samples=n, t_window_s=20.0)
    dets = np.linspace(3.5, 4.5, 3)
    co = tl.make_lle_coeffs(grid, detuning=dets, pump=2.2 * np.exp(0.3j), d2=-1.0)
    psi0 = np.stack([tl.soliton_ansatz(grid, d, 2.2, -1.0) for d in dets])
    psi0[1] *= 1e160 if rdt == torch.float64 else 1e25
    det, F, ph = tl.lane_coeffs(co, 3, n, rdt, "cpu")
    if rows:
        ph = (ph[None] * torch.linspace(0.8, 1.2, 3, dtype=rdt)[:, None]).contiguous()
    y0 = torch.as_tensor(psi0).to(CDT[rdt])
    k = host.k7(libs["lle_ssfm"], y0, det, F, ph, 0.01, n_steps, 4)
    p = cl.solve_lle_batch_torch(y0, det, F, ph, dt=0.01, n_steps=n_steps, save_every=4)
    _check(k, p, 1, rdt)
    assert torch.equal(k[1][1], y0[1])


def _check_rk45(k, p, bad, rdt):
    """K8 against its plain version: the same ok, the bad lane failed, in
    fp64 the same counters on every lane."""
    assert k[2].tolist() == p.ok.tolist() and not bool(k[2][bad])
    if rdt == torch.float64:
        assert torch.equal(k[3], p.n_accepted) and torch.equal(k[4], p.n_rejected)
    good = p.ok
    err = ((k[1][good] - p.A_end[good]).abs().amax(-1) / p.A_end[good].abs().amax(-1)).max()
    assert float(err) <= TOL45[rdt]
    torch.testing.assert_close(k[0][good], p.peak_max[good], rtol=TOL45[rdt], atol=0)


# K8: fp64 to rounding; fp32 against the plain fp32 version at the card
# test's bar (tests/test_torch_kernel.py): the two may take other steps
TOL45 = {torch.float64: 1e-12, torch.float32: 1e-4}
RK45_TOL = {torch.float64: (1e-8, 1e-11), torch.float32: (1e-5, 1e-8)}


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [256, 384])
def test_ssfm_rk45_lle_route_matches_plain_version(libs, rdt, n):
    """K8's LLE route, r = 1 and r = 3, soliton-ansatz cavities with a
    complex pump, one cavity overflowing (rejected to dt_min), 3 steps at
    save_every=2 (a trailing span)."""
    grid = tl.TimeGrid(n_samples=n, t_window_s=20.0)
    dets = np.linspace(3.6, 4.4, 3)
    co = tl.make_lle_coeffs(grid, detuning=dets, pump=2.0 * np.exp(0.3j), d2=-1.0)
    psi0 = np.stack([tl.soliton_ansatz(grid, d, 2.0, -1.0) for d in dets])
    psi0[1] *= 1e160 if rdt == torch.float64 else 1e25
    det, F, ph = tl.lane_coeffs(co, 3, n, rdt, "cpu")
    y0 = torch.as_tensor(psi0).to(CDT[rdt])
    rtol, atol = RK45_TOL[rdt]
    kw = dict(dt=0.004, n_steps=3, save_every=2, rtol=rtol, atol=atol)
    k = host.k8(libs["ssfm_rk45"], y0, det, F, ph, kw["dt"], 3, 2, rtol, atol)
    p = csa.solve_lle_batch_rk45_torch(y0, det, F, ph, **kw)
    _check_rk45(k, p, 1, rdt)
    assert int(k[3][1]) == 0 and int(k[4][1]) > 0


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [256, 384])
def test_ssfm_rk45_gnlse_route_matches_plain_version(libs, rdt, n):
    """K8's GNLSE route, r = 1 and r = 3, per-envelope phase rows, one
    envelope 1e12 times too strong, 12 steps at save_every=5."""
    grid, A0 = _pulses(n, 3)
    A0[1] *= 1e12
    co = tg.make_gnlse_coeffs(grid, DISP, gamma_W_m=2e-3, alpha_1_m=5e-5)
    g, a, ph = tg.lane_coeffs(co, 3, n, rdt, "cpu")
    ph = (ph[None] * torch.linspace(0.9, 1.1, 3, dtype=rdt)[:, None]).contiguous()
    y0 = torch.as_tensor(A0).to(CDT[rdt])
    rtol, atol = (1e-9, 1e-12) if rdt == torch.float64 else (1e-5, 1e-9)
    kw = dict(dz_m=0.05, n_steps=12, save_every=5, rtol=rtol, atol=atol)
    k = host.k8_gnlse(libs["ssfm_rk45"], y0, g, a, ph, 0.05, 12, 5, rtol, atol)
    p = csa.solve_gnlse_batch_rk45_torch(y0, g, a, ph, **kw)
    _check_rk45(k, p, 1, rdt)
