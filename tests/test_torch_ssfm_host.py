"""The nl bodies of csrc/gnlse_ssfm.cu (K6) and csrc/vgnlse_ssfm.cu (K9),
compiled as host C++ with each block's threads run as host threads
(``ssfm_host_rehearsal.py``: ``__syncthreads`` a ``std::barrier``), against
their plain versions on the CPU.  The CUDA kernels themselves run only on the
card (``tests/test_torch_kernel.py``); this holds their source's arithmetic,
the threads' ownership of samples and the barriers between the wide
transform's passes to the plain versions here.  Needs g++ with C++20."""

import shutil

import numpy as np
import pytest
import torch

import ssfm_host_rehearsal as host
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import gnlse as tg
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import vgnlse as tv
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_gnlse as cg
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
    return {name: host.build(name, out) for name in ("gnlse_ssfm", "vgnlse_ssfm")}


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
