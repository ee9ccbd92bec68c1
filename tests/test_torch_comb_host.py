"""csrc/comb_rk.cu (K4) and csrc/comb_rk45.cu (K5), compiled as host C++ with
each block's threads run as host threads (``ssfm_host_rehearsal.py``:
``__syncwarp`` a barrier of the warp's threads, ``__all_sync`` an AND over
them), against their plain versions on the CPU.  The CUDA kernels themselves
run only on the card (``tests/test_torch_kernel.py``); this holds their
sources' FFT coupling, the threads' ownership of lines, K5's stages and error
norm and the barriers between the passes to the plain versions here, whose cubic
sum is the kernels' arithmetic (``ops/cuda_comb.kernel_polarization``).
Needs g++ with C++20."""

import shutil

import numpy as np
import pytest
import torch

import ssfm_host_rehearsal as host
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import nwave as tn
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_comb as cc
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_comb_adaptive as cca
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops.dispersion import DispersionParams

# fp64 to rounding; fp32 the card test's bar (tests/test_torch_kernel.py)
TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
CDT = {torch.float64: torch.complex128, torch.float32: torch.complex64}


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host build of the kernels needs g++")
    return tmp_path_factory.mktemp("host_kernels")


@pytest.fixture(scope="module")
def lib(out):
    return host.build("comb_rk", out)


@pytest.fixture(scope="module")
def lib45(out):
    return host.build("comb_rk45", out)


def _combs(N, B, rdt, bad, spacing_hz=50e9):
    """bench_comb.py's comb at N lines (pumps at N/4 and 3N/4), 50 GHz apart
    unless ``spacing_hz`` says otherwise, over a gamma grid; comb ``bad``
    blows up in its first step."""
    oc = 2 * np.pi * 193.1e12
    grid = tn.CombGrid.centered(oc, 2 * np.pi * spacing_hz, N)
    beta = tn.comb_beta_lin(grid, DispersionParams.from_betas(oc, beta2=-1e-27, beta3=1.2e-41))
    A0 = np.broadcast_to(tn.seed_comb(grid, pump_lines={N // 4: 0.5, 3 * N // 4: 0.5},
                                      noise_floor_W=1e-9), (B, N)).copy()
    g = np.linspace(5e-3, 15e-3, B)
    A0[bad] *= 1e3
    g[bad] = 1e3
    return (torch.as_tensor(A0).to(CDT[rdt]),
            *(torch.as_tensor(np.ascontiguousarray(v), dtype=rdt)
              for v in (g, np.full(B, 5e-5), np.broadcast_to(beta, (B, N)))))


def _normwise(a, b):
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("method", ["rk4", "ab4", "abm4"])
@pytest.mark.parametrize("N", [16, 33, 64])
def test_comb_kernel_matches_plain_version(lib, rdt, method, N):
    """One warp a comb on a 128-point transform, 23 steps at save_every=10
    (a trailing partial interval), the bad comb frozen at its input."""
    t = _combs(N, 4, rdt, bad=2)
    kw = dict(dz_m=5.0, n_steps=23, save_every=10, integrator=method)
    pk, A, ok = host.k4(lib, *t, 5.0, 23, 10, method)
    p = cc.solve_comb_batch_torch(*t, **kw)
    assert ok.tolist() == p.ok.tolist() == [True, True, False, True]
    assert torch.equal(A[2], t[0][2])
    good = p.ok
    assert _normwise(A[good], p.A_end[good]) <= TOL[rdt]
    assert _normwise(pk[good], p.P_max[good]) <= TOL[rdt]


def test_comb_kernel_wide_route_and_check_nan_off(lib):
    """N = 100: a block of 64 threads on a 256-point transform, fp64; with
    check_nan off the bad comb runs on and ok stays set."""
    t = _combs(100, 3, torch.float64, bad=1)
    pk, A, ok = host.k4(lib, *t, 5.0, 12, 5, "abm4")
    p = cc.solve_comb_batch_torch(*t, dz_m=5.0, n_steps=12, save_every=5, integrator="abm4")
    assert ok.tolist() == p.ok.tolist() == [True, False, True]
    assert _normwise(A[p.ok], p.A_end[p.ok]) <= 1e-12
    pk, A, ok = host.k4(lib, *t, 5.0, 12, 5, "rk4", check_nan=False)
    assert bool(ok.all()) and not bool(torch.isfinite(A[1]).all())


# K5 against its plain version at the card test's tolerances: fp64 rtol 1e-9,
# fp32 rtol 1e-6; the same steps on every comb in both, the results held to
# rounding in fp64 and to the card check's 1e-3 in fp32
RK45_TOL = {torch.float64: (1e-9, 1e-12), torch.float32: (1e-6, 1e-10)}
TOL45 = {torch.float64: 1e-12, torch.float32: 1e-3}
# every route: one warp a comb on a 128-point transform up to N = 64, a block
# of 64 threads on a 256-point one at N = 100, 256 threads at 4 lines a thread
# (N = 600, 2,048 points) and, in fp32 only (the fp64 block does not fit in
# shared memory), at 8 lines a thread (N = 1,100, 4,096 points)
K5_CASES = [(N, rdt) for N in (16, 33, 64, 100, 600) for rdt in (torch.float64, torch.float32)] \
    + [(1100, torch.float32)]


@pytest.mark.parametrize("N,rdt", K5_CASES,
                         ids=[f"{'f64' if r == torch.float64 else 'f32'}-{N}" for N, r in K5_CASES])
def test_comb_rk45_kernel_matches_plain_version(lib45, rdt, N):
    """23 steps at save_every=10 (a trailing span), at most 400 attempts a
    segment; the combs of 600 lines and more 10 GHz apart, so that their
    outer lines' dispersion leaves the host build a few hundred attempts.
    The same ok flags and counters on every comb, the failed one included,
    and every comb's results within the bar; in fp64 the failed comb stays
    at its input.  The plain version runs with the host build's sqrt and
    pow (``host_libm``), as it runs with the kernel's on the card."""
    t = _combs(N, 4, rdt, bad=2, spacing_hz=50e9 if N <= 100 else 10e9)
    rtol, atol = RK45_TOL[rdt]
    kw = dict(dz_m=5.0, n_steps=23, save_every=10, rtol=rtol, atol=atol, max_steps=400)
    pk, A, ok, na, nr = host.k5(lib45, *t, 5.0, 23, 10, rtol, atol, max_steps=400)
    with host.host_libm():
        p = cca.solve_comb_batch_rk45_torch(*t, **kw)
    assert ok.tolist() == p.ok.tolist() == [True, True, False, True]
    assert torch.equal(na, p.n_accepted) and torch.equal(nr, p.n_rejected)
    if rdt == torch.float64:
        assert torch.equal(A[2], t[0][2])
    assert _normwise(A, p.A_end) <= TOL45[rdt]
    assert _normwise(pk, p.P_max) <= TOL45[rdt]
