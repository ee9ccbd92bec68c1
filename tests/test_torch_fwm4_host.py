"""csrc/fwm4_rk.cu (K1/K2) and csrc/fwm4_rk45.cu (K3), compiled as host C++
with each block's threads run as host threads (``ssfm_host_rehearsal.py``:
``__shfl_sync`` exchanges within its mask's group of a warp's threads, at a
barrier of that group), against their plain versions on the CPU.  The CUDA
kernels themselves run only on the card (``tests/test_torch_kernel.py``);
this holds their sources' spreading of a lane over a group of threads -- the
waves each thread owns, the shuffled couplings of the RHS, the group's
error norm and finiteness -- to the plain versions here.

K1/K2 run a lane on one thread.  K3's launcher picks the threads a lane
from the batch and the card's SM count: the stub's card reports an H100's
132 SMs, where 130 lanes run 4 threads a lane, or 0 SMs, where every batch
fills the card and a lane runs on one thread.  130 lanes are not a multiple
of a block's lanes, lane 7 blows up, and delta beta spans -1.66 to 1.5 /m.
Needs g++ with C++20."""

import shutil

import pytest
import torch

import ssfm_host_rehearsal as host
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_adaptive as ca
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_solver as cs

B, BAD = 130, 7
# SM counts of the stub's card: 132 gives a lane 4 threads at B = 130, 0 one
GROUPS = {4: 132, 1: 0}
RDT = [torch.float64, torch.float32]
RDT_IDS = ["f64", "f32"]
# K1/K2 against the plain version: fp64 to rounding, fp32 the card test's bar
TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
# K3 at the card test's tolerances (tests/test_torch_kernel.py)
RK45_TOL = {torch.float64: (1e-10, 1e-13), torch.float32: (1e-6, 1e-10)}
# a save grid whose segment, 7 x 2^-5 m, and its multiples are exact, so the
# plain version's segments are the kernel's to the bit
DZ45 = 2.0 ** -5


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host build of the kernels needs g++")
    return tmp_path_factory.mktemp("host_kernels")


@pytest.fixture(scope="module")
def lib(out):
    return host.build("fwm4_rk", out)


@pytest.fixture(scope="module")
def lib45(out):
    return host.build("fwm4_rk45", out)


def _rel(a, b):
    return float(((a - b).abs() / b.abs().clamp_min(torch.finfo(b.real.dtype).tiny)).max())


@pytest.mark.parametrize("rdt", RDT, ids=RDT_IDS)
@pytest.mark.parametrize("method", ["rk4", "ab4", "abm4"])
@pytest.mark.parametrize("n_steps", [250, 253])
def test_fwm4_kernel_matches_plain_version(lib, rdt, method, n_steps):
    """Every lane within the bar, the bad lane frozen finite with ok clear;
    253 steps leave a trailing partial interval at save_every=7."""
    t = host.fwm4_lanes(B, rdt, bad=BAD)
    rk = host.k1(lib, *t, 0.2, n_steps, 7, method)
    rp = cs.solve_batch_torch(*t, dz_m=0.2, n_steps=n_steps, save_every=7, integrator=method)
    assert torch.equal(rk.ok, rp.ok) and not bool(rk.ok[BAD]) and int(rk.ok.sum()) == B - 1
    assert torch.isfinite(rk.P_max).all() and torch.isfinite(rk.A_end).all()
    assert _rel(rk.P_max, rp.P_max) <= TOL[rdt]
    assert _rel(rk.A_end, rp.A_end) <= TOL[rdt]


@pytest.mark.parametrize("rdt", RDT, ids=RDT_IDS)
def test_fwm4_kernel_check_nan_off(lib, rdt):
    """With check_nan off no lane freezes: ok stays set, the bad lane runs
    on to non-finite values, the others match the plain version."""
    t = host.fwm4_lanes(B, rdt, bad=BAD)
    rk = host.k1(lib, *t, 0.2, 250, 10, "rk4", check_nan=False)
    rp = cs.solve_batch_torch(*t, dz_m=0.2, n_steps=250, save_every=10, check_nan=False)
    assert bool(rk.ok.all()) and not bool(torch.isfinite(rk.A_end[BAD]).all())
    rest = torch.arange(B) != BAD
    assert _rel(rk.A_end[rest], rp.A_end[rest]) <= TOL[rdt]


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("rdt", RDT, ids=RDT_IDS)
@pytest.mark.parametrize("n_steps", [250, 253])
def test_fwm4_rk45_kernel_matches_plain_version_bit_for_bit(lib45, group, rdt, n_steps):
    """The same steps and the same outputs bit for bit in both types: equal
    counters and ok flags on every lane, P_max and A_end equal.  253 steps
    leave a trailing span at save_every=7.  The plain version runs with the
    host build's sqrt and pow (``host_libm``)."""
    rtol, atol = RK45_TOL[rdt]
    t = host.fwm4_lanes(B, rdt, bad=BAD)
    with host.sm_count(lib45, GROUPS[group]):
        assert lib45.fwm4_rk45_group(B) == group
        rk = host.k3(lib45, *t, DZ45, n_steps, 7, rtol, atol)
    with host.host_libm():
        rp = ca.solve_batch_rk45_torch(*t, dz_m=DZ45, n_steps=n_steps, save_every=7, rtol=rtol,
                                       atol=atol)
    assert torch.equal(rk.ok, rp.ok) and not bool(rk.ok[BAD]) and int(rk.ok.sum()) == B - 1
    assert torch.equal(rk.n_accepted, rp.n_accepted) and torch.equal(rk.n_rejected, rp.n_rejected)
    assert bool((rk.n_accepted[BAD + 1:] > 0).all())
    assert torch.equal(rk.P_max, rp.P_max) and torch.equal(rk.A_end, rp.A_end)


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("lanes,n_steps", [(1, 0), (1, 5), (3, 12), (B, 5)])
def test_fwm4_rk45_kernel_edge_shapes(lib45, group, lanes, n_steps):
    """One lane, no steps, fewer steps than one save interval (the trailing
    span only: the saved outputs stay the initial values, the span still
    feeds ok and the counters), bit for bit with the plain version."""
    t = tuple(x[-lanes:] for x in host.fwm4_lanes(B, torch.float64, bad=BAD))
    with host.sm_count(lib45, GROUPS[group]):
        rk = host.k3(lib45, *t, DZ45, n_steps, 7, 1e-10, 1e-13)
    with host.host_libm():
        rp = ca.solve_batch_rk45_torch(*t, dz_m=DZ45, n_steps=n_steps, save_every=7, rtol=1e-10,
                                       atol=1e-13)
    assert torch.equal(rk.ok, rp.ok) and int(rk.ok.sum()) == lanes - (lanes > BAD)
    assert torch.equal(rk.n_accepted, rp.n_accepted) and torch.equal(rk.n_rejected, rp.n_rejected)
    assert torch.equal(rk.P_max, rp.P_max) and torch.equal(rk.A_end, rp.A_end)
    if n_steps < 7:
        assert torch.equal(rk.A_end, t[0])
    assert (n_steps == 0) == (int(rk.n_accepted.sum()) == 0)


@pytest.mark.parametrize("group", list(GROUPS))
def test_fwm4_rk45_kernel_max_steps_exhaustion(lib45, group):
    """A lane that cannot finish a segment within max_steps attempts fails,
    in the kernel as in the plain version."""
    t = host.fwm4_lanes(B, torch.float64, bad=BAD)
    kw = dict(dz_m=0.2, n_steps=50, save_every=10, rtol=1e-10, atol=1e-13, max_steps=2)
    with host.sm_count(lib45, GROUPS[group]):
        rk = host.k3(lib45, *t, 0.2, 50, 10, 1e-10, 1e-13, max_steps=2)
    rp = ca.solve_batch_rk45_torch(*t, **kw)
    assert not bool(rk.ok.any()) and torch.equal(rk.ok, rp.ok)
    assert torch.equal(rk.n_accepted, rp.n_accepted) and torch.equal(rk.n_rejected, rp.n_rejected)
