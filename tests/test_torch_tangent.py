"""The 4-wave RK4 in tangent mode (``ops/cuda_tangent.py``, the plain
version of ``csrc/fwm4_tangent.cu``) on the CPU.

- The autograd Function passes ``torch.autograd.gradcheck`` in float64 for
  the coefficients, the initial state and both (B = 3, 10 steps): torch's
  convention for complex gradients (dL/dRe + i dL/dIm) is settled here.
- The plain version's tangents equal ``torch.autograd.functional.jacobian``
  of the plain RK4 (``integrate_reduce`` with ``check_nan=False``) within
  1e-12 of each lane's largest entry, and its state follows that RK4 to
  the bit.
- The kernel's source, compiled as host C++ (``ssfm_host_rehearsal.py``'s
  stub, one host thread a CUDA thread), against the plain version: fp64
  within 1e-13, fp32 against the fp64 plain version within 1e-4 (the chip's
  bars are 1e-11 / 1e-10 and 1e-4).
- Its two designs, a (lane, direction) on a group of 4 threads and on one,
  each through its own launcher of that build (130 lanes, 3 and 11
  directions): the group gives the one thread's bits in fp64 and fp32 and
  is held to the plain version at the bars above; the launcher by width
  takes the group below ``kLaneDirsPerSM`` (lane, direction)s an SM of the
  stub's card and one thread from there on, with the same bits.
- A CPU tensor takes the plain version and counts no launch; the kernel's
  wrapper refuses CPU tensors.

The kernel itself runs only on the card (``tests/test_torch_kernel.py``,
``chip_smoke.py`` phase 29)."""

import ctypes
import functools
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ssfm_host_rehearsal as host  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_tangent as ct  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops.integrators import integrate_reduce  # noqa: E402,E501
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops.rhs import (  # noqa: E402
    RHSCoeffs,
    rhs_yaman_autonomous,
)


def _lanes(B, seed=0, rdt=torch.float64):
    """(coef (3, B), y0 (8, B)): gamma 5e-3..2e-2 /(W m), alpha to 1e-3 /m,
    delta beta +-0.05 /m, two 0.5 W pumps, a signal and an idler, random
    phases."""
    rng = np.random.default_rng(seed)
    coef = np.stack([rng.uniform(5e-3, 2e-2, B), rng.uniform(0.0, 1e-3, B),
                     rng.uniform(-0.05, 0.05, B)])
    A = np.sqrt([0.5, 0.5, 1e-5, 1e-6]) * np.exp(1j * rng.uniform(0.0, 6.0, (B, 4)))
    return (torch.tensor(coef, dtype=rdt),
            torch.tensor(np.concatenate([A.real.T, A.imag.T]), dtype=rdt).contiguous())


def _plain_rk4(coef, y0, dz, n_steps):
    """The plain RK4 end state, ``(8, B)``, as the 4-wave solvers run it."""
    A0 = torch.complex(y0[:4].T, y0[4:].T)
    res = integrate_reduce(rhs_yaman_autonomous, A0, RHSCoeffs(coef[0], coef[1], coef[2]),
                           z0=0.0, dz=dz, n_steps=n_steps, save_every=n_steps,
                           reduce_init=None, reduce_fn=lambda acc, _y: acc, check_nan=False,
                           batch_ndim=1)
    return torch.cat([res.y_final.real.T, res.y_final.imag.T])


@pytest.mark.parametrize("wrt", ["coef", "y0", "both"])
def test_the_function_passes_gradcheck(wrt):
    coef, y0 = _lanes(3, seed=1)
    c = (coef.T * torch.tensor([30.0, 30.0, 6.0], dtype=torch.float64)).clone()
    a = torch.complex(y0[:4].T, y0[4:].T).clone()
    c.requires_grad_(wrt in ("coef", "both"))
    a.requires_grad_(wrt in ("y0", "both"))
    inputs = tuple(t for t in (c, a) if t.requires_grad)

    def f(*xs):
        it = iter(xs)
        cc = next(it) if c.requires_grad else c
        aa = next(it) if a.requires_grad else a
        return ct.rk4_end_state(cc, aa, dz_m=0.5, n_steps=10)

    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-7, rtol=1e-6)


def test_plain_tangents_are_the_jacobian_of_the_plain_rk4():
    B, dz, n = 4, 2.0, 25
    coef, y0 = _lanes(B, seed=2)
    t0, s = ct.directions(B, coef=True, state=True, dtype=torch.float64, device="cpu")
    y_end, t_end = ct.solve_tangent_torch(coef, y0, t0, s, dz_m=dz, n_steps=n)
    # the state: integrate_reduce's to the bit
    assert torch.equal(y_end, _plain_rk4(coef, y0, dz, n))
    jc, jy = torch.autograd.functional.jacobian(lambda c, y: _plain_rk4(c, y, dz, n), (coef, y0))
    # jc (8, B, 3, B), jy (8, B, 8, B): keep each lane's own block
    lane = torch.arange(B)
    ref = torch.cat([jc[:, lane, :, lane], jy[:, lane, :, lane]], dim=-1)   # (B, 8, 11)
    got = t_end.reshape(8, 11, B).permute(2, 0, 1)
    scale = ref.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((got - ref).abs() / scale).max()) <= 1e-12


def test_directions_seed_one_coefficient_or_one_component_each():
    t0, s = ct.directions(5, coef=True, state=True, dtype=torch.float64, device="cpu")
    assert t0.shape == (8, 55) and s.shape == (3, 55)
    t0, s = t0.reshape(8, 11, 5), s.reshape(3, 11, 5)
    assert torch.equal(s[:, :3], torch.eye(3, dtype=torch.float64)[:, :, None].expand(3, 3, 5))
    assert torch.equal(t0[:, 3:], torch.eye(8, dtype=torch.float64)[:, :, None].expand(8, 8, 5))
    assert not t0[:, :3].any() and not s[:, 3:].any()
    t0, s = ct.directions(5, coef=True, state=False, dtype=torch.float32, device="cpu")
    assert t0.shape == (8, 15) and t0.dtype == torch.float32 and not t0.any()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host build of the kernel needs g++")
    return host.build("fwm4_tangent", tmp_path_factory.mktemp("host_tangent"))


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("state", [False, True], ids=["fit", "launch"])
def test_the_kernel_source_matches_the_plain_version(host_lib, rdt, state):
    """37 lanes (not a multiple of a block), 3 fit directions or 11, 120
    steps of 1 m, through the launcher by width on a stub card of 0 SMs,
    where it runs a (lane, direction) on one thread (the group of 4 is held
    by ``test_a_group_of_four_matches_the_plain_version``)."""
    B, n = 37, 120
    coef, y0 = _lanes(B, seed=3, rdt=rdt)
    t0, s = ct.directions(B, coef=True, state=state, dtype=rdt, device="cpu")
    y_end = torch.empty((8, B), dtype=rdt)
    t_end = torch.empty_like(t0)
    fn = getattr(host_lib, f"fwm4_tangent_{'f64' if rdt == torch.float64 else 'f32'}")
    with host.sm_count(host_lib, 0):
        err = fn(*(host.ptr(t) for t in (coef, y0, t0, s, y_end, t_end)), B,
                 t0.shape[1] // B, n, ctypes.c_double(1.0), None)
    assert err == 0
    f64 = [t.double() for t in (coef, y0, t0, s)]
    y_ref, t_ref = ct.solve_tangent_torch(*f64, dz_m=1.0, n_steps=n)
    bar = 1e-13 if rdt == torch.float64 else 1e-4
    ey = (y_end.double() - y_ref).abs().amax(dim=0) / y_ref.abs().amax(dim=0)
    tk, tr = t_end.double().reshape(8, -1, B), t_ref.reshape(8, -1, B)
    et = (tk - tr).norm(dim=0) / tr.norm(dim=0)
    assert float(ey.max()) <= bar and float(et.max()) <= bar


GROUP_B, GROUP_STEPS, GROUP_DZ = 130, 8, 5.0
LANE_DIRS_PER_SM = int(re.search(r"constexpr int kLaneDirsPerSM = (\d+);",
                                 (_build.CSRC_DIR / "fwm4_tangent.cu").read_text()).group(1))


def _host_call(fn, planes):
    coef, y0, t0, s = planes
    B = coef.shape[1]
    y_end, t_end = torch.empty((8, B), dtype=coef.dtype), torch.empty_like(t0)
    err = fn(*(host.ptr(t) for t in (coef, y0, t0, s, y_end, t_end)), B, t0.shape[1] // B,
             GROUP_STEPS, ctypes.c_double(GROUP_DZ), None)
    assert err == 0
    return y_end, t_end


@functools.lru_cache(maxsize=None)
def _designs(lib, rdt, n_dir):
    """130 lanes in ``n_dir`` directions (3 fit, or 3 fit and 8 launch):
    the outputs of each design's launcher (``g1``, ``g4``), of the
    launcher by width on a stub card of 0 SMs, where it takes one thread
    (``no SMs``), and of the plain fp64 version.  A group's shuffles cost the stub a barrier of 32
    host threads each, so the run is short: 8 steps of 5 m."""
    coef, y0 = _lanes(GROUP_B, seed=6, rdt=rdt)
    t0, s = ct.directions(GROUP_B, coef=True, state=n_dir == 11, dtype=rdt, device="cpu")
    planes = (coef, y0, t0, s)
    sfx = "f64" if rdt == torch.float64 else "f32"
    out = {f"g{g}": _host_call(getattr(lib, f"fwm4_tangent_{sfx}_g{g}"), planes)
           for g in (1, 4)}
    with host.sm_count(lib, 0):
        out["no SMs"] = _host_call(getattr(lib, f"fwm4_tangent_{sfx}"), planes)
    out["plain"] = ct.solve_tangent_torch(*(t.double() for t in planes), dz_m=GROUP_DZ,
                                          n_steps=GROUP_STEPS)
    return out


@pytest.mark.parametrize("n_dir", [3, 11])
@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_a_group_of_four_gives_the_one_thread_bits(host_lib, rdt, n_dir):
    """The group's shuffles move bits and its sums run in the one-thread
    order, so every output equals the one-thread design's, and the
    launcher by width gives those bits through either design."""
    out = _designs(host_lib, rdt, n_dir)
    for label in ("g4", "no SMs"):
        assert torch.equal(out[label][0], out["g1"][0]), label
        assert torch.equal(out[label][1], out["g1"][1]), label


@pytest.mark.parametrize("n_dir", [3, 11])
@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_a_group_of_four_matches_the_plain_version(host_lib, rdt, n_dir):
    """fp64 within 1e-13 of the plain version, fp32 within 1e-4 of the fp64
    one (state: of each lane's largest value; tangents: normwise a lane
    and direction)."""
    out = _designs(host_lib, rdt, n_dir)
    (y_k, t_k), (y_ref, t_ref) = out["g4"], out["plain"]
    bar = 1e-13 if rdt == torch.float64 else 1e-4
    ey = (y_k.double() - y_ref).abs().amax(dim=0) / y_ref.abs().amax(dim=0)
    tk, tr = t_k.double().reshape(8, n_dir, -1), t_ref.reshape(8, n_dir, -1)
    et = (tk - tr).norm(dim=0) / tr.norm(dim=0)
    assert float(ey.max()) <= bar and float(et.max()) <= bar


@pytest.mark.parametrize("sms", [1, 132])
def test_group_size_takes_four_below_the_threshold_and_one_from_it(host_lib, sms):
    """``fwm4_tangent_group(n)`` on a stub card of ``sms`` SMs: 4 threads a
    (lane, direction) below ``kLaneDirsPerSM * sms`` of them, 1 from there
    on; ``fit-gain``'s 200 x 3 takes the group on an H100's 132 SMs."""
    fn = host_lib.fwm4_tangent_group
    fn.argtypes, fn.restype = [ctypes.c_longlong], ctypes.c_int
    edge = LANE_DIRS_PER_SM * sms
    with host.sm_count(host_lib, sms):
        assert [fn(n) for n in (1, edge - 1, edge, 10 * edge)] == [4, 4, 1, 1]
        if sms == 132:
            assert fn(200 * 3) == 4


def test_float32_adds_the_state_compensated():
    """The fp32 plain version (the state's increment added with Kahan
    summation) against the fp64 one over 400 steps: the state within 1e-5
    of each lane's largest value, the tangents within 1e-4 normwise."""
    B, n = 8, 400
    coef, y0 = _lanes(B, seed=4)
    t0, s = ct.directions(B, coef=True, state=False, dtype=torch.float64, device="cpu")
    y64, t64 = ct.solve_tangent_torch(coef, y0, t0, s, dz_m=0.25, n_steps=n)
    y32, t32 = ct.solve_tangent_torch(*(t.float() for t in (coef, y0, t0, s)), dz_m=0.25,
                                      n_steps=n)
    err = (y32.double() - y64).abs().amax(dim=0) / y64.abs().amax(dim=0)
    assert float(err.max()) <= 1e-5
    et = ((t32.double() - t64).reshape(8, 3, B).norm(dim=0)
          / t64.reshape(8, 3, B).norm(dim=0))
    assert float(et.max()) <= 1e-4


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    coef, y0 = _lanes(2)
    _build.LAUNCHES.clear()
    c = coef.T.clone().requires_grad_(True)
    y = ct.rk4_end_state(c, torch.complex(y0[:4].T, y0[4:].T), dz_m=1.0, n_steps=5)
    y[:, 2].abs().pow(2).sum().backward()
    assert c.grad is not None and torch.isfinite(c.grad).all()
    with torch.no_grad():
        y_ng = ct.rk4_end_state(coef.T, torch.complex(y0[:4].T, y0[4:].T), dz_m=1.0, n_steps=5)
    assert torch.equal(y_ng, y.detach())
    assert not _build.LAUNCHES
    t0, s = ct.directions(2, coef=True, state=False, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ct.solve_tangent_cuda(coef, y0, t0, s, dz_m=1.0, n_steps=5)


def test_the_design_launchers_take_cuda_tensors_and_a_group_of_1_or_4():
    coef, y0 = _lanes(2)
    t0, s = ct.directions(2, coef=True, state=False, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="group must be 1 or 4"):
        ct.solve_tangent_design(coef, y0, t0, s, dz_m=1.0, n_steps=5, group=2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ct.solve_tangent_design(coef, y0, t0, s, dz_m=1.0, n_steps=5, group=4)


@pytest.mark.parametrize("bad, says", [
    (dict(coef=torch.zeros(2, 3)), r"coef must have shape \(3, B\)"),
    (dict(y0=torch.zeros(8, 3, dtype=torch.float64)), r"y0 must have shape \(8, 2\)"),
    (dict(t0=torch.zeros(8, 3, dtype=torch.float64)), r"t0 must have shape"),
    (dict(s=torch.zeros(3, 4, dtype=torch.float64)), r"s must have shape \(3, 6\)"),
    (dict(y0=torch.zeros(8, 2, dtype=torch.float32)), "y0 must be torch.float64"),
])
def test_the_planes_are_checked(bad, says):
    coef, y0 = _lanes(2)
    t0, s = ct.directions(2, coef=True, state=False, dtype=torch.float64, device="cpu")
    args = dict(coef=coef, y0=y0, t0=t0, s=s) | bad
    with pytest.raises(ValueError, match=says):
        ct.solve_tangent_torch(**args, dz_m=1.0, n_steps=3)
    with pytest.raises(ValueError, match=r"need coef \(B, 3\)"):
        ct.rk4_end_state(coef, y0, dz_m=1.0, n_steps=3)
