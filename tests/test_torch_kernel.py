"""The CUDA kernels of the PyTorch port against their plain PyTorch versions,
on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and a CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_kernel.py

Without a CUDA device every test here skips (the kernel has no CPU mode);
``chip_smoke.py`` makes the same comparison at the main path's sizes.

Tolerances: fp64 rtol 1e-11 -- FMA contraction and a different summation
order over a few hundred steps; fp32 rtol 1e-4 -- float32 rounding.  The
adaptive kernel rounds as its plain version does, so its counters must be
equal and its results agree far inside the same bars.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_adaptive as ca  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_solver as cs  # noqa: E402

RTOL = {torch.float64: 1e-11, torch.float32: 1e-4}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a CUDA device")
    return torch.device("cuda")


def _inputs(B, rdt, device, seed=5):
    rng = np.random.default_rng(seed)
    A0 = np.broadcast_to(np.sqrt([0.5, 0.5, 1e-7, 1e-7]).astype(np.complex128), (B, 4)).copy()
    g = np.full(B, 0.0115)
    a = np.full(B, 1.15e-4)
    db = rng.uniform(-0.05, 0.05, B)
    A0[7], g[7] = [1e4, 1e4, 1.0, 0.0], 1e3          # a lane that blows up
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    return (torch.as_tensor(A0, dtype=cdt, device=device),
            *(torch.as_tensor(v, dtype=rdt, device=device) for v in (g, a, db)))


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("method", ["rk4", "ab4", "abm4"])
@pytest.mark.parametrize("n_steps", [250, 253])
def test_kernel_matches_plain_version(card, rdt, method, n_steps):
    t = _inputs(130, rdt, card)
    kw = dict(dz_m=0.2, n_steps=n_steps, save_every=10, integrator=method)
    name = f"fwm4_rk_{'f64' if rdt == torch.float64 else 'f32'}"
    launches = _build.LAUNCHES[name]
    rk = cs.solve_batch_cuda(*t, **kw)
    rp = cs.solve_batch_torch(*t, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == launches + 1
    assert torch.equal(rk.ok, rp.ok) and not bool(rk.ok[7]) and bool(rk.ok[8:].all())
    assert torch.isfinite(rk.P_max).all() and torch.isfinite(rk.A_end).all()
    torch.testing.assert_close(rk.P_max, rp.P_max, rtol=RTOL[rdt], atol=0)
    torch.testing.assert_close(rk.A_end, rp.A_end, rtol=RTOL[rdt], atol=0)


def test_kernel_edge_shapes(card):
    """One lane, no steps, and fewer steps than one save interval."""
    for B, n_steps in ((1, 0), (1, 7), (3, 12)):
        t = _inputs(max(B, 8), torch.float64, card)
        t = tuple(x[-B:] for x in t)
        kw = dict(dz_m=0.2, n_steps=n_steps, save_every=10)
        rk, rp = cs.solve_batch_cuda(*t, **kw), cs.solve_batch_torch(*t, **kw)
        torch.testing.assert_close(rk.P_max, rp.P_max, rtol=1e-11, atol=0)
        torch.testing.assert_close(rk.A_end, rp.A_end, rtol=1e-11, atol=0)


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_check_nan_off(card, rdt):
    """With check_nan=False no lane freezes: ok stays set everywhere, the
    blown-up lane is not finite, and the others match the plain version."""
    t = _inputs(130, rdt, card)
    kw = dict(dz_m=0.2, n_steps=250, save_every=10, check_nan=False)
    rk, rp = cs.solve_batch_cuda(*t, **kw), cs.solve_batch_torch(*t, **kw)
    assert bool(rk.ok.all()) and bool(rp.ok.all())
    assert not bool(torch.isfinite(rk.A_end[7]).all())
    rest = torch.arange(130, device=card) != 7
    torch.testing.assert_close(rk.P_max[rest], rp.P_max[rest], rtol=RTOL[rdt], atol=0)
    torch.testing.assert_close(rk.A_end[rest], rp.A_end[rest], rtol=RTOL[rdt], atol=0)


def test_kernel_refuses_mismatched_dtypes(card):
    A0, g, a, db = _inputs(8, torch.float64, card)
    with pytest.raises(ValueError, match="gamma"):
        cs.solve_batch_cuda(A0, g.float(), a, db, dz_m=0.2, n_steps=10, save_every=10)
    with pytest.raises(ValueError, match="complex"):
        cs.solve_batch_cuda(A0.real, g, a, db, dz_m=0.2, n_steps=10, save_every=10)


def test_gain_spectrum_auto_runs_the_kernel(card):
    lam3 = np.linspace(1540e-9, 1650e-9, 64)
    disp = T.dispersion_params_from_D_S(1.5525e-6, 0.2, 0.02, D_units="ps/nm/km",
                                        S_units="ps/nm^2/km")
    kw = dict(cfg=T.custom_simulation_config(z_max=100.0, dz=0.2),
              lambda_p1_m=1550e-9, lambda_p2_m=1555e-9, lambda_signal_m=lam3,
              gamma=0.0115, alpha=1.15e-4, p_in=[0.5, 0.5, 1e-7, 1e-7], dispersion=disp,
              device=card)
    _build.LAUNCHES.clear()
    auto = T.gain_spectrum(**kw)
    assert _build.LAUNCHES == {"fwm4_rk_f64": 1}
    plain = T.gain_spectrum(**kw, engine="torch")
    assert _build.LAUNCHES == {"fwm4_rk_f64": 1}
    np.testing.assert_allclose(auto.gain, plain.gain, rtol=1e-11)
    lab = T.gain_spectrum(**{**kw, "frame": "lab"})
    assert _build.LAUNCHES == {"fwm4_rk_f64": 1} and np.isfinite(lab.gain).all()


# ---------------------------------------------------------------------------
# K3: the adaptive (rk45) kernel, csrc/fwm4_rk45.cu
# ---------------------------------------------------------------------------

RK45_TOL = {torch.float64: (1e-10, 1e-13), torch.float32: (1e-6, 1e-10)}


def _rk45_inputs(B, rdt, device):
    t = _inputs(B, rdt, device)
    # a spread of mismatch, so that lanes take different step counts
    db = torch.linspace(-1.5, 1.5, B, dtype=rdt, device=device)
    return t[0], t[1], t[2], db


def _rk45_pair(t, **kw):
    rk = ca.solve_batch_rk45_cuda(*t, **kw)
    rp = ca.solve_batch_rk45_torch(*t, **kw)
    torch.cuda.synchronize()
    return rk, rp


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n_steps,save_every,one_thread",
                         [(250, 10, False), (253, 10, False), (250, 7, False), (53, 10, True)],
                         ids=["250-10", "253-10", "250-7", "53-10-one-thread"])
def test_rk45_kernel_matches_plain_version(card, rdt, n_steps, save_every, one_thread):
    """The kernel and its plain version take the same steps (the plain
    version repeats the kernel's operations, and the float32 kernel forms
    its products without FMA contraction): equal counters and ok flags, and
    results within 1e-11 (fp64) or 1e-4 (fp32) relative.  130 lanes run 4
    threads a lane; from 256 lanes an SM on, the launcher runs a lane on one
    thread (``fwm4_rk45_group``)."""
    B = 130
    if one_thread:
        group = _build.load_library("fwm4_rk45").fwm4_rk45_group
        group.argtypes, group.restype = [ctypes.c_int], ctypes.c_int
        B = 256 * torch.cuda.get_device_properties(card).multi_processor_count
        assert group(B) == 1 and group(B - 1) == 4
    rtol, atol = RK45_TOL[rdt]
    t = _rk45_inputs(B, rdt, card)
    kw = dict(dz_m=0.2, n_steps=n_steps, save_every=save_every, rtol=rtol, atol=atol)
    name = f"fwm4_rk45_{'f64' if rdt == torch.float64 else 'f32'}"
    launches = _build.LAUNCHES[name]
    rk, rp = _rk45_pair(t, **kw)
    assert _build.LAUNCHES[name] == launches + 1
    assert torch.equal(rk.ok, rp.ok) and not bool(rk.ok[7]) and bool(rk.ok[8:].all())
    assert torch.equal(rk.n_accepted, rp.n_accepted)
    assert torch.equal(rk.n_rejected, rp.n_rejected)
    assert bool((rk.n_accepted[8:] > 0).all())
    assert torch.isfinite(rk.P_max).all() and torch.isfinite(rk.A_end).all()
    bar = 1e-11 if rdt == torch.float64 else 1e-4
    torch.testing.assert_close(rk.P_max, rp.P_max, rtol=bar, atol=0)
    torch.testing.assert_close(rk.A_end, rp.A_end, rtol=bar, atol=0)


def test_rk45_kernel_edge_shapes(card):
    """One lane; no steps; fewer steps than one save interval (the saved
    outputs are the initial values, the span still feeds ok and the
    counters)."""
    for B, n_steps in ((1, 0), (1, 7), (3, 12), (130, 5)):
        t = tuple(x[-B:] for x in _rk45_inputs(max(B, 8), torch.float64, card))
        kw = dict(dz_m=0.2, n_steps=n_steps, save_every=10, rtol=1e-10, atol=1e-13)
        rk, rp = _rk45_pair(t, **kw)
        assert torch.equal(rk.ok, rp.ok) and torch.equal(rk.n_accepted, rp.n_accepted)
        torch.testing.assert_close(rk.P_max, rp.P_max, rtol=1e-11, atol=0)
        torch.testing.assert_close(rk.A_end, rp.A_end, rtol=1e-11, atol=0)
        if n_steps < 10:
            torch.testing.assert_close(rk.A_end, t[0], rtol=0, atol=0)
        if n_steps == 0:
            assert bool(rk.ok.all()) and int(rk.n_accepted.sum()) == 0


def test_rk45_kernel_max_steps_exhaustion(card):
    """A lane that cannot finish a segment within max_steps attempts fails,
    in the kernel as in the plain version."""
    t = _rk45_inputs(64, torch.float64, card)
    kw = dict(dz_m=0.2, n_steps=50, save_every=10, rtol=1e-10, atol=1e-13, max_steps=2)
    rk, rp = _rk45_pair(t, **kw)
    assert not bool(rk.ok.any()) and torch.equal(rk.ok, rp.ok)
    assert torch.equal(rk.n_accepted, rp.n_accepted)


def test_gain_spectrum_rk45_runs_the_kernel(card):
    lam3 = np.linspace(1540e-9, 1650e-9, 64)
    disp = T.dispersion_params_from_D_S(1.5525e-6, 0.2, 0.02, D_units="ps/nm/km",
                                        S_units="ps/nm^2/km")
    for precision, name in (("df32", "fwm4_rk45_f64"), ("x32", "fwm4_rk45_f32")):
        cfg = T.custom_simulation_config(z_max=100.0, dz=0.2, integrator="rk45",
                                         precision=precision, rtol=1e-9, atol=1e-12)
        kw = dict(cfg=cfg, lambda_p1_m=1550e-9, lambda_p2_m=1555e-9, lambda_signal_m=lam3,
                  gamma=0.0115, alpha=1.15e-4, p_in=[0.5, 0.5, 1e-7, 1e-7], dispersion=disp,
                  device=card)
        _build.LAUNCHES.clear()
        auto = T.gain_spectrum(**kw)
        assert _build.LAUNCHES == {name: 1}
        plain = T.gain_spectrum(**kw, engine="torch")
        assert _build.LAUNCHES == {name: 1}
        np.testing.assert_allclose(auto.gain, plain.gain,
                                   rtol=1e-11 if precision == "df32" else 1e-5)


# ---------------------------------------------------------------------------
# K4 and K5: the comb kernels, csrc/comb_rk.cu and csrc/comb_rk45.cu
# ---------------------------------------------------------------------------

from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import nwave as tn  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_comb as cc  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_comb_adaptive as cca  # noqa: E402

COMB_TOL = {torch.float64: 1e-11, torch.float32: 1e-4}


def _normwise(a, b):
    """Worst over combs of max_lines |a - b| / max_lines |b|: a weak line
    carries the DFT sums' rounding relative to the pumps."""
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def _comb_inputs(N, B, rdt, device, bad=None, spacing_hz=50e9):
    """bench_comb.py's comb at N lines (pumps at c +- N/4), 50 GHz apart
    unless ``spacing_hz`` says otherwise, over a gamma grid; comb ``bad``
    blows up."""
    oc = 2 * np.pi * 193.1e12
    grid = tn.CombGrid.centered(oc, 2 * np.pi * spacing_hz, N)
    beta = tn.comb_beta_lin(grid, T.DispersionParams.from_betas(oc, beta2=-1e-27, beta3=1.2e-41))
    A0 = np.broadcast_to(tn.seed_comb(grid, pump_lines={N // 4: 0.5, 3 * N // 4: 0.5},
                                      noise_floor_W=1e-9), (B, N)).copy()
    g = np.linspace(5e-3, 15e-3, B)
    if bad is not None:
        A0[bad] *= 1e3
        g[bad] = 1e3
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    return (torch.as_tensor(A0, dtype=cdt, device=device),
            *(torch.as_tensor(v, dtype=rdt, device=device).contiguous()
              for v in (g, np.full(B, 5e-5), np.broadcast_to(beta, (B, N)))))


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("method", ["rk4", "ab4", "abm4"])
@pytest.mark.parametrize("N,n_steps", [(16, 100), (33, 105), (100, 103)])
def test_comb_kernel_matches_plain_version(card, rdt, method, N, n_steps):
    """Up to N = 64 a comb is one warp (a 128-point transform); N = 100 is
    a block of 64 threads on a 256-point transform, at 2.5 m steps: at 5 m
    AB4 is unstable at 100 lines (the plain version's dft and fft couplings
    part by 2e-10 in fp64 over 105 steps), so the kernel's rounding would
    be amplified, not measured."""
    t = _comb_inputs(N, 37, rdt, card, bad=7)
    kw = dict(dz_m=5.0 if N <= 64 else 2.5, n_steps=n_steps, save_every=10, integrator=method)
    name = f"comb_rk_{'f64' if rdt == torch.float64 else 'f32'}"
    launches = _build.LAUNCHES[name]
    rk = cc.solve_comb_batch_cuda(*t, **kw)
    rp = cc.solve_comb_batch_torch(*t, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == launches + 1
    assert torch.equal(rk.ok, rp.ok) and not bool(rk.ok[7]) and int(rk.ok.sum()) == 36
    assert torch.isfinite(rk.P_max).all() and torch.isfinite(rk.A_end).all()
    assert _normwise(rk.A_end, rp.A_end) <= COMB_TOL[rdt]
    assert _normwise(rk.P_max, rp.P_max) <= COMB_TOL[rdt]


def test_comb_kernel_edge_shapes(card):
    """One line, one comb, no steps, fewer steps than one save interval."""
    for N, B, n_steps in ((1, 1, 0), (1, 2, 7), (3, 1, 12), (64, 3, 5)):
        t = _comb_inputs(max(N, 4), B, torch.float64, card)
        t = (t[0][:, :N].contiguous(), t[1], t[2], t[3][:, :N].contiguous())
        for method in ("rk4", "abm4"):
            kw = dict(dz_m=5.0, n_steps=n_steps, save_every=10, integrator=method)
            rk, rp = cc.solve_comb_batch_cuda(*t, **kw), cc.solve_comb_batch_torch(*t, **kw)
            assert torch.equal(rk.ok, rp.ok)
            assert _normwise(rk.A_end, rp.A_end) <= 1e-12
            if n_steps < 10:
                assert torch.equal(rk.A_end, t[0])


def test_comb_kernel_check_nan_off(card):
    t = _comb_inputs(16, 8, torch.float64, card, bad=2)
    kw = dict(dz_m=5.0, n_steps=60, save_every=10, check_nan=False)
    rk, rp = cc.solve_comb_batch_cuda(*t, **kw), cc.solve_comb_batch_torch(*t, **kw)
    assert bool(rk.ok.all()) and bool(rp.ok.all()) and not bool(torch.isfinite(rk.A_end[2]).all())
    rest = torch.arange(8, device=card) != 2
    assert _normwise(rk.A_end[rest], rp.A_end[rest]) <= 1e-11


# K5's routes: one warp a comb (N = 16), a block of 64 threads (N = 100), 256
# threads at 4 lines a thread (N = 600) and, in fp32 only (the fp64 block
# does not fit in shared memory), at 8 lines a thread (N = 1,100); the combs
# of 600 lines and more 10 GHz apart, as in tests/test_torch_comb_host.py
K5_CASES = [(N, rdt) for N in (16, 100, 600) for rdt in (torch.float64, torch.float32)] \
    + [(1100, torch.float32)]


@pytest.mark.parametrize("N,rdt", K5_CASES,
                         ids=[f"{N}-{'f64' if r == torch.float64 else 'f32'}" for N, r in K5_CASES])
@pytest.mark.parametrize("n_steps", [100, 105])
def test_comb_rk45_kernel_matches_plain_version(card, rdt, n_steps, N):
    """fp64: the same steps on (nearly) every comb, results within 1e-9
    there and 10 x rtol on all; fp32: every comb, the failed one included,
    within 1e-3, inside the 2e-2 class of the JAX kernel's test (the plain
    version computes the cubic sum with the kernel's passes and rounding
    points, so the two take the same steps)."""
    rtol, atol = (1e-9, 1e-12) if rdt == torch.float64 else (1e-6, 1e-10)
    t = _comb_inputs(N, 37, rdt, card, bad=7, spacing_hz=50e9 if N <= 100 else 10e9)
    kw = dict(dz_m=5.0, n_steps=n_steps, save_every=10, rtol=rtol, atol=atol)
    name = f"comb_rk45_{'f64' if rdt == torch.float64 else 'f32'}"
    launches = _build.LAUNCHES[name]
    rk = cca.solve_comb_batch_rk45_cuda(*t, **kw)
    rp = cca.solve_comb_batch_rk45_torch(*t, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == launches + 1
    assert torch.equal(rk.ok, rp.ok) and not bool(rk.ok[7]) and int(rk.ok.sum()) == 36
    assert torch.isfinite(rk.P_max).all() and torch.isfinite(rk.A_end).all()
    if rdt == torch.float64:
        same = (rk.n_accepted == rp.n_accepted) & (rk.n_rejected == rp.n_rejected)
        assert float(same.double().mean()) >= 0.9
        assert _normwise(rk.A_end[same], rp.A_end[same]) <= 1e-9
    bar = 10 * rtol if rdt == torch.float64 else 1e-3
    assert _normwise(rk.A_end, rp.A_end) <= bar, _parting(cca, t, kw, rk, rp)
    assert _normwise(rk.P_max, rp.P_max) <= bar


def _parting(cca, t, kw, rk, rp):
    """Where the kernel and its plain version part: the three combs with
    the widest gap, with both counters, the gap and the first save segment
    (of kw's) after which the comb's state differs bit for bit."""
    gaps = [_normwise(rk.A_end[b:b + 1], rp.A_end[b:b + 1]) for b in range(t[0].shape[0])]
    rows = []
    for b in sorted(range(len(gaps)), key=lambda b: -gaps[b])[:3]:
        if gaps[b] == 0:
            break
        first = None
        for s in range(1, kw["n_steps"] // kw["save_every"] + 1):
            sub = dict(kw, n_steps=s * kw["save_every"])
            k1 = cca.solve_comb_batch_rk45_cuda(*(v[b:b + 1] for v in t), **sub)
            p1 = cca.solve_comb_batch_rk45_torch(*(v[b:b + 1] for v in t), **sub)
            if not torch.equal(k1.A_end, p1.A_end):
                first = s
                break
        rows.append(f"comb {b}: kernel {int(rk.n_accepted[b])}/{int(rk.n_rejected[b])}, plain "
                    f"{int(rp.n_accepted[b])}/{int(rp.n_rejected[b])} accepted/rejected, gap "
                    f"{gaps[b]:.3e}, first parting "
                    f"save segment {first}")
    return "; ".join(rows)


def test_comb_kernel_refuses_a_comb_too_wide_for_shared_memory(card):
    """N = 2049 lines (L = 8192) needs more than a block's 227 KB in fp64:
    the wrapper raises with the number, launching nothing."""
    t = _comb_inputs(2049, 1, torch.float64, card)
    launches = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        cc.solve_comb_batch_cuda(*t, dz_m=5.0, n_steps=10, save_every=10)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        cca.solve_comb_batch_rk45_cuda(*t, dz_m=5.0, n_steps=10, save_every=10, rtol=1e-8,
                                       atol=1e-12)
    assert dict(_build.LAUNCHES) == launches


def test_solve_comb_batch_auto_runs_the_kernels(card):
    t = _comb_inputs(16, 8, torch.float64, card)
    coeffs = tn.NWaveCoeffs(gamma=t[1].cpu().numpy(), alpha=5e-5, beta_lin=t[3][0].cpu().numpy())
    A0 = t[0].cpu().numpy()
    for integrator, precision, name in (("rk4", "df32", "comb_rk_f64"),
                                        ("abm4", "x32", "comb_rk_f32"),
                                        ("rk45", "x64", "comb_rk45_f64")):
        cfg = T.custom_simulation_config(z_max=300.0, dz=5.0, save_every=10,
                                         integrator=integrator, precision=precision,
                                         rtol=1e-9, atol=1e-12)
        _build.LAUNCHES.clear()
        P, A, ok = tn.solve_comb_batch(cfg, coeffs, A0)
        assert _build.LAUNCHES == {name: 1} and ok.all() and P.shape == (8, 16)
        P2, A2, ok2 = tn.solve_comb_batch(cfg, coeffs, A0, engine="torch", device=card)
        assert _build.LAUNCHES == {name: 1}
        bar = 1e-4 if precision == "x32" else 1e-9
        assert np.max(np.abs(A - A2).max(-1) / np.abs(A2).max(-1)) <= bar


# ---------------------------------------------------------------------------
# K6 and K8: the split-step kernels, csrc/gnlse_ssfm.cu and csrc/ssfm_rk45.cu
# ---------------------------------------------------------------------------

from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import gnlse as tg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_gnlse as cg  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_ssfm_adaptive as csa  # noqa: E402

SSFM_TOL = {torch.float64: 1e-11, torch.float32: 1e-4}
NL_CASES = {"kerr": None, "raman_steep": (0.18, 1.2e15), "raman": (0.18, None),
            "steep": (0.0, 1.2e15)}


def _pulse_inputs(B, n, rdt, device, bad=None, bad_scale=None):
    """bench_gnlse.py's sech envelopes (0.5-1.5 x the soliton power) at
    width n.  Envelope ``bad`` has a gain so large that its first chunk
    overflows (it freezes at its input) or, with
    ``bad_scale``, starts that many times too strong: its Kerr phase makes
    the adaptive controller reject down to dt_min at once (a runaway gain
    would crawl on accepted ever-smaller steps until max_steps)."""
    grid = tg.TimeGrid.for_pulse(1e-12, n_samples=n)
    co = tg.make_gnlse_coeffs(grid, T.DispersionParams.from_betas(1.2e15, beta2=-2e-26),
                              gamma_W_m=2e-3)
    P0 = tg.soliton_peak_power(-2e-26, 2e-3, 1e-12)
    A0 = np.sqrt(np.linspace(0.5, 1.5, B) * P0)[:, None] / np.cosh(grid.t()[None, :] / 1e-12)
    a = np.full(B, 5e-5)
    if bad is not None and bad_scale is not None:
        A0[bad] *= bad_scale
    elif bad is not None:
        a[bad] = -4e6
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    return grid, (torch.as_tensor(A0, device=device).to(cdt),
                  torch.full((B,), 2e-3, dtype=rdt, device=device),
                  torch.as_tensor(a, device=device).to(rdt), co.lin_phase.to(device, rdt))


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(NL_CASES))
@pytest.mark.parametrize("n,n_steps", [(128, 12), (384, 14), (640, 14), (1024, 14), (2048, 13)])
def test_gnlse_kernel_matches_plain_version(card, rdt, case, n, n_steps):
    """Every width class (r = 1, 3 and 5 groups, the widest block), with a
    blown-up envelope and, for 13 and 14 steps at save_every=4, a trailing
    partial chunk."""
    grid, t = _pulse_inputs(9, n, rdt, card, bad=4)
    nl = NL_CASES[case]
    nl = None if nl is None else tg._cast_nl(tg.make_nl_terms(grid, f_raman=nl[0], omega0=nl[1]),
                                             rdt, card)
    kw = dict(dz_m=0.02, n_steps=n_steps, save_every=4, nl=nl)
    name = f"gnlse_ssfm{'_nl' if nl is not None else ''}_{'f64' if rdt == torch.float64 else 'f32'}"
    launches = _build.LAUNCHES[name]
    rk = cg.solve_gnlse_batch_cuda(*t, **kw)
    rp = cg.solve_gnlse_batch_torch(*t, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == launches + 1
    assert torch.equal(rk.ok, rp.ok) and not bool(rk.ok[4]) and int(rk.ok.sum()) == 8
    assert torch.isfinite(rk.A_end).all()
    assert torch.equal(rk.A_end[4], t[0][4]) and torch.equal(rp.A_end[4], t[0][4])
    good = rk.ok
    assert _normwise(rk.A_end[good], rp.A_end[good]) <= SSFM_TOL[rdt]
    torch.testing.assert_close(rk.peak_max[good], rp.peak_max[good], rtol=SSFM_TOL[rdt], atol=0)


def test_gnlse_kernel_shared_memory_matches_the_sources(card):
    lib, lib45 = _build.load_library("gnlse_ssfm"), _build.load_library("ssfm_rk45")
    lib7 = _build.load_library("lle_ssfm")
    for n in (128, 1024, 2048):
        for rdt in (torch.float64, torch.float32):
            elem = rdt.itemsize
            assert lib.gnlse_ssfm_shared_bytes(n, elem, 0) == cg.shared_bytes("gnlse_ssfm", n, rdt)
            assert lib7.lle_ssfm_shared_bytes(n, elem) == cg.shared_bytes("lle_ssfm", n, rdt)
            assert lib.gnlse_ssfm_shared_bytes(n, elem, 1) == \
                cg.shared_bytes("gnlse_ssfm", n, rdt, True)
            assert lib45.ssfm_rk45_shared_bytes(n, elem) == cg.shared_bytes("ssfm_rk45", n, rdt)
    # the widest fp64 nl block fits a Hopper block's opt-in limit
    assert cg.width_problem("gnlse_ssfm", 2048, torch.float64, card, nl=True) is None


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n,n_steps", [(128, 40), (384, 43), (1024, 42), (2048, 41)])
def test_ssfm_rk45_kernel_matches_plain_version(card, rdt, n, n_steps):
    """fp64: the same steps on (nearly) every envelope and results within
    1e-9 there; fp32: the transforms' rounding moves the float32 error
    estimate, so the steps may differ and the results are held to 1e-4."""
    rtol, atol = (1e-9, 1e-12) if rdt == torch.float64 else (1e-5, 1e-9)
    _grid, t = _pulse_inputs(9, n, rdt, card, bad=4, bad_scale=1e12)
    kw = dict(dz_m=0.05, n_steps=n_steps, save_every=10, rtol=rtol, atol=atol, max_steps=5000)
    name = f"ssfm_rk45_{'f64' if rdt == torch.float64 else 'f32'}"
    launches = _build.LAUNCHES[name]
    rk = csa.solve_gnlse_batch_rk45_cuda(*t, **kw)
    rp = csa.solve_gnlse_batch_rk45_torch(*t, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == launches + 1
    assert torch.equal(rk.ok, rp.ok) and not bool(rk.ok[4]) and int(rk.ok.sum()) == 8
    assert torch.isfinite(rk.A_end).all() and bool((rk.n_accepted[rk.ok] > 0).all())
    good = rk.ok
    if rdt == torch.float64:
        same = good & (rk.n_accepted == rp.n_accepted) & (rk.n_rejected == rp.n_rejected)
        assert int(same.sum()) >= 7
        assert _normwise(rk.A_end[same], rp.A_end[same]) <= 1e-9
    assert _normwise(rk.A_end[good], rp.A_end[good]) <= (1e-7 if rdt == torch.float64 else 1e-4)


def test_ssfm_rk45_kernel_max_steps_exhaustion(card):
    """An envelope that cannot finish a segment within max_steps attempts
    fails, in the kernel as in the plain version."""
    _grid, t = _pulse_inputs(4, 256, torch.float64, card)
    kw = dict(dz_m=0.05, n_steps=20, save_every=10, rtol=1e-9, atol=1e-12, max_steps=1)
    rk = csa.solve_gnlse_batch_rk45_cuda(*t, **kw)
    rp = csa.solve_gnlse_batch_rk45_torch(*t, **kw)
    assert not bool(rk.ok.any()) and torch.equal(rk.ok, rp.ok)
    assert torch.equal(rk.n_accepted, rp.n_accepted)


def test_solve_gnlse_batch_auto_runs_the_kernels(card):
    grid, t = _pulse_inputs(8, 256, torch.float64, card)
    co = tg.GNLSECoeffs(gamma=2e-3, alpha=5e-5, lin_phase=t[3].cpu().numpy())
    A0 = t[0].cpu().numpy()
    nl = tg.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15)
    for integrator, precision, use_nl, name in (("rk4", "df32", False, "gnlse_ssfm_f64"),
                                                ("rk4", "x32", True, "gnlse_ssfm_nl_f32"),
                                                ("rk45", "x64", False, "ssfm_rk45_f64"),
                                                ("rk4ip", "x64", False, None),
                                                ("rk45", "x64", True, None)):
        cfg = T.custom_simulation_config(z_max=0.5, dz=0.05, save_every=3, integrator=integrator,
                                         precision=precision, rtol=1e-9, atol=1e-12)
        kw = dict(nl=nl if use_nl else None)
        _build.LAUNCHES.clear()
        pk, A, ok = tg.solve_gnlse_batch(cfg, co, A0, **kw)
        assert _build.LAUNCHES == ({name: 1} if name else {}) and ok.all()
        pk2, A2, ok2 = tg.solve_gnlse_batch(cfg, co, A0, engine="torch", device=card, **kw)
        assert _build.LAUNCHES == ({name: 1} if name else {})
        bar = 1e-4 if precision == "x32" else (1e-7 if integrator == "rk45" else 1e-11)
        assert np.max(np.abs(A - A2).max(-1) / np.abs(A2).max(-1)) <= bar
        if name is None:
            with pytest.raises(ValueError):
                tg.solve_gnlse_batch(cfg, co, A0, engine="cuda", **kw)


# ---------------------------------------------------------------------------
# K7 and K8's LLE route: csrc/lle_ssfm.cu and the affine instantiation of
# csrc/ssfm_rk45.cu
# ---------------------------------------------------------------------------

from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import lle as tl  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_lle as cl  # noqa: E402

# a seed whose |psi|^2 overflows the type in the first Kerr substep
LLE_BAD_SCALE = {torch.float64: 1e160, torch.float32: 1e25}


def _cavity_inputs(B, n, rdt, device, bad=None, rows=False):
    """bench_lle.py's soliton-ansatz cavities (Delta in [3.6, 4.4], F = 2,
    d2 = -1) at width n, a complex pump at phase 0.3; cavity ``bad`` starts
    LLE_BAD_SCALE times too strong; ``rows``: a per-cavity phase."""
    grid = tl.TimeGrid(n_samples=n, t_window_s=20.0)
    dets = np.linspace(3.6, 4.4, B)
    co = tl.make_lle_coeffs(grid, detuning=dets, pump=2.0 * np.exp(0.3j), d2=-1.0)
    psi0 = np.stack([tl.soliton_ansatz(grid, d, 2.0, -1.0) for d in dets])
    if bad is not None:
        psi0[bad] *= LLE_BAD_SCALE[rdt]
    det, F, ph = tl.lane_coeffs(co, B, n, rdt, device)
    if rows:
        scale = torch.linspace(0.8, 1.2, B, dtype=rdt, device=device)
        ph = (ph[None] * scale[:, None]).contiguous()
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    return torch.as_tensor(psi0, device=device).to(cdt), det, F, ph


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("rows", [False, True], ids=["shared_phase", "phase_rows"])
@pytest.mark.parametrize("n,n_steps", [(128, 12), (256, 14), (384, 13), (2048, 14)])
def test_lle_kernel_matches_plain_version(card, rdt, rows, n, n_steps):
    """K7 at every width class, a bad cavity frozen at its input and, for 13
    and 14 steps at save_every=4, a trailing partial chunk."""
    t = _cavity_inputs(9, n, rdt, card, bad=4, rows=rows)
    kw = dict(dt=0.01, n_steps=n_steps, save_every=4)
    name = f"lle_ssfm_{'f64' if rdt == torch.float64 else 'f32'}"
    launches = _build.LAUNCHES[name]
    rk = cl.solve_lle_batch_cuda(*t, **kw)
    rp = cl.solve_lle_batch_torch(*t, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == launches + 1
    assert torch.equal(rk.ok, rp.ok) and not bool(rk.ok[4]) and int(rk.ok.sum()) == 8
    assert torch.equal(rk.A_end[4], t[0][4]) and torch.equal(rp.A_end[4], t[0][4])
    good = rk.ok
    assert _normwise(rk.A_end[good], rp.A_end[good]) <= SSFM_TOL[rdt]
    torch.testing.assert_close(rk.peak_max[good], rp.peak_max[good], rtol=SSFM_TOL[rdt], atol=0)


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n,n_steps", [(128, 20), (256, 23), (384, 21), (2048, 22), (640, 21),
                                     (1024, 22)])
def test_ssfm_rk45_lle_kernel_matches_plain_version(card, rdt, n, n_steps):
    """K8's LLE route with a trailing span and a bad cavity, which the
    controller rejects to dt_min (35 attempts), at every block shape of the
    launcher (4 samples a thread in 32 to 256 threads, 8 at n = 2,048):
    fp64 the same steps on (nearly) every cavity and results within 1e-9
    there; fp32 within 1e-4."""
    rtol, atol = (1e-8, 1e-11) if rdt == torch.float64 else (1e-5, 1e-8)
    t = _cavity_inputs(9, n, rdt, card, bad=4)
    kw = dict(dt=0.01, n_steps=n_steps, save_every=10, rtol=rtol, atol=atol, max_steps=20_000)
    name = f"ssfm_rk45_lle_{'f64' if rdt == torch.float64 else 'f32'}"
    launches = _build.LAUNCHES[name]
    rk = csa.solve_lle_batch_rk45_cuda(*t, **kw)
    rp = csa.solve_lle_batch_rk45_torch(*t, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == launches + 1
    assert torch.equal(rk.ok, rp.ok) and not bool(rk.ok[4]) and int(rk.ok.sum()) == 8
    assert int(rk.n_accepted[4]) == 0 and torch.isfinite(rk.A_end).all()
    good = rk.ok
    if rdt == torch.float64:
        same = good & (rk.n_accepted == rp.n_accepted) & (rk.n_rejected == rp.n_rejected)
        assert int(same.sum()) >= 7
        assert _normwise(rk.A_end[same], rp.A_end[same]) <= 1e-9
    assert _normwise(rk.A_end[good], rp.A_end[good]) <= (1e-7 if rdt == torch.float64 else 1e-4)


def test_solve_lle_batch_auto_runs_the_kernels(card):
    t = _cavity_inputs(8, 256, torch.float64, card)
    co = tl.LLECoeffs(detuning=t[1].cpu(), pump_re=t[2].real.cpu(), pump_im=t[2].imag.cpu(),
                      lin_phase=t[3].cpu())
    psi0 = t[0].cpu().numpy()
    for integrator, precision, name in (("rk4", "df32", "lle_ssfm_f64"),
                                        ("rk4", "x32", "lle_ssfm_f32"),
                                        ("rk45", "x64", "ssfm_rk45_lle_f64"),
                                        ("rk45", "x32", "ssfm_rk45_lle_f32"),
                                        ("rk4ip", "x64", None), ("rk4ip45", "x64", None)):
        rtol, atol = (1e-5, 1e-8) if precision == "x32" else (1e-8, 1e-11)
        cfg = T.custom_simulation_config(z_max=0.3, dz=0.01, save_every=7, integrator=integrator,
                                         precision=precision, rtol=rtol, atol=atol)
        _build.LAUNCHES.clear()
        pk, A, ok = tl.solve_lle_batch(cfg, co, psi0)
        assert _build.LAUNCHES == ({name: 1} if name else {}) and ok.all()
        pk2, A2, ok2 = tl.solve_lle_batch(cfg, co, psi0, engine="torch", device=card)
        assert _build.LAUNCHES == ({name: 1} if name else {})
        bar = 1e-4 if precision == "x32" else (1e-7 if integrator == "rk45" else 1e-11)
        assert np.max(np.abs(A - A2).max(-1) / np.abs(A2).max(-1)) <= bar
        if name is None:
            with pytest.raises(ValueError, match="Strang"):
                tl.solve_lle_batch(cfg, co, psi0, engine="cuda")


# ---------------------------------------------------------------------------
# K9: the vector split-step kernel, csrc/vgnlse_ssfm.cu
# ---------------------------------------------------------------------------

from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import vgnlse as tv  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_vgnlse as cv  # noqa: E402

# body label -> (coupling, nl terms (f_R, omega_0) or None)
VBODIES = {"rotation_manakov": ("manakov", None), "rotation_cnlse": ("cnlse", None),
           "coherent": ("isotropic", None), "nl_manakov": ("manakov", (0.18, 1.2e15)),
           "nl_isotropic": ("isotropic", (0.18, None))}


def _vector_inputs(B, n, rdt, device, coupling, nl_case=None, bad=None, rows=False):
    """Two-polarization sech pulses (0.5-1.5 x the soliton power, theta =
    0.4) with birefringence; instance ``bad`` has a gain that overflows in
    its first chunk; ``rows``: one phase plane an instance."""
    grid = tv.TimeGrid.for_pulse(1e-12, n_samples=n)
    co = tv.make_vgnlse_coeffs(grid, T.DispersionParams.from_betas(1.2e15, beta2=-2e-26),
                               gamma_W_m=2e-3, alpha_1_m=5e-5, coupling=coupling,
                               dbeta0_1_m=8.0, dbeta1_s_m=1e-13)
    P0 = tg.soliton_peak_power(-2e-26, 2e-3, 1e-12)
    A = np.sqrt(np.linspace(0.5, 1.5, B) * P0)[:, None] / np.cosh(grid.t()[None, :] / 1e-12)
    A0 = np.stack([np.cos(0.4) * A, np.sin(0.4) * np.exp(0.5j) * A], axis=1)
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    g, a, b, ph = tv.lane_coeffs(co, B, n, rdt, device)
    if bad is not None:
        a = a.clone()
        a[bad] = -4e6
    if rows:
        ph = (ph[None] * torch.linspace(0.9, 1.1, B, dtype=rdt, device=device)[:, None, None])
    nl = None if nl_case is None else tg._cast_nl(
        tg.make_nl_terms(grid, f_raman=nl_case[0], omega0=nl_case[1]), rdt, device)
    return (torch.as_tensor(A0, device=device).to(cdt), g, a, b, ph.contiguous()), co, nl


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("body", sorted(VBODIES))
@pytest.mark.parametrize("n,n_steps,rows", [(128, 12, False), (384, 14, True), (640, 14, False),
                                            (1024, 13, False), (2048, 14, True)])
def test_vgnlse_kernel_matches_plain_version(card, rdt, body, n, n_steps, rows):
    """Every body and width class (r = 1, 3 and 5 groups, the widest
    block), shared and per-instance planes, a blown-up instance and, for 13
    and 14 steps at save_every=4, a trailing partial chunk.  Every block
    fits in shared memory, the fp64 nl block at n = 2048 too."""
    coupling, nl_case = VBODIES[body]
    t, co, nl = _vector_inputs(9, n, rdt, card, coupling, nl_case, bad=4, rows=rows)
    kw = dict(dz_m=0.02, n_steps=n_steps, save_every=4, nl=nl)
    kind = cv.body_of(co.coherent, nl)
    assert cv.width_problem(n, rdt, card, kind) is None
    name = (f"vgnlse_ssfm{'' if kind == 'rotation' else '_' + kind}_"
            f"{'f64' if rdt == torch.float64 else 'f32'}")
    launches = _build.LAUNCHES[name]
    rk = cv.solve_vgnlse_batch_cuda(*t, co.coherent, **kw)
    rp = cv.solve_vgnlse_batch_torch(*t, co.coherent, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == launches + 1
    assert torch.equal(rk.ok, rp.ok) and not bool(rk.ok[4]) and int(rk.ok.sum()) == 8
    assert torch.isfinite(rk.A_end).all()
    assert torch.equal(rk.A_end[4], t[0][4]) and torch.equal(rp.A_end[4], t[0][4])
    good = rk.ok
    assert _normwise(rk.A_end[good].flatten(1), rp.A_end[good].flatten(1)) <= SSFM_TOL[rdt]
    torch.testing.assert_close(rk.peak_max[good], rp.peak_max[good], rtol=SSFM_TOL[rdt], atol=0)


def test_vgnlse_kernel_shared_memory_matches_the_source(card):
    lib = _build.load_library("vgnlse_ssfm")
    for n in (128, 1024, 2048):
        for rdt in (torch.float64, torch.float32):
            for body, code in cv.BODIES.items():
                assert lib.vgnlse_ssfm_shared_bytes(n, rdt.itemsize, code) == \
                    cv.shared_bytes(n, rdt, body)
    assert cv.width_problem(1024, torch.float64, card, "nl") is None
    assert cv.width_problem(2048, torch.float32, card, "nl") is None
    assert cv.width_problem(2048, torch.float64, card, "nl") is None


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_vgnlse_kernel_with_an_empty_polarization_is_the_scalar_kernel(card, rdt):
    """A_y = 0: K9 on the pulses is K6 on their x parts at the same gamma
    (the rotation's angle reduces to K6's; the y part stays exactly 0)."""
    t, co, _ = _vector_inputs(6, 1024, rdt, card, "cnlse")
    A0 = t[0].clone()
    A0[:, 1] = 0
    ph = t[4][0].contiguous()                        # no birefringence: both rows alike
    ph = torch.stack([ph, ph]).contiguous()
    kw = dict(dz_m=0.02, n_steps=50, save_every=10)
    rv = cv.solve_vgnlse_batch_cuda(A0, t[1], t[2], t[3], ph, **kw)
    rs = cg.solve_gnlse_batch_cuda(A0[:, 0].contiguous(), t[1], t[2], ph[0].contiguous(), **kw)
    torch.cuda.synchronize()
    assert bool(rv.ok.all()) and bool(rs.ok.all()) and not bool(rv.A_end[:, 1].abs().any())
    assert _normwise(rv.A_end[:, 0], rs.A_end) <= SSFM_TOL[rdt]
    torch.testing.assert_close(rv.peak_max[:, 0], rs.peak_max, rtol=SSFM_TOL[rdt], atol=0)


def test_solve_vgnlse_batch_auto_runs_the_kernel(card):
    t, co, _ = _vector_inputs(8, 256, torch.float64, card, "manakov")
    A0 = t[0].cpu().numpy()
    grid = tv.TimeGrid.for_pulse(1e-12, n_samples=256)
    nl = tg.make_nl_terms(grid, f_raman=0.18, omega0=1.2e15)
    for integrator, precision, use_nl, name in (("rk4", "df32", False, "vgnlse_ssfm_f64"),
                                                ("rk4", "x32", True, "vgnlse_ssfm_nl_f32"),
                                                ("rk45", "x64", False, None),
                                                ("rk4ip", "x64", True, None)):
        cfg = T.custom_simulation_config(z_max=0.5, dz=0.05, save_every=3, integrator=integrator,
                                         precision=precision, rtol=1e-9, atol=1e-12)
        cof = tv.make_vgnlse_coeffs(grid, T.DispersionParams.from_betas(1.2e15, beta2=-2e-26),
                                    gamma_W_m=2e-3, alpha_1_m=5e-5, coupling="manakov",
                                    precision=precision)
        kw = dict(nl=nl if use_nl else None)
        _build.LAUNCHES.clear()
        pk, A, ok = tv.solve_vgnlse_batch(cfg, cof, A0, **kw)
        assert _build.LAUNCHES == ({name: 1} if name else {}) and ok.all()
        pk2, A2, ok2 = tv.solve_vgnlse_batch(cfg, cof, A0, engine="torch", device=card, **kw)
        assert _build.LAUNCHES == ({name: 1} if name else {})
        bar = 1e-4 if precision == "x32" else 1e-11
        assert np.max(np.abs(A - A2).max((-2, -1)) / np.abs(A2).max((-2, -1))) <= bar
        if name is None:
            with pytest.raises(ValueError, match="rk4 only"):
                tv.solve_vgnlse_batch(cfg, cof, A0, engine="cuda", **kw)


# ---------------------------------------------------------------------------
# K1t: the 4-wave RK4 in tangent mode (csrc/fwm4_tangent.cu)
# ---------------------------------------------------------------------------

from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_tangent as ct  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import calibrate as tcal  # noqa: E402,E501


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("state", [False, True], ids=["fit", "launch"])
def test_tangent_kernel_matches_plain_version(card, rdt, state):
    """130 lanes (not a multiple of a block), 3 fit or 11 directions, 253
    steps: fp64 within 1e-11 (state) and 1e-10 (tangents, normwise a lane
    and direction) of the plain version, fp32 within 1e-4 of the fp64 one."""
    B, n = 130, 253
    rng = np.random.default_rng(8)
    coef = torch.tensor(np.stack([rng.uniform(5e-3, 2e-2, B), rng.uniform(0.0, 1e-3, B),
                                  rng.uniform(-0.05, 0.05, B)]), device=card)
    A = np.sqrt([0.5, 0.5, 1e-5, 1e-6]) * np.exp(1j * rng.uniform(0.0, 6.0, (B, 4)))
    y0 = torch.tensor(np.concatenate([A.real.T, A.imag.T]), device=card).contiguous()
    t0, s = ct.directions(B, coef=True, state=state, dtype=torch.float64, device=card)
    y_p, t_p = ct.solve_tangent_torch(coef, y0, t0, s, dz_m=0.4, n_steps=n)
    name = f"fwm4_tangent_{'f64' if rdt == torch.float64 else 'f32'}"
    launches = _build.LAUNCHES[name]
    y_k, t_k = ct.solve_tangent_cuda(*(x.to(rdt).contiguous() for x in (coef, y0, t0, s)),
                                     dz_m=0.4, n_steps=n)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == launches + 1
    bars = (1e-11, 1e-10) if rdt == torch.float64 else (1e-4, 1e-4)
    D = t0.shape[1] // B
    ey = (y_k.double() - y_p).abs().amax(dim=0) / y_p.abs().amax(dim=0)
    et = ((t_k.double() - t_p).reshape(8, D, B).norm(dim=0)
          / t_p.reshape(8, D, B).norm(dim=0))
    assert float(ey.max()) <= bars[0] and float(et.max()) <= bars[1]


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("state", [False, True], ids=["fit", "launch"])
@pytest.mark.parametrize("group", [1, 4], ids=["g1", "g4"])
def test_tangent_designs_match_plain_version_and_each_other(card, rdt, state, group):
    """Each design's own launcher (a lane-direction on ``group`` threads):
    the bars of ``test_tangent_kernel_matches_plain_version``, no launch
    counted, and the group of 4 equal to the one thread bit for bit."""
    B, n = 130, 253
    rng = np.random.default_rng(9)
    coef = torch.tensor(np.stack([rng.uniform(5e-3, 2e-2, B), rng.uniform(0.0, 1e-3, B),
                                  rng.uniform(-0.05, 0.05, B)]), device=card)
    A = np.sqrt([0.5, 0.5, 1e-5, 1e-6]) * np.exp(1j * rng.uniform(0.0, 6.0, (B, 4)))
    y0 = torch.tensor(np.concatenate([A.real.T, A.imag.T]), device=card).contiguous()
    t0, s = ct.directions(B, coef=True, state=state, dtype=torch.float64, device=card)
    y_p, t_p = ct.solve_tangent_torch(coef, y0, t0, s, dz_m=0.4, n_steps=n)
    args = [x.to(rdt).contiguous() for x in (coef, y0, t0, s)]
    launches = dict(_build.LAUNCHES)
    y_k, t_k = ct.solve_tangent_design(*args, dz_m=0.4, n_steps=n, group=group)
    y_1, t_1 = ct.solve_tangent_design(*args, dz_m=0.4, n_steps=n, group=1)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == launches
    assert torch.equal(y_k, y_1) and torch.equal(t_k, t_1)
    bars = (1e-11, 1e-10) if rdt == torch.float64 else (1e-4, 1e-4)
    D = t0.shape[1] // B
    ey = (y_k.double() - y_p).abs().amax(dim=0) / y_p.abs().amax(dim=0)
    et = ((t_k.double() - t_p).reshape(8, D, B).norm(dim=0)
          / t_p.reshape(8, D, B).norm(dim=0))
    assert float(ey.max()) <= bars[0] and float(et.max()) <= bars[1]


def test_fit_on_the_card_is_one_tangent_launch_a_step(card):
    """``fit_gain_curve`` on the card launches K1t once an adam step and
    once for the curve at the fitted parameters, and follows the CPU fit
    (the plain version) to 1e-9."""
    cfg = T.custom_simulation_config(z_max=100.0, dz=5.0, save_every=2)
    db = np.linspace(-0.05, 0.03, 8)
    p_in = [0.5, 0.5, 1e-5, 0.0]
    with torch.no_grad():
        curve = tcal.make_gain_model(cfg, p_in=p_in, device="cpu")(T.RHSCoeffs(
            0.0115, 2e-4, torch.tensor(db - 3e-3))).numpy()
    kw = dict(delta_beta_grid=db, measured_gain_db=curve, p_in=p_in, steps=6,
              init=dict(gamma=0.008), tol_db=0.0)
    _build.LAUNCHES.clear()
    fc = tcal.fit_gain_curve(cfg, **kw, device=card)
    assert dict(_build.LAUNCHES) == {"fwm4_tangent_f64": 7}
    fh = tcal.fit_gain_curve(cfg, **kw, device="cpu")
    np.testing.assert_allclose(fc.loss_history, fh.loss_history, rtol=1e-9)
    for k, v in fh.params.items():
        assert fc.params[k] == pytest.approx(v, rel=1e-9, abs=1e-15)
