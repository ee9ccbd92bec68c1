"""The kernel module of the PyTorch port, ``ops/cuda_solver.py``.

On the CPU its plain version, ``solve_batch_torch``, is held against the
JAX package's solvers on the same seeded inputs:

- fp64 rk4/ab4/abm4 vs ``sweep.solve_batch(precision='x64', engine='scan',
  frame='rotating')`` at rtol 1e-12 (the same float64 arithmetic; rounding
  differences of ~1e-16 per step over 250 steps);
- fp32 rk4 vs the JAX x32 Pallas kernel in interpret mode at rtol 1e-5 in
  ``P_max`` (the float32 class ``tests/test_pallas.py`` uses).

The CUDA kernel itself is compared with the plain version on the card in
``tests/test_torch_kernel.py`` and ``chip_smoke.py``.  The wrapper's
refusals and the build's failure path are tested here.
"""

import re
import stat
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psa_torch as T  # noqa: E402
import psa_tpu as J  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.ops import pallas_solver as jpallas  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu.parallel import sweep as jsweep  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import _build  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_solver as cs  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import sweep as tsweep  # noqa: E402

torch.set_num_threads(1)


def _case(B=9, seed=0):
    """The inputs of tests/test_pallas.py::_case."""
    rng = np.random.default_rng(seed)
    A0 = np.broadcast_to(np.sqrt([0.1, 0.1, 1e-6, 0.0]).astype(np.complex128), (B, 4)).copy()
    return A0, np.full(B, 0.0115), np.full(B, 1.15e-4), rng.uniform(-0.05, 0.05, B)


def _nan_case():
    """Lane 1 blows up in its first steps (tests/test_pallas.py:71-80)."""
    A0 = np.array([[0.3, 0.3, 1e-3, 0.0], [1e4, 1e4, 1.0, 0.0]], dtype=np.complex128)
    return A0, np.array([0.01, 1e3]), np.zeros(2), np.zeros(2)


def _tensors(A0, g, a, db, rdt=torch.float64, device="cpu"):
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    return (torch.as_tensor(A0, dtype=cdt, device=device),
            *(torch.as_tensor(v, dtype=rdt, device=device) for v in (g, a, db)))


def _jax_scan(A0, g, a, db, *, n_steps, dz, method, save_every=10):
    cfg = J.custom_simulation_config(z_max=n_steps * dz, dz=dz, save_every=save_every,
                                     precision="x64", integrator=method)
    return jsweep.solve_batch(cfg, J.RHSCoeffs(gamma=g, alpha=a, delta_beta=db), A0,
                              frame="rotating", engine="scan")


@pytest.mark.parametrize("method", ["rk4", "ab4", "abm4"])
@pytest.mark.parametrize("n_steps", [250, 253])
def test_plain_fp64_matches_jax_x64_scan(method, n_steps):
    A0, g, a, db = _case()
    r = cs.solve_batch_torch(*_tensors(A0, g, a, db), dz_m=0.2, n_steps=n_steps,
                             save_every=10, integrator=method)
    rj = _jax_scan(A0, g, a, db, n_steps=n_steps, dz=0.2, method=method)
    assert r.P_max.dtype == torch.float64 and r.A_end.dtype == torch.complex128
    np.testing.assert_array_equal(r.ok.numpy(), rj.ok)
    np.testing.assert_allclose(r.P_max.numpy(), rj.P_max, rtol=1e-12, atol=0)
    np.testing.assert_allclose(r.A_end.numpy(), rj.A_end, rtol=1e-12, atol=0)


def test_plain_fp32_matches_jax_x32_pallas_interpret():
    A0, g, a, db = _case()
    r = cs.solve_batch_torch(*_tensors(A0, g, a, db, rdt=torch.float32), dz_m=0.2,
                             n_steps=250, save_every=10)
    rp = jpallas.solve_batch_pallas(A0, g, a, db, dz_m=0.2, n_steps=250, save_every=10,
                                    interpret=True)
    assert r.P_max.dtype == torch.float32 and r.A_end.dtype == torch.complex64
    np.testing.assert_array_equal(r.ok.numpy(), rp.ok)
    np.testing.assert_allclose(r.P_max.numpy(), rp.P_max, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(r.A_end.numpy(), rp.A_end, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("method", ["rk4", "abm4"])
def test_nan_lane_freezes_like_jax(method):
    A0, g, a, db = _nan_case()
    r = cs.solve_batch_torch(*_tensors(A0, g, a, db), dz_m=0.5, n_steps=40, save_every=10,
                             integrator=method)
    rj = _jax_scan(A0, g, a, db, n_steps=40, dz=0.5, method=method)
    assert r.ok.tolist() == [True, False] == rj.ok.tolist()
    assert torch.isfinite(r.P_max).all() and torch.isfinite(r.A_end).all()
    np.testing.assert_allclose(r.P_max.numpy(), rj.P_max, rtol=1e-12, atol=0)
    np.testing.assert_allclose(r.A_end.numpy(), rj.A_end, rtol=1e-12, atol=0)
    if method == "rk4":
        rp = jpallas.solve_batch_pallas(A0, g, a, db, dz_m=0.5, n_steps=40, save_every=10,
                                        interpret=True)
        assert rp.ok.tolist() == r.ok.tolist()


@pytest.mark.parametrize("frame", ["rotating", "lab"])
def test_check_nan_off_matches_jax_scan(frame):
    """With ``check_nan=False`` no lane freezes and ``ok`` stays set, in both
    frames, as in the JAX x64 scan engine; the healthy lane is unchanged."""
    A0, g, a, db = _nan_case()
    kw = dict(z_max=20.0, dz=0.5, save_every=10, precision="x64", check_nan=False)
    coeffs = dict(gamma=g, alpha=a, delta_beta=db)
    with np.errstate(all="ignore"):
        r = tsweep.solve_batch(T.custom_simulation_config(**kw), T.RHSCoeffs(**coeffs), A0,
                               frame=frame, device="cpu")
        rj = jsweep.solve_batch(J.custom_simulation_config(**kw), J.RHSCoeffs(**coeffs), A0,
                                frame=frame, engine="scan")
    assert r.ok.tolist() == [True, True] == rj.ok.tolist()
    assert not np.isfinite(r.A_end[1]).all() and not np.isfinite(rj.A_end[1]).all()
    np.testing.assert_allclose(r.P_max[0], rj.P_max[0], rtol=1e-12, atol=0)
    np.testing.assert_allclose(r.A_end[0], rj.A_end[0], rtol=1e-12, atol=0)


def test_kernel_path_refuses_cpu_and_bad_inputs():
    A0, g, a, db = _case(B=3)
    t = _tensors(A0, g, a, db)
    launches = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cs.solve_batch_cuda(*t, dz_m=0.2, n_steps=10, save_every=10)
    with pytest.raises(ValueError, match="gamma"):
        cs.solve_batch_torch(t[0], t[1].float(), t[2], t[3], dz_m=0.2, n_steps=10,
                             save_every=10)
    with pytest.raises(ValueError, match="integrator"):
        cs.solve_batch_torch(*t, dz_m=0.2, n_steps=10, save_every=10, integrator="rk45")
    cfg = T.custom_simulation_config(z_max=2.0, dz=0.2)
    coeffs = T.RHSCoeffs(g, a, db)
    with pytest.raises(ValueError, match="CUDA device"):
        tsweep.solve_batch(cfg, coeffs, A0, engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tsweep.solve_batch(cfg, coeffs, A0, engine="pallas", device="cpu")
    with pytest.raises(TypeError, match="mesh must be"):
        tsweep.solve_batch(cfg, coeffs, A0, mesh=object(), device="cpu")
    assert dict(_build.LAUNCHES) == launches


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cu").write_text("this is not C++\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'broken.cu(1): error: expected a declaration' >&2\nexit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "toolkit"))
    monkeypatch.setenv("PATH", str(tmp_path))
    _build.build.cache_clear()
    try:
        assert _build.find_nvcc() == str(nvcc)
        with pytest.raises(_build.KernelBuildError, match="expected a declaration"):
            _build.build()
    finally:
        _build.build.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_compiles_every_source_and_logs_its_seconds(tmp_path, monkeypatch):
    """Every source gets its own nvcc run; each library's log starts with
    the seconds that run took, then what nvcc printed."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("one", "two"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo "ptxas info    : Used 10 registers" >&2\n: > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "toolkit"))
    monkeypatch.setenv("PATH", str(tmp_path))
    _build.build.cache_clear()
    try:
        libs = _build.build()
        assert sorted(libs) == ["one", "two"] and all(p.exists() for p in libs.values())
        seconds = _build.build_seconds()
        assert sorted(seconds) == ["one", "two"] and all(s >= 0.0 for s in seconds.values())
        assert _build.build_log().count("Used 10 registers") == 2
        assert not list((tmp_path / "build").glob("*.tmp"))
    finally:
        _build.build.cache_clear()


PKG_FILE = ("psa_simulation_ode_rk_mvp_dispersion_tpu_torch", "ops", "_build.py")


def test_a_checkout_builds_into_its_build_directory(tmp_path):
    """From this checkout, and from any tree with a pyproject.toml beside
    the package, the libraries go to ``<root>/build/psa_torch_kernels``
    (which .gitignore lists)."""
    root = Path(__file__).resolve().parent.parent
    assert _build.BUILD_DIR == root / "build" / "psa_torch_kernels"
    (tmp_path / "pyproject.toml").write_text("[project]\n")
    assert _build.build_dir(tmp_path.joinpath(*PKG_FILE)) == (
        tmp_path.resolve() / "build" / "psa_torch_kernels")


@pytest.mark.parametrize("xdg", [True, False], ids=["XDG_CACHE_HOME", "home-cache"])
def test_an_installed_package_builds_into_the_user_cache(tmp_path, monkeypatch, xdg):
    """With no checkout root above the package (site-packages), the
    libraries go to ``$XDG_CACHE_HOME/psa_torch_kernels``, else to
    ``~/.cache/psa_torch_kernels``, never beside the package."""
    site = tmp_path / "lib" / "site-packages"
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if xdg:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
        want = tmp_path / "cache" / "psa_torch_kernels"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        want = tmp_path / "home" / ".cache" / "psa_torch_kernels"
    assert _build.build_dir(site.joinpath(*PKG_FILE)) == want


def test_a_build_directory_that_cannot_be_made_raises_a_build_error(tmp_path, monkeypatch):
    """mkdir refused (a read-only site-packages) is a KernelBuildError that
    names the directory, not a PermissionError."""
    target = tmp_path / "ro" / "psa_torch_kernels"

    def refuse(self, *a, **k):
        raise PermissionError(13, "Permission denied", str(self))

    monkeypatch.setattr(_build, "BUILD_DIR", target)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(Path, "mkdir", refuse)
    _build.build.cache_clear()
    try:
        with pytest.raises(_build.KernelBuildError,
                           match=re.escape(f"cannot make the kernel build directory {target}")):
            _build.build()
    finally:
        _build.build.cache_clear()


def test_plain_fp32_stays_close_to_fp64_over_the_bench_run():
    """Bench configuration (bench.py:190-220), 2,500 steps, signals at the
    gain band's edge, where the gain is most sensitive to rounding.  With the
    compensated state update the float32 P_max stays within 1e-5 of float64
    (without it the error there is 5.9e-5)."""
    lam3 = np.linspace(1566.8e-9, 1567.6e-9, 8)
    disp = T.dispersion_params_from_D_S(
        float(T.lambda_from_omega(0.5 * (T.omega_from_lambda(1550e-9)
                                         + T.omega_from_lambda(1555e-9)))),
        0.2, 0.02, D_units="ps/nm/km", S_units="ps/nm^2/km")
    _, dbeta = T.dbeta_spectrum(lambda_p1_m=1550e-9, lambda_p2_m=1555e-9,
                                lambda_signal_m=lam3, dispersion=disp, device="cpu")
    B = lam3.size
    A0 = np.broadcast_to(np.sqrt([0.5, 0.5, 1e-7, 1e-7]).astype(np.complex128), (B, 4)).copy()
    g, a = np.full(B, 0.0115), np.full(B, np.log(10.0) / 10.0 * 0.5e-3)
    t32 = _tensors(A0, g, a, dbeta, rdt=torch.float32)
    t64 = (t32[0].to(torch.complex128), *(x.double() for x in t32[1:]))
    kw = dict(dz_m=0.2, n_steps=2500, save_every=10)
    r32, r64 = cs.solve_batch_torch(*t32, **kw), cs.solve_batch_torch(*t64, **kw)
    err = ((r32.P_max.double() - r64.P_max) / r64.P_max).abs().max()
    assert float(err) < 1e-5
