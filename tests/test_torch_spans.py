"""The port's spans and counters (``utils/observability``) on the CPU.

Under ``torch.profiler`` each call the benchmark's cells make emits the
documented tree of ``psa.`` spans (names, nesting, one entry span a call);
with no profiler recording a span is the shared null context and no span,
mark or wait is issued; the ``k3`` mark of an rk45 solve counts the
attempts of its plain version; and every result is the same, bit for bit,
with the profiler on and off.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psa_simulation_ode_rk_mvp_dispersion_tpu_torch import custom_simulation_config  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.models import nwave  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import cuda_adaptive  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import dispersion  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops import phase_matching as pm  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops.rhs import RHSCoeffs  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import sweep  # noqa: E402
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.utils import observability as obs  # noqa: E402

torch.set_num_threads(1)

LAM1, LAM2 = 1550e-9, 1555e-9


def _spectrum(integrator):
    """A 5-point gain spectrum near the pumps, 4 m (the benchmark's
    ``fwm4_main_py`` physics, shortened: the profiler's cost grows with the
    operations it records)."""
    lam = np.linspace(1556e-9, 1566e-9, 5)
    _, _, disp = pm.dispersion_at_pump_center(LAM1, LAM2, float(lam[0]), D=0.2, S=0.02)
    cfg = custom_simulation_config(z_max=4.0, dz=0.2, integrator=integrator, save_every=10,
                                   precision="x64", rtol=1e-9, atol=1e-12)
    return sweep.gain_spectrum(
        cfg=cfg, lambda_p1_m=LAM1, lambda_p2_m=LAM2, lambda_signal_m=lam, gamma=11.5e-3,
        alpha=1.15e-4, p_in=(0.5, 0.5, 1e-7, 1e-7), dispersion=disp,
        phase_matching_cfg=pm.PhaseMatchingConfig(
            method=pm.PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4,
            atol=0.0, rtol=1e-12),
        length_unit="m", gain_unit="dB", gain_mode="max", device="cpu")


def _comb(n_slots=1):
    """Six 16-line combs, 8 steps: ``make_comb_coeffs`` then
    ``solve_comb_batch``, as the benchmark's comb cells call them."""
    n, B = 16, 6
    grid = nwave.CombGrid.centered(2 * np.pi * 193.1e12, 2 * np.pi * 50e9, n)
    disp = dispersion.DispersionParams.from_betas(2 * np.pi * 193.1e12, beta2=-1e-27,
                                                  beta3=1.2e-41)
    rng = np.random.default_rng(7)
    A0 = np.sqrt(1e-9) * np.exp(2j * np.pi * rng.random((B, n)))
    A0[:, [n // 2 - 2, n // 2 + 2]] = np.sqrt(0.5)
    one = nwave.make_comb_coeffs(grid, disp, gamma_W_m=1.0, alpha_1_m=5e-5)
    coeffs = nwave.NWaveCoeffs(gamma=np.linspace(5e-3, 15e-3, B), alpha=5e-5,
                               beta_lin=one.beta_lin)
    cfg = custom_simulation_config(z_max=4.0, dz=0.5, integrator="rk4", save_every=4,
                                   precision="x64")
    mesh = tmesh.default_mesh(n_slots, device="cpu") if n_slots > 1 else None
    return nwave.solve_comb_batch(cfg, coeffs, A0, length_unit="m", mesh=mesh,
                                  device=None if mesh else "cpu")


def _profiled(fn):
    """``(fn's result, the psa. spans and marks as a tree)``: each node is
    ``(name, [children])``, in order of start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = sorted(((e.time_range.start, -e.time_range.end, e.name, e.time_range.end)
                  for e in prof.events() if e.name.startswith("psa.")))
    root = ("", [])
    stack = [(root, float("inf"))]
    for start, _neg, name, end in evs:
        while stack[-1][1] < end or stack[-1][1] <= start:
            stack.pop()
        node = (name, [])
        stack[-1][0][1].append(node)
        stack.append((node, end))
    return out, root[1]


def _names(tree):
    return [n for n, _c in tree]


def _shape(tree):
    """The tree with the k3 mark's values dropped."""
    return [(n.split(" attempts=")[0], _shape(c)) for n, c in tree]


GAIN_TAIL = [("psa.wait", []), ("psa.fetch", [])]


@pytest.mark.parametrize("integrator", ["rk4", "rk45"])
def test_a_gain_spectrum_emits_its_span_tree(integrator):
    _res, tree = _profiled(lambda: _spectrum(integrator))
    assert _names(tree) == ["psa.sweep.spectrum"]
    kernel = "psa.k3.plain" if integrator == "rk45" else "psa.k1.plain"
    marks = [("psa.fetch", []), ("psa.count k3", [])] if integrator == "rk45" else []
    assert _shape(tree[0][1]) == [
        ("psa.sweep.plan", []), ("psa.sweep.inputs", []), (kernel, []), *GAIN_TAIL, *marks,
        ("psa.sweep.gain", []), ("psa.sweep.gain", [])]


def test_a_comb_call_emits_its_span_tree():
    _res, tree = _profiled(_comb)
    assert _shape(tree) == [
        ("psa.make_comb_coeffs", []),
        ("psa.solve_comb_batch", [("psa.nwave.inputs", []), ("psa.k4.plain", []),
                                  ("psa.wait", []), ("psa.fetch", [])])]


def test_a_comb_call_over_a_four_slot_mesh_emits_its_span_tree():
    _res, tree = _profiled(lambda: _comb(4))
    assert _names(tree) == ["psa.make_comb_coeffs", "psa.solve_comb_batch"]
    call = tree[1][1]
    assert _names(call) == ["psa.nwave.inputs", "psa.mesh.shard"] + ["psa.k4.plain"] * 4 + [
        "psa.wait", "psa.mesh.gather"]
    # P_max, A_end and ok: each slot's block fetched once
    assert _shape(call[-1][1]) == [("psa.fetch", [])] * 12
    assert all(not c for n, c in call[:-1])


def test_with_no_profiler_a_span_is_the_shared_null_context(monkeypatch):
    assert not obs.tracing()
    assert obs.span("psa.anything") is obs.span("psa.other") is obs._OFF

    def refuse(*_a, **_k):
        raise AssertionError("a span or mark was made with no profiler recording")

    class NoInt:
        def __int__(self):
            raise AssertionError("count formatted its values with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    obs.count("k3", attempts=NoInt(), accepted=NoInt(), lanes=NoInt())
    obs.wait(torch.device("cuda", 0))
    with obs.span("psa.x"):
        pass
    # the solvers' own spans, marks and waits, end to end
    _spectrum("rk45")
    _comb(4)


def test_the_k3_mark_counts_the_plain_versions_attempts():
    lanes = 7
    lam = np.linspace(1556e-9, 1566e-9, lanes)
    _, _, disp = pm.dispersion_at_pump_center(LAM1, LAM2, float(lam[0]), D=0.2, S=0.02)
    om, _valid = sweep._batched_plan_from_wavelengths(LAM1, LAM2, torch.as_tensor(lam))
    dbeta = sweep._batched_delta_beta(om, disp, pm.PhaseMatchingConfig(
        method=pm.PhaseMatchingMethod.SYMMETRIC_EVEN, even_orders=(2, 4), max_order=4))
    A0 = np.broadcast_to(np.sqrt([0.5, 0.5, 1e-7, 1e-7]).astype(np.complex128), (lanes, 4))
    coeffs = RHSCoeffs(np.full(lanes, 11.5e-3), np.full(lanes, 1.15e-4), dbeta.numpy())
    cfg = custom_simulation_config(z_max=4.0, dz=0.2, integrator="rk45", save_every=10,
                                   precision="x64", rtol=1e-9, atol=1e-12)
    _res, tree = _profiled(lambda: sweep.solve_batch(cfg, coeffs, A0, device="cpu"))
    marks = [n for n, _c in tree if n.startswith(obs.COUNT_PREFIX)]
    assert len(marks) == 1
    values = dict(kv.split("=") for kv in marks[0].split()[2:])
    assert marks[0].split()[:2] == ["psa.count", "k3"]

    r = cuda_adaptive.solve_batch_rk45_torch(
        torch.as_tensor(A0.copy()), torch.full((lanes,), 11.5e-3, dtype=torch.float64),
        torch.full((lanes,), 1.15e-4, dtype=torch.float64), dbeta, dz_m=0.2, n_steps=20,
        save_every=10, rtol=1e-9, atol=1e-12, max_steps=cfg.max_steps)
    assert int(values["attempts"]) == int((r.n_accepted + r.n_rejected).sum())
    assert int(values["accepted"]) == int(r.n_accepted.sum())
    assert int(values["lanes"]) == lanes
    assert int(values["attempts"]) > int(values["accepted"]) > 0


def test_a_mesh_marks_k3_once_a_slot():
    cfg = custom_simulation_config(z_max=4.0, dz=0.2, integrator="rk45", save_every=10,
                                   precision="x64", rtol=1e-9, atol=1e-12)
    lanes = 6
    coeffs = RHSCoeffs(np.full(lanes, 11.5e-3), np.zeros(lanes), np.linspace(-0.02, 0.02, lanes))
    A0 = np.broadcast_to(np.sqrt([0.5, 0.5, 1e-7, 1e-7]).astype(np.complex128), (lanes, 4))
    _res, tree = _profiled(lambda: sweep.solve_batch(
        cfg, coeffs, A0, mesh=tmesh.default_mesh(4, device="cpu")))
    marks = [n for n, _c in tree if n.startswith(obs.COUNT_PREFIX)]
    gather = _names(tree).index("psa.mesh.gather")
    assert [_names(tree).index(m) > gather for m in marks] == [True] * 4
    # 6 lanes padded to 8: two rows a slot
    assert [m.split()[-1] for m in marks] == ["lanes=2"] * 4


@pytest.mark.parametrize("call", ["rk4", "rk45", "comb", "comb-mesh"])
def test_results_are_the_same_bit_for_bit_with_tracing_on_and_off(call):
    def run():
        if call == "comb":
            return _comb()
        if call == "comb-mesh":
            return _comb(4)
        r = _spectrum(call)
        return r.gain, r.ok, r.x
    off = run()
    on, _tree = _profiled(run)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
