"""The port's instrumentation, ``utils/observability.py`` and
``utils/debug.py``, on the CPU: the cases of the JAX package's
``tests/test_resume_observability.py`` (throughput meter, run log, profiler
trace, the checked RHS through an integration) on the port, plus the
contract of the checks: a failure inside ``run_checked`` is recorded, not
raised mid-integration, and a non-finite result also fails."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.ops.integrators import (  # noqa: E402
    integrate_fixed_grid,
)
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.utils.debug import (  # noqa: E402
    checked_rhs,
    run_checked,
)
from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.utils.observability import (  # noqa: E402
    ThroughputMeter,
    log_run,
    profile_trace,
)


def test_throughput_meter():
    m = ThroughputMeter(label="test")
    m.tick(10)
    m.tick(5)
    assert m.count == 15
    assert m.per_second > 0
    s = m.summary()
    assert "Throughput" in s and "test" in s


def test_log_run(tmp_path):
    p = log_run(tmp_path / "runs.jsonl", {"experiment": "x", "gain_db": 12.5})
    p = log_run(p, {"experiment": "y"})
    lines = p.read_text().strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[0])
    assert rec["experiment"] == "x" and rec["gain_db"] == 12.5
    assert "timestamp_utc" in rec and "backend" in rec
    # the torch device kind: the card when there is one
    assert rec["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert "torch_version" in rec


@pytest.mark.parametrize("link", [False, True])
def test_profile_trace_writes_a_chrome_trace(tmp_path, capsys, link):
    with profile_trace(str(tmp_path / "trace"), create_perfetto_link=link):
        _ = torch.ones(16) * 2.0
    traces = list((tmp_path / "trace").glob("psa_torch_trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mul" in str(e.get("name", "")) for e in events)
    assert ("Perfetto" in capsys.readouterr().out) == link


def test_profile_trace_writes_its_trace_on_an_error(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profile_trace(str(tmp_path)):
            _ = torch.ones(4) + 1.0
            1 / 0
    assert len(list(tmp_path.glob("psa_torch_trace_*.json"))) == 1


def _blowup(z, y, p):
    return p * y * y


def _solve(rhs):
    def solve(y0, lam):
        return integrate_fixed_grid(
            rhs, y0, lam, z0=0.0, dz=0.05, n_steps=100, save_every=100,
            check_nan=False,
        ).y_final
    return solve


def test_checked_rhs_catches_nonfinite():
    """The blowup RHS fails inside run_checked and surfaces through
    err.throw() with the check's name; a healthy run raises nothing."""
    rhs_dbg = checked_rhs(_blowup, name="blowup")
    y0 = torch.tensor([1.0], dtype=torch.float64)
    err, out = run_checked(_solve(rhs_dbg), y0, torch.tensor(50.0, dtype=torch.float64))
    assert err.get() is not None and "blowup" in err.get()
    with pytest.raises(FloatingPointError, match="blowup: non-finite derivative"):
        err.throw()

    err2, out2 = run_checked(_solve(rhs_dbg), y0, torch.tensor(0.1, dtype=torch.float64))
    err2.throw()
    assert err2.get() is None
    assert np.isfinite(out2.numpy()).all()


def test_a_failed_check_is_recorded_not_raised_mid_integration():
    """The integration runs to its end (all 100 steps are taken) although
    the RHS goes non-finite early; outside run_checked the same wrapper
    raises at the first non-finite derivative."""
    calls = []

    def counting(z, y, p):
        calls.append(z)
        return _blowup(z, y, p)

    rhs_dbg = checked_rhs(counting, name="blowup")
    y0 = torch.tensor([1.0], dtype=torch.float64)
    lam = torch.tensor(50.0, dtype=torch.float64)
    err, _ = run_checked(_solve(rhs_dbg), y0, lam)
    assert err.get() is not None
    assert len(calls) == 4 * 100          # every RK4 stage of every step ran
    calls.clear()
    with pytest.raises(FloatingPointError, match="blowup"):
        _solve(rhs_dbg)(y0, lam)
    assert len(calls) < 4 * 100


def test_a_nonfinite_result_fails_without_a_checked_rhs():
    """As checkify's float checks: a NaN/inf in the result fails, also in
    a tuple or a complex tensor."""
    err, out = run_checked(lambda x: (x / 0.0, 1), torch.ones(3))
    assert err.get() is not None and "non-finite" in err.get()
    with pytest.raises(FloatingPointError):
        err.throw()
    err, _ = run_checked(lambda x: x * complex(float("nan"), 0.0), torch.ones(2))
    assert err.get() is not None
    err, out = run_checked(lambda x: {"y": x + 1.0, "n": torch.arange(3)}, torch.ones(2))
    err.throw()
    assert torch.equal(out["y"], torch.full((2,), 2.0))
