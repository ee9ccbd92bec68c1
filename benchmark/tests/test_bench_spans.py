"""The readers of the port's spans and counters (``benchmark/metrics/_spans.py``
and the metrics that use it): on a hand-made trace, on the traced CPU run of
every cell, and against the benchmark's contract for a per-layer metric."""

from __future__ import annotations

import importlib
import json
import re
import time
from pathlib import Path

import pytest

from benchmark import run
from benchmark import trace as tr
from benchmark.metrics import _spans

ROOT = Path(__file__).resolve().parents[2]
NEW = ("inputs_ms_per_job", "launch_ms_per_job", "wait_ms_per_job", "assembly_ms_per_job",
       "mesh_host_ms_per_job", "k3_attempts_per_lane", "k3_accepted_pct",
       "idle_outside_spans_pct")
SEED = 2**31 + 977


def _reader(name):
    return importlib.import_module(f"benchmark.metrics.{name}")


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": args}


def _span(name, ts, dur):
    return _x(name, "user_annotation", ts, dur)


def _kernel(ts, dur, device=0):
    return _x("comb_rk_kernel<double, 0, 2>", "kernel", ts, dur, device=device)


def _events():
    """Two jobs of 1,000 us in a 2,100-us window.  Job 1: the entry span
    holds the plan (with 100 host operations, more than ``Trace.idle_gaps``
    looks back over), a launch, a wait while the card runs, a fetch with a
    k3 mark, the gain.  Job 2: a mesh's shard and gather, the gather holding
    a fetch, and 50 us of the job outside every ``psa.`` span."""
    ev = [_span("bench.window", 0, 2100), _span("bench.job", 0, 1000),
          _span("bench.job", 1050, 1000)]
    ev += [_span("psa.sweep.spectrum", 0, 1000), _span("psa.sweep.plan", 10, 390)]
    ev += [_x("aten::mul", "cpu_op", 20 + i, 0.5) for i in range(100)]
    ev += [_span("psa.k3.launch", 400, 100), _span("psa.wait", 500, 300),
           _span("psa.fetch", 800, 50), _span("psa.count k3 attempts=120 accepted=100 lanes=4",
                                              850, 0),
           _span("psa.sweep.gain", 900, 80)]
    ev += [_kernel(450, 400)]                      # card 0 busy 450-850 in job 1
    ev += [_span("psa.solve_comb_batch", 1050, 950), _span("psa.mesh.shard", 1100, 200),
           _span("psa.k4.launch", 1300, 100), _span("psa.wait", 1400, 300),
           _span("psa.mesh.gather", 1700, 250), _span("psa.fetch", 1750, 100),
           _kernel(1380, 320)]                     # job 2: 1,380-1,700
    ev += [_span("psa.count k3 attempts=80 accepted=70 lanes=4", 1960, 0)]
    return ev


@pytest.fixture
def trace():
    return tr.Trace(_events(), tr.Cell("hand-made", {"physics": {}}, {}, 4, 1))


def test_self_times_take_out_each_spans_children(trace):
    own = {(o.name, o.start): t for o, t in _spans.self_times(_spans.spans(trace))}
    assert own[("psa.sweep.spectrum", 0)] == 1000 - (390 + 100 + 300 + 50 + 80)
    assert own[("psa.sweep.plan", 10)] == 390
    assert own[("psa.solve_comb_batch", 1050)] == 950 - (200 + 100 + 300 + 250)
    assert own[("psa.mesh.gather", 1700)] == 150
    assert not any(o.name.startswith("psa.count") for o in _spans.spans(trace))


def test_each_layer_per_job(trace):
    values = {name: _reader(name).read(trace) for name in NEW}
    ms = 1e-3 / 2   # two jobs
    assert values["inputs_ms_per_job"] == pytest.approx((80 + 390 + 100) * ms)
    assert values["launch_ms_per_job"] == pytest.approx(200 * ms)
    assert values["wait_ms_per_job"] == pytest.approx(600 * ms)
    assert values["assembly_ms_per_job"] == pytest.approx((50 + 80 + 100) * ms)
    assert values["mesh_host_ms_per_job"] == pytest.approx((200 + 150) * ms)
    # the host layers add up to each job's span, less what lies outside them
    host = sum(values[n] for n in NEW[:5]) / ms
    assert host == pytest.approx(2000 - 50)
    assert values["k3_attempts_per_lane"] == pytest.approx(200 / 8)
    assert values["k3_accepted_pct"] == pytest.approx(100 * 170 / 200)


def test_idle_outside_spans_is_measured_without_a_look_back(trace):
    """Card 0 idles 0-450, 850-1,380 and 1,700-2,100 in the window; inside
    the jobs (0-1,000 and 1,050-2,050) that is 450 + 150 + 330 + 350 us.
    The psa. spans cover all of it but 2,000-2,050 (the end of job 2, after
    its last span); the gap between the jobs and the one after them are the
    benchmark's loop, and count neither way."""
    idle, outside = _spans.idle_outside_spans(trace)
    assert idle == pytest.approx(450 + 150 + 330 + 350)
    assert outside == pytest.approx(50)
    assert _reader("idle_outside_spans_pct").read(trace) == pytest.approx(100 * 50 / 1280)
    # the benchmark's own breakdown looks back 64 host operations: it files
    # the first gap, in the plan behind 100 operations, under the job
    assert dict(trace.idle_gaps())["bench.job"] == pytest.approx(450e-6)


def test_launch_reads_either_route_of_a_kernel(trace):
    """The kernel layer's host side is ``psa.k<N>.launch`` on the CUDA route
    and ``psa.k<N>.plain`` where the plain torch version runs."""
    plain = [dict(e, name=e["name"].replace(".launch", ".plain")) for e in _events()]
    cell = tr.Cell("hand-made", {"physics": {}}, {}, 4, 1)
    assert _reader("launch_ms_per_job").read(tr.Trace(plain, cell)) == pytest.approx(
        _reader("launch_ms_per_job").read(trace))
    assert not _spans.LAUNCH.fullmatch("psa.k4.plainer")


def test_marks_parse_every_value(trace):
    assert _spans.marks(trace, "k3") == [{"attempts": 120, "accepted": 100, "lanes": 4},
                                         {"attempts": 80, "accepted": 70, "lanes": 4}]
    assert _spans.marks(trace, "k5") == []


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_without_the_programs_spans_or_off_the_card(name):
    """A program without the spans (one older than these readers),
    and a run with no device operation, read None and raise nothing."""
    bare = [e for e in _events() if not e["name"].startswith("psa.")]
    cell = tr.Cell("hand-made", {"physics": {}}, {}, 4, 1)
    assert _reader(name).read(tr.Trace(bare, cell)) is None
    no_card = [e for e in _events() if e["cat"] != "kernel"]
    assert _reader(name).read(tr.Trace(no_card, cell)) is None


SMALL = {
    "fwm4-spectrum-rk45": dict(wavelengths=6, sample_per_set=6,
                               physics=dict(z_max_m=20.0, signal_band_nm=[1556.0, 1566.0])),
    "comb-rk4": dict(combs=6, sample_per_set=6,
                     physics=dict(z_max_m=10.0, n_steps=20, save_every=10)),
    "comb-rk4-x4": dict(combs=8, sample_per_set=8,
                        physics=dict(z_max_m=10.0, n_steps=20, save_every=10)),
}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_traced_run_of_each_cell_reports_every_new_metric_it_lists(workload, monkeypatch):
    """On the CPU the host's operators stand in for the card's operations
    (with no device operation every reader reads None), and the kernels run
    their plain versions (``psa.k<N>.plain``); each new metric the cell
    lists then reads a value, through the readers as they ship."""
    monkeypatch.setattr(tr, "DEVICE_CATS", tr.DEVICE_CATS + ("cpu_op",))
    line, _checks, notes = run.run_cell(workload, SEED, 0.2, True, device="cpu",
                                        overrides=dict(SMALL[workload], input_sets=2),
                                        t_start=time.perf_counter())
    assert line["correct"], notes
    listed = [m["name"] for m in run.load_manifest()["per_layer"]
              if m["name"] in NEW and workload in m["workloads"]]
    assert listed and set(listed) <= set(line["metrics"]), (listed, line["metrics"])
    for name in listed:
        assert line["metrics"][name]["value"] >= 0
    if "k3_accepted_pct" in listed:
        assert 0 < line["metrics"]["k3_accepted_pct"]["value"] <= 100
        assert line["metrics"]["k3_attempts_per_lane"]["value"] >= 1


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_keeps_the_contract_of_an_entry(name):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    m = entries[name]
    assert list(entries).index(name) >= len(entries) - len(NEW)   # appended at the end
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                "higher")
    assert m["source"] in ("program_span", "program_counter")
    assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"] and "\t" not in m["layer"]
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {e["name"]: set(e.get("workloads", cells)) for e in manifest["end_to_end"]}
    assert m["moves"] in e2e and m["moves"] != "setup_s"
    assert m["workloads"] and set(m["workloads"]) <= e2e[m["moves"]] & cells
    assert (ROOT / "benchmark" / "metrics" / f"{name}.py").is_file()
    # a layer the benchmark already names keeps its name letter for letter
    perf = (ROOT / "PERF.md").read_text()
    assert f"| {m['layer']} |" in perf
