"""``BENCHMARK.json`` holds to the benchmark's contract, and a configuration,
a traffic mix and a per-layer metric added as new files are found by name,
with no edit to a file that is there."""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16 and 1 <= len(manifest["command"]) <= 32
    for p in manifest["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/")
    for word in manifest["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51


def test_names_units_and_entries(manifest):
    names = {}
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in manifest[section]]
        assert len(seen) == len(set(seen)), section
        names[section] = set(seen)
        for e in manifest[section]:
            assert NAME.match(e["name"]), e["name"]
    assert not names["end_to_end"] & names["per_layer"]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_metric_reaches_cells_that_report_what_it_moves(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e, m
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]] & cells, m
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert any(cell in v for k, v in e2e.items() if k != "setup_s")
        assert any(cell in m.get("workloads", cells) for m in manifest["per_layer"])


def test_four_chip_cells_and_every_configuration_keeps_a_cell(manifest):
    cells = manifest["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    used = {w["config"] for w in cells}
    assert used == {c["name"] for c in manifest["configs"]}


def test_every_name_has_its_files(manifest):
    for w in manifest["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "configs" / f"{w['config']}.py").is_file()
    for m in manifest["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


NEW_READER = '''"""jobs_in_window: how many jobs the traced window holds."""


def read(trace):
    return float(trace.n_jobs) if trace.n_jobs else None
'''


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path, manifest):
    """A later change adds files and manifest entries only: a copy of the
    benchmark gains a configuration, a mix and a metric, and a run finds and
    reports all three."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    config = json.loads((bench / "configs" / "comb_baseline5.json").read_text())
    config["name"] = "comb_32_lines"
    config["physics"] = dict(config["physics"], n_lines=32, pump_offsets=[-4, 4])
    (bench / "configs" / "comb_32_lines.json").write_text(json.dumps(config))
    shutil.copy(bench / "configs" / "comb_baseline5.py", bench / "configs" / "comb_32_lines.py")
    traffic = json.loads((bench / "traffic" / "comb-4096-rk4.json").read_text())
    traffic.update(combs=4, sample_per_set=4, input_sets=2)
    (bench / "traffic" / "comb-4-rk4.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "jobs_in_window.py").write_text(NEW_READER)
    m = json.loads(json.dumps(manifest))
    m["configs"].append({"name": "comb_32_lines", "source": "a test", "reduced": ["n_lines"],
                         "file": "benchmark/configs/comb_32_lines.json", "why": "a test"})
    m["workloads"].append({"name": "comb32-rk4", "config": "comb_32_lines",
                           "traffic": "comb-4-rk4", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "jobs_in_window", "unit": "jobs", "better": "higher",
                           "source": "program_span", "layer": "device",
                           "moves": "instances_per_s", "workloads": ["comb32-rk4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    ov = {"physics": {"z_max_m": 10.0, "n_steps": 20, "save_every": 10}}
    line, _checks, notes = run.run_cell("comb32-rk4", 5, 0.2, True, device="cpu", overrides=ov,
                                        bench_dir=bench, root=tmp_path,
                                        t_start=time.perf_counter())
    assert line["correct"], notes
    assert line["metrics"]["jobs_in_window"]["unit"] == "jobs"
    assert line["metrics"]["jobs_in_window"]["value"] >= 1
