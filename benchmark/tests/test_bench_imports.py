"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: by an AST scan of every module under
``benchmark/``, and through ``sys.modules`` of a fresh process that imports
them all and runs a cell on the CPU.  Top-level names are compared whole:
the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
JAX_NAMES = {"jax", "jaxlib", "flax", "psa_simulation_ode_rk_mvp_dispersion_tpu"}
PORT = "psa_simulation_ode_rk_mvp_dispersion_tpu_torch"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _top_names(path: Path):
    """Every top-level module name the file imports, plus the string
    arguments of ``import_module`` calls (their first dotted part)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.add(arg.value.split(".")[0])
            elif isinstance(arg, (ast.Name, ast.BinOp)):
                out.add(PORT)   # the drivers name the port through PORT
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_names(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert not any(n.startswith("psa") for n in _top_names(path))
    assert PORT not in path.read_text()


CHILD = r"""
import importlib, json, sys, time
from pathlib import Path
root = Path(sys.argv[1])
from benchmark import run
for p in sorted((root / "benchmark").rglob("*.py")):
    if "tests" in p.parts:
        continue
    if p.parent.name in ("configs", "metrics") and p.stem != "__init__":
        run._module(p, "probe_" + p.stem)
    else:
        importlib.import_module(".".join(p.relative_to(root).with_suffix("").parts))
line, checks, notes = run.run_cell(
    "comb-rk4", 3, 0.1, False, device="cpu", t_start=time.perf_counter(),
    overrides={"combs": 2, "sample_per_set": 2, "input_sets": 1,
               "physics": {"z_max_m": 5.0, "n_steps": 10, "save_every": 5}})
print(json.dumps({"correct": line["correct"], "forbidden": run.forbidden_modules(),
                  "port": "psa_simulation_ode_rk_mvp_dispersion_tpu_torch" in sys.modules}))
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_a_run_loads_no_jax_in_its_process():
    p = subprocess.run([sys.executable, "-c", CHILD, str(ROOT)], capture_output=True,
                       text=True, cwd=ROOT, env=_clean_env(), timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "forbidden": [], "port": True}


def test_without_a_card_the_command_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "comb-rk4",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, env=_clean_env(), timeout=300)
    if "true" in subprocess.run([sys.executable, "-c", "import torch; print("
                                 "str(torch.cuda.is_available()).lower())"],
                                capture_output=True, text=True).stdout:
        pytest.skip("this host has a CUDA card")
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def test_with_only_the_benchmarks_files_the_command_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = _clean_env()
    env["PYTHONPATH"] = str(tmp_path)
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "comb-rk4",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
