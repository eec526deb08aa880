"""A run end to end on the CPU at a small size (the program's plain
kernels): the shape of its line, the refusals of ``run.py``, the modules
it loads, and ``correct`` coming out false under each fault the cells can
have (``portbench/faults.py``)."""

import json
import subprocess
import sys

import pytest

from portbench import faults, spec
from portbench.tests.conftest import (HEADLINE, ROOT, full_root, run_small,
                                      with_hmc)

# the cells of BENCHMARK.json and the headline cell kept as files
FULL = full_root()
CELLS = [w["name"] for w in spec.load_benchmark(FULL)["workloads"]]


def _check_line(line, cell, trace, root=ROOT):
    bench, c, _ = spec.load_cell(cell, root)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "check"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "check"}
    json.dumps(line)
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"]
             for m in spec.metrics_of(bench, cell, kind)}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    if not trace:
        assert set(line["metrics"]) == set(units)
    assert set(line["check"]) == set(c["limits"])
    for row in line["check"].values():
        assert set(row) == {"value", "limit"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_line_shape(cell):
    _check_line(run_small(cell, root=FULL), cell, False, FULL)


def test_hmc_cell_line_shape(tmp_path):
    """The HMC cell's files run once its entries are in BENCHMARK.json."""
    root = with_hmc(tmp_path)
    _check_line(run_small("fmm_k3.hmc.c64", root=root), "fmm_k3.hmc.c64",
                False, root)
    line = run_small("fmm_k3.hmc.c64", root=root, trace=True)
    _check_line(line, "fmm_k3.hmc.c64", True, root)
    assert "grad_mfu_pct" in line["metrics"]


def test_traced_line_shape():
    cell = HEADLINE
    line = run_small(cell, trace=True, seconds=3.0, root=FULL)
    _check_line(line, cell, True, FULL)
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no device operation ran: no launches, idle or roofline
    assert "sweep_mfu_pct" in line["metrics"]
    assert not {"host_launches_per_sweep", "k1_roofline_pct",
                "device_idle_pct.gibbs"} & set(line["metrics"])


def _run_py(*extra, cwd=ROOT, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fmm_k3.warm_ref.c1", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, capture_output=True,
        text=True, timeout=300, env=env)


def test_no_card_no_result():
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run_py(env=env)
    assert r.returncode == 2 and r.stdout == ""
    assert "nothing was measured" in r.stderr


def test_a_bare_benchmark_directory_fails(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run_py(cwd=tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_run_loads_no_jax():
    """Everything run.py and a whole run load, imported in one process: no
    top-level name is JAX's, its libraries' or the JAX package's (the
    port's own name begins with the JAX package's, so names are compared
    whole)."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.argv = ["run.py"]
import importlib.util
s = importlib.util.spec_from_file_location(
    "run", {str(ROOT / "portbench/run.py")!r})
run = importlib.util.module_from_spec(s); s.loader.exec_module(run)
from portbench import harness, spec
from portbench.tests.conftest import HEADLINE, full_root, run_small
from pathlib import Path
for p in Path({str(ROOT / "portbench")!r}).glob("entries/*.py"):
    spec.load_entry(p.stem)
for p in Path({str(ROOT / "portbench")!r}).glob("metrics/*.py"):
    spec.load_reader(p.stem)
run_small(HEADLINE, trace=True, root=full_root())
print(run.forbidden_modules(), "bayesfmmm_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


# --- faults: the timed path broken underneath, correct must be False ----

# what each cell can have (``tf32`` changes nothing on the CPU; a fault of
# another family's data has nothing to break); at covcov a Phi draw from
# half the curves leaves no trace on the outputs, on the card at the cell's
# size as here (PERF.md)
FAMILY = {cell: spec.load_cell(cell, FULL)[2].get("family", "functional")
          for cell in CELLS}
SEEN = {cell: sorted(f for f in set(faults.FAULTS) - {"tf32"}
                     if faults.ONLY.get(f, FAMILY[cell]) == FAMILY[cell])
        for cell in CELLS}
SEEN["covcov_d2.warm_prod.c256"].remove("half_phi")


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in SEEN[c]])
def test_faults_make_correct_false(cell, fault, monkeypatch):
    _, c, _ = spec.load_cell(cell, FULL)
    faults.FAULTS[fault](monkeypatch.setattr, c["limits"]["loglik_gap"])
    line = run_small(cell, root=FULL)
    assert line["correct"] is False and line["failed"] >= 1, line["check"]


@pytest.mark.parametrize("fault", ["unchanged", "half_rss", "altered"])
def test_faults_make_the_hmc_cell_incorrect(fault, monkeypatch, tmp_path):
    root = with_hmc(tmp_path)
    _, c, _ = spec.load_cell("fmm_k3.hmc.c64", root)
    faults.FAULTS[fault](monkeypatch.setattr, c["limits"]["loglik_gap"])
    line = run_small("fmm_k3.hmc.c64", root=root)
    assert line["correct"] is False and line["failed"] >= 1, line["check"]
