"""Discovery: every cell, configuration and per-layer metric that
BENCHMARK.json names is a file the harness finds by its name, and a new
one is a new file."""

import json
import re
import shutil

import pytest

from portbench import spec
from portbench.tests.conftest import ROOT, full_root, run_small

BENCH = spec.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(0 < m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


# the cells of BENCHMARK.json and the headline cell kept as files
@pytest.mark.parametrize(
    "cell", [w["name"] for w in spec.load_benchmark(full_root())["workloads"]])
def test_every_cell_finds_its_files(cell):
    bench, c, config = spec.load_cell(cell, full_root())
    assert c["entry"] and spec.load_entry(c["entry"], ROOT).Entry
    zf = ["Phi", "nu", "chi"] + (["xi", "eta"] if config["D"] else [])
    assert set(c["limits"]) == {"loglik_gap", "stuck_chains"} | {
        f + "_z2" for f in zf}
    assert c["limits"]["stuck_chains"] == 0
    used = {m["moves"] for m in spec.metrics_of(bench, cell, "per_layer")}
    e2e = {m["name"] for m in spec.metrics_of(bench, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert used and used <= e2e
    for entry in BENCH["configs"]:
        if entry["name"] == c["config"]:
            assert (ROOT / entry["file"]).is_file()
            assert config["reduced"] == entry["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_says_what_the_json_says(metric):
    reader = spec.load_reader(metric, ROOT)
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == \
        (m["unit"], m["layer"], m["moves"])
    assert callable(reader.read)


def test_one_layer_one_name():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A copy of the benchmark gains a cell and a per-layer metric by new
    files and new entries of BENCHMARK.json alone; the harness runs the
    cell and reports the metric without an edit to any existing file."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    cell = json.loads((tmp_path / "portbench/workloads"
                       / "fmm_k3.warm_prod.c256.json").read_text())
    cell["traffic"] = "warm_prod.c256_copy"
    (tmp_path / "portbench/workloads/fmm_k3.warm_prod.c256_copy.json"
     ).write_text(
        json.dumps(cell))
    (tmp_path / "portbench/metrics/calls_traced.py").write_text(
        'UNIT = "calls"\nLAYER = "api"\nMOVES = "chain_sweeps_per_s"\n\n\n'
        'def read(ctx):\n    return 1.0 if ctx.slice_call else None\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "fmm_k3.warm_prod.c256_copy", "config": "fmm_k3_p8_m4_n100",
         "traffic": "warm_prod.c256_copy", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("fmm_k3.warm_prod.c256_copy")
    bench["per_layer"].append(
        {"name": "calls_traced", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "api",
         "moves": "chain_sweeps_per_s",
         "workloads": ["fmm_k3.warm_prod.c256_copy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = {p: p.read_bytes() for p in before}
    assert after == before                      # nothing existing edited
    _, c, config = spec.load_cell("fmm_k3.warm_prod.c256_copy", tmp_path)
    assert c["chains"] == 256 and config["K"] == 3
    line = run_small("fmm_k3.warm_prod.c256_copy", trace=True,
                     root=tmp_path)
    assert line["metrics"]["calls_traced"] == {"value": 1.0,
                                               "unit": "calls"}
    assert line["correct"]
