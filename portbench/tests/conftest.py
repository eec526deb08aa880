"""Shared helpers of the benchmark's CPU tests: a cell's files shrunk to a
size the CPU runs in seconds (the program's plain kernels), the entries of
the HMC cell that BENCHMARK.json does not hold yet, and a fixture that
skips a card test where PyTorch sees no card."""

import sys
import time
from pathlib import Path

import pytest
import torch

# a few threads a worker: the tests run in several workers at once
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = dict(N=30, n_time=[30, 30])


def small(cell, config, chains=None):
    """The cell and configuration at 30 curves of 30 points and ``chains``
    chains, by default as many as the cell has up to 256, and up to 64
    with covariates, whose 512-coordinate xi draw is slow on the CPU: so
    many that the draws' check (``<field>_z2``, pooled over every chain)
    reads under the cell's limits.  Every width and flag as the files have
    them."""
    if chains is None:
        chains = min(cell["chains"], 64 if config["D"] else 256)
    return dict(cell, chains=chains), dict(config, **SMALL)


def run_small(name, *, trace=False, seconds=0.5, seed=2 ** 31 + 5,
              root=ROOT, chains=None):
    from portbench import harness, spec
    bench, cell, config = spec.load_cell(name, root)
    cell, config = small(cell, config, chains)
    return harness.run(bench, cell, config, seed=seed, seconds=seconds,
                       trace=trace, device="cpu", t0=time.perf_counter(),
                       root=root)[0]


# The BENCHMARK.json entries of the HMC cell, whose files are in the
# benchmark but whose entries are not (PERF.md, Open questions).
HMC_ENTRIES = {
    "workloads": [{"name": "fmm_k3.hmc.c64", "config": "fmm_k3_p8_m4_n100",
                   "traffic": "hmc.c64", "chips": 1,
                   "why": "fit_hmc, 64 chains: the log-joint and K2's "
                          "backward"}],
    "end_to_end": [{"name": "grad_evals_per_s", "unit": "grad-evals/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock",
                    "workloads": ["fmm_k3.hmc.c64"]}],
    "per_layer": [
        {"name": n, "unit": u, "better": b, "source": "device_trace",
         "layer": layer, "moves": "grad_evals_per_s",
         "workloads": ["fmm_k3.hmc.c64"]}
        for n, u, b, layer in (
            ("host_launches_per_leapfrog", "launches/step", "lower",
             "models.logjoint and samplers.hmc, the host path"),
            ("device_idle_pct.hmc", "%", "lower", "device"),
            ("grad_mfu_pct", "%", "higher",
             "one value and gradient of models.logjoint"),
            ("k2_roofline_pct.hmc", "%", "higher",
             "ops.kernels K2 mean_rss"))]}


def with_hmc(tmp_path):
    """A copy of the benchmark whose BENCHMARK.json also holds the HMC
    cell's entries; returns its root."""
    import json
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key, entries in HMC_ENTRIES.items():
        bench[key] += entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
