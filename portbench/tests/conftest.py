"""Shared helpers of the benchmark's CPU tests: a cell's files shrunk to a
size the CPU runs in seconds (the program's plain kernels), the entries of
the HMC cell that BENCHMARK.json does not hold yet, those of the headline
production cell that it no longer holds, a configuration of the hd family
and its two cells added as files only, and a fixture that skips a card
test where PyTorch sees no card."""

import atexit
import functools
import json
import shutil
import sys
import tempfile
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


def _copy_benchmark(root):
    """BENCHMARK.json and portbench/ copied under ``root``; returns the
    copy's BENCHMARK.json as a dict."""
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "portbench", Path(root) / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def with_hmc(tmp_path):
    """A copy of the benchmark whose BENCHMARK.json also holds the HMC
    cell's entries; returns its root."""
    bench = _copy_benchmark(tmp_path)
    for key, entries in HMC_ENTRIES.items():
        bench[key] += entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


# The headline production cell, out of BENCHMARK.json since its rate spread
# on a shared host by more than half of the largest bound (PERF.md): its
# files stay, and the tests run it from a copy with its entries back.
HEADLINE = "fmm_k3.warm_prod.c256"
HEADLINE_ENTRY = {
    "name": HEADLINE, "config": "fmm_k3_p8_m4_n100",
    "traffic": "warm_prod.c256", "chips": 1,
    "why": "256 chains, production census with MALA, 100-sweep resumed "
           "calls: the eager Gibbs host path and K2 at 256 and 512 rows; "
           "K1 at D=96"}
# the metrics whose ``workloads`` listed it
HEADLINE_METRICS = (
    "chain_sweeps_per_s", "host_launches_per_sweep", "device_idle_pct.gibbs",
    "sweep_mfu_pct", "k1_roofline_pct", "k2_roofline_pct.gibbs",
    "api_self_pct", "driver_self_pct", "host_syncs_per_sweep")


def with_headline(root):
    """A copy of the benchmark under ``root`` whose BENCHMARK.json holds the
    headline cell again; returns ``root``."""
    bench = _copy_benchmark(root)
    bench["workloads"].append(dict(HEADLINE_ENTRY))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in HEADLINE_METRICS:
            m["workloads"].append(HEADLINE)
    (Path(root) / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return Path(root)


@functools.lru_cache(maxsize=None)
def full_root():
    """``with_headline`` in a directory of its own, made once a process and
    removed when it exits: every Gibbs cell the tests run."""
    root = tempfile.mkdtemp(prefix="portbench-full-")
    atexit.register(shutil.rmtree, root, True)
    return with_headline(root)


# BHDFMMM at upstream's own basis, added to a copy of the benchmark as new
# files only (``with_hd``): not a cell of BENCHMARK.json (PERF.md, Open
# questions).
HD_CONFIG_NAME = "bhdfmmm_k2_p36_m2_n100"
HD_CONFIG = {
    "source": "https://github.com/ndmarco/BayesFMMM/blob/HEAD/src/"
              "PostProcessing.cpp BHDFMMM's HD examples: degree (2, 2), "
              "internal knots 250/500/750, boundary [0, 990] on each axis",
    "model": "BayesFMMM HD functional mixed membership (BHDFMMM): surfaces "
             "on a tensor-product B-spline basis, graph-difference penalty",
    "family": "hd",
    "basis_degrees": [2, 2],
    "internal_knots": [[250.0, 500.0, 750.0], [250.0, 500.0, 750.0]],
    "boundary_knots": [[0.0, 990.0], [0.0, 990.0]],
    "K": 2, "P": 36, "M": 2, "D": 0, "N": 100, "n_time": [400, 900],
    "with_eta": False, "with_xi": False, "covariate_cov": False,
    "sigma2": 0.01, "nu_scale": 3.0, "phi_scale": 0.5,
    "precision": "float32 with TF32 off (ops/gibbs.py use_full_f32)",
    "reduced": [],
    "assumed": {
        "widths": "upstream's HD basis, P = 6 x 6 = 36; K = 2, M = 2 as "
                  "the HD fixture fit (tests/test_reference_parity.py)",
        "scale": "N = 100 surfaces of 400 to 900 points",
        "data": "simulated from the seed, points uniform in the box"},
    "joint_draws": {"Phi": 144}}
_HD_SETUP = {"nu_z_iters": 100, "theta_iters": 100, "n_try": 3,
             "init": "spectral"}
# from readings (PERF.md, PR 23): the program's float32 log-likelihood over
# ~65,000 points reads to ~0.008, an ulp of its value
_HD_LIMITS = {"loglik_gap": 0.1, "stuck_chains": 0, "Phi_z2": 0.25,
              "nu_z2": 0.25, "chi_z2": 0.25}
HD_CELLS = {
    "bhd_k2.warm_prod.c64": {
        "config": HD_CONFIG_NAME, "traffic": "warm_prod.c64",
        "entry": "warm_start", "kernels": "production", "chains": 64,
        "call_sweeps": 100, "setup": _HD_SETUP,
        "call": "api.fit_warm_start(resume_from=<checkpoint>, data=..., "
                "tot_mcmc_iters=100, kernels='production', ...), 64 chains",
        "limits": _HD_LIMITS},
    "bhd_k2.warm_ref.c64": {
        "config": HD_CONFIG_NAME, "traffic": "warm_ref.c64",
        "entry": "warm_start", "kernels": "reference", "chains": 64,
        "call_sweeps": 500, "setup": _HD_SETUP,
        "call": "api.fit_warm_start(resume_from=<checkpoint>, data=..., "
                "tot_mcmc_iters=500, kernels='reference', ...), 64 chains, "
                "the captured sweep on the card",
        "limits": _HD_LIMITS}}
# the hd cells report every metric this production Gibbs cell reports
_LIKE = "covcov_d2.warm_prod.c256"


def with_hd(root, config=None, cells=None):
    """A copy of the benchmark under ``root`` with the hd configuration and
    cells added: their files, and their entries in BENCHMARK.json (a cell,
    and in each metric that lists ``_LIKE``).  ``config`` and ``cells``
    replace the defaults above.  Returns ``root``."""
    config = HD_CONFIG if config is None else config
    cells = HD_CELLS if cells is None else cells
    root = Path(root)
    bench = _copy_benchmark(root)
    here = root / "portbench"
    (here / "configs" / f"{HD_CONFIG_NAME}.json").write_text(
        json.dumps(config, indent=1))
    bench["configs"].append({
        "name": HD_CONFIG_NAME, "source": config["source"][:200],
        "file": f"portbench/configs/{HD_CONFIG_NAME}.json", "reduced": [],
        "why": "BHDFMMM surfaces, P = 36: K2's general path, K3 chunked, "
               "K1 at D = 144, the tensor penalty"})
    for name, cell in cells.items():
        (here / "workloads" / f"{name}.json").write_text(
            json.dumps(cell, indent=1))
        bench["workloads"].append({
            "name": name, "config": HD_CONFIG_NAME,
            "traffic": cell["traffic"], "chips": 1,
            "why": f"hd surfaces, {cell['chains']} chains, {cell['kernels']}"
                   " census"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if _LIKE in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
