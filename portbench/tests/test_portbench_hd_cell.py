"""The committed hd configuration and its cell, and K3's roofline reader:
BENCHMARK.json lists the files that ``conftest.with_hd`` drops in, the
reader's calls a sweep are those the program makes, its bound is worked by
hand, and it reads nothing where no K3 kernel ran."""

import json

import pytest
import torch

from bayesfmmm_torch import api
from bayesfmmm_torch.config import ModelConfig, Priors
from bayesfmmm_torch.models.state import init_state
from bayesfmmm_torch.ops import gibbs, kernels
from portbench import datagen, harness, spec
from portbench.counts.kernel_bound import kernel_bound
from portbench.entries.common import program_data
from portbench.tests.conftest import (HD_CELLS, HD_CONFIG, HD_CONFIG_NAME,
                                      ROOT)
from portbench.trace import SPAN, Event, TraceSlice

CELL = "bhd_k2.warm_ref.c64"
K3 = spec.load_reader("k3_roofline_pct", ROOT)


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def test_the_committed_files_are_the_drop_ins():
    config = _config(HD_CONFIG_NAME)
    assert {k: config[k] for k in HD_CONFIG} == HD_CONFIG
    cell = json.loads((ROOT / "portbench" / "workloads" / f"{CELL}.json")
                      .read_text())
    assert cell == HD_CELLS[CELL]
    bench, cell, config = spec.load_cell(CELL)
    assert (cell["chips"], config["name"], config["P"]) == \
        (1, HD_CONFIG_NAME, 36)
    entry, = [c for c in bench["configs"] if c["name"] == HD_CONFIG_NAME]
    assert (entry["source"], entry["reduced"]) == \
        (HD_CONFIG["source"][:200], [])
    assert [m["name"] for m in bench["per_layer"]
            if CELL in m.get("workloads", ())] == [
        "host_launches_per_sweep", "device_idle_pct.gibbs", "sweep_mfu_pct",
        "k1_roofline_pct", "k2_roofline_pct.gibbs", "api_self_pct",
        "driver_self_pct", "host_syncs_per_sweep", "k3_roofline_pct"]


@pytest.mark.parametrize("name", ["fmm_k3_p8_m4_n100",
                                  "covcov_k2_p8_m16_d2_n80", HD_CONFIG_NAME])
@pytest.mark.parametrize("census", ["reference", "production"])
@pytest.mark.parametrize("joint_max", [4096, 16])
def test_k3_rows_are_the_sweeps_calls(name, census, joint_max, monkeypatch):
    """One CPU sweep at a small size of each configuration: the rows of
    every ``kernels.weighted_gram`` call, counted by a wrapper, are the
    reader's, with the joint draws' limit as the program's and lowered so
    that Phi (and xi) are drawn block by block."""
    config = dict(_config(name), N=6, n_time=[12, 16])
    data = program_data(api, datagen.from_config(config, 2 ** 31 + 9), "cpu")
    D = config["D"]
    cfg = ModelConfig(K=config["K"], P=config["P"], M=config["M"], D=D,
                      family=config.get("family", "functional"),
                      covariate_mean=D > 0,
                      covariate_cov=D > 0 and config["covariate_cov"])
    chains = 3
    state = init_state(torch.Generator().manual_seed(1), cfg, data, chains)
    c = torch.as_tensor(Priors().c_vector(cfg.K), dtype=torch.float32)
    monkeypatch.setattr(gibbs, "_JOINT_MAX_DIM", joint_max)
    monkeypatch.setattr(K3, "JOINT_MAX_DIM", joint_max)
    rows, real = [], kernels.weighted_gram

    def counted(W, G):
        rows.append(W.shape[0])
        return real(W, G)
    monkeypatch.setattr(kernels, "weighted_gram", counted)
    flags = api.PRODUCTION_FLAGS if census == "production" else {}
    gibbs.sweep_full(torch.Generator().manual_seed(2), state, data, Priors(),
                     c, covariate_mean=cfg.covariate_mean,
                     covariate_cov=cfg.covariate_cov, **flags)
    assert rows and sorted(rows) == sorted(K3.rows(config, chains))


def test_k3_bound_by_hand_at_the_hd_cell():
    # W 128 * 100 + G 100 * 36 * 36 + out 128 * 36 * 36 = 308,288 floats;
    # 2 R N P^2 = 2 * 128 * 100 * 1,296 FLOP
    b = kernel_bound("weighted_gram", R=128, N=100, P=36)
    assert b["bytes"] == 1_233_152
    assert b["flop"] == 33_177_600
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] * 1e3 == pytest.approx(0.495, abs=1e-3)
    _, cell, config = spec.load_cell(CELL)
    assert K3.rows(config, cell["chains"]) == [128]


def _ctx(kernel_names, sweeps=500):
    """A Context of the hd cell whose traced slice holds one 2-ms device
    operation of each name."""
    events = [Event(SPAN, "user_annotation", 0, 10 ** 9)]
    events += [Event(n, "kernel", 1000 + 10 ** 7 * i,
                     1000 + 10 ** 7 * i + 2 * 10 ** 6)
               for i, n in enumerate(kernel_names)]
    _, cell, config = spec.load_cell(CELL)
    return harness.Context(cell, config, TraceSlice(events),
                           {"sweeps": sweeps}, {})


def test_k3_reads_its_kernels_time():
    ctx = _ctx(["void weighted_gram_chunk_kernel(float const*)",
                "void mean_rss_tile_kernel<40, 0, false>(float const*)"])
    bound_ms = kernel_bound("weighted_gram", R=128, N=100, P=36)["bound_ms"]
    assert K3.read(ctx) == pytest.approx(100 * bound_ms * 1e-3 * 500 / 2e-3)
    both = _ctx(["weighted_gram_tile_kernel", "weighted_gram_chunk_kernel"])
    assert K3.read(both) == pytest.approx(K3.read(ctx) / 2)


def test_k3_reads_nothing_without_its_kernels():
    assert K3.read(_ctx(["mean_rss_tile_kernel",
                         "chol_blocked_kernel"])) is None
    assert K3.read(_ctx([])) is None
    ctx = _ctx(["weighted_gram_chunk_kernel"])
    ctx.slice = None
    assert K3.read(ctx) is None
