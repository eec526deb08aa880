#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bayesfmmm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one line each, any failure exits non-zero:

  1. build the CUDA kernels from bayesfmmm_torch/csrc with nvcc;
  2. K1 chol_solve against its plain version (torch.linalg) at the main
     path's shape and two others;
  3. K2 mean_rss against its plain version (einsum + sum);
  4. the slice's main path: phase_warm_start in the reference kernel census
     at the headline width (K=3, P=8, M=4, N=100, 256 chains), 500 sweeps
     with the first 200 annealed from beta 0.1, held against the JAX
     package's result for the same protocol
     (tests/data/torch_slice_reference.json), with the kernels' launch
     counts read around that run;
  5. timings: chain-sweeps/s of the slice, and each kernel beside its plain
     version at the main path's shapes.

It then prints the card's name and power limit, one JSON line of kernel
numbers, and as its last line {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bayesfmmm_torch import ModelConfig, Priors
from bayesfmmm_torch.convert import state_to_numpy
from bayesfmmm_torch.models.likelihood import log_likelihood
from bayesfmmm_torch.models.state import init_state
from bayesfmmm_torch.ops import gibbs, kernels
from bayesfmmm_torch.samplers import drivers
from bayesfmmm_torch.utils.init_strategies import spectral_init
from bayesfmmm_torch.utils.simulate import simulate_functional

ROOT = Path(__file__).resolve().parent
REFERENCE = ROOT / "tests" / "data" / "torch_slice_reference.json"

# The slice protocol; must equal the one the JAX reference was made with.
PROTOCOL = dict(seed=7, N=100, K=3, P=8, M=4, n_time=[100, 100],
                sweeps=500, anneal=200, beta0=0.1, z_jitter=0.02)
CHAINS = 256

K1_TOL = {"mean": 5e-5, "noise": 5e-4}      # tests/test_linalg.py:118-121
K2_TOL = {"rss_rtol": 1e-5, "mu": 2e-5}     # tests/test_pallas_kernels.py


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0].strip()


def cuda_ms(fn, reps=50, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spd(g, C, D, dev, diag=50.0):
    X = torch.randn(C, D, D, generator=g, device=dev)
    A = X @ X.mT + diag * torch.eye(D, device=dev)
    return (A.contiguous(), torch.randn(C, D, generator=g, device=dev),
            torch.randn(C, D, generator=g, device=dev))


def k1_phase(dev, g):
    worst = 0.0
    for C, D in ((CHAINS, 96), (3, 13), (2, kernels.chol_solve_max_dim())):
        A, b, z = spd(g, C, D, dev)
        mean, noise = kernels.chol_solve(A, b, z)
        mean_p, noise_p = kernels.chol_solve_plain(A, b, z)
        torch.cuda.synchronize()
        e_mean = (mean - mean_p).abs().max().item()
        e_noise = (noise - noise_p).abs().max().item()
        print(f"  K1 chol_solve C={C} D={D}: max|mean-plain|={e_mean:.3e} "
              f"(tol {K1_TOL['mean']}), max|noise-plain|={e_noise:.3e} "
              f"(tol {K1_TOL['noise']})")
        check(e_mean <= K1_TOL["mean"] and e_noise <= K1_TOL["noise"],
              f"K1 disagrees with its plain version at C={C} D={D}")
        worst = max(worst, e_mean, e_noise)
    return worst


def k2_phase(dev, g):
    worst = 0.0
    for C, N, L, P, pad in ((CHAINS, 100, 100, 8, None), (3, 13, 24, 6, 16)):
        B = torch.randn(N, L, P, generator=g, device=dev)
        y = torch.randn(N, L, generator=g, device=dev)
        if pad is not None:
            B[:, pad:] = 0.0
            y[:, pad:] = 0.0
        w = torch.randn(C, N, P, generator=g, device=dev)
        rss, mu = kernels.mean_rss(B, y, w, want_mu=True)
        rss_p, mu_p = kernels.mean_rss_plain(B, y, w, want_mu=True)
        torch.cuda.synchronize()
        e_rel = ((rss - rss_p).abs() / rss_p.abs()).max().item()
        e_mu = (mu - mu_p).abs().max().item()
        mu_ok = bool(((mu - mu_p).abs()
                      <= K2_TOL["mu"] * (1 + mu_p.abs())).all())
        print(f"  K2 mean_rss C={C} N={N} L={L} P={P} pad={pad}: "
              f"max rel|rss-plain|={e_rel:.3e} (tol {K2_TOL['rss_rtol']}), "
              f"max|mu-plain|={e_mu:.3e} (tol {K2_TOL['mu']} abs+rel)")
        check(e_rel <= K2_TOL["rss_rtol"] and mu_ok,
              f"K2 disagrees with its plain version at C={C} N={N}")
        worst = max(worst, e_mu, (rss - rss_p).abs().max().item())
    return worst


def slice_phase(dev):
    """Drive the main path; returns (seconds, launch counts)."""
    ref = json.loads(REFERENCE.read_text())
    check(ref["protocol"] == PROTOCOL and ref["port_chains"] == CHAINS,
          f"reference protocol {ref['protocol']} != {PROTOCOL}")
    p = PROTOCOL
    K, P, M = p["K"], p["P"], p["M"]
    data, _ = simulate_functional(seed=p["seed"], N=p["N"], K=K, P=P, M=M,
                                  n_time=tuple(p["n_time"]), device=dev)
    hp, c = Priors(), torch.full((K,), 10.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    st = init_state(g, ModelConfig(K=K, P=P, M=M), data, chains=CHAINS)
    sp = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
          for k, v in spectral_init(data, K, M).items()}
    Z0 = (sp["Z"] + p["z_jitter"] * torch.randn(
        (CHAINS,) + sp["Z"].shape, generator=g, device=dev)).clamp_min(1e-4)
    st = st.replace(Z=Z0 / Z0.sum(-1, keepdim=True),
                    nu=sp["nu"].expand_as(st.nu).contiguous(),
                    chi=sp["chi"].expand_as(st.chi).contiguous(),
                    Phi=sp["Phi"].expand_as(st.Phi).contiguous(),
                    sigma2=sp["sigma2"].expand_as(st.sigma2).contiguous())
    betas = np.interp(np.arange(p["sweeps"]),
                      [0, p["anneal"] - 1, p["sweeps"] - 1],
                      [p["beta0"], 1.0, 1.0])
    ll0 = log_likelihood(st, data)
    # one throwaway sweep first, so library set-up is not timed
    gibbs.sweep_full(torch.Generator(device=dev).manual_seed(1), st, data,
                     hp, c, beta=0.1)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = drivers.phase_warm_start(g, st, data, hp, c, n_iters=p["sweeps"],
                                   betas=betas)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)

    final = state_to_numpy(res.final_state)
    for f, v in final.items():
        check(np.all(np.isfinite(v)), f"final state field {f} not finite")
    for f, v in res.traces.items():
        check(bool(torch.isfinite(v).all()), f"trace {f} not finite")
    ll = res.loglik
    check(ll.shape == (CHAINS, p["sweeps"]) and bool(torch.isfinite(ll).all()),
          "loglik trace malformed")
    med0 = ll0.median().item()
    med_ll = ll[:, -1].median().item()
    med_s2 = float(np.median(final["sigma2"]))
    print(f"  slice: {CHAINS} chains x {p['sweeps']} sweeps in "
          f"{seconds:.3f} s; median loglik {med0:.2f} -> {med_ll:.2f}; "
          f"median sigma2 {med_s2:.6f}; launches {counts}")
    check(med_ll > med0, "ensemble loglik did not rise from its start")
    check(counts["chol_solve"] == p["sweeps"],
          f"K1 launched {counts['chol_solve']} times in {p['sweeps']} sweeps")
    check(counts["mean_rss"] == 2 * p["sweeps"],
          f"K2 launched {counts['mean_rss']} times in {p['sweeps']} sweeps")
    for name, med in (("loglik", med_ll), ("sigma2", med_s2)):
        lo, hi = ref[name]["limits"]
        print(f"  {name}: port median {med:.6g}, JAX median "
              f"{ref[name]['median']:.6g}, limits [{lo:.6g}, {hi:.6g}] "
              f"({ref['limit_rule']})")
        check(lo <= med <= hi, f"{name} median {med} outside [{lo}, {hi}]")
    return seconds, counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    gibbs.use_full_f32()
    card = card_line()

    t0 = time.perf_counter()
    lib = kernels.build()
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln] \
        if lib.with_suffix(".log").exists() else []
    print(f"phase 1 build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for ln in ptxas:
        print(f"  ptxas {ln}")

    g = torch.Generator(device=dev).manual_seed(123)
    k1_err = k1_phase(dev, g)
    print("phase 2 K1 chol_solve vs plain: ok")
    k2_err = k2_phase(dev, g)
    print("phase 3 K2 mean_rss vs plain: ok")

    seconds, counts = slice_phase(dev)
    print("phase 4 slice main path: ok")

    A, b, z = spd(g, CHAINS, 96, dev)
    k1_ms = cuda_ms(lambda: kernels.chol_solve(A, b, z))
    k1_plain = cuda_ms(lambda: kernels.chol_solve_plain(A, b, z))
    B = torch.randn(100, 100, 8, generator=g, device=dev)
    y = torch.randn(100, 100, generator=g, device=dev)
    w = torch.randn(CHAINS, 100, 8, generator=g, device=dev)
    k2_ms = cuda_ms(lambda: kernels.mean_rss(B, y, w))
    k2_plain = cuda_ms(lambda: kernels.mean_rss_plain(B, y, w))
    rate = CHAINS * PROTOCOL["sweeps"] / seconds
    print(f"phase 5 timings on {card}: slice {rate:.1f} chain-sweeps/s "
          f"({seconds / PROTOCOL['sweeps'] * 1e3:.3f} ms per sweep of "
          f"{CHAINS} chains, loglik every sweep); K1 C={CHAINS} D=96 "
          f"{k1_ms:.4f} ms vs plain {k1_plain:.4f} ms; K2 C={CHAINS} N=100 "
          f"L=100 P=8 {k2_ms:.4f} ms vs plain {k2_plain:.4f} ms")

    src = "bayesfmmm_tpu/ops/pallas_kernels.py"
    print(card)
    print(json.dumps({"kernels": [
        {"name": "chol_solve", "route": "cuda",
         "source": "bayesfmmm_torch/csrc/chol_solve.cu",
         "replaces": f"{src}:228", "launches": counts["chol_solve"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "mean_rss", "route": "cuda",
         "source": "bayesfmmm_torch/csrc/mean_rss.cu",
         "replaces": f"{src}:68", "launches": counts["mean_rss"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
