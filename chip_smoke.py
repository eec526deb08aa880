#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bayesfmmm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one line each, any failure exits non-zero:

  1. build the CUDA kernels from bayesfmmm_torch/csrc with nvcc;
  2. K1 chol_solve against its plain version (torch.linalg) at the main
     paths' shapes (D = 96; D = 256 at 16, 64 and 256 chains, the joint xi
     and hd Phi draws; D = 60 and 72), at shapes that take each of its two
     kernels, odd D of the packed one, its smallest and its largest, and at
     every D the register-tiled kernel serves with a ragged chain count;
     each without and with the jitter, the same bits from two calls; and a D
     above every kernel, which must raise and launch nothing;
  3. K2 mean_rss against its plain version (einsum + sum) at the main
     paths' shapes (C and the MGP-scale moves' 2C chain rows; the hd
     family's P = 16, L = 144) and a padded one, with and without mu, the
     same bits from two calls;
  4. K3 weighted_gram against its plain version (einsum) at the main
     paths' shapes (update_nu's R = C K, update_eta's R = C D K, the
     sequential scan's R = C K M D, the hd family's P = 16), a ragged one
     and one with P > 16 (the chunked kernel), the same bits from two calls;
  5. slice 1's path: phase_warm_start in the reference kernel census at the
     headline width (K=3, P=8, M=4, N=100, 256 chains), 500 sweeps with the
     first 200 annealed from beta 0.1, held against the JAX package's
     result for the same protocol (tests/data/torch_slice_reference.json),
     with the kernels' launch counts read around that run;
  6. slice 2's path, the bench's production census (collapsed Z/chi, gauge,
     MGP- and noise-scale interweaves, Phi MALA), same protocol, held
     against tests/data/torch_production_reference.json, launch counts
     read around it;
  7. slice 5's path, the three-phase fit pipeline through api.fit at the
     headline width: phase 1 (8 restart chains) and phase 2 (7) of 300
     sweeps each from the spectral init, phase 3 with 256 chains of the
     production census for 400 sweeps with a tempered excursion every 100,
     progress printed by chunk, the warm ensemble checkpointed and the best
     chain's traces exported; held against the JAX package's api.fit under
     the same protocol (tests/data/torch_fit_reference.json), the launch
     counts of each phase read around it; then the ensemble resumed twice
     from the checkpoint (the same bits), a run split at the checkpoint
     against the unbroken run (the same bits), and the exported directory
     reloaded (the same numbers);
  8. slice 6's paths, the repo's own configurations 4, 3, 1 and 5
     (benchmarks/suite.py; data seed 7) at their full widths, each held
     against tests/data/torch_families_reference.json (JAX, several seeds):
     config 4 (functional, K=2, P=8, M=16, N=80, D=1, eta and xi) through
     api.fit with covariate_cov=True: restarts in phases 1 and 2, phase 3 at
     16 chains in the reference census, then from the same medians a
     256-chain ensemble in the production census with a tempered excursion,
     checkpointed, resumed, and held bit for bit against the unbroken run;
     config 3 (K=3, M=3, N=100, D=2, eta; 8 chains) through
     phase_warm_start(covariate_mean=True); config 1 (multivariate, K=2,
     P=10, M=3, N=200; 4 chains) and config 5 (hd, K=4, P=16, M=4, 64
     surfaces on a 12 x 12 grid; 64 chains) through api.fit; the launch
     counts of every phase as the code predicts them (config 4: K1 twice a
     phase-3 sweep, both at a shape the packed kernel serves; config 1: no
     K2, no K3), counted shape by shape; and the fit smoke's phase 3
     once more from the JAX package's own phase-1/2 medians, inside the
     tight limits of tests/data/torch_fit_reference.json;
  9. timings: chain-sweeps/s of both paths, and each kernel at the main
     path's shapes (K2 at C and at 2C chain rows, and the restart phases'
     7 and 8 chains) beside its plain version,
     the one PyTorch call for the same function where there is one (K3: a
     matmul), the empty kernel and its bound (ops/kernels.py::kernel_bound,
     published H100 SXM peaks): device time from torch.profiler, candidates
     in turns, and host-paced time from CUDA events; and the device time
     of the PyTorch ops that formed A + jitter * scale * I before K1 took
     the jitter inside; the packed K1 kernel at (16, 64, 256) x 256 beside
     the three torch.linalg calls, K2 and K3 at slice 6's shapes, and ms,
     kernels and device-busy ms a sweep of configs 4 (16 and 256 chains), 3,
     1 and 5.

It then prints the card's name and power limit, one JSON line of kernel
numbers, and as its last line {"ok": true, "device": {...}}.  Where the
production sweep's time goes, updater by updater, is measured apart:
python3 -m bayesfmmm_torch.utils.profile_sweep.
"""

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bayesfmmm_torch import ModelConfig, Priors, api, diagnostics
from bayesfmmm_torch.convert import (fit_result_from_estimates,
                                     state_to_numpy)
from bayesfmmm_torch.io import armaio
from bayesfmmm_torch.io.checkpoint import load_checkpoint
from bayesfmmm_torch.models.likelihood import log_likelihood
from bayesfmmm_torch.models.state import (STATE_FIELDS, init_state,
                                          make_hd_functional_data)
from bayesfmmm_torch.ops import gibbs, kernels
from bayesfmmm_torch.samplers import drivers
from bayesfmmm_torch.utils.init_strategies import spectral_ensemble
from bayesfmmm_torch.utils.kernel_bench import (card_line, device_launches,
                                                device_ms, in_turns,
                                                library_chol_solve,
                                                library_weighted_gram,
                                                main_path_inputs, paced_ms,
                                                spd)
from bayesfmmm_torch.utils.observability import ProgressStream
from bayesfmmm_torch.utils.simulate import (_numpy_mu, _truth_state,
                                            simulate_functional,
                                            simulate_multivariate)

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"

# The protocol both paths run; must equal the one the JAX references were
# made with.
PROTOCOL = dict(seed=7, N=100, K=3, P=8, M=4, n_time=[100, 100],
                sweeps=500, anneal=200, beta0=0.1, z_jitter=0.02)
CHAINS = 256
# path -> (sweep_full flags, JAX reference, kernel launches per sweep)
PATHS = {
    "slice": ({}, DATA / "torch_slice_reference.json",
              {"chol_solve": 1, "mean_rss": 2, "weighted_gram": 1}),
    # K2: sigma2, the loglik probe, 4 MGP-scale moves, MALA's RSS of a
    "production": (dict(collapsed_z=True, gauge=True, p_indep=0.3,
                        phi_mala_steps=4, phi_mala_step=0.05),
                   DATA / "torch_production_reference.json",
                   {"chol_solve": 1, "mean_rss": 7, "weighted_gram": 1}),
}

# The fit pipeline's protocol; must equal the one its JAX reference was made
# with (tests/data/make_torch_fit_reference.py).
FIT_PROTOCOL = dict(seed=7, N=100, K=3, P=8, M=4, n_time=[100, 100],
                    init="spectral", n_try=7, nu_z_iters=300,
                    theta_iters=300, warm_iters=400, kernels="production",
                    n_temp_trans=100, N_t=3, beta_N_t=0.5, fit_seed=0)
FIT_REFERENCE = DATA / "torch_fit_reference.json"
RESUME_SWEEPS = 100         # the least fit_warm_start's validation takes
# kernel launches per sweep with the loglik probe: phase 1 (sweep_nu_z:
# sigma2 and the probe, update_nu), phase 2 (sweep_theta: update_phi, sigma2
# and the probe)
PHASE_LAUNCHES = {
    "nu_z": {"chol_solve": 0, "mean_rss": 2, "weighted_gram": 1},
    "theta": {"chol_solve": 1, "mean_rss": 2, "weighted_gram": 0},
}

# Slice 6: the protocols of the four configurations; each must equal the
# one its JAX reference was made with
# (tests/data/make_torch_families_reference.py).
FAMILIES_REFERENCE = DATA / "torch_families_reference.json"
FAMILY_PROTOCOLS = {
    "config4": dict(
        name="CovAdjCov_xi_fullM", family="functional", seed=7, N=80, K=2,
        P=8, M=16, D=1, n_time=[100, 100], with_eta=True, with_xi=True,
        init="spectral", n_try=3, nu_z_iters=200, theta_iters=200,
        fit_seeds=[0, 1, 2],
        reference=dict(kernels="reference", warm_iters=100, chains=16,
                       port_chains=16),
        production=dict(kernels="production", warm_iters=200, chains=16,
                        port_chains=256, n_temp_trans=100, N_t=2,
                        beta_N_t=0.7)),
    "config3": dict(
        name="CovAdjMean_eta_D2_K3", family="functional", seed=7, N=100, K=3,
        P=8, M=3, D=2, n_time=[100, 100], with_eta=True, sweeps=300,
        anneal=100, beta0=0.1, z_jitter=0.02, chains=64, port_chains=8),
    "config1": dict(
        name="BMVMMM_K2", family="multivariate", seed=7, N=200, K=2, P=10,
        M=3, init="spectral", n_try=3, nu_z_iters=200, theta_iters=200,
        warm_iters=200, kernels="production", fit_seeds=[0, 1, 2],
        chains=16, port_chains=4),
    "config5": dict(
        name="BHDFMMM_2D_K4_manychain", family="hd", seed=7, N=64, K=4, M=4,
        grid=12, basis_degrees=[2, 2], n_internal=[1, 1], sigma2=0.01,
        init="spectral", n_try=3, nu_z_iters=200, theta_iters=200,
        warm_iters=100, kernels="production", fit_seeds=[0, 1, 2],
        chains=16, port_chains=64),
}
# kernel launches a sweep (K1, K2, K3) with the loglik probe, by sweep and
# model: eta adds a K3 launch (update_eta) to the sweeps that draw it, xi a
# K1 launch (the joint draw); the identity basis launches no K2 and no K3
SWEEP_LAUNCHES = {
    # config 4: eta and xi
    ("nu_z", "eta"): (0, 2, 2), ("theta", "xi"): (2, 2, 0),
    ("reference", "xi"): (2, 2, 2), ("production", "xi"): (2, 7, 2),
    # config 3: eta only
    ("reference", "eta"): (1, 2, 2),
    # config 1: the multivariate family
    ("nu_z", "mv"): (0, 0, 0), ("theta", "mv"): (1, 0, 0),
    ("production", "mv"): (1, 0, 0),
    # config 5: the hd family launches what the functional one does
    ("nu_z", "hd"): (0, 2, 1), ("theta", "hd"): (1, 2, 0),
    ("production", "hd"): (1, 7, 1),
}
KERNEL_NAMES = ("chol_solve", "mean_rss", "weighted_gram")

K1_TOL = {"mean": 5e-5, "noise": 5e-4}      # tests/test_linalg.py:118-121
K2_TOL = {"rss_rtol": 1e-5, "mu": 2e-5}     # tests/test_pallas_kernels.py
# tests/test_pallas_kernels.py:46-47, the absolute part scaled by N/21
K3_TOL = {"rtol": 2e-5, "atol_per_21": 2e-5}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def k1_case(dev, g, C, D, jitter):
    """One shape and jitter: the kernel twice against the plain version;
    returns (max |mean - plain|, max |noise - plain|)."""
    A, b, z = spd(g, C, D, dev)
    mean, noise = kernels.chol_solve(A, b, z, jitter)
    mean2, noise2 = kernels.chol_solve(A, b, z, jitter)
    mean_p, noise_p = kernels.chol_solve_plain(A, b, z, jitter)
    torch.cuda.synchronize()
    check(torch.equal(mean, mean2) and torch.equal(noise, noise2),
          f"K1 gave other bits on a second call at C={C} D={D} "
          f"jitter={jitter}")
    e_mean = (mean - mean_p).abs().max().item()
    e_noise = (noise - noise_p).abs().max().item()
    check(e_mean <= K1_TOL["mean"] and e_noise <= K1_TOL["noise"],
          f"K1 disagrees with its plain version at C={C} D={D} "
          f"jitter={jitter}: mean {e_mean:.3e}, noise {e_noise:.3e}")
    return e_mean, e_noise


def _refuses_float64(dev):
    """Every kernel wrapper refuses a float64 tensor on the card by name:
    nothing is cast silently."""
    f64 = dict(dtype=torch.float64, device=dev)
    calls = (
        lambda: kernels.chol_solve(torch.eye(8, **f64)[None],
                                   torch.ones(1, 8, **f64),
                                   torch.ones(1, 8, **f64)),
        lambda: kernels.mean_rss(torch.ones(3, 4, 8, **f64),
                                 torch.ones(3, 4, **f64),
                                 torch.ones(2, 3, 8, **f64)),
        lambda: kernels.weighted_gram(torch.ones(2, 3, **f64),
                                      torch.ones(3, 8, 8, **f64)))
    for call in calls:
        try:
            call()
        except ValueError as e:
            if "float32" not in str(e):
                return False
        else:
            return False
    return True


def k1_phase(dev, g):
    worst = 0.0
    top = kernels.chol_solve_max_dim()
    for C, D in ((CHAINS, 96), (7, 96), (3, 13), (2, 240), (5, 129), (4, 16),
                 (2, 1),
                 # slice 6: the 256-dimensional joint draws of configs 4 and
                 # 5 at their chain counts, config 1's and config 3's D, an
                 # odd D of the packed kernel, its smallest and its largest
                 (16, 256), (64, 256), (CHAINS, 256), (4, 60), (8, 72),
                 (3, 251), (2, 241), (3, 130), (2, 200), (2, top)):
        for jitter in (0.0, 1e-6):
            e_mean, e_noise = k1_case(dev, g, C, D, jitter)
            print(f"  K1 chol_solve C={C} D={D} jitter={jitter} "
                  f"({kernels.chol_solve_plan(C, D)['kernel']} kernel): "
                  f"max|mean-plain|={e_mean:.3e} (tol {K1_TOL['mean']}), "
                  f"max|noise-plain|={e_noise:.3e} (tol {K1_TOL['noise']}), "
                  f"same bits twice")
            worst = max(worst, e_mean, e_noise)
    for D in (129, 256, 251, top):
        check(kernels.chol_solve_plan(16, D)["kernel"] == "packed",
              f"K1 D={D} is not served by the packed kernel")
    # a D above every kernel raises: nothing gives way to torch.linalg
    before = kernels.LAUNCHES["chol_solve"]
    try:
        kernels.chol_solve(*spd(g, 2, top + 1, dev), 1e-6)
    except NotImplementedError as e:
        print(f"  K1 chol_solve D={top + 1} raises: {e}")
    else:
        check(False, f"K1 D={top + 1}, which no kernel serves, did not raise")
    check(kernels.LAUNCHES["chol_solve"] == before,
          f"K1 D={top + 1} launched a kernel")
    check(_refuses_float64(dev),
          "a float64 tensor reached a kernel on the card")
    print("  K1, K2, K3: a float64 tensor on the card raises by name")
    # every D of the register-tiled kernel, padded tiles and all
    tiled = [D for D in range(1, kernels.chol_solve_max_dim() + 1)
             if kernels.chol_solve_plan(3, D)["kernel"] == "tiled"]
    e_all = [k1_case(dev, g, 3, D, jitter)
             for D in tiled for jitter in (0.0, 1e-6)]
    print(f"  K1 chol_solve C=3, every D of the tiled kernel "
          f"({tiled[0]}..{tiled[-1]}), jitter 0 and 1e-6: "
          f"max|mean-plain|={max(e[0] for e in e_all):.3e}, "
          f"max|noise-plain|={max(e[1] for e in e_all):.3e}, same bits twice")
    return max(worst, *(max(e) for e in e_all))


def k2_phase(dev, g):
    worst = 0.0
    for C, N, L, P, pad in ((CHAINS, 100, 100, 8, None),
                           (2 * CHAINS, 100, 100, 8, None),
                           (8, 100, 100, 8, None), (7, 100, 100, 8, None),
                           (3, 13, 24, 6, 16),
                           # slice 6: config 5 (hd, P=16, L=144) at its 64
                           # chains, 128 chain rows and 4 restart chains;
                           # config 4 (N=80) at 256, 512 and 16
                           (64, 64, 144, 16, None), (128, 64, 144, 16, None),
                           (4, 64, 144, 16, None), (CHAINS, 80, 100, 8, None),
                           (2 * CHAINS, 80, 100, 8, None),
                           (16, 80, 100, 8, None)):
        B = torch.randn(N, L, P, generator=g, device=dev)
        y = torch.randn(N, L, generator=g, device=dev)
        if pad is not None:
            B[:, pad:] = 0.0
            y[:, pad:] = 0.0
        w = torch.randn(C, N, P, generator=g, device=dev)
        rss, mu = kernels.mean_rss(B, y, w, want_mu=True)
        rss2, none = kernels.mean_rss(B, y, w)
        rss_p, mu_p = kernels.mean_rss_plain(B, y, w, want_mu=True)
        torch.cuda.synchronize()
        check(none is None and torch.equal(rss, rss2),
              f"K2 gave other bits without mu, or on a second call, at C={C}")
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


def k3_phase(dev, g):
    worst = 0.0
    for R, N, P in ((CHAINS * PROTOCOL["K"], PROTOCOL["N"], PROTOCOL["P"]),
                    (8 * PROTOCOL["K"], PROTOCOL["N"], PROTOCOL["P"]),
                    (5, 21, 8), (7, 130, 16), (3, 40, 20),
                    # slice 6: update_eta's R = C D K of config 3 (8 chains)
                    # and config 4 (256, 16), the sequential scan's
                    # R = C K M D of config 4, config 5's P = 16 at 64 and 4
                    # chains
                    (8 * 2 * 3, 100, 8), (CHAINS * 2, 80, 8), (16 * 2, 80, 8),
                    (16 * 2 * 16, 80, 8), (64 * 4, 64, 16), (4 * 4, 64, 16)):
        G = torch.randn(N, P, P, generator=g, device=dev)
        W = torch.rand(R, N, generator=g, device=dev)
        out = kernels.weighted_gram(W, G)
        out2 = kernels.weighted_gram(W, G)
        ref = kernels.weighted_gram_plain(W, G)
        torch.cuda.synchronize()
        check(torch.equal(out, out2),
              f"K3 gave other bits on a second call at R={R} N={N} P={P}")
        err = (out - ref).abs()
        atol = K3_TOL["atol_per_21"] * N / 21
        ok = bool((err <= atol + K3_TOL["rtol"] * ref.abs()).all())
        print(f"  K3 weighted_gram R={R} N={N} P={P}: "
              f"max|out-plain|={err.max().item():.3e} (tol "
              f"{K3_TOL['rtol']} rel + {atol:.3e} abs)")
        check(ok, f"K3 disagrees with its plain version at R={R} N={N} "
                  f"P={P}")
        worst = max(worst, err.max().item())
    return worst


def headline_start(dev):
    """The protocol's data, priors and spectral-init ensemble on ``dev``."""
    p = PROTOCOL
    K, P, M = p["K"], p["P"], p["M"]
    data, _ = simulate_functional(seed=p["seed"], N=p["N"], K=K, P=P, M=M,
                                  n_time=tuple(p["n_time"]), device=dev)
    hp, c = Priors(), torch.full((K,), 10.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    st = init_state(g, ModelConfig(K=K, P=P, M=M), data, chains=CHAINS)
    st = spectral_ensemble(g, st, data, K, M, z_jitter=p["z_jitter"])
    return data, hp, c, g, st


def path_phase(dev, name):
    """Drive one path through phase_warm_start; returns (seconds, launch
    counts)."""
    flags, ref_path, per_sweep = PATHS[name]
    ref = json.loads(ref_path.read_text())
    check(ref["protocol"] == PROTOCOL and ref["port_chains"] == CHAINS
          and ref.get("census", {}) == flags,
          f"{ref_path.name}: protocol {ref['protocol']} / census "
          f"{ref.get('census')} != {PROTOCOL} / {flags}")
    p = PROTOCOL
    data, hp, c, g, st = headline_start(dev)
    betas = np.interp(np.arange(p["sweeps"]),
                      [0, p["anneal"] - 1, p["sweeps"] - 1],
                      [p["beta0"], 1.0, 1.0])
    ll0 = log_likelihood(st, data)
    # one throwaway sweep first, so library set-up is not timed
    gibbs.sweep_full(torch.Generator(device=dev).manual_seed(1), st, data,
                     hp, c, beta=0.1, **flags)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = drivers.phase_warm_start(g, st, data, hp, c, n_iters=p["sweeps"],
                                   betas=betas, **flags)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)

    final = state_to_numpy(res.final_state)
    for f, v in final.items():
        check(np.all(np.isfinite(v)), f"{name}: final {f} not finite")
    for f, v in res.traces.items():
        check(bool(torch.isfinite(v).all()), f"{name}: trace {f} not finite")
    ll = res.loglik
    check(ll.shape == (CHAINS, p["sweeps"]) and bool(torch.isfinite(ll).all()),
          f"{name}: loglik trace malformed")
    med0 = ll0.median().item()
    med_ll = ll[:, -1].median().item()
    med_s2 = float(np.median(final["sigma2"]))
    print(f"  {name}: {CHAINS} chains x {p['sweeps']} sweeps in "
          f"{seconds:.3f} s; median loglik {med0:.2f} -> {med_ll:.2f}; "
          f"median sigma2 {med_s2:.6f}; launches {counts}")
    check(med_ll > med0, f"{name}: ensemble loglik did not rise")
    for k, n in per_sweep.items():
        check(counts[k] == n * p["sweeps"],
              f"{name}: {k} launched {counts[k]} times in {p['sweeps']} "
              f"sweeps, expected {n} per sweep")
    for stat, med in (("loglik", med_ll), ("sigma2", med_s2)):
        lo, hi = ref[stat]["limits"]
        print(f"  {name} {stat}: port median {med:.6g}, JAX median "
              f"{ref[stat]['median']:.6g}, limits [{lo:.6g}, {hi:.6g}] "
              f"({ref['limit_rule']})")
        check(lo <= med <= hi,
              f"{name}: {stat} median {med} outside [{lo}, {hi}]")
    return seconds, counts


def phase3_launches(per, n, n_temp_trans=0, N_t=1, start=0):
    """(excursions, kernel launches) of ``n`` phase-3 iterations from
    iteration ``start`` whose sweep launches ``per`` (with the loglik
    probe): an excursion in place of a sweep runs 2 N_t sweeps without the
    probe, 2 N_t + 1 pz_unit probes of K2 and the iteration's loglik probe;
    where the basis is the identity (no K2 in the sweep) the probes launch
    none either."""
    rungs = 2 * N_t
    n_exc = sum(1 for it in range(start, start + n)
                if n_temp_trans and it > 0 and it % n_temp_trans == 0)
    probe = 1 if per["mean_rss"] else 0
    return n_exc, {
        "chol_solve": (n - n_exc + n_exc * rungs) * per["chol_solve"],
        "mean_rss": (n - n_exc) * per["mean_rss"]
        + n_exc * (rungs * (per["mean_rss"] - probe)
                   + (rungs + 1 + 1) * probe),
        "weighted_gram": (n - n_exc + n_exc * rungs) * per["weighted_gram"]}


def fit_launches(p):
    """Kernel launches the fit protocol's phase 3 must make: the production
    sweep's 1/7/1 at every plain iteration, and its excursions."""
    return phase3_launches(PATHS["production"][2], p["warm_iters"],
                           p["n_temp_trans"], p["N_t"])


def counters():
    """The launch counts ops/kernels.py keeps, as a dict of its own."""
    return dict(kernels.LAUNCHES)


class ShapeProbe:
    """While active, every launch the three kernel wrappers make is also
    counted by its shape: ``counts[(kernel, shape)]`` rises by what
    ``kernels.LAUNCHES[kernel]`` rose by in the call, the shape being K1's
    (C, D), K2's (C, N, L, P) or K3's (R, N, P).  The sampler reaches the
    wrappers through the module's attributes, so they are wrapped there."""

    SHAPES = {
        "chol_solve": lambda A, b, z, *a, **kw: tuple(b.shape),
        "mean_rss": lambda B, y, w, *a, **kw: (w.shape[0], *B.shape),
        "weighted_gram": lambda W, G: (*W.shape, G.shape[-1])}

    def __init__(self):
        self.counts = {}

    def __enter__(self):
        self._originals = {name: getattr(kernels, name)
                           for name in self.SHAPES}
        for name, fn in self._originals.items():
            setattr(kernels, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._originals.items():
            setattr(kernels, name, fn)

    def _wrap(self, name, fn):
        def wrapper(*a, **kw):
            before = kernels.LAUNCHES[name]
            out = fn(*a, **kw)
            key = (name, self.SHAPES[name](*a, **kw))
            self.counts[key] = (self.counts.get(key, 0)
                                + kernels.LAUNCHES[name] - before)
            return out
        return wrapper

    def check_k1(self, what, kernel):
        """Every K1 launch counted here was at a shape ``kernel`` serves,
        and there was one."""
        shapes = [shape for (name, shape), n in self.counts.items()
                  if name == "chol_solve" and n]
        check(shapes and all(
            kernels.chol_solve_plan(*shape)["kernel"] == kernel
            for shape in shapes),
            f"{what}: K1 launched at {shapes}, not all the {kernel} "
            f"kernel's")
        print(f"  {what}: every K1 launch at a shape of the {kernel} "
              f"kernel: {shapes}")


class PhaseProbe:
    """While active, api.fit_nu_z, api.fit_theta and api.fit_warm_start (the
    names api.fit calls its phases by) record for each call (result,
    seconds ending in a synchronise, what every counter rose by)."""

    NAMES = ("fit_nu_z", "fit_theta", "fit_warm_start")

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._originals = {name: getattr(api, name) for name in self.NAMES}
        for name, fn in self._originals.items():
            setattr(api, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._originals.items():
            setattr(api, name, fn)

    def _wrap(self, name, fn):
        def wrapper(*a, **kw):
            before = counters()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            self.calls.append((name, res, seconds, {
                k: v - before[k] for k, v in counters().items()}))
            return res
        return wrapper


def same_bits(a, b, what):
    """Two phase-3 results hold the same bits: every chain's loglik trace,
    every field of the final ensemble, every trace of the best chain."""
    check(np.array_equal(a.all_chain_loglik, b.all_chain_loglik),
          f"{what}: loglik traces differ")
    for f in STATE_FIELDS:
        check(torch.equal(getattr(a.ensemble_state, f),
                          getattr(b.ensemble_state, f)),
              f"{what}: final ensemble differs in {f}")
    check(a.chain_index == b.chain_index, f"{what}: another best chain")
    for f in a.traces:
        check(np.array_equal(a.traces[f], b.traces[f]),
              f"{what}: trace {f} differs")


def fit_phase(dev, card):
    """Drive the three-phase pipeline through api.fit; returns the launch
    counts of the whole fit and of each of its phases."""
    p = FIT_PROTOCOL
    ref = json.loads(FIT_REFERENCE.read_text())
    check(ref["protocol"] == p and ref["port_chains"] == CHAINS,
          f"{FIT_REFERENCE.name}: protocol {ref['protocol']} != {p}")
    check(api.PRODUCTION_FLAGS == PATHS["production"][0],
          "api.PRODUCTION_FLAGS is not the production census")
    data, _ = simulate_functional(seed=p["seed"], N=p["N"], K=p["K"],
                                  P=p["P"], M=p["M"],
                                  n_time=tuple(p["n_time"]), device=dev)
    warm = dict(kernels=p["kernels"], n_temp_trans=p["n_temp_trans"],
                N_t=p["N_t"], beta_N_t=p["beta_N_t"])

    with tempfile.TemporaryDirectory() as tmp:
        ck, ck2 = os.path.join(tmp, "ensemble.npz"), os.path.join(tmp, "next")
        trace_dir = os.path.join(tmp, "traces")
        # api.fit calls the three phases by their module names: the probe
        # reads the launch counts and the clock around each
        with PhaseProbe() as probe:
            kernels.reset_launch_counts()
            res = api.fit(
                data=data, K=p["K"], M=p["M"], init=p["init"],
                n_try=p["n_try"], nu_z_iters=p["nu_z_iters"],
                theta_iters=p["theta_iters"], warm_iters=p["warm_iters"],
                n_chains=CHAINS, seed=p["fit_seed"], progress_every=100,
                progress=ProgressStream(
                    every=1, printer=lambda m: print(f"    {m}")),
                checkpoint_to=ck, directory=trace_dir, **warm)
            torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)
        check([c[0] for c in probe.calls] == list(PhaseProbe.NAMES),
              f"api.fit ran {[c[0] for c in probe.calls]}")
        (r1, s1, c1), (r2, s2, c2), (r3, s3, c3) = (
            (r, s_, {k: c[k] for k in KERNEL_NAMES})
            for _, r, s_, c in probe.calls)
        check(r3 is res, "api.fit did not return phase 3's result")

        # shapes, finiteness, loglik phase over phase
        n1, n2, n3 = p["nu_z_iters"], p["theta_iters"], p["warm_iters"]
        for name, r, n in (("phase 1", r1, n1), ("phase 2", r2, n2),
                           ("phase 3", r3, n3)):
            check(r.loglik.shape == (n,) and np.all(np.isfinite(r.loglik)),
                  f"{name}: loglik trace malformed")
            for f, v in r.traces.items():
                check(v.shape[0] == n and np.all(np.isfinite(v)),
                      f"{name}: trace {f} malformed")
        check(res.all_chain_loglik.shape == (CHAINS, n3)
              and np.all(np.isfinite(res.all_chain_loglik)),
              "phase 3: ensemble loglik malformed")
        final = state_to_numpy(res.ensemble_state)
        for f, v in final.items():
            check(v.shape[0] == CHAINS and np.all(np.isfinite(v)),
                  f"phase 3: final {f} malformed")
        best = [float(np.mean(r.loglik[-100:])) for r in (r1, r2, r3)]
        print(f"  fit: best chain's mean loglik over its last 100 draws, "
              f"phase over phase: {best[0]:.2f} -> {best[1]:.2f} -> "
              f"{best[2]:.2f} (JAX: "
              + " -> ".join(f"{v:.2f}" for v in
                            ref["best_chain_loglik_last_100"].values())
              + f"); chains {r1.chain_index}, {r2.chain_index}, "
              f"{r3.chain_index} chosen")
        check(best[0] < best[1] < best[2],
              "fit: the best chain's loglik did not rise phase over phase")

        # launch counts of each phase
        n_exc, want3 = fit_launches(p)
        for name, got, want in (
                ("phase 1", c1, {k: v * n1 for k, v in
                                 PHASE_LAUNCHES["nu_z"].items()}),
                ("phase 2", c2, {k: v * n2 for k, v in
                                 PHASE_LAUNCHES["theta"].items()}),
                ("phase 3", c3, want3)):
            print(f"  fit {name}: launches {got}")
            check(got == want, f"fit {name}: launches {got}, expected {want}")
        check(counts == {k: c1[k] + c2[k] + c3[k] for k in counts},
              f"fit: launches {counts} are not the three phases' sum")
        check(res.tt_accept.shape == (CHAINS, n_exc),
              f"fit: {res.tt_accept.shape} excursion decisions, expected "
              f"{(CHAINS, n_exc)}")
        print(f"  fit: {n_exc} excursions x {CHAINS} chains, accepted "
              f"{int(res.tt_accept.sum())} of {res.tt_accept.size} "
              f"({res.tt_accept.mean(0).round(4).tolist()} by excursion)")

        # the ensemble against the JAX package's
        med_ll = float(np.median(res.all_chain_loglik[:, -1]))
        med_s2 = float(np.median(final["sigma2"]))
        for stat, med in (("loglik", med_ll), ("sigma2", med_s2)):
            lo, hi = ref[stat]["limits"]
            print(f"  fit {stat}: port median {med:.6g}; JAX medians under "
                  f"seeds {ref['seeds']}: "
                  + ", ".join(f"{m:.6g}" for m in ref[stat]["medians"])
                  + f"; limits [{lo:.6g}, {hi:.6g}] ({ref['limit_rule']})")
            check(lo <= med <= hi,
                  f"fit: {stat} median {med} outside [{lo}, {hi}]")

        # the exported directory gives back the best chain's traces
        disk = armaio.load_trace_dir(trace_dir)
        stems = api.export_layout(res.traces, res.config)
        check(sorted(disk) == sorted(stems), f"fit: exported {sorted(disk)}")
        for stem, v in stems.items():
            check(np.array_equal(disk[stem], v.astype(np.float64)),
                  f"fit: {stem} read back from {trace_dir} differs")

        # two resumes from one file: the same bits
        kw = dict(resume_from=ck, data=data, tot_mcmc_iters=RESUME_SWEEPS,
                  progress=False, **warm)
        ra = api.fit_warm_start(checkpoint_to=ck2, **kw)
        rb = api.fit_warm_start(**kw)
        same_bits(ra, rb, "two resumes from one checkpoint")
        moved = (ra.ensemble_state.nu - res.ensemble_state.nu).abs().max()
        check(moved.item() > 1e-6, "the resumed ensemble did not move")
        it = load_checkpoint(ck2, dev)[2]
        check(it == n3 + RESUME_SWEEPS,
              f"the second checkpoint is at iteration {it}")
        # a run split at the checkpoint is the unbroken run
        whole = api.fit_warm_start(
            r1, r2, tot_mcmc_iters=n3 + RESUME_SWEEPS, n_chains=CHAINS,
            seed=p["fit_seed"] + 2, progress=False, **warm)
        check(np.array_equal(whole.all_chain_loglik[:, :n3],
                             res.all_chain_loglik)
              and np.array_equal(whole.all_chain_loglik[:, n3:],
                                 ra.all_chain_loglik),
              f"{n3} + {RESUME_SWEEPS} sweeps through the checkpoint are "
              f"not the unbroken run's loglik traces")
        for f in STATE_FIELDS:
            check(torch.equal(getattr(whole.ensemble_state, f),
                              getattr(ra.ensemble_state, f)),
                  f"split run: final ensemble differs in {f}")
        check(whole.tt_accept.shape[1] > n_exc and np.array_equal(
            whole.tt_accept, np.concatenate([res.tt_accept, ra.tt_accept], 1)),
            "split run: the excursions' decisions differ")
        print(f"  fit: two resumes of {RESUME_SWEEPS} sweeps gave the same "
              f"bits; {n3} + {RESUME_SWEEPS} sweeps through the checkpoint "
              f"gave the bits of one {n3 + RESUME_SWEEPS}-sweep run "
              f"(excursion at {n3} included); the second checkpoint is at "
              f"iteration {it}")

        # fault B's gate: phase 3 alone from the JAX package's own phase-1/2
        # medians lands where the JAX package's phase 3 did
        start = fit_result_from_estimates(ref["warm_start_from"], data,
                                          res.config)
        t0 = time.perf_counter()
        tight = api.fit_warm_start(
            start, start, tot_mcmc_iters=n3, n_chains=CHAINS,
            seed=p["fit_seed"] + 2, progress=False, **warm)
        torch.cuda.synchronize()
        tight_s = time.perf_counter() - t0
        lims = ref["from_jax_medians"]
        for stat, med in (
                ("loglik", float(np.median(tight.all_chain_loglik[:, -1]))),
                ("sigma2", float(tight.ensemble_state.sigma2.median()))):
            lo, hi = lims[stat]
            print(f"  fit from the JAX package's phase-1/2 medians (fit seed "
                  f"{lims['fit_seed']}), {stat}: port median {med:.6g}, JAX "
                  f"median {ref['runs'][0][stat]['median']:.6g}, limits "
                  f"[{lo:.6g}, {hi:.6g}] (median +- 5 se of two sample "
                  f"medians, no spread between seeds in it)")
            check(lo <= med <= hi, f"fit from the JAX medians: {stat} median "
                                   f"{med} outside [{lo}, {hi}]")
        print(f"  fit from the JAX medians: {n3} iterations in {tight_s:.3f} s")

    ess = diagnostics.rank_normalized_ess(res.all_chain_loglik)
    rhat = diagnostics.rank_normalized_rhat(res.all_chain_loglik)
    print(f"  fit on {card}: phase 1 {s1:.3f} s ({s1 / n1 * 1e3:.3f} ms per "
          f"sweep of {p['n_try'] + 1} chains), phase 2 {s2:.3f} s "
          f"({s2 / n2 * 1e3:.3f} ms per sweep of {p['n_try']} chains), phase "
          f"3 {s3:.3f} s ({CHAINS * n3 / s3:.1f} chain-sweeps/s, "
          f"{s3 / n3 * 1e3:.3f} ms per iteration of {CHAINS} chains, "
          f"excursions, host copies, checkpoint and export included); "
          f"loglik trace of phase 3, {CHAINS} chains x {n3} draws: "
          f"rank-normalised ESS {ess:.1f}, R-hat {rhat:.4f}")
    return counts, {"nu_z": c1, "theta": c2, "warm_start": c3}


# ---------------------------------------------------------------------------
# Slice 6: configurations 4, 3, 1 and 5
# ---------------------------------------------------------------------------

def family_reference(name):
    ref = json.loads(FAMILIES_REFERENCE.read_text())
    check(ref[name]["protocol"] == FAMILY_PROTOCOLS[name],
          f"{FAMILIES_REFERENCE.name}: {name}'s protocol "
          f"{ref[name]['protocol']} != {FAMILY_PROTOCOLS[name]}")
    return ref[name], ref["limit_rule"]


def hd_grid_data(p, dev):
    """The hd configuration's data: every surface seen on one grid of
    p["grid"] points a side, the truth and the noise drawn as
    simulate_hd_functional draws them (which observes random points, so its
    draws are restated here without them, as benchmarks/suite.py and
    tests/data/make_torch_families_reference.py::hd_grid_data do)."""
    rng = np.random.default_rng(p["seed"])
    g = np.linspace(0, 1, p["grid"])
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    t_list = [pts] * p["N"]
    kw = dict(basis_degrees=tuple(p["basis_degrees"]),
              internal_knots_list=[np.linspace(0, 1, n + 2)[1:-1]
                                   for n in p["n_internal"]],
              boundary_knots=np.tile(np.array([0.0, 1.0]), (2, 1)))
    data0 = make_hd_functional_data([np.zeros(len(pts))] * p["N"], t_list,
                                    device="cpu", **kw)
    truth = _truth_state(rng, p["N"], p["K"], int(data0.P), p["M"], 0,
                         nu_scale=3.0, phi_scale=0.5, sigma2=p["sigma2"],
                         with_eta=False, with_xi=False)
    mu = _numpy_mu(data0.B.numpy(), data0.X.numpy(), truth)
    y = mu + np.sqrt(p["sigma2"]) * rng.normal(size=mu.shape) \
        * data0.mask.numpy()
    return make_hd_functional_data(list(y), t_list, device=dev, **kw)


def family_data(dev, name):
    """The configuration's data from the port's simulators (the JAX
    simulators' bits) and its full ModelConfig."""
    p = FAMILY_PROTOCOLS[name]
    if p["family"] == "multivariate":
        data, _ = simulate_multivariate(seed=p["seed"], N=p["N"], K=p["K"],
                                        P=p["P"], M=p["M"], device=dev)
    elif p["family"] == "hd":
        data = hd_grid_data(p, dev)
    else:
        data, _ = simulate_functional(
            seed=p["seed"], N=p["N"], K=p["K"], P=p["P"], M=p["M"], D=p["D"],
            n_time=tuple(p["n_time"]), with_eta=p.get("with_eta", False),
            with_xi=p.get("with_xi", False), device=dev)
    cfg = ModelConfig(K=p["K"], P=int(data.P), M=p["M"], D=int(data.D),
                      family=p["family"],
                      covariate_mean=p.get("with_eta", False),
                      covariate_cov=p.get("with_xi", False))
    return data, cfg


def per_sweep(sweep, model):
    return dict(zip(KERNEL_NAMES, SWEEP_LAUNCHES[(sweep, model)]))


def check_counts(what, got, want):
    """The launches of one phase: K1, K2, K3 as predicted."""
    print(f"  {what}: launches {got}")
    check(got == want, f"{what}: launches {got}, expected {want}")


def gate(what, ref, rule, loglik, sigma2):
    """An ensemble's final loglik (C,) and sigma2 (C,) against the JAX
    package's limits; returns the two medians."""
    meds = {"loglik": float(np.median(np.asarray(loglik, np.float64))),
            "sigma2": float(np.median(np.asarray(sigma2, np.float64)))}
    for stat, med in meds.items():
        lo, hi = ref[stat]["limits"]
        seeds = ref[stat].get("medians", [ref[stat]["median"]])
        print(f"  {what} {stat}: port median {med:.6g}; JAX medians "
              + ", ".join(f"{m:.6g}" for m in seeds)
              + f"; limits [{lo:.6g}, {hi:.6g}] ({rule})")
        check(lo <= med <= hi,
              f"{what}: {stat} median {med} outside [{lo}, {hi}]")
    return meds


def finite_result(what, res, chains, n):
    check(res.all_chain_loglik.shape == (chains, n)
          and np.all(np.isfinite(res.all_chain_loglik)),
          f"{what}: ensemble loglik malformed")
    for f, v in state_to_numpy(res.ensemble_state).items():
        check(v.shape[0] == chains and np.all(np.isfinite(v)),
              f"{what}: final {f} malformed")
    for f, v in res.traces.items():
        check(v.shape[0] == n and np.all(np.isfinite(v)),
              f"{what}: trace {f} malformed")


def config4_phase(dev, card):
    """Config 4 through api.fit with covariate_cov=True; returns the
    counters of the whole path and the ms a sweep of its two ensembles."""
    ref, rule = family_reference("config4")
    p = FAMILY_PROTOCOLS["config4"]
    pr, pp = p["reference"], p["production"]
    data, cfg = family_data(dev, "config4")
    check(data.D == 1 and p["K"] * p["M"] * p["P"] == 256
          and p["K"] * p["M"] * p["D"] * p["P"] == 256,
          "config 4 does not draw Phi and xi at 256 dimensions")
    seed = p["fit_seeds"][0]
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp, PhaseProbe() as probe, \
            ShapeProbe() as shapes:
        ck = os.path.join(tmp, "ensemble.npz")
        # phases 1 and 2 with restarts, phase 3 at the suite's 16 chains
        ra = api.fit(data=data, K=p["K"], M=p["M"], covariate_cov=True,
                     init=p["init"], n_try=p["n_try"],
                     nu_z_iters=p["nu_z_iters"], theta_iters=p["theta_iters"],
                     warm_iters=pr["warm_iters"], n_chains=pr["port_chains"],
                     kernels=pr["kernels"], seed=seed, progress=False)
        r1, r2 = probe.calls[0][1], probe.calls[1][1]
        check(ra.config == cfg, f"config 4: fitted {ra.config}")
        # from the same medians, 256 chains of the production census with a
        # tempered excursion, checkpointed
        warm = dict(kernels=pp["kernels"], n_temp_trans=pp["n_temp_trans"],
                    N_t=pp["N_t"], beta_N_t=pp["beta_N_t"], progress=False)
        C, n = pp["port_chains"], pp["warm_iters"]
        rb = api.fit_warm_start(r1, r2, tot_mcmc_iters=n, n_chains=C,
                                seed=seed + 2, checkpoint_to=ck, **warm)
        counts, by_shape = counters(), dict(shapes.counts)
        # the resume continues the unbroken run bit for bit
        rc = api.fit_warm_start(resume_from=ck, data=data,
                                tot_mcmc_iters=RESUME_SWEEPS, **warm)
        whole = api.fit_warm_start(r1, r2, tot_mcmc_iters=n + RESUME_SWEEPS,
                                   n_chains=C, seed=seed + 2, **warm)
    (_, _, s1, c1), (_, _, s2, c2), (_, _, sa, ca), (_, _, sb, cb), \
        (_, _, sc, cc), _ = probe.calls
    n1, n2, na = p["nu_z_iters"], p["theta_iters"], pr["warm_iters"]
    finite_result("config 4 reference", ra, pr["port_chains"], na)
    finite_result("config 4 production", rb, C, n)
    check(rc.config == ra.config and rc.config.covariate_cov,
          f"config 4: resumed as {rc.config}")
    check_counts("config 4 phase 1", c1,
                 {k: v * n1 for k, v in per_sweep("nu_z", "eta").items()})
    check_counts("config 4 phase 2", c2,
                 {k: v * n2 for k, v in per_sweep("theta", "xi").items()})
    check_counts("config 4 phase 3, 16 chains, reference census", ca,
                 phase3_launches(per_sweep("reference", "xi"), na)[1])
    n_exc, want = phase3_launches(per_sweep("production", "xi"), n,
                                  pp["n_temp_trans"], pp["N_t"])
    check_counts(f"config 4 phase 3, {C} chains, production census, "
                 f"{n_exc} excursion", cb, want)
    check_counts(
        "config 4 resume", cc,
        phase3_launches(per_sweep("production", "xi"), RESUME_SWEEPS,
                        pp["n_temp_trans"], pp["N_t"], start=n)[1])
    shapes.check_k1("config 4", "packed")
    check(ca["chol_solve"] == 2 * na
          and by_shape[("chol_solve", (pr["port_chains"], 256))] == 2 * na,
          "config 4: K1 did not launch twice a phase-3 sweep at D = 256")
    check(rb.tt_accept.shape == (C, n_exc) and n_exc == 1,
          f"config 4: {rb.tt_accept.shape} excursion decisions")
    check(np.array_equal(whole.all_chain_loglik[:, :n], rb.all_chain_loglik)
          and np.array_equal(whole.all_chain_loglik[:, n:],
                             rc.all_chain_loglik),
          f"config 4: {n} + {RESUME_SWEEPS} sweeps through the checkpoint "
          f"are not the unbroken run's loglik traces")
    for f in STATE_FIELDS:
        check(torch.equal(getattr(whole.ensemble_state, f),
                          getattr(rc.ensemble_state, f)),
              f"config 4 split run: final ensemble differs in {f}")
    print(f"  config 4: {n} + {RESUME_SWEEPS} sweeps through the checkpoint "
          f"gave the bits of one {n + RESUME_SWEEPS}-sweep run; excursion "
          f"accepted by {int(rb.tt_accept.sum())} of {C} chains")
    gate("config 4 reference (16 chains)", ref["reference"], rule,
         ra.all_chain_loglik[:, -1], ra.ensemble_state.sigma2.cpu())
    gate(f"config 4 production ({C} chains)", ref["production"], rule,
         rb.all_chain_loglik[:, -1], rb.ensemble_state.sigma2.cpu())
    print(f"  config 4 on {card}: phase 1 {s1 / n1 * 1e3:.3f} ms per sweep of "
          f"{p['n_try'] + 1} chains, phase 2 {s2 / n2 * 1e3:.3f} ms per sweep "
          f"of {p['n_try']} chains, phase 3 reference "
          f"{sa / na * 1e3:.3f} ms per sweep of 16 chains, production "
          f"{sb / n * 1e3:.3f} ms per iteration of {C} chains "
          f"({C * n / sb:.1f} chain-sweeps/s; the excursion, host copies "
          f"and the checkpoint included)")
    check(counts == {k: c1[k] + c2[k] + ca[k] + cb[k] for k in c1},
          f"config 4: launches {counts} are not its four phases' sum")
    return counts, by_shape, {"config4 16 chains": sa / na * 1e3,
                              "config4 256 chains": sb / n * 1e3}


def config3_phase(dev, card):
    """Config 3: sweep_full(covariate_mean=True) from the spectral init."""
    ref, rule = family_reference("config3")
    p = FAMILY_PROTOCOLS["config3"]
    K, P, M, C = p["K"], p["P"], p["M"], p["port_chains"]
    data, cfg = family_data(dev, "config3")
    hp, c = Priors(), torch.full((K,), 10.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    st = init_state(g, cfg, data, chains=C)
    st = spectral_ensemble(g, st, data, K, M, z_jitter=p["z_jitter"])
    betas = np.interp(np.arange(p["sweeps"]),
                      [0, p["anneal"] - 1, p["sweeps"] - 1],
                      [p["beta0"], 1.0, 1.0])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with ShapeProbe() as shapes:
        res = drivers.phase_warm_start(g, st, data, hp, c,
                                       n_iters=p["sweeps"], betas=betas,
                                       covariate_mean=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = counters()
    for f, v in state_to_numpy(res.final_state).items():
        check(np.all(np.isfinite(v)), f"config 3: final {f} not finite")
    check(float(res.final_state.eta.abs().max()) > 0
          and not bool(res.final_state.xi.any()),
          "config 3: eta did not move, or xi did")
    check_counts("config 3", counts, {
        k: v * p["sweeps"] for k, v in per_sweep("reference", "eta").items()})
    shapes.check_k1("config 3", "tiled")
    gate(f"config 3 ({C} chains)", ref["ensemble"], rule,
         res.loglik[:, -1].cpu(), res.final_state.sigma2.cpu())
    print(f"  config 3 on {card}: {seconds / p['sweeps'] * 1e3:.3f} ms per "
          f"sweep of {C} chains")
    return counts, shapes.counts, {"config3": seconds / p["sweeps"] * 1e3}


def family_fit_phase(dev, card, name, data, model, k1_kernel):
    """Configs 1 and 5: the three phases through api.fit."""
    ref, rule = family_reference(name)
    p = FAMILY_PROTOCOLS[name]
    C, n1, n2, n3 = (p["port_chains"], p["nu_z_iters"], p["theta_iters"],
                     p["warm_iters"])
    kernels.reset_launch_counts()
    with PhaseProbe() as probe, ShapeProbe() as shapes:
        res = api.fit(data=data, K=p["K"], M=p["M"], init=p["init"],
                      n_try=p["n_try"], nu_z_iters=n1, theta_iters=n2,
                      warm_iters=n3, n_chains=C, kernels=p["kernels"],
                      seed=p["fit_seeds"][0], progress=False)
    counts = counters()
    (_, _, s1, c1), (_, _, s2, c2), (_, _, s3, c3) = probe.calls
    check(res.config.family == p["family"] and res.config.D == 0,
          f"{name}: fitted {res.config}")
    finite_result(name, res, C, n3)
    check_counts(f"{name} phase 1", c1,
                 {k: v * n1 for k, v in per_sweep("nu_z", model).items()})
    check_counts(f"{name} phase 2", c2,
                 {k: v * n2 for k, v in per_sweep("theta", model).items()})
    check_counts(f"{name} phase 3", c3,
                 phase3_launches(per_sweep("production", model), n3)[1])
    shapes.check_k1(name, k1_kernel)
    gate(f"{name} ({C} chains)", ref["ensemble"], rule,
         res.all_chain_loglik[:, -1], res.ensemble_state.sigma2.cpu())
    print(f"  {name} on {card}: phase 1 {s1 / n1 * 1e3:.3f}, phase 2 "
          f"{s2 / n2 * 1e3:.3f} ms per sweep of {p['n_try'] + 1} and "
          f"{p['n_try']} chains, phase 3 {s3 / n3 * 1e3:.3f} ms per sweep of "
          f"{C} chains")
    return res, counts, shapes.counts, {name: s3 / n3 * 1e3}


def config1_phase(dev, card):
    p = FAMILY_PROTOCOLS["config1"]
    data, _ = family_data(dev, "config1")
    check(data.identity_basis and p["K"] * p["M"] * p["P"] == 60,
          "config 1 is not the identity-basis model at D = 60")
    res, counts, by_shape, ms = family_fit_phase(dev, card, "config1", data,
                                                 "mv", "tiled")
    check(counts["mean_rss"] == 0 and counts["weighted_gram"] == 0
          and counts["chol_solve"] > 0,
          f"config 1: the multivariate family launched {counts}")
    # the exported Tau is the variance: the reciprocal, finite in float32
    tau = api.export_layout(res.traces, res.config)["Tau"]
    check(np.all(np.isfinite(tau)) and np.allclose(
        tau, 1.0 / res.traces["tau"]), "config 1: exported Tau")
    return counts, by_shape, ms


def config5_phase(dev, card):
    p = FAMILY_PROTOCOLS["config5"]
    data, _ = family_data(dev, "config5")
    check(data.P == 16 and data.L == 144 and data.family == "hd"
          and p["K"] * p["M"] * data.P == 256,
          "config 5 is not the hd model at P = 16, L = 144, D = 256")
    _, counts, by_shape, ms = family_fit_phase(dev, card, "config5", data,
                                               "hd", "packed")
    return counts, by_shape, ms


def sweep_profile(dev, name, chains, flags):
    """Kernels and device-busy ms of one sweep_full of ``chains`` chains
    from a random state, under the profiler (which slows the host; the ms a
    sweep of the runs above are the host's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    data, cfg = family_data(dev, name)
    flags = dict(flags, covariate_mean=cfg.covariate_mean,
                 covariate_cov=cfg.covariate_cov)
    g = torch.Generator(device=dev).manual_seed(5)
    c = torch.full((cfg.K,), 10.0, device=dev)
    st = init_state(g, cfg, data, chains=chains)
    for _ in range(2):
        st = gibbs.sweep_full(g, st, data, Priors(), c, **flags)
    torch.cuda.synchronize()
    reps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            st = gibbs.sweep_full(g, st, data, Priors(), c, **flags)
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA]
    n = sum(ev.count for ev in events) / reps
    busy = sum(ev.self_device_time_total for ev in events) / reps / 1e3
    top = sorted(events, key=lambda ev: -ev.self_device_time_total)[:4]
    print(f"  {name}, {chains} chains: {n:.0f} kernels and {busy:.3f} ms of "
          f"device time a sweep; most of it in "
          + ", ".join(f"{ev.key[:48]} {ev.self_device_time_total / reps / 1e3:.3f} ms"
                      for ev in top))
    check(n > 0 and busy > 0, f"{name}: the profiler saw no device work")
    return {"kernels": n, "device_ms": busy}


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
    k3_err = k3_phase(dev, g)
    print("phase 4 K3 weighted_gram vs plain: ok")

    s_seconds, s_counts = path_phase(dev, "slice")
    print("phase 5 slice 1 path (reference census): ok")
    p_seconds, p_counts = path_phase(dev, "production")
    print("phase 6 slice 2 path (production census): ok")
    counts, fit_counts = fit_phase(dev, card)
    print("phase 7 slice 5 path (three-phase fit through api.fit): ok")

    c4_path, c4_shapes, ms4 = config4_phase(dev, card)
    print("phase 8 slice 6 path, config 4 (eta and xi through api.fit, K1 "
          "at D = 256): ok")
    c3, c3_shapes, ms3 = config3_phase(dev, card)
    print("phase 8 slice 6 path, config 3 (eta, sweep_full): ok")
    c1, _, ms1 = config1_phase(dev, card)
    print("phase 8 slice 6 path, config 1 (multivariate through api.fit): ok")
    c5, c5_shapes, ms5 = config5_phase(dev, card)
    print("phase 8 slice 6 path, config 5 (hd through api.fit): ok")
    slice6 = {"config4": c4_path, "config3": c3, "config1": c1, "config5": c5}
    for k in KERNEL_NAMES:
        check(c4_path[k] > 0, f"config 4's path never launched {k}")

    x = main_path_inputs(dev)
    C, K, N, P = CHAINS, PROTOCOL["K"], PROTOCOL["N"], PROTOCOL["P"]
    fn1 = (kernels.chol_solve, kernels.chol_solve_plain, None)
    fn2 = (kernels.mean_rss, kernels.mean_rss_plain, None)
    fn3 = (kernels.weighted_gram, kernels.weighted_gram_plain,
           library_weighted_gram)
    # inputs' name -> (kernel, shape, kernel, plain version, the one PyTorch
    # call or None); the last three are the fit's restart phases
    timed = {
        "chol_solve": ("chol_solve", dict(C=C, D=96), *fn1),
        "mean_rss": ("mean_rss", dict(C=C, N=N, L=100, P=P), *fn2),
        "mean_rss_2c": ("mean_rss", dict(C=2 * C, N=N, L=100, P=P), *fn2),
        "weighted_gram": ("weighted_gram", dict(R=C * K, N=N, P=P), *fn3),
        "chol_solve_c7": ("chol_solve", dict(C=7, D=96), *fn1),
        "mean_rss_c8": ("mean_rss", dict(C=8, N=N, L=100, P=P), *fn2),
        "weighted_gram_r24": ("weighted_gram", dict(R=8 * K, N=N, P=P), *fn3),
    }
    # slice 6's shapes: K1 at D = 256 with the jitter the sweep passes, beside
    # the three torch.linalg calls; K2 of the hd family (P = 16, L = 144) at
    # 64 chains and the MGP-scale moves' 128 rows, and of config 4 (N = 80);
    # K3 of update_eta (R = C D K: configs 3 and 4) and of the hd family
    g6 = torch.Generator(device=dev).manual_seed(321)

    def k2_inputs(C6, N6, L6, P6):
        return (torch.randn(N6, L6, P6, generator=g6, device=dev),
                torch.randn(N6, L6, generator=g6, device=dev),
                torch.randn(C6, N6, P6, generator=g6, device=dev))

    def k3_inputs(R6, N6, P6):
        return (torch.rand(R6, N6, generator=g6, device=dev),
                torch.randn(N6, P6, P6, generator=g6, device=dev))

    fn1j = (lambda A, b, z: kernels.chol_solve(A, b, z, 1e-6),
            lambda A, b, z: kernels.chol_solve_plain(A, b, z, 1e-6),
            library_chol_solve)
    # name -> (..., the launches at each shape of the path that has it)
    timed6 = {
        "chol_solve_c16_d256": ("chol_solve", dict(C=16, D=256), *fn1j,
                                c4_shapes),
        "chol_solve_c64_d256": ("chol_solve", dict(C=64, D=256), *fn1j,
                                c5_shapes),
        "chol_solve_c256_d256": ("chol_solve", dict(C=C, D=256), *fn1j,
                                 c4_shapes),
        "mean_rss_hd_c64": ("mean_rss", dict(C=64, N=64, L=144, P=16), *fn2,
                            c5_shapes),
        "mean_rss_hd_c128": ("mean_rss", dict(C=128, N=64, L=144, P=16),
                             *fn2, c5_shapes),
        "mean_rss_n80_c256": ("mean_rss", dict(C=C, N=80, L=100, P=8), *fn2,
                              c4_shapes),
        "weighted_gram_eta_r48": ("weighted_gram", dict(R=48, N=100, P=8),
                                  *fn3, c3_shapes),
        "weighted_gram_eta_r512": ("weighted_gram", dict(R=2 * C, N=80, P=8),
                                   *fn3, c4_shapes),
        "weighted_gram_hd_r256": ("weighted_gram", dict(R=256, N=64, P=16),
                                  *fn3, c5_shapes),
    }
    launches6 = {}
    for name, (base, shape, *fns, by_shape) in timed6.items():
        launched = by_shape.get((base, tuple(shape.values())), 0)
        check(launched > 0, f"{name}: its path never launched {base} at "
                            f"{shape}")
        if base == "chol_solve":
            x[name] = spd(g6, shape["C"], shape["D"], dev)
        elif base == "mean_rss":
            x[name] = k2_inputs(*(shape[k] for k in "CNLP"))
        else:
            x[name] = k3_inputs(*(shape[k] for k in "RNP"))
        timed[name] = (base, shape, *fns)
        launches6[name] = launched
    ms = {}
    for name, (base, shape, kern, plain, library) in timed.items():
        cands = {"kernel": lambda: kern(*x[name]),
                 "plain": lambda: plain(*x[name]),
                 "empty": lambda: kernels.empty_launch(dev)}
        if library is not None:
            cands["library"] = lambda: library(*x[name])
        t = {k: v["device_ms"] for k, v in in_turns(cands, rounds=3).items()}
        t["paced"] = paced_ms(cands["kernel"])
        t["paced_plain"] = paced_ms(cands["plain"])
        t.update(kernels.kernel_bound(base, **shape))
        ms[name] = t
    def jitter_ops():
        return kernels.add_jitter(x["chol_solve"][0], 1e-6)
    jitter_ms, jitter_launches = device_ms(jitter_ops), device_launches(
        jitter_ops)
    n = PROTOCOL["sweeps"]
    print(f"phase 9 timings on {card}: slice 1 "
          f"{CHAINS * n / s_seconds:.1f} chain-sweeps/s "
          f"({s_seconds / n * 1e3:.3f} ms per sweep); production "
          f"{CHAINS * n / p_seconds:.1f} chain-sweeps/s "
          f"({p_seconds / n * 1e3:.3f} ms per sweep), {CHAINS} chains, "
          f"loglik every sweep")
    print(f"  the jitter ops K1 absorbed (A + jitter * scale * I in PyTorch, "
          f"C={C} D=96): {jitter_launches} kernels, "
          f"{jitter_ms:.4f} ms of device time a call")
    for name, (_, shape, *_) in timed.items():
        t = ms[name]
        lib_ms = f"{t['library']:.4f} ms" if "library" in t else "none"
        print(f"  {name} {shape}: device {t['kernel']:.4f} ms vs plain "
              f"{t['plain']:.4f} ms, one PyTorch call {lib_ms}, empty kernel "
              f"{t['empty']:.4f} ms; bound {t['bound_ms']:.6f} ms by "
              f"{t['bound_by']} ({t['bytes']} bytes, {t['flop']:.0f} FLOP; "
              f"{100 * t['bound_ms'] / t['kernel']:.2f} % of it reached); "
              f"host-paced {t['paced']:.4f} ms vs plain "
              f"{t['paced_plain']:.4f} ms")

    # slice 6: ms, kernels and device-busy ms a sweep of each configuration
    sweeps6 = {**ms4, **ms3, **ms1, **ms5}
    profiles = {
        "config4 16 chains": sweep_profile(dev, "config4", 16, {}),
        "config4 256 chains": sweep_profile(dev, "config4", CHAINS,
                                            api.PRODUCTION_FLAGS),
        "config3": sweep_profile(dev, "config3", 8, {}),
        "config1": sweep_profile(dev, "config1", 4, api.PRODUCTION_FLAGS),
        "config5": sweep_profile(dev, "config5", 64, api.PRODUCTION_FLAGS),
    }
    for name, v in profiles.items():
        v["ms_per_sweep"] = sweeps6[name]
        print(f"  {name}: {sweeps6[name]:.3f} ms a sweep on the host's "
              f"clock, {v['kernels']:.0f} kernels and {v['device_ms']:.3f} "
              f"ms of device time a sweep "
              f"({100 * v['device_ms'] / sweeps6[name]:.1f} % busy)")

    SOURCES = {"chol_solve": ("chol_solve.cu", 228),
               "mean_rss": ("mean_rss.cu", 68),
               "weighted_gram": ("weighted_gram.cu", 122)}
    ERRS = {"chol_solve": k1_err, "mean_rss": k2_err, "weighted_gram": k3_err}

    def shape_entry(name):
        """One of slice 6's shapes: the keys every kernel entry has."""
        base, shape = timed[name][0], timed[name][1]
        t = ms[name]
        return {"name": name, "route": "cuda",
                "source": f"bayesfmmm_torch/csrc/{SOURCES[base][0]}",
                "replaces": "bayesfmmm_tpu/ops/pallas_kernels.py:"
                            f"{SOURCES[base][1]}",
                "launches": launches6[name], "max_abs_err": ERRS[base],
                "ms": t["kernel"], "plain_ms": t["plain"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library"), "shape": shape,
                "bytes": t["bytes"], "flop": t["flop"],
                "empty_ms": t["empty"]}

    def entry(name, small, source, line, err):
        t = ms[name]
        return {"name": name, "route": "cuda",
                "source": f"bayesfmmm_torch/csrc/{source}",
                "replaces": f"bayesfmmm_tpu/ops/pallas_kernels.py:{line}",
                "launches": counts[name], "max_abs_err": err,
                "launches_by_path": {"slice": s_counts[name],
                                     "production": p_counts[name],
                                     **{f"fit {ph}": c[name]
                                        for ph, c in fit_counts.items()},
                                     **{cfg: c[name]
                                        for cfg, c in slice6.items()}},
                "ms": t["kernel"], "plain_ms": t["plain"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library"),
                "launches_per_sweep": {
                    **{path: per[name] for path, (_, _, per) in PATHS.items()},
                    **{ph: per[name] for ph, per in PHASE_LAUNCHES.items()}},
                "empty_ms": t["empty"],
                "at_restart_chains": {k: ms[small][k] for k in (
                    "kernel", "plain", "bound_ms", "bound_by")}}

    k2 = entry("mean_rss", "mean_rss_c8", "mean_rss.cu", 68, k2_err)
    # the MGP-scale moves' 2C chain rows, 4 of the production sweep's 7
    k2["at_2c_rows"] = {k: ms["mean_rss_2c"][k]
                        for k in ("kernel", "plain", "bound_ms", "bound_by")}
    print(card)
    print(json.dumps({"kernels": [
        entry("chol_solve", "chol_solve_c7", "chol_solve.cu", 228, k1_err),
        k2, entry("weighted_gram", "weighted_gram_r24", "weighted_gram.cu",
                  122, k3_err), *(shape_entry(name) for name in timed6)],
        "sweeps": profiles}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
