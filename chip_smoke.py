#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bayesfmmm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one line each, any failure exits non-zero:

  1. build the CUDA kernels from bayesfmmm_torch/csrc with nvcc;
  2. K1 chol_solve against its plain version (torch.linalg) at the main
     path's shape, at shapes that take each of its two kernels, and at
     every D the register-tiled kernel serves with a ragged chain count;
     each without and with the jitter, the same bits from two calls;
  3. K2 mean_rss against its plain version (einsum + sum) at the main
     path's two shapes (C and the MGP-scale moves' 2C chain rows) and a
     padded one, with and without mu, the same bits from two calls;
  4. K3 weighted_gram against its plain version (einsum) at the main
     path's shape, a ragged one, a wider P and one with P > 16 (the
     chunked kernel), the same bits from two calls;
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
  8. timings: chain-sweeps/s of both paths, and each kernel at the main
     path's shapes (K2 at C and at 2C chain rows, and the restart phases'
     7 and 8 chains) beside its plain version,
     the one PyTorch call for the same function where there is one (K3: a
     matmul), the empty kernel and its bound (ops/kernels.py::kernel_bound,
     published H100 SXM peaks): device time from torch.profiler, candidates
     in turns, and host-paced time from CUDA events; and the device time
     of the PyTorch ops that formed A + jitter * scale * I before K1 took
     the jitter inside.

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
from bayesfmmm_torch.convert import state_to_numpy
from bayesfmmm_torch.io import armaio
from bayesfmmm_torch.io.checkpoint import load_checkpoint
from bayesfmmm_torch.models.likelihood import log_likelihood
from bayesfmmm_torch.models.state import STATE_FIELDS, init_state
from bayesfmmm_torch.ops import gibbs, kernels
from bayesfmmm_torch.samplers import drivers
from bayesfmmm_torch.utils.init_strategies import spectral_ensemble
from bayesfmmm_torch.utils.kernel_bench import (card_line, device_launches,
                                                device_ms, in_turns,
                                                library_weighted_gram,
                                                main_path_inputs, paced_ms,
                                                spd)
from bayesfmmm_torch.utils.observability import ProgressStream
from bayesfmmm_torch.utils.simulate import simulate_functional

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


def k1_phase(dev, g):
    worst = 0.0
    for C, D in ((CHAINS, 96), (7, 96), (3, 13),
                 (2, kernels.chol_solve_max_dim()), (5, 129), (4, 16),
                 (2, 1)):
        for jitter in (0.0, 1e-6):
            e_mean, e_noise = k1_case(dev, g, C, D, jitter)
            print(f"  K1 chol_solve C={C} D={D} jitter={jitter} "
                  f"({kernels.chol_solve_plan(C, D)['kernel']} kernel): "
                  f"max|mean-plain|={e_mean:.3e} (tol {K1_TOL['mean']}), "
                  f"max|noise-plain|={e_noise:.3e} (tol {K1_TOL['noise']}), "
                  f"same bits twice")
            worst = max(worst, e_mean, e_noise)
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
                           (3, 13, 24, 6, 16)):
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
                    (5, 21, 8), (7, 130, 16), (3, 40, 20)):
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


def fit_launches(p):
    """Kernel launches the fit protocol's phase 3 must make: the production
    sweep's 1/7/1 at every plain iteration; an excursion in place of a sweep
    runs 2 N_t sweeps without the loglik probe (1/6/1), 2 N_t + 1 pz_unit
    probes of K2 and the iteration's loglik probe."""
    per = PATHS["production"][2]
    n, rungs = p["warm_iters"], 2 * p["N_t"]
    n_exc = len(range(p["n_temp_trans"], n, p["n_temp_trans"]))
    return n_exc, {
        "chol_solve": (n - n_exc + n_exc * rungs) * per["chol_solve"],
        "mean_rss": (n - n_exc) * per["mean_rss"]
        + n_exc * (rungs * (per["mean_rss"] - 1) + rungs + 1 + 1),
        "weighted_gram": (n - n_exc + n_exc * rungs) * per["weighted_gram"]}


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

    # api.fit calls the three phases by their module names: wrap each to
    # read the launch counts and the clock around it
    phases = {}

    def counted(name):
        fn = getattr(api, name)

        def wrapper(*a, **kw):
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            phases[name] = (res, time.perf_counter() - t0,
                            {k: kernels.LAUNCHES[k] - before[k]
                             for k in before})
            return res
        return fn, wrapper

    originals = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck, ck2 = os.path.join(tmp, "ensemble.npz"), os.path.join(tmp, "next")
        trace_dir = os.path.join(tmp, "traces")
        for name in ("fit_nu_z", "fit_theta", "fit_warm_start"):
            originals[name], wrapper = counted(name)
            setattr(api, name, wrapper)
        try:
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
        finally:
            for name, fn in originals.items():
                setattr(api, name, fn)
        (r1, s1, c1), (r2, s2, c2), (r3, s3, c3) = (
            phases[k] for k in ("fit_nu_z", "fit_theta", "fit_warm_start"))
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
    print(f"phase 8 timings on {card}: slice 1 "
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

    def entry(name, small, source, line, err):
        t = ms[name]
        return {"name": name, "route": "cuda",
                "source": f"bayesfmmm_torch/csrc/{source}",
                "replaces": f"bayesfmmm_tpu/ops/pallas_kernels.py:{line}",
                "launches": counts[name], "max_abs_err": err,
                "launches_by_path": {"slice": s_counts[name],
                                     "production": p_counts[name],
                                     **{f"fit {ph}": c[name]
                                        for ph, c in fit_counts.items()}},
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
                  122, k3_err)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
