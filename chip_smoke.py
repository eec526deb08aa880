#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bayesfmmm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card
    python3 chip_smoke.py --phases k2,advi    # the build and these only

Phases, one line each, any failure exits non-zero (``--phases`` names a
subset by the names in brackets; the build always runs, and the timings
only with every other phase, whose launch counts they read):

  1. [build] build the CUDA kernels from bayesfmmm_torch/csrc with nvcc;
  2. [k1] K1 chol_solve against its plain version (torch.linalg) at the main
     paths' shapes (D = 96; D = 256 at 16, 64 and 256 chains, the joint xi
     and hd Phi draws; D = 512 at 16 and 256 chains, the joint xi draw at
     two covariates; D = 60 and 72), at shapes that take each of its three
     kernels, odd D of the blocked one, its smallest and its largest, the
     panels kernel's smallest D, D neither a multiple of 4 nor of 32, an hd
     Phi draw on a 5 x 5 basis (64, 400) and its largest D up to 4,096, and
     at every D the register-tiled kernel serves with a ragged chain count;
     each without and with the jitter, the same bits from two calls, and the
     blocked kernel's first two chains also against its plain version (which
     repeats its panels) and the panels kernel's against its own
     (kernels.chol_solve_panels_plain, its order of work) on the card, the
     panels kernel's plan (panel width, cluster, update blocks an SM,
     launches) printed; and a D above 4,096, which must raise and launch
     nothing;
  3. [k2] K2 mean_rss against its plain version (einsum + sum) at the main
     paths' shapes (C and the MGP-scale moves' 2C chain rows; the hd
     family's P = 16, L = 144) and a padded one, with and without mu, the
     same bits from two calls;
  4. [k3] K3 weighted_gram against its plain version (einsum) at the main
     paths' shapes (update_nu's R = C K, update_eta's R = C D K, the
     sequential scan's R = C K M D, the hd family's P = 16), a ragged one
     and one with P > 16 (the chunked kernel), the same bits from two calls;
  5. [slice] slice 1's path: phase_warm_start in the reference kernel census at
     the headline width (K=3, P=8, M=4, N=100, 256 chains), 300 sweeps with the
     first 200 annealed from beta 0.1, held against the JAX package's result
     for the same protocol (tests/data/torch_slice_reference.json), with the
     kernels' launch counts read around that run;
  6. [production] slice 2's path, the bench's production census (collapsed
     Z/chi, gauge, MGP- and noise-scale interweaves, Phi MALA), same protocol,
     held against tests/data/torch_production_reference.json, launch counts
     read around it;
  7. [fit] slice 5's path, the three-phase fit pipeline through api.fit at the
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
  8. [families] slice 6's paths, the repo's own configurations 4, 3, 1 and 5
     (benchmarks/suite.py; data seed 7) at their full widths, each held
     against tests/data/torch_families_reference.json (JAX, several seeds):
     config 4 (functional, K=2, P=8, M=16, N=80, D=1, eta and xi) through
     api.fit with covariate_cov=True: restarts in phases 1 and 2, phase 3 at
     16 chains in the reference census, then from the same medians a
     256-chain ensemble in the production census with a tempered excursion,
     checkpointed, resumed, and held bit for bit against the unbroken run;
     config 4's model at two covariates (D=2, the joint xi draw at K*M*D*P =
     512 dimensions on K1's panels kernel) by the same protocol, without the
     resume, with the production ensemble's peak device memory;
     config 3 (K=3, M=3, N=100, D=2, eta; 8 chains) through
     phase_warm_start(covariate_mean=True); config 1 (multivariate, K=2,
     P=10, M=3, N=200; 4 chains) and config 5 (hd, K=4, P=16, M=4, 64
     surfaces on a 12 x 12 grid; 64 chains) through api.fit; the launch
     counts of every phase as the code predicts them (config 4: K1 twice a
     phase-3 sweep, both at a shape the blocked kernel serves, and at D=2
     Phi's on the blocked kernel and xi's on the panels kernel; config 1: no
     K2, no K3), counted shape by shape; and the fit smoke's phase 3
     once more from the JAX package's own phase-1/2 medians, inside the
     tight limits of tests/data/torch_fit_reference.json;
  9. [refapi] slice 9's path, the reference-named API
     (bayesfmmm_torch.reference_api) on the card, no device given:
     BFMMM_Nu_Z_multiple_try, BFMMM_Theta_est in the reference-literal form and
     BFMMM_warm_start (with excursions, exporting its traces) at the headline
     width from the raw Y / time lists of bench.py's data, the launch counts of
     each phase and the R lists' layouts; then every post-processing name on
     the directory it wrote (FMeanCI, FCovCI, ZCI, SigmaCI, FDIC, FAIC, FBIC,
     FLLik against the warm start's own loglik trace, FSamplePaths' band
     coverage, the six Read*, and ConditionalPredictiveOrdinates on the card,
     timed on the host's clock and the device's); CPO on the card, DIC, AIC,
     BIC and the loglik trace held against the JAX package's on traces rebuilt
     from tests/data/torch_post_reference.json's seeds (the headline widths and
     config 4's, eta and xi); and the multivariate and hd mirrors at configs 1
     and 5's widths, 100 sweeps a phase, with MVMeanCI, MVCovCI, MVDIC, MVAIC,
     MVBIC, MVLLik, HDFMeanCI and HDFCovCI;
 10. [tempering] slice 10's paths, parallel tempering and SMC at the headline
     width (no device given, so on the card): api.fit_pt from the JAX package's
     own phase-1/2 medians (tests/data/torch_fit_reference.json) with the auto
     ladder (a pilot of 50 sweeps of one chain, up to 64 replicas, 400 rounds),
     then 100 rounds on a geometric ladder of 8; api.fit_smc from the prior
     with 256 particles; the ladder, the swap rate, the cold chain's median
     loglik, SMC's stage count, log-evidence and weighted sigma2 against
     tests/data/torch_tempering_reference.json (JAX, five seeds each), the
     launch counts as the code predicts them, shape by shape (K1 at 1 and R
     replicas, K2 at 1, 2, R, 2R, 256, 512 rows and the cold chain's
     log-likelihood over the rounds, K3 at 3 and 3R), and ms, kernels and
     device-busy ms a PT round and an SMC stage;
 11. [hmc] slice 11's path, the gradient samplers at the headline width
     (no device given, so on the card): K2's backward (mean_rss_grad)
     against its plain version, against autograd through K2's plain
     forward and against its twin on the CPU (the kernel's order of sums),
     the same bits from two calls and through MeanRSS, at 64, 4 and one
     chain (N = L = 100, P = 8), config 5's P = 16, L = 144 and a general
     P = 10; the
     log-joint's value and gradient on the card against the CPU at one
     point of 64 chains, one evaluation launching K2 forward and backward
     once each and no plain version; api.fit_hmc with 64 chains from the
     spectral init, method "hmc" (100 + 100 iterations of up to 16 steps)
     and "nuts" (80 + 80 to depth 4), the best chain's mean loglik over
     its last 100 draws, its median sigma2, the pooled accept_mean and the
     median eps against tests/data/torch_hmc_reference.json (JAX, twelve
     seeds), K2 forward and backward launched once a gradient evaluation as
     the run's own trajectory lengths predict (K1 and K3 never); ms a
     gradient evaluation and an iteration, kernels and device-busy ms a
     leapfrog step, mean_rss_grad's time beside its bound, its plain
     version and the empty kernel at 64, 4 and one chain (P = 8), config
     5's P = 16 and P = 10;
 12. [advi] slice 12's paths at the headline width (no device given, so on
     the card): K2 and its backward at ADVI's 4 rows against their plain
     versions; api.fit_advi_init (600 ADVI steps of 4 draws, then 4 chains
     of the reference census for 300 sweeps, cut from 2,000), its mean
     ELBO of the last 50 steps, the ELBO's rise from the first 50, the best
     chain's mean loglik over its last 100 draws and median sigma2 against
     tests/data/torch_advi_reference.json (JAX, five seeds), its launches
     (K2 forward and backward once an ADVI step, then the census's 1/2/1 a
     sweep); the production sweep with every default-off kernel on
     (z_anchor, phi_chi_moves=2, hmc_steps=2 with bench.py's hmc_eps and an
     inverse mass from the ensemble's variance, 64 chains, 100 sweeps
     after 100 of the production census from the JAX package's
     phase-1/2 medians), its ensemble medians against the same file, its
     launches (K1 1, K2 11, K2's backward 3, K3 1 a sweep), and
     update_hmc_joint's log-joint at its ensemble on the card against the
     CPU; ms, kernels and device-busy ms an ADVI step and a default-off
     sweep, K2 and its backward at 4 rows beside their bounds;
 13. [mesh] slices 16 to 18's paths, parallel/mesh.py's chains and data
     axes at the headline width, from the production path's final
     256-chain ensemble (that path runs first when it was not asked for):
     20 production sweeps, a checkpoint, one sweep more and 10 PT rounds of
     64 replicas, (a) in one process under a 1 x 1 mesh over NCCL, which
     must give the bits and launch counts of the same run without it, and
     in two ranks sharing the one card through gloo
     (bayesfmmm_torch.dryrun.run_ranks), (b) on a (2, 1) mesh, 128 chains
     and 32 replicas each, then (c) on a (1, 2) mesh, the data's 100 rows
     split 50 and 50 with all 256 chains and 64 replicas on each rank:
     after the first sweep at least 99 % of the chains within the JAX
     tests' atol of one process's in every field (the others printed), the
     medians after the 20 inside the production path's JAX limits, each
     rank's launches as the sweep predicts them (K1, K2 and K3 20, 140 and
     20), and the ranks' checkpoint holding their gathered ensemble, read
     back here and resumed for a sweep that holds 99 % of the chains within
     that atol of the ranks' own; (b) also PT's swap counts equal to one
     process's, (c) the global fields of both ranks the same bits and K2
     and K3 against their plain versions at the rank's shapes (N = 50);
     it prints the share of chains still bit-equal, ms a sweep at one rank
     and at two ranks sharing the card, and the collectives a sweep and
     their ms.  Then slice 18's samplers over the same three meshes, at
     the headline width: SMC (256 particles from the prior, 3 stages),
     HMC (up to 16 steps) and NUTS (to depth 4) of 64 chains for 4 + 4
     iterations, ADVI (50 steps of 4 draws) and 5 production sweeps of 64
     chains with the whole-model HMC step (hmc_steps=2), all but SMC from
     that ensemble: under the 1 x 1 mesh the bits, generator states and
     launches of one process; in each split after the first transition
     99 % of the chains within the atol of one process's, relative where a
     value passes 1 (ADVI's whole position; SMC, whose first stage mutates
     the prior's draws, where a last-bit change moves a value by ~1e-3 of
     itself, no fewer chains than one process keeps from particles one
     ulp away, and its first stage's beta and weights within the atol),
     every rank's generator in one process's state and its launches one
     process's, SMC's stage count and HMC's trajectory
     lengths equal, with the rows split both ranks' global fields and
     slots the same bits, and the HMC-step sweep's medians inside the
     production path's limits (the other runs are too short for the JAX
     limits of phases 10-12, and say so); K2's backward at a rank's rows
     (64 and 4 chain rows, N = 50) against its plain version and timed,
     and ms a step of each sampler in one process and at two ranks
     sharing the card, with the collectives a step and their ms;
 14. [timings] chain-sweeps/s of both paths, and each kernel at the main
     path's shapes (K2 at C and at 2C chain rows, and the restart phases'
     7 and 8 chains) beside its plain version,
     the one PyTorch call for the same function where there is one (K1: the
     three torch.linalg calls; K3: a matmul), the empty kernel and its bound
     (ops/kernels.py::kernel_bound,
     published H100 SXM peaks): device time from torch.profiler, candidates
     in turns, and host-paced time from CUDA events; and the device time
     of the PyTorch ops that formed A + jitter * scale * I before K1 took
     the jitter inside; the blocked K1 kernel at (16, 64, 256) x 256 beside
     the three torch.linalg calls, K2 and K3 at slice 6's shapes, each
     kernel at PT's shapes (K1 at R and one chain, K2 at R and 2R, K3 at
     3R), K2 and K3 at the data split's shapes (N = 50: K2 at C and 2C,
     K3 at 3C), K1's panels kernel at (16, 512) and (256, 512) of the two-covariate
     path and at (64, 400), (4, 1024) and (1, 4096) beside the three
     torch.linalg calls, each split by launch (first diagonal block, panel
     products, trailing updates, back substitutions; kernel_bench's
     panels_parts), and ms, kernels and device-busy ms a sweep of
     configs 4 (16 and 256 chains), 4 at two covariates (16 and 256), 3, 1
     and 5.

Launch counts are those ops/kernels.py counts where a kernel is launched:
a sweep run eagerly, or a sweep captured in a CUDA graph.  A run of the
reference census replays its captured sweep (samplers/drivers.py), whose
launches come from the graph and are not counted; such a run is predicted
one sweep's launches for each sweep run eagerly or captured, and its
captures, replays and eager sweeps (``drivers.SWEEP_GRAPHS``) are printed
beside it and kept under "sweep_graphs" in the line of kernel numbers.

It then prints the card's name and power limit, one JSON line of kernel
numbers, and as its last line {"ok": true, "device": {...}}.  Where the
production sweep's time goes, updater by updater, is measured apart:
python3 portbench/run.py --workload <cell> --seed <n> --seconds 51
--trace 1, and the program's spans that utils/observability.py's
trace_profile writes beside the profiler's events.
"""

import json
import os
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from bayesfmmm_torch import ModelConfig, Priors, api, diagnostics
from bayesfmmm_torch import reference_api as R
from bayesfmmm_torch.convert import (fit_result_from_estimates,
                                     state_to_numpy)
from bayesfmmm_torch.io import armaio
from bayesfmmm_torch.io.checkpoint import (load_checkpoint,
                                          save_checkpoint)
from bayesfmmm_torch.models.likelihood import log_likelihood
from bayesfmmm_torch.models.state import (STATE_FIELDS, init_state,
                                          make_hd_functional_data,
                                          take_chains)
from bayesfmmm_torch.ops import gibbs, kernels
from bayesfmmm_torch.parallel import tempering
from bayesfmmm_torch.post import model_selection
from bayesfmmm_torch.samplers import drivers, smc
from bayesfmmm_torch.utils.init_strategies import spectral_ensemble
from bayesfmmm_torch.utils.kernel_bench import (_PAD_KERNEL, _PAD_LAUNCHES,
                                                GRAD_SHAPES, card_line,
                                                device_launches,
                                                device_ms, device_ms_by_kernel,
                                                in_turns,
                                                library_chol_solve,
                                                library_weighted_gram,
                                                main_path_inputs, paced_ms,
                                                panels_parts, spd)
from bayesfmmm_torch.utils.observability import ProgressStream
from bayesfmmm_torch.utils.simulate import (_numpy_mu, _truth_state,
                                            functional_lists, simulate_draws,
                                            simulate_functional,
                                            simulate_multivariate)

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"

# The protocol both paths run; must equal the one the JAX references were
# made with.
PROTOCOL = dict(seed=7, N=100, K=3, P=8, M=4, n_time=[100, 100],
                sweeps=300, anneal=200, beta0=0.1, z_jitter=0.02)
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
    # config 4's model at config 3's two covariates: the joint xi draw at
    # K*M*D*P = 512, on K1's panels kernel
    "config4_D2": dict(
        name="CovAdjCov_xi_fullM_D2", family="functional", seed=7, N=80, K=2,
        P=8, M=16, D=2, n_time=[100, 100], with_eta=True, with_xi=True,
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
    ("production", "mv"): (1, 0, 0), ("reference", "mv"): (1, 0, 0),
    # config 5: the hd family launches what the functional one does
    ("nu_z", "hd"): (0, 2, 1), ("theta", "hd"): (1, 2, 0),
    ("production", "hd"): (1, 7, 1), ("reference", "hd"): (1, 2, 1),
}
KERNEL_NAMES = ("chol_solve", "mean_rss", "weighted_gram")

# Slice 10: parallel tempering and SMC at the headline width, from the data
# of FIT_PROTOCOL; each must equal the protocol its JAX reference was made
# with (tests/data/make_torch_tempering_reference.py).  PT starts from the
# JAX package's phase-1/2 medians (FIT_REFERENCE's warm_start_from).
TEMPERING_REFERENCE = DATA / "torch_tempering_reference.json"
PT_PROTOCOL = dict(kernels="production", ladder="auto", beta_min=0.3,
                   max_replicas=64, pilot_sweeps=50, tot_mcmc_iters=400)
SMC_PROTOCOL = dict(n_particles=256, n_mutation_sweeps=2,
                    kernels="production")
# the short run on a fixed ladder: finiteness and launch counts only
PT_GEOMETRIC = dict(kernels="production", ladder="geometric", n_replicas=8,
                    beta_min=0.3, tot_mcmc_iters=100)

# Slice 11: the log-joint and api.fit_hmc at the headline width
# (bench.py:115-117), 64 chains from the spectral init; the protocol must
# equal the one its JAX reference was made with
# (tests/data/make_torch_hmc_reference.py).
HMC_REFERENCE = DATA / "torch_hmc_reference.json"
HMC_PROTOCOL = dict(
    data=dict(seed=7, N=100, K=3, P=8, M=4, n_time=[100, 100]),
    fit=dict(K=3, M=4, n_chains=64, init="spectral"),
    hmc=dict(method="hmc", n_warmup=100, n_samples=100, n_leapfrog=16),
    nuts=dict(method="nuts", n_warmup=80, n_samples=80, max_depth=4))
HMC_STATS = ("loglik_tail_mean", "sigma2_median", "accept_mean",
             "eps_median")
# K2's backward (C, N, L, P): the HMC path's 64 chains and one chain at the
# headline width, config 5's P = 16, L = 144 (N = 64), ADVI's n_mc = 4
# rows (the default-off sweep's update_hmc_joint runs at the 64 chains),
# and a general P (copied 4 bytes at a time into padded rows)
K2_GRAD_SHAPES = ((64, 100, 100, 8), (1, 100, 100, 8), (64, 64, 144, 16),
                  (1, 64, 144, 16), (4, 100, 100, 8), (64, 100, 100, 10))
# max |kernel - reference| over max |reference|: float32 sums of L
# products of order 1-10 each, taken in another order
K2_GRAD_TOL = 2e-5
# the log-joint on the card against the CPU: tests/test_torch_hmc.py's
# float32 tolerances (value relative; gradient relative norm per chain)
LOGJOINT_TOL = {"value": 1e-4, "grad": 1e-3}
# Slice 12: api.fit_advi_init, and the production sweep with every
# default-off kernel on (tests/data/make_torch_advi_reference.py has the
# reasons); each protocol must equal the one its JAX reference was made with
ADVI_REFERENCE = DATA / "torch_advi_reference.json"
ADVI_DATA = dict(seed=7, N=100, K=3, P=8, M=4, n_time=[100, 100])
ADVI_PROTOCOL = dict(
    data=ADVI_DATA,
    # warm_iters cut from the function's 2,000
    fit=dict(K=3, M=4, advi_steps=600, advi_lr=0.03, n_chains=4,
             warm_iters=300))
DEFAULT_OFF_PROTOCOL = dict(
    data=ADVI_DATA, start="torch_fit_reference.json warm_start_from",
    chains=64, warm_sweeps=100, sweeps=100,
    flags=dict(collapsed_z=True, gauge=True, p_indep=0.3, phi_mala_steps=4,
               phi_mala_step=0.05, z_anchor=True, phi_chi_moves=2,
               hmc_steps=2, hmc_eps=0.003))
ADVI_STATS = ("elbo_tail_mean", "elbo_rise", "loglik_tail_mean",
              "sigma2_median")
SWEEP_STATS = ("loglik_median", "sigma2_median")
# Slice 16: the production census over a (chains, data) mesh, from the
# production path's final ensemble: one process under a 1 x 1 NCCL mesh,
# then two ranks sharing the one card through gloo
MESH_PROTOCOL = dict(ranks=2, sweeps=20, seed=16, pt_replicas=64,
                     pt_rounds=10, pt_beta_min=0.3, pt_seed=17, timeout=300)
# slice 17: the two ranks split the chains, a (2, 1) mesh of 128 chains a
# rank, and then the data, a (1, 2) mesh of the 256 chains and 50 rows a
# rank; the split's name -> data shards
MESH_SPLITS = {"chains": 1, "data": 2}
# the fields no rank holds by rows of the data
MESH_GLOBAL = tuple(f for f in STATE_FIELDS if f not in ("Z", "chi"))
# a split sweep against one process's (tests/test_checkpoint_parallel.py:79),
# held chain by chain: on the card the two ranks' 128-chain products take
# other cuBLAS and cuSOLVER kernels than one process's 256-chain ones, and a
# last-bit difference can turn an accept/reject in a chain (one chain of 256
# after one production sweep, in its Phi and chi, on an H100 80GB HBM3 at
# 700 W); the share of chains within the atol must reach MESH_SHARE
MESH_ATOL = 2e-4
MESH_SHARE = 0.99
# slice 18: SMC, HMC, NUTS, ADVI and the sweep's whole-model HMC step
# (update_hmc_joint) over the same meshes at the headline width: SMC from
# the prior (3 stages of max_stages' 200), HMC (up to 16 steps) and NUTS (to
# depth 4) of fit_hmc's 64 chains for 4 + 4 iterations, ADVI 50 steps of 4
# draws, and 5 production sweeps with the HMC step of 64 chains, all but
# SMC from the production path's final ensemble.  HMC and NUTS start at a
# step size of 1e-4: from that ensemble at run_hmc's default 0.01 no
# trajectory of the 8 iterations is accepted (a CPU run of this protocol),
# and a first transition that moves no chain compares nothing
MESH_SAMPLERS = dict(seed=18, smc_particles=256, smc_stages=3,
                     hmc_chains=64, hmc_warmup=4, hmc_samples=4,
                     hmc_steps=16, hmc_init_step=1e-4, nuts_depth=4,
                     advi_steps=50, advi_mc=4,
                     advi_lr=0.03, sweeps=5,
                     sweep_flags=dict(hmc_steps=2, hmc_eps=0.003))
# their first transitions are held to MESH_ATOL times the value's magnitude
# where it passes 1, and SMC's to no fewer chains than one process keeps
# from particles one float32 ulp away: its first stage mutates the prior's
# draws (sigma2 to ~500, nu to ~100, at beta ~1e-4), where a last-bit change
# moves a value by ~1e-3 of itself (one ulp: 29 of 256 chains past, nu
# 0.005 and sigma2 0.008; the split: 6 of 256, nu 0.006; an H100 80GB HBM3
# at 700 W)
# each sampler's count of steps, by the unit its ms are given in
MESH_SAMPLER_UNITS = {"smc": ("stage", "smc_stages"),
                      "hmc": ("iteration", None), "nuts": ("iteration", None),
                      "advi": ("step", "advi_steps"),
                      "hmc_sweep": ("sweep", "sweeps")}
# K2's backward at a rank's rows of the data split (N / 2): HMC's, NUTS's
# and the sweep's 64 chains, ADVI's 4 draws
MESH_GRAD_SHAPES = ((64, 50, 100, 8), (4, 50, 100, 8))
# the phases, in the order they run; all by default
PHASES = ("build", "k1", "k2", "k3", "slice", "production", "fit",
          "families", "refapi", "tempering", "hmc", "advi", "mesh",
          "timings")

K1_TOL = {"mean": 5e-5, "noise": 5e-4}      # tests/test_linalg.py:118-121
# K1's panels kernel on the path: config 4's model at two covariates, the
# joint xi draw at 512 dimensions at its reference and production chains
K1_PANELS_PATH = ((16, 512), (CHAINS, 512))
# calls a round when the panels kernel is timed: its call and torch.linalg's
# start dozens to thousands of kernels, whose traces the profiler reads
# slowly (the five shapes took 115 s at 50 calls a round)
K1_PANELS_REPS = 10
K2_TOL = {"rss_rtol": 1e-5, "mu": 2e-5}     # tests/test_pallas_kernels.py
# tests/test_pallas_kernels.py:46-47, the absolute part scaled by N/21
K3_TOL = {"rtol": 2e-5, "atol_per_21": 2e-5}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def k1_case(dev, g, C, D, jitter):
    """One shape and jitter: the kernel twice against the plain version,
    and the blocked and panels kernels' first two chains against their own
    order of work (``chol_solve_blocked_plain``,
    ``chol_solve_panels_plain``); returns (max |mean - plain|, max |noise -
    plain|)."""
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
    kernel = kernels.chol_solve_plan(C, D)["kernel"]
    if kernel in ("blocked", "panels"):
        twin = (kernels.chol_solve_blocked_plain if kernel == "blocked"
                else kernels.chol_solve_panels_plain)
        mean_b, noise_b = twin(A[:2], b[:2], z[:2], jitter)
        e_b = ((mean[:2] - mean_b).abs().max().item(),
               (noise[:2] - noise_b).abs().max().item())
        check(e_b[0] <= K1_TOL["mean"] and e_b[1] <= K1_TOL["noise"],
              f"K1's {kernel} kernel disagrees with its plain twin "
              f"{twin.__name__} at C={C} D={D} jitter={jitter}: mean "
              f"{e_b[0]:.3e}, noise {e_b[1]:.3e}")
        e_mean, e_noise = max(e_mean, e_b[0]), max(e_noise, e_b[1])
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
                 # 5 at their chain counts, config 1's and config 3's D, odd
                 # D of the blocked kernel, its smallest and its largest
                 (16, 256), (64, 256), (CHAINS, 256), (4, 60), (8, 72),
                 (3, 251), (2, 241), (3, 130), (2, 200), (3, 333),
                 (2, 334), (2, top),
                 # slice 10: PT's pilot (one chain), the geometric ladder's
                 # 8 replicas and the auto ladder's most (max_replicas)
                 (1, 96), (8, 96), (PT_PROTOCOL["max_replicas"], 96),
                 # slice 14, the panels kernel: the joint xi draw at two
                 # covariates at config 4's 16 and 256 chains, an hd Phi
                 # draw on a 5 x 5 basis (K = M = 4) at 64, the smallest D,
                 # D neither a multiple of 4 nor of 32, and the largest
                 *K1_PANELS_PATH, (64, 400), (2, top + 1), (3, 401),
                 (2, 1000), (4, 1024), (2, 2048), (1, kernels.K1_MAX_DIM)):
        for jitter in (0.0, 1e-6):
            e_mean, e_noise = k1_case(dev, g, C, D, jitter)
            plan = kernels.chol_solve_plan(C, D)
            kernel = plan["kernel"]
            check(kernel == ("tiled" if D <= 128 else "blocked" if D <= 336
                             else "panels"),
                  f"K1 C={C} D={D} is served by the {kernel} kernel")
            how = (f"panels kernel: panels of {plan['panel']}, cluster "
                   f"{plan['cluster']}, update {plan['update_blocks']} "
                   f"block(s) an SM, {plan['launches']} launches"
                   if kernel == "panels" else f"{kernel} kernel")
            print(f"  K1 chol_solve C={C} D={D} jitter={jitter} ({how}): "
                  f"max|mean-plain|={e_mean:.3e} (tol {K1_TOL['mean']}), "
                  f"max|noise-plain|={e_noise:.3e} (tol {K1_TOL['noise']}), "
                  f"same bits twice"
                  + (", its plain twin on the first two chains too"
                     if kernel != "tiled" else ""))
            worst = max(worst, e_mean, e_noise)
    # a D above the joint draws' ceiling raises: nothing gives way to
    # torch.linalg
    over = kernels.K1_MAX_DIM + 1
    before = kernels.LAUNCHES["chol_solve"]
    try:
        kernels.chol_solve(*spd(g, 1, over, dev), 1e-6)
    except NotImplementedError as e:
        print(f"  K1 chol_solve D={over} raises: {e}")
    else:
        check(False, f"K1 D={over}, which no kernel serves, did not raise")
    check(kernels.LAUNCHES["chol_solve"] == before,
          f"K1 D={over} launched a kernel")
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


# K2's shapes: (C, N, L, P, padded from)
K2_SHAPES = (
    (CHAINS, 100, 100, 8, None), (2 * CHAINS, 100, 100, 8, None),
    (8, 100, 100, 8, None), (7, 100, 100, 8, None), (3, 13, 24, 6, 16),
    # slice 6: config 5 (hd, P=16, L=144) at its 64 chains, 128 chain rows
    # and 4 restart chains; config 4 (N=80) at 256, 512 and 16
    (64, 64, 144, 16, None), (128, 64, 144, 16, None),
    (4, 64, 144, 16, None), (CHAINS, 80, 100, 8, None),
    (2 * CHAINS, 80, 100, 8, None), (16, 80, 100, 8, None),
    # slice 10: PT's pilot (1 and 2 rows), 8 and 64 replicas and their 2R
    # rows, and the cold chain's log-likelihood over the rounds
    (1, 100, 100, 8, None), (2, 100, 100, 8, None), (16, 100, 100, 8, None),
    (64, 100, 100, 8, None), (128, 100, 100, 8, None),
    (PT_PROTOCOL["tot_mcmc_iters"], 100, 100, 8, None))


def k2_phase(dev, g, shapes=K2_SHAPES):
    worst = 0.0
    for C, N, L, P, pad in shapes:
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


# K3's shapes: (R, N, P)
K3_SHAPES = (
    (CHAINS * PROTOCOL["K"], PROTOCOL["N"], PROTOCOL["P"]),
    (8 * PROTOCOL["K"], PROTOCOL["N"], PROTOCOL["P"]),
    (5, 21, 8), (7, 130, 16), (3, 40, 20),
    # slice 6: update_eta's R = C D K of config 3 (8 chains) and config 4
    # (256, 16), the sequential scan's R = C K M D of config 4, config 5's
    # P = 16 at 64 and 4 chains
    (8 * 2 * 3, 100, 8), (CHAINS * 2, 80, 8), (16 * 2, 80, 8),
    (16 * 2 * 16, 80, 8), (64 * 4, 64, 16), (4 * 4, 64, 16),
    # slice 10: update_nu's R = 3 C of PT's pilot and of 64 replicas (8
    # replicas: 24 above)
    (PROTOCOL["K"], 100, 8), (64 * PROTOCOL["K"], 100, 8))


def k3_phase(dev, g, shapes=K3_SHAPES):
    worst = 0.0
    for R, N, P in shapes:
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
    counts, final ensemble)."""
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
    events = graph_events()
    t0 = time.perf_counter()
    res = drivers.phase_warm_start(g, st, data, hp, c, n_iters=p["sweeps"],
                                   betas=betas, **flags)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = counters()
    counted = counted_sweeps(name, graph_events(events), p["sweeps"])

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
        check(counts[k] == n * counted,
              f"{name}: {k} launched {counts[k]} times in {counted} "
              f"counted sweeps, expected {n} per sweep")
    for stat, med in (("loglik", med_ll), ("sigma2", med_s2)):
        lo, hi = ref[stat]["limits"]
        print(f"  {name} {stat}: port median {med:.6g}, JAX median "
              f"{ref[stat]['median']:.6g}, limits [{lo:.6g}, {hi:.6g}] "
              f"({ref['limit_rule']})")
        check(lo <= med <= hi,
              f"{name}: {stat} median {med} outside [{lo}, {hi}]")
    return seconds, counts, res.final_state


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
    """The launch counts of K1, K2 and K3 that ops/kernels.py keeps, as a
    dict of its own; the Gibbs paths that read them launch no backward
    kernel."""
    check(kernels.LAUNCHES["mean_rss_grad"] == 0,
          "a Gibbs path launched K2's backward")
    return {k: kernels.LAUNCHES[k] for k in KERNEL_NAMES}


class ShapeProbe:
    """While active, every launch the kernel wrappers make is also counted
    by its shape: ``counts[(kernel, shape)]`` rises by what
    ``kernels.LAUNCHES[kernel]`` rose by in the call, the shape being K1's
    (C, D), K2's and its backward's (C, N, L, P) or K3's (R, N, P).  The
    sampler reaches the wrappers through the module's attributes, so they
    are wrapped there."""

    SHAPES = {
        "chol_solve": lambda A, b, z, *a, **kw: tuple(b.shape),
        "mean_rss": lambda B, y, w, *a, **kw: (w.shape[0], *B.shape),
        "weighted_gram": lambda W, G: (*W.shape, G.shape[-1]),
        "mean_rss_grad": lambda B, y, w, g: (w.shape[0], *B.shape)}

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
        and there was one; ``kernel`` a name, or {D: name}, every D of
        which was launched and no other."""
        shapes = [shape for (name, shape), n in self.counts.items()
                  if name == "chol_solve" and n]
        want = kernel if isinstance(kernel, dict) else None
        check(shapes and all(
            kernels.chol_solve_plan(*shape)["kernel"]
            == (want.get(shape[1]) if want else kernel) for shape in shapes)
            and (want is None or {D for _, D in shapes} == set(want)),
            f"{what}: K1 launched at {shapes}, not at the shapes of "
            f"{kernel}")
        print(f"  {what}: every K1 launch at a shape of the {kernel} "
              f"kernel{'s' if want else ''}: {shapes}")


# the captured sweep's events (drivers.SWEEP_GRAPHS) of each run that
# counted_sweeps saw, by the run's name
SWEEP_GRAPH_RUNS = {}


def graph_events(before=None):
    """What drivers.SWEEP_GRAPHS counts, as a dict of its own; with
    ``before`` (such a dict), what it rose by since."""
    now = dict(drivers.SWEEP_GRAPHS)
    return now if before is None else {k: now[k] - before[k] for k in now}


def counted_sweeps(what, events, n):
    """Of ``n`` sweeps that a run made with the captured sweep's ``events``
    (graph_events' rise over the run), the number whose launches
    ``kernels.LAUNCHES`` counted: each sweep run eagerly, and one for each
    capture, which counted one sweep with its loglik probe.  A replayed
    sweep launches its kernels from the graph and is not counted.  Checks
    that every sweep ran, eagerly or as a replay, and keeps the events
    under ``what`` for the line."""
    check(events["eager"] + events["replays"] == n,
          f"{what}: {events} for {n} sweeps")
    SWEEP_GRAPH_RUNS[what] = events
    print(f"  {what}: {events['eager']} sweeps eager, {events['captures']} "
          f"captured, {events['replays']} replayed")
    return events["eager"] + events["captures"]


class PhaseProbe:
    """While active, api.fit_nu_z, api.fit_theta and api.fit_warm_start (the
    names api.fit calls its phases by) record for each call (result,
    seconds ending in a synchronise, what every counter rose by) in
    ``calls``, and what the captured sweep's events rose by in
    ``graphs``."""

    NAMES = ("fit_nu_z", "fit_theta", "fit_warm_start")

    def __init__(self):
        self.calls, self.graphs = [], []

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
            before, events = counters(), graph_events()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            self.calls.append((name, res, seconds, {
                k: v - before[k] for k, v in counters().items()}))
            self.graphs.append(graph_events(events))
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
            counts = counters()
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


def config4_phase(dev, card, name="config4"):
    """Config 4 through api.fit with covariate_cov=True, or its model at two
    covariates (``name`` "config4_D2", whose joint xi draw of 512
    dimensions takes K1's panels kernel; no resume, which config 4 shows);
    returns the counters of the whole path, the launches by shape, the ms a
    sweep of its two ensembles and the production ensemble's peak device
    memory in bytes."""
    ref, rule = family_reference(name)
    p = FAMILY_PROTOCOLS[name]
    pr, pp = p["reference"], p["production"]
    data, cfg = family_data(dev, name)
    what = "config 4" if name == "config4" else "config 4 at D = 2"
    D_xi = p["K"] * p["M"] * p["D"] * p["P"]
    # K1's kernel at each joint draw: Phi's 256 dimensions and xi's
    want_k1 = {256: "blocked", D_xi: "blocked" if p["D"] == 1 else "panels"}
    check(data.D == p["D"] and p["K"] * p["M"] * p["P"] == 256
          and D_xi == 256 * p["D"],
          f"{what} does not draw Phi at 256 dimensions and xi at {D_xi}")
    resume = name == "config4"
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
        check(ra.config == cfg, f"{what}: fitted {ra.config}")
        # from the same medians, 256 chains of the production census with a
        # tempered excursion, checkpointed
        warm = dict(kernels=pp["kernels"], n_temp_trans=pp["n_temp_trans"],
                    N_t=pp["N_t"], beta_N_t=pp["beta_N_t"], progress=False)
        C, n = pp["port_chains"], pp["warm_iters"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rb = api.fit_warm_start(r1, r2, tot_mcmc_iters=n, n_chains=C,
                                seed=seed + 2, checkpoint_to=ck, **warm)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts, by_shape = counters(), dict(shapes.counts)
        if resume:
            # the resume continues the unbroken run bit for bit
            rc = api.fit_warm_start(resume_from=ck, data=data,
                                    tot_mcmc_iters=RESUME_SWEEPS, **warm)
            whole = api.fit_warm_start(
                r1, r2, tot_mcmc_iters=n + RESUME_SWEEPS, n_chains=C,
                seed=seed + 2, **warm)
    (_, _, s1, c1), (_, _, s2, c2), (_, _, sa, ca), (_, _, sb, cb) = \
        probe.calls[:4]
    n1, n2, na = p["nu_z_iters"], p["theta_iters"], pr["warm_iters"]
    ka = counted_sweeps(f"{what} phase 3, reference census", probe.graphs[2],
                        na)
    finite_result(f"{what} reference", ra, pr["port_chains"], na)
    finite_result(f"{what} production", rb, C, n)
    check_counts(f"{what} phase 1", c1,
                 {k: v * n1 for k, v in per_sweep("nu_z", "eta").items()})
    check_counts(f"{what} phase 2", c2,
                 {k: v * n2 for k, v in per_sweep("theta", "xi").items()})
    check_counts(f"{what} phase 3, {pr['port_chains']} chains, reference "
                 f"census", ca,
                 phase3_launches(per_sweep("reference", "xi"), ka)[1])
    n_exc, want = phase3_launches(per_sweep("production", "xi"), n,
                                  pp["n_temp_trans"], pp["N_t"])
    check_counts(f"{what} phase 3, {C} chains, production census, "
                 f"{n_exc} excursion", cb, want)
    shapes.check_k1(what, want_k1)
    # a phase-3 sweep draws Phi and xi once each, both at 256 at D = 1
    draws = {D: [256, D_xi].count(D) for D in want_k1}
    for D, k in draws.items():
        check(by_shape[("chol_solve", (pr["port_chains"], D))] == k * ka
              and by_shape[("chol_solve", (C, D))]
              == k * want["chol_solve"] // 2,
              f"{what}: K1 did not launch {k} times a phase-3 sweep at "
              f"D = {D}")
    # update_eta's K3 at R = C D K once a phase-3 sweep of either ensemble
    # (at D = 1 update_nu's R = C K is the same shape)
    for R, times in ((pr["port_chains"] * p["D"] * p["K"], ka),
                     (C * p["D"] * p["K"], want["weighted_gram"] // 2)):
        got = by_shape.get(("weighted_gram", (R, p["N"], p["P"])))
        check(got == times * (2 if p["D"] == 1 else 1),
              f"{what}: K3 at R = {R} (update_eta) launched {got} times")
    check(rb.tt_accept.shape == (C, n_exc) and n_exc == 1,
          f"{what}: {rb.tt_accept.shape} excursion decisions")
    if resume:
        _, _, _, cc = probe.calls[4]
        check(rc.config == ra.config and rc.config.covariate_cov,
              f"{what}: resumed as {rc.config}")
        check_counts(
            f"{what} resume", cc,
            phase3_launches(per_sweep("production", "xi"), RESUME_SWEEPS,
                            pp["n_temp_trans"], pp["N_t"], start=n)[1])
        check(np.array_equal(whole.all_chain_loglik[:, :n],
                             rb.all_chain_loglik)
              and np.array_equal(whole.all_chain_loglik[:, n:],
                                 rc.all_chain_loglik),
              f"{what}: {n} + {RESUME_SWEEPS} sweeps through the checkpoint "
              f"are not the unbroken run's loglik traces")
        for f in STATE_FIELDS:
            check(torch.equal(getattr(whole.ensemble_state, f),
                              getattr(rc.ensemble_state, f)),
                  f"{what} split run: final ensemble differs in {f}")
        print(f"  {what}: {n} + {RESUME_SWEEPS} sweeps through the "
              f"checkpoint gave the bits of one {n + RESUME_SWEEPS}-sweep "
              f"run")
    print(f"  {what}: excursion accepted by {int(rb.tt_accept.sum())} of "
          f"{C} chains; peak device memory of the production ensemble "
          f"{peak} bytes")
    gate(f"{what} reference ({pr['port_chains']} chains)", ref["reference"],
         rule,
         ra.all_chain_loglik[:, -1], ra.ensemble_state.sigma2.cpu())
    gate(f"{what} production ({C} chains)", ref["production"], rule,
         rb.all_chain_loglik[:, -1], rb.ensemble_state.sigma2.cpu())
    print(f"  {what} on {card}: phase 1 {s1 / n1 * 1e3:.3f} ms per sweep of "
          f"{p['n_try'] + 1} chains, phase 2 {s2 / n2 * 1e3:.3f} ms per sweep "
          f"of {p['n_try']} chains, phase 3 reference "
          f"{sa / na * 1e3:.3f} ms per sweep of 16 chains, production "
          f"{sb / n * 1e3:.3f} ms per iteration of {C} chains "
          f"({C * n / sb:.1f} chain-sweeps/s; the excursion, host copies "
          f"and the checkpoint included)")
    check(counts == {k: c1[k] + c2[k] + ca[k] + cb[k] for k in c1},
          f"{what}: launches {counts} are not its four phases' sum")
    return counts, by_shape, {f"{name} 16 chains": sa / na * 1e3,
                              f"{name} 256 chains": sb / n * 1e3}, peak


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
    events = graph_events()
    t0 = time.perf_counter()
    with ShapeProbe() as shapes:
        res = drivers.phase_warm_start(g, st, data, hp, c,
                                       n_iters=p["sweeps"], betas=betas,
                                       covariate_mean=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = counters()
    counted = counted_sweeps("config 3", graph_events(events), p["sweeps"])
    for f, v in state_to_numpy(res.final_state).items():
        check(np.all(np.isfinite(v)), f"config 3: final {f} not finite")
    check(float(res.final_state.eta.abs().max()) > 0
          and not bool(res.final_state.xi.any()),
          "config 3: eta did not move, or xi did")
    check_counts("config 3", counts, {
        k: v * counted for k, v in per_sweep("reference", "eta").items()})
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
    k3 = counted_sweeps(f"{name} phase 3, production census",
                        probe.graphs[2], n3)
    check_counts(f"{name} phase 3", c3,
                 phase3_launches(per_sweep("production", model), k3)[1])
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
                                               "hd", "blocked")
    return counts, by_shape, ms


# ---------------------------------------------------------------------------
# Slice 9: the reference-named API and its post-processing
# ---------------------------------------------------------------------------

# The R-named functional pipeline at the headline width (bench.py's data)
REF_API = dict(seed=7, N=100, K=3, P=8, M=4, n_time=[100, 100], n_try=7,
               nu_z_iters=300, theta_iters=300, warm_iters=400,
               n_temp_trans=100, N_t=3, beta_N_t=0.5, grid=50)
# The mirrors at configs 1 and 5's widths, short
REF_API_FAMILY_ITERS = 100
# FLLik (float64 NumPy from the traces) against the warm start's own loglik
# trace (float32 on the card, the RSS by K2): the same state, so they differ
# by float32 rounding of terms of the order of n_obs (10,000 points): up to
# 2.5e-3 nats found on the CPU at this width (FLLIK_ATOL: about 20 times it)
FLLIK_ATOL = 0.05
# tests/data/make_torch_post_reference.py's protocol: chip_smoke.py refuses
# a reference made with another
POST_REFERENCE = DATA / "torch_post_reference.json"
POST_PROTOCOL = {
    "headline": dict(data=dict(seed=7, N=100, K=3, P=8, M=4,
                               n_time=[80, 100]),
                     draws=200, trace_seed=13, burnin_prop=0.1, X=False),
    "config4": dict(data=dict(seed=7, N=80, K=2, P=8, M=16, D=1,
                              n_time=[80, 100], with_eta=True, with_xi=True),
                    draws=200, trace_seed=13, burnin_prop=0.1, X=True),
}


def check_ci(what, ci, shape):
    """A credible interval's three members: shape, finite, in order."""
    lo, med, hi = (np.asarray(ci[k]) for k in ("CI_Lower", "CI_50",
                                               "CI_Upper"))
    check(lo.shape == med.shape == hi.shape == shape,
          f"{what}: CI shape {lo.shape}, expected {shape}")
    check(all(np.all(np.isfinite(a)) for a in (lo, med, hi)),
          f"{what}: CI not finite")
    check(np.all(lo <= med + 1e-12) and np.all(med <= hi + 1e-12),
          f"{what}: CI_Lower <= CI_50 <= CI_Upper fails")


def r_named_phases(probe, n_calls):
    """The (seconds, launches, captured sweep's events) of the last
    ``n_calls`` api.fit_* calls the probe saw, which must be fit_nu_z,
    fit_theta, fit_warm_start."""
    calls = probe.calls[-n_calls:]
    check([c[0] for c in calls] == list(PhaseProbe.NAMES),
          f"the R-named fitters ran {[c[0] for c in calls]}")
    return [(s, {k: c[k] for k in KERNEL_NAMES}, ev) for (_, _, s, c), ev
            in zip(calls, probe.graphs[-n_calls:])]


def ref_api_functional(dev, card):
    """The R-named functional pipeline at the headline width, then every
    post-processing name on the directory its warm start wrote; returns
    (launch counts by phase, numbers for the line of timings)."""
    p = REF_API
    K, P, M, N = p["K"], p["P"], p["M"], p["N"]
    n1, n2, n3 = p["nu_z_iters"], p["theta_iters"], p["warm_iters"]
    n_time = tuple(p["n_time"])
    sim, _ = simulate_functional(seed=p["seed"], N=N, K=K, P=P, M=M,
                                 n_time=n_time, device=dev)
    # the raw lists the R names take: each curve's values and time points
    Y, t = functional_lists(sim, seed=p["seed"], n_time=n_time)
    knots, bk, deg = np.linspace(0, 1, P - 4 + 2)[1:-1], [0, 1], 3
    basis = (deg, bk, knots)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        with PhaseProbe() as probe:
            # no device: the card (reference_api's default)
            est1 = R.BFMMM_Nu_Z_multiple_try(n1, p["n_try"], K, Y, t, N, deg,
                                             M, bk, knots)
            est2 = R.BFMMM_Theta_est(n2, p["n_try"], K, Y, t, N, deg, M, bk,
                                     knots, est1)
            est3 = R.BFMMM_warm_start(n3, est1, est2, dir=tmp,
                                      n_temp_trans=p["n_temp_trans"],
                                      N_t=p["N_t"], beta_N_t=p["beta_N_t"])
        counts = counters()
        (s1, c1, _), (s2, c2, _), (s3, c3, _) = r_named_phases(probe, 3)
        check(est1.data.device.type == dev.type
              and torch.equal(est1.data.B, sim.B)
              and torch.equal(est1.data.y, sim.y),
              "R-named phase 1 did not build the headline data on the card")
        n_exc, want3 = phase3_launches(PATHS["slice"][2], n3,
                                       p["n_temp_trans"], p["N_t"])
        for name, got, want in (
                ("phase 1", c1, {k: v * n1 for k, v in
                                 PHASE_LAUNCHES["nu_z"].items()}),
                ("phase 2", c2, {k: v * n2 for k, v in
                                 PHASE_LAUNCHES["theta"].items()}),
                ("phase 3", c3, want3)):
            check_counts(f"R-named {name}", got, want)
        check(all(counts[k] > 0 for k in KERNEL_NAMES)
              and counts == {k: c1[k] + c2[k] + c3[k] for k in counts},
              f"R-named pipeline: launches {counts}")
        # the R lists' members in the reference's layouts
        # (tests/test_reference_signatures.py:52-68)
        for est, n, members in (
                (est1, n1, {"nu": (K, P), "Z": (N, K), "pi": (K,),
                            "alpha_3": (), "sigma_sq": (), "tau": (K,),
                            "loglik": ()}),
                (est2, n2, {"Phi": (K, P, M), "chi": (N, M),
                            "gamma": (K, P, M), "delta": (K, M),
                            "A": (K, 2), "loglik": ()}),
                (est3, n3, {"Phi": (K, P, M), "nu": (K, P), "Z": (N, K),
                            "sigma_sq": (), "loglik": ()})):
            for m, shape in members.items():
                v = est[m]
                check(v.shape == shape + (n,) and np.all(np.isfinite(v)),
                      f"R list member {m}: {v.shape}, expected "
                      f"{shape + (n,)}")
        B = est1["B"]
        check(len(B) == N and all(b.shape == (len(ti), P)
                                  for b, ti in zip(B, t)),
              "R list member B is not the per-curve basis list")
        ll1, ll3 = (float(np.mean(e.loglik[-100:])) for e in (est1, est3))
        print(f"  R-named pipeline: {n1} + {n2} + {n3} sweeps, {n_exc} "
              f"excursions; phase 1 and phase 3 mean loglik over the last 100 "
              f"draws {ll1:.2f} -> {ll3:.2f}")
        check(ll3 > ll1, "the warm start's loglik did not climb over phase 1's")
        out.update(phase_s={"nu_z": s1, "theta": s2, "warm_start": s3})

        # every post-processing name on the directory phase 3 wrote
        t0 = time.perf_counter()
        grid = np.linspace(0, 1, p["grid"])
        G = len(grid)
        for k in range(1, K + 1):
            for sim_band in (False, True):
                check_ci(f"FMeanCI k={k} simultaneous={sim_band}",
                         R.FMeanCI(tmp, 1, grid, *basis, k, rescale=False,
                                   simultaneous=sim_band), (G,))
        for k, l in ((1, 1), (1, 2)):
            check_ci(f"FCovCI ({k}, {l})",
                     R.FCovCI(tmp, 1, grid, grid, *basis, k, l,
                              rescale=False), (G, G))
        zci = R.ZCI(tmp, 1)
        check_ci("ZCI", zci, (N, K))
        check(np.all(zci["CI_Lower"] >= 0) and np.all(zci["CI_Upper"] <= 1),
              "ZCI outside [0, 1]")
        sci = R.SigmaCI(tmp, 1)
        check(0 < sci["CI_Lower"] <= sci["CI_50"] <= sci["CI_Upper"],
              f"SigmaCI {sci['CI_Lower']}, {sci['CI_50']}, {sci['CI_Upper']}")
        ics = {name: getattr(R, name)(tmp, 1, *basis, t, Y)
               for name in ("FDIC", "FAIC", "FBIC")}
        check(all(np.isfinite(v) for v in ics.values()), f"{ics}")
        ll = R.FLLik(tmp, 1, *basis, t, Y)
        e_ll = float(np.max(np.abs(ll - est3.loglik)))
        check(ll.shape == (n3,) and e_ll <= FLLIK_ATOL,
              f"FLLik differs from the warm start's loglik trace by {e_ll}")
        paths = R.FSamplePaths(tmp, 1, *basis, t, Y)
        y, mask = sim.y.cpu().numpy(), sim.mask.cpu().numpy() > 0
        cover = float(((y >= paths["CI_Lower"])
                       & (y <= paths["CI_Upper"]))[mask].mean())
        check(paths["SampPaths"].shape == (n3 - round(0.1 * n3), N, y.shape[1])
              and cover > 0.8,
              f"FSamplePaths: shape {paths['SampPaths'].shape}, its 95 % band "
              f"covers {cover:.3f} of the observed points")
        stems = {"ReadVec": ("Sigma", (n3,)), "ReadMat": ("Pi", (K, n3)),
                 "ReadCube": ("Z", (N, K, n3)), "ReadFieldVec": ("Chi", None),
                 "ReadFieldMat": ("Nu", None), "ReadFieldCube": ("Phi", None)}
        for reader, (stem, shape) in stems.items():
            got = getattr(R, reader)(os.path.join(tmp, f"{stem}0.txt"))
            ok = (np.shape(got) == shape if shape is not None
                  else isinstance(got, list) and len(got) == n3
                  and all(np.all(np.isfinite(g)) for g in got))
            check(ok, f"{reader}({stem}0.txt): {np.shape(got)}")
        numpy_s = time.perf_counter() - t0

        # CPO on the card: its host and device time at (draws, N)
        cpo = R.ConditionalPredictiveOrdinates(tmp, 1, *basis, t, Y)
        check(cpo.shape == (N,) and np.all(np.isfinite(cpo)),
              f"ConditionalPredictiveOrdinates: {cpo.shape}, finite "
              f"{np.isfinite(cpo).all()}")
        traces, data = R._traces_and_data_from_dir(tmp, 1, Y, t, *basis)
        check(data.device.type == dev.type, "CPO's data is not on the card")

        def cpo_call():
            return model_selection.cpo(traces, data)

        check(np.array_equal(cpo_call(), cpo), "CPO: another call, other bits")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            cpo_call()
        cpo_host_ms = (time.perf_counter() - t1) / 5 * 1e3
        by_kernel = device_ms_by_kernel(cpo_call, reps=5, warmup=1)
        draws = n3 - round(0.1 * n3)
    print(f"  R-named post-processing: FMeanCI x {2 * K}, FCovCI x 2, ZCI, "
          f"SigmaCI, FDIC {ics['FDIC']:.4f}, FAIC {ics['FAIC']:.4f}, FBIC "
          f"{ics['FBIC']:.4f}, FLLik (max |FLLik - loglik trace| {e_ll:.3e}, "
          f"tol {FLLIK_ATOL}), FSamplePaths (95 % band covers {cover:.4f}), "
          f"six Read*; CPO on the card in [{cpo.min():.3f}, {cpo.max():.3f}]")
    out.update(numpy_s=numpy_s, cpo_host_ms=cpo_host_ms,
               cpo_device_ms=sum(by_kernel.values()), cpo_shape=(draws, N),
               cpo_top=sorted(by_kernel.items(), key=lambda kv: -kv[1])[:3])
    return {"nu_z": c1, "theta": c2, "warm_start": c3}, out


def post_reference_phase(dev):
    """CPO on the card, DIC, AIC, BIC and the loglik trace against the JAX
    package's on traces rebuilt from the reference's seeds."""
    ref = json.loads(POST_REFERENCE.read_text())
    check(ref["protocol"] == POST_PROTOCOL,
          f"{POST_REFERENCE.name}: protocol {ref['protocol']} != "
          f"{POST_PROTOCOL}")
    for case, p in POST_PROTOCOL.items():
        want = ref[case]
        data, truth = simulate_functional(
            device=dev, **dict(p["data"], n_time=tuple(p["data"]["n_time"])))
        traces = simulate_draws(truth, p["draws"], seed=p["trace_seed"])
        sums = {k: float(np.sum(v)) for k, v in sorted(traces.items())}
        check(sums.keys() == want["trace_sums"].keys() and all(
            np.isclose(sums[k], want["trace_sums"][k], rtol=1e-12, atol=0)
            for k in sums), f"{case}: the rebuilt traces are not the "
                            f"reference's")
        X = data.X.cpu().numpy() if p["X"] else None
        bp = p["burnin_prop"]
        cpo = model_selection.cpo(traces, data, burnin_prop=bp, X=X)
        err = float(np.max(np.abs(cpo - np.asarray(want["cpo"]))))
        check(err <= want["cpo_atol"],
              f"{case}: CPO on the card differs from the JAX package's by "
              f"{err}, tolerance {want['cpo_atol']}")
        got = {"dic": model_selection.dic(traces, data, burnin_prop=bp, X=X),
               "aic": model_selection.aic(traces, data, burnin_prop=bp, X=X,
                                          cov_adj=bool(p["X"])),
               "bic": model_selection.bic(traces, data, burnin_prop=bp, X=X,
                                          cov_adj=bool(p["X"]))}
        ll = model_selection.loglik_trace(traces, data, X)
        check(all(np.isclose(got[k], want[k], rtol=1e-9, atol=0) for k in got)
              and np.allclose(ll, want["loglik"], rtol=1e-9, atol=0),
              f"{case}: {got} against the JAX package's "
              f"{ {k: want[k] for k in got} }")
        print(f"  {case} (N={data.N}, M={p['data']['M']}, {p['draws']} draws"
              f"{', eta and xi with X' if p['X'] else ''}): CPO on the card "
              f"within {err:.3e} of the JAX package's (tolerance "
              f"{want['cpo_atol']:.3e}: 4 x its float32 error); DIC "
              f"{got['dic']:.4f}, AIC {got['aic']:.4f}, BIC {got['bic']:.4f} "
              f"and the loglik trace equal to it (rtol 1e-9)")


def ref_api_families(dev):
    """The multivariate and hd mirrors at configs 1 and 5's widths, short;
    returns their launch counts and seconds by phase."""
    n = REF_API_FAMILY_ITERS
    counts, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp, PhaseProbe() as probe:
        # config 1: the multivariate family launches no K2 and no K3
        p = FAMILY_PROTOCOLS["config1"]
        K, M = p["K"], p["M"]
        data, _ = family_data(dev, "config1")
        Y = data.y.cpu().numpy()
        d1 = os.path.join(tmp, "mv")
        kernels.reset_launch_counts()
        e1 = R.BMVMMM_Nu_Z_multiple_try(n, p["n_try"], K, Y, M)
        e2 = R.BMVMMM_Theta_est(n, p["n_try"], K, Y, M, e1)
        e3 = R.BMVMMM_warm_start(n, e1, e2, dir=d1)
        counts["config1"] = counters()
        phases = r_named_phases(probe, 3)
        for (s, c, ev), sweep in zip(phases, ("nu_z", "theta", "reference")):
            m = counted_sweeps(f"R-named config 1, {sweep}", ev, n)
            check_counts(f"R-named config 1, {sweep}", c,
                         {k: v * m for k, v in per_sweep(sweep, "mv").items()})
        check(counts["config1"]["mean_rss"] == 0
              and counts["config1"]["weighted_gram"] == 0
              and counts["config1"]["chol_solve"] > 0,
              f"R-named config 1 launched {counts['config1']}")
        seconds["config1"] = [s for s, _, _ in phases]
        check(e3.data.identity_basis and "B" not in e3 and np.allclose(
            e3["tau"], 1.0 / np.moveaxis(e3.traces["tau"], 0, -1)),
            "config 1: the MV list's tau or B")
        P = Y.shape[1]
        mean = R.MVMeanCI(d1, 1)
        check(sorted(mean) == list(range(1, K + 1)), f"MVMeanCI: {list(mean)}")
        for k, ci in mean.items():
            check_ci(f"MVMeanCI k={k}", ci, (P,))
        check_ci("MVCovCI (1, 2)", R.MVCovCI(d1, 1, 1, 2), (P, P))
        ics = [getattr(R, name)(d1, 1, Y) for name in ("MVDIC", "MVAIC",
                                                         "MVBIC")]
        ll = R.MVLLik(d1, 1, Y)
        e_ll = float(np.max(np.abs(ll - e3.loglik)))
        check(np.all(np.isfinite(ics)) and e_ll <= FLLIK_ATOL,
              f"config 1: MVDIC/AIC/BIC {ics}, MVLLik off by {e_ll}")
        print(f"  R-named config 1 (multivariate): MVMeanCI, MVCovCI, MVDIC "
              f"{ics[0]:.4f}, MVAIC {ics[1]:.4f}, MVBIC {ics[2]:.4f}, MVLLik "
              f"within {e_ll:.3e} of the loglik trace")

        # config 5: the hd family, surfaces on a 12 x 12 grid
        p = FAMILY_PROTOCOLS["config5"]
        K, M = p["K"], p["M"]
        data = hd_grid_data(p, dev)
        g = np.linspace(0, 1, p["grid"])
        pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
        Y, t = list(data.y.cpu().numpy()), [pts] * p["N"]
        knots = [np.linspace(0, 1, k + 2)[1:-1] for k in p["n_internal"]]
        bk = np.tile(np.array([0.0, 1.0]), (2, 1))
        basis = (p["basis_degrees"], bk, knots)
        d5 = os.path.join(tmp, "hd")
        kernels.reset_launch_counts()
        e1 = R.BHDFMMM_Nu_Z_multiple_try(n, p["n_try"], K, Y, t, p["N"],
                                         p["basis_degrees"], M, bk, knots)
        e2 = R.BHDFMMM_Theta_est(n, p["n_try"], K, Y, t, p["N"],
                                 p["basis_degrees"], M, bk, knots, e1)
        R.BHDFMMM_warm_start(n, e1, e2, dir=d5)
        counts["config5"] = counters()
        phases = r_named_phases(probe, 3)
        for (s, c, ev), sweep in zip(phases, ("nu_z", "theta", "reference")):
            m = counted_sweeps(f"R-named config 5, {sweep}", ev, n)
            check_counts(f"R-named config 5, {sweep}", c,
                         {k: v * m for k, v in per_sweep(sweep, "hd").items()})
        seconds["config5"] = [s for s, _, _ in phases]
        check(torch.equal(e1.data.B, data.B) and e1.data.P == 16,
              "config 5: the R names built other data")
        for k in range(1, K + 1):
            check_ci(f"HDFMeanCI k={k}",
                     R.HDFMeanCI(d5, 1, pts, *basis, k, rescale=False),
                     (len(pts),))
        check_ci("HDFCovCI (1, 2)",
                 R.HDFCovCI(d5, 1, pts, pts[::4], *basis, 1, 2,
                            rescale=False), (len(pts), len(pts[::4])))
        print(f"  R-named config 5 (hd): HDFMeanCI x {K}, HDFCovCI on "
              f"{len(pts)} grid points")
    return counts, seconds


# ---------------------------------------------------------------------------
# Slice 10: parallel tempering and SMC
# ---------------------------------------------------------------------------

def production_sweeps(add, C, n):
    """Add the launches of ``n`` production sweeps of C chains at the
    headline width to ``add(kernel, shape, count)``: K1 once (update_phi),
    K2 twice on C rows (sigma2, MALA's RSS) and four times on 2C (the
    MGP-scale moves), K3 once on C K rows (update_nu)."""
    K, P, M, N = (PROTOCOL[k] for k in ("K", "P", "M", "N"))
    L = PROTOCOL["n_time"][1]
    add("chol_solve", (C, K * M * P), n)
    add("mean_rss", (C, N, L, P), 2 * n)
    add("mean_rss", (2 * C, N, L, P), 4 * n)
    add("weighted_gram", (C * K, N, P), n)


def predicted(fill):
    """(launches by kernel, launches by (kernel, shape)) that ``fill(add)``
    adds up."""
    by = {}

    def add(name, shape, n):
        by[(name, shape)] = by.get((name, shape), 0) + n

    fill(add)
    by = {k: n for k, n in by.items() if n}
    return ({k: sum(n for (name, _), n in by.items() if name == k)
             for k in KERNEL_NAMES}, by)


def pt_launches(R, n_rounds, pilot):
    """fit_pt in the production census: the pilot's sweeps of one chain and
    its energy (K2) after each, every round's sweep of R replicas and their
    energies, and the cold chain's log-likelihood over all rounds (one K2
    on n_rounds rows)."""
    N, L, P = PROTOCOL["N"], PROTOCOL["n_time"][1], PROTOCOL["P"]

    def fill(add):
        production_sweeps(add, 1, pilot)
        add("mean_rss", (1, N, L, P), pilot)
        production_sweeps(add, R, n_rounds)
        add("mean_rss", (R, N, L, P), n_rounds)
        add("mean_rss", (n_rounds, N, L, P), 1)
    return predicted(fill)


def smc_launches(n_particles, n_stages, n_mutation):
    """fit_smc in the production census: each stage's log-likelihood (K2)
    and its mutation sweeps of every particle."""
    N, L, P = PROTOCOL["N"], PROTOCOL["n_time"][1], PROTOCOL["P"]

    def fill(add):
        add("mean_rss", (n_particles, N, L, P), n_stages)
        production_sweeps(add, n_particles, n_stages * n_mutation)
    return predicted(fill)


def check_shapes(what, got, want):
    got = {k: v for k, v in got.items() if v}
    print(f"  {what}: launches by shape "
          + ", ".join(f"{k[0]} {k[1]} {v}" for k, v in sorted(got.items())))
    check(got == want, f"{what}: launches by shape {got}, expected {want}")


def in_limits(what, x, lim, rule):
    lo, hi = lim["limits"]
    print(f"  {what}: port {x:.6g}; JAX "
          + ", ".join(f"{v:.6g}" for v in lim["values"])
          + f"; limits [{lo:.6g}, {hi:.6g}] ({rule})")
    check(lo <= x <= hi, f"{what}: {x} outside [{lo}, {hi}]")


def tempering_phase(dev, card):
    """api.fit_pt (auto ladder, then a short geometric one) and api.fit_smc
    at the headline width, held against the JAX package's limits; returns
    (launches of each path, launches by shape of PT, its ladder length,
    timing numbers)."""
    ref = json.loads(TEMPERING_REFERENCE.read_text())
    head, rule = ref["headline"], ref["limit_rule"]
    fp = FIT_PROTOCOL
    dp = {k: fp[k] for k in ("seed", "N", "K", "P", "M", "n_time")}
    check(head["protocol"]["data"] == dp
          and head["protocol"]["pt"] == PT_PROTOCOL
          and head["protocol"]["smc"] == SMC_PROTOCOL,
          f"{TEMPERING_REFERENCE.name}: protocol {head['protocol']} != "
          f"{dp} / {PT_PROTOCOL} / {SMC_PROTOCOL}")
    fit_ref = json.loads(FIT_REFERENCE.read_text())
    data, _ = simulate_functional(seed=dp["seed"], N=dp["N"], K=dp["K"],
                                  P=dp["P"], M=dp["M"],
                                  n_time=tuple(dp["n_time"]), device=dev)
    start = fit_result_from_estimates(
        fit_ref["warm_start_from"], data,
        ModelConfig(K=dp["K"], P=dp["P"], M=dp["M"]))

    # the rounds' seconds, apart from the pilot's: fit_pt calls
    # run_parallel_tempering by its module attribute
    rounds_s = []
    original = tempering.run_parallel_tempering

    def timed_rounds(*a, **kw):
        t0 = time.perf_counter()
        out = original(*a, **kw)
        torch.cuda.synchronize()
        rounds_s.append(time.perf_counter() - t0)
        return out

    out = {}
    tempering.run_parallel_tempering = timed_rounds
    try:
        for name, kw in (("pt", PT_PROTOCOL), ("pt geometric", PT_GEOMETRIC)):
            kernels.reset_launch_counts()
            with ShapeProbe() as shapes, \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                res = api.fit_pt(start, start, **kw)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            out[name] = (res, counters(), dict(shapes.counts), seconds,
                         rounds_s[-1], [str(w.message) for w in caught])
    finally:
        tempering.run_parallel_tempering = original

    # the auto ladder and its run
    res, pt_counts, pt_shapes, pt_s, pt_rounds_s, msgs = out["pt"]
    n = PT_PROTOCOL["tot_mcmc_iters"]
    lad = res.ladder
    R = len(lad)
    check(lad[0] == 1.0 and np.all(np.diff(lad) < 0)
          and lad[-1] >= np.float32(PT_PROTOCOL["beta_min"]),
          f"PT: ladder {lad} does not fall from 1 to beta_min or above")
    check(res.loglik.shape == (n,) and np.all(np.isfinite(res.loglik)),
          "PT: the cold chain's loglik trace is malformed")
    for f, v in res.traces.items():
        check(v.shape[0] == n and np.all(np.isfinite(v)),
              f"PT: cold trace {f} malformed")
    for f, v in state_to_numpy(res.final_state).items():
        check(v.shape[0] == 1 and np.all(np.isfinite(v)),
              f"PT: final {f} malformed")
    for m in msgs:
        print(f"  PT warned: {m[:150]}")
    check(not any("swap rate" in m for m in msgs),
          "PT: the auto ladder's run raised the swap-rate warning")
    print(f"  PT ladder: {R} rungs from 1 to {lad[-1]:.4f}, swap rate "
          f"{res.swap_rate:.4f} (JAX: "
          + ", ".join(f"{v:.4f}" for v in head["pt"]["swap_rate"]["values"])
          + ")")
    in_limits("PT ladder length", R, head["pt"]["ladder_length"], rule)
    in_limits(f"PT cold chain's median loglik over rounds {n // 2}..{n}",
              float(np.median(res.loglik[n // 2:])),
              head["pt"]["loglik_median"], rule)
    want, want_shapes = pt_launches(R, n, PT_PROTOCOL["pilot_sweeps"])
    check_counts("PT (pilot, rounds, cold loglik)", pt_counts, want)
    check_shapes("PT", pt_shapes, want_shapes)

    # the geometric ladder: finiteness and launches
    g_res, g_counts, g_shapes, _, g_rounds_s, g_msgs = out["pt geometric"]
    ng, Rg = PT_GEOMETRIC["tot_mcmc_iters"], PT_GEOMETRIC["n_replicas"]
    check(g_res.ladder is None and np.all(np.isfinite(g_res.loglik))
          and all(np.all(np.isfinite(v)) for v in g_res.traces.values()),
          "PT geometric: result malformed or not finite")
    want, want_shapes = pt_launches(Rg, ng, 0)
    check_counts(f"PT geometric ({Rg} replicas, {ng} rounds)", g_counts,
                 want)
    check_shapes("PT geometric", g_shapes, want_shapes)
    print(f"  PT geometric: swap rate {g_res.swap_rate:.4f}"
          + (f" ({len(g_msgs)} warning: {g_msgs[0][:60]}...)" if g_msgs
             else ""))

    # SMC from the prior, no device given: the data's
    kernels.reset_launch_counts()
    with ShapeProbe() as shapes:
        t0 = time.perf_counter()
        sres = api.fit_smc(data=data, K=dp["K"], M=dp["M"], **SMC_PROTOCOL)
        torch.cuda.synchronize()
        smc_s = time.perf_counter() - t0
    smc_counts, smc_shapes = counters(), dict(shapes.counts)
    ns, Np = sres["n_stages"], SMC_PROTOCOL["n_particles"]
    check(sres["final_beta"] == 1.0, f"SMC ended at beta "
                                     f"{sres['final_beta']}")
    check(sres["particles"].Z.device.type == "cuda",
          "SMC: the particles are not on the card")
    for f, v in state_to_numpy(sres["particles"]).items():
        check(v.shape[0] == Np and np.all(np.isfinite(v)),
              f"SMC: particles' {f} malformed")
    w = sres["weights"].astype(np.float64)
    s2 = float(np.sum(w * state_to_numpy(sres["particles"])["sigma2"]))
    print(f"  SMC: {ns} stages to beta {sres['final_beta']}, weight-ESS "
          f"{1.0 / np.sum(w * w):.1f} of {Np}")
    in_limits("SMC stages", ns, head["smc"]["n_stages"], rule)
    in_limits("SMC log-evidence", sres["log_evidence"],
              head["smc"]["log_evidence"], rule)
    in_limits("SMC weighted sigma2", s2, head["smc"]["sigma2"], rule)
    want, want_shapes = smc_launches(Np, ns, SMC_PROTOCOL["n_mutation_sweeps"])
    check_counts(f"SMC ({ns} stages)", smc_counts, want)
    check_shapes("SMC", smc_shapes, want_shapes)

    # where a round's and a stage's time goes on the card
    hp, c = Priors(), torch.full((dp["K"],), 10.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(8)
    ladder = torch.as_tensor(lad, device=dev)
    pt = tempering.pt_init(take_chains(res.final_state, torch.zeros(
        R, dtype=torch.long, device=dev)))
    flags = api.PRODUCTION_FLAGS
    # a stage from beta 0.5 each time, at the particles SMC ended with
    box = {"pt": pt, "smc": (sres["particles"], torch.zeros(Np, device=dev))}
    half, zero = (torch.tensor(v, device=dev) for v in (0.5, 0.0))

    def pt_round():
        box["pt"] = tempering.pt_step(g, box["pt"], data, hp, c, ladder,
                                      parity=0, **flags)

    def smc_round():
        box["smc"] = smc.smc_stage(
            g, *box["smc"], half, zero, data, hp, c,
            n_mutation_sweeps=SMC_PROTOCOL["n_mutation_sweeps"],
            target_cess=0.7, ess_threshold=0.5, **flags)[:2]

    # profiled after the kernels' timings, as the sweeps are: a trace of
    # thousands of kernels just before them cost the next traces records
    rounds = {"PT round": (f"PT round, {R} replicas", pt_round,
                           pt_rounds_s / n * 1e3),
              "SMC stage": (f"SMC stage, {Np} particles", smc_round,
                            smc_s / ns * 1e3)}
    times = {k: v[2] for k, v in rounds.items()}
    print(f"  PT on {card}: fit_pt {pt_s:.3f} s ({pt_rounds_s:.3f} s for "
          f"{n} rounds of {R} replicas: {times['PT round']:.3f} ms a round, "
          f"{R * n / pt_rounds_s:.1f} replica-sweeps/s; pilot, set-up and "
          f"copies {pt_s - pt_rounds_s:.3f} s); geometric "
          f"{g_rounds_s / ng * 1e3:.3f} ms a round of {Rg}; SMC {smc_s:.3f} s "
          f"({times['SMC stage']:.3f} ms a stage, "
          f"{Np * ns * SMC_PROTOCOL['n_mutation_sweeps'] / smc_s:.1f} "
          f"particle-sweeps/s)")
    return ({"pt": pt_counts, "pt geometric": g_counts, "smc": smc_counts},
            pt_shapes, R, rounds)


def k2_grad_phase(dev, g, shapes=K2_GRAD_SHAPES):
    """K2's backward against its plain version, against autograd through
    K2's plain forward and against its twin on the CPU
    (``mean_rss_grad_tiled_plain``, the kernel's order of sums), the same
    bits from two calls and through MeanRSS (K2 forward and backward, as
    the log-joint reaches them); returns the worst |kernel - plain|."""
    worst = 0.0
    for C, N, L, P in shapes:
        B = torch.randn(N, L, P, generator=g, device=dev)
        y = torch.randn(N, L, generator=g, device=dev)
        w = torch.randn(C, N, P, generator=g, device=dev)
        gv = torch.randn(C, generator=g, device=dev)
        before = dict(kernels.LAUNCHES)
        got = kernels.mean_rss_grad(B, y, w, gv)
        got2 = kernels.mean_rss_grad(B, y, w, gv)
        wf = w.clone().requires_grad_()
        rss = kernels.MeanRSS.apply(B, y, wf)
        via_fn, = torch.autograd.grad((rss * gv).sum(), wf)
        plain = kernels.mean_rss_grad_plain(B, y, w, gv)
        wa = w.clone().requires_grad_()
        auto, = torch.autograd.grad(
            (kernels.mean_rss_plain(B, y, wa)[0] * gv).sum(), wa)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["mean_rss_grad"] - before["mean_rss_grad"] == 3
              and kernels.LAUNCHES["mean_rss"] - before["mean_rss"] == 1,
              f"K2's backward at {(C, N, L, P)}: launches "
              f"{kernels.LAUNCHES} after {before}")
        check(torch.equal(got, got2) and torch.equal(got, via_fn)
              and torch.equal(rss.detach(), kernels.mean_rss(B, y, w)[0]),
              f"K2's backward gave other bits on a second call or through "
              f"MeanRSS at {(C, N, L, P)}")
        twin = kernels.mean_rss_grad_tiled_plain(B.cpu(), y.cpu(), w.cpu(),
                                                 gv.cpu())
        scale = plain.abs().max().item()
        e_plain = (got - plain).abs().max().item()
        e_auto = (got - auto).abs().max().item()
        e_twin = (got.cpu() - twin).abs().max().item()
        print(f"  K2 mean_rss_grad C={C} N={N} L={L} P={P}: max|grad-plain|"
              f"={e_plain:.3e}, max|grad-autograd|={e_auto:.3e}, "
              f"max|grad-twin|={e_twin:.3e} (the twin's bits: "
              f"{'all' if torch.equal(got.cpu(), twin) else 'not all'}) of "
              f"max|grad| {scale:.3e} (tol {K2_GRAD_TOL} of it)")
        check(max(e_plain, e_auto, e_twin) <= K2_GRAD_TOL * scale,
              f"K2's backward disagrees at {(C, N, L, P)}")
        worst = max(worst, e_plain)
    return worst


def hmc_data(dev):
    d = HMC_PROTOCOL["data"]
    return simulate_functional(seed=d["seed"], N=d["N"], K=d["K"], P=d["P"],
                               M=d["M"], n_time=tuple(d["n_time"]),
                               device=dev)[0]


def hmc_point(data, chains):
    """(log_joint_flat, q) at the headline width: ``chains`` chains of a
    random unconstrained start (made on the CPU, so both devices get the
    same numbers) on ``data``'s device."""
    from bayesfmmm_torch.models import logjoint
    K, M = HMC_PROTOCOL["fit"]["K"], HMC_PROTOCOL["fit"]["M"]
    unc = logjoint.init_unc(torch.Generator().manual_seed(11),
                            ModelConfig(K=K, P=data.P, M=M),
                            hmc_data(torch.device("cpu")), chains)
    unc = logjoint.UncState(**{f: t.to(data.device)
                               for f, t in vars(unc).items()})
    lj = logjoint.make_log_joint(data, Priors(), torch.full(
        (K,), 10.0, device=data.device))
    return (lambda q: lj(logjoint.unflatten(q, unc))), logjoint.flatten(unc)


def logjoint_phase(dev):
    """The log-joint's value and gradient on the card against the CPU at
    one point, 64 chains at the headline width; on the card one gradient
    evaluation launches K2 forward and backward once each, and the plain
    versions are not called."""
    from bayesfmmm_torch.samplers import hmc
    C = HMC_PROTOCOL["fit"]["n_chains"]
    lj_cpu, q_cpu = hmc_point(hmc_data(torch.device("cpu")), C)
    v_cpu, g_cpu = hmc.value_and_grad(lj_cpu, q_cpu)
    lj, q = hmc_point(hmc_data(dev), C)
    check(torch.equal(q.cpu(), q_cpu), "log-joint: the two points differ")

    def refuse(*a, **kw):
        raise RuntimeError("a plain K2 version ran on the card")

    plains = kernels.mean_rss_plain, kernels.mean_rss_grad_plain
    kernels.mean_rss_plain = kernels.mean_rss_grad_plain = refuse
    try:
        kernels.reset_launch_counts()
        v, grad = hmc.value_and_grad(lj, q)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
    finally:
        kernels.mean_rss_plain, kernels.mean_rss_grad_plain = plains
    want = {"chol_solve": 0, "mean_rss": 1, "mean_rss_grad": 1,
            "weighted_gram": 0}
    check(counts == want, f"log-joint: one gradient evaluation launched "
                          f"{counts}, expected {want}")
    e_v = ((v.cpu() - v_cpu).abs() / v_cpu.abs()).max().item()
    e_g = ((grad.cpu() - g_cpu).norm(dim=1) / g_cpu.norm(dim=1)).max().item()
    print(f"  log-joint on the card vs the CPU, {C} chains at the headline "
          f"width (dim {q.shape[1]}): max relative value error {e_v:.3e} "
          f"(tol {LOGJOINT_TOL['value']}), max relative gradient error "
          f"{e_g:.3e} (tol {LOGJOINT_TOL['grad']}); launches {counts}")
    check(bool(torch.isfinite(v).all()) and bool(torch.isfinite(grad).all())
          and e_v <= LOGJOINT_TOL["value"] and e_g <= LOGJOINT_TOL["grad"],
          "log-joint: the card disagrees with the CPU")
    return lj, q


def hmc_evaluations(diag, method):
    """Gradient evaluations a run makes, from its own trajectories: one at
    the start, then the longest of the chains' lengths an iteration (HMC)
    or 2^D - 1 leaves for the deepest tree D of the batch (NUTS)."""
    if method == "hmc":
        return 1 + int(diag["n_steps"].max(0).sum())
    return 1 + int((2 ** diag["depth"].max(0).astype(np.int64) - 1).sum())


def hmc_fit(dev, method, ref):
    """api.fit_hmc at the headline width, no device given (so on the card):
    launch counts as its trajectories predict them, the statistics inside
    the JAX limits.  Returns (counts, numbers)."""
    p = HMC_PROTOCOL
    data = hmc_data(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = api.fit_hmc(data, seed=0, **p["fit"], **p[method])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    diag = res.hmc_diagnostics
    C, S = p["fit"]["n_chains"], p[method]["n_samples"]
    iters = p[method]["n_warmup"] + S
    evals = hmc_evaluations(diag, method)
    # K2 forward and backward once a gradient evaluation, and one forward
    # for the loglik of every kept draw
    want = {"chol_solve": 0, "mean_rss": evals + 1, "mean_rss_grad": evals,
            "weighted_gram": 0}
    print(f"  fit_hmc {method}: {C} chains, {iters} iterations in "
          f"{seconds:.3f} s ({1e3 * seconds / iters:.3f} ms an iteration, "
          f"{evals} gradient evaluations: {1e3 * seconds / evals:.3f} ms "
          f"each with the sampler's own work); launches {counts}")
    check(counts == want, f"fit_hmc {method}: launches {counts}, expected "
                          f"{want} from its trajectories")
    check(res.all_chain_loglik.shape == (C, S)
          and np.all(np.isfinite(res.all_chain_loglik))
          and all(np.all(np.isfinite(v)) for v in res.traces.values()),
          f"fit_hmc {method}: non-finite draws")
    got = {"loglik_tail_mean": float(res.loglik[-100:].mean()),
           "sigma2_median": float(np.median(res.traces["sigma2"])),
           "accept_mean": float(diag["accept_mean"].mean()),
           "eps_median": float(np.median(diag["eps"]))}
    for stat in HMC_STATS:
        lim = ref[method][stat]
        lo, hi = lim["limits"]
        print(f"  fit_hmc {method} {stat}: port {got[stat]:.6g}; JAX "
              + ", ".join(f"{v:.6g}" for v in lim["values"])
              + f"; limits [{lo:.6g}, {hi:.6g}]")
        check(lo <= got[stat] <= hi, f"fit_hmc {method}: {stat} "
                                     f"{got[stat]} outside [{lo}, {hi}]")
    extra = ({"mean_depth": float(diag["mean_depth"].mean()),
              "n_divergent": int(diag["n_divergent"].sum())}
             if method == "nuts" else {})
    return counts, dict(got, seconds=seconds, iterations=iters,
                        evaluations=evals,
                        ms_per_iteration=1e3 * seconds / iters,
                        ms_per_evaluation_in_run=1e3 * seconds / evals,
                        best_chain=res.chain_index, **extra)


def hmc_phase(dev, g, card):
    """Slice 11: K2's backward, the log-joint on the card, api.fit_hmc
    ("hmc" and "nuts"), and the numbers of the gradient path.  Returns
    (launch counts by method, numbers, the mean_rss_grad entry of the
    kernels line)."""
    from bayesfmmm_torch.samplers import hmc, nuts
    ref = json.loads(HMC_REFERENCE.read_text())["headline"]
    check({k: v for k, v in ref["protocol"].items() if k != "seeds"}
          == HMC_PROTOCOL, f"{HMC_REFERENCE.name}: protocol "
          f"{ref['protocol']} != {HMC_PROTOCOL}")
    err = k2_grad_phase(dev, g)
    lj, q = logjoint_phase(dev)
    counts, numbers = {}, {}
    for method in ("hmc", "nuts"):
        counts[method], numbers[method] = hmc_fit(dev, method, ref)

    # ms a gradient evaluation on the host's clock, ending in a synchronise
    for _ in range(3):
        hmc.value_and_grad(lj, q)
    torch.cuda.synchronize()
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        hmc.value_and_grad(lj, q)
    torch.cuda.synchronize()
    ms_eval = 1e3 * (time.perf_counter() - t0) / reps
    # kernels and device-busy ms a leapfrog step, from the profiler: 8
    # steps of HMC's leapfrog and a NUTS subtree of 8 leaves
    C, steps = q.shape[0], 8
    logp, grad = hmc.value_and_grad(lj, q)
    p0 = torch.randn(q.shape, generator=g, device=dev)
    eps = torch.full((C,), 0.03, device=dev)
    inv_mass = torch.ones_like(q)
    vg = lambda x: hmc.value_and_grad(lj, x)          # noqa: E731
    energy0 = -logp + 0.5 * (p0 * p0).sum(1)
    live = torch.ones(C, dtype=torch.bool, device=dev)
    step_prof = {
        "hmc": profile_calls(
            f"HMC, {steps} leapfrog steps of {C} chains",
            lambda: hmc._leapfrog(vg, q, p0, grad, logp, eps, inv_mass,
                                  torch.full((C,), steps, device=dev))),
        "nuts": profile_calls(
            f"NUTS, a subtree of {steps} leaves of {C} chains",
            lambda: nuts._build_subtree(g, vg, q, p0, grad, eps, 3,
                                        inv_mass, energy0, 6, live))}
    for method, v in step_prof.items():
        n = numbers[method]
        n["kernels_per_step"] = v["kernels"] / steps
        n["device_ms_per_step"] = v["device_ms"] / steps
        n["ms_per_evaluation"] = ms_eval
        busy = 100 * n["device_ms_per_step"] / n["ms_per_evaluation_in_run"]
        print(f"  fit_hmc {method} on {card}: {ms_eval:.3f} ms a gradient "
              f"evaluation alone (host's clock), "
              f"{n['ms_per_evaluation_in_run']:.3f} ms in the run, "
              f"{n['ms_per_iteration']:.3f} ms an iteration; a leapfrog step "
              f"{n['kernels_per_step']:.1f} kernels and "
              f"{n['device_ms_per_step']:.4f} ms of device time "
              f"({busy:.1f} % busy)")

    # mean_rss_grad beside its bound, its plain version and the empty
    # kernel, in turns, at every shape a path gives it and a general P
    t = []
    for C_, N_, L_, P_ in GRAD_SHAPES:      # the first the line's own
        x = (torch.randn(N_, L_, P_, generator=g, device=dev),
             torch.randn(N_, L_, generator=g, device=dev),
             torch.randn(C_, N_, P_, generator=g, device=dev),
             torch.randn(C_, generator=g, device=dev))
        cands = {"kernel": lambda x=x: kernels.mean_rss_grad(*x),
                 "plain": lambda x=x: kernels.mean_rss_grad_plain(*x),
                 "empty": lambda: kernels.empty_launch(dev)}
        v = {k: r["device_ms"] for k, r in in_turns(cands, rounds=3).items()}
        v["paced"] = paced_ms(cands["kernel"])
        v.update(kernels.kernel_bound("mean_rss_grad", C=C_, N=N_, L=L_,
                                      P=P_))
        v["shape"] = dict(C=C_, N=N_, L=L_, P=P_)
        t.append(v)
        print(f"  mean_rss_grad (C={C_}, N={N_}, L={L_}, P={P_}): device "
              f"{1e3 * v['kernel']:.2f} us vs plain {1e3 * v['plain']:.2f} "
              f"us, empty kernel {1e3 * v['empty']:.2f} us; bound "
              f"{1e3 * v['bound_ms']:.3f} us by {v['bound_by']} "
              f"({v['bytes']} bytes, {v['flop']:.0f} FLOP; "
              f"{100 * v['bound_ms'] / v['kernel']:.2f} % of it reached); "
              f"host-paced {1e3 * v['paced']:.2f} us")
    main_t = t[0]
    entry = {"name": "mean_rss_grad", "route": "cuda",
             "source": "bayesfmmm_torch/csrc/mean_rss.cu",
             "replaces": "bayesfmmm_tpu/ops/pallas_kernels.py:68",
             "backward_of": "mean_rss",
             "launches": sum(c["mean_rss_grad"] for c in counts.values()),
             "launches_by_path": {f"fit_hmc {m}": c["mean_rss_grad"]
                                  for m, c in counts.items()},
             "max_abs_err": err, "ms": main_t["kernel"],
             "plain_ms": main_t["plain"], "bound_ms": main_t["bound_ms"],
             "bound_by": main_t["bound_by"], "library_ms": None,
             "shape": main_t["shape"], "bytes": main_t["bytes"],
             "flop": main_t["flop"], "empty_ms": main_t["empty"],
             "by_shape": [{"shape": v["shape"], "ms": v["kernel"],
                           "plain_ms": v["plain"], "empty_ms": v["empty"],
                           "bound_ms": v["bound_ms"],
                           "bound_by": v["bound_by"], "bytes": v["bytes"],
                           "flop": v["flop"]} for v in t]}
    return counts, numbers, entry


def advi_fit(dev, seed=0):
    """api.fit_advi_init under ADVI_PROTOCOL on ``dev`` (no device given
    on the card, so it goes there by default)."""
    p = ADVI_PROTOCOL
    d = p["data"]
    data, _ = simulate_functional(seed=d["seed"], N=d["N"], K=d["K"],
                                  P=d["P"], M=d["M"],
                                  n_time=tuple(d["n_time"]), device=dev)
    where = {} if dev.type == "cuda" else {"device": dev}
    return api.fit_advi_init(data, seed=seed, **p["fit"], **where)


def default_off_sweeps(dev, seed=0):
    """DEFAULT_OFF_PROTOCOL on ``dev``: fit_warm_start's production census
    from the JAX package's phase-1/2 medians, the inverse mass from its
    ensemble (bench.py:196-203), then the default-off sweeps through
    phase_warm_start.  Returns (their loglik (C, n), the final ensemble,
    their launch counts, their seconds, (data, inverse mass))."""
    from bayesfmmm_torch.models import logjoint
    p = DEFAULT_OFF_PROTOCOL
    d = p["data"]
    data, _ = simulate_functional(seed=d["seed"], N=d["N"], K=d["K"],
                                  P=d["P"], M=d["M"],
                                  n_time=tuple(d["n_time"]), device=dev)
    cfg = ModelConfig(K=d["K"], P=d["P"], M=d["M"])
    start = fit_result_from_estimates(
        json.loads(FIT_REFERENCE.read_text())["warm_start_from"], data, cfg)
    warm = api.fit_warm_start(start, start, tot_mcmc_iters=p["warm_sweeps"],
                              n_chains=p["chains"], kernels="production",
                              seed=seed, progress=False)
    flat = logjoint.flatten(logjoint.from_state(warm.ensemble_state), False)
    inv_mass = flat.var(0, unbiased=False) + 1e-8
    g = torch.Generator(device=dev).manual_seed(1000 + seed)
    c = torch.full((d["K"],), 10.0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = drivers.phase_warm_start(g, warm.ensemble_state, data, Priors(), c,
                                   n_iters=p["sweeps"],
                                   hmc_inv_mass=inv_mass, **p["flags"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (res.loglik, res.final_state, dict(kernels.LAUNCHES), seconds,
            (data, inv_mass))


def advi_statistics(res):
    """The advi protocol's statistics (make_torch_advi_reference.py's)."""
    elbo = np.asarray(res.elbo_trace, np.float64)
    ll = np.asarray(res.loglik, np.float64)
    return {"elbo_tail_mean": float(elbo[-50:].mean()),
            "elbo_rise": float(elbo[-50:].mean() - elbo[:50].mean()),
            "loglik_tail_mean": float(ll[-100:].mean()),
            "sigma2_median": float(np.median(res.traces["sigma2"]))}


def sweep_statistics(loglik, final):
    """The default-off sweep's statistics: the ensemble medians of the
    chains' mean loglik over the last 50 sweeps and of the last sigma^2."""
    return {"loglik_median": float(loglik[:, -50:].mean(1).median()),
            "sigma2_median": float(final.sigma2.median())}


def advi_phase(dev, g, card):
    """Slice 12: api.fit_advi_init and the default-off sweep at the
    headline width against the JAX limits, their launch counts, the
    log-joint's gradient at the sweep's state on the card against the CPU,
    K2 and its backward at ADVI's 4 rows, and the ADVI step's and the
    default-off sweep's numbers.  Returns (launch counts by path, numbers,
    kernels-line entries of the new shapes)."""
    from bayesfmmm_torch.models import logjoint
    from bayesfmmm_torch.samplers import advi, hmc
    ref = json.loads(ADVI_REFERENCE.read_text())
    for name, proto in (("advi", ADVI_PROTOCOL),
                        ("sweep", DEFAULT_OFF_PROTOCOL)):
        got = {k: v for k, v in ref[name]["protocol"].items() if k != "seeds"}
        check(got == proto, f"{ADVI_REFERENCE.name} {name}: protocol {got} "
                            f"!= {proto}")
    p, q = ADVI_PROTOCOL["fit"], DEFAULT_OFF_PROTOCOL
    numbers, paths = {}, {}

    # K2 forward and backward at ADVI's rows against their plain versions
    k2_err = k2_phase(dev, g, [(4, 100, 100, 8, None)])
    grad_err = k2_grad_phase(dev, g, [(4, 100, 100, 8)])

    # 1. fit_advi_init: K2 forward and backward once an ADVI step; the warm
    # start's reference census K1 / K2 / K3 1 / 2 / 1 a sweep run eagerly or
    # captured (its replays launch from the graph)
    kernels.reset_launch_counts()
    events = graph_events()
    t0 = time.perf_counter()
    res = advi_fit(dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    n_w, n_a = p["warm_iters"], p["advi_steps"]
    k_w = counted_sweeps("fit_advi_init", graph_events(events), n_w)
    want = {"chol_solve": k_w, "mean_rss": n_a + 2 * k_w,
            "mean_rss_grad": n_a, "weighted_gram": k_w}
    print(f"  fit_advi_init: {n_a} ADVI steps, {p['n_chains']} chains x "
          f"{n_w} sweeps in {seconds:.3f} s; launches {counts}")
    check(counts == want, f"fit_advi_init: launches {counts}, expected "
                          f"{want}")
    check(np.all(np.isfinite(res.elbo_trace))
          and np.all(np.isfinite(res.all_chain_loglik))
          and res.all_chain_loglik.shape == (p["n_chains"], n_w)
          and all(np.all(np.isfinite(v)) for v in res.traces.values()),
          "fit_advi_init: non-finite or malformed result")
    stats = advi_statistics(res)
    for stat in ADVI_STATS:
        in_limits(f"fit_advi_init {stat}", stats[stat], ref["advi"][stat],
                  ref["limit_rule"])
    paths["fit_advi_init"] = counts
    numbers["fit_advi_init"] = dict(stats, seconds=seconds)

    # 2. the production sweep with every default-off kernel on: per sweep
    # K1 1, K3 1, K2 the production census's 7, update_phi_chi's RSS and
    # 1 + hmc_steps log-joint evaluations, with as many backward launches
    ll, final, counts, s_seconds, (data, inv_mass) = default_off_sweeps(dev)
    n, h = q["sweeps"], q["flags"]["hmc_steps"]
    want = {"chol_solve": n, "mean_rss": n * (7 + 1 + 1 + h),
            "mean_rss_grad": n * (1 + h), "weighted_gram": n}
    ms_sweep = 1e3 * s_seconds / n
    print(f"  default-off sweep: {q['chains']} chains x {n} sweeps in "
          f"{s_seconds:.3f} s ({ms_sweep:.3f} ms a sweep, "
          f"{q['chains'] * n / s_seconds:.1f} chain-sweeps/s); launches "
          f"{counts}")
    check(counts == want, f"default-off sweep: launches {counts}, expected "
                          f"{want}")
    check(bool(torch.isfinite(ll).all()) and all(
        bool(torch.isfinite(getattr(final, f)).all()) for f in STATE_FIELDS)
        and bool((final.Z >= 0).all()), "default-off sweep: non-finite")
    stats = sweep_statistics(ll, final)
    for stat in SWEEP_STATS:
        in_limits(f"default-off sweep {stat}", stats[stat],
                  ref["sweep"][stat], ref["limit_rule"])
    paths["default-off sweep"] = counts
    numbers["default-off sweep"] = dict(stats, seconds=s_seconds,
                                        ms_per_sweep=ms_sweep)

    # update_hmc_joint's log-joint on the card against the CPU, at the
    # sweep's final ensemble, K2 forward and backward once, no plain version
    c = torch.full((3,), 10.0, device=dev)
    unc = logjoint.from_state(final)
    qpos = logjoint.flatten(unc, False)
    cpu = torch.device("cpu")
    unc_c = logjoint.UncState(**{f: t.to(cpu) for f, t in vars(unc).items()})
    data_c = api._on_device(data, cpu)
    lj_c = logjoint.make_log_joint(data_c, Priors(), c.cpu())
    v_c, g_c = hmc.value_and_grad(
        lambda x: lj_c(logjoint.unflatten(x, unc_c, False)), qpos.cpu())
    lj = logjoint.make_log_joint(data, Priors(), c)

    def refuse(*a, **kw):
        raise RuntimeError("a plain K2 version ran on the card")

    plains = kernels.mean_rss_plain, kernels.mean_rss_grad_plain
    kernels.mean_rss_plain = kernels.mean_rss_grad_plain = refuse
    try:
        kernels.reset_launch_counts()
        v, grad = hmc.value_and_grad(
            lambda x: lj(logjoint.unflatten(x, unc, False)), qpos)
        torch.cuda.synchronize()
        one = dict(kernels.LAUNCHES)
    finally:
        kernels.mean_rss_plain, kernels.mean_rss_grad_plain = plains
    e_v = ((v.cpu() - v_c).abs() / v_c.abs()).max().item()
    e_g = ((grad.cpu() - g_c).norm(dim=1) / g_c.norm(dim=1)).max().item()
    print(f"  update_hmc_joint's log-joint at the sweep's ensemble, card vs "
          f"CPU: max relative value error {e_v:.3e} (tol "
          f"{LOGJOINT_TOL['value']}), gradient {e_g:.3e} (tol "
          f"{LOGJOINT_TOL['grad']}); launches {one}")
    check(one == {"chol_solve": 0, "mean_rss": 1, "mean_rss_grad": 1,
                  "weighted_gram": 0}, f"update_hmc_joint's log-joint: "
                                       f"launches {one}")
    check(e_v <= LOGJOINT_TOL["value"] and e_g <= LOGJOINT_TOL["grad"],
          "update_hmc_joint's log-joint: the card disagrees with the CPU")

    # ms an ADVI step on the host's clock, then its kernels and device-busy
    # ms under the profiler; kernels and device-busy ms a default-off sweep
    lj_a = logjoint.make_log_joint(data, Priors(), c)
    like = logjoint.init_unc(torch.Generator(device=dev).manual_seed(3),
                             ModelConfig(K=3, P=8, M=4), data, 1)
    mu = logjoint.flatten(like, False)[0].clone().requires_grad_()
    log_sd = torch.full_like(mu, -2.0).requires_grad_()
    opt = torch.optim.Adam([mu, log_sd], lr=p["advi_lr"])
    eps = torch.randn(4, mu.shape[0], generator=g, device=dev)

    def step():
        return advi._advi_step(
            lambda x: lj_a(logjoint.unflatten(x, like, False)), (mu, log_sd),
            opt, eps)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        step()
    torch.cuda.synchronize()
    ms_step = 1e3 * (time.perf_counter() - t0) / 50
    prof_step = profile_calls("ADVI, a step of 4 draws", step)
    box = [final]
    g_s = torch.Generator(device=dev).manual_seed(6)

    def sweep():
        box[0] = gibbs.sweep_full(g_s, box[0], data, Priors(), c,
                                  hmc_inv_mass=inv_mass, **q["flags"])

    prof_sweep = profile_calls(f"default-off sweep, {q['chains']} chains",
                               sweep)
    numbers["fit_advi_init"].update(
        ms_per_step=ms_step, kernels_per_step=prof_step["kernels"],
        device_ms_per_step=prof_step["device_ms"])
    numbers["default-off sweep"].update(
        kernels_per_sweep=prof_sweep["kernels"],
        device_ms_per_sweep=prof_sweep["device_ms"])
    print(f"  ADVI on {card}: {ms_step:.3f} ms a step (host's clock), "
          f"{prof_step['kernels']:.0f} kernels and "
          f"{prof_step['device_ms']:.4f} ms of device time a step "
          f"({100 * prof_step['device_ms'] / ms_step:.1f} % busy); the "
          f"default-off sweep {ms_sweep:.3f} ms, {prof_sweep['kernels']:.0f} "
          f"kernels and {prof_sweep['device_ms']:.3f} ms of device time a "
          f"sweep ({100 * prof_sweep['device_ms'] / ms_sweep:.1f} % busy)")

    # K2 and its backward at ADVI's 4 rows beside their bounds and plain
    # versions
    B, y = data.B, data.y
    w4 = torch.randn(4, data.N, data.P, generator=g, device=dev)
    gv = torch.randn(4, generator=g, device=dev)
    entries = []
    for base, fns, err, launched in (
            ("mean_rss", (lambda: kernels.mean_rss(B, y, w4),
                          lambda: kernels.mean_rss_plain(B, y, w4)), k2_err,
             paths["fit_advi_init"]["mean_rss"]),
            ("mean_rss_grad", (lambda: kernels.mean_rss_grad(B, y, w4, gv),
                               lambda: kernels.mean_rss_grad_plain(
                                   B, y, w4, gv)), grad_err,
             paths["fit_advi_init"]["mean_rss_grad"])):
        cands = {"kernel": fns[0], "plain": fns[1],
                 "empty": lambda: kernels.empty_launch(dev)}
        t = {k: r["device_ms"] for k, r in in_turns(cands, rounds=3).items()}
        t.update(kernels.kernel_bound(base, C=4, N=data.N, L=data.L,
                                      P=data.P))
        print(f"  {base} at ADVI's 4 rows (N={data.N}, L={data.L}, "
              f"P={data.P}): device {1e3 * t['kernel']:.2f} us vs plain "
              f"{1e3 * t['plain']:.2f} us, empty kernel "
              f"{1e3 * t['empty']:.2f} us; bound {1e3 * t['bound_ms']:.3f} us "
              f"by {t['bound_by']} ({t['bytes']} bytes, {t['flop']:.0f} "
              f"FLOP; {100 * t['bound_ms'] / t['kernel']:.2f} % of it)")
        entries.append({
            "name": f"{base}_advi_c4", "route": "cuda",
            "source": "bayesfmmm_torch/csrc/mean_rss.cu",
            "replaces": "bayesfmmm_tpu/ops/pallas_kernels.py:68",
            "launches": launched, "max_abs_err": err, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": dict(C=4, N=data.N, L=data.L, P=data.P),
            "bytes": t["bytes"], "flop": t["flop"], "empty_ms": t["empty"]})
    return paths, numbers, entries


# ---------------------------------------------------------------------------
# Slice 16: the chains axis of parallel/mesh.py on the card
# ---------------------------------------------------------------------------

def _mesh_data(dev):
    """The headline protocol's data, priors and c on ``dev``."""
    p = PROTOCOL
    data, _ = simulate_functional(seed=p["seed"], N=p["N"], K=p["K"],
                                  P=p["P"], M=p["M"],
                                  n_time=tuple(p["n_time"]), device=dev)
    return data, Priors(), torch.full((p["K"],), 10.0, device=dev)


def _mesh_runs(g, st, data, hp, c, flags, pt_states, mesh=None,
               ckpt=None):
    """The mesh protocol from the ensemble ``st`` and the generator ``g``:
    its production sweeps, a checkpoint (to ``ckpt`` when given), one sweep
    more, then PT over ``pt_states`` with a generator of its own.  Under a
    split ``mesh`` (inside its ``with``) ``st`` is this rank's chains and
    rows, and ``pt_states``, whole, are split just before PT.  Returns
    (sweeps' result, seconds, launch counts, (collectives, their seconds)
    in the sweeps, the sweep after the checkpoint, PT's (cold trace,
    PTState, rate))."""
    from bayesfmmm_torch.parallel import mesh as pmesh

    m = MESH_PROTOCOL
    split = mesh is not None and mesh.size > 1
    before = (mesh.collectives, mesh.collective_seconds) if split else (0, 0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = drivers.phase_warm_start(g, st, data, hp, c, n_iters=m["sweeps"],
                                   **flags)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = counters()
    coll = ((mesh.collectives - before[0],
             mesh.collective_seconds - before[1]) if split else (0, 0.0))
    if ckpt is not None:
        save_checkpoint(ckpt, res.final_state, g, iteration=m["sweeps"])
    after = drivers.phase_warm_start(g, res.final_state, data, hp, c,
                                     n_iters=1, start_iter=m["sweeps"],
                                     **flags).final_state
    if split:
        pt_states = pmesh.shard_chain_states(pt_states, mesh)
    pt = tempering.run_parallel_tempering(
        torch.Generator(device=data.device).manual_seed(m["pt_seed"]),
        pt_states, data, hp, c, n_rounds=m["pt_rounds"],
        beta_min=m["pt_beta_min"], **flags)
    return res, seconds, counts, coll, after, pt


class _First:
    """While active, ``module.name`` is wrapped so that ``keep(args,
    output)`` of its first call is kept in ``value``; with ``factory`` the
    function returns a step function, and the step's first call is kept."""

    def __init__(self, module, name, keep, factory=False):
        self.module, self.name, self.keep = module, name, keep
        self.factory = factory
        self.value = None

    def __enter__(self):
        self._original = fn = getattr(self.module, self.name)

        def first(call):
            def wrapper(*a, **kw):
                out = call(*a, **kw)
                if self.value is None:
                    self.value = self.keep(a, out)
                return out
            return wrapper

        setattr(self.module, self.name,
                (lambda *a, **kw: first(fn(*a, **kw))) if self.factory
                else first(fn))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._original)


def _sampler_inputs(data, start):
    """The slice-18 samplers' whole inputs on ``data``'s device, made
    outside any mesh (their draws are the one-process run's): SMC's
    particles from the prior, HMC's and NUTS's positions and the sweep's
    ensemble (the first 64 chains of ``start``), ADVI's start (its first
    chain) and the sweep's inverse mass (the variance of those chains'
    positions, as bench.py:196-203 takes it)."""
    from bayesfmmm_torch.models import logjoint
    m = MESH_SAMPLERS
    p = PROTOCOL
    dev = data.device
    chains = take_chains(start, torch.arange(m["hmc_chains"], device=dev))
    unc = logjoint.from_state(chains)
    return {
        "particles": init_state(torch.Generator(device=dev).manual_seed(
            m["seed"]), ModelConfig(K=p["K"], P=p["P"], M=p["M"]), data,
            chains=m["smc_particles"]),
        "hmc": unc, "sweep": chains,
        "advi": logjoint.from_state(take_chains(
            start, torch.zeros(1, dtype=torch.long, device=dev))),
        "inv_mass": logjoint.flatten(unc, False).var(0, unbiased=False)
        + 1e-8}


def _sampler_runs(data, hp, c, x, mesh=None):
    """SMC, HMC, NUTS, ADVI and the HMC-step sweep under MESH_SAMPLERS from
    the whole inputs ``x`` (``_sampler_inputs``), in one process or, inside
    a ``with mesh:`` that splits the chains or the data (``data`` then the
    rank's rows), over the mesh's ranks.  Returns sampler -> {"first": the
    state after its first transition and "final": its results, both whole
    and on the host; "mine": this rank's global fields and slots; "gen":
    its generator's state; "launches", "seconds", "steps" and
    "collectives" (count, seconds)}."""
    from bayesfmmm_torch.models import logjoint
    from bayesfmmm_torch.models.state import GibbsState
    from bayesfmmm_torch.parallel import mesh as pmesh
    from bayesfmmm_torch.samplers import advi, hmc, nuts

    m = MESH_SAMPLERS
    split = mesh is not None and mesh.size > 1
    dev = data.device
    flags = PATHS["production"][0]
    out = {}

    def host(fields):
        return {k: v.cpu() for k, v in fields.items()}

    def shard(st):
        return pmesh.shard_chain_states(st, mesh) if split else st

    def whole(st):
        st = pmesh.gather_chain_states(st, mesh) if split else st
        return host({f: getattr(st, f) for f in STATE_FIELDS})

    def chains(v):
        return (mesh.gather(v) if split else v).cpu()

    def local_unc(unc, split_chains=True):
        """The rank's chains (with ``split_chains``) and rows of ``unc``."""
        if not split:
            return unc
        axis = pmesh.CHAIN_AXIS if split_chains else None
        return logjoint.UncState(**{
            f: pmesh.NamedSharding(mesh, (axis, pmesh.DATA_AXIS) if f in
                                   logjoint.ROW_FIELDS else (axis,)).place(t)
            for f, t in vars(unc).items()})

    def timed(name, steps, fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        before = (mesh.collectives, mesh.collective_seconds) if split \
            else (0, 0.0)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        res.update(seconds=time.perf_counter() - t0, steps=steps,
                   launches=dict(kernels.LAUNCHES),
                   collectives=((mesh.collectives - before[0],
                                 mesh.collective_seconds - before[1])
                                if split else (0, 0.0)))
        out[name] = res

    def run_smc():
        g = torch.Generator(device=dev).manual_seed(m["seed"] + 1)
        with _First(smc, "smc_stage", lambda a, o: o) as first:
            r = smc.run_smc(g, shard(x["particles"]), data, hp, c,
                            max_stages=m["smc_stages"], **flags)
        particles, log_w, beta, _ = first.value
        return {"first": whole(particles),
                "first_stage": {"beta": beta.cpu(), "log_w": log_w.cpu()},
                "final": {"particles": whole(r.particles),
                          "log_weights": r.log_weights.cpu(),
                          "log_evidence": r.log_evidence.cpu(),
                          "final_beta": r.final_beta.cpu(),
                          "n_stages": r.n_stages},
                "mine": host({f: getattr(r.particles, f)
                              for f in MESH_GLOBAL}),
                "gen": g.get_state().cpu()}

    unc = local_unc(x["hmc"])
    lj = logjoint.FlatLogJoint(
        logjoint.make_log_joint(data, hp, c),
        logjoint.UncState(**{f: t[:1] for f, t in vars(unc).items()}), False)
    q0 = logjoint.flatten(unc, False)

    def run_gradient(method):
        if split:       # the positions' chains are the ensemble's
            mesh.n_chains = m["hmc_chains"]
        slots = lj.slots()
        g = torch.Generator(device=dev).manual_seed(m["seed"] + 2)
        if method == "hmc":
            spy = _First(hmc, "hmc_kernel", lambda a, o: o[0].position, True)
            run, kw = hmc.run_hmc, dict(n_leapfrog=m["hmc_steps"])
        else:
            spy = _First(nuts, "nuts_kernel", lambda a, o: o[0][0], True)
            run, kw = nuts.run_nuts, dict(max_depth=m["nuts_depth"])
        with spy:
            qs, diag = run(g, lj, q0, n_warmup=m["hmc_warmup"],
                           n_samples=m["hmc_samples"],
                           init_step_size=m["hmc_init_step"], **kw)
        return {"first": slots.gather(spy.value).cpu(),
                "start": slots.gather(q0).cpu(),
                "final": {"trace": slots.gather(qs).cpu(),
                          **{k: chains(v) for k, v in diag.items()}},
                "mine": {"trace": (qs if slots.glob is None
                                   else qs[..., slots.glob]).cpu()},
                "gen": g.get_state().cpu()}

    def run_advi():
        g = torch.Generator(device=dev).manual_seed(m["seed"] + 3)
        with _First(advi, "_advi_step", lambda a, o: [
                p.detach().clone() for p in a[1]]) as first:
            r = advi.run_advi(g, logjoint.make_log_joint(data, hp, c),
                              local_unc(x["advi"], False),
                              n_steps=m["advi_steps"], n_mc=m["advi_mc"],
                              learning_rate=m["advi_lr"],
                              covariate_cov=False)
        slots = logjoint.rank_slots(r.like, False)
        mu = logjoint.flatten(r.mean, False)[0]
        glob = slice(None) if slots.glob is None else slots.glob
        return {"first": {k: slots.gather(v[None], None)[0].cpu()
                          for k, v in zip(("mu", "log_sd"), first.value)},
                "final": {"mu": slots.gather(mu[None], None)[0].cpu(),
                          "log_sd": slots.gather(r.log_sd_flat[None],
                                                 None)[0].cpu(),
                          "elbo": r.elbo_trace.cpu()},
                "mine": {"mu": mu[glob].cpu(),
                         "log_sd": r.log_sd_flat[glob].cpu()},
                "gen": g.get_state().cpu()}

    def run_sweeps():
        g = torch.Generator(device=dev).manual_seed(m["seed"] + 4)
        r = drivers.phase_warm_start(g, shard(x["sweep"]), data, hp, c,
                                     n_iters=m["sweeps"],
                                     hmc_inv_mass=x["inv_mass"], **flags,
                                     **m["sweep_flags"])
        return {"first": whole(GibbsState(**{f: r.traces[f][:, 0]
                                             for f in STATE_FIELDS})),
                "final": {"state": whole(r.final_state),
                          "loglik": chains(r.loglik[:, -1])},
                "mine": host({f: getattr(r.final_state, f)
                              for f in MESH_GLOBAL}),
                "gen": g.get_state().cpu()}

    timed("smc", m["smc_stages"], run_smc)
    iters = m["hmc_warmup"] + m["hmc_samples"]
    timed("hmc", iters, lambda: run_gradient("hmc"))
    timed("nuts", iters, lambda: run_gradient("nuts"))
    timed("advi", m["advi_steps"], run_advi)
    timed("hmc_sweep", m["sweeps"], run_sweeps)
    return out


def _same_tree(a, b):
    """Equal bits in every tensor of two nests of dicts and lists (and
    equal numbers elsewhere)."""
    if isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k])
                                            for k in b)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_same_tree, a, b))
    if isinstance(b, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _max_diffs(a, b):
    """max |a - b| by field of two tensors or dicts of them."""
    if not isinstance(b, dict):
        a, b = {"x": a}, {"x": b}
    return {k: (a[k] - v).abs().max().item() for k, v in b.items()
            if v.numel()}


def _share_within(a, b, scaled=True):
    """(share of the chains of ``b`` (a tensor whose first axis is the
    chains, or a dict of them) whose every entry in ``a`` lies within
    MESH_ATOL, the chains past it); ``scaled``: MESH_ATOL times the
    entry's magnitude where that passes 1."""
    if not isinstance(b, dict):
        a, b = {"x": a}, {"x": b}
    C = next(iter(b.values())).shape[0]
    bad = torch.zeros(C, dtype=torch.bool)
    for k, v in b.items():
        if v.numel():
            tol = MESH_ATOL * (v.abs().clamp(min=1.0) if scaled else 1.0)
            bad |= ((a[k] - v).abs() > tol).reshape(C, -1).any(1)
    return 1.0 - bad.float().mean().item(), torch.nonzero(bad).flatten(
        ).tolist()


def _smc_ulp_control(data, hp, c, x):
    """SMC's first stage in one process from the protocol's particles and
    from the same particles moved by one float32 ulp (every entry of every
    field but the simplices Z and pi): what float32 rounding alone does to
    the stage.  Returns both stages' particles on the host."""
    from bayesfmmm_torch.models.state import GibbsState
    out = []
    for bump in (False, True):
        p = x["particles"]
        if bump:
            p = GibbsState(**{f: v if f in ("Z", "pi") else torch.nextafter(
                v, torch.full_like(v, float("inf")))
                for f, v in ((f, getattr(p, f)) for f in STATE_FIELDS)})
        g = torch.Generator(device=data.device).manual_seed(
            MESH_SAMPLERS["seed"] + 1)
        r = smc.run_smc(g, p, data, hp, c, max_stages=1,
                        **PATHS["production"][0])
        out.append({f: getattr(r.particles, f).cpu() for f in STATE_FIELDS})
    return out


def _off_chains(a, b, chains):
    """For ``chains`` of the dicts ``a`` and ``b``: field -> (max |a - b|,
    max |b|) where the field passes MESH_ATOL, relative above 1."""
    out = {}
    for k, v in b.items():
        if not v.numel() or not chains:
            continue
        d = (a[k][chains] - v[chains]).abs()
        if bool((d > MESH_ATOL * v[chains].abs().clamp(min=1.0)).any()):
            out[k] = (d.max().item(), v[chains].abs().max().item())
    return out


def _sampler_setup(data, hp, c, x):
    """Library set-up for the samplers, outside any mesh and on a
    throwaway generator: two ADVI steps, a gradient of the log-joint and
    torch.optim's first step (which imports and builds what later steps
    reuse), so that no sampler's time holds them."""
    from bayesfmmm_torch.models import logjoint
    from bayesfmmm_torch.samplers import advi
    advi.run_advi(torch.Generator(device=data.device).manual_seed(1),
                  logjoint.make_log_joint(data, hp, c), x["advi"],
                  n_steps=2, covariate_cov=False)
    torch.cuda.synchronize()


def mesh_samplers_check(split, got, per_rank, ref, ref_path):
    """Slice 18's samplers over two ranks (``got``, rank 0's whole results;
    ``per_rank``, each rank's own) held to one process's ``ref``
    (``_sampler_runs``' results): after the first transition MESH_SHARE of
    the chains within MESH_ATOL, relative where a value passes 1, in every
    field (ADVI, which has no chains, its whole position; SMC, whose first
    stage mutates the prior's draws, at least the share one process keeps
    from particles one float32 ulp away, ``_smc_ulp_control``, and its
    first stage's beta and weights within the atol; HMC's and NUTS's first
    transition moving a chain); SMC's stage count and HMC's trajectory
    lengths equal; each rank's launches one process's; every rank's
    generator in one process's state; with rows split, the data group's
    global fields and slots the same bits on both ranks; the HMC-step
    sweep's medians
    inside the production path's JAX limits (``ref_path``).  Returns the
    split's numbers by sampler."""
    numbers = {}
    for name, want in ref.items():
        mine = got[name]
        if name == "advi":       # one position, no chains
            near = min(_share_within(mine["first"][k][None], v[None])[0]
                       for k, v in want["first"].items())
            near_abs = min(_share_within(mine["first"][k][None], v[None],
                                         False)[0]
                           for k, v in want["first"].items())
            off = [] if near == 1.0 else ["the position"]
        else:
            near, off = _share_within(mine["first"], want["first"])
            near_abs = _share_within(mine["first"], want["first"], False)[0]
        worst = _max_diffs(mine["first"], want["first"])
        stage, bar = "", MESH_SHARE
        if name == "smc":
            # the first stage's reweighting reads the split's gathered
            # logliks; its mutation from the prior's draws moves a value by
            # ~1e-3 of itself on a last-bit change, so the particles are
            # held to what one ulp of the particles does in one process
            a, b = mine["first_stage"], want["first_stage"]
            plain, bumped = want["ulp_control"]
            control, control_off = _share_within(bumped, plain)
            bar = min(MESH_SHARE, control)
            check(_share_within(a["beta"][None], b["beta"][None])[0] == 1.0
                  and _share_within(a["log_w"][None], b["log_w"][None])[0]
                  == 1.0, f"mesh {split} smc: the first stage's beta or log "
                          f"weights differ from one process's past the atol")
            w_diff = _max_diffs(a["log_w"], b["log_w"])["x"]
            split_off = _off_chains(mine["first"], want["first"], off)
            ulp_off = _off_chains(bumped, plain, control_off)
            stage = (f"; the first stage's beta {float(a['beta'])!r} (one "
                     f"process {float(b['beta'])!r}), its log weights "
                     f"{w_diff:.3g} apart; the split's chains past the "
                     f"atol, field (max |diff|, max |value|): {split_off}; "
                     f"one process from the particles one ulp away: "
                     f"{control:.4f} of the chains within the atol "
                     f"(relative above 1), past it {ulp_off}; the "
                     f"control's unmoved run equals the protocol's first "
                     f"stage: {_same_tree(plain, want['first'])}")
        if name in ("hmc", "nuts"):
            moved = (want["first"] != want["start"]).any(1).float().mean()
            stage = f"; the first transition moved {moved:.4f} of the chains"
            check(moved > 0, f"mesh {split} {name}: the first transition "
                             f"moved no chain, so it compares nothing")
        print(f"  mesh {split} {name} first transition: {near_abs:.4f} of "
              f"the chains within {MESH_ATOL} of one process's in absolute "
              f"terms; max |diff| by field "
              + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + stage)
        check(near >= bar, f"mesh {split} {name}: only {near} of the chains "
                           f"within {MESH_ATOL} of one process's after the "
                           f"first transition, {bar} expected (past it: "
                           f"{off})")
        for r, res in enumerate(per_rank):
            check(torch.equal(res["gen"][name], want["gen"]),
                  f"mesh {split} {name}: rank {r}'s generator is not in "
                  f"one process's state")
            check(res["launches"][name] == want["launches"],
                  f"mesh {split} {name}: rank {r} launched "
                  f"{res['launches'][name]}, one process {want['launches']}")
            if MESH_SPLITS[split] > 1:
                for k, v in per_rank[0]["mine"][name].items():
                    check(torch.equal(res["mine"][name][k], v),
                          f"mesh {split} {name}: rank {r}'s global {k} "
                          f"differs from rank 0's")
        unit, _ = MESH_SAMPLER_UNITS[name]
        steps = want["steps"]
        coll = [res["collectives"][name] for res in per_rank]
        numbers[name] = {
            "unit": unit, "first_share_within_atol": near, "first_off": off,
            "first_share_within_atol_absolute": near_abs,
            "first_share_required": bar,
            "first_max_abs": worst,
            "ms_one_rank": 1e3 * want["seconds"] / steps,
            "ms_two_ranks_sharing": 1e3 * mine["seconds"] / steps,
            "collectives_per_unit": [n / steps for n, _ in coll],
            "collective_ms_per_unit": [1e3 * t / steps for _, t in coll],
            "launches_a_rank": want["launches"]}
    check(got["smc"]["final"]["n_stages"] == ref["smc"]["final"]["n_stages"],
          f"mesh {split} smc: {got['smc']['final']['n_stages']} stages, one "
          f"process {ref['smc']['final']['n_stages']}")
    check(torch.equal(got["hmc"]["final"]["n_steps"],
                      ref["hmc"]["final"]["n_steps"]),
          f"mesh {split} hmc: other trajectory lengths than one process's")
    limits = json.loads(ref_path.read_text())
    sweep = got["hmc_sweep"]["final"]
    med = {"loglik": sweep["loglik"].median().item(),
           "sigma2": float(np.median(sweep["state"]["sigma2"].numpy()))}
    for stat, v in med.items():
        lo, hi = limits[stat]["limits"]
        check(lo <= v <= hi, f"mesh {split} hmc_sweep: {stat} median {v} "
                             f"outside [{lo}, {hi}]")
    numbers["hmc_sweep"]["medians"] = med
    for name, v in numbers.items():
        print(f"  mesh {split} {name}: {v['first_share_within_atol']:.4f} of "
              f"the chains within {MESH_ATOL} (relative above 1) of one "
              f"process's after the first transition (past it: "
              f"{v['first_off']}); ms a "
              f"{v['unit']} {v['ms_one_rank']:.3f} in one process, "
              f"{v['ms_two_ranks_sharing']:.3f} at rank 0 of two sharing "
              f"the card (gloo; sharing, not scaling); collectives a "
              f"{v['unit']} by rank {v['collectives_per_unit']}, their ms "
              f"on the host's clock "
              + ", ".join(f"{x:.3f}" for x in v["collective_ms_per_unit"])
              + f"; launches a rank {v['launches_a_rank']}")
    print(f"  mesh {split} samplers: every rank's generator in one "
          f"process's state after each, its launches one process's; SMC "
          f"{got['smc']['final']['n_stages']} stages as one process's, HMC's "
          f"trajectory lengths one process's; NUTS depths of the first "
          f"chains {got['nuts']['final']['depth'][:4].tolist()}; the "
          f"HMC-step sweep's medians {med} inside {ref_path.name}'s limits "
          f"after {MESH_SAMPLERS['sweeps']} sweeps; SMC, HMC, NUTS and ADVI "
          f"run too few steps here for the JAX limits of phases 10-12 (a "
          f"whole run's statistics), which are not read")
    return numbers


def mesh_rank(start, out, ckpt, rows=1):
    """A rank of the mesh phase's split runs (dryrun.run_ranks, two ranks
    on the one card through gloo), on a mesh of ``rows`` data shards: its
    chains and rows of the start ensemble and of the data, the protocol
    under ``with mesh:``, then slice 18's samplers (``_sampler_runs``);
    the first rank saves the gathered results to ``out``, every rank its
    own global fields, and its samplers' generator states, launches and
    collectives, to ``out`` + ".<rank>", and every rank prints its launch
    counts (also by shape) and collectives."""
    from bayesfmmm_torch.models.state import GibbsState
    from bayesfmmm_torch.parallel import mesh as pmesh

    gibbs.use_full_f32()
    mesh = pmesh.make_mesh(n_data_shards=rows)   # cuda:0 for both on one card
    dev = mesh.device
    data, hp, c = _mesh_data(dev)
    st, g, _, _ = load_checkpoint(start, dev)
    x = _sampler_inputs(data, st)
    _sampler_setup(data, hp, c, x)
    data = pmesh.shard_data(data, mesh)
    flags = PATHS["production"][0]
    pt_states = take_chains(st, torch.arange(MESH_PROTOCOL["pt_replicas"],
                                             device=dev))
    local = pmesh.shard_chain_states(st, mesh)
    # library set-up on a throwaway generator, outside the mesh
    gibbs.sweep_full(torch.Generator(device=dev).manual_seed(1), local, data,
                     hp, c, **flags)
    with mesh, ShapeProbe() as probe:
        res, seconds, counts, coll, after_local, pt = _mesh_runs(
            g, local, data, hp, c, flags, pt_states, mesh, ckpt)
        first_local = GibbsState(**{f: res.traces[f][:, 0]
                                    for f in STATE_FIELDS})
        first = pmesh.gather_chain_states(first_local, mesh)
        final = pmesh.gather_chain_states(res.final_state, mesh)
        after = pmesh.gather_chain_states(after_local, mesh)
        loglik = mesh.gather(res.loglik[:, -1])
        samplers = _sampler_runs(data, hp, c, x, mesh)
    cold, pt_state, rate = pt
    torch.save({"globals": {f"{what} {f}": getattr(v, f).cpu()
                            for f in MESH_GLOBAL
                            for what, v in (("first", first_local),
                                            ("final", res.final_state),
                                            ("after", after_local))},
                **{k: {name: v[k] for name, v in samplers.items()}
                   for k in ("mine", "gen", "launches", "collectives")}},
               f"{out}.{mesh.rank}")
    if mesh.rank == 0:
        torch.save({
            "first": {f: getattr(first, f).cpu() for f in STATE_FIELDS},
            "final": {f: getattr(final, f).cpu() for f in STATE_FIELDS},
            "after": {f: getattr(after, f).cpu() for f in STATE_FIELDS},
            "loglik": loglik.cpu(), "seconds": seconds,
            "pt_counts": [pt_state.swap_accepts.item(),
                          pt_state.swap_attempts.item()],
            "pt_cold_sigma2": cold.sigma2.cpu(),
            "samplers": {name: {k: v[k] for k in v if k not in (
                "mine", "gen", "launches", "collectives")}
                for name, v in samplers.items()}}, out)
    print("RANK " + json.dumps({
        "rank": mesh.rank, "rows": [data.N, data.N_whole], "counts": counts,
        "shapes": [[k, list(shape), n] for (k, shape), n
                   in probe.counts.items()],
        "collectives": coll[0], "collective_seconds": coll[1],
        "seconds": seconds}), flush=True)


def mesh_chains_within(a, b):
    """(share of the chains whose every field in ``a`` lies within
    MESH_ATOL of ``b``, {chain: the fields past it} for the others); a and b
    map the state's fields to whole-ensemble tensors on the host."""
    past = {f: ((a[f] - b[f]).abs().reshape(CHAINS, -1) > MESH_ATOL).any(1)
            for f in STATE_FIELDS if b[f].numel()}
    bad = torch.stack(list(past.values())).any(0)
    return (1.0 - bad.float().mean().item(),
            {c: [f for f, v in past.items() if v[c]]
             for c in torch.nonzero(bad).flatten().tolist()})


def mesh_split(dev, split, start, tmp, ref_run, ref_samplers, data, hp, c):
    """One split run of the mesh phase: two ranks on the one card through
    gloo, splitting the chains (128 a rank) or the data (50 rows a rank),
    held to the one-process runs ``ref_run`` (the sweeps, checkpoint and
    PT) and ``ref_samplers`` (slice 18's).  Returns (each rank's launch
    counts, rank 0's launches by shape, the split's numbers)."""
    from bayesfmmm_torch.dryrun import run_ranks

    m = MESH_PROTOCOL
    rows = MESH_SPLITS[split]
    flags, ref_path, per_sweep = PATHS["production"]
    ref = json.loads(ref_path.read_text())
    out, ckpt = tmp / f"{split}.pt", tmp / f"{split}_ckpt.npz"
    t_ranks = time.perf_counter()
    logs = run_ranks(m["ranks"], f"{Path(__file__).resolve()}:mesh_rank",
                     {"start": str(start), "out": str(out),
                      "ckpt": str(ckpt), "rows": rows},
                     device="cuda", timeout=m["timeout"])
    ranks_s = time.perf_counter() - t_ranks
    got = torch.load(out)
    lines = [json.loads(ln[5:]) for log in logs for ln in log.splitlines()
             if ln.startswith("RANK ")]
    check(len(lines) == m["ranks"], f"mesh {split}: rank lines {lines}")
    rank_counts = {f"mesh {split} rank {ln['rank']}": ln["counts"]
                   for ln in lines}
    for name, cts in rank_counts.items():
        for k, n in per_sweep.items():
            check(cts[k] == n * m["sweeps"],
                  f"mesh: {name} launched {k} {cts[k]} times in "
                  f"{m['sweeps']} sweeps, expected {n} a sweep")
    N = PROTOCOL["N"]
    for ln in lines:
        check(ln["rows"] == [N // rows, N],
              f"mesh {split}: rank {ln['rank']} held rows {ln['rows']}")
    shapes = {(k, tuple(shape)): n for k, shape, n in
              next(ln for ln in lines if ln["rank"] == 0)["shapes"]}
    per_rank = [torch.load(f"{out}.{r}") for r in range(m["ranks"])]
    if rows > 1:
        # every rank of the data group holds the same bits of every field
        # that is not split by rows
        for k, v in per_rank[0]["globals"].items():
            for r in range(1, m["ranks"]):
                check(torch.equal(per_rank[r]["globals"][k], v),
                      f"mesh {split}: rank {r}'s {k} differs from rank 0's")
        print(f"  mesh {split}: the global fields of the first sweep, the "
              f"last and the one after the checkpoint hold the same bits "
              f"on both ranks; launches by shape (rank 0) {shapes}")

    # the first sweep against one process, in every field, chain by chain
    ref_first = {f: ref_run[0].traces[f][:, 0].cpu() for f in STATE_FIELDS}
    worst = {f: (got["first"][f] - ref_first[f]).abs().max().item()
             if ref_first[f].numel() else 0.0 for f in STATE_FIELDS}
    near, off = mesh_chains_within(got["first"], ref_first)
    print(f"  mesh {split} first sweep: {near:.4f} of the chains within "
          f"{MESH_ATOL} of one process's in every field; the others, with "
          f"the fields past it: {off}; max |diff| by field "
          + ", ".join(f"{f} {e:.3g}" for f, e in worst.items() if e))
    check(near >= MESH_SHARE, f"mesh {split}: only {near} of the chains' "
                              f"first sweeps within {MESH_ATOL}")
    ref_final = {f: getattr(ref_run[0].final_state, f).cpu()
                 for f in STATE_FIELDS}
    same = torch.ones(CHAINS, dtype=torch.bool)
    first_equal = torch.ones(CHAINS, dtype=torch.bool)
    for f in STATE_FIELDS:
        same &= (got["final"][f] == ref_final[f]).reshape(CHAINS, -1).all(1)
        first_equal &= (got["first"][f] == ref_first[f]).reshape(
            CHAINS, -1).all(1)
    # the medians after the last sweep, in the production path's limits
    med = {"loglik": got["loglik"].median().item(),
           "sigma2": float(np.median(got["final"]["sigma2"].numpy()))}
    for stat, v in med.items():
        lo, hi = ref[stat]["limits"]
        check(lo <= v <= hi, f"mesh {split}: the split run's {stat} median "
                             f"{v} outside [{lo}, {hi}]")
        print(f"  mesh {split} {stat}: split median {v:.6g} after "
              f"{m['sweeps']} sweeps, limits [{lo:.6g}, {hi:.6g}] "
              f"({ref_path.name})")
    # PT: the chain split takes one process's swaps (its energies are one
    # process's bits); the data split sums each energy over two ranks, so
    # a swap may flip and only the attempts must agree
    cold, pt_state, _ = ref_run[5]
    pt_counts = [pt_state.swap_accepts.item(), pt_state.swap_attempts.item()]
    check((got["pt_counts"] == pt_counts) if rows == 1 else
          got["pt_counts"][1] == pt_counts[1]
          and bool(torch.isfinite(got["pt_cold_sigma2"]).all()),
          f"mesh {split}: split PT's swap counts {got['pt_counts']} against "
          f"one process's {pt_counts}")
    pt_err = (got["pt_cold_sigma2"] - cold.sigma2.cpu()).abs().max().item()
    # the checkpoint the two ranks wrote, read back here: the whole
    # ensemble, resumed for one sweep
    st, g, it, _ = load_checkpoint(ckpt, dev)
    check(it == m["sweeps"], f"mesh {split}: the ranks' checkpoint is at "
                             f"{it}")
    for f in STATE_FIELDS:
        check(tuple(getattr(st, f).shape) == tuple(got["final"][f].shape)
              and torch.equal(getattr(st, f).cpu(), got["final"][f]),
              f"mesh {split}: the ranks' checkpoint holds another {f}")
    resumed = drivers.phase_warm_start(g, st, data, hp, c, n_iters=1,
                                       start_iter=m["sweeps"], **flags)
    resumed = {f: getattr(resumed.final_state, f).cpu()
               for f in STATE_FIELDS}
    resume_near, resume_off = mesh_chains_within(resumed, got["after"])
    check(resume_near >= MESH_SHARE and all(
        bool(torch.isfinite(v).all()) for v in resumed.values()),
        f"mesh {split}: only {resume_near} of the chains' resumed sweeps "
        f"within {MESH_ATOL} of the ranks' own")
    samplers = mesh_samplers_check(split, got["samplers"], per_rank,
                                   ref_samplers, ref_path)
    for name in samplers:
        for r, res in enumerate(per_rank):
            rank_counts[f"mesh {split} {name} rank {r}"] = \
                res["launches"][name]
    coll_ms = [1e3 * ln["collective_seconds"] / m["sweeps"] for ln in lines]
    coll_n = [ln["collectives"] / m["sweeps"] for ln in lines]
    split_ms = 1e3 * got["seconds"] / m["sweeps"]
    per_rank = (f"{CHAINS // m['ranks']} chains of {N} rows" if rows == 1
                else f"{CHAINS} chains of {N // rows} rows")
    print(f"  mesh {split} split: {m['ranks']} ranks sharing the one card "
          f"(gloo; sharing, not scaling), {per_rank} each; chains bit-equal "
          f"after 1 sweep {first_equal.float().mean():.4f}, after "
          f"{m['sweeps']} {same.float().mean():.4f}; launches a rank "
          f"{rank_counts}; ms a sweep at rank 0 {split_ms:.3f}; collectives "
          f"a sweep by rank {coll_n}, their ms on the host's clock "
          f"{', '.join(f'{x:.3f}' for x in coll_ms)}; PT "
          f"{m['pt_replicas']} replicas x {m['pt_rounds']} rounds swap "
          f"counts {got['pt_counts']} (one process {pt_counts}), cold sigma2 "
          f"max diff {pt_err:.3g}; resumed sweep {resume_near:.4f} of the "
          f"chains within the atol (the others {resume_off}); ranks "
          f"{ranks_s:.1f} s from start to exit")
    return rank_counts, shapes, {
        "rows_a_rank": N // rows,
        "chains_a_rank": CHAINS // m["ranks"] if rows == 1 else CHAINS,
        "first_sweep_max_abs": worst,
        "bit_equal_share_first": first_equal.float().mean().item(),
        "bit_equal_share_last": same.float().mean().item(), "medians": med,
        "ms_per_sweep_two_ranks_sharing": split_ms,
        "collectives_per_sweep": coll_n, "collective_ms_per_sweep": coll_ms,
        "pt_swap_counts": got["pt_counts"], "pt_swap_counts_one": pt_counts,
        "pt_cold_sigma2_max_abs": pt_err,
        "first_sweep_share_within_atol": near, "first_sweep_off": off,
        "resume_share_within_atol": resume_near,
        "launches_by_rank": rank_counts, "ranks_seconds": ranks_s,
        "samplers": samplers}


def mesh_phase(dev, card, start_state):
    """Slices 16 and 17: the production census over a (chains, data) mesh
    on the card, from ``start_state`` (the production path's final
    256-chain ensemble).  (a) A 1 x 1 mesh over NCCL: the protocol's sweeps
    under ``with mesh:`` give the bits of the same sweeps without it.
    (b) Two ranks on the one card through gloo splitting the chains, 128
    each, then (c) splitting the data's 100 rows, 50 each with all 256
    chains (``mesh_split``): the first sweep within JAX's atol of one
    process in every field in MESH_SHARE of the chains, the medians after
    the last inside the production path's JAX limits, the launches a sweep,
    the checkpoint read back here; the chain split also PT's swap counts,
    the data split also every global field's bits equal on both ranks and
    K2 and K3 against their plain versions at the rank's shapes.  Then
    slice 18's samplers (``_sampler_runs``: SMC, HMC, NUTS, ADVI and the
    HMC-step sweep) in one process, under the 1 x 1 mesh (the same bits,
    generators and launches) and in both splits' ranks
    (``mesh_samplers_check``), and K2's backward at a rank's rows against
    its plain version, timed.  Returns (each rank's launch counts, the data
    split's launches by shape, the kernels line's entries of K2's backward
    at a rank's rows, the phase's numbers)."""
    import torch.distributed as dist

    from bayesfmmm_torch.parallel import mesh as pmesh

    m = MESH_PROTOCOL
    t_phase = time.perf_counter()
    flags, ref_path, per_sweep = PATHS["production"]
    data, hp, c = _mesh_data(dev)
    R = m["pt_replicas"]
    with tempfile.TemporaryDirectory(prefix="bfmmm_mesh_") as tmp:
        tmp = Path(tmp)
        start = tmp / "start.npz"
        save_checkpoint(start, start_state,
                        torch.Generator(device=dev).manual_seed(m["seed"]))

        def one_process(mesh=None):
            st, g, _, _ = load_checkpoint(start, dev)
            pt_states = take_chains(st, torch.arange(R, device=dev))
            if mesh is None:
                return _mesh_runs(g, st, data, hp, c, flags, pt_states)
            with mesh:
                return _mesh_runs(g, pmesh.shard_chain_states(st, mesh),
                                  data, hp, c, flags, pt_states, mesh)

        def samplers(mesh=None):
            x = _sampler_inputs(data, load_checkpoint(start, dev)[0])
            if mesh is None:
                control = _smc_ulp_control(data, hp, c, x)
                runs = _sampler_runs(data, hp, c, x)
                runs["smc"]["ulp_control"] = control
                return runs
            with mesh:
                return _sampler_runs(data, hp, c, x, mesh)

        # library set-up, then (a): one process under a 1 x 1 NCCL mesh
        gibbs.sweep_full(torch.Generator(device=dev).manual_seed(1),
                         start_state, data, hp, c, **flags)
        events = graph_events()
        ref_run = one_process()
        # in one process the sweeps replay a captured sweep (after one
        # eager sweep and the capture), the one after the checkpoint too;
        # under a mesh they run eagerly
        ref_counted = counted_sweeps("mesh, one process",
                                     graph_events(events), m["sweeps"] + 1)
        _sampler_setup(data, hp, c, _sampler_inputs(data, start_state))
        ref_samplers = samplers()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl",
                                world_size=1, rank=0)
        try:
            one = pmesh.make_mesh(devices=dev)
            check(one.shape == {"chains": 1, "data": 1},
                  f"mesh: one process gave the mesh {one.shape}")
            under = one_process(one)
            under_samplers = samplers(one)
        finally:
            dist.destroy_process_group()
        for name, want in ref_samplers.items():
            check(_same_tree(under_samplers[name]["first"], want["first"])
                  and _same_tree(under_samplers[name]["final"],
                                 want["final"])
                  and torch.equal(under_samplers[name]["gen"], want["gen"])
                  and under_samplers[name]["launches"] == want["launches"],
                  f"mesh: the 1 x 1 NCCL mesh changed {name}'s bits, "
                  f"generator or launches")
        print(f"  mesh (a) samplers: SMC, HMC, NUTS, ADVI and the HMC-step "
              f"sweep under the 1 x 1 mesh: the bits, generator states and "
              f"launches of the same runs without it")
        for f in STATE_FIELDS:
            check(torch.equal(getattr(under[0].final_state, f),
                              getattr(ref_run[0].final_state, f))
                  and torch.equal(under[0].traces[f], ref_run[0].traces[f]),
                  f"mesh: the 1 x 1 NCCL mesh changed {f}")
        check(torch.equal(under[0].loglik, ref_run[0].loglik),
              "mesh: the 1 x 1 NCCL mesh changed the loglik")
        check(torch.equal(under[5][0].sigma2, ref_run[5][0].sigma2)
              and torch.equal(under[5][2], ref_run[5][2]),
              "mesh: the 1 x 1 NCCL mesh changed PT")
        for k, n in per_sweep.items():
            check(ref_run[2][k] == n * ref_counted
                  and under[2][k] == n * m["sweeps"],
                  f"mesh: one process launched {k} {ref_run[2][k]} times in "
                  f"{ref_counted} counted sweeps and the 1 x 1 mesh "
                  f"{under[2][k]} in {m['sweeps']}, expected {n} a sweep")
        print(f"  mesh (a): {m['sweeps']} production sweeps of {CHAINS} "
              f"chains under a 1 x 1 mesh over NCCL (eager): the bits of the "
              f"same sweeps replayed without it")

        # (b) and (c): two ranks on the one card through gloo
        counts, numbers, data_shapes = {}, {}, {}
        for split in MESH_SPLITS:
            cts, shapes, numbers[split] = mesh_split(
                dev, split, start, tmp, ref_run, ref_samplers, data, hp, c)
            counts.update(cts)
            if MESH_SPLITS[split] > 1:
                data_shapes = shapes
    # K2 and K3 against their plain versions at the data split's shapes:
    # N/2 rows, the sweep's C and 2C chain rows and update_nu's 3C, PT's R
    # and 2R rows and 3R, and slice 18's: HMC's, NUTS's and the HMC-step
    # sweep's 64 chains (2 x 64 rows and 3 x 64 in the sweep) and ADVI's
    # 4 draws; K2's backward at those 64 and 4 rows
    g = torch.Generator(device=dev).manual_seed(17)
    n2, K = PROTOCOL["N"] // MESH_SPLITS["data"], PROTOCOL["K"]
    H = MESH_SAMPLERS["hmc_chains"]
    k2_shapes = tuple((C1, n2, 100, PROTOCOL["P"], None)
                      for C1 in (CHAINS, 2 * CHAINS, R, 2 * R, H, 2 * H,
                                 MESH_SAMPLERS["advi_mc"]))
    k3_shapes = ((K * CHAINS, n2, PROTOCOL["P"]), (K * R, n2, PROTOCOL["P"]),
                 (K * H, n2, PROTOCOL["P"]))
    for k, shape in data_shapes:
        check(k == "chol_solve" or shape in (
            [s[:4] for s in k2_shapes] if k != "weighted_gram"
            else list(k3_shapes))
            and (k != "mean_rss_grad" or shape in MESH_GRAD_SHAPES),
            f"mesh data: rank 0 launched {k} at {shape}, a shape the "
            f"smoke does not hold to its plain version")
    k2_phase(dev, g, k2_shapes)
    k3_phase(dev, g, k3_shapes)
    grad_err = k2_grad_phase(dev, g, MESH_GRAD_SHAPES)
    entries = []
    for C1, N1, L1, P1 in MESH_GRAD_SHAPES:
        x = (torch.randn(N1, L1, P1, generator=g, device=dev),
             torch.randn(N1, L1, generator=g, device=dev),
             torch.randn(C1, N1, P1, generator=g, device=dev),
             torch.randn(C1, generator=g, device=dev))
        cands = {"kernel": lambda x=x: kernels.mean_rss_grad(*x),
                 "plain": lambda x=x: kernels.mean_rss_grad_plain(*x),
                 "empty": lambda: kernels.empty_launch(dev)}
        t = {k: r["device_ms"] for k, r in in_turns(cands, rounds=3).items()}
        t.update(kernels.kernel_bound("mean_rss_grad", C=C1, N=N1, L=L1,
                                      P=P1))
        launched = data_shapes.get(("mean_rss_grad", (C1, N1, L1, P1)), 0)
        check(launched > 0, f"mesh data: rank 0 never launched K2's "
                            f"backward at {(C1, N1, L1, P1)}")
        print(f"  mean_rss_grad at a rank's rows (C={C1}, N={N1}, L={L1}, "
              f"P={P1}): device {1e3 * t['kernel']:.2f} us vs plain "
              f"{1e3 * t['plain']:.2f} us, empty kernel "
              f"{1e3 * t['empty']:.2f} us; bound {1e3 * t['bound_ms']:.3f} us "
              f"by {t['bound_by']} ({t['bytes']} bytes, {t['flop']:.0f} "
              f"FLOP; {100 * t['bound_ms'] / t['kernel']:.2f} % of it); "
              f"{launched} launches at rank 0 of the data split")
        entries.append({
            "name": f"mean_rss_grad_n{N1}_c{C1}", "route": "cuda",
            "source": "bayesfmmm_torch/csrc/mean_rss.cu",
            "replaces": "bayesfmmm_tpu/ops/pallas_kernels.py:68",
            "backward_of": "mean_rss", "launches": launched,
            "max_abs_err": grad_err, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": dict(C=C1, N=N1, L=L1, P=P1), "bytes": t["bytes"],
            "flop": t["flop"], "empty_ms": t["empty"]})
    one_ms = 1e3 * ref_run[1] / m["sweeps"]
    seconds = time.perf_counter() - t_phase
    print(f"  mesh on {card}: ms a sweep at one rank ({CHAINS} chains of "
          f"{PROTOCOL['N']} rows) {one_ms:.3f}; two ranks sharing the card, "
          f"rank 0: chains split "
          f"{numbers['chains']['ms_per_sweep_two_ranks_sharing']:.3f}, data "
          f"split {numbers['data']['ms_per_sweep_two_ranks_sharing']:.3f} "
          f"(of which collectives "
          f"{numbers['data']['collective_ms_per_sweep'][0]:.3f} on the "
          f"host's clock); the phase {seconds:.1f} s")
    return counts, data_shapes, entries, {
        "card": card, "ranks": m["ranks"], "chains": CHAINS,
        "sweeps": m["sweeps"], "ms_per_sweep_one_rank": one_ms,
        "splits": numbers, "samplers_protocol": MESH_SAMPLERS,
        "seconds": seconds}


def round_profiles(rounds):
    """Kernels and device-busy ms of a PT round and an SMC stage beside
    their ms on the host's clock."""
    prof = {}
    for k, (what, fn, ms) in rounds.items():
        v = prof[k] = dict(profile_calls(what, fn), ms=ms)
        print(f"  {k}: {ms:.3f} ms on the host's clock, "
              f"{v['kernels']:.0f} kernels and {v['device_ms']:.3f} ms of "
              f"device time ({100 * v['device_ms'] / ms:.1f} % busy)")
    return prof


def profile_calls(what, fn, reps=1):
    """Kernels and device-busy ms of one call of ``fn`` (the mean of
    ``reps``), under the profiler (which slows the host ~14x; the host ms
    of the runs are their own).  A record_function range (Adam's step) is
    no work of its own and is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the records the profiler drops at a trace's start, left out
        for _ in range(_PAD_LAUNCHES):
            torch.cuda._sleep(1)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and _PAD_KERNEL not in ev.key
              and not getattr(ev, "is_user_annotation", False)]
    n = sum(ev.count for ev in events) / reps
    busy = sum(ev.self_device_time_total for ev in events) / reps / 1e3
    top = sorted(events, key=lambda ev: -ev.self_device_time_total)[:4]
    print(f"  {what}: {n:.0f} kernels and {busy:.3f} ms of device time a "
          f"call; most of it in "
          + ", ".join(f"{ev.key[:48]} "
                      f"{ev.self_device_time_total / reps / 1e3:.3f} ms"
                      for ev in top))
    check(n > 0 and busy > 0, f"{what}: the profiler saw no device work")
    return {"kernels": n, "device_ms": busy}


def sweep_profile(dev, name, chains, flags):
    """Kernels and device-busy ms of one sweep_full of ``chains`` chains
    from a random state, under the profiler."""
    data, cfg = family_data(dev, name)
    flags = dict(flags, covariate_mean=cfg.covariate_mean,
                 covariate_cov=cfg.covariate_cov)
    g = torch.Generator(device=dev).manual_seed(5)
    c = torch.full((cfg.K,), 10.0, device=dev)
    box = [init_state(g, cfg, data, chains=chains)]

    def sweep():
        box[0] = gibbs.sweep_full(g, box[0], data, Priors(), c, **flags)

    return profile_calls(f"{name}, {chains} chains, a sweep", sweep)


def parse_phases(argv):
    """The phases to run.  ``--phases`` names them, comma-separated (they
    run in ``PHASES``' order); every phase by default.  The build runs
    whatever is asked.  The timings read every path's launch counts and
    shapes, so they run only with every phase."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="chip_smoke.py",
        description="Smoke run of bayesfmmm_torch on one NVIDIA GPU.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated, of: " + ", ".join(PHASES)
                    + " (default: all)")
    asked = {x.strip() for x in ap.parse_args(argv).phases.split(",")
             if x.strip()}
    if asked - set(PHASES):
        ap.error(f"unknown phases {sorted(asked - set(PHASES))}; the phases "
                 f"are {', '.join(PHASES)}")
    asked.add("build")
    if "timings" in asked and asked != set(PHASES):
        ap.error("the timings read every path's launch counts: run them "
                 "with every phase")
    return asked


def main(argv=None):
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    gibbs.use_full_f32()
    card = card_line()

    t0 = time.perf_counter()
    took, mark = {}, [t0]

    def lap(name):
        """Seconds since the last phase ended, under the phase's name."""
        now = time.perf_counter()
        took[name] = round(now - mark[0], 1)
        mark[0] = now

    lib = kernels.build()
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln] \
        if lib.with_suffix(".log").exists() else []
    print(f"phase 1 build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for ln in ptxas:
        print(f"  ptxas {ln}")
    lap("build")

    g = torch.Generator(device=dev).manual_seed(123)
    k1_err = k2_err = k3_err = 0.0
    if "k1" in phases:
        k1_err = k1_phase(dev, g)
        print("phase 2 K1 chol_solve vs plain: ok")
        lap("k1")
    if "k2" in phases:
        k2_err = k2_phase(dev, g)
        print("phase 3 K2 mean_rss vs plain: ok")
        lap("k2")
    if "k3" in phases:
        k3_err = k3_phase(dev, g)
        print("phase 4 K3 weighted_gram vs plain: ok")
        lap("k3")

    if "slice" in phases:
        s_seconds, s_counts, _ = path_phase(dev, "slice")
        print("phase 5 slice 1 path (reference census): ok")
        lap("slice")
    if "production" in phases:
        p_seconds, p_counts, p_final = path_phase(dev, "production")
        print("phase 6 slice 2 path (production census): ok")
        lap("production")
    if "fit" in phases:
        counts, fit_counts = fit_phase(dev, card)
        print("phase 7 slice 5 path (three-phase fit through api.fit): ok")
        lap("fit")

    if "families" in phases:
        c4_path, c4_shapes, ms4, _ = config4_phase(dev, card)
        print("phase 8 slice 6 path, config 4 (eta and xi through api.fit, K1 "
              "at D = 256): ok")
        c4d2_path, c4d2_shapes, ms4d2, c4d2_peak = config4_phase(
            dev, card, "config4_D2")
        print("phase 8 slice 14 path, config 4 at two covariates (eta and xi "
              "through api.fit, K1's panels kernel at D = 512): ok")
        c3, c3_shapes, ms3 = config3_phase(dev, card)
        print("phase 8 slice 6 path, config 3 (eta, sweep_full): ok")
        c1, _, ms1 = config1_phase(dev, card)
        print("phase 8 slice 6 path, config 1 (multivariate through "
              "api.fit): ok")
        c5, c5_shapes, ms5 = config5_phase(dev, card)
        print("phase 8 slice 6 path, config 5 (hd through api.fit): ok")
        slice6 = {"config4": c4_path, "config4_D2": c4d2_path, "config3": c3,
                  "config1": c1, "config5": c5}
        for k in KERNEL_NAMES:
            check(c4_path[k] > 0 and c4d2_path[k] > 0,
                  f"config 4's paths never launched {k}")
        lap("families")

    if "refapi" in phases:
        t9 = time.perf_counter()
        ref_counts, ref_times = ref_api_functional(dev, card)
        post_reference_phase(dev)
        fam_counts, fam_seconds = ref_api_families(dev)
        ph = ref_times["phase_s"]
        print(f"  reference API on {card}: R-named phases "
              + ", ".join(f"{k} {v:.3f} s" for k, v in ph.items())
              + f" (headline; phase 1 {REF_API['n_try'] + 1} chains, phase 2 "
              f"{REF_API['n_try']}, phase 3 one); configs 1 and 5, phases "
              f"1 / 2 / 3: "
              + ", ".join(f"{k} " + " / ".join(f"{s:.3f}" for s in v) + " s"
                          for k, v in fam_seconds.items())
              + f"; CPO at (draws, N) = {ref_times['cpo_shape']}: "
              f"{ref_times['cpo_host_ms']:.3f} ms a call on the host's clock, "
              f"{ref_times['cpo_device_ms']:.4f} ms of device time (most in "
              + ", ".join(f"{k[:40]} {v:.4f}" for k, v in ref_times["cpo_top"])
              + "); the NumPy "
              f"post-processing (FMeanCI .. Read*) "
              f"{ref_times['numpy_s']:.3f} s; the phase "
              f"{time.perf_counter() - t9:.1f} s")
        print("phase 9 slice 9 path (the reference-named API and its "
              "post-processing, CPO on the card): ok")
        lap("refapi")

    if "tempering" in phases:
        t10 = time.perf_counter()
        slice10, pt_shapes, R, rounds = tempering_phase(dev, card)
        # the kernels at the auto ladder's own length, if phases 2-4 missed it
        if R not in (1, 8, PT_PROTOCOL["max_replicas"]):
            for jitter in (0.0, 1e-6):
                k1_err = max(k1_err, *k1_case(dev, g, R, 96, jitter))
            k2_err = max(k2_err, k2_phase(dev, g, [
                (R, 100, 100, 8, None), (2 * R, 100, 100, 8, None)]))
            k3_err = max(k3_err, k3_phase(dev, g, [(3 * R, 100, 8)]))
        print(f"  the phase {time.perf_counter() - t10:.1f} s")
        print("phase 10 slice 10 paths (parallel tempering and SMC through "
              "api.fit_pt and api.fit_smc): ok")
        lap("tempering")

    line = {"kernels": []}
    if "hmc" in phases:
        t11 = time.perf_counter()
        hmc_counts, line["hmc"], grad_entry = hmc_phase(dev, g, card)
        print(f"  the phase {time.perf_counter() - t11:.1f} s")
        print("phase 11 slice 11 path (K2's backward, the log-joint on the "
              "card, HMC and NUTS through api.fit_hmc): ok")
        lap("hmc")

    if "advi" in phases:
        t12 = time.perf_counter()
        slice12, line["advi"], advi_entries = advi_phase(dev, g, card)
        print(f"  the phase {time.perf_counter() - t12:.1f} s")
        print("phase 12 slice 12 paths (ADVI through api.fit_advi_init, and "
              "the production sweep with every default-off kernel on): ok")
        lap("advi")

    if "mesh" in phases:
        t13 = time.perf_counter()
        if "production" not in phases:
            _, _, p_final = path_phase(dev, "production")
        mesh_counts, mesh_shapes, mesh_entries, line["mesh"] = mesh_phase(
            dev, card, p_final)
        print(f"  the phase {time.perf_counter() - t13:.1f} s")
        print("phase 13 slices 16 to 18 paths (the production census over "
              "a (chains, data) mesh: 1 x 1 over NCCL, two ranks sharing the "
              "card through gloo splitting the chains, then the data, PT and "
              "a checkpoint across them; SMC, HMC, NUTS, ADVI and the "
              "HMC-step sweep over the same meshes): ok")
        lap("mesh")

    if "timings" in phases:
        x = main_path_inputs(dev)
        C, K, N, P = CHAINS, PROTOCOL["K"], PROTOCOL["N"], PROTOCOL["P"]
        fn1 = (kernels.chol_solve, kernels.chol_solve_plain,
               library_chol_solve)
        fn2 = (kernels.mean_rss, kernels.mean_rss_plain, None)
        fn3 = (kernels.weighted_gram, kernels.weighted_gram_plain,
               library_weighted_gram)
        # inputs' name -> (kernel, shape, kernel, plain version, the one
        # PyTorch call or None); the last three are the fit's restart phases
        timed = {
            "chol_solve": ("chol_solve", dict(C=C, D=96), *fn1),
            "mean_rss": ("mean_rss", dict(C=C, N=N, L=100, P=P), *fn2),
            "mean_rss_2c": ("mean_rss", dict(C=2 * C, N=N, L=100, P=P), *fn2),
            "weighted_gram": ("weighted_gram", dict(R=C * K, N=N, P=P), *fn3),
            "chol_solve_c7": ("chol_solve", dict(C=7, D=96), *fn1),
            "mean_rss_c8": ("mean_rss", dict(C=8, N=N, L=100, P=P), *fn2),
            "weighted_gram_r24": ("weighted_gram", dict(R=8 * K, N=N, P=P),
                                  *fn3),
        }
        # slice 6's shapes: K1 at D = 256 with the jitter the sweep passes,
        # beside the three torch.linalg calls; K2 of the hd family (P = 16,
        # L = 144) at 64 chains and the MGP-scale moves' 128 rows, and of
        # config 4 (N = 80);
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
            "mean_rss_hd_c64": ("mean_rss", dict(C=64, N=64, L=144, P=16),
                                *fn2, c5_shapes),
            "mean_rss_hd_c128": ("mean_rss", dict(C=128, N=64, L=144, P=16),
                                 *fn2, c5_shapes),
            "mean_rss_n80_c256": ("mean_rss", dict(C=C, N=80, L=100, P=8),
                                  *fn2, c4_shapes),
            "weighted_gram_eta_r48": ("weighted_gram", dict(R=48, N=100, P=8),
                                      *fn3, c3_shapes),
            "weighted_gram_eta_r512": ("weighted_gram",
                                       dict(R=2 * C, N=80, P=8), *fn3,
                                       c4_shapes),
            "weighted_gram_hd_r256": ("weighted_gram", dict(R=256, N=64, P=16),
                                      *fn3, c5_shapes),
            # slice 10: PT's R replicas (K1, K2 on R and 2R rows, K3 on 3R) and
            # its pilot's one chain (K1)
            "chol_solve_pt": ("chol_solve", dict(C=R, D=96), *fn1, pt_shapes),
            "chol_solve_c1": ("chol_solve", dict(C=1, D=96), *fn1, pt_shapes),
            "mean_rss_pt": ("mean_rss", dict(C=R, N=N, L=100, P=P), *fn2,
                            pt_shapes),
            "mean_rss_pt_2r": ("mean_rss", dict(C=2 * R, N=N, L=100, P=P),
                               *fn2, pt_shapes),
            "weighted_gram_pt": ("weighted_gram", dict(R=3 * R, N=N, P=P),
                                 *fn3, pt_shapes),
            # slice 17: a rank's rows of the data split (N / 2), the sweep's
            # C and the MGP-scale moves' 2C chain rows, update_nu's 3C
            "mean_rss_n50_c256": ("mean_rss", dict(C=C, N=N // 2, L=100, P=P),
                                  *fn2, mesh_shapes),
            "mean_rss_n50_c512": ("mean_rss",
                                  dict(C=2 * C, N=N // 2, L=100, P=P), *fn2,
                                  mesh_shapes),
            "weighted_gram_n50_r768": ("weighted_gram",
                                       dict(R=K * C, N=N // 2, P=P), *fn3,
                                       mesh_shapes),
        }
        # slice 14: K1's panels kernel at the two-covariate path's shapes,
        # and at shapes no path of the smoke reaches (an hd Phi draw on a
        # 5 x 5 basis with K = M = 4, and larger D), with the jitter the
        # sweep passes, beside the three torch.linalg calls
        panels = {f"chol_solve_c{C1}_d{D1}": (C1, D1) for C1, D1 in (
            *K1_PANELS_PATH, (64, 400), (4, 1024), (1, kernels.K1_MAX_DIM))}
        for name, (C1, D1) in panels.items():
            x[name] = spd(g6, C1, D1, dev)
            timed[name] = ("chol_solve", dict(C=C1, D=D1), *fn1j)
        panels_launched = {name: c4d2_shapes.get(("chol_solve", shape), 0)
                           for name, shape in panels.items()}
        for C1, D1 in K1_PANELS_PATH:
            check(panels_launched[f"chol_solve_c{C1}_d{D1}"] > 0,
                  f"config 4 at D = 2 never launched K1 at ({C1}, {D1})")
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
            try:
                t = {k: v["device_ms"] for k, v in in_turns(
                    cands, rounds=3,
                    reps=K1_PANELS_REPS if name in panels else 50).items()}
            except RuntimeError as e:
                raise RuntimeError(f"timing {name} {shape}: {e}") from e
            t["paced"] = paced_ms(cands["kernel"])
            t["paced_plain"] = paced_ms(cands["plain"])
            t.update(kernels.kernel_bound(base, **shape))
            if name in panels:
                t["by_part"] = panels_parts(device_ms_by_kernel(
                    cands["kernel"], reps=K1_PANELS_REPS))
            ms[name] = t

        def jitter_ops():
            return kernels.add_jitter(x["chol_solve"][0], 1e-6)
        jitter_ms, jitter_launches = device_ms(jitter_ops), device_launches(
            jitter_ops)
        n = PROTOCOL["sweeps"]
        print(f"phase 14 timings on {card}: slice 1 "
              f"{CHAINS * n / s_seconds:.1f} chain-sweeps/s "
              f"({s_seconds / n * 1e3:.3f} ms per sweep); production "
              f"{CHAINS * n / p_seconds:.1f} chain-sweeps/s "
              f"({p_seconds / n * 1e3:.3f} ms per sweep), {CHAINS} chains, "
              f"loglik every sweep")
        print(f"  the jitter ops K1 absorbed (A + jitter * scale * I in "
              f"PyTorch, C={C} D=96): {jitter_launches} kernels, "
              f"{jitter_ms:.4f} ms of device time a call")
        for name, (_, shape, *_) in timed.items():
            t = ms[name]
            lib_ms = f"{t['library']:.4f} ms" if "library" in t else "none"
            print(f"  {name} {shape}: device {t['kernel']:.4f} ms vs plain "
                  f"{t['plain']:.4f} ms, one PyTorch call {lib_ms}, empty "
                  f"kernel {t['empty']:.4f} ms; bound {t['bound_ms']:.6f} "
                  f"ms by {t['bound_by']} ({t['bytes']} bytes, "
                  f"{t['flop']:.0f} FLOP; "
                  f"{100 * t['bound_ms'] / t['kernel']:.2f} % of it reached); "
                  f"host-paced {t['paced']:.4f} ms vs plain "
                  f"{t['paced_plain']:.4f} ms")
        for name, shape in panels.items():
            plan = kernels.chol_solve_plan(*shape)
            print(f"  {name} by launch: " + ", ".join(
                f"{k} {1e3 * v:.1f} us" for k, v in
                ms[name]["by_part"].items())
                + f" (panels of {plan['panel']}, cluster {plan['cluster']}, "
                  f"update {plan['update_blocks']} block(s) an SM, "
                  f"{plan['launches']} launches)")

        # slice 6: ms, kernels and device-busy ms a sweep of each
        # configuration
        sweeps6 = {**ms4, **ms4d2, **ms3, **ms1, **ms5}
        profiles = {
            "config4 16 chains": sweep_profile(dev, "config4", 16, {}),
            "config4 256 chains": sweep_profile(dev, "config4", CHAINS,
                                                api.PRODUCTION_FLAGS),
            "config4_D2 16 chains": sweep_profile(dev, "config4_D2", 16, {}),
            "config4_D2 256 chains": sweep_profile(
                dev, "config4_D2", CHAINS, api.PRODUCTION_FLAGS),
            "config3": sweep_profile(dev, "config3", 8, {}),
            "config1": sweep_profile(dev, "config1", 4, api.PRODUCTION_FLAGS),
            "config5": sweep_profile(dev, "config5", 64, api.PRODUCTION_FLAGS),
        }
        rounds = round_profiles(rounds)
        for name, v in profiles.items():
            v["ms_per_sweep"] = sweeps6[name]
            print(f"  {name}: {sweeps6[name]:.3f} ms a sweep on the host's "
                  f"clock, {v['kernels']:.0f} kernels and "
                  f"{v['device_ms']:.3f} ms of device time a sweep "
                  f"({100 * v['device_ms'] / sweeps6[name]:.1f} % busy)")

        SOURCES = {"chol_solve": ("chol_solve.cu", 228),
                   "mean_rss": ("mean_rss.cu", 68),
                   "weighted_gram": ("weighted_gram.cu", 122)}
        ERRS = {"chol_solve": k1_err, "mean_rss": k2_err,
                "weighted_gram": k3_err}

        def shape_entry(name):
            """One of slice 6's and slice 10's shapes: the keys every kernel
            entry has."""
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
                                            for cfg, c in slice6.items()},
                                         **{f"reference_api {ph}": c[name]
                                            for ph, c in ref_counts.items()},
                                         **{f"reference_api {cfg}": c[name]
                                            for cfg, c in fam_counts.items()},
                                         **{path: c[name]
                                            for path, c in slice10.items()},
                                         **{f"fit_hmc {m}": c[name]
                                            for m, c in hmc_counts.items()},
                                         **{path: c[name]
                                            for path, c in slice12.items()},
                                         **{path: c[name]
                                            for path, c in
                                            mesh_counts.items()}},
                    "ms": t["kernel"], "plain_ms": t["plain"],
                    "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                    "library_ms": t.get("library"),
                    "launches_per_sweep": {
                        **{path: per[name]
                           for path, (_, _, per) in PATHS.items()},
                        **{ph: per[name]
                           for ph, per in PHASE_LAUNCHES.items()}},
                    "empty_ms": t["empty"],
                    "at_restart_chains": {
                        **{k: ms[small][k] for k in (
                            "kernel", "plain", "bound_ms", "bound_by")},
                        "library": ms[small].get("library")}}

        def panels_entry():
            """K1's panels kernel: its numbers at the production shape of
            the two-covariate path, and at every shape it was timed at
            under ``by_shape``; launches are those of that path (a call,
            one launch counted, makes ``launches_a_call`` inside)."""
            rows = []
            for name in panels:
                t = ms[name]
                plan = kernels.chol_solve_plan(*panels[name])
                rows.append({
                    "shape": timed[name][1],
                    "launches": panels_launched[name],
                    "launches_a_call": plan["launches"],
                    **{k: plan[k] for k in ("panel", "cluster",
                                            "update_blocks")},
                    "by_part_ms": t["by_part"],
                    **{k: t[k] for k in ("bound_ms", "bound_by", "bytes",
                                         "flop")},
                    "ms": t["kernel"], "plain_ms": t["plain"],
                    "library_ms": t["library"], "empty_ms": t["empty"]})
            top = rows[[*panels].index(f"chol_solve_c{CHAINS}_d512")]
            return {"name": "chol_solve_panels", "route": "cuda",
                    "source": "bayesfmmm_torch/csrc/chol_solve_panels.cu",
                    "replaces": "bayesfmmm_tpu/ops/pallas_kernels.py:228",
                    "launches": sum(panels_launched.values()),
                    "max_abs_err": k1_err,
                    **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "shape")},
                    "peak_bytes_config4_D2_production": c4d2_peak,
                    "by_shape": rows}

        k2 = entry("mean_rss", "mean_rss_c8", "mean_rss.cu", 68, k2_err)
        # the MGP-scale moves' 2C chain rows, 4 of the production sweep's 7
        k2["at_2c_rows"] = {k: ms["mean_rss_2c"][k] for k in (
            "kernel", "plain", "bound_ms", "bound_by")}
        line["kernels"] = [
            entry("chol_solve", "chol_solve_c7", "chol_solve.cu", 228, k1_err),
            k2, entry("weighted_gram", "weighted_gram_r24", "weighted_gram.cu",
                      122, k3_err), *(shape_entry(name) for name in timed6),
            panels_entry()]
        line.update(sweeps=profiles, rounds=rounds)
    if "hmc" in phases:
        if "advi" in phases:
            for path, c in slice12.items():
                grad_entry["launches_by_path"][path] = c["mean_rss_grad"]
                grad_entry["launches"] += c["mean_rss_grad"]
        if "mesh" in phases:
            for path, c in mesh_counts.items():
                if c.get("mean_rss_grad"):
                    grad_entry["launches_by_path"][path] = \
                        c["mean_rss_grad"]
                    grad_entry["launches"] += c["mean_rss_grad"]
        line["kernels"].append(grad_entry)
    if "mesh" in phases:
        line["kernels"].extend(mesh_entries)
    if "advi" in phases:
        line["kernels"].extend(advi_entries)
    if "timings" in phases:
        lap("timings")
    line["sweep_graphs"] = SWEEP_GRAPH_RUNS
    line["phase_seconds"] = took
    print(f"phases' seconds on the host's clock: "
          + ", ".join(f"{k} {v}" for k, v in took.items())
          + f"; {time.perf_counter() - t0:.1f} s from the build on")
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
