"""Where the production sweep's time goes on one NVIDIA GPU.

    python3 -m bayesfmmm_torch.utils.profile_sweep [--sweeps 20] [--warm 100]

Builds the bench's headline model (K=3, P=8, M=4, N=100, L=100) and a
256-chain ensemble at the spectral init, runs ``--warm`` production sweeps,
then ``--sweeps`` more with the card synchronised around each updater (host
ms per updater per sweep), then ``--sweeps`` more under torch.profiler
(kernels per sweep, device busy ms per sweep).  Prints the card's name and
power limit and one JSON object of those numbers.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bayesfmmm_torch import ModelConfig, Priors
from bayesfmmm_torch.models.state import init_state
from bayesfmmm_torch.ops import gibbs
from bayesfmmm_torch.utils.init_strategies import spectral_ensemble
from bayesfmmm_torch.utils.simulate import simulate_functional

# the bench's production census
PRODUCTION = dict(collapsed_z=True, gauge=True, p_indep=0.3,
                  phi_mala_steps=4, phi_mala_step=0.05)
# the production sweep's updaters, in sweep order (build_cache runs twice)
UPDATERS = ("build_cache", "update_z_chi", "update_pi", "update_alpha3",
            "update_phi", "update_delta", "update_a", "update_gamma",
            "update_nu", "update_tau", "update_sigma", "update_chi_joint",
            "update_gauge", "update_mgp_scale", "update_noise_scale",
            "update_phi_mala")


def per_updater_ms(g, st, data, hp, c, sweeps):
    """(state, ms per sweep by updater, ms per sweep), the card synchronised
    around each updater call."""
    totals = dict.fromkeys(UPDATERS, 0.0)

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            totals[name] += time.perf_counter() - t0
            return out
        return run

    originals = {n: getattr(gibbs, n) for n in UPDATERS}
    try:
        for n, fn in originals.items():
            setattr(gibbs, n, timed(n, fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(sweeps):
            st = gibbs.sweep_full(g, st, data, hp, c, **PRODUCTION)
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) / sweeps * 1e3
    finally:
        for n, fn in originals.items():
            setattr(gibbs, n, fn)
    return st, {n: v / sweeps * 1e3 for n, v in totals.items()}, synced


def profiled(g, st, data, hp, c, sweeps):
    """(kernels per sweep, device busy ms per sweep, wall ms per sweep under
    the profiler)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(sweeps):
            st = gibbs.sweep_full(g, st, data, hp, c, **PRODUCTION)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / sweeps * 1e3
    n_kernels, busy_us = 0, 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and not ev.key.startswith(
                ("Memcpy", "Memset")):
            n_kernels += ev.count
            busy_us += ev.self_device_time_total
    return n_kernels / sweeps, busy_us / sweeps / 1e3, wall


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--warm", type=int, default=100)
    ap.add_argument("--chains", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sweep: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    gibbs.use_full_f32()
    K, P, M = 3, 8, 4
    data, _ = simulate_functional(seed=7, N=100, K=K, P=P, M=M,
                                  n_time=(100, 100), device=dev)
    hp, c = Priors(), torch.full((K,), 10.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    st = init_state(g, ModelConfig(K=K, P=P, M=M), data, chains=args.chains)
    st = spectral_ensemble(g, st, data, K, M)
    for _ in range(args.warm):
        st = gibbs.sweep_full(g, st, data, hp, c, **PRODUCTION)

    st, per, synced = per_updater_ms(g, st, data, hp, c, args.sweeps)
    n_kernels, busy_ms, wall = profiled(g, st, data, hp, c, args.sweeps)
    if n_kernels == 0:
        print("profile_sweep: the profiler saw no kernel on the card",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    print(json.dumps({
        "chains": args.chains, "sweeps": args.sweeps,
        "synced_ms_per_sweep": synced, "updater_ms_per_sweep": per,
        "profiled_ms_per_sweep": wall, "kernels_per_sweep": n_kernels,
        "device_busy_ms_per_sweep": busy_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
