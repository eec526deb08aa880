"""Dry runs of the port, and the launcher of its multi-rank runs.

The port's counterparts of ``__graft_entry__.py``:

  * ``entry()`` -> (step, example arguments): one production sweep of the
    flagship model (functional mixed membership, K=3, P=8, M=4) as a
    callable of (generator, state);
  * ``dryrun_multichip(n)`` runs the chain-parallel path on ``n`` gloo
    ranks of this machine's CPU, at one data shard: a 3-sweep chain and a
    2-round parallel tempering run over a (chains, data) = (n, 1) mesh,
    held to the same program in one process;
  * ``run_ranks(n, target, kwargs)`` starts ``n`` processes that join one
    process group and call ``target(**kwargs)``, and returns what each
    printed.  It fails if a rank fails or the ranks outlast ``timeout``,
    and kills every process it started before it returns.

    python -m bayesfmmm_torch.dryrun              # entry() on the card
    python -m bayesfmmm_torch.dryrun dryrun 4     # dryrun_multichip(4)
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parent.parent


def _setup(N=20, K=3, P=8, M=4, n_time=(30, 30), seed=0, device=None):
    from bayesfmmm_torch.config import ModelConfig, Priors
    from bayesfmmm_torch.utils.simulate import simulate_functional

    data, _ = simulate_functional(seed=seed, N=N, K=K, P=P, M=M,
                                  n_time=n_time, device=device)
    c = torch.full((K,), 10.0, dtype=data.y.dtype, device=data.device)
    return data, ModelConfig(K=K, P=P, M=M), Priors(), c


def entry(device=None):
    """(step, (generator, state)): ``step(generator, state)`` is one sweep of
    the production census of one chain of the flagship model, on ``device``
    (the card when None)."""
    from bayesfmmm_torch.api import PRODUCTION_FLAGS
    from bayesfmmm_torch.models.state import init_state
    from bayesfmmm_torch.ops import gibbs

    data, cfg, hp, c = _setup(device=device)
    generator = torch.Generator(device=data.device).manual_seed(0)
    state = init_state(generator, cfg, data, chains=1)

    def step(generator, state):
        return gibbs.sweep_full(generator, state, data, hp, c,
                                **PRODUCTION_FLAGS)

    return step, (generator, state)


# ---------------------------------------------------------------------------
# Multi-rank runs
# ---------------------------------------------------------------------------

def _load(target):
    """The function ``target`` names: "package.module:function", or
    "path/to/file.py:function"."""
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            f"_rank_target_{Path(where).stem}", where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def run_ranks(n, target, kwargs=None, *, device="cpu", timeout=120.0):
    """Run ``target(**kwargs)`` in ``n`` new processes that form one
    process group (``parallel/mesh.py::initialize_distributed``, through a
    file store in a temporary directory); returns each rank's standard
    output and error, in rank order.

    ``device`` is the ranks' device type ("cuda": rank r on card r modulo
    the cards, through gloo when the ranks outnumber them); ``kwargs`` must
    be JSON.  A rank that
    exits non-zero, or ranks still running after ``timeout`` seconds, raise
    RuntimeError with what each printed; every process is stopped before
    this returns."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in (env.get("PYTHONPATH"),) if p])
    if torch.device(device).type == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory(prefix="bfmmm_ranks_") as tmp:
        store = Path(tmp) / "store"
        logs = [Path(tmp) / f"rank{r}.log" for r in range(n)]
        args = ["--world", str(n), "--init", f"file://{store}", "--device",
                str(device), "--target", target, "--kwargs",
                json.dumps(kwargs or {})]
        procs = []
        try:
            for r, log in enumerate(logs):
                with open(log, "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "bayesfmmm_torch.dryrun",
                         "--rank", str(r), *args], stdout=f,
                        stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + timeout
            failed = timed_out = False
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    failed = True
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = [log.read_text() for log in logs]
    if timed_out or failed or any(p.returncode for p in procs):
        what = (f"still running after {timeout} s" if timed_out
                else "exit codes " + str([p.returncode for p in procs]))
        raise RuntimeError(f"run_ranks({n}, {target}): {what}\n" + "\n".join(
            f"--- rank {r} ---\n{out[-3000:]}" for r, out in enumerate(outs)))
    return outs


def _rank_main(argv):
    """A rank of ``run_ranks``: join the group, call the target, leave."""
    from bayesfmmm_torch.parallel import mesh as pmesh

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--init", "--device", "--target", "--kwargs"):
        ap.add_argument(flag, required=True)
    a = ap.parse_args(argv)
    pmesh.initialize_distributed(num_processes=a.world, process_id=a.rank,
                                 init_method=a.init, device=a.device)
    try:
        _load(a.target)(**json.loads(a.kwargs))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------

_DRY_SWEEPS, _DRY_ROUNDS, _DRY_CHAINS_A_SHARD = 3, 2, 2
_DRY_ATOL = 2e-4


def _dry_program(n_chain_shards, mesh=None):
    """The dry run's program on the CPU: a 3-sweep chain of every chain,
    then 2 PT rounds over the chains as replicas; under ``mesh`` split over
    its ranks.  Returns (final states, cold trace's sigma2, swap rate), all
    whole."""
    from bayesfmmm_torch.models.state import init_state
    from bayesfmmm_torch.ops import gibbs
    from bayesfmmm_torch.parallel import mesh as pmesh
    from bayesfmmm_torch.parallel.tempering import run_parallel_tempering
    from bayesfmmm_torch.samplers import drivers

    data, cfg, hp, c = _setup(N=8, K=2, P=5, M=2, n_time=(12, 12),
                              device="cpu")
    n_chains = n_chain_shards * _DRY_CHAINS_A_SHARD
    states = init_state(torch.Generator().manual_seed(0), cfg, data,
                        chains=n_chains)
    scope = contextlib.nullcontext()
    if mesh is not None:
        data = pmesh.shard_data(data, mesh)
        states = pmesh.shard_chain_states(states, mesh)
        scope = mesh
    with scope:
        out = drivers.run_chain(torch.Generator().manual_seed(1), states,
                                data, hp, c, sweep=gibbs.sweep_full,
                                n_iters=_DRY_SWEEPS).final_state
        cold, _, rate = run_parallel_tempering(
            torch.Generator().manual_seed(7), out, data, hp, c,
            n_rounds=_DRY_ROUNDS, beta_min=0.5)
        if mesh is not None:
            out = pmesh.gather_chain_states(out, mesh)
    return out, cold.sigma2, rate


def _dry_rank(out):
    """A rank of ``dryrun_multichip``: its program over the mesh; the first
    rank saves the whole results to ``out``."""
    from bayesfmmm_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(n_data_shards=1, devices="cpu")
    final, cold_sigma2, rate = _dry_program(mesh.shape[pmesh.CHAIN_AXIS],
                                            mesh)
    if mesh.rank == 0:
        torch.save({"final": dataclasses.asdict(final),
                    "cold_sigma2": cold_sigma2, "rate": rate}, out)


def dryrun_multichip(n_devices: int, *, timeout=120.0) -> None:
    """Run the chain-parallel path on ``n_devices`` gloo ranks of the CPU, at
    a (chains, data) = (n_devices, 1) mesh with 2 chains a rank: a 3-sweep
    chain (``drivers.run_chain`` of ``sweep_full``), then 2 parallel
    tempering rounds of those chains as replicas; and hold the final
    ensemble and the cold chain's sigma2 to the same program in this
    process within the JAX dry run's atol of 2e-4
    (``__graft_entry__.py:117-128``), the swap rate exactly.  The CPU's
    sgemm picks its kernel by the chain count, so the bits agree at some
    splits and not at others; the line printed says which.  Raises on a
    difference past the atol, a failed rank or a hang."""
    from bayesfmmm_torch.models.state import STATE_FIELDS

    with tempfile.TemporaryDirectory(prefix="bfmmm_dryrun_") as tmp:
        out = str(Path(tmp) / "rank0.pt")
        run_ranks(n_devices, "bayesfmmm_torch.dryrun:_dry_rank",
                  {"out": out}, device="cpu", timeout=timeout)
        got = torch.load(out)
    final, cold_sigma2, rate = _dry_program(n_devices)
    pairs = [(got["final"][f], getattr(final, f)) for f in STATE_FIELDS]
    pairs.append((got["cold_sigma2"], cold_sigma2))
    worst = max((a - b).abs().max().item() for a, b in pairs if b.numel())
    if worst > _DRY_ATOL or not torch.equal(got["rate"], rate):
        raise AssertionError(
            f"dryrun_multichip({n_devices}): the split run is {worst} from "
            f"one process's (atol {_DRY_ATOL}), swap rate "
            f"{float(got['rate'])} against {float(rate)}")
    parity = ("bit-equal" if all(torch.equal(a, b) for a, b in pairs)
              else f"max |diff| {worst:.3g} <= {_DRY_ATOL}")
    print(f"dryrun_multichip OK: mesh=({n_devices}, 1) chains="
          f"{n_devices * _DRY_CHAINS_A_SHARD} steps={_DRY_SWEEPS} "
          f"pt_rounds={_DRY_ROUNDS} pt_swap_rate={float(rate):.2f} "
          f"sigma2[0]={float(final.sigma2[0]):.4f} parity={parity}")


if __name__ == "__main__":
    if "--rank" in sys.argv:
        _rank_main(sys.argv[1:])
    elif len(sys.argv) > 1 and sys.argv[1] == "dryrun":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
    else:
        fn, args = entry()
        out = fn(*args)
        print("entry OK", float(out.sigma2[0]))
