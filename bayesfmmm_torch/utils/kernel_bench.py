"""Times of the kernels K1, K2 and K3 on one NVIDIA GPU, beside their yardsticks.

    python3 -m bayesfmmm_torch.utils.kernel_bench [--rounds 4] [--sweep]
                                                  [--baseline DIR]

At the main path's shapes (256 chains of the headline model: K1 C=256,
D=96; K2 C=256 and the MGP-scale moves' 512 chain rows, N=L=100, P=8; K3
R=768, N=100, P=8) it times, for each kernel, the kernel, its plain PyTorch
version, the single PyTorch call that computes the same function where
there is one (K3: ``torch.matmul(W, G.reshape(N, P * P))``), and the empty
kernel (the launch floor).  The candidates of one kernel are timed in
turns, forwards then backwards, ``--rounds`` times on the same inputs, so
the inputs stay warm in L2 as the sampler's B and G do; the figure kept is
the median over rounds of the device time per call (the profiler's summed
durations of the card's work, so neither the host's pace nor its syncs
count); ``by_kernel`` splits the kernel's figure by CUDA kernel name.

``--baseline DIR`` also loads ``ops/kernels.py`` of DIR, an earlier
revision's ``bayesfmmm_torch`` directory (``git archive REV bayesfmmm_torch
| tar -x -C SOMEWHERE``), as a module of its own, which builds that
revision's ``csrc`` into DIR and binds it as that revision did, and times
its three wrappers in the same turns: two revisions are compared only
inside one run, on one card.  ``--sweep`` times K2 over other tile sizes
than the plan's and every kernel of K1 that can serve D=96 (and, in
groups of their own, D=32, 64 and 128) beside the plan's choice.  K1's
group also times ``jitter_ops``, the PyTorch ops that built
A + jitter * scale * I before K1 took the jitter inside.  Prints the
card's name and power limit and one JSON object.  Needs one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bayesfmmm_torch.ops import kernels

CHAINS, N, L, P, K, D = 256, 100, 100, 8, 3, 96


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0].strip()


def _device_events(fn, reps, warmup, attempts):
    """[(name, launches a call, mean ms a launch)] of the card's work over
    ``reps`` calls of ``fn``, from the profiler.  The profiler now and then
    loses records: a kernel may miss up to a tenth of its launches (its
    mean is then over those that were kept); a trace that misses more is
    taken again, ``attempts`` times at most."""
    for _ in range(warmup):
        fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA]
        per_call = [max(1, round(ev.count / reps)) for ev in events]
        if events and all(0 <= n * reps - ev.count <= reps // 10
                          for ev, n in zip(events, per_call)):
            return [(ev.key, n, ev.self_device_time_total / ev.count / 1e3)
                    for ev, n in zip(events, per_call)]
    raise RuntimeError(f"the profiler lost records of the card's work in "
                       f"{attempts} traces of {reps} calls; the last held "
                       f"{ {ev.key: ev.count for ev in events} }")


def device_ms_by_kernel(fn, reps=50, warmup=5, attempts=6):
    """{name: ms per call} of every piece of the card's work that ``fn``
    starts: the profiler's durations, so neither the host's pace nor a host
    sync inside ``fn`` counts."""
    return {name: n * ms
            for name, n, ms in _device_events(fn, reps, warmup, attempts)}


def device_launches(fn, reps=50, warmup=5, attempts=6):
    """Pieces of the card's work (kernels, copies) one call of ``fn``
    starts."""
    return sum(n for _, n, _ in _device_events(fn, reps, warmup, attempts))


def device_ms(fn, reps=50, warmup=5):
    """Device time per call: the sum of ``device_ms_by_kernel``."""
    return sum(device_ms_by_kernel(fn, reps, warmup).values())


def paced_ms(fn, reps=50, warmup=5):
    """ms per call between CUDA events around ``reps`` calls, each run as
    the host sends it, so the host's pace shows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(candidates, rounds):
    """{name: {"device_ms": median, "rounds": [...]}} for a dict of
    callables timed in turns: forwards on even rounds, backwards on odd."""
    times = {name: [] for name in candidates}
    order = list(candidates)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else reversed(order)):
            times[name].append(device_ms(candidates[name]))
    return {name: {"device_ms": statistics.median(t), "rounds": t}
            for name, t in times.items()}


def spd(g, C, D, dev, diag=50.0):
    """A batch of SPD (D, D) matrices and two right-hand sides."""
    X = torch.randn(C, D, D, generator=g, device=dev)
    A = X @ X.mT + diag * torch.eye(D, device=dev)
    return (A.contiguous(), torch.randn(C, D, generator=g, device=dev),
            torch.randn(C, D, generator=g, device=dev))


def main_path_inputs(dev, seed=123):
    """Random tensors at the main path's shapes, by kernel."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = torch.randn(N, L, P, generator=g, device=dev)
    y = torch.randn(N, L, generator=g, device=dev)
    return {
        "chol_solve": spd(g, CHAINS, D, dev),
        "mean_rss": (B, y, torch.randn(CHAINS, N, P, generator=g,
                                       device=dev)),
        "mean_rss_2c": (B, y, torch.randn(2 * CHAINS, N, P, generator=g,
                                          device=dev)),
        "weighted_gram": (torch.rand(CHAINS * K, N, generator=g, device=dev),
                          torch.randn(N, P, P, generator=g, device=dev)),
    }


def library_weighted_gram(W, G):
    """The one PyTorch call for K3's function: a (R, N) by (N, P*P) GEMM.
    A yardstick only; the package never calls it."""
    return torch.matmul(W, G.reshape(G.shape[0], -1))


def _baseline_kernels(pkg):
    """``ops/kernels.py`` of the package directory ``pkg``, an earlier
    revision's, as a module beside this revision's: it finds its own
    ``csrc`` and ``_build`` from its path."""
    path = Path(pkg) / "ops" / "kernels.py"
    spec = importlib.util.spec_from_file_location(
        "bayesfmmm_torch_baseline_kernels", path)
    if spec is None or not path.is_file():
        raise RuntimeError(f"no ops/kernels.py under {pkg}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k2_tiles(lib, B, y, w, TC, TN):
    """K2 through the C entry point with tile sizes other than the plan's."""
    C = w.shape[0]
    rss = torch.empty(C, device=w.device)
    partial = torch.empty(-(-N // TN), C, device=w.device)

    def launch():
        rc = lib.bfmmm_mean_rss(
            B.data_ptr(), y.data_ptr(), w.data_ptr(), rss.data_ptr(), None,
            partial.data_ptr(), C, N, L, P, TC, TN,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {torch.cuda.CudaError(rc)}")
    return launch


def _k1_tile(lib, A, b, z, tile):
    """K1 through the C entry point with another kernel than the plan's:
    ``tile`` 0 is the shared-memory kernel, otherwise the tile side of the
    register-tiled one."""
    C, D_ = b.shape
    mean, noise = torch.empty_like(b), torch.empty_like(b)

    def launch():
        rc = lib.bfmmm_chol_solve(
            A.data_ptr(), b.data_ptr(), z.data_ptr(), mean.data_ptr(),
            noise.data_ptr(), C, D_, 0.0, tile,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {torch.cuda.CudaError(rc)}")
    return launch


def _k1_sweep(lib, x):
    """{name: callable} of every kernel of K1 that serves x's D."""
    D_ = x[1].shape[1]
    cands = {"shared": _k1_tile(lib, *x, tile=0)}
    for TS in kernels.K1_TILES:
        if D_ <= kernels.K1_GRID * TS:
            cands[f"tiled {TS}x{TS}"] = _k1_tile(lib, *x, tile=TS)
    return cands


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    x = main_path_inputs(dev)
    base = _baseline_kernels(args.baseline) if args.baseline else None

    groups = {
        "chol_solve": {
            "kernel": lambda: kernels.chol_solve(*x["chol_solve"]),
            "plain": lambda: kernels.chol_solve_plain(*x["chol_solve"]),
            "jitter_ops": lambda: kernels.add_jitter(x["chol_solve"][0],
                                                     1e-6)},
        "mean_rss": {
            "kernel": lambda: kernels.mean_rss(*x["mean_rss"]),
            "plain": lambda: kernels.mean_rss_plain(*x["mean_rss"])},
        "mean_rss_2c": {
            "kernel": lambda: kernels.mean_rss(*x["mean_rss_2c"]),
            "plain": lambda: kernels.mean_rss_plain(*x["mean_rss_2c"])},
        "weighted_gram": {
            "kernel": lambda: kernels.weighted_gram(*x["weighted_gram"]),
            "plain": lambda: kernels.weighted_gram_plain(*x["weighted_gram"]),
            "library": lambda: library_weighted_gram(*x["weighted_gram"])},
    }
    for cands in groups.values():
        cands["empty"] = lambda: kernels.empty_launch(dev)
    if base is not None:
        for name, cands in groups.items():
            fn = getattr(base, name.removesuffix("_2c"))
            cands["baseline"] = lambda fn=fn, name=name: fn(*x[name])
    if args.sweep:
        lib = kernels._library()
        for name in ("mean_rss", "mean_rss_2c"):
            for TC in kernels.K2_CHAIN_TILES:
                for TN in (5, 10, 20):
                    groups[name][f"TC={TC},TN={TN}"] = _k2_tiles(
                        lib, *x[name], TC=TC, TN=TN)
        groups["chol_solve"].update(_k1_sweep(lib, x["chol_solve"]))
        g = torch.Generator(device=dev).manual_seed(321)
        for D_ in (32, 64, 128):
            xd = spd(g, CHAINS, D_, dev)
            groups[f"chol_solve_d{D_}"] = {
                "kernel": lambda xd=xd: kernels.chol_solve(*xd),
                **_k1_sweep(lib, xd)}

    result = {}
    for name, cands in groups.items():
        result[name] = in_turns(cands, args.rounds)
        result[name]["kernel"]["paced_ms"] = paced_ms(cands["kernel"])
        result[name]["kernel"]["by_kernel"] = device_ms_by_kernel(
            cands["kernel"])
    shapes = {"chol_solve": dict(C=CHAINS, D=D),
              "mean_rss": dict(C=CHAINS, N=N, L=L, P=P),
              "mean_rss_2c": dict(C=2 * CHAINS, N=N, L=L, P=P),
              "weighted_gram": dict(R=CHAINS * K, N=N, P=P)}
    for name in result:
        if name.startswith("chol_solve_d"):
            shapes[name] = dict(C=CHAINS, D=int(name.removeprefix(
                "chol_solve_d")))
    for name, shape in shapes.items():
        bound = kernels.kernel_bound(name.split("_d")[0].removesuffix("_2c"),
                                     **shape)
        result[name]["shape"] = shape
        result[name]["bound"] = bound
        result[name]["share_of_bound"] = (
            bound["bound_ms"] / result[name]["kernel"]["device_ms"])
    print(card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
