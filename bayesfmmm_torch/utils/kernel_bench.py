"""Times of the kernels K1, K2 and K3 on one NVIDIA GPU, beside their yardsticks.

    python3 -m bayesfmmm_torch.utils.kernel_bench [--rounds 4] [--sweep]
                                                  [--baseline DIR]

At the main path's shapes (256 chains of the headline model: K1 C=256,
D=96; K2 C=256 and the MGP-scale moves' 512 chain rows, N=L=100, P=8; K3
R=768, N=100, P=8; K2's backward at ``GRAD_SHAPES``, those of fit_hmc,
ADVI, one chain, the hd family and a general P) and at the shapes of the hd
configuration at upstream's basis (``HD_SHAPES``: K2's general
instantiation at 64 and 128 chain rows, K3's chunked kernel) it times, for
each kernel, the kernel, its plain PyTorch version, the single PyTorch
call that computes the same function where there is one (K3:
``torch.matmul(W, G.reshape(N, P * P))``), and the empty kernel (the
launch floor).  The candidates of one kernel are timed in
turns, forwards then backwards, ``--rounds`` times on the same inputs, so
the inputs stay warm in L2 as the sampler's B and G do; the figure kept is
the median over rounds of the device time per call (the profiler's summed
durations of the card's work, so neither the host's pace nor its syncs
count): every launch a call makes is in it, by name the launches a call
times their mean, so K1's panels kernel, 2 ceil(D / 128) + 1 launches of
four kernels a call, counts whole; ``by_kernel`` splits the kernel's
figure by CUDA kernel name.  ``panels_parts`` sums the panels kernel's
split into its parts (first diagonal block, panel products, trailing
updates, back substitutions; the earlier design's prologue).

``--baseline DIR`` also loads ``ops/kernels.py`` of DIR, an earlier
revision's ``bayesfmmm_torch`` directory (``git archive REV bayesfmmm_torch
| tar -x -C SOMEWHERE``), as a module of its own, which builds that
revision's ``csrc`` into DIR and binds it as that revision did, and times
its three wrappers in the same turns (and its K1 in every group of
``--sweep``): two revisions are compared only inside one run, on one card.
``--sweep`` times K2 over other tile sizes than the plan's, K2's backward
over other lanes a chain than the plan's (1 to 32), and every kernel
of K1 that can serve D=96 (the register kernel's tiles, the blocked
kernel; and, in groups of their own, D=32, 64 and 128, and
D=129, 200, 240, 256 and 334 at 256 and at 16 chains, and D=256 at 64
chains; at D=256 also the plain version and the three ``torch.linalg``
calls) beside the plan's choice, and K1's panels kernel at (16, 512),
(256, 512), (64, 400), (4, 1024) and (1, 4096) beside the plain version,
the three ``torch.linalg`` calls, the earlier revision's kernel (with
``--baseline``) and the other configurations its C entry point takes
(``_panels_sweep``: panels of 64 and 128 at clusters of 1, 4, 8 and 16
blocks, the update compiled for the other blocks an SM), ten calls a
round, with the kernel's and the baseline's split by part
(``panels_parts``).  K1's
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
# K2's backward (C, N, L, P): fit_hmc's 64 chains, ADVI's 4 rows and one
# chain at the headline width, the hd family's P = 16 (config 5) and a
# general P
GRAD_SHAPES = ((64, 100, 100, 8), (4, 100, 100, 8), (1, 100, 100, 8),
               (64, 64, 144, 16), (64, 100, 100, 10))
# BHDFMMM at upstream's basis (P = 6 x 6 = 36; 100 surfaces of up to 900
# points, 64 chains, K = 2): K2 (C, N, L, P) at the chains and at twice
# them, K3 (R, N, P) at R = C K
HD_SHAPES = {"mean_rss": ((64, 100, 900, 36), (128, 100, 900, 36)),
             "weighted_gram": ((128, 100, 36),)}


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0].strip()


# Launched at the start of every trace and left out of its records: once a
# process has run long on the card, the profiler drops the first records
# of every trace, 5 of 50 or of 200 calls alike after the smoke's PT and
# SMC paths, ~27 after its HMC and NUTS fits as well (chip_smoke.py,
# NVIDIA H100 80GB HBM3); these absorb that.
_PAD_LAUNCHES = 64
_PAD_KERNEL = "spin_kernel"        # torch.cuda._sleep's


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
            for _ in range(_PAD_LAUNCHES):
                torch.cuda._sleep(1)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA
                  and _PAD_KERNEL not in ev.key]
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


# K1's panels kernel's launches by the name of their CUDA kernel
# (csrc/chol_solve_panels.cu; in the earlier design, panels_prologue
# copied A and panels_panel solved the rows by substitution)
PANELS_PARTS = {"panels_prologue": "prologue",
                "panels_first": "first diagonal block",
                "panels_panel": "panel products",
                "panels_update": "trailing updates",
                "panels_solve": "back substitutions"}


def panels_parts(by_kernel):
    """``device_ms_by_kernel``'s split of a panels-kernel call summed by
    part (``PANELS_PARTS``); the card's other work under "other"."""
    parts = {}
    for name, ms in by_kernel.items():
        part = next((p for k, p in PANELS_PARTS.items() if k in name),
                    "other")
        parts[part] = parts.get(part, 0.0) + ms
    return parts


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


def in_turns(candidates, rounds, reps=50):
    """{name: {"device_ms": median, "rounds": [...]}} for a dict of
    callables timed in turns: forwards on even rounds, backwards on odd;
    each round ``reps`` calls (fewer where a call starts thousands of
    kernels, whose trace the profiler takes seconds to read)."""
    times = {name: [] for name in candidates}
    order = list(candidates)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else reversed(order)):
            times[name].append(device_ms(candidates[name], reps=reps))
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
        # the restart phases of the fit pipeline at n_try=7: 8 chains in
        # phase 1 (K2, K3), 7 in phase 2 (K1, K2)
        "chol_solve_c7": spd(g, 7, D, dev),
        "mean_rss_c8": (B, y, torch.randn(8, N, P, generator=g, device=dev)),
        "weighted_gram_r24": (torch.rand(8 * K, N, generator=g, device=dev),
                              torch.randn(N, P, P, generator=g, device=dev)),
    }


def library_weighted_gram(W, G):
    """The one PyTorch call for K3's function: a (R, N) by (N, P*P) GEMM.
    A yardstick only; the package never calls it."""
    return torch.matmul(W, G.reshape(G.shape[0], -1))


def library_chol_solve(A, b, z):
    """K1's function by the library: the three ``torch.linalg`` calls (one
    factorization, two triangular solves, the second on both right-hand
    sides).  A yardstick only; on the card the package calls it for no
    D."""
    L = torch.linalg.cholesky_ex(A).L
    w = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(
        L.mT, torch.cat([w, z[..., None]], -1), upper=True)


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


def _k2_grad_lanes(lib, B, y, w, g, lanes):
    """K2's backward through the C entry point with ``lanes`` a chain
    splitting the points, not the plan's."""
    N_, L_, P_ = B.shape
    C_ = w.shape[0]
    plan = kernels.mean_rss_grad_plan(C_, N_, L_, P_, lanes=lanes)
    grad = torch.empty_like(w)

    def launch():
        rc = lib.bfmmm_mean_rss_grad(
            B.data_ptr(), y.data_ptr(), w.data_ptr(), g.data_ptr(),
            grad.data_ptr(), C_, N_, L_, P_, plan["KP"], plan["SP"],
            plan["SL"], plan["TC"], plan["LC"],
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {torch.cuda.CudaError(rc)}")
    return launch


def _k1_tile(lib, A, b, z, tile):
    """K1 through the C entry point with another kernel than the plan's:
    ``tile`` is the entry point's kernel code (``kernels.chol_solve_code``):
    minus the blocked kernel's panel width, or the register-tiled one's
    tile side."""
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
    cands = {"blocked": _k1_tile(lib, *x, tile=-kernels.K1_PANEL)}
    for TS in kernels.K1_TILES:
        if D_ <= kernels.K1_GRID * TS:
            cands[f"tiled {TS}x{TS}"] = _k1_tile(lib, *x, tile=TS)
    return cands


# K1's panels kernel: the two-covariate path's shapes, an hd Phi draw on a
# 5 x 5 basis, and larger D at few chains
PANELS_SHAPES = ((16, 512), (CHAINS, 512), (64, 400), (4, 1024),
                 (1, kernels.K1_MAX_DIM))
# calls a round for those: a call starts 9 to 65 kernels (the baseline's
# 33 to 257), whose traces the profiler reads slowly
PANELS_REPS = 10


def _panels_sweep(x):
    """{name: callable} of the panels kernel at x's shape in the other
    configurations its C entry point takes: panel widths 64 and 128 at
    clusters of 1, 4, 8 and 16 blocks (the plan's update blocks an SM),
    and the plan's width and cluster with the other update blocks."""
    A, b, z = x
    mean, noise = torch.empty_like(b), torch.empty_like(b)
    plan = kernels.chol_solve_plan(*b.shape)

    def launcher(**over):
        p = dict(plan, **over)

        def launch():
            rc = kernels.panels_launch(A, b, z, mean, noise, 0.0, p)
            if rc != 0:
                raise RuntimeError(
                    f"launch failed: {torch.cuda.CudaError(rc)}")
        return launch
    cands = {f"panel={nb},cluster={cs}": launcher(panel=nb, cluster=cs)
             for nb in kernels.K1_PANELS_WIDTHS for cs in (1, 4, 8, 16)
             if (nb, cs) != (plan["panel"], plan["cluster"])}
    ub = 3 - plan["update_blocks"]
    cands[f"update_blocks={ub}"] = launcher(update_blocks=ub)
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
    # name -> (kernel, shape) of every group, for its bound
    shapes = {"chol_solve": ("chol_solve", dict(C=CHAINS, D=D)),
              "mean_rss": ("mean_rss", dict(C=CHAINS, N=N, L=L, P=P)),
              "mean_rss_2c": ("mean_rss", dict(C=2 * CHAINS, N=N, L=L, P=P)),
              "weighted_gram": ("weighted_gram", dict(R=CHAINS * K, N=N,
                                                      P=P))}
    g2 = torch.Generator(device=dev).manual_seed(7)
    for C_, N_, L_, P_ in GRAD_SHAPES:
        name = f"mean_rss_grad_c{C_}_n{N_}_l{L_}_p{P_}"
        x[name] = (torch.randn(N_, L_, P_, generator=g2, device=dev),
                   torch.randn(N_, L_, generator=g2, device=dev),
                   torch.randn(C_, N_, P_, generator=g2, device=dev),
                   torch.randn(C_, generator=g2, device=dev))
        shapes[name] = ("mean_rss_grad", dict(C=C_, N=N_, L=L_, P=P_))
        groups[name] = {
            "kernel": lambda name=name: kernels.mean_rss_grad(*x[name]),
            "plain": lambda name=name: kernels.mean_rss_grad_plain(*x[name])}
    for C_, N_, L_, P_ in HD_SHAPES["mean_rss"]:
        name = f"mean_rss_c{C_}_n{N_}_l{L_}_p{P_}"
        x[name] = (torch.randn(N_, L_, P_, generator=g2, device=dev),
                   torch.randn(N_, L_, generator=g2, device=dev),
                   torch.randn(C_, N_, P_, generator=g2, device=dev))
        shapes[name] = ("mean_rss", dict(C=C_, N=N_, L=L_, P=P_))
        groups[name] = {
            "kernel": lambda name=name: kernels.mean_rss(*x[name]),
            "plain": lambda name=name: kernels.mean_rss_plain(*x[name])}
    for R_, N_, P_ in HD_SHAPES["weighted_gram"]:
        name = f"weighted_gram_r{R_}_n{N_}_p{P_}"
        x[name] = (torch.rand(R_, N_, generator=g2, device=dev),
                   torch.randn(N_, P_, P_, generator=g2, device=dev))
        shapes[name] = ("weighted_gram", dict(R=R_, N=N_, P=P_))
        groups[name] = {
            "kernel": lambda name=name: kernels.weighted_gram(*x[name]),
            "plain": lambda name=name: kernels.weighted_gram_plain(*x[name]),
            "library": lambda name=name: library_weighted_gram(*x[name])}
    for cands in groups.values():
        cands["empty"] = lambda: kernels.empty_launch(dev)
    if base is not None:
        for name, cands in groups.items():
            fn = getattr(base, shapes[name][0])
            cands["baseline"] = lambda fn=fn, name=name: fn(*x[name])
    if args.sweep:
        lib = kernels._library()
        for name in ("mean_rss", "mean_rss_2c"):
            for TC in kernels.K2_CHAIN_TILES:
                for TN in (5, 10, 20):
                    groups[name][f"TC={TC},TN={TN}"] = _k2_tiles(
                        lib, *x[name], TC=TC, TN=TN)
        for name, (kern, shape) in list(shapes.items()):
            if kern != "mean_rss_grad":
                continue
            own = kernels.mean_rss_grad_plan(*shape.values())["SL"]
            for lanes in (1, 2, 4, 8, 16, 32):
                if lanes != own:
                    groups[name][f"lanes={lanes}"] = _k2_grad_lanes(
                        lib, *x[name], lanes)
        groups["chol_solve"].update(_k1_sweep(lib, x["chol_solve"]))
        g = torch.Generator(device=dev).manual_seed(321)
        for C_, D_ in ((CHAINS, 32), (CHAINS, 64), (CHAINS, 128),
                       (CHAINS, 129), (CHAINS, 200), (CHAINS, 240),
                       (CHAINS, 256), (CHAINS, 334), (16, 129), (16, 200),
                       (16, 240), (16, 256), (16, 334), (64, 256)):
            xd = spd(g, C_, D_, dev)
            name = f"chol_solve_c{C_}_d{D_}"
            shapes[name] = ("chol_solve", dict(C=C_, D=D_))
            groups[name] = {
                "kernel": lambda xd=xd: kernels.chol_solve(*xd),
                **_k1_sweep(lib, xd)}
            if base is not None:
                groups[name]["baseline"] = lambda xd=xd: base.chol_solve(*xd)
            if D_ == 256:      # the joint draws: also the yardsticks
                groups[name]["plain"] = (
                    lambda xd=xd: kernels.chol_solve_plain(*xd))
                groups[name]["library"] = (
                    lambda xd=xd: library_chol_solve(*xd))
        for C_, D_ in PANELS_SHAPES:
            xd = spd(g, C_, D_, dev)
            name = f"chol_solve_c{C_}_d{D_}"
            shapes[name] = ("chol_solve", dict(C=C_, D=D_))
            groups[name] = {
                "kernel": lambda xd=xd: kernels.chol_solve(*xd),
                "plain": lambda xd=xd: kernels.chol_solve_plain(*xd),
                "library": lambda xd=xd: library_chol_solve(*xd),
                **_panels_sweep(xd)}
            if base is not None:
                groups[name]["baseline"] = lambda xd=xd: base.chol_solve(*xd)

    result = {}
    for name, cands in groups.items():
        panels = shapes[name][0] == "chol_solve" and kernels.chol_solve_plan(
            *shapes[name][1].values())["kernel"] == "panels"
        reps = PANELS_REPS if panels else 50
        result[name] = in_turns(cands, args.rounds, reps=reps)
        result[name]["kernel"]["paced_ms"] = paced_ms(cands["kernel"])
        result[name]["kernel"]["by_kernel"] = device_ms_by_kernel(
            cands["kernel"], reps=reps)
        if panels:
            for who in ("kernel", "baseline"):
                if who in cands:
                    result[name][who]["by_part"] = panels_parts(
                        device_ms_by_kernel(cands[who], reps=reps))
    for name, (kern, shape) in shapes.items():
        bound = kernels.kernel_bound(kern, **shape)
        result[name]["shape"] = shape
        result[name]["bound"] = bound
        result[name]["share_of_bound"] = (
            bound["bound_ms"] / result[name]["kernel"]["device_ms"])
    print(card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
