"""Run one cell of ``BENCHMARK.json`` once on the card and print one line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``check``:
each number compared beside its limit); the same numbers close standard
error.  Exits 2 without a result where PyTorch sees no CUDA card or fewer
cards than the cell asks for, and 3 where JAX, its libraries or the JAX
package were loaded into this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bayesfmmm_tpu")


def _fixed_caches():
    """Every kernel cache inside the checkout, at a fixed path, before
    anything that reads these is imported; few host threads."""
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "2"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))
    from portbench import harness, spec
    bench, cell, config = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell asks for {cell['chips']} CUDA card(s), "
              f"PyTorch sees {n}; nothing was measured", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, call_seconds = harness.run(
        bench, cell, config, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device="cuda", t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the port must not load: "
              f"{', '.join(bad)}; no result", file=sys.stderr)
        return 3
    print("seconds of each timed call: "
          + " ".join(f"{dt:.3f}" for dt in call_seconds),
          file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    for name, row in result["check"].items():
        print(f"check {name} = {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
