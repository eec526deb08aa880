"""The readings the limits of ``correct`` are set from: for each seed, the
numbers the check compares, for the program, for the program with a fault
planted underneath (``faults.py``), and for the control (the reference in
float32 with TF32 products put in the program's place), on the same calls
at the cell's own size.  Not run by ``run.py``.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 \
        --calls 2 [--fault NAME] [--control] [--out FILE]

Each seed sets the cell up as a run does, makes ``--calls`` timed calls
and prints one JSON line: {"seed", "fault", "numbers": the run's numbers
(``check.numbers``), "control_gap": the control's ``loglik_gap`` or null,
"seconds"}.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seed_readings(cell, config, seed, calls, device, control):
    from portbench import datagen, harness, spec
    from portbench.reference import check, conditionals
    raw = datagen.from_config(config, seed)
    mod = spec.load_entry(cell["entry"])
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        entry = mod.Entry(cell, config, raw, seed, device, work)
        entry.setup()
        for _ in range(calls):
            entry.call()
        answers = entry.answers()
        entry.free()
    curves = harness.curves_of(raw)
    out = {"seed": seed,
           "numbers": check.numbers(check.readings(
               answers, curves, device=device,
               zfields=conditionals.ZFIELDS)),
           "control_gap": None}
    if control:
        out["control_gap"] = check.numbers(check.readings(
            answers, curves, lower_device=device, zfields=()))["loglik_gap"]
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, default=2)
    p.add_argument("--fault")
    p.add_argument("--control", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import faults, spec
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    _, cell, config = spec.load_cell(args.workload)
    if args.fault:
        faults.FAULTS[args.fault](setattr, cell["limits"]["loglik_gap"])
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t = time.perf_counter()
            r = seed_readings(cell, config, seed, args.calls, "cuda",
                              args.control)
            r["fault"] = args.fault
            r["seconds"] = time.perf_counter() - t
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
