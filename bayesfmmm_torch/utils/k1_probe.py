"""Where K1's time goes on one NVIDIA GPU: the register-tiled kernel with one
part knocked out at a time.

    python3 -m bayesfmmm_torch.utils.k1_probe [--rounds 4]

No profiler that reads stall reasons runs everywhere, so this asks the card
directly: it patches ``csrc/chol_solve.cu`` in memory (the barrier of the
column loop, the diagonal's shuffle, the reciprocal square root, the stores
of L, the back substitutions, or the staging of A taken out), builds each
patched source with nvcc into ``_build/probe/``, and times the builds in
turns at the main path's shape (C=256, D=96), device time from the
profiler.  A knocked-out kernel computes nonsense: only its time means
anything, and the difference to the whole kernel is what that part costs
where it stands (for the barrier: the wait for the owners of the column,
not the instruction).  Each patch must match the source exactly once, so
the probe fails loudly when the kernel has moved on.  Prints the card's
name and power limit and one JSON object.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from bayesfmmm_torch.ops import kernels
from bayesfmmm_torch.utils.kernel_bench import (CHAINS, D, card_line,
                                                in_turns, spd)

# name -> [(text of csrc/chol_solve.cu, its replacement)]
KNOCK_OUTS = {
    "whole": [],
    "no_barrier": [("      __syncthreads();\n      float rv[TSP], cv[TSP];",
                    "      float rv[TSP], cv[TSP];")],
    "no_shuffle": [("      const float d = __shfl_sync(kFullWarp, a[jb][jb], "
                    "(jj % 2) * G + jj);",
                    "      const float d = a[jb][jb];")],
    "no_rsqrt": [("        const float inv = rsqrtf(d);",
                  "        const float inv = d * 1e-2f;")],
    "no_l_store": [("          S[i * LD + j] = l;\n", "")],
    "no_back_solves": [("  if (t < 32) {\n    float u[NV];",
                        "  if (t < 0) {\n    float u[NV];")],
    "no_staging": [("  if (wide) {\n    const int G4", 
                    "  if (D < 0) {\n    const int G4"),
                   ("  } else {\n    for (int idx = t; idx < D * D; idx += T)",
                    "  } else if (D < 0) {\n"
                    "    for (int idx = t; idx < D * D; idx += T)")],
}

# The same for the packed kernel (128 < D <= 334), timed at PACKED_SHAPE
PACKED_SHAPE = (16, 256)
PACKED_KNOCK_OUTS = {
    "whole": [],
    "no_barrier": [("  for (int j = 0; j < D; ++j) {\n    __syncthreads();\n"
                    "    const float* cur",
                    "  for (int j = 0; j < D; ++j) {\n    const float* cur")],
    "no_rsqrt": [("    const float inv = rsqrtf(cur[j]);",
                  "    const float inv = cur[j] * 1e-2f;")],
    "no_update": [("    for (int i = first; i <= D; i += W) {",
                   "    for (int i = first; i < 0; i += W) {")],
    "no_handoff": [("      __syncwarp();\n      nxt[i] = row[jn];\n"
                    "      row[j] = li;\n", "")],
    "threads_1024": [("constexpr int kPackedThreads = 512;",
                      "constexpr int kPackedThreads = 1024;")],
    "threads_256": [("constexpr int kPackedThreads = 512;",
                     "constexpr int kPackedThreads = 256;")],
    "no_back_solves": [("  if (warp == 0) {\n    // backward on both "
                        "right-hand sides along the rows of L",
                        "  if (warp < 0) {\n    // backward on both "
                        "right-hand sides along the rows of L")],
    "no_staging": [("    for (int k = lane; k <= i; k += 32) dst[k] = src[k];",
                    "    for (int k = lane; k < 0; k += 32) dst[k] = src[k];")],
}


def patched_sources(text, knock_outs=None):
    """{name: source text} for every knock-out (the register kernel's unless
    ``knock_outs`` is given); each patch must match ``text`` exactly once."""
    out = {}
    for name, patches in (knock_outs or KNOCK_OUTS).items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(
                    f"k1_probe: the patch {name!r} matches "
                    f"csrc/chol_solve.cu {src.count(old)} times, not once: "
                    f"{old!r}")
            src = src.replace(old, new)
        out[name] = src
    return out


def build_all(sources, out_dir):
    """Compile every patched source with nvcc, all at once; {name: CDLL}."""
    nvcc = kernels._find_nvcc()
    if nvcc is None:
        raise RuntimeError("k1_probe: nvcc not found")
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = []
    for name, text in sources.items():
        src, lib = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        src.write_text(text)
        cmd = [nvcc, *flags, "-shared", "-o", str(lib), str(src)]
        jobs.append((name, lib, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, lib, cmd, proc in jobs:
        said, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{said}")
        libs[name] = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        libs[name].bfmmm_chol_solve.argtypes = [p, p, p, p, p, i, i,
                                                ctypes.c_float, i, p]
        libs[name].bfmmm_chol_solve.restype = i
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--kernel", choices=("tiled", "packed"), default="tiled",
                    help="the register kernel at the headline shape, or the "
                         "packed kernel at 16 chains of D = 256")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_probe: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    text = (kernels._CSRC / "chol_solve.cu").read_text()
    packed = args.kernel == "packed"
    C, dim = PACKED_SHAPE if packed else (CHAINS, D)
    libs = build_all(
        patched_sources(text, PACKED_KNOCK_OUTS if packed else None),
        kernels._BUILD_DIR / "probe")
    A, b, z = spd(torch.Generator(device=dev).manual_seed(123), C, dim, dev)
    mean, noise = torch.empty_like(b), torch.empty_like(b)
    plan = kernels.chol_solve_plan(C, dim)
    tile = plan["tile"][0] if plan["tile"] else 0      # 0: the packed kernel

    def launcher(lib):
        def launch():
            rc = lib.bfmmm_chol_solve(
                A.data_ptr(), b.data_ptr(), z.data_ptr(), mean.data_ptr(),
                noise.data_ptr(), C, dim, 0.0, tile,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(
                    f"launch failed: {torch.cuda.CudaError(rc)}")
        return launch

    times = in_turns({name: launcher(lib) for name, lib in libs.items()},
                     args.rounds)
    whole = times["whole"]["device_ms"]
    for name, t in times.items():
        t["saves_ms"] = whole - t["device_ms"]
    print(card_line())
    print(json.dumps({"shape": dict(C=C, D=dim), "kernel": plan["kernel"],
                      "tile": tile, **times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
