"""Where K1's time goes on one NVIDIA GPU: one of its kernels with one part
knocked out at a time.

    python3 -m bayesfmmm_torch.utils.k1_probe [--kernel tiled|blocked|panels]
                                              [--rounds 4]

No profiler that reads stall reasons runs everywhere, so this asks the card
directly: it patches the kernel's source (``csrc/chol_solve.cu``, or
``csrc/chol_solve_panels.cu`` for the panels kernel) in memory, one part
taken out at a time, builds each patched source with nvcc into
``_build/probe/``, and times the builds in turns, device time from the
profiler.  The register
kernel (``--kernel tiled``, the default) is timed at the main path's shape
(C=256, D=96) without the barrier of the column loop, the diagonal's
shuffle, the reciprocal square root, the stores of L, the back
substitutions or the staging of A; the blocked kernel (``--kernel
blocked``) at 16 chains of D = 256 without the diagonal block's factor,
its reciprocal square roots, the panel solve, the trailing update, the
panel loop's barriers, the back substitutions or the staging, and beside
it the alternatives its design set aside (``alt_*``: the same function;
panels of 16 columns, the update's rows past D masked, lanes column tile
first, the diagonal shuffled after the column's update, the back
substitutions' steps not unrolled, 1,024 threads, a look-ahead).  The
panels kernel (``--kernel panels``) at (16, 512), (256, 512) and (1, 4096)
with the plan's panel width, cluster and update blocks an SM (``--panel``
another width) without the first or the later diagonal blocks' factor,
the factor's 32 x 32 steps in one warp, its work below each 32 x 32
block, its inverse's block rows, the panel products, the trailing
updates' products, or the back substitutions' owner steps or updates;
with the first factor run twice (``warm_factor``: its cost once its code
is in the instruction cache); and beside it the update compiled for the
other blocks an SM (``alt_update_blocks``); each also split by launch
(``kernel_bench.panels_parts``).  A knocked-out kernel computes nonsense:
only its time means anything, and the difference to the whole kernel is
what that part costs where it stands (for a barrier: the wait for the
slowest thread, not the instruction).  Each patch must match
the source exactly once, so the probe fails loudly when the kernel has
moved on.  Prints the card's name and power limit and one JSON object.
Needs one card.
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
                                                device_ms_by_kernel, in_turns,
                                                panels_parts, spd)

_PANEL_LOOP = """\
    if (warp == 0) factor_diagonal_block<NB>(a, k0, nb, lane);
    __syncthreads();
    for (int i = s + tid; i <= D; i += T) solve_panel_row<NB>(a, k0, nb, i);
    __syncthreads();
    if (s < D) update_trailing<NB>(a, k0, s, D, warp, lane);
    __syncthreads();
"""
_PANEL_HEAD = """\
  for (int k0 = 0; k0 < D; k0 += NB) {
    const int nb = min(NB, D - k0), s = k0 + nb;
"""
# the panel loop with a look-ahead: the next panel's columns are updated
# first, then warp 0 factors its diagonal block while the others update the
# rest (three barriers a panel, as now)
_LOOK_AHEAD_LOOP = """\
  if (warp == 0) factor_diagonal_block<NB>(a, 0, min(NB, D), lane);
  __syncthreads();
""" + _PANEL_HEAD + """\
    for (int i = s + tid; i <= D; i += T) solve_panel_row<NB>(a, k0, nb, i);
    __syncthreads();
    if (s < D) {
      update_trailing<NB>(a, k0, s, D, 0, NB / 4, 0, W, warp, lane);
      __syncthreads();
      if (warp == 0)
        factor_diagonal_block<NB>(a, s, min(NB, D - s), lane);
      else
        update_trailing<NB>(a, k0, s, D, NB / 4, D, 1, W - 1, warp, lane);
      __syncthreads();
    }
"""

# kernel -> {name: [(text of csrc/chol_solve.cu, its replacement)]}
KNOCK_OUTS = {
    "tiled": {
        "whole": [],
        "no_barrier": [("      __syncthreads();\n      float rv[TSP], cv[TSP];",
                        "      float rv[TSP], cv[TSP];")],
        "no_shuffle": [("      const float d = __shfl_sync(kFullWarp, "
                        "a[jb][jb], (jj % 2) * G + jj);",
                        "      const float d = a[jb][jb];")],
        "no_rsqrt": [("        const float inv = rsqrtf(d);",
                      "        const float inv = d * 1e-2f;")],
        "no_l_store": [("          S[i * LD + j] = l;\n", "")],
        "no_back_solves": [("  if (t < 32) {\n    float u[NV];",
                            "  if (t < 0) {\n    float u[NV];")],
        "no_staging": [("  if (wide) {\n    const int G4",
                        "  if (D < 0) {\n    const int G4"),
                       ("  } else {\n    for (int idx = t; idx < D * D; "
                        "idx += T)",
                        "  } else if (D < 0) {\n"
                        "    for (int idx = t; idx < D * D; idx += T)")],
    },
    "blocked": {
        "whole": [],
        "no_diagonal_block": [
            ("    if (warp == 0) factor_diagonal_block<NB>",
             "    if (warp < 0) factor_diagonal_block<NB>")],
        "no_rsqrt": [
            ("      const float inv = rsqrtf(d);\n      const float l = lane > j",
             "      const float inv = d * 1e-2f;\n      const float l = lane > j")],
        "no_panel_solve": [("i <= D; i += T) solve_panel_row<NB>",
                            "i < 0; i += T) solve_panel_row<NB>")],
        "no_trailing_update": [("    if (s < D) update_trailing<NB>",
                                "    if (s < 0) update_trailing<NB>")],
        "no_barriers": [(_PANEL_LOOP,
                         _PANEL_LOOP.replace("    __syncthreads();\n", ""))],
        "no_back_solves": [("  if (warp == 0) {\n    // x <- L^-T x for w",
                            "  if (warp < 0) {\n    // x <- L^-T x for w")],
        "no_staging": [("  for (int i = warp; i < D; i += W) {\n"
                        "    const float* src = Ag",
                        "  for (int i = warp; i < 0; i += W) {\n"
                        "    const float* src = Ag")],
        # the alternatives the design set aside: the same function
        "alt_panel_16": [("      return (int)launch_blocked<32>(",
                          "      return (int)launch_blocked<16>(")],
        "alt_masked_update": [
            ("    for (int r = 0; r < 4; ++r) rv[r] = ld4(a + ro[r] + 4 * q);\n",
             "    for (int r = 0; r < 4; ++r)\n      rv[r] = i0 + r > D ? "
             "make_float4(0.f, 0.f, 0.f, 0.f) : ld4(a + ro[r] + 4 * q);\n"),
            ("      const float4 cv = ld4(a + co[c] + 4 * q);\n",
             "      const float4 cv = c0 + c >= D ? make_float4(0.f, 0.f, 0.f, "
             "0.f) : ld4(a + co[c] + 4 * q);\n")],
        "alt_lanes_column_first": [
            ("const int rt = lane & 3, ct = lane >> 2;",
             "const int rt = lane >> 3, ct = lane & 7;")],
        "alt_diagonal_last": [
            ("      const float inv = rsqrtf(d);\n      const float l = lane > j",
             "      const float inv = rsqrtf(__shfl_sync(kFullWarp, x[j], j));\n"
             "      const float l = lane > j"),
            ("        d = __shfl_sync(kFullWarp, fmaf(-l, l, x[j + 1]), j + 1);\n",
             "")],
        "alt_steps_not_unrolled": [
            ("#pragma unroll 4\n      for (int l = min(31, D - 1 - 32 * mb);",
             "      for (int l = min(31, D - 1 - 32 * mb);")],
        "alt_threads_1024": [("constexpr int kBlockedThreads = 512;",
                              "constexpr int kBlockedThreads = 1024;")],
        "alt_look_ahead": [
            ("                                                int warp, int "
             "lane) {\n  const int n_rows = (D - s) / 4 + 1, n_cols = "
             "(D - s + 3) / 4;",
             "    int t_lo, int t_hi, int w0, int nw, int warp, int lane) {\n"
             "  const int n_rows = (D - s) / 4 + 1,\n"
             "            n_cols = min((D - s + 3) / 4, t_hi);"),
            ("    for (int gb = 0; gb < n_groups; ++gb, ++u) {\n"
             "      const int ta = 4 * ga + rt, tb = 8 * gb + ct;\n"
             "      if (u % kBlockedWarps == warp && tb <= ta",
             "    for (int gb = t_lo / 8; gb < n_groups; ++gb, ++u) {\n"
             "      const int ta = 4 * ga + rt, tb = 8 * gb + ct;\n"
             "      if (u % nw == warp - w0 && t_lo <= tb && tb <= ta"),
            (_PANEL_HEAD + _PANEL_LOOP, _LOOK_AHEAD_LOOP)],
    },
    "panels": {
        "whole": [],
        "no_first_factor": [
            ("  factor_diagonal_block<NB, SP>(S, S + NB * SP, nb);\n", "")],
        "no_corner_factor": [
            ("    factor_diagonal_block<NB, TS>(T, T + kTile * TS, nbn);\n",
             "")],
        "no_warp_steps": [("    if (warp == 0) factor_32<SP>(",
                           "    if (warp < 0) factor_32<SP>(")],
        "no_block_below": [
            ("    if (q1 < nb) {\n#pragma unroll 2",
             "    if (q1 < 0) {\n#pragma unroll 2"),
            ("    if (q1 < nb) {\n#pragma unroll\n",
             "    if (q1 < 0) {\n#pragma unroll\n")],
        "no_inverse_blocks": [
            ("    for (int t = tid; t < 2 * q0; t += kThreads) {\n"
             "      const int k = 4",
             "    for (int t = tid; t < 0; t += kThreads) {\n"
             "      const int k = 4"),
            ("    for (int t = tid; t < 2 * q0; t += kThreads)\n"
             "      inverse_block_row",
             "    for (int t = tid; t < 0; t += kThreads)\n"
             "      inverse_block_row")],
        "no_panel_product": [("  for (int kb = 0; kb < H; ++kb) {",
                              "  for (int kb = 0; kb < 0; ++kb) {")],
        "no_update_product": [
            ("    if (diag)\n      stage_product<true>",
             "    if (diag && kc < 0)\n      stage_product<true>"),
            ("    else\n      stage_product<false>",
             "    else if (kc < 0)\n      stage_product<false>")],
        "no_solve_owner": [("    if (rank == owner) {\n      // x_p",
                            "    if (rank < 0) {\n      // x_p")],
        "no_solve_updates": [("    for (int t = 0; t < nq; ++t) {",
                              "    for (int t = 0; t < 0; ++t) {")],
        # the first factor run twice in a loop: what a run costs once its
        # code is in the instruction cache
        "warm_factor": [
            ("  factor_diagonal_block<NB, SP>(S, S + NB * SP, nb);\n",
             "#pragma unroll 1\n  for (int rep = 0; rep < 2; ++rep)\n"
             "    factor_diagonal_block<NB, SP>(S, S + NB * SP, nb);\n")],
    },
}
# the source each kernel's knock-outs patch
SOURCES = {"tiled": "chol_solve.cu", "blocked": "chol_solve.cu",
           "panels": "chol_solve_panels.cu"}
# the shapes each kernel is probed at
SHAPES = {"tiled": ((CHAINS, D),), "blocked": ((16, 256),),
          "panels": ((16, 512), (CHAINS, 512), (1, 4096))}


def patched_sources(text, knock_outs, source="csrc/chol_solve.cu"):
    """{name: source text} for every knock-out of ``knock_outs`` (one of
    ``KNOCK_OUTS``); each patch must match ``text`` (of ``source``) exactly
    once."""
    out = {}
    for name, patches in knock_outs.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(
                    f"probe: the patch {name!r} matches {source} "
                    f"{src.count(old)} times, not once: {old!r}")
            src = src.replace(old, new)
        out[name] = src
    return out


def _bind_chol_solve(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bfmmm_chol_solve.argtypes = [p, p, p, p, p, i, i, ctypes.c_float, i,
                                     p]
    lib.bfmmm_chol_solve.restype = i


def _bind_chol_solve_panels(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bfmmm_chol_solve_panels.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                            ctypes.c_float, i, i, i, p]
    lib.bfmmm_chol_solve_panels.restype = i


def build_all(sources, out_dir, bind=_bind_chol_solve):
    """Compile every patched source with nvcc, all at once, and ``bind``
    each library's entry point; {name: CDLL}."""
    nvcc = kernels._find_nvcc()
    if nvcc is None:
        raise RuntimeError("probe: nvcc not found")
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
        bind(libs[name])
    return libs


def _panels_launcher(lib, A, b, z, nb, cs, ub):
    """One call of the panels kernel of ``lib`` at panel width nb, cluster
    cs and ub update blocks an SM, its scratch allocated once."""
    C, dim = b.shape
    ld = kernels.panels_ld(dim)
    work = torch.empty(C, dim + 1, ld, device=b.device)
    eps = torch.empty(C, device=b.device)
    mean, noise = torch.empty_like(b), torch.empty_like(b)

    def launch():
        rc = lib.bfmmm_chol_solve_panels(
            A.data_ptr(), b.data_ptr(), z.data_ptr(), mean.data_ptr(),
            noise.data_ptr(), work.data_ptr(), eps.data_ptr(), C, dim, ld,
            0.0, nb, cs, ub, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {torch.cuda.CudaError(rc)}")
    return launch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--kernel", choices=tuple(KNOCK_OUTS), default="tiled",
                    help="the register kernel at the headline shape, the "
                         "blocked kernel at 16 chains of D = 256, or the "
                         "panels kernel at D = 512 and 4,096")
    ap.add_argument("--panel", type=int, default=None,
                    help="the panels kernel's width, if not the plan's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_probe: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    source = SOURCES[args.kernel]
    text = (kernels._CSRC / source).read_text()
    panels = args.kernel == "panels"
    libs = build_all(patched_sources(text, KNOCK_OUTS[args.kernel],
                                     f"csrc/{source}"),
                     kernels._BUILD_DIR / "probe",
                     _bind_chol_solve_panels if panels else _bind_chol_solve)
    g = torch.Generator(device=dev).manual_seed(123)
    out = []
    for C, dim in SHAPES[args.kernel]:
        A, b, z = spd(g, C, dim, dev)
        plan = kernels.chol_solve_plan(C, dim)
        if panels:
            nb = args.panel or plan["panel"]
            cands = {name: _panels_launcher(lib, A, b, z, nb, plan["cluster"],
                                            plan["update_blocks"])
                     for name, lib in libs.items()}
            # the design's alternative: the update compiled for the other
            # number of blocks an SM
            cands["alt_update_blocks"] = _panels_launcher(
                libs["whole"], A, b, z, nb, plan["cluster"],
                3 - plan["update_blocks"])
            shape = dict(C=C, D=dim, panel=nb, cluster=plan["cluster"],
                         update_blocks=plan["update_blocks"])
        else:
            code = kernels.chol_solve_code(plan)
            mean, noise = torch.empty_like(b), torch.empty_like(b)

            def launcher(lib, C=C, dim=dim, A=A, b=b, z=z, mean=mean,
                         noise=noise, code=code):
                def launch():
                    rc = lib.bfmmm_chol_solve(
                        A.data_ptr(), b.data_ptr(), z.data_ptr(),
                        mean.data_ptr(), noise.data_ptr(), C, dim, 0.0, code,
                        torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(
                            f"launch failed: {torch.cuda.CudaError(rc)}")
                return launch
            cands = {name: launcher(lib) for name, lib in libs.items()}
            shape = dict(C=C, D=dim, code=code)
        reps = 10 if panels else 50
        times = in_turns(cands, args.rounds, reps=reps)
        whole = times["whole"]["device_ms"]
        for name, t in times.items():
            t["saves_ms"] = whole - t["device_ms"]
            if panels:
                t["by_part"] = panels_parts(device_ms_by_kernel(
                    cands[name], reps=reps))
        out.append({"shape": shape, "kernel": plan["kernel"], **times})
    print(card_line())
    print(json.dumps(out if panels else out[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
