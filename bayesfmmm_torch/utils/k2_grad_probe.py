"""Where the time of K2's backward (``mean_rss_grad``) goes on one NVIDIA
GPU: its kernel with one part knocked out at a time, and the alternatives
its design set aside.

    python3 -m bayesfmmm_torch.utils.k2_grad_probe [--rounds 4]

As ``utils/k1_probe.py`` does for K1: it patches ``csrc/mean_rss.cu`` in
memory, builds each patched source with nvcc into ``_build/probe/`` and
times the builds in turns (device time from the profiler), at fit_hmc's 64
chains (N = L = 100, P = 8), at the hd family's P = 16 (N = 64, L = 144)
and at one chain, each with ``mean_rss_grad_plan``'s layout.  Knock-outs
(the kernel then computes nonsense; only the time means anything): the
copies to shared memory, the chunk's barrier, the residual's dot product,
the accumulation, every point, the lanes' shuffle tree.  Alternatives
(``alt_*``): the out-of-range points masked once a point instead of each
element of B's row, more or fewer points a loop step, the U points' dot
products interleaved (k outside), that and the next U points' rows loaded
while these are used (all the same bits), the dot product as two chains
(other bits).  Each patch must match the source exactly once.  Prints the card's name and power
limit and one JSON object.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from bayesfmmm_torch.ops import kernels
from bayesfmmm_torch.utils.k1_probe import build_all, patched_sources
from bayesfmmm_torch.utils.kernel_bench import card_line, in_turns

_U = "  constexpr int U = KP <= 8 ? 4 : (KP <= 16 ? 2 : 1);  // points a step"
_SELECTS = """\
            b[u][k] = ok ? v.x : 0.0f;
            b[u][k + 1] = ok ? v.y : 0.0f;
            b[u][k + 2] = ok ? v.z : 0.0f;
            b[u][k + 3] = ok ? v.w : 0.0f;
"""
_NO_SELECTS = """\
            b[u][k] = v.x;
            b[u][k + 1] = v.y;
            b[u][k + 2] = v.z;
            b[u][k + 3] = v.w;
"""
_R = "        const float r = yv[u] - m[u];"
_DOT = ("        for (int k = 0; k < KP; ++k) "
        "m[u] = fmaf(b[u][k], wr[k], m[u]);\n")
_ACC = ("        for (int k = 0; k < KP; ++k) "
        "acc[k] = fmaf(r, b[u][k], acc[k]);\n")

# name -> [(text of csrc/mean_rss.cu, its replacement)]
KNOCK_OUTS = {
    "whole": [],
    "no_copies": [
        ("  stage(0);\n  if (!SPLIT && P < KP) {",
         "  if (!SPLIT && P < KP) {"),
        ("      stage(ch + 1);\n      __pipeline_wait_prior(1);",
         "      __pipeline_wait_prior(1);")],
    "no_barrier": [
        ("    __syncthreads();                       "
         "// chunk ch is in shared memory\n", "")],
    "no_dot": [(_DOT, "")],
    "no_accumulate": [(_ACC, "")],
    "no_points": [("    for (int j0 = 0; j0 < lc; j0 += U * SL) {",
                   "    for (int j0 = 0; j0 < 0; j0 += U * SL) {")],
    "no_tree": [("      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);",
                 "      acc[k] *= 1.0f;")],
    "alt_mask_r": [(_SELECTS, _NO_SELECTS),
                   (_R, "        const float r = j0 + u * SL + sl < lc "
                        "? yv[u] - m[u] : 0.0f;")],
    "alt_more_points": [(_U, _U.replace("? 4 : (KP <= 16 ? 2 : 1)",
                                        "? 8 : (KP <= 16 ? 4 : 1)"))],
    "alt_fewer_points": [(_U, _U.replace("? 4 : (KP <= 16 ? 2 : 1)",
                                         "? 2 : 1"))],
    "alt_two_chains": [(_DOT, """\
        float m1 = 0.0f;
#pragma unroll
        for (int k = 0; k < KP; k += 2) {
          m[u] = fmaf(b[u][k], wr[k], m[u]);
          m1 = fmaf(b[u][k + 1], wr[k + 1], m1);
        }
        m[u] += m1;
""")],
}
# the points loop as it stands, and the same loop with the next U points'
# rows loaded into a second set of registers while these are used (and the
# U dot products interleaved, k outside)
_LOAD = """\
        const int i = j0 + u * SL + sl;
        const bool ok = i < lc;            // past the chunk: B = 0, y = 0
        const float* row = Bc + (size_t)(ok ? i : 0) * PS;
        if (!SPLIT) {
#pragma unroll
          for (int k = 0; k < KP; k += 4) {
            const float4 v = reinterpret_cast<const float4*>(row)[k / 4];
""" + _SELECTS + """\
          }
        } else {
#pragma unroll
          for (int k = 0; k < KP; ++k) {
            const int p = sp + k * SP;
            b[u][k] = ok && p < P ? row[p] : 0.0f;
          }
        }
        yv[u] = ok ? yc[i] : 0.0f;
"""
_SHUFFLE_DOTS = """\
      if (SPLIT) {                         // the SP lanes' partial products
#pragma unroll
        for (int u = 0; u < U; ++u)
          for (int o = 1; o < SP; o <<= 1)
            m[u] += __shfl_xor_sync(0xffffffffu, m[u], o);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float r = yv[u] - m[u];
#pragma unroll
""" + _ACC + """\
      }
"""
_LOOP = """\
    for (int j0 = 0; j0 < lc; j0 += U * SL) {
      float b[U][KP], yv[U], m[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
""" + _LOAD + """\
        m[u] = 0.0f;
#pragma unroll
""" + _DOT + """\
      }
""" + _SHUFFLE_DOTS + """\
    }
"""
_PREFETCH = """\
    auto load = [&](int j0, float (&b)[U][KP], float (&yv)[U]) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
""" + _LOAD + """\
      }
    };
    float b[U][KP], yv[U];
    load(0, b, yv);
    for (int j0 = 0; j0 < lc; j0 += U * SL) {
      float bn[U][KP], yn[U], m[U];
      load(j0 + U * SL, bn, yn);
#pragma unroll
      for (int u = 0; u < U; ++u) m[u] = 0.0f;
#pragma unroll
      for (int k = 0; k < KP; ++k)
#pragma unroll
        for (int u = 0; u < U; ++u) m[u] = fmaf(b[u][k], wr[k], m[u]);
""" + _SHUFFLE_DOTS + """\
#pragma unroll
      for (int u = 0; u < U; ++u) {
        yv[u] = yn[u];
#pragma unroll
        for (int k = 0; k < KP; ++k) b[u][k] = bn[u][k];
      }
    }
"""
_KOUTER = ("        m[u] = 0.0f;\n      }\n#pragma unroll\n"
           "      for (int k = 0; k < KP; ++k)\n#pragma unroll\n"
           "        for (int u = 0; u < U; ++u) "
           "m[u] = fmaf(b[u][k], wr[k], m[u]);\n")
KNOCK_OUTS.update({
    # the dot products of the U points interleaved, k outside (same bits)
    "alt_k_outer": [("        m[u] = 0.0f;\n#pragma unroll\n" + _DOT
                     + "      }\n", _KOUTER)],
    # and the next U points' rows loaded while these are used (same bits)
    "alt_prefetch": [(_LOOP, _PREFETCH)],
})
# (C, N, L, P) the probe times every build at
SHAPES = ((64, 100, 100, 8), (64, 64, 144, 16), (1, 100, 100, 8))


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bfmmm_mean_rss_grad.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                        i, i, p]
    lib.bfmmm_mean_rss_grad.restype = i


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_grad_probe: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    text = (kernels._CSRC / "mean_rss.cu").read_text()
    libs = build_all(patched_sources(text, KNOCK_OUTS, "csrc/mean_rss.cu"),
                     kernels._BUILD_DIR / "probe", _bind)
    g = torch.Generator(device=dev).manual_seed(123)
    result = {}
    for C, N, L, P in SHAPES:
        B = torch.randn(N, L, P, generator=g, device=dev)
        y = torch.randn(N, L, generator=g, device=dev)
        w = torch.randn(C, N, P, generator=g, device=dev)
        gv = torch.randn(C, generator=g, device=dev)
        grad = torch.empty_like(w)
        plan = kernels.mean_rss_grad_plan(C, N, L, P)

        def launcher(lib):
            def launch():
                rc = lib.bfmmm_mean_rss_grad(
                    B.data_ptr(), y.data_ptr(), w.data_ptr(), gv.data_ptr(),
                    grad.data_ptr(), C, N, L, P, plan["KP"], plan["SP"],
                    plan["SL"], plan["TC"], plan["LC"],
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(
                        f"launch failed: {torch.cuda.CudaError(rc)}")
            return launch

        times = in_turns({name: launcher(lib) for name, lib in libs.items()},
                         args.rounds)
        whole = times["whole"]["device_ms"]
        for t in times.values():
            t["saves_ms"] = whole - t["device_ms"]
        result[f"C={C},N={N},L={L},P={P}"] = {"plan": plan, **times}
    print(card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
