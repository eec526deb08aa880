"""Bytes, FLOP and the least time one H100 could take for one call of each
of the port's kernels, from its shapes.

A frozen copy of ``kernel_bound`` and the ``PEAK_*`` constants of
``bayesfmmm_torch/ops/kernels.py`` at commit 29f7e3a7.  Every input is read
once and every output written once (float32; of K1's symmetric A the one
triangle that defines it); the bound is the larger of bytes over the
memory peak and FLOP over the float32 peak outside the tensor cores (the
port runs float32 with TF32 off).
"""

from __future__ import annotations

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# device memory 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def kernel_bound(name, **shape):
    """{"bytes", "flop", "bound_ms", "bound_by"} of one call.  Shapes by
    keyword: ``chol_solve`` C, D; ``mean_rss`` C, N, L, P and want_mu;
    ``mean_rss_grad`` C, N, L, P; ``weighted_gram`` R, N, P."""
    if name == "chol_solve":
        C, D = shape["C"], shape["D"]
        # a triangle of A, b and z in; mean and noise out
        floats = C * (D * (D + 1) // 2 + 4 * D)
        # factor D^3/3; forward solve of b, back solves of w and z: 3 D^2
        flop = C * (D ** 3 / 3 + 3 * D * D)
    elif name == "mean_rss":
        C, N, L, P = (shape[k] for k in "CNLP")
        floats = N * L * P + N * L + C * N * P + C     # B, y, w in; rss out
        if shape.get("want_mu", False):
            floats += C * N * L
        # per chain and point: P multiply-adds, the residual, its square
        # and the sum
        flop = C * N * L * (2 * P + 3)
    elif name == "mean_rss_grad":
        C, N, L, P = (shape[k] for k in "CNLP")
        # B, y, w and g in; grad_w out
        floats = N * L * P + N * L + 2 * C * N * P + C
        # per chain and point: the residual's P multiply-adds and its
        # difference, then P multiply-adds into grad_w
        flop = C * N * L * (4 * P + 1)
    elif name == "weighted_gram":
        R, N, P = shape["R"], shape["N"], shape["P"]
        floats = R * N + N * P * P + R * P * P         # W, G in; out
        flop = 2 * R * N * P * P
    else:
        raise KeyError(name)
    t_bytes = 4 * floats / PEAK_BYTES_PER_S
    t_flop = flop / PEAK_F32_FLOP_PER_S
    return {"bytes": 4 * floats, "flop": flop,
            "bound_ms": 1e3 * max(t_bytes, t_flop),
            "bound_by": "bytes" if t_bytes >= t_flop else "operations"}
