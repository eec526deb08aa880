"""Kernel K3's share of its roofline in the traced Gibbs call.  The work is
the weighted Gram sums a sweep needs (``ops/gibbs.py`` as of commit
f31a6434), the same in either census: ``update_nu`` one call on C K rows;
with covariates (D > 0, where the program draws eta) ``update_eta`` one on
C D K rows; and a joint draw above 4,096 coordinates, which no cell
reaches, is drawn block by block after one call on a row a block (C K M
for Phi, C K M D for xi).  Each bound is ``counts/kernel_bound.py``'s
``weighted_gram`` (R, N, P); their sum times the call's sweeps is divided
by the device time of K3's kernels, the tiled one (P <= 16) or the
chunked one, whichever ran.  None where neither did."""

from portbench.counts.kernel_bound import kernel_bound

UNIT = "%"
LAYER = "ops.kernels K3 weighted_gram"
MOVES = "chain_sweeps_per_s"
KERNELS = ("weighted_gram_tile_kernel", "weighted_gram_chunk_kernel")
# ops/gibbs.py::_JOINT_MAX_DIM
JOINT_MAX_DIM = 4096


def rows(config, chains):
    """The rows R of each K3 call one sweep of ``chains`` chains makes."""
    K, P, M, D = (config[k] for k in "KPMD")
    out = [chains * K]                                   # update_nu
    if D:
        out.append(chains * D * K)                       # update_eta
    if K * M * P > JOINT_MAX_DIM:
        out.append(chains * K * M)                       # Phi, sequential
    if D and config["covariate_cov"] and K * M * D * P > JOINT_MAX_DIM:
        out.append(chains * K * M * D)                   # xi, sequential
    return out


def read(ctx):
    if ctx.slice is None or not ctx.slice_call:
        return None
    seconds, n = ctx.slice.device_seconds(KERNELS)
    if not n or seconds <= 0:
        return None
    cfg = ctx.config
    bound_ms = sum(kernel_bound("weighted_gram", R=r, N=cfg["N"],
                                P=cfg["P"])["bound_ms"]
                   for r in rows(cfg, ctx.cell["chains"]))
    return 100.0 * bound_ms * 1e-3 * ctx.slice_call["sweeps"] / seconds
