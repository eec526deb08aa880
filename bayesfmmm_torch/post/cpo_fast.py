"""CPO via the Woodbury / matrix-determinant-lemma form, on the data's device.

The reference's CPO (CalculateLikelihood.h:344-386) assembles, for every
observation i and draw d, the dense chi-integrated covariance

    cov_i = U_i' U_i + sigma2 I_L,   U_i (M, L) = rows B_i(phi_m + xi_m x_i)
            weighted by memberships,

then pays O(L^3) for log-det + solve.  Because cov_i is a rank-M update of
a scaled identity, the determinant lemma and Woodbury identity give

    logdet = L log s2 + logdet(I_M + U U' / s2)
    r' cov^-1 r = ( r'r - r'U' (s2 I_M + U U')^-1 U r ) / s2

at O(L M^2 + M^3), batched over (draw, observation) in the data's dtype on
the data's device: the CUDA card as a rule.  With v = (s2 I_M + U U')^-1 U r
the quadratic form is taken as (|r - U'v|^2 + s2 |v|^2) / s2, a sum of
squares: the JAX package's r'r - w'w subtracts two sums of the order of
L (chi Phi)^2 / s2 and loses about 1e-3 nats to float32 rounding at 100
points a curve, this form about a tenth of that
(tests/data/make_torch_post_reference.py measures both against float64).

Port of ``bayesfmmm_tpu/post/cpo_fast.py``, where XLA lowers the same
function; here it is plain PyTorch ops.  Draws go through in chunks so that
device memory stays bounded (U alone is draws * N * M * L values); the
result does not depend on the chunk.  A factor that fails raises: the M x M
matrices are checked once, after the last chunk.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bayesfmmm_torch.ops.gibbs import use_full_f32
from bayesfmmm_torch.post import host

__all__ = ["marginal_loglik_matrix", "cpo_fast"]

_LOG_2PI = math.log(2.0 * math.pi)
# values of U a chunk of draws holds: 2**24 float32 values is 64 MB
CHUNK_VALUES = 1 << 24


def _draws(traces, name, start, stop, like):
    return torch.as_tensor(host(traces[name])[start:stop], dtype=like.dtype,
                           device=like.device)


def marginal_loglik_matrix(traces, data, X=None):
    """(N, draws) chi-integrated marginal log-liks as host NumPy, computed on
    ``data.device`` in the data's dtype, as many draws at a time as keep U
    within ``CHUNK_VALUES`` values.

    traces: iteration-major dict with nu, Phi, Z, sigma2 (+ eta, xi), as
    host arrays or tensors.
    """
    use_full_f32()
    y, mask, B = data.y, data.mask, data.B
    N, L = y.shape
    n_draws = host(traces["sigma2"]).shape[0]
    K, P, M = host(traces["Phi"]).shape[1:]
    Xa = (torch.zeros((N, 0), dtype=y.dtype, device=y.device) if X is None
          else torch.as_tensor(host(X), dtype=y.dtype,
                               device=y.device).reshape(N, -1))
    has_eta = "eta" in traces and host(traces["eta"]).size > 0 \
        and Xa.shape[1] > 0
    has_xi = "xi" in traces and host(traces["xi"]).size > 0 \
        and Xa.shape[1] > 0
    chunk_draws = max(1, CHUNK_VALUES // (N * M * L))
    n_i = mask.sum(dim=1)                                  # (N,)
    eye = torch.eye(M, dtype=y.dtype, device=y.device)
    failed = torch.zeros((), dtype=torch.bool, device=y.device)
    out = []
    for s in range(0, n_draws, chunk_draws):
        e = min(s + chunk_draws, n_draws)
        nu = _draws(traces, "nu", s, e, y)                 # (d, K, P)
        Phi = _draws(traces, "Phi", s, e, y)               # (d, K, P, M)
        Z = _draws(traces, "Z", s, e, y)                   # (d, N, K)
        s2 = _draws(traces, "sigma2", s, e, y)             # (d,)
        # per observation: w = Z_i (nu + eta x_i), V = Z_i (Phi + xi x_i)
        w = torch.einsum("dnk,dkp->dnp", Z, nu)
        V = torch.einsum("dnk,dkpm->dnpm", Z, Phi)
        if has_eta:
            eta = _draws(traces, "eta", s, e, y)           # (d, K, P, D)
            w = w + torch.einsum("dnk,dkpc,nc->dnp", Z, eta, Xa)
        if has_xi:
            xi = _draws(traces, "xi", s, e, y)             # (d, K, P, D, M)
            V = V + torch.einsum("dnk,dkpcm,nc->dnpm", Z, xi, Xa)
        mean = torch.einsum("nlp,dnp->dnl", B, w)
        U = torch.einsum("nlp,dnpm->dnml", B, V) * mask[:, None, :]
        r = (y - mean) * mask                              # (d, N, L)
        Ur = torch.einsum("dnml,dnl->dnm", U, r)
        s2b = s2[:, None, None, None]
        A = s2b * eye + U @ U.mT                           # (d, N, M, M)
        Lc, info = torch.linalg.cholesky_ex(A)
        failed |= (info != 0).any()
        # v = A^-1 U r: r' cov^-1 r = (|r - U'v|^2 + s2 |v|^2) / s2
        v = torch.cholesky_solve(Ur[..., None], Lc)        # (d, N, M, 1)
        res = r - (U * v).sum(-2)                          # (d, N, L)
        s2n = s2[:, None]
        quad = (res * res).sum(-1) / s2n + (v[..., 0] * v[..., 0]).sum(-1)
        logdet = n_i * torch.log(s2n) \
            + 2.0 * torch.log(torch.diagonal(Lc, dim1=-2, dim2=-1)).sum(-1) \
            - M * torch.log(s2n)
        out.append(-0.5 * (n_i * _LOG_2PI + logdet + quad))   # (d, N)
    if bool(failed):
        raise np.linalg.LinAlgError(
            "cpo: sigma2 I + U U' is not positive definite for some (draw, "
            "observation); the traces hold a sigma2 <= 0 or non-finite values")
    return torch.cat(out, 0).T.cpu().numpy()


def cpo_fast(traces, data, *, burnin_prop=0.1, X=None):
    """Stabilized harmonic-mean CPO (CalculateLikelihood.h:377-382)."""
    n = host(traces["sigma2"]).shape[0]
    keep = int(round(n * (1.0 - burnin_prop)))
    tr = {k: host(v)[n - keep:] for k, v in traces.items()}
    logl = marginal_loglik_matrix(tr, data, X)
    D = logl.shape[1]
    lmin = logl.min(axis=1, keepdims=True)
    return np.log(D) + lmin[:, 0] - np.log(
        np.exp(lmin - logl).sum(axis=1))
