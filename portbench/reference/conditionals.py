"""Each sampled field's full conditional at a returned state, worked out
again from the model's definition, and how far the program's draws lie
from it.

Every field F below enters the curves' mean coefficients linearly,

    w_n = sum_b W_bn F_b + e_n,

F in blocks F_b of P basis coordinates with weights W_bn and e_n the rest
of the mean, under a Gaussian prior N(0, Q_b^-1) per block.  Given every
other field, F is Gaussian with precision and linear term

    A = s sum_n W_an W_bn G_n + blockdiag(Q_b),
    b = s sum_n W_an (S_n' y_n - G_n e_n),

s = 1 / sigma2, S_n curve n's basis rows and G_n = S_n' S_n.  With A = L L'
the draw F gives z = L' (F - A^-1 b), which is N(0, I) where F is a draw of
its conditional: for every field at a state drawn from the posterior, and
whatever the chain's history for a field the sweep draws last.  The
fields, as BayesFMMM's updaters define them (UpdatePhi.h, UpdateXi.h,
UpdateNu.h, UpdateEta.h, UpdateChi.h):

  * ``Phi``: blocks (k, m), W = Z_nk chi_nm, prior precision
    prod_{m' <= m} delta_km' gamma_kpm (diagonal);
  * ``xi``: blocks (k, m, d), W = Z_nk chi_nm x_nd, prior
    prod_{m' <= m} delta_xi_km'd gamma_xi_kpdm;
  * ``nu``: blocks k, W = Z_nk, prior tau_k R with R the data's penalty
    (``model.Curves.R``): the first-order random walk D'D (D the (P-1, P)
    first differences) of a functional family, the graph of first
    differences along each axis of an hd family;
  * ``eta``: blocks (k, d), W = Z_nk x_nd, prior tau_eta_kd R;
  * ``chi``: per curve, chi_n in M coordinates with the directions
    U_n = sum_k Z_nk (Phi_k + sum_d xi_k[:, d, :] x_nd), prior N(0, I):
    precision I + s U_n' G_n U_n, linear term s U_n' (S_n' y_n - G_n a_n)
    with a_n the chi-free part of w_n.

``z2_sums`` returns, per field, the sum of z^2 over every coordinate of
every chain and their count; the check compares |mean z^2 - 1|.  It runs in
float64 with PyTorch on the device it is given, in blocks of chains.
"""

from __future__ import annotations

import numpy as np

ZFIELDS = ("Phi", "xi", "nu", "eta", "chi")


class Design:
    """What the conditionals need of the data, from the reference's own
    basis rows (``model.Curves``), in float64 on ``device``."""

    def __init__(self, curves, device):
        import torch
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                      device=device)
        S = t(curves.S) * t(curves.mask)[..., None]
        self.G = torch.einsum("nlp,nlq->npq", S, S)
        self.u = torch.einsum("nlp,nl->np", S, t(curves.y * curves.mask))
        self.X = t(curves.X)
        self.R = t(curves.R)
        self.device = device


def _blocks_z(d, W, F, Q, e, s):
    """z (C, B P) of blocks F (C, B, P) with weights W (C, B, N), prior
    precisions Q (C, B, P, P), rest e (C, N, P), s (C,)."""
    import torch
    C, B, N = W.shape
    P = F.shape[2]
    A = torch.einsum("can,cbn,npq->capbq", W, W, d.G) * s[:, None, None,
                                                           None, None]
    A = A + torch.einsum("cbpq,ab->capbq", Q,
                         torch.eye(B, dtype=Q.dtype, device=Q.device))
    A = A.reshape(C, B * P, B * P)
    r = d.u[None] - torch.einsum("npq,cnq->cnp", d.G, e)
    bvec = s[:, None] * torch.einsum("cbn,cnp->cbp", W, r).reshape(C, B * P)
    L = torch.linalg.cholesky(A)
    mean = torch.cholesky_solve(bvec[..., None], L)[..., 0]
    return (L.transpose(1, 2) @ (F.reshape(C, B * P) - mean)[..., None]
            )[..., 0]


def _field_z(name, st, d):
    """z of one field at the states ``st`` (float64 tensors, chain axis
    first), or None where the model has no such field."""
    import torch
    Z, chi, s = st["Z"], st["chi"], 1.0 / st["sigma2"].reshape(-1)
    X = d.X
    C, N, K = Z.shape
    P, M = st["Phi"].shape[2], st["Phi"].shape[3]
    Dn = X.shape[1]
    U = torch.einsum("cnk,ckpm->cnpm", Z, st["Phi"])
    a = torch.einsum("cnk,ckp->cnp", Z, st["nu"])
    if Dn > 0:
        U = U + torch.einsum("cnk,ckpdm,nd->cnpm", Z, st["xi"], X)
        a = a + torch.einsum("cnk,ckpd,nd->cnp", Z, st["eta"], X)
    w = a + torch.einsum("cnpm,cnm->cnp", U, chi)
    if name == "chi":
        GU = torch.einsum("npq,cnqm->cnpm", d.G, U)
        prec = s[:, None, None, None] * torch.einsum("cnpi,cnpj->cnij", U,
                                                     GU)
        prec = prec + torch.eye(M, dtype=prec.dtype, device=prec.device)
        r = d.u[None] - torch.einsum("npq,cnq->cnp", d.G, a)
        bvec = s[:, None, None] * torch.einsum("cnpm,cnp->cnm", U, r)
        L = torch.linalg.cholesky(prec)
        mean = torch.cholesky_solve(bvec[..., None], L)[..., 0]
        return (L.transpose(-1, -2) @ (chi - mean)[..., None])[..., 0]
    if name == "Phi":
        W = torch.einsum("cnk,cnm->ckmn", Z, chi).reshape(C, K * M, N)
        F = st["Phi"].permute(0, 1, 3, 2).reshape(C, K * M, P)
        pri = torch.cumprod(st["delta"], 2)[..., None] \
            * st["gamma"].permute(0, 1, 3, 2)                  # (C,K,M,P)
        Q = torch.diag_embed(pri.reshape(C, K * M, P))
    elif name == "nu":
        W = Z.permute(0, 2, 1)
        F = st["nu"]
        Q = st["tau"][..., None, None] * d.R
    elif Dn == 0:
        return None
    elif name == "xi":
        W = torch.einsum("cnk,cnm,nd->ckmdn", Z, chi, X).reshape(
            C, K * M * Dn, N)
        F = st["xi"].permute(0, 1, 4, 3, 2).reshape(C, K * M * Dn, P)
        pri = torch.cumprod(st["delta_xi"], 2)[..., None] \
            * st["gamma_xi"].permute(0, 1, 4, 3, 2)            # (C,K,M,D,P)
        Q = torch.diag_embed(pri.reshape(C, K * M * Dn, P))
    elif name == "eta":
        W = torch.einsum("cnk,nd->ckdn", Z, X).reshape(C, K * Dn, N)
        F = st["eta"].permute(0, 1, 3, 2).reshape(C, K * Dn, P)
        Q = st["tau_eta"].reshape(C, K * Dn)[..., None, None] * d.R
    else:
        raise KeyError(name)
    e = w - torch.einsum("cbn,cbp->cnp", W, F)
    return _blocks_z(d, W, F, Q, e, s)


def _tensors(states, lo, hi, device):
    import torch
    return {f: torch.as_tensor(np.asarray(states[f][lo:hi]),
                               dtype=torch.float64, device=device)
            for f in NEEDS}


NEEDS = {"Z", "chi", "sigma2", "Phi", "nu", "xi", "eta", "delta", "gamma",
         "tau", "delta_xi", "gamma_xi", "tau_eta"}


def z2_sums(states, design, fields=ZFIELDS, block=32):
    """{field: (sum of z^2, number of coordinates)} over every chain of
    ``states`` (a dict of arrays with a leading chain axis) for the fields
    the model has."""
    C = np.shape(states["sigma2"])[0]
    out = {}
    for c0 in range(0, C, block):
        st = _tensors(states, c0, c0 + block, design.device)
        for name in fields:
            z = _field_z(name, st, design)
            if z is None:
                continue
            s2, n = out.get(name, (0.0, 0))
            out[name] = (s2 + float((z * z).sum()), n + z.numel())
    return out

