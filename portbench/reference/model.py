"""The model's Gaussian log-likelihood, from its definition (BayesFMMM's
CalculateLikelihood.h, calcLikelihood), over the raw curves.

Curve n of the data is seen at its own time points t_n with values y_n
(a surface at its own points of the plane).  With S_n the basis at t_n
and the state's fields of one chain,

    mean_n = S_n sum_k Z_nk ( nu_k + eta_k x_n + (Phi_k + xi_k x_n) chi_n )
    loglik = sum_n sum_t log N(y_n(t) | mean_n(t), sigma2)

where eta_k x_n = sum_d eta_k[:, d] x_n[d] (P), Phi_k chi_n =
sum_m Phi_k[:, m] chi_n[m], and xi_k x_n is (P, M).  Without covariates
the eta and xi terms vanish.

``loglik`` computes it in float64 with NumPy.  ``loglik_lower`` is the
control: the same sum in float32 on PyTorch with its products in TF32
(the nearest precision below the program's float32 with TF32 off): every
factor rounded to TF32's 10-bit mantissa first, which is what the card's
TF32 path does to its inputs, on the card as on the CPU.  The card's own
TF32 switch would not do: cuBLAS takes its TF32 path for these products
only where the number of points a row is a multiple of 4, and a float32
path elsewhere (surfaces of 400 to 900 points, PERF.md).
"""

from __future__ import annotations

import math

import numpy as np

from portbench.reference.bspline import (basis_sizes, design, rw1_penalty,
                                         tensor_design, tensor_penalty)

LOG_2PI = math.log(2.0 * math.pi)
FIELDS = ("Z", "nu", "Phi", "chi", "eta", "xi", "sigma2")


class Curves:
    """The raw data as the reference sees it: per observation its basis
    rows (padded to the longest with zero rows), values and a mask, the
    covariates, and nu's prior penalty ``R``.  ``from_raw`` builds them by
    the data's family."""

    def __init__(self, y_list, rows_list, X, R):
        N = len(y_list)
        L = max(len(r) for r in rows_list)
        P = rows_list[0].shape[1]
        self.S = np.zeros((N, L, P))
        self.y = np.zeros((N, L))
        self.mask = np.zeros((N, L))
        for n, (yn, rows) in enumerate(zip(y_list, rows_list)):
            m = len(rows)
            self.S[n, :m] = rows
            self.y[n, :m] = np.asarray(yn, np.float64)
            self.mask[n, :m] = 1.0
        self.X = (np.zeros((N, 0)) if X is None
                  else np.asarray(X, np.float64).reshape(N, -1))
        self.R = np.asarray(R, np.float64)
        self.n_obs = float(self.mask.sum())

    @classmethod
    def from_raw(cls, raw):
        """From the raw inputs of ``datagen``: ``functional`` curves (the
        default) on a 1-D basis and the random-walk penalty, ``hd``
        surfaces on the tensor basis and its graph penalty."""
        family = raw.get("family", "functional")
        if family == "functional":
            rows = [design(t, raw["degree"], raw["internal"],
                           raw["boundary"]) for t in raw["t"]]
            R = rw1_penalty(rows[0].shape[1])
        elif family == "hd":
            rows = [tensor_design(t, raw["degrees"], raw["internal"],
                                  raw["boundary"]) for t in raw["t"]]
            R = tensor_penalty(basis_sizes(raw["degrees"], raw["internal"]))
        else:
            raise ValueError(f"the reference has no family {family!r}")
        return cls(raw["y"], rows, raw["X"], R)


def _coefficients(st, X, xp, rnd=lambda a: a):
    """(C, N, P) basis coefficients of every curve's mean; ``rnd`` rounds
    each factor of a contraction (the identity but for the control on the
    CPU)."""
    feat = st["nu"][:, None] + xp.einsum("ckpm,cnm->cnkp", st["Phi"],
                                         st["chi"])
    if X.shape[1] > 0:
        feat = feat + xp.einsum("ckpd,nd->cnkp", st["eta"], X)
        feat = feat + xp.einsum("ckpdm,nd,cnm->cnkp", st["xi"], X,
                                st["chi"])
    return xp.einsum("cnk,cnkp->cnp", st["Z"], rnd(feat))


def loglik(states, curves, block=64):
    """(C,) float64 log-likelihood of every chain in ``states`` (a dict of
    arrays with a leading chain axis, the fields of ``FIELDS``)."""
    C = np.shape(states["sigma2"])[0]
    out = np.empty(C)
    for c0 in range(0, C, block):
        st = {f: np.asarray(states[f][c0:c0 + block], np.float64)
              for f in FIELDS}
        w = _coefficients(st, curves.X, np)
        r = (curves.y - np.einsum("nlp,cnp->cnl", curves.S, w)) * curves.mask
        rss = np.einsum("cnl,cnl->c", r, r)
        s2 = st["sigma2"].reshape(-1)
        out[c0:c0 + block] = (-0.5 * curves.n_obs * (LOG_2PI + np.log(s2))
                              - 0.5 * rss / s2)
    return out


def round_tf32(x):
    """float32 tensor rounded to TF32 (10 explicit mantissa bits), to the
    nearest with ties away from zero, as the card converts its inputs."""
    import torch
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def loglik_lower(states, curves, device="cpu", block=64):
    """The control: ``loglik`` in float32 with TF32 products, on
    ``device``.  Returns (C,) float64 on the host."""
    import torch
    dev = torch.device(device)

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # the factors of the contractions are rounded, y and sigma2 not
    S, X = round_tf32(t32(curves.S)), round_tf32(t32(curves.X))
    y, mask = t32(curves.y), t32(curves.mask)
    C = np.shape(states["sigma2"])[0]
    out = np.empty(C)
    for c0 in range(0, C, block):
        st = {f: (t32(states[f][c0:c0 + block]) if f == "sigma2"
                  else round_tf32(t32(states[f][c0:c0 + block])))
              for f in FIELDS}
        w = round_tf32(_coefficients(st, X, torch, round_tf32))
        r = (y - torch.einsum("nlp,cnp->cnl", S, w)) * mask
        rss = (r * r).sum((1, 2))
        s2 = st["sigma2"].reshape(-1)
        ll = (-0.5 * curves.n_obs * (LOG_2PI + torch.log(s2))
              - 0.5 * rss / s2)
        out[c0:c0 + block] = ll.double().cpu().numpy()
    return out
