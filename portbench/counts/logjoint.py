"""Analytic FLOP of one value and gradient of the whole-model log-joint
(``models/logjoint.py``'s ``make_log_joint`` as of commit 29f7e3a7) for
one chain, without covariates: the transforms, the mean's coefficients
(Z times nu + Phi chi), the residual sum of squares through K2 and the
prior terms.  Reverse mode is counted at twice the forward pass, except
K2's backward, which is its own kernel and counted by its own formula
(``kernel_bound.py``'s ``mean_rss_grad``)."""

from __future__ import annotations


def logjoint_terms(N, L, P, K, M):
    """{term: FLOP} of one evaluation with its gradient, one chain."""
    fwd = {
        # ALR softmax of Z's rows and pi; exps and the non-centred Phi
        "transforms": 15.0 * N * K + 15.0 * K + 13.0 * K * P * M
        + 10.0 * K * M,
        # feature offsets nu + Phi chi, then w = Z T
        "mean_coeffs": 2.0 * N * K * P * M + N * K * P + 2.0 * N * K * P,
        # Dirichlet rows, chi's normals, nu's penalty, the MGP priors
        "priors": 3.0 * N * K + 2.0 * N * M + 2.0 * K * P * P
        + 2.0 * K * P + 12.0 * K * P * M + 12.0 * K * M,
    }
    f = {k: 3.0 * v for k, v in fwd.items()}        # value + reverse mode
    f["k2_forward"] = float(N * L * (2 * P + 3))
    f["k2_backward"] = float(N * L * (4 * P + 1))
    f["total"] = float(sum(f.values()))
    return f


def grad_eval_flops(config):
    """FLOP of one value and gradient of a configuration's log-joint."""
    if config["D"]:
        raise NotImplementedError("the count has no covariate terms")
    return logjoint_terms(config["N"], config["n_time"][1], config["P"],
                          config["K"], config["M"])["total"]
