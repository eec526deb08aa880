"""Analytic FLOP counts: one Gibbs sweep of one chain, and one value and
gradient of the whole-model log-joint.

``_joint_blocked_flops``, ``_blocked_seq_flops`` and ``sweep_flops`` are a
frozen copy of ``benchmarks/flops.py`` at commit 29f7e3a7, term for term
(that file counted the JAX package's sweep).  Conventions, as there: one
fused multiply-add is 2 FLOP, a Cholesky of d x d is d^3/3, a triangular
solve d^2 per right-hand side, a Gamma draw ~25 FLOP and a transcendental
~10.  ``sweep_flops`` has no term for the Phi MALA steps of the production
census; ``mala_flops`` adds them, and ``chain_sweep_flops`` is the total of
a configuration's census.  A gradient by reverse mode is counted at twice
its forward pass.
"""

from __future__ import annotations


def _joint_blocked_flops(B, N, P, identity_basis):
    """_joint_blocked_draw (ops/gibbs.py): joint precision + Cholesky."""
    f = 0.0
    f += 4.0 * B * N * P                 # w_excl remove + add back
    if identity_basis:
        f += 2.0 * B * B * N             # C = W W'
    else:
        f += 2.0 * N * P * P             # Gw
        f += 2.0 * B * N * P * P         # an,npq->anpq
        f += 2.0 * B * B * N * P * P     # anpq,bn->apbq
    f += 2.0 * B * N * P                 # bvec
    f += (B * P) ** 3 / 3.0              # joint Cholesky
    f += 2.0 * (B * P) ** 2 * 2          # mean + noise triangular solves
    return f


def _blocked_seq_flops(B, N, P, identity_basis):
    """Sequential blocked path: batched upfront Cholesky + per-block solves."""
    f = 0.0
    if not identity_basis:
        f += 2.0 * B * N * P * P         # weighted Gram
    f += B * P ** 3 / 3.0                # batched Cholesky
    per_block = (0.0 if identity_basis else 2.0 * N * P * P) + 8.0 * N * P
    f += B * (per_block + 2.0 * P * P * 2)
    return f


def sweep_flops(N, L, P, K, M, D=0, *, identity_basis=False,
                collapsed_z=False, covariate_mean=False,
                covariate_cov=False, gauge=False, joint_max_dim=4096):
    """FLOPs of one ops/gibbs.sweep_full call (one chain, one iteration),
    including the driver-level log_likelihood evaluation."""
    f = {}
    nlp = 0.0 if identity_basis else 2.0 * N * L * P   # one B matvec
    rss = nlp + 3.0 * N * L                            # matvec + residual

    # build_cache (effective_coeffs)
    f["cache"] = 2.0 * N * K * P + 2.0 * N * K * P * M \
        + (2.0 * N * K * P * D + 2.0 * N * K * P * D * M if D else 0.0)

    # Z update
    if collapsed_z:
        # row_stats x2: a, U, GU, C, Fr, rr; chol + solves; chi redraw
        per = (2.0 * N * K * P + 2.0 * N * K * P * M
               + (0.0 if identity_basis
                  else 2.0 * N * P * P * M + 2.0 * N * P * P)
               + 2.0 * N * P * M * M + 2.0 * N * P * M + rss
               + N * M ** 3 / 3.0 + N * M * M)
        f["z_collapsed"] = 2.0 * per + 50.0 * N * K \
            + 3.0 * N * M * M + 2.0 * N * P * M      # chi solves + w update
    else:
        f["z"] = (2.0 * N * K * P * M                 # feature_offsets
                  + 2.0 * (2.0 * N * K * P + rss)     # two MH endpoints
                  + 50.0 * N * K + 2.0 * N * K * P)
    f["pi_alpha3"] = 20.0 * N * K

    # Phi tower
    B_phi = K * M
    if B_phi * P <= joint_max_dim:
        f["phi"] = 2.0 * N * K * M + _joint_blocked_flops(
            B_phi, N, P, identity_basis)
    else:
        f["phi"] = 2.0 * N * K * M + _blocked_seq_flops(
            B_phi, N, P, identity_basis)
    f["mgp"] = 6.0 * K * P * M + 60.0 * K * M          # delta/gamma/A

    # nu
    f["nu"] = _blocked_seq_flops(K, N, P, identity_basis) + 2.0 * K * P * P
    f["tau"] = 2.0 * K * P * P
    f["sigma"] = rss

    # chi (sequential M loop; skipped FLOP-wise if collapsed did the joint
    # draw AND the sweep still calls update_chi — both run, so count it)
    f["chi"] = (2.0 * N * K * P * M
                + (0.0 if identity_basis else 2.0 * N * P * P * M)
                + 4.0 * N * P * M + 8.0 * N * P * M)

    if covariate_mean and D:
        f["eta"] = _blocked_seq_flops(D * K, N, P, identity_basis)
        f["tau_eta"] = 2.0 * K * D * P * P
    if covariate_cov and D:
        B_xi = K * M * D
        if B_xi * P <= joint_max_dim:
            f["xi"] = _joint_blocked_flops(B_xi, N, P, identity_basis)
        else:
            f["xi"] = _blocked_seq_flops(B_xi, N, P, identity_basis)
        f["mgp_xi"] = 6.0 * K * P * M * D + 60.0 * K * M * D

    if gauge:
        # update_gauge (ops/gibbs.py): one feature-mix + one eigen-rescale
        # MH move; NO likelihood evaluation — cost is three
        # _gauge_logprior evaluations (lp0, mix proposal, scale proposal)
        # plus the transform maps and accept-selects over the state pytree.
        per_lp = (12.0 * N * K          # Z log-prior term
                  + 2.0 * K * P * P     # tau penalty quadform
                  + 3.0 * K * P * M     # MGP Phi term (cumprod + mult-sum)
                  + 2.0 * N * M)        # chi standard-normal term
        if D:
            per_lp += 2.0 * K * P * P * D + 3.0 * K * P * D * M
        transforms = 2.0 * (4.0 * N * K + 3.0 * K * P * (1.0 + M) + N * M)
        if D:
            transforms += 2.0 * 3.0 * K * P * D * (1.0 + M)
        f["gauge"] = 4.0 * per_lp + transforms   # lp0 + mix/scale/rotate
        # update_mgp_scale (interweaved ASIS moves, ride the gauge flag):
        # 4 moves x (column rescale + dw einsum + stacked rss pair)
        f["interweave"] = 4.0 * (3.0 * K * P * M + 2.0 * N * K * P * M
                                 + 2.0 * (nlp + 3.0 * N * L))
        # rebuild_cache before the interweave block
        f["interweave"] += f["cache"]
    f["loglik"] = rss + 10.0 * N
    f["total"] = float(sum(f.values()))
    return f


def _chi_marginal_flops(N, K, P, M, identity_basis):
    """One forward pass of ``_chi_marginal_sums`` (ops/gibbs.py): U = Z Phi,
    G U, the row precisions I + s U'GU and their Cholesky factors, the
    solve of U'ur, the log-determinants and the squared norms."""
    f = 2.0 * N * K * P * M                        # U
    if not identity_basis:
        f += 2.0 * N * P * P * M                   # G U
    f += 2.0 * N * P * M * M + N * M * M           # U'GU, + I, * s
    f += N * M ** 3 / 3.0                          # row Cholesky
    f += 2.0 * N * P * M + N * M * M               # U'ur, the solve
    f += N * M + 2.0 * N * M                       # logdet, |v|^2
    return f


def mala_flops(N, L, P, K, M, D=0, *, n_steps=4, identity_basis=False):
    """``update_phi_mala`` (ops/gibbs.py) of one chain: its fixed terms
    (mean-only coefficients, u - G a, the RSS of a, the xi part of U), one
    value and gradient of the chi-marginal before the steps and one a
    step, the proposals and accepts, then the joint chi redraw."""
    nlp = 0.0 if identity_basis else 2.0 * N * L * P
    f = 2.0 * N * K * P + (2.0 * N * K * P * D if D else 0.0)   # a
    f += (0.0 if identity_basis else 2.0 * N * P * P) + N * P   # ur
    f += nlp + 3.0 * N * L                                      # rss of a
    if D:
        f += 2.0 * N * K * P * D * M + N * P * M                # U_xi
    f += 4.0 * K * P * M                                        # pri, W, V
    vg = 3.0 * _chi_marginal_flops(N, K, P, M, identity_basis)  # + grad
    vg += 6.0 * K * P * M                                       # prior
    f += (1 + n_steps) * vg
    f += n_steps * 14.0 * K * P * M                             # proposal
    # the chi redraw: U, its row factors, u - G a, the draw's two solves
    f += 2.0 * N * K * P * M + (N * P * M if D else 0.0)
    f += (0.0 if identity_basis else 2.0 * N * P * P * M) \
        + 2.0 * N * P * M * M + N * M ** 3 / 3.0
    f += (0.0 if identity_basis else 2.0 * N * P * P) + 2.0 * N * P * M
    f += 4.0 * N * M * M + 2.0 * N * P * M                     # solves, w
    return f


def chain_sweep_flops(config, kernels):
    """FLOP of one sweep of one chain of a configuration file's model in
    the "reference" or "production" census of ``sweep_full``, with the
    driver's log-likelihood."""
    N, L, P, K, M = (config["N"], config["n_time"][1], config["P"],
                     config["K"], config["M"])
    D = config["D"]
    production = kernels == "production"
    f = sweep_flops(N, L, P, K, M, D, collapsed_z=production,
                    covariate_mean=bool(D) and config["with_eta"],
                    covariate_cov=bool(D) and config["covariate_cov"],
                    gauge=production)["total"]
    if production:
        f += mala_flops(N, L, P, K, M, D)
    return f
