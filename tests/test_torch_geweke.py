"""Geweke (2004) joint-distribution proofs of the port's sweeps, in float64
on the CPU: ports of tests/test_geweke.py::test_geweke_full_sweep and of the
two proofs of tests/test_geweke_covadj.py.

If every updater leaves its conditional invariant, the successive-
conditional sampler theta' ~ sweep(theta; y), y' ~ p(y | theta') has the
model prior as its stationary marginal; moments of posterior functionals of
that chain are held against iid prior draws (|z| <= 5, the standard error of
the chain side taken between independent chains).  The multivariate family
(identity basis) makes every prior proper.  Hyperparameters, statistics and
tolerances are the JAX tests'; their docstrings give the reasons.  The data
is shared by the chains of a port state, and here every chain must see its
own y, so each successive-conditional chain is a one-chain state; the iid
prior draws are one 8000-chain state.  The production proof runs the flags
the port has (collapsed_z, gauge, phi_mala_steps): the column moves, the
anchor stage and the HMC step of the JAX proof are not ported.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bayesfmmm_torch.config import Priors  # noqa: E402
from bayesfmmm_torch.models.state import (GibbsState,  # noqa: E402
                                          make_multivariate_data)
from bayesfmmm_torch.ops import gibbs  # noqa: E402
from bayesfmmm_torch.ops.distributions import rdirichlet  # noqa: E402
from bayesfmmm_torch.ops.mean import effective_coeffs  # noqa: E402

K, P, M, N, D = 2, 3, 2, 6, 1
HP = Priors(b=0.5, alpha_0=3.0, beta_0=2.0, alpha1l=20.0, beta1l=10.0,
            alpha2l=30.0, beta2l=10.0, alpha_nu=10.0, beta_nu=1.0, nu_1=3.0,
            a_Z_PM=20.0, a_pi_PM=20.0, var_alpha3=1.0)
DT = torch.float64
STAT_NAMES = ["alpha3", "log_sigma2", "nu2_tau", "phi2_std", "log_delta",
              "log_gamma", "chi2", "Z0", "log_tau", "A"]
STAT_NAMES_COV = STAT_NAMES + ["eta2_std", "xi2_std", "log_delta_xi",
                               "log_gamma_xi", "A_xi", "log_tau_eta"]


def _prior_draw(g, C, d):
    """C exact draws from the model prior (the conditionals' references are
    listed in tests/test_geweke.py::_prior_draw); d covariates."""
    def gam(shape, *size):
        a = shape if torch.is_tensor(shape) else torch.full(size, shape,
                                                            dtype=DT)
        return torch._standard_gamma(a, generator=g)

    def normal(*size):
        return torch.randn(size, generator=g, dtype=DT)

    pi = rdirichlet(g, torch.full((C, K), 3.0, dtype=DT))
    alpha3 = -torch.log1p(-torch.rand(C, generator=g, dtype=DT)) / HP.b
    # Dirichlet rows in log space (log G_a = log G_{a+1} + log U / a), as
    # jax.random.dirichlet draws them: a small alpha3 * pi must not
    # underflow a whole row to 0 / 0
    a = (alpha3[:, None] * pi)[:, None, :].expand(C, N, K).contiguous()
    Z = torch.softmax(gam(a + 1.0).log() + torch.log(torch.rand(
        a.shape, generator=g, dtype=DT)) / a, -1)
    tau = gam(HP.alpha_nu, C, K) / HP.beta_nu
    nu = normal(C, K, P) / tau.sqrt()[..., None]
    sigma2 = HP.beta_0 / gam(HP.alpha_0, C)

    def tower(*tail):
        """(A, delta) of one MGP tower per trailing index."""
        a1 = gam(HP.alpha1l, C, K, *tail) / HP.beta1l
        a2 = gam(HP.alpha2l, C, K, *tail) / HP.beta2l
        rest = gam(a2[:, :, None].expand(C, K, M - 1, *tail).contiguous())
        return torch.stack([a1, a2], 2), torch.cat([gam(a1)[:, :, None],
                                                    rest], 2)

    A, delta = tower()
    gamma = gam(HP.nu_1 / 2.0, C, K, P, M) / (HP.nu_1 / 2.0)
    Phi = normal(C, K, P, M) / (gamma * torch.cumprod(
        delta, 2)[:, :, None, :]).sqrt()
    tau_eta = gam(HP.alpha_eta, C, K, d) / HP.beta_eta
    eta = normal(C, K, P, d) / tau_eta.sqrt()[:, :, None, :]
    A_xi, delta_xi = tower(d)
    gamma_xi = gam(HP.nu_1 / 2.0, C, K, P, d, M) / (HP.nu_1 / 2.0)
    pri = torch.cumprod(delta_xi, 2).transpose(2, 3)[:, :, None]
    xi = normal(C, K, P, d, M) / (gamma_xi * pri).sqrt()
    return GibbsState(Z=Z, pi=pi, alpha3=alpha3, nu=nu, tau=tau,
                      sigma2=sigma2, chi=normal(C, N, M), Phi=Phi,
                      gamma=gamma, delta=delta, A=A, eta=eta,
                      tau_eta=tau_eta, xi=xi, gamma_xi=gamma_xi,
                      delta_xi=delta_xi, A_xi=A_xi)


def _draw_y(g, st, X):
    w = effective_coeffs(st, X)
    return w + st.sigma2.sqrt()[:, None, None] * torch.randn(
        w.shape, generator=g, dtype=DT)


def _stats(st):
    """(C, n) posterior functionals with finite prior variance; the
    standardized squares have prior mean 1 by construction."""
    tilde = torch.cumprod(st.delta, 2)
    out = [st.alpha3, st.sigma2.log(),
           (st.nu ** 2 * st.tau[..., None]).mean((1, 2)),
           (st.gamma * tilde[:, :, None, :] * st.Phi ** 2).mean((1, 2, 3)),
           st.delta.log().mean((1, 2)), st.gamma.log().mean((1, 2, 3)),
           (st.chi ** 2).mean((1, 2)), st.Z[:, :, 0].mean(1),
           st.tau.log().mean(1), st.A.mean((1, 2))]
    if st.eta.shape[3] > 0:
        pri = torch.cumprod(st.delta_xi, 2).transpose(2, 3)[:, :, None]
        out += [(st.eta ** 2 * st.tau_eta[:, :, None, :]).mean((1, 2, 3)),
                (st.gamma_xi * pri * st.xi ** 2).mean((1, 2, 3, 4)),
                st.delta_xi.log().mean((1, 2, 3)),
                st.gamma_xi.log().mean((1, 2, 3, 4)),
                st.A_xi.mean((1, 2, 3)), st.tau_eta.log().mean((1, 2))]
    return torch.stack(out, 1).numpy()


def _run_geweke(sweep_kwargs, d, stat_names, chi2_stats, n_mc=8000,
                n_sc=3000, n_chains=8, n_burn=500):
    torch.set_num_threads(1)
    X = np.random.default_rng(5).normal(size=(N, d)) if d else None
    data0 = make_multivariate_data(np.zeros((N, P)), X=X, dtype=DT,
                                   device="cpu")
    c = torch.full((K,), 3.0, dtype=DT)
    mc = _stats(_prior_draw(torch.Generator().manual_seed(42), n_mc, d))
    sc = np.empty((n_chains, n_sc, len(stat_names)))
    for ch in range(n_chains):
        g = torch.Generator().manual_seed(43 + ch)
        st = _prior_draw(g, 1, d)
        y = _draw_y(g, st, data0.X)[0]
        for t in range(n_sc):
            data = dataclasses.replace(data0, y=y, u=y, yy=(y * y).sum(1))
            st = gibbs.sweep_full(g, st, data, HP, c, **sweep_kwargs)
            y = _draw_y(g, st, data0.X)[0]
            sc[ch, t] = _stats(st)[0]
    assert np.isfinite(mc).all() and np.isfinite(sc).all()
    sc = sc[:, n_burn:]
    failures = []
    for j, name in enumerate(stat_names):
        m1, v1 = mc[:, j].mean(), mc[:, j].var(ddof=1)
        chain_means = sc[:, :, j].mean(axis=1)
        m2 = chain_means.mean()
        se_sc = chain_means.std(ddof=1) / np.sqrt(n_chains)
        z = (m1 - m2) / np.sqrt(v1 / n_mc + se_sc ** 2)
        if abs(z) > 5.0:
            failures.append(f"{name}: z={z:.2f} (mc={m1:.4f}, sc={m2:.4f}, "
                            f"se_sc={se_sc:.4f})")
    assert not failures, "Geweke z-score failures: " + "; ".join(failures)
    for j in chi2_stats:
        assert abs(mc[:, j].mean() - 1.0) < 0.1
        assert abs(sc[:, :, j].mean() - 1.0) < 0.15


@pytest.mark.slow
def test_geweke_full_sweep():
    """The reference census on the multivariate family."""
    _run_geweke({}, 0, STAT_NAMES, (2, 3), n_sc=4000)


@pytest.mark.slow
def test_geweke_covariate_adjusted_sweep():
    """D = 1: eta, xi, delta_xi, gamma_xi, A_xi and tau_eta enter the joint
    invariance proof."""
    _run_geweke(dict(covariate_mean=True, covariate_cov=True), D,
                STAT_NAMES_COV, (2, 3, len(STAT_NAMES), len(STAT_NAMES) + 1))


@pytest.mark.slow
@pytest.mark.parametrize("d", [0, D])
def test_geweke_collapsed_gauge_sweep(d):
    """The production census (collapsed (Z, chi) block, gauge moves, both
    interweaves, MALA), without and with the covariate tower (the JAX proof
    runs it without)."""
    flags = dict(collapsed_z=True, gauge=True, phi_mala_steps=1)
    if d:
        flags.update(covariate_mean=True, covariate_cov=True)
    names = STAT_NAMES_COV if d else STAT_NAMES
    chi2 = (2, 3) + ((len(STAT_NAMES), len(STAT_NAMES) + 1) if d else ())
    _run_geweke(flags, d, names, chi2)
