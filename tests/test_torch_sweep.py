"""The slices as a whole: 150 sweeps of the reference census and of the
production census in the JAX package (jit, vmapped over chains) and in the
port, from the same converted initial ensemble on the same data.  The
ensemble means of the loglik, sigma2 and 8 fitted-curve probes after the
run agree within 5 combined standard errors (the two packages draw
different random numbers, so the chains are independent runs of one Markov
kernel)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.config import ModelConfig, Priors  # noqa: E402
from bayesfmmm_tpu.models.likelihood import log_likelihood  # noqa: E402
from bayesfmmm_tpu.models.state import init_state  # noqa: E402
from bayesfmmm_tpu.ops import gibbs  # noqa: E402
from bayesfmmm_tpu.utils.init_strategies import spectral_init  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402
from bayesfmmm_torch import convert  # noqa: E402
from bayesfmmm_torch.config import Priors as TPriors  # noqa: E402
from bayesfmmm_torch.ops import kernels  # noqa: E402
from bayesfmmm_torch.samplers import drivers  # noqa: E402

CHAINS, SWEEPS = 128, 150
K, P, M = 2, 6, 2
# the bench's production census (bench.py:71-77); the JAX package runs MALA
# under gauge=True by default, the port only when asked (ROADMAP F3)
CENSUS = {
    "reference": {},
    "production": dict(collapsed_z=True, gauge=True, p_indep=0.3,
                       phi_mala_steps=4, phi_mala_step=0.05),
}
# 8 (observation, time index) probes of the fitted curve
PROBES = [(0, 2), (3, 10), (6, 18), (9, 5), (12, 12), (15, 0), (18, 8),
          (21, 15)]


def _probes(B, Z, nu, Phi, chi):
    """Fitted mean at PROBES; leading axes of the parameters are chains."""
    n = np.array([p[0] for p in PROBES])
    t = np.array([p[1] for p in PROBES])
    w = np.einsum("cik,ckp->cip", Z[:, n], nu) \
        + np.einsum("cik,ckpm,cim->cip", Z[:, n], Phi, chi[:, n])
    return np.einsum("ip,cip->ci", B[n, t], w)


@pytest.mark.parametrize("census", list(CENSUS))
def test_sweep_ensemble_matches_jax(census):
    flags = CENSUS[census]
    data, _ = simulate_functional(seed=9, N=24, K=K, P=P, M=M,
                                  n_time=(20, 24))
    cfg = ModelConfig(K=K, P=P, M=M)
    c = jnp.full((K,), 10.0)
    keys = jax.random.split(jax.random.PRNGKey(0), CHAINS)
    sp = {k: jnp.asarray(v, jnp.float32)
          for k, v in spectral_init(data, K, M).items()}

    def init(k):
        st = init_state(k, cfg, data)
        Z0 = jnp.clip(sp["Z"] + 0.02 * jax.random.normal(k, sp["Z"].shape),
                      1e-4, None)
        return st.replace(Z=Z0 / Z0.sum(1, keepdims=True), nu=sp["nu"],
                          chi=sp["chi"], Phi=sp["Phi"], sigma2=sp["sigma2"])

    init_states = jax.jit(jax.vmap(init))(keys)

    def run(k, st):
        def body(s, kk):
            return gibbs.sweep_full(kk, s, data, Priors(), c, **flags), None
        st, _ = jax.lax.scan(body, st, jax.random.split(k, SWEEPS))
        return st, log_likelihood(st, data)

    jst, jll = jax.jit(jax.vmap(run))(
        jax.random.split(jax.random.PRNGKey(1), CHAINS), init_states)

    tdata = convert.data_from_jax(data, device="cpu")
    tst0 = convert.state_from_numpy(init_states, chains=CHAINS,
                                    device="cpu")
    g = torch.Generator().manual_seed(1)
    kernels.reset_launch_counts()
    res = drivers.phase_warm_start(g, tst0, tdata, TPriors(),
                                   torch.full((K,), 10.0), n_iters=SWEEPS,
                                   **flags)
    tst = res.final_state
    assert res.loglik.shape == (CHAINS, SWEEPS)
    assert res.traces["Phi"].shape == (CHAINS, SWEEPS, K, P, M)
    for f, v in convert.state_to_numpy(tst).items():
        assert np.all(np.isfinite(v)), f

    B = np.asarray(data.B)
    jnp_st = jax.tree.map(np.asarray, jst)
    tnp = convert.state_to_numpy(tst)
    stats = {
        "loglik": (np.asarray(jll)[:, None], res.loglik[:, -1:].numpy()),
        "sigma2": (jnp_st.sigma2[:, None], tnp["sigma2"][:, None]),
        "probes": (_probes(B, jnp_st.Z, jnp_st.nu, jnp_st.Phi, jnp_st.chi),
                   _probes(B, tnp["Z"], tnp["nu"], tnp["Phi"], tnp["chi"])),
    }
    for name, (a, b) in stats.items():
        a, b = a.astype(np.float64), b.astype(np.float64)
        se = np.sqrt(a.var(0) / len(a) + b.var(0) / len(b))
        diff = np.abs(a.mean(0) - b.mean(0))
        assert np.all(diff <= 5.0 * se), \
            f"{name}: {a.mean(0)} vs {b.mean(0)} (se {se})"


def test_driver_thinning_and_flags_outside_the_slice():
    from bayesfmmm_torch.ops import gibbs as tgibbs
    from bayesfmmm_torch.ops.mean import build_cache
    from bayesfmmm_torch.utils.simulate import simulate_functional as tsim

    data, truth = tsim(seed=1, N=6, K=2, P=5, M=2, n_time=(8, 10),
                       device="cpu")
    st = convert.state_from_numpy(truth, chains=3, device="cpu")
    hp, c = TPriors(), torch.full((2,), 10.0)
    g = torch.Generator().manual_seed(0)
    res = drivers.run_chain(g, st, data, hp, c, sweep=tgibbs.sweep_full,
                            n_iters=6, thin=3)
    assert res.loglik.shape == (3, 2) and res.traces["Z"].shape == (3, 2, 6, 2)
    assert torch.equal(res.traces["sigma2"][:, -1], res.final_state.sigma2)
    for kw in (dict(z_anchor=True), dict(phi_chi_moves=1),
               dict(hmc_steps=1), dict(covariate_mean=True),
               dict(n_temp_trans=5)):
        with pytest.raises(NotImplementedError, match="ROADMAP item"):
            drivers.phase_warm_start(g, st, data, hp, c, n_iters=1, **kw)
    with pytest.raises(ValueError, match="betas"):
        drivers.phase_warm_start(g, st, data, hp, c, n_iters=2, betas=[0.5])
    wide = st.replace(Phi=torch.zeros(3, 2, 5, 410))   # K*M*P = 4100
    with pytest.raises(NotImplementedError, match="sequential blocked"):
        tgibbs.update_phi(g, wide, data, hp, build_cache(data, st))
