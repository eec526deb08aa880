"""Carry data and sampler state between the JAX package and the port.

The parity tests give both packages the same inputs through these; they
touch only NumPy views of the JAX objects, so this module imports no JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from bayesfmmm_torch.models.state import (STATE_FIELDS, GibbsState, ModelData,
                                          default_device)


def data_from_jax(jdata, device=None, dtype=torch.float32) -> ModelData:
    """Port ModelData holding the same arrays as a JAX ``ModelData`` of any
    family (the identity-basis flag and the family's name come along), on
    ``device``: the CUDA card when None."""
    device = default_device(device)

    def dev(name):
        return torch.tensor(np.asarray(getattr(jdata, name)), dtype=dtype,
                            device=device)

    return ModelData(
        y=dev("y"), mask=dev("mask"), B=dev("B"), X=dev("X"), G=dev("G"),
        pen=dev("pen"), u=dev("u"), yy=dev("yy"),
        n_obs=float(np.sum(np.asarray(jdata.mask, dtype=np.float64))),
        identity_basis=bool(jdata.identity_basis), family=str(jdata.family))


def state_from_numpy(leaves, chains=None, device=None,
                     dtype=torch.float32) -> GibbsState:
    """GibbsState from the leaves of a JAX ``GibbsState`` (or a dict).

    A leaf with the per-chain shape is broadcast over ``chains`` chains
    (1 if not given); a leaf that already has a leading chain axis (a
    vmapped state) is taken as it is, and must have ``chains`` entries when
    ``chains`` is given.  The tensors go to ``device``: the CUDA card when
    None."""
    device = default_device(device)
    get = leaves.__getitem__ if isinstance(leaves, Mapping) \
        else lambda f: getattr(leaves, f)
    out = {}
    for f, ndim in STATE_FIELDS.items():
        a = np.asarray(get(f))
        if a.ndim == ndim:
            a = np.broadcast_to(a, (chains or 1,) + a.shape)
        elif a.ndim != ndim + 1 or (chains is not None
                                    and a.shape[0] != chains):
            raise ValueError(f"{f}: shape {a.shape} is neither one chain's "
                             f"({ndim} axes) nor {chains} chains'")
        out[f] = torch.tensor(a, dtype=dtype, device=device)
    return GibbsState(**out)


def state_to_numpy(state: GibbsState) -> dict:
    """Dict of (C, ...) NumPy arrays, one per state field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in STATE_FIELDS}


def unc_from_jax(leaves, chains=None, device=None, dtype=torch.float32):
    """The port's batched ``UncState`` (models/logjoint.py) from the leaves
    of a JAX ``UncState`` (or a dict of them): one chain's leaves are
    broadcast over ``chains`` chains (1 if not given), a batch of chains
    (a vmapped state) is taken as it is.  On ``device``: the CUDA card
    when None."""
    from bayesfmmm_torch.models.logjoint import UNC_FIELDS, UncState
    device = default_device(device)
    get = leaves.__getitem__ if isinstance(leaves, Mapping) \
        else lambda f: getattr(leaves, f)
    # log_sigma2 has no axis of its own: a batch shows as one axis there
    batched = np.ndim(get("log_sigma2")) == 1
    out = {}
    for f in UNC_FIELDS:
        a = np.asarray(get(f))
        if not batched:
            a = np.broadcast_to(a, (chains or 1,) + a.shape)
        elif chains is not None and a.shape[0] != chains:
            raise ValueError(f"{f}: {a.shape[0]} chains, not {chains}")
        out[f] = torch.tensor(a, dtype=dtype, device=device)
    return UncState(**out)


def unc_to_numpy(unc) -> dict:
    """Dict of (C, ...) NumPy arrays, one per ``UncState`` field."""
    return {f: t.detach().cpu().numpy() for f, t in vars(unc).items()}


def fit_result_from_jax(jres, data, device=None):
    """The port's ``FitResult`` holding a JAX ``FitResult``'s traces, loglik
    and final state (as NumPy), so that the port's ``fit_theta`` and
    ``fit_warm_start`` can continue from a phase the JAX package ran.
    ``data`` is the port's ModelData of the same observations."""
    from bayesfmmm_torch.api import FitResult
    from bayesfmmm_torch.config import ModelConfig

    res = FitResult({k: np.asarray(v) for k, v in jres.traces.items()},
                    np.asarray(jres.loglik),
                    state_from_numpy(jres.final_state, chains=1,
                                     device=device or data.device),
                    int(jres.chain_index))
    res.data = data
    res.config = ModelConfig(**{f: getattr(jres.config, f) for f in (
        "K", "P", "M", "D", "family", "covariate_mean", "covariate_cov")})
    for k in ("hmc_diagnostics", "all_chain_loglik"):
        if hasattr(jres, k):
            setattr(res, k, _host_tree(getattr(jres, k)))
    return res


def fit_result_from_estimates(est, data, config):
    """A ``FitResult`` whose ``estimates()`` are ``est``: a dict of one
    chain's point estimates by state field (arrays or nested lists, say the
    posterior medians another run stored), as a one-draw trace.  It can
    stand for both phase results that ``api.fit_warm_start`` takes, so a
    phase 3 can start from exactly the point another package's did."""
    from bayesfmmm_torch.api import FitResult

    N, K, P, M, D = data.N, config.K, config.P, config.M, config.D
    shapes = dict(
        Z=(N, K), pi=(K,), alpha3=(), nu=(K, P), tau=(K,), sigma2=(),
        chi=(N, M), Phi=(K, P, M), gamma=(K, P, M), delta=(K, M), A=(K, 2),
        eta=(K, P, D), tau_eta=(K, D), xi=(K, P, D, M),
        gamma_xi=(K, P, D, M), delta_xi=(K, M, D), A_xi=(K, 2, D))
    # nested lists lose the axes after an empty one (D = 0): reshape
    host = {f: np.asarray(est[f], dtype=np.float32).reshape(shapes[f])
            for f in STATE_FIELDS}
    res = FitResult({f: v[None] for f, v in host.items()}, np.zeros(1),
                    state_from_numpy(host, chains=1, device=data.device))
    res.data = data
    res.config = config
    return res


def _host(x):
    """A tensor (on any device) or a JAX / NumPy array as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_tree(x):
    """A dict of arrays (any package, any device) or one array, on the
    host."""
    if isinstance(x, Mapping):
        return {k: _host(v) for k, v in x.items()}
    return _host(x)


def fit_result_to_numpy(res, burnin_prop=0.8) -> dict:
    """A ``FitResult`` of either package as host arrays: its traces, loglik
    and per-element posterior medians; a parallel-tempering result
    (``fit_pt``) adds its ``swap_rate`` and ``ladder``, an HMC/NUTS result
    (``fit_hmc``) its ``hmc_diagnostics`` and ``all_chain_loglik``."""
    out = {"traces": {k: np.asarray(v) for k, v in res.traces.items()},
           "loglik": np.asarray(res.loglik),
           "estimates": {k: np.asarray(v) for k, v in
                         res.estimates(burnin_prop, _warn=False).items()}}
    if hasattr(res, "swap_rate"):
        out["swap_rate"] = float(res.swap_rate)
        out["ladder"] = None if res.ladder is None else _host(res.ladder)
    for k in ("hmc_diagnostics", "all_chain_loglik"):
        if hasattr(res, k):
            out[k] = _host_tree(getattr(res, k))
    return out


def smc_result_to_numpy(res) -> dict:
    """The dict ``fit_smc`` of either package returns, as host values: the
    particles by field (N, ...), weights, log-evidence, stage count, final
    beta and the weighted estimates."""
    parts = res["particles"]
    return {"particles": {f: _host(getattr(parts, f)) for f in STATE_FIELDS},
            "weights": _host(res["weights"]),
            "log_evidence": float(res["log_evidence"]),
            "n_stages": int(res["n_stages"]),
            "final_beta": float(res["final_beta"]),
            "estimates": {f: _host(res["estimates"][f])
                          for f in STATE_FIELDS}}
