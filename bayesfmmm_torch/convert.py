"""Carry data and sampler state between the JAX package and the port.

The parity tests give both packages the same inputs through these; they
touch only NumPy views of the JAX objects, so this module imports no JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from bayesfmmm_torch.models.state import STATE_FIELDS, GibbsState, ModelData


def data_from_jax(jdata, device=None) -> ModelData:
    """Port ModelData holding the same arrays as a JAX ``ModelData`` of the
    functional or hd family (the identity-basis multivariate family is not
    ported yet)."""
    if jdata.identity_basis:
        raise NotImplementedError(
            "multivariate family: ROADMAP item 'covariate-adjusted models "
            "and the other families'")

    def dev(name):
        return torch.tensor(np.asarray(getattr(jdata, name)),
                            dtype=torch.float32, device=device)

    return ModelData(
        y=dev("y"), mask=dev("mask"), B=dev("B"), X=dev("X"), G=dev("G"),
        pen=dev("pen"), u=dev("u"), yy=dev("yy"),
        n_obs=float(np.sum(np.asarray(jdata.mask, dtype=np.float64))))


def state_from_numpy(leaves, chains=None, device=None) -> GibbsState:
    """GibbsState from the leaves of a JAX ``GibbsState`` (or a dict).

    A leaf with the per-chain shape is broadcast over ``chains`` chains
    (1 if not given); a leaf that already has a leading chain axis (a
    vmapped state) is taken as it is, and must have ``chains`` entries when
    ``chains`` is given."""
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
        out[f] = torch.tensor(a, dtype=torch.float32, device=device)
    return GibbsState(**out)


def state_to_numpy(state: GibbsState) -> dict:
    """Dict of (C, ...) NumPy arrays, one per state field."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in STATE_FIELDS}
