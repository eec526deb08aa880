"""Label-switching correction by permutation alignment.

Reference: LabelSwitch.h — ``GetDistanceZ`` (:7) and ``LabelSwitch``
(:16-60): align a draw's Z matrix to a reference Z by the permutation
minimizing the L1 distance.  (In the reference this is mostly superseded by
the post-processing "rescale" transform — summaries.rescale_transforms —
but kept as a standalone tool, as here.)

The port's own copy of ``bayesfmmm_tpu/post/label_switch.py`` (NumPy only);
``tests/test_torch_api.py`` holds the two equal on shared inputs.
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = ["z_distance", "align_draw", "align_trace"]


def z_distance(Z_a: np.ndarray, Z_b: np.ndarray) -> float:
    """Sum of absolute differences (GetDistanceZ, LabelSwitch.h:7-14)."""
    return float(np.abs(np.asarray(Z_a) - np.asarray(Z_b)).sum())


def _permutations(K: int) -> np.ndarray:
    return np.array(list(itertools.permutations(range(K))), dtype=int)


def align_draw(Z: np.ndarray, Z_ref: np.ndarray, perms=None):
    """Best column permutation of Z against Z_ref; returns (perm, dist)."""
    K = Z.shape[1]
    perms = _permutations(K) if perms is None else np.asarray(perms)
    dists = np.abs(Z[:, perms] - Z_ref[:, None, :]).sum(axis=(0, 2))
    best = int(np.argmin(dists))
    return perms[best], float(dists[best])


_FEATURE_LEADING = {"nu", "tau", "Phi", "gamma", "delta", "A", "eta",
                    "tau_eta", "xi", "gamma_xi", "delta_xi", "A_xi", "pi"}


def align_trace(traces: dict, Z_ref: np.ndarray | None = None,
                block: int = 512) -> dict:
    """Permutation-align every draw of a trace dict to a reference Z.

    Applies the per-draw best permutation to all feature-indexed arrays
    (Z columns; nu/Phi/gamma/delta/A/eta/... leading feature axis; pi).
    Default reference: the final draw's Z.

    Fully vectorized over draws: per-draw distances for all K! permutations
    are computed in draw blocks of ``block`` (bounding the (b, N, K!, K)
    intermediate), and permutations are applied with one take_along_axis
    per array.
    """
    Z_samp = np.asarray(traces["Z"])
    n_draws, N, K = Z_samp.shape
    Z_ref = Z_samp[-1] if Z_ref is None else np.asarray(Z_ref)
    perms = _permutations(K)                        # (K!, K)
    best = np.empty(n_draws, dtype=int)
    for s in range(0, n_draws, block):
        zb = Z_samp[s:s + block]                    # (b, N, K)
        cand = zb[:, :, perms]                      # (b, N, K!, K)
        dists = np.abs(cand - Z_ref[None, :, None, :]).sum(axis=(1, 3))
        best[s:s + block] = np.argmin(dists, axis=1)
    perm_idx = perms[best]                          # (draws, K)
    out = {}
    for name, v in traces.items():
        arr = np.asarray(v)
        if name == "Z":
            arr = np.take_along_axis(arr, perm_idx[:, None, :], axis=2)
        elif name in _FEATURE_LEADING and arr.ndim >= 2 \
                and arr.shape[1] == K:
            idx = perm_idx.reshape(perm_idx.shape
                                   + (1,) * (arr.ndim - 2))
            arr = np.take_along_axis(arr, idx, axis=1)
        else:
            arr = np.array(arr, copy=True)
        out[name] = arr
    return out
