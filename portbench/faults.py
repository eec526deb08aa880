"""Faults planted in the program underneath a run, for the tests that see
``correct`` come out false and for the fault readings the limits of
``correct`` are set from (``readings.py --fault``).  Never used by a run
of ``run.py``.

Each fault is ``plant(patch, limit)``: ``patch(obj, name, value)`` sets an
attribute of the program (pytest's ``monkeypatch.setattr``, or
``setattr``), ``limit`` is the cell's ``loglik_gap`` limit.

  * ``unchanged``: every sweep, and every HMC step, returns its state.
  * ``half_rows``: the whole sweep sees the first half of the curves with
    twice their weight and not the rest (half of the batch left out, the
    mean taken over the rest).
  * ``half_gram``: the weighted Gram sums of kernel K3 (nu's and eta's
    precisions) over the first half of the curves, doubled.
  * ``half_phi``: Phi's joint draw (kernel K1) from the first half of the
    curves, doubled.
  * ``k1_stuck``: the joint draws of Phi and xi (kernel K1) return the
    field they were given.
  * ``half_rss``: the residual sum of squares (kernel K2) over the first
    half of the curves, doubled.
  * ``altered``: every log-likelihood off by twice the limit where it is
    made.
  * ``tensor_order``: the program's tensor basis and its penalty with the
    first axis fastest, not the last (an hd run only: ``ONLY``).  The
    program's fit is sound in its own numbering; only a check that builds
    the surfaces' basis itself sees its coefficients belong to other
    functions.

``tf32`` is the control on the program's own path rather than a fault:
the sweep's float32 products in TF32 (the program's switch
``gibbs.use_full_f32`` turned the other way).  It changes nothing on the
CPU.
"""

from __future__ import annotations

import dataclasses


def _halved(data):
    """``data`` with its first half of the curves weighted twice and the
    rest left out: every sum over curves is twice the first half's."""
    import torch
    h = data.N // 2
    f2 = torch.zeros(data.N, dtype=data.y.dtype, device=data.y.device)
    f2[:h] = 2.0
    f = f2.sqrt()
    return dataclasses.replace(
        data, y=data.y * f[:, None], B=data.B * f[:, None, None],
        G=data.G * f2[:, None, None], u=data.u * f2[:, None],
        yy=data.yy * f2)


def unchanged(patch, limit):
    from bayesfmmm_torch.ops import gibbs
    from bayesfmmm_torch.samplers import hmc
    patch(gibbs, "sweep_full", lambda generator, state, *a, **k: state)
    real = hmc.hmc_kernel

    def frozen(log_joint):
        step = real(log_joint)

        def still(generator, state, eps, inv_mass, n_steps):
            _, ap, n = step(generator, state, eps, inv_mass, n_steps)
            return state, ap, n
        return still
    patch(hmc, "hmc_kernel", frozen)


def half_rows(patch, limit):
    from bayesfmmm_torch.ops import gibbs
    real = gibbs.sweep_full

    def half(generator, state, data, *a, **k):
        return real(generator, state, _halved(data), *a, **k)
    patch(gibbs, "sweep_full", half)


def half_gram(patch, limit):
    from bayesfmmm_torch.ops import gibbs
    real = gibbs._weighted_gram

    def half(data, W):
        return real(dataclasses.replace(data, G=_halved(data).G), W)
    patch(gibbs, "_weighted_gram", half)


def half_phi(patch, limit):
    from bayesfmmm_torch.ops import gibbs
    real = gibbs.update_phi

    def half(generator, state, data, *a, **k):
        return real(generator, state, _halved(data), *a, **k)
    patch(gibbs, "update_phi", half)


def k1_stuck(patch, limit):
    from bayesfmmm_torch.ops import gibbs
    patch(gibbs, "update_phi", lambda generator, state, data, hp, cache,
          beta=1.0: (state, cache))
    patch(gibbs, "update_xi", lambda generator, state, data, hp, cache,
          beta=1.0: (state, cache))


def half_rss(patch, limit):
    from bayesfmmm_torch.ops import mean
    real = mean.rank_rss

    def half(data, w):
        h = data.N // 2
        sub = dataclasses.replace(data, y=data.y[:h], B=data.B[:h])
        return 2.0 * real(sub, w[..., :h, :])
    patch(mean, "rank_rss", half)


def altered(patch, limit):
    from bayesfmmm_torch.models import likelihood
    from bayesfmmm_torch.samplers import drivers
    real = likelihood.log_likelihood

    def off(state, data):
        return real(state, data) + 2.0 * limit
    patch(drivers, "log_likelihood", off)
    patch(likelihood, "log_likelihood", off)


def tensor_order(patch, limit):
    from bayesfmmm_torch import basis
    real = basis.mixed_radix_indices

    def first_fastest(sizes):
        return real(list(sizes)[::-1])[:, ::-1]
    patch(basis, "mixed_radix_indices", first_fastest)


def tf32(patch, limit):
    import torch
    from bayesfmmm_torch.ops import gibbs

    def on():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    patch(gibbs, "use_full_f32", on)


FAULTS = {f.__name__: f for f in (unchanged, half_rows, half_gram, half_phi,
                                  k1_stuck, half_rss, altered, tensor_order,
                                  tf32)}
# faults that only the data of one family can have
ONLY = {"tensor_order": "hd"}
