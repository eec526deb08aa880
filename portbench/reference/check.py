"""The comparison that decides ``correct``.

Each call of the window returned log-likelihood traces and the states they
belong to; a call of a resumed ensemble also the state it started from.
Numbers compared, each against its cell's limit (a cell compares the
numbers its file's ``limits`` name):

  * ``loglik_gap``: the widest gap, in nats, between a log-likelihood the
    program returned and the reference's (``model.loglik``, float64) at
    the state it belongs to: every chain's final state against the last
    entry of its trace, and every draw of the best chain against its
    trace.  It covers the likelihood, the mean and kernel K2 that compute
    it, the basis the program built, and whether a returned state is the
    state its value was taken at.  Per call.
  * ``stuck_chains``: chains whose log-likelihood did not change over a
    whole call, or in which one of the fields every sweep draws (Z, nu,
    Phi, chi, sigma2, and eta and xi with covariates) ended the call as it
    began it.  Per call.
  * ``<field>_z2`` for Phi, xi, nu, eta and chi: |mean z^2 - 1| over every
    coordinate of every chain's final state in every call, z the field's
    whitened distance from its full conditional given the rest of that
    state (``conditionals``).  It covers the draws: Phi's and xi's joint
    draws (kernel K1), nu's and eta's (kernel K3's weighted Grams) and
    chi's.  Pooled over the run's calls.

``control`` puts ``model.loglik_lower`` in the program's place: the same
comparison of the reference's float32-with-TF32 values.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import conditionals, model

MOVED = ("Z", "nu", "Phi", "chi", "sigma2", "eta", "xi")
PER_CALL = ("loglik_gap", "stuck_chains")


def _items(answer):
    """(program's values, states) pairs of one call."""
    if answer.get("final") is not None:
        yield answer["loglik_all"][:, -1], answer["final"]
    yield answer["best_loglik"], answer["best_draws"]


def _stuck(answer):
    ll = np.asarray(answer["loglik_all"])
    stuck = ll.max(axis=1) == ll.min(axis=1)
    start, final = answer.get("start"), answer.get("final")
    if start is not None:
        for f in MOVED:
            a, b = np.asarray(start[f]), np.asarray(final[f])
            if a[0].size:
                stuck |= np.all((a == b).reshape(len(a), -1), axis=1)
    return int(np.sum(stuck))


def readings(answers, curves, lower_device=None, device="cpu",
             zfields=conditionals.ZFIELDS):
    """Per call {"loglik_gap", "stuck_chains", "z2": {field: (sum, n)}};
    with ``lower_device`` the gap is the control's (the program's values
    replaced by ``model.loglik_lower`` on that device).  The conditionals
    run on ``device``, for the ``zfields`` asked for."""
    design = None
    out = []
    for a in answers:
        gap = 0.0
        for values, states in _items(a):
            ref = model.loglik(states, curves)
            got = (model.loglik_lower(states, curves, lower_device)
                   if lower_device is not None
                   else np.asarray(values, np.float64))
            d = np.abs(got - ref)
            gap = max(gap, float(np.max(d)) if np.all(np.isfinite(d))
                      else float("inf"))
        z2 = {}
        final = a.get("final")
        if zfields and final is not None and \
                conditionals.NEEDS <= set(final):
            if design is None:
                design = conditionals.Design(curves, device)
            try:
                z2 = conditionals.z2_sums(final, design, zfields)
            except RuntimeError:            # a factor that is not positive
                z2 = {f: (float("inf"), 1) for f in zfields}
        out.append({"loglik_gap": gap, "stuck_chains": _stuck(a),
                    "z2": z2})
    return out


def numbers(per_call):
    """The run's numbers: the worst call's per-call numbers, and each
    field's |mean z^2 - 1| pooled over the calls (not finite where a z^2
    sum is not)."""
    out = {k: max(r[k] for r in per_call) for k in PER_CALL}
    sums = {}
    for r in per_call:
        for f, (s, n) in r["z2"].items():
            s0, n0 = sums.get(f, (0.0, 0))
            sums[f] = (s0 + s, n0 + n)
    for f, (s, n) in sums.items():
        out[f + "_z2"] = abs(s / n - 1.0)
    return out


def judge(per_call, limits):
    """(correct, failed calls, {name: {"value", "limit"}}).  A call fails
    where one of its per-call numbers passes its limit; where a pooled
    number passes its limit every call fails.  A number the limits name
    that the run did not give reads as infinite."""
    got = numbers(per_call) if per_call else {}
    table = {k: {"value": got.get(k, float("inf")), "limit": lim}
             for k, lim in limits.items()}
    failed = sum(1 for r in per_call
                 if any(not r[k] <= limits[k] for k in PER_CALL
                        if k in limits))
    if any(not row["value"] <= row["limit"] for k, row in table.items()
           if k not in PER_CALL):
        failed = len(per_call)
    correct = bool(per_call) and failed == 0 and all(
        row["value"] <= row["limit"] for row in table.values())
    return correct, failed, table


def zfields_of(limits):
    """The fields whose ``<field>_z2`` the limits name."""
    return tuple(f for f in conditionals.ZFIELDS if f + "_z2" in limits)
