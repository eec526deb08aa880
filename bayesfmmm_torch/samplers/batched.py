"""Batched long-run sampling with background trace persistence.

Port of ``bayesfmmm_tpu/samplers/batched.py``.  Reference semantics
(BFMMM.h:205-271, :1680-1746): the reference sampler keeps a ring of
``r_stored_iters`` draws; each time it fills, draws are thinned by
``thinning_num`` and appended as ``Param{q}.txt`` batch files, then the ring
resets.  The reference *blocks the sampler* on synchronous arma::save.

Here each batch is one ``phase_warm_start`` call on the device; between
batches the thinned draws move to the host and are handed to the native
async writer (io/native.AsyncTraceWriter) so file IO overlaps the next
batch's compute.  The trace files hold one chain, as the reference's do, so
the state has one chain (C = 1).
"""

from __future__ import annotations

import os

import numpy as np

from bayesfmmm_torch.samplers import drivers


def run_batched(generator, state, data, hp, c, *, directory, tot_mcmc_iters,
                r_stored_iters, config, thinning_num=1, n_temp_trans=0,
                beta_N_t=1.0, N_t=1, checkpoint_every=None, start_batch=0,
                progress=None, **sweep_flags):
    """Run ``tot_mcmc_iters`` sweeps in ``r_stored_iters`` batches, saving
    each thinned batch in the reference's trace-file contract.

    ``config``: the ModelConfig, for the family's file layout and the
    checkpoint.  ``sweep_flags`` go to ``sweep_full``.  ``progress``: a
    utils.observability.ProgressStream (or True for the default one) fed
    after every batch — the rolling-loglik print of BFMMM.h:870-875 at
    batch granularity.  The host loop between batches is also the
    cooperative interrupt point (Rcpp::checkUserInterrupt analog,
    BFMMM.h:203): Ctrl-C lands when the in-flight batch returns; the
    already-saved batch files and the latest checkpoint survive, so
    ``resume_batched`` can continue the run.  The tempered excursions'
    schedule counts iterations from the start of the whole run.

    Returns (final_state, loglik_full, n_batches).
    """
    from bayesfmmm_torch.io.native import AsyncTraceWriter
    from bayesfmmm_torch.utils.observability import ProgressStream

    if state.Z.shape[0] != 1:
        raise ValueError(f"run_batched writes one chain's trace files; the "
                         f"state holds {state.Z.shape[0]} chains")
    if progress is True:
        progress = ProgressStream(every=1)
    os.makedirs(directory, exist_ok=True)
    n_batches = tot_mcmc_iters // r_stored_iters
    logliks = []
    writer = AsyncTraceWriter()
    try:
        for q0 in range(n_batches):
            q = start_batch + q0
            res = drivers.phase_warm_start(
                generator, state, data, hp, c, n_iters=r_stored_iters,
                thin=thinning_num, n_temp_trans=n_temp_trans,
                beta_N_t=beta_N_t, N_t=N_t, start_iter=q * r_stored_iters,
                **sweep_flags)
            state = res.final_state
            logliks.append(res.loglik[0].cpu().numpy())
            _submit_batch(writer, directory, res.traces, q, config)
            if checkpoint_every and (q0 + 1) % checkpoint_every == 0:
                from bayesfmmm_torch.io.checkpoint import save_checkpoint
                save_checkpoint(os.path.join(directory, "checkpoint"),
                                state, generator,
                                iteration=(q + 1) * r_stored_iters,
                                config=config)
            if progress is not None:
                progress.update(q0, logliks[-1])
        failures = writer.flush()
        if failures:
            raise IOError(f"{failures} trace batch writes failed")
    finally:
        writer.close()
    return state, np.concatenate(logliks), n_batches


def _submit_batch(writer, directory, traces, q, config):
    """Host transfer of chain 0's thinned draws + async submission of one
    batch's files."""
    from bayesfmmm_torch.api import export_layout
    from bayesfmmm_torch.io import armaio

    out = export_layout({k: v[0].cpu().numpy() for k, v in traces.items()},
                        config)
    # ascii formats go through the async writer; binary field formats are
    # written synchronously (they are the smaller minority of bytes)
    for name, arr in out.items():
        path = os.path.join(directory, f"{name}{q}.txt")
        kind = armaio._PLAIN_FILES.get(name)
        if kind in ("vec", "mat", "mat_iter_cols", "cube_iter_last"):
            writer.submit(path, arr.T if kind == "mat_iter_cols" else arr)
        else:
            armaio.save_trace_dir(directory, {name: arr}, batch=q)


def resume_batched(directory, data, hp, c, *, additional_iters,
                   r_stored_iters, thinning_num=1, n_temp_trans=0,
                   beta_N_t=1.0, N_t=1, checkpoint_every=1, **sweep_flags):
    """Exact-state resume of a batched run from its checkpoint.

    Continues the trace-file numbering after existing batches; the
    generator state stored in the checkpoint makes the continuation
    trajectory identical to an uninterrupted run (capability the reference
    lacks).  The configuration comes from the checkpoint.
    """
    from bayesfmmm_torch.io.checkpoint import load_checkpoint

    state, generator, it, config = load_checkpoint(
        os.path.join(directory, "checkpoint"), data.device)
    # count existing batches for file numbering
    q = 0
    while os.path.exists(os.path.join(directory, f"Nu{q}.txt")):
        q += 1
    # Cross-check the directory's batch count against the checkpoint's
    # stored iteration: a stale/mixed directory (files added or removed
    # since the checkpoint) would silently splice two different
    # trajectories' traces together.
    if q * r_stored_iters != it:
        raise ValueError(
            f"trace directory holds {q} batches but the checkpoint was "
            f"written at iteration {it} (expected "
            f"{it // r_stored_iters if r_stored_iters else 0} batches of "
            f"r_stored_iters={r_stored_iters}); the directory is stale or "
            "was written with a different r_stored_iters — refusing to mix "
            "trajectories")
    return run_batched(
        generator, state, data, hp, c, directory=directory,
        tot_mcmc_iters=additional_iters, r_stored_iters=r_stored_iters,
        config=config, thinning_num=thinning_num, n_temp_trans=n_temp_trans,
        beta_N_t=beta_N_t, N_t=N_t, checkpoint_every=checkpoint_every,
        start_batch=q, **sweep_flags)
