"""Exact-state checkpoint / resume for the sampler.

Port of ``bayesfmmm_tpu/io/checkpoint.py``.  The reference has NO
exact-state resume: its two mechanisms are batch trace persistence
(BFMMM.h:205-271) and warm-starting from point estimates
(UserFunctions.cpp:1557-1650), and the RNG state is lost.  Here a checkpoint
holds every field of the sampler state for all C chains, the state of the
ensemble's ``torch.Generator``, the iteration reached and the model's
configuration, so a resumed ensemble continues the exact same trajectory.

The file is one ``.npz`` with the JAX package's names (``state__<field>``,
``iteration``), so a checkpoint that package wrote as ``.npz`` loads too.
Such a file holds JAX PRNG keys, which are no generator state: the caller
then gives a seed for a new generator.  A failed write raises.

Under ``with mesh:`` (``parallel/mesh.py``) a rank holds only its rows of
the ensemble; ``save_checkpoint`` then gathers them and the first rank of
the chains axis writes the one file the one-process run writes, with the
generator's state, which every rank shares.  ``load_checkpoint`` followed
by ``shard_chain_states`` resumes it on any number of ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bayesfmmm_torch.config import ModelConfig
from bayesfmmm_torch.models.state import STATE_FIELDS, GibbsState
from bayesfmmm_torch.parallel import mesh as pmesh


def _npz_path(path) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path, state: GibbsState, generator: torch.Generator,
                    iteration: int = 0, config: ModelConfig | None = None):
    """Save (state, generator state, iteration, config) to ``path``
    (``.npz`` is appended when missing).

    A CUDA generator's state is a small host byte tensor (seed and Philox
    offset) that a CPU generator cannot take, so the generator's device
    type is stored beside it.  Under a split mesh every rank calls it with
    its rows; the file holds the whole ensemble, and every rank returns once
    it is written."""
    mesh = pmesh.active_mesh()
    if mesh is not None:
        state = pmesh.gather_chain_states(state, mesh)
        if mesh.coords[pmesh.CHAIN_AXIS] != 0:
            mesh.barrier()
            return
    try:
        arrs = {f"state__{f}": getattr(state, f).detach().cpu().numpy()
                for f in STATE_FIELDS}
        arrs["generator_state"] = generator.get_state().numpy()
        arrs["generator_device"] = np.asarray(generator.device.type)
        arrs["iteration"] = np.asarray(iteration)
        if config is not None:
            for k, v in dataclasses.asdict(config).items():
                arrs[f"config__{k}"] = np.asarray(v)
        np.savez(_npz_path(path), **arrs)
    finally:
        if mesh is not None:
            mesh.barrier()


def load_checkpoint(path, device, seed=None, dtype=torch.float32):
    """Returns (state, generator, iteration, config) on ``device``, the
    state's fields in ``dtype`` (the data's: a float64 fit resumes in
    float64).

    ``config`` is None for a file without one (one the JAX package wrote).
    The generator is a new ``torch.Generator(device=device)`` set to the
    stored state; a checkpoint made on one device type refuses to resume on
    another, since the two generators' streams are not the same.  A file
    without a generator state needs ``seed``."""
    device = torch.device(device)
    with np.load(_npz_path(path)) as z:
        state = GibbsState(**{
            f: torch.tensor(z[f"state__{f}"], dtype=dtype, device=device)
            for f in STATE_FIELDS})
        iteration = int(z["iteration"])
        fields = [f.name for f in dataclasses.fields(ModelConfig)]
        config = None
        if f"config__{fields[0]}" in z:
            config = ModelConfig(**{k: z[f"config__{k}"].item()
                                    for k in fields})
        generator = torch.Generator(device=device)
        if "generator_state" in z:
            made_on = str(z["generator_device"])
            if made_on != device.type:
                raise ValueError(
                    f"checkpoint {path} holds the state of a {made_on!r} "
                    f"generator and cannot resume on {device.type!r}: the "
                    f"two draw different streams")
            generator.set_state(torch.from_numpy(z["generator_state"].copy()))
        elif seed is None:
            raise ValueError(
                f"checkpoint {path} holds no torch generator state (the JAX "
                f"package wrote it); pass seed= to start a new generator")
        else:
            generator.manual_seed(seed)
    return state, generator, iteration, config
