"""Rank mesh and sharding: chain-parallel MCMC over torch.distributed ranks.

Port of ``bayesfmmm_tpu/parallel/mesh.py``.  The JAX package lays devices
out on a (chains, data) mesh, annotates the chain axis of the ensemble (and
the N axis of the data) with shardings, and leaves the collectives to
GSPMD.  Here each process is one rank of a ``torch.distributed`` process
group, the ranks form a (chains, data) grid, and a rank holds rows
[lo, hi) of the ensemble's chain axis.

  * **Chain parallelism** (this module): the ensemble is built whole, then
    ``shard_chain_states`` keeps each rank's rows.  Chains need no
    communication, except through the one ``torch.Generator`` the port
    keeps for the whole ensemble (ROADMAP, Decisions): every rank holds a
    copy seeded alike, and inside ``with mesh:`` every draw of the sweep is
    taken at the whole ensemble's shape and cut to the rank's rows
    (``ops/distributions.py``), so each rank draws exactly the rows the
    one-process run draws and its generator stays in step with the
    others'.  Gamma shapes are gathered first (their CPU sampler spends
    uniforms by value).  Parallel tempering gathers its energies and moves
    the replicas whose swap partner sits on the next rank
    (``parallel/tempering.py``); a checkpoint of a split ensemble is the
    one file the one-process run writes (``io/checkpoint.py``).
  * **Data parallelism** (the data axis above one shard) is not ported: it
    puts a collective into every reduction over the N observations, and
    ``shard_data``, ``data_sharding`` and a split Z or chi raise
    ``NotImplementedError`` there rather than hand out a replicated copy.

The collectives are broadcasts only.  They keep every bit (a gather done as
a sum over zero-filled buffers would turn -0.0 into +0.0), and every
backend has them on every device: gloo takes CUDA tensors only for
broadcast and all_reduce, and two ranks that share one card must use gloo
(NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from bayesfmmm_torch.models.state import (STATE_FIELDS, GibbsState,
                                          default_device)
from bayesfmmm_torch.ops import distributions

CHAIN_AXIS = "chains"
DATA_AXIS = "data"

_DATA_AXIS_TODO = ("a data axis above one shard (ROADMAP item 15b) is not "
                   "ported: it needs a collective in every reduction over "
                   "the N observations")
_BACKENDS = ("gloo", "nccl")


def collective_backend(device, num_processes):
    """The backend for ``num_processes`` ranks on ``device``: NCCL when the
    ranks sit on CUDA cards, one a card; gloo on the CPU and for ranks that
    share a card."""
    device = torch.device(device)
    if device.type == "cuda" and num_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _check_backend(backend, device, num_processes):
    """Raise unless ``backend`` can run this module's collectives between
    ``num_processes`` ranks on ``device``."""
    device = torch.device(device)
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this "
                           "build of PyTorch")
    if backend not in _BACKENDS:
        raise ValueError(f"backend {backend!r}: the mesh's collectives are "
                         f"written for {' or '.join(_BACKENDS)}")
    if backend == "gloo" and not dist.is_gloo_available():
        raise RuntimeError("this build of PyTorch has no gloo backend")
    if backend == "nccl":
        if device.type != "cuda" or not dist.is_nccl_available():
            raise RuntimeError(f"NCCL runs collectives between CUDA cards "
                               f"only, not on {device}")
        if num_processes > torch.cuda.device_count():
            raise RuntimeError(
                f"NCCL refuses two ranks on one card: {num_processes} ranks "
                f"for {torch.cuda.device_count()} card(s); ranks that share "
                f"a card take gloo")


def initialize_distributed(coordinator=None, num_processes=None,
                           process_id=None, *, backend=None,
                           init_method=None, device=None):
    """Join ``num_processes`` ranks into one process group; nothing for one
    process.  Returns the backend, or None for one process.

    ``coordinator`` is rank 0's "host:port" (a ``tcp://`` rendezvous);
    ``init_method`` (say ``file:///tmp/store``) takes its place.  The
    backend is NCCL for ranks on CUDA cards, one a card, and gloo on the CPU
    (``device="cpu"``) or for ranks that share a card; ``device`` is the
    card when None, as elsewhere in the port.  A backend that cannot run
    the mesh's collectives on the rank's device raises."""
    if not num_processes or num_processes <= 1:
        return None
    if process_id is None:
        raise ValueError("initialize_distributed: process_id is needed "
                         "with more than one process")
    if init_method is None:
        if coordinator is None:
            raise ValueError("initialize_distributed: give coordinator "
                             "('host:port') or init_method")
        init_method = f"tcp://{coordinator}"
    device = default_device(device)
    backend = backend or collective_backend(device, num_processes)
    _check_backend(backend, device, num_processes)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(minutes=5))
    return backend


def mesh_shape(n, n_chain_shards=None, n_data_shards=None):
    """(chain shards, data shards) of a mesh over ``n`` ranks, by the JAX
    package's rule: every rank on the chains axis by default, one count
    given and the other inferred, and a product other than ``n`` raises."""
    if n_chain_shards is None and n_data_shards is None:
        n_chain_shards, n_data_shards = n, 1
    elif n_chain_shards is None:
        n_chain_shards = n // n_data_shards
    elif n_data_shards is None:
        n_data_shards = n // n_chain_shards
    if n_chain_shards * n_data_shards != n:
        raise ValueError(f"mesh {n_chain_shards}x{n_data_shards} != {n} "
                         f"ranks")
    return n_chain_shards, n_data_shards


class Mesh:
    """A (chains, data) grid of the process group's ranks, as seen from one
    rank.

    ``devices``: the (chains, data) array of global ranks (JAX's
    ``Mesh.devices`` holds devices there); ``shape``: axis name -> size;
    ``coords``: this rank's index on each axis; ``groups``: axis name -> the
    ``torch.distributed`` group of the ranks that differ from this one on
    that axis only (None for an axis of size 1); ``device``: this rank's
    device.  ``n_chains`` is the size of the last ensemble
    ``shard_chain_states`` split over it.

    ``with mesh:`` turns on the split draws of ``ops/distributions.py`` (on
    a mesh of more than one chain shard; on one it changes nothing).  Every
    draw inside then expects the rank's share of ``n_chains`` on its chain
    axis and raises otherwise.  ``collectives`` and
    ``collective_seconds`` count the broadcasts this rank took part in and
    their time on the host's clock."""

    axis_names = (CHAIN_AXIS, DATA_AXIS)

    def __init__(self, ranks, rank, device, groups):
        self.devices = ranks
        self.shape = dict(zip(self.axis_names, ranks.shape))
        ci, di = (int(x) for x in np.argwhere(ranks == rank)[0])
        self.coords = {CHAIN_AXIS: ci, DATA_AXIS: di}
        self.rank = rank
        self.device = device
        self.groups = groups
        self.n_chains = None
        self.collectives = 0
        self.collective_seconds = 0.0
        self._outer = []

    @property
    def size(self):
        return self.devices.size

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device})")

    def __enter__(self):
        if self.shape[DATA_AXIS] > 1:
            raise NotImplementedError(_DATA_AXIS_TODO)
        self._outer.append(distributions._CHAIN_SHARD)
        distributions._CHAIN_SHARD = (self if self.shape[CHAIN_AXIS] > 1
                                      else None)
        return self

    def __exit__(self, *exc):
        distributions._CHAIN_SHARD = self._outer.pop()

    # --- the chain axis ---------------------------------------------------

    def chain_rows(self, n_local):
        """(lo, hi): the rows of the whole ensemble that this rank's
        ``n_local`` chains are; raises unless ``n_local`` is its share of
        ``n_chains``."""
        if self.n_chains is None:
            raise RuntimeError(
                "no ensemble was split over this mesh: call "
                "shard_chain_states(states, mesh) before drawing under it")
        share = self.n_chains // self.shape[CHAIN_AXIS]
        if n_local != share:
            raise ValueError(
                f"a draw over {n_local} chains under a mesh whose rank holds "
                f"{share} of the ensemble's {self.n_chains}: split the "
                f"ensemble with shard_chain_states")
        lo = self.coords[CHAIN_AXIS] * share
        return lo, lo + share

    def whole(self, shape, chain_dim):
        """The whole ensemble's draw shape for this rank's ``shape``, and
        the (first row, rows) to keep on ``chain_dim``."""
        shape = tuple(shape)
        lo, hi = self.chain_rows(shape[chain_dim])
        whole = shape[:chain_dim] + (self.n_chains,) + shape[chain_dim + 1:]
        return whole, (lo, hi - lo)

    def _chain_src(self, k):
        """The global rank at chain coordinate ``k`` in this rank's
        column."""
        return int(self.devices[k, self.coords[DATA_AXIS]])

    def _broadcast(self, x, src):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        dist.broadcast(x, src=src, group=self.groups[CHAIN_AXIS])
        self.collectives += 1
        self.collective_seconds += time.perf_counter() - t0
        return x

    def gather(self, x, chain_dim=0):
        """Every rank's ``x`` (equal shapes), concatenated on ``chain_dim``
        in chain order, on every rank; the bits kept."""
        if self.shape[CHAIN_AXIS] == 1:
            return x
        x = x.movedim(chain_dim, 0).contiguous()
        me = self.coords[CHAIN_AXIS]
        parts = [self._broadcast(x if k == me else torch.empty_like(x),
                                 self._chain_src(k))
                 for k in range(self.shape[CHAIN_AXIS])]
        return torch.cat(parts).movedim(0, chain_dim)

    def gather_fields(self, fields):
        """``gather`` of a dict of chain-leading tensors of one dtype, as one
        packed collective per rank."""
        return _unpack(self.gather(_pack(fields)), fields)

    def broadcast_fields(self, fields):
        """The dict of tensors of the first rank of the chains axis, on
        every rank (each rank passes tensors of the same shapes)."""
        if self.shape[CHAIN_AXIS] == 1:
            return fields
        like = {k: v[None] for k, v in fields.items()}
        buf = self._broadcast(_pack(like), self._chain_src(0))
        return {k: v[0] for k, v in _unpack(buf, like).items()}

    def barrier(self):
        """Wait for every rank of the chains axis."""
        if self.shape[CHAIN_AXIS] > 1:
            self._broadcast(torch.zeros(1, device=self.device),
                            self._chain_src(0))


def _pack(fields):
    """(rows, total width) of the chain-leading tensors of ``fields``."""
    rows = next(iter(fields.values())).shape[0]
    return torch.cat([v.reshape(rows, int(np.prod(v.shape[1:])))
                      for v in fields.values()], 1)


def _unpack(buf, like):
    """``_pack``'s inverse, for the shapes of ``like`` past their first
    axis; the rows are ``buf``'s."""
    out, at = {}, 0
    for k, v in like.items():
        width = int(np.prod(v.shape[1:]))
        out[k] = buf[:, at:at + width].reshape((buf.shape[0],)
                                               + tuple(v.shape[1:]))
        at += width
    return out


def active_mesh():
    """The mesh whose ``with`` block splits the chains right now, else
    None."""
    return distributions._CHAIN_SHARD


def make_mesh(n_chain_shards=None, n_data_shards=None, devices=None) -> Mesh:
    """Build a (chains, data) mesh over the process group's ranks (one rank
    when there is no process group).

    By default every rank is on the chains axis, the dominant parallelism
    for MCMC (independent chains need no communication).  Rank r sits at
    (r // data shards, r % data shards), as the JAX package reshapes its
    device list.  ``devices``: this rank's device, or one device per rank
    (rank r takes ``devices[r]``); the card when None (``cuda:r`` modulo
    the cards there are).  Every rank must call this with the same
    counts."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if isinstance(devices, (list, tuple)):
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = torch.device(devices[rank])
    elif devices is not None:
        device = torch.device(devices)
    else:
        default_device(None)                # raises without a card
        device = torch.device("cuda", rank % torch.cuda.device_count())
    c, d = mesh_shape(world, n_chain_shards, n_data_shards)
    ranks = np.arange(world).reshape(c, d)
    groups = {CHAIN_AXIS: None, DATA_AXIS: None}
    # every rank creates every group, in the same order (new_group's rule);
    # a DeviceMesh would pin rank r to cuda:r, which one card does not have
    for axis, lines in ((CHAIN_AXIS, ranks.T), (DATA_AXIS, ranks)):
        if ranks.shape[Mesh.axis_names.index(axis)] == 1:
            continue
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return Mesh(ranks, rank, device, groups)


class NamedSharding(NamedTuple):
    """How a tensor lies on the mesh: ``spec`` names the mesh axis each of
    its leading axes is split over (None: whole), as JAX's PartitionSpec."""
    mesh: Mesh
    spec: tuple

    def place(self, x):
        """This rank's part of ``x``, on the rank's device."""
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            n = self.mesh.shape[axis]
            if axis == DATA_AXIS and n > 1:
                raise NotImplementedError(_DATA_AXIS_TODO)
            if x.shape[dim] % n:
                raise ValueError(f"{x.shape[dim]} rows of axis {dim} do not "
                                 f"split over the {n} ranks of the {axis!r} "
                                 f"axis")
            share = x.shape[dim] // n
            x = x.narrow(dim, self.mesh.coords[axis] * share,
                         share).contiguous()
        return x.to(self.mesh.device)


def data_sharding(mesh: Mesh):
    """Shardings for ModelData by field name: the N-leading tensors over the
    data axis, the penalty whole.  Above one data shard it raises (ROADMAP
    item 15b)."""
    if mesh.shape[DATA_AXIS] > 1:
        raise NotImplementedError(_DATA_AXIS_TODO)

    def spec(arr_name):
        if arr_name == "pen":
            return NamedSharding(mesh, ())
        return NamedSharding(mesh, (DATA_AXIS,))
    return spec


def shard_data(data, mesh: Mesh):
    """Place a ModelData on the mesh: at one data shard, whole on the rank's
    device; above one it raises (ROADMAP item 15b)."""
    spec = data_sharding(mesh)
    return dataclasses.replace(data, **{
        f: spec(f).place(getattr(data, f))
        for f in ("y", "mask", "B", "X", "G", "pen", "u", "yy")})


def chain_state_sharding(mesh: Mesh, state_batch):
    """Shardings for a chains-leading GibbsState, by field: the chain axis
    over the chains axis; the per-observation Z and chi also name the data
    axis for their N axis (whole at one data shard)."""
    return {f: NamedSharding(mesh, (CHAIN_AXIS, DATA_AXIS)
                             if f in ("Z", "chi") else (CHAIN_AXIS,))
            for f in STATE_FIELDS}


def shard_chain_states(state_batch, mesh: Mesh):
    """This rank's rows [lo, hi) of a whole ensemble, on its device; the
    ensemble's size is recorded on the mesh for the draws under it.  A
    chain count the chains axis does not divide raises."""
    C = state_batch.Z.shape[0]
    if C % mesh.shape[CHAIN_AXIS]:
        raise ValueError(f"{C} chains do not split over the "
                         f"{mesh.shape[CHAIN_AXIS]} ranks of the chains axis")
    shardings = chain_state_sharding(mesh, state_batch)
    out = GibbsState(**{f: shardings[f].place(getattr(state_batch, f))
                        for f in STATE_FIELDS})
    mesh.n_chains = C
    return out


def key_sharding(mesh: Mesh):
    """The sharding of a chains-leading tensor.  The port has no per-chain
    PRNG keys to shard: its one ``torch.Generator`` is replicated, every
    rank holding a copy in the same state, and the draws under
    ``with mesh:`` keep the copies in step."""
    return NamedSharding(mesh, (CHAIN_AXIS,))


def gather_chain_states(states, mesh: Mesh):
    """The whole ensemble, on every rank, from each rank's rows (the
    inverse of ``shard_chain_states``; one packed collective)."""
    return GibbsState(**mesh.gather_fields(
        {f: getattr(states, f) for f in STATE_FIELDS}))
