"""Rank mesh and sharding: chain- and data-parallel MCMC over
torch.distributed ranks.

Port of ``bayesfmmm_tpu/parallel/mesh.py``.  The JAX package lays devices
out on a (chains, data) mesh, annotates the chain axis of the ensemble and
the N axis of the data with shardings, and leaves the collectives to
GSPMD.  Here each process is one rank of a ``torch.distributed`` process
group, the ranks form a (chains, data) grid, and a rank holds rows
[lo, hi) of the ensemble's chain axis and, of the data with Z's and chi's
rows, observations [lo, hi) of N.

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
  * **Data parallelism**: ``shard_data`` keeps each rank's N/d rows of
    every N-leading field of the data (the penalty whole; ``n_obs``,
    ``pen_rank`` and the whole N stay the whole data set's), and
    ``shard_chain_states`` the same rows of Z and chi.  Every sum over n
    in the sweep is a partial sum over the rank's rows (K2's RSS and K3's
    Gram sums among them) that ``data_sum`` adds over the data group, so
    every rank of a group holds the same global fields, bit for bit, and
    the one-process run's to rounding.  Draws on rows name their data axis
    and are taken at the whole N.  A gradient is reduced beside its value
    (a sum built from broadcasts carries no gradient, and ``data_sum``
    refuses a tensor that needs one): MALA's, and the whole-model
    log-joint's of HMC, NUTS, ADVI and ``update_hmc_joint``, whose flat
    position holds the rank's rows of Z and chi beside the whole global
    fields (``models/logjoint.py::rank_slots``).
  * **The samplers**: SMC gathers its particles' log-likelihoods over the
    chains, so the next beta, the weights and the resampling index are the
    whole ensemble's on every rank, and a resampled particle crosses ranks
    (``samplers/smc.py``).  HMC and NUTS read the longest trajectory and
    whether any tree still grows over every rank (``mesh_max``,
    ``mesh_any``), so every rank takes the same draws; ADVI has no chain
    axis and runs the same optimisation on every rank of a data group.

The collectives are broadcasts only.  They keep every bit (a gather done as
a sum over zero-filled buffers would turn -0.0 into +0.0), a sum over the
data group is every rank's part broadcast and the d parts added in
data-rank order on every rank (so the ranks hold equal bits, which an
all_reduce does not promise), and every backend has them on every device:
gloo takes CUDA tensors only for broadcast and all_reduce, and two ranks
that share one card must use gloo (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
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
    ``shard_chain_states`` split over it, ``n_rows`` the N of the last
    data ``shard_data`` split over it.

    ``with mesh:`` turns on the split draws of ``ops/distributions.py`` and
    the sums over the data group of ``data_sum`` (on a mesh of more than
    one rank; on one it changes nothing).  Every draw inside then expects
    the rank's share of ``n_chains`` on its chain axis and of ``n_rows`` on
    its data axis, and raises otherwise.  ``collectives`` and
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
        self.n_rows = None
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
        self._outer.append(distributions._MESH)
        distributions._MESH = self if self.size > 1 else None
        return self

    def __exit__(self, *exc):
        distributions._MESH = self._outer.pop()

    # --- the rows of each axis -------------------------------------------

    def _rows(self, axis, n_local):
        """(lo, hi): the rows of the whole ensemble (chains axis) or the
        whole data (data axis) that this rank's ``n_local`` are; raises
        unless ``n_local`` is its share."""
        total, what, how = (
            (self.n_chains, "ensemble", "shard_chain_states")
            if axis == CHAIN_AXIS else (self.n_rows, "data", "shard_data"))
        if total is None:
            raise RuntimeError(
                f"no {what} was split over this mesh: call {how}(..., mesh) "
                f"before drawing under it")
        share = total // self.shape[axis]
        if n_local != share:
            raise ValueError(
                f"a draw over {n_local} rows of the {axis!r} axis under a "
                f"mesh whose rank holds {share} of the {what}'s {total}: "
                f"split it with {how}")
        lo = self.coords[axis] * share
        return lo, lo + share

    def chain_rows(self, n_local):
        """(lo, hi): the rows of the whole ensemble that this rank's
        ``n_local`` chains are; raises unless ``n_local`` is its share of
        ``n_chains``."""
        return self._rows(CHAIN_AXIS, n_local)

    def data_rows(self, n_local):
        """(lo, hi): the rows of the whole data that this rank's ``n_local``
        rows are; raises unless ``n_local`` is its share of ``n_rows``."""
        return self._rows(DATA_AXIS, n_local)

    def whole(self, shape, chain_dim, data_dim=None):
        """The whole draw's shape for this rank's ``shape`` (the whole
        ensemble on ``chain_dim``, the whole data's rows on ``data_dim``;
        None for no such axis), and [(dim, first row, rows)] to keep."""
        shape, keep = list(shape), []
        for axis, dim in ((CHAIN_AXIS, chain_dim), (DATA_AXIS, data_dim)):
            if dim is None or self.shape[axis] == 1:
                continue
            lo, hi = self._rows(axis, shape[dim])
            shape[dim] = (hi - lo) * self.shape[axis]
            keep.append((dim, lo, hi - lo))
        return tuple(shape), keep

    # --- collectives ------------------------------------------------------

    def _src(self, axis, k):
        """The global rank at coordinate ``k`` of ``axis`` in this rank's
        line of the grid."""
        at = dict(self.coords, **{axis: k})
        return int(self.devices[at[CHAIN_AXIS], at[DATA_AXIS]])

    def _broadcast(self, x, src, axis):
        """Broadcast over the ranks of ``axis`` (None: every rank)."""
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        dist.broadcast(x, src=src,
                       group=None if axis is None else self.groups[axis])
        self.collectives += 1
        self.collective_seconds += time.perf_counter() - t0
        return x

    def _parts(self, x, axis):
        """Every rank's ``x`` of the ranks of ``axis``, in their order."""
        me = self.coords[axis]
        return [self._broadcast(x if k == me else torch.empty_like(x),
                                self._src(axis, k), axis)
                for k in range(self.shape[axis])]

    def gather(self, x, dim=0, axis=CHAIN_AXIS):
        """Every rank's ``x`` (equal shapes) of the ranks of ``axis``,
        concatenated on ``dim`` in their order, on every rank; the bits
        kept."""
        if self.shape[axis] == 1:
            return x
        x = x.movedim(dim, 0).contiguous()
        return torch.cat(self._parts(x, axis)).movedim(0, dim)

    def gather_axes(self, x, chain_dim, data_dim=None):
        """``x`` with every rank's chains on ``chain_dim`` and every rank's
        rows of the data on ``data_dim`` (None: no such axis)."""
        if chain_dim is not None:
            x = self.gather(x, chain_dim)
        if data_dim is not None:
            x = self.gather(x, data_dim, DATA_AXIS)
        return x

    def gather_fields(self, fields, axis=CHAIN_AXIS):
        """``gather`` of a dict of tensors of one dtype on their first axis,
        as one packed collective per rank."""
        if self.shape[axis] == 1:
            return fields
        return _unpack(self.gather(_pack(fields), axis=axis), fields)

    def gather_rows(self, fields, dim=1):
        """The dict of tensors whose axis ``dim`` holds this rank's rows of
        the data, with every rank's rows there, in one packed collective
        per rank."""
        moved = {k: v.movedim(dim, 0) for k, v in fields.items()}
        return {k: v.movedim(0, dim) for k, v in
                self.gather_fields(moved, DATA_AXIS).items()}

    def sum_over_data(self, parts):
        """Each tensor of ``parts`` (one dtype) summed over the ranks of the
        data axis, as one packed collective per rank: every rank's parts
        are broadcast and every rank adds the d of them in data-rank
        order, so every rank of the group gets the same bits."""
        if torch.is_grad_enabled() and any(p.requires_grad for p in parts):
            raise RuntimeError(
                "a sum over the data axis is built from broadcasts and "
                "carries no gradient: reduce the value and its gradient "
                "apart (as update_phi_mala does)")
        flat = torch.cat([p.reshape(-1) for p in parts])
        total = functools.reduce(torch.add, self._parts(flat, DATA_AXIS))
        out, at = [], 0
        for p in parts:
            out.append(total[at:at + p.numel()].view(p.shape))
            at += p.numel()
        return out

    def broadcast_fields(self, fields):
        """The dict of tensors of the first rank of the chains axis, on
        every rank (each rank passes tensors of the same shapes)."""
        if self.shape[CHAIN_AXIS] == 1:
            return fields
        like = {k: v[None] for k, v in fields.items()}
        buf = self._broadcast(_pack(like), self._src(CHAIN_AXIS, 0),
                              CHAIN_AXIS)
        return {k: v[0] for k, v in _unpack(buf, like).items()}

    def barrier(self):
        """Wait for every rank of the mesh."""
        if self.size > 1:
            self._broadcast(torch.zeros(1, device=self.device),
                            int(self.devices[0, 0]), None)


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
    """The mesh whose ``with`` block splits the chains or the data right
    now, else None."""
    return distributions._MESH


def data_sum(*parts):
    """The sum over the data group of each partial sum of ``parts`` (sums
    over this rank's rows of the data), inside a ``with mesh:`` block that
    splits the data; the tensors themselves elsewhere.  One tensor gives
    one tensor, several a tuple, summed in one collective.  A tensor that
    needs a gradient raises there: reduce the value and its gradient
    apart."""
    mesh = distributions._MESH
    if mesh is not None and mesh.shape[DATA_AXIS] > 1:
        parts = tuple(mesh.sum_over_data(parts))
    return parts[0] if len(parts) == 1 else parts


def data_split():
    """The mesh whose ``with`` block splits the data's rows right now, else
    None."""
    mesh = distributions._MESH
    return mesh if mesh is not None and mesh.shape[DATA_AXIS] > 1 else None


def chain_split():
    """The mesh whose ``with`` block splits the chains right now, else
    None."""
    mesh = distributions._MESH
    return mesh if mesh is not None and mesh.shape[CHAIN_AXIS] > 1 else None


def _every_rank(x):
    """``x`` (one value a rank) of every rank of the active split mesh, on
    every rank, the chains axis's ranks then the data axis's."""
    mesh = distributions._MESH
    return mesh.gather(mesh.gather(x.reshape(1), 0), 0, DATA_AXIS)


def mesh_max(x):
    """``int(x.max())``, the largest over every rank inside a ``with mesh:``
    block that splits the chains or the data, so that every rank runs as
    many steps as the longest of all."""
    m = x.max()
    return int(m if distributions._MESH is None else _every_rank(m).max())


def mesh_any(x):
    """``bool(x.any())``, over every rank inside a ``with mesh:`` block that
    splits the chains or the data, so that every rank goes on (and takes
    the same draws) while any chain of any rank does."""
    a = x.any()
    if distributions._MESH is None:
        return bool(a)
    return bool(_every_rank(a.to(torch.int32)).any())


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
    data axis, the penalty whole."""
    def spec(arr_name):
        if arr_name == "pen":
            return NamedSharding(mesh, ())
        return NamedSharding(mesh, (DATA_AXIS,))
    return spec


def shard_data(data, mesh: Mesh):
    """Place a ModelData on the mesh: this rank's rows of every N-leading
    field on its device, the penalty whole; the whole data set's constants
    (``n_obs``, ``pen_rank`` and the whole N, ``N_whole``) kept.  An N the
    data axis does not divide raises.  The N is recorded on the mesh for
    the draws under it."""
    spec = data_sharding(mesh)
    out = dataclasses.replace(data, n_whole=data.N_whole, **{
        f: spec(f).place(getattr(data, f))
        for f in ("y", "mask", "B", "X", "G", "pen", "u", "yy")})
    mesh.n_rows = data.N_whole
    return out


def chain_state_sharding(mesh: Mesh, state_batch):
    """Shardings for a chains-leading GibbsState, by field: the chain axis
    over the chains axis; the per-observation Z and chi also split their N
    axis over the data axis."""
    return {f: NamedSharding(mesh, (CHAIN_AXIS, DATA_AXIS)
                             if f in ("Z", "chi") else (CHAIN_AXIS,))
            for f in STATE_FIELDS}


def shard_chain_states(state_batch, mesh: Mesh):
    """This rank's rows [lo, hi) of a whole ensemble, and of Z's and chi's
    its rows of the data, on its device; the ensemble's size is recorded
    on the mesh for the draws under it.  A chain count the chains axis, or
    an N the data axis, does not divide raises."""
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
    inverse of ``shard_chain_states``; one packed collective over the
    chains, then one of Z's and chi's rows over the data)."""
    fields = mesh.gather_fields({f: getattr(states, f) for f in STATE_FIELDS})
    if mesh.shape[DATA_AXIS] > 1:
        fields.update(mesh.gather_rows({f: fields[f] for f in ("Z", "chi")}))
    return GibbsState(**fields)
