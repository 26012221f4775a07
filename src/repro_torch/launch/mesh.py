"""Meshes of the port: counterpart of `repro.launch.mesh`.

A JAX mesh is an array of devices with named axes. In the port its devices
are `torch.distributed` ranks: rank ``r`` sits at the row-major coordinates
of ``r`` in the mesh's shape (the order `jax.make_mesh` gives host devices),
and every subset of the axes has a process group: the ranks that differ
only along those axes. Every rank creates every group, in one order, when
the mesh is made (`dist.new_group` is collective).

The collectives run on the ``gloo`` backend (ranks sharing one card cannot
use a backend that holds one device per rank), whose algorithms work on
host memory. A CUDA tensor goes through an explicit copy to pinned host
memory and back (`_staged`), the same on every torch version: gloo's own
CUDA paths, where a version has them, make that copy inside. A mesh of one
rank needs no process group and its collectives return their input.

Production meshes (abstract: shapes only, no processes; `launch.specs`
reads them):
  single pod : (data=16, model=16)            = 256 devices
  multi-pod  : (pod=2, data=16, model=16)     = 512 devices
`RecordingMesh` plays one rank of such a mesh with no process: its
collectives return tensors of the right shape and tally their bytes (the
dry run, `launch.dryrun`).
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axes = Union[None, str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """The buffer a collective of ``group`` runs on: ``t`` itself when it is
    a contiguous host tensor, else a copy in host memory (pinned when ``t``
    is on a card, so the copies are DMA transfers). The backend is gloo
    (`_check_backend`), whose collectives run on host tensors."""
    _check_backend(group)
    if t.device.type == "cpu" and t.is_contiguous():
        return t
    host = torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda")
    host.copy_(t)
    return host


def _check_backend(group) -> None:
    backend = dist.get_backend(group)
    if backend != "gloo":
        raise ValueError(f"the port's collectives run on gloo, not {backend!r}")


class Mesh:
    """Named axes over the ranks of the default process group (or over no
    process: ``rank=None`` makes an abstract mesh for shapes only).

    ``shape`` maps each axis to its size, as JAX's ``mesh.shape`` does;
    ``coords`` maps each axis to this rank's coordinate. Every rank of the
    group makes the mesh (the process groups are made then)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 rank: Optional[int] = 0):
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)}")
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self.coords = None
        self._groups: Dict[frozenset, object] = {}
        if rank is None:
            return
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.coords = self._coords_of(rank)
        if self.size > 1:
            self._make_groups()

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    def _make_groups(self) -> None:
        rank, world = _world()
        if world != self.size or rank != self.rank:
            raise ValueError(
                f"a mesh of {self.size} ranks needs torch.distributed "
                f"initialised with {self.size} ranks (rank {self.rank}); it "
                f"has {world} (rank {rank})")
        sizes = tuple(self.shape.values())
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for subset in itertools.combinations(range(len(names)), k):
                if math.prod(sizes[i] for i in subset) == 1:
                    continue
                rest = [i for i in range(len(names)) if i not in subset]
                for fixed in itertools.product(*(range(sizes[i]) for i in rest)):
                    members = []
                    for free in itertools.product(*(range(sizes[i]) for i in subset)):
                        coord = [0] * len(names)
                        for i, c in zip(rest, fixed):
                            coord[i] = c
                        for i, c in zip(subset, free):
                            coord[i] = c
                        members.append(int(np.ravel_multi_index(coord, sizes)))
                    group = dist.new_group(sorted(members))
                    if self.rank in members:
                        self._groups[frozenset(names[i] for i in subset)] = group

    # -- indices ----------------------------------------------------------

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, axes: Axes, coords: Optional[Dict[str, int]] = None) -> int:
        """This rank's (or ``coords``') piece along ``axes``: the row-major
        index over the axes in the order given (the first axis major, as a
        JAX spec entry ``("model", "data")`` splits a dim)."""
        coords = self.coords if coords is None else coords
        if coords is None:
            raise ValueError("an abstract mesh has no rank")
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def group(self, axes: Axes):
        """The process group of the ranks that differ from this one only
        along ``axes``; None where they are this rank alone."""
        key = frozenset(_axes(axes))
        if self.axis_size(tuple(key)) == 1:
            return None
        if self.rank is None:
            raise ValueError("an abstract mesh runs no collective")
        return self._groups[key]

    # -- collectives -------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, axes: Axes, op: str = "sum"):
        """``t`` reduced in place (``"sum"`` or ``"max"``) over the ranks
        along ``axes``; returns ``t``."""
        self.all_reduce_many([t], axes, op)
        return t

    def all_reduce_many(self, tensors, axes: Axes, op: str = "sum") -> None:
        """Each of ``tensors`` reduced in place over the ranks along
        ``axes``, all of them in flight at once (gloo spreads them over its
        worker threads, so the leaves of a gradient overlap)."""
        group = self.group(axes)
        if group is None or not tensors:
            return
        bufs = [_staged(t, group) for t in tensors]
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        works = [dist.all_reduce(b, op=red, group=group, async_op=True)
                 for b in bufs]
        for work in works:
            work.wait()
        for t, b in zip(tensors, bufs):
            if b is not t:
                t.copy_(b)

    def reduce_scatter_many(self, tensors, axes: Axes):
        """For each of ``tensors``, 1-d and made of `members`' chunks in
        their order (equal sizes), this rank's chunk summed over the ranks
        along ``axes``: a reduce-scatter, every tensor in flight at once.
        Returns the sums, on the tensors' devices."""
        group = self.group(axes)
        if group is None:
            return list(tensors)
        n = self.axis_size(axes)
        bufs = [_staged(t, group) for t in tensors]
        outs = [torch.empty(b.numel() // n, dtype=b.dtype) for b in bufs]
        works = [dist.reduce_scatter(o, list(b.chunk(n)), group=group,
                                     async_op=True)
                 for o, b in zip(outs, bufs)]
        for work in works:
            work.wait()
        return [o.to(t.device) for o, t in zip(outs, tensors)]

    def all_gather(self, t: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
        """The pieces of the ranks along ``axes`` joined along ``dim`` in
        their `index` order, on ``t``'s device."""
        group = self.group(axes)
        if group is None:
            return t
        buf = _staged(t, group)
        pieces = [torch.empty_like(buf) for _ in range(self.axis_size(axes))]
        dist.all_gather(pieces, buf, group=group)
        order = [self.index(axes, c) for c in self.members(axes)]
        joined = torch.cat([pieces[order.index(i)] for i in range(len(order))],
                           dim=dim)
        return joined.to(t.device)

    def members(self, axes: Axes) -> list:
        """The coordinates of the ranks along ``axes`` (this rank's group),
        in the group's rank order."""
        group = self.group(axes)
        if group is None:
            return [self.coords]
        return [self._coords_of(r) for r in dist.get_process_group_ranks(group)]

    def _coords_of(self, rank: int) -> Dict[str, int]:
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
            rank, tuple(self.shape.values())))))

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


class RecordingMesh(Mesh):
    """Rank ``rank`` of a mesh played with no process: the dry run's mesh
    (`launch.dryrun`). Each collective returns a tensor of its result's
    shape (empty, on the input's device: ``meta`` in the dry run) and adds
    the result's bytes to ``bytes`` under JAX's op names (``all-reduce``,
    ``all-gather``, ``reduce-scatter``: what `repro.launch.dryrun.
    parse_collectives` sums from the HLO) and to ``axis_bytes`` under
    (name, mesh axes), its count to ``counts``, and ``(kind, shape)`` to
    ``events`` in call order. An axis of one rank runs no collective, as on
    a real mesh."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], rank: int = 0):
        super().__init__(shape, axes, rank=None)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = self._coords_of(rank)
        self.reset()

    def reset(self) -> None:
        """Empty the tallies."""
        self.bytes: Dict[str, int] = {}
        self.axis_bytes: Dict[tuple, int] = {}
        self.counts: Dict[str, int] = {}
        self.events: list = []

    def _record(self, kind: str, t: torch.Tensor, axes: Axes) -> None:
        n = t.numel() * t.element_size()
        self.bytes[kind] = self.bytes.get(kind, 0) + n
        key = (kind, tuple(a for a in self.axis_names if a in _axes(axes)))
        self.axis_bytes[key] = self.axis_bytes.get(key, 0) + n
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.events.append((kind, tuple(t.shape)))

    def group(self, axes: Axes):
        return None if self.axis_size(axes) == 1 else frozenset(_axes(axes))

    def all_reduce_many(self, tensors, axes: Axes, op: str = "sum") -> None:
        if self.group(axes) is not None:
            for t in tensors:
                self._record("all-reduce", t, axes)

    def reduce_scatter_many(self, tensors, axes: Axes):
        if self.group(axes) is None:
            return list(tensors)
        n = self.axis_size(axes)
        outs = [torch.empty(t.numel() // n, dtype=t.dtype, device=t.device)
                for t in tensors]
        for o in outs:
            self._record("reduce-scatter", o, axes)
        return outs

    def all_gather(self, t: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
        if self.group(axes) is None:
            return t
        shape = list(t.shape)
        shape[dim] *= self.axis_size(axes)
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
        self._record("all-gather", out, axes)
        return out

    def members(self, axes: Axes) -> list:
        """The coordinates of the ranks along ``axes``, in `index` order."""
        names = _axes(axes)
        sizes = [self.shape[a] for a in names]
        out = []
        for i in range(self.axis_size(names)):
            coords = dict(self.coords)
            coords.update(zip(names, (int(c) for c in np.unravel_index(i, sizes))))
            out.append(coords)
        return out

    def barrier(self) -> None:
        pass

    def broadcast_object(self, obj):
        return obj


def make_mesh_compat(shape, axes) -> Mesh:
    """The mesh ``shape`` with named ``axes`` over the default process
    group's ranks (or this process alone when their product is 1)."""
    rank, _ = _world()
    return Mesh(shape, axes, rank=rank)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract production mesh (no processes): shapes only."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, rank=None)


def make_host_mesh(model_parallel: int = 2) -> Mesh:
    """(data, model) over every rank of the default process group (one
    without it): ``model_parallel`` halved until it divides the ranks."""
    _, n = _world()
    mp = model_parallel
    while mp > 1 and n % mp:
        mp //= 2
    return make_mesh_compat((n // mp, mp), ("data", "model"))


__all__ = ["Mesh", "RecordingMesh", "make_host_mesh", "make_mesh_compat",
           "make_production_mesh"]
