"""The client-axis mesh across ranks (port of fedml_tpu/parallel/mesh.py).

JAX's mesh is devices inside one program, and XLA moves the bytes of a
`psum`.  The port's mesh is PROCESSES, one device each, joined by
`torch.distributed` over gloo: a `Mesh` holds the axis names, the grid of
global ranks laid out on them, this rank's coordinates, and a process
group along each axis and over the whole mesh.  A "sharding" is this
rank's row range of a leading (client) axis; `shard_cohort` and
`shard_stack` return this rank's share.

Axis conventions, as in JAX:

  "clients"  the federated data-parallel axis (the cohort dimension K);
  "silo"     the cross-silo tier of hierarchical FL (2-D meshes);
  "batch"    per-client sample parallelism: each client's per-step
             batch split over the ranks of this axis, the gradient
             folded once a step (core/trainer.py ``batch_axes``).

Rank order is JAX's device order: rank r of a 1-D mesh holds the rows
that ``NamedSharding(mesh, P("clients"))`` places on device r, on a
(silo, clients) mesh rank s * per_silo + c sits at grid cell (s, c), and
on a (clients, batch) mesh rank c * n_batch + b at (c, b).

Float exchanges go through the host: `Mesh.all_gather` gathers host
arrays (CPU tensors under gloo) from every rank of an axis group and
returns them in mesh-coordinate order; callers fold them in that order
(multihost.py::fold_block_partials), so every rank commits the same bits
and no float sum goes through an all-reduce, whose order the backend
picks.  A mesh of one rank needs no process group and launches no
collective.  A mesh over a subset of the world (`devices`) is built by
every rank (group creation is collective over the world) and is None on
the ranks outside it.  `pvary_tree` has no counterpart: it is a JAX type-system
device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.utils.device import resolve_device

CLIENT_AXIS = "clients"
SILO_AXIS = "silo"
BATCH_AXIS = "batch"


def world() -> tuple[int, int]:
    """(world size, this process's rank) of the initialized default
    process group, or (1, 0) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A grid of global ranks over named axes, seen from one rank.

    `grid` holds the global ranks (row-major over `axis_names`); `rank` is
    this process's.  `groups` maps a tuple of axes to the process group of
    this rank's sub-grid along them (None: one member, or the layout of
    `Mesh.layout`, which has no groups)."""

    def __init__(self, axis_names: Sequence[str], grid, rank: int,
                 groups: Optional[dict] = None):
        self.axis_names = tuple(axis_names)
        self.grid = np.asarray(grid, dtype=np.int64)
        if self.grid.ndim != len(self.axis_names):
            raise ValueError(f"a grid of {self.grid.ndim} dims for axes "
                             f"{self.axis_names}")
        self.rank = int(rank)
        where = np.argwhere(self.grid == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not in this mesh's grid "
                             f"{self.grid.tolist()}")
        self.coords = dict(zip(self.axis_names,
                               (int(i) for i in where[0])))
        self._groups = dict(groups or {})

    @classmethod
    def layout(cls, axis_names: Sequence[str], shape: Sequence[int],
               rank: int) -> "Mesh":
        """The mesh of `shape` over ranks 0.. in row-major order, seen from
        `rank`, with no process group: its row ranges and coordinates are
        those of the mesh a launched cluster builds, and a collective over
        more than one rank raises."""
        return cls(axis_names, np.arange(int(np.prod(shape))).reshape(
            tuple(shape)), rank)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.grid.shape))

    @property
    def size(self) -> int:
        return int(self.grid.size)

    @property
    def is_first(self) -> bool:
        """This rank sits at the grid's first cell (the rank that
        evaluates, as the multi-process runner's rank 0 does)."""
        return all(c == 0 for c in self.coords.values())

    def axis_ranks(self, axes: Sequence[str]) -> list:
        """The global ranks of this rank's sub-grid along `axes` (the other
        axes fixed at this rank's coordinates), row-major: mesh-coordinate
        order."""
        axes = tuple(axes)
        idx = tuple(slice(None) if a in axes else self.coords[a]
                    for a in self.axis_names)
        return [int(r) for r in np.asarray(self.grid[idx]).reshape(-1)]

    def index(self, axes: Sequence[str]) -> int:
        """This rank's position along `axes` (row-major)."""
        return self.axis_ranks(axes).index(self.rank)

    def all_gather(self, array: np.ndarray,
                   axes: Optional[Sequence[str]] = None) -> list:
        """Every rank's `array` along `axes` (default: the whole mesh), in
        mesh-coordinate order, as host numpy arrays.  The arrays must have
        one shape and dtype on every rank.  One rank: [array], no
        collective."""
        ranks, group = self._axis_group(axes)
        if group is None:
            return [array]
        import torch.distributed as dist
        t = torch.from_numpy(np.require(array, requirements=("C", "W")))
        out = [torch.empty_like(t) for _ in ranks]
        dist.all_gather(out, t, group=group)
        # a group's ranks are numbered in ascending global rank; hand them
        # back in the mesh's coordinate order
        by_global = sorted(ranks)
        return [out[by_global.index(r)].numpy() for r in ranks]

    def _axis_group(self, axes: Optional[Sequence[str]]):
        """(ranks along `axes` (default: the whole mesh) in mesh order,
        their process group or None for one rank)."""
        axes = tuple(axes) if axes is not None else self.axis_names
        ranks = self.axis_ranks(axes)
        if len(ranks) == 1:
            return ranks, None
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self._groups:
            raise RuntimeError(
                f"mesh axes {key} span {len(ranks)} ranks but this mesh "
                f"has no process group for them (a Mesh.layout view, or a "
                f"mesh built before torch.distributed was initialized)")
        return ranks, self._groups[key]

    def broadcast_object(self, obj, axes: Optional[Sequence[str]] = None):
        """The first rank's picklable `obj` (along `axes`, default the
        whole mesh) on every rank of them; the others pass anything."""
        ranks, group = self._axis_group(axes)
        if group is None:
            return obj
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=ranks[0], group=group)
        return box[0]

    def broadcast(self, array: Optional[np.ndarray],
                  axes: Optional[Sequence[str]] = None) -> np.ndarray:
        """The first rank's host `array` (along `axes`) on every rank of
        them, bit for bit; the others pass None."""
        ranks, group = self._axis_group(axes)
        if group is None:
            return array
        import torch.distributed as dist
        first = self.rank == ranks[0]
        head = self.broadcast_object(
            (array.shape, array.dtype.str) if first else None, axes)
        t = (torch.from_numpy(np.require(array, requirements=("C", "W")))
             if first else torch.from_numpy(np.empty(head[0], head[1])))
        dist.broadcast(t, src=ranks[0], group=group)
        return t.numpy()

    def __repr__(self) -> str:
        return (f"Mesh(axes={self.axis_names}, shape={self.grid.shape}, "
                f"rank={self.rank}, coords={self.coords})")


def _axis_keys(axis_names: tuple) -> list:
    """Every axis alone, then the whole mesh: the groups a mesh needs."""
    keys = [(a,) for a in axis_names]
    if len(axis_names) > 1:
        keys.append(tuple(axis_names))
    return keys


def _build(axis_names: tuple, grid: np.ndarray) -> Optional[Mesh]:
    """The mesh over `grid` with its process groups.  Every rank of the
    world calls it with the same grid (group creation is collective over
    the world, in one order); groups of one rank are not created, and a
    mesh of one rank creates none.  A rank outside the grid (a mesh over
    a subset of the world, `devices`) joins the group creation and gets
    None."""
    n_world, rank = world()
    grid = np.asarray(grid, dtype=np.int64)
    if len(set(grid.reshape(-1).tolist())) != grid.size:
        raise ValueError(f"a mesh grid names a rank twice: {grid.tolist()}")
    if grid.size and (grid.min() < 0 or grid.max() >= n_world):
        raise ValueError(
            f"a mesh over ranks {grid.reshape(-1).tolist()} needs them in "
            f"torch.distributed's world; this world has {n_world} "
            f"process(es) (init_multihost joins it)")
    groups = {}
    if grid.size > 1:
        import torch.distributed as dist
        for key in _axis_keys(axis_names):
            moved = [axis_names.index(a) for a in key]
            rest = [i for i in range(grid.ndim) if i not in moved]
            g = np.transpose(grid, rest + moved)
            g = g.reshape(-1, int(np.prod([grid.shape[i] for i in moved])))
            for members in g:
                members = sorted(int(r) for r in members)
                if len(members) == 1:
                    continue
                if len(members) == n_world:
                    pg = dist.group.WORLD
                else:
                    pg = dist.new_group(members)
                if rank in members:
                    groups[key] = pg
    if rank not in grid:
        return None
    return Mesh(axis_names, grid, rank, groups)


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = CLIENT_AXIS,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """1-D mesh over `n_devices` ranks (default: every rank of the world;
    `devices` names the ranks, in mesh order)."""
    n_world, _ = world()
    devs = list(devices) if devices is not None else list(range(n_world))
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"make_mesh({n_devices}): the port's mesh is one process a "
                f"device, and {len(devs)} rank(s) are available (launch "
                f"{n_devices} ranks with spawn_cluster(jax_distributed=True)"
                f" and call init_multihost)")
        devs = devs[:n_devices]
    return _build((axis_name,), np.array(devs, dtype=np.int64))


def make_mesh_2d(n_silos: int, per_silo: Optional[int] = None,
                 devices: Optional[Sequence[int]] = None) -> Mesh:
    """2-D (silo x clients) mesh for hierarchical FL: rank s * per_silo + c
    of `devices` sits at (s, c)."""
    n_world, _ = world()
    devs = list(devices) if devices is not None else list(range(n_world))
    per_silo = per_silo if per_silo is not None else len(devs) // n_silos
    if n_silos < 1 or per_silo < 1 or n_silos * per_silo > len(devs):
        raise ValueError(
            f"make_mesh_2d({n_silos}, {per_silo}): {len(devs)} rank(s) "
            f"cannot form a {n_silos} x {per_silo} grid (one process a "
            f"device)")
    grid = np.array(devs[:n_silos * per_silo],
                    dtype=np.int64).reshape(n_silos, per_silo)
    return _build((SILO_AXIS, CLIENT_AXIS), grid)


def make_mesh_batch(n_client_shards: int, n_batch: int,
                    devices: Optional[Sequence[int]] = None) -> Mesh:
    """2-D (clients x batch) mesh: the cohort splits over the first axis
    and each client's per-step batch over the second (the layout for more
    ranks than clients); rank c * n_batch + b of `devices` sits at (c,
    b), and the "batch" group of a rank is its row."""
    n_world, _ = world()
    devs = list(devices) if devices is not None else list(range(n_world))
    if n_client_shards < 1 or n_batch < 1 \
            or n_client_shards * n_batch > len(devs):
        raise ValueError(
            f"make_mesh_batch({n_client_shards}, {n_batch}): {len(devs)} "
            f"rank(s) cannot form a {n_client_shards} x {n_batch} grid (one "
            f"process a device)")
    grid = np.array(devs[:n_client_shards * n_batch],
                    dtype=np.int64).reshape(n_client_shards, n_batch)
    return _build((CLIENT_AXIS, BATCH_AXIS), grid)


def client_axes(mesh: Mesh) -> tuple:
    """The mesh axes that shard the CLIENT dimension: every axis except
    "batch"."""
    return tuple(a for a in mesh.axis_names if a != BATCH_AXIS)


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """This rank's share of a leading axis split into `count` equal row
    ranges; `index` is its range (count 1: replicated)."""
    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"a leading axis of {n} rows does not split "
                             f"evenly over {self.count} shards (pad it: "
                             f"pad_cohort)")
        k = n // self.count
        return slice(self.index * k, (self.index + 1) * k)


def client_sharding(mesh: Mesh) -> RowSharding:
    """Shard a [K, ...] cohort or stack along its leading (client) axis over
    the client axes: on a silo x clients mesh clients split over both."""
    axes = client_axes(mesh)
    return RowSharding(mesh.index(axes),
                       int(np.prod([mesh.shape[a] for a in axes])))


@dataclasses.dataclass(frozen=True)
class StackSharding:
    """This rank's share of a stack leaf: the leading (client) axis by
    `clients`, and axis 2 (the per-step samples) by `batch` when the mesh
    splits it (None: whole)."""
    clients: RowSharding
    batch: Optional[RowSharding] = None

    def rows(self, n: int) -> slice:
        """This rank's range of the leading (client) axis."""
        return self.clients.rows(n)

    def take(self, a):
        a = a[self.clients.rows(len(a))]
        if self.batch is not None:
            a = a[:, :, self.batch.rows(a.shape[2])]
        return a


def batch_sharding(mesh: Mesh) -> Optional[RowSharding]:
    """This rank's share of a per-step batch over the "batch" axis (None
    without one)."""
    if BATCH_AXIS not in mesh.axis_names:
        return None
    return RowSharding(mesh.index((BATCH_AXIS,)), mesh.shape[BATCH_AXIS])


def _splits_batch(mesh: Mesh, leaf) -> bool:
    """Whether a stack leaf's per-step sample axis (axis 2) splits over
    the "batch" axis: it exists, the leaf has one, and the axis divides
    it (JAX replicates a leaf it does not divide; the engines refuse such
    a batch instead)."""
    return (BATCH_AXIS in mesh.axis_names and np.ndim(leaf) >= 3
            and np.shape(leaf)[2] % mesh.shape[BATCH_AXIS] == 0)


def stack_leaf_sharding(mesh: Mesh, leaf) -> StackSharding:
    """Per-leaf sharding of a client data stack {x, y, mask}[C, B, bs,
    ...]: the client dim over the client axes and, when the mesh has a
    "batch" axis, the per-step sample dim (axis 2) over it, so each rank
    uploads only its rows of every batch.  Weight [C] leaves split over
    the clients alone."""
    return StackSharding(client_sharding(mesh),
                         batch_sharding(mesh) if _splits_batch(mesh, leaf)
                         else None)


def stack_leaf_spec(mesh: Mesh, leaf) -> tuple:
    """The partition spec matching stack_leaf_sharding."""
    if _splits_batch(mesh, leaf):
        return (client_axes(mesh), None, BATCH_AXIS)
    return (client_axes(mesh),)


def replicated_sharding(mesh: Mesh) -> RowSharding:
    return RowSharding(0, 1)


def _share(mesh: Mesh, tree: dict, device) -> dict:
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(
        stack_leaf_sharding(mesh, v).take(np.asarray(v)))).to(dev)
        for k, v in tree.items()}


def shard_stack(mesh: Mesh, stack: dict, device=None) -> dict:
    """This rank's share of a client data stack (stack_leaf_sharding), on
    `device` (the card unless named)."""
    return _share(mesh, stack, device)


def shard_cohort(mesh: Mesh, cohort: dict, device=None) -> dict:
    """This rank's share of a host cohort {x, y, mask}[K, ...] (and
    weights [K]), leaf by leaf as stack_leaf_sharding splits it.  K must
    divide evenly: callers pad with zero-weight clients otherwise
    (pad_cohort)."""
    return _share(mesh, cohort, device)


def pad_cohort(cohort: dict, weights: np.ndarray, multiple: int):
    """Pad a cohort to a multiple of the mesh size with zero-weight dummy
    clients (zero rows: mask 0 makes their local training a no-op, and
    weight 0 drops them from the sums).  The engines pad ids another way
    (engine.py::pad_ids)."""
    K = int(weights.shape[0])
    pad = (-K) % multiple
    if pad == 0:
        return cohort, weights
    def pad_leaf(a):
        z = np.zeros((pad,) + tuple(a.shape[1:]), a.dtype)
        return np.concatenate([np.asarray(a), z], axis=0)
    cohort = {k: pad_leaf(v) for k, v in cohort.items()}
    weights = np.concatenate([np.asarray(weights),
                              np.zeros(pad, np.asarray(weights).dtype)])
    return cohort, weights
