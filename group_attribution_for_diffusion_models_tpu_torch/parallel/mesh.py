"""Ranks as a device mesh, on torch.distributed.

Port of the JAX package's ``parallel/mesh.py``. There a `jax.sharding.Mesh`
lays devices out on named axes and XLA inserts the collectives; here one rank
is one process that owns one device, and the mesh says which part of the
work each rank owns. The axes are ("ensemble", "data") as in JAX: the
ensemble axis splits whole members (no communication between them), the data
axis splits each member's batch and means its gradients over the ranks of a
data row. Rank r sits at the row-major coordinates of r in the mesh's shape,
the order ``np.reshape`` gives the JAX device list (rank = e * data + d).

`make_mesh` keeps the JAX function's clamp and its two warnings. The
counterparts of the JAX helpers are `member_range` (``ensemble_sharding``:
the global member ids a rank owns), `shard_ensemble` (the rank's slice of a
stacked state), `replicate` (a broadcast from a group's first rank) and
`gather_members` (``multihost_utils.process_allgather``: the members' tensors
on rank 0 in member order). Every rank must build every mesh, in the same
order: `make_mesh` creates the process groups of its data rows with
``dist.new_group``, which every rank of the world calls for every group.

Collectives run on whatever device the tensors are on, with the process
group's backend for that device (`multihost.initialize`: NCCL for CUDA
tensors with gloo for host tensors, or gloo for both); `gather_members`
gathers host copies, because its product goes to files.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..training.state import EnsembleState

AXES = ("ensemble", "data")


def group_ready() -> bool:
    """True when a default process group exists in this process."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(size, rank) of the default process group; (1, 0) without one."""
    return (dist.get_world_size(), dist.get_rank()) if group_ready() else (1, 0)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A layout of the world's first `size` ranks on named axes.

    `coords` are this rank's coordinates, None for a rank the mesh leaves
    out (it owns no work). `group` is the process group of the mesh's ranks
    and `row_group` that of this rank's data row (the ranks that differ only
    in their "data" coordinate); each is None where it would hold one rank or
    where no process group exists."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int = 0
    coords: Optional[Tuple[int, ...]] = None
    group: Any = None
    row_group: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def in_mesh(self) -> bool:
        return self.coords is not None

    def axis_size(self, name: str) -> int:
        """The axis' size; 1 for an axis the mesh does not have."""
        return self.shape[self.axis_names.index(name)] if name in self.axis_names else 1

    def coord(self, name: str) -> int:
        """This rank's coordinate on the axis; 0 for an axis the mesh does not have."""
        if not self.in_mesh:
            raise ValueError(f"rank {self.rank} is outside the mesh {self.shape}")
        return self.coords[self.axis_names.index(name)] if name in self.axis_names else 0

    def pmean_data(self, tensors: Sequence[torch.Tensor]) -> None:
        """Mean `tensors` over this rank's data row, in place (the JAX
        ``lax.pmean`` over "data"); nothing where the row is one rank."""
        if self.row_group is not None:
            all_mean_(tensors, self.row_group, self.axis_size("data"))


def _coords_of(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    coords = []
    for n in reversed(shape):
        coords.append(rank % n)
        rank //= n
    return tuple(reversed(coords))


def make_mesh(
    mesh_shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = AXES,
    world_size: Optional[int] = None,
) -> Mesh:
    """A mesh over the world's ranks (`world_size` of them, by default the
    process group's size, 1 without one).

    Default: every rank on the ensemble axis, the other axes 1. A shape that
    needs more ranks than there are is shrunk, leading axes first, with a
    warning; one that needs fewer warns too, and the ranks past it own no
    work (the JAX function's rules and messages, a rank for a device)."""
    n, rank = world()
    n = world_size if world_size is not None else n
    if mesh_shape is None:
        mesh_shape = (n,) + (1,) * (len(axis_names) - 1)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    want = math.prod(mesh_shape)
    if want > n:
        shrunk = list(mesh_shape)
        while math.prod(shrunk) > n:
            for i in range(len(shrunk)):
                if shrunk[i] > 1:
                    shrunk[i] -= 1
                    break
        warnings.warn(
            f"make_mesh: requested shape {mesh_shape} needs {want} devices "
            f"but only {n} are visible; clamping to {tuple(shrunk)}",
            stacklevel=2,
        )
        mesh_shape = tuple(shrunk)
        want = math.prod(mesh_shape)
    elif want < n:
        warnings.warn(
            f"make_mesh: shape {mesh_shape} uses {want} of {n} visible devices",
            stacklevel=2,
        )
    coords = _coords_of(rank, mesh_shape) if rank < want else None
    mesh = Mesh(tuple(mesh_shape), tuple(axis_names), rank, coords)
    if not group_ready() or want == 1:
        return mesh
    # Every rank of the world creates every group, in this order.
    group = dist.new_group(list(range(want)))
    row_group = None
    if "data" in axis_names and mesh.axis_size("data") > 1:
        d = axis_names.index("data")
        rows: Dict[Tuple[int, ...], List[int]] = {}
        for r in range(want):
            c = _coords_of(r, mesh_shape)
            rows.setdefault(c[:d] + c[d + 1:], []).append(r)
        for key in sorted(rows):
            g = dist.new_group(rows[key])
            if coords is not None and rank in rows[key]:
                row_group = g
    return dataclasses.replace(mesh, group=group if coords is not None else None,
                               row_group=row_group)


def member_range(mesh: Optional[Mesh], num_members: int) -> range:
    """The global ids of the members this rank owns: all of them without a
    mesh, none outside it, else its ensemble coordinate's block of
    num_members / ensemble (which must divide)."""
    if mesh is None:
        return range(num_members)
    if not mesh.in_mesh:
        return range(0)
    e_size = mesh.axis_size("ensemble")
    if num_members % e_size:
        raise ValueError(f"{num_members} members do not divide the ensemble axis {e_size}")
    local = num_members // e_size
    e = mesh.coord("ensemble")
    return range(e * local, (e + 1) * local)


def _slice_tree(tree, members: range):
    if isinstance(tree, torch.Tensor):
        return tree[members.start:members.stop].clone()
    if isinstance(tree, dict):
        return {k: _slice_tree(v, members) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice_tree(v, members) for v in tree)
    raise TypeError(f"cannot shard a {type(tree).__name__}")


def shard_ensemble(stacked, mesh: Optional[Mesh], num_members: Optional[int] = None):
    """This rank's slice of a stacked state (copies): an `EnsembleState`, or
    a tree (dicts, lists) of tensors with a leading member axis of
    `num_members` (default: that of the tree's first tensor)."""
    if isinstance(stacked, EnsembleState):
        members = member_range(mesh, num_members or stacked.num_members)
        opt = stacked.opt_state
        slots = {name: _slice_tree(xs, members) for name, xs in opt.slots().items()}
        params = {n: p.detach()[members.start:members.stop].clone().requires_grad_(True)
                  for n, p in stacked.params.items()}
        return EnsembleState(
            model=stacked.model, params=params,
            buffers=_slice_tree(stacked.buffers, members), ema=_slice_tree(stacked.ema, members),
            opt_state=type(opt)(count=opt.count, **slots), step=stacked.step)
    if num_members is None:
        num_members = _first_tensor(stacked).shape[0]
    return _slice_tree(stacked, member_range(mesh, num_members))


def _first_tensor(tree) -> torch.Tensor:
    if isinstance(tree, torch.Tensor):
        return tree
    for v in (tree.values() if isinstance(tree, dict) else tree):
        return _first_tensor(v)
    raise ValueError("an empty tree has no member axis")


@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor], group: Any) -> None:
    """Make every rank of `group` (a mesh's group, or a data row's) hold its
    first rank's `tensors`, in place: a broadcast from that rank."""
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


@torch.no_grad()
def all_mean_(tensors: Sequence[torch.Tensor], group: Any, size: int) -> None:
    """Mean `tensors` over the ranks of `group` (`size` of them), in place:
    one all-reduce of a flat buffer per dtype, then a division by `size`.
    Every rank ends with the same bits."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(size)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _to_bytes(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
                      for t in tensors])


def _from_bytes(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, offset = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[offset:offset + n].view(t.dtype).reshape(t.shape))
        offset += n
    return out


@torch.no_grad()
def gather_members(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor]) -> Optional[List[torch.Tensor]]:
    """The members' `tensors` (each (L, ...) on this rank, L its members) as
    (M, ...) host tensors in global member order, on rank 0; None on the
    other ranks. The ranks of a data row hold one copy of their members:
    the first rank of each row gives it. Without a mesh group the tensors
    themselves come back, on the host."""
    if mesh is None or mesh.group is None:
        return [t.detach().cpu() for t in tensors]
    buf = _to_bytes(tensors)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)] if mesh.rank == 0 else None
    dist.gather(buf, parts, dst=0, group=mesh.group)
    if mesh.rank != 0:
        return None
    # Each data row's first rank (data coordinate 0), in rank order.
    d = mesh.axis_names.index("data") if "data" in mesh.axis_names else None
    pieces = [_from_bytes(parts[r], tensors) for r in range(mesh.size)
              if d is None or _coords_of(r, mesh.shape)[d] == 0]
    return [torch.cat(xs) for xs in zip(*pieces)]
