"""The ``clients`` mesh of the sharded engines, and its collectives.

The reference splits the population over a 1-D ``clients`` mesh of
devices and writes each shard-local body as a function of one shard's
slice that reduces across the mesh with ``psum``/``pmin``/``pmax``/
``all_gather`` over an axis name. Here a :class:`ClientMesh` is that axis.
A process holds ``local`` consecutive shards as a leading dimension:
every per-client tensor of a body is ``(local, n_loc, ...)``, and a
collective reduces (or concatenates) over that dimension in shard order,
then, when the mesh spans a ``torch.distributed`` process group, over the
group's ranks. Two meshes come out of this:

* the virtual mesh, ``D`` shards in one process on one device (the twin
  of the reference's forced host-device count): its collectives are
  ordinary tensor operations, so a round stays one CUDA-graph replay;
* the process-group mesh, one rank per card with one shard each
  (``local=1``): NCCL on cards, gloo on the CPU. A group's collectives
  always run through ``torch.distributed``, at world size 1 too. Gloo
  cannot be captured in a CUDA graph, so it is the CPU's route only.

Nothing here builds a mesh of more than one shard unless the caller asks
for one.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import tree_flatten, tree_unflatten


class ClientMesh:
    """``local`` shards in this process, times the ranks of ``group`` (a
    ``torch.distributed`` process group, or ``None`` for one process):
    ``size()`` shards in all, this process's first being ``first``."""

    def __init__(self, local: int = 1, group=None):
        if local < 1:
            raise ValueError(f"a mesh needs at least one local shard, got "
                             f"{local}")
        self.local = int(local)
        self.group = group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.world = 1 if group is None else dist.get_world_size(group)
        self.first = self.rank * self.local

    def size(self) -> int:
        return self.local * self.world

    def __repr__(self) -> str:
        return (f"ClientMesh(shards={self.size()}, local={self.local}, "
                f"world={self.world})")

    # ------------------------------------------------------------ layout
    def n_padded(self, n: int) -> int:
        """``n`` rounded up to a multiple of the shard count."""
        return n + (-n) % self.size()

    def bases(self, n_loc: int, device) -> torch.Tensor:
        """(local,) int64: the global index of each local shard's first
        client."""
        return (self.first + torch.arange(self.local, device=device)) * n_loc

    def put(self, tree: Any) -> Any:
        """Each leaf of ``tree``, padded already to ``(n_padded, ...)``, as
        this process's block ``(local, n_loc, ...)`` (a copy)."""
        leaves, treedef = tree_flatten(tree)
        out = []
        for x in leaves:
            blocks = x.reshape(self.size(), -1, *x.shape[1:])
            out.append(blocks[self.first:self.first + self.local].clone())
        return tree_unflatten(treedef, out)

    def gather(self, tree: Any, n: Optional[int] = None) -> Any:
        """The inverse of :meth:`put`: each ``(local, n_loc, ...)`` leaf as
        the whole ``(n_padded, ...)`` array on every process, cut to the
        first ``n`` clients when ``n`` is given (a sharded population
        trimmed to its real clients: the pad clients never leave their
        initial state)."""
        leaves, treedef = tree_flatten(tree)
        out = []
        for x in leaves:
            full = self.all_gather(x)
            full = full.reshape(-1, *full.shape[2:])
            out.append(full if n is None else full[:n])
        return tree_unflatten(treedef, out)

    def draw(self, sample, n_loc: int) -> torch.Tensor:
        """This process's ``(local, n_loc)`` slice of a prefix-stable
        population-wide stream: ``sample(count, offset)`` draws positions
        ``[offset, offset + count)`` (``prng.bits`` and friends)."""
        return sample(self.local * n_loc,
                      self.first * n_loc).reshape(self.local, n_loc)

    # ------------------------------------------------------- collectives
    # Each takes per-shard values stacked on a leading (local,) dimension
    # and returns the one replicated result.
    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return x
        y = x.clone()
        dist.all_reduce(y, op=op, group=self.group)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x.sum(0), dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x.amin(0), dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x.amax(0), dist.ReduceOp.MAX)

    def pany(self, x: torch.Tensor) -> torch.Tensor:
        return self.pmax(x.to(torch.int32)) > 0

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(local, ...)`` -> ``(size(), ...)``, in shard order."""
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


# Reductions over all clients, one body for both layouts: the whole (N,)
# tensor on one device (``axis=None``), or, with a mesh as ``axis``, each
# shard's row of an ``(S, n_loc)`` block and then the mesh. max and
# integer sums are exact in any order; float sums may differ in the last
# bit.

def asum(x: torch.Tensor, axis: Optional[ClientMesh] = None) -> torch.Tensor:
    return x.sum(-1) if axis is None else axis.psum(x.sum(-1))


def amax(x: torch.Tensor, axis: Optional[ClientMesh] = None) -> torch.Tensor:
    return x.amax(-1) if axis is None else axis.pmax(x.amax(-1))


def amin(x: torch.Tensor, axis: Optional[ClientMesh] = None) -> torch.Tensor:
    return x.amin(-1) if axis is None else axis.pmin(x.amin(-1))


def aany(x: torch.Tensor, axis: Optional[ClientMesh] = None) -> torch.Tensor:
    return x.any(-1) if axis is None else axis.pany(x.any(-1))


def population_draw(sample, n_loc: int,
                    axis: Optional[ClientMesh] = None) -> torch.Tensor:
    """A prefix-stable population-wide stream in the layout of ``axis``:
    ``sample(n_loc, 0)`` on one device, this process's ``(S, n_loc)``
    slice on a mesh (:meth:`ClientMesh.draw`)."""
    return sample(n_loc, 0) if axis is None else axis.draw(sample, n_loc)


def make_client_mesh(n_devices: Optional[int] = None) -> ClientMesh:
    """A 1-D ``clients`` mesh of ``n_devices`` shards.

    Without an initialised ``torch.distributed`` group every shard is
    virtual, in this process, and the default is one shard. Inside one,
    the mesh spans the default group's ranks, ``n_devices // world``
    shards a rank (default one: one card a rank). An NCCL group runs one
    warm-up collective here, on the current stream, so that a CUDA graph
    may capture the engines' collectives later."""
    if not (dist.is_available() and dist.is_initialized()):
        return ClientMesh(1 if n_devices is None else int(n_devices))
    group = dist.group.WORLD
    world = dist.get_world_size(group)
    n = world if n_devices is None else int(n_devices)
    if n % world:
        raise ValueError(f"a mesh of {n} shards over {world} ranks: the "
                         f"shard count must be a multiple of the world size")
    mesh = ClientMesh(n // world, group)
    if dist.get_backend(group) == "nccl":
        warm = torch.zeros(1, device=torch.device(
            "cuda", torch.cuda.current_device()))
        dist.all_reduce(warm, group=group)
        torch.cuda.synchronize()
    return mesh
