"""Placement of per-client state over the ``clients`` mesh
(``launch/mesh.py``): the population and its data. ``ClientMesh.gather``
brings a block back whole."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.clients import ClientPopulation, pad_population
from repro_torch.launch.mesh import ClientMesh


def population_sharding(mesh: ClientMesh,
                        ) -> Callable[[ClientPopulation], ClientPopulation]:
    """The layout of a ``ClientPopulation`` over ``mesh``: a function that
    pads a population to a multiple of the shard count with inert clients
    (``pad_population``) and returns this process's block, every leaf
    ``(local, n_loc)``."""
    return lambda pop: mesh.put(pad_population(pop, mesh.size()))


def shard_clients(x: torch.Tensor, mesh: ClientMesh) -> torch.Tensor:
    """A per-client ``(N, ...)`` array (say the clients' training data),
    zero-padded to a multiple of the shard count, as this process's
    ``(local, n_loc, ...)`` block."""
    pad = mesh.n_padded(x.shape[0]) - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    return mesh.put(x)
