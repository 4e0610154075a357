"""Client population state: struct-of-arrays over N clients, in PyTorch.

Each client maps to one of the three Table-2 device categories and to a
network medium (WiFi / 3G) with MobiPerf-style heavy-tailed bandwidths.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Dict

import torch

from repro_torch import prng
from repro_torch.core import energy
from repro_torch.numerics import f32

_FIELDS = ("category", "network", "down_mbps", "up_mbps", "battery_pct",
           "stat_util", "last_duration", "explored", "last_round",
           "times_selected", "dropped", "n_samples")


@dataclass
class ClientPopulation:
    """All per-client scalars, shape (N,), on one device."""

    category: torch.Tensor        # int32 in {0,1,2}
    network: torch.Tensor         # int32 in {0 wifi, 1 3g}
    down_mbps: torch.Tensor       # f32
    up_mbps: torch.Tensor         # f32
    battery_pct: torch.Tensor     # f32 in [0,100]
    stat_util: torch.Tensor       # f32 Oort statistical utility
    last_duration: torch.Tensor   # f32 seconds (last observed round time)
    explored: torch.Tensor        # bool, participated at least once
    last_round: torch.Tensor      # int32, round of last participation
    times_selected: torch.Tensor  # int32
    dropped: torch.Tensor         # bool, battery ran out (unavailable)
    n_samples: torch.Tensor       # int32 local dataset size

    @property
    def n(self) -> int:
        return int(self.category.shape[0])

    @property
    def device(self) -> torch.device:
        return self.category.device

    @property
    def alive(self) -> torch.Tensor:
        return (~self.dropped) & (self.battery_pct > 0.0)

    def replace(self, **kw) -> "ClientPopulation":
        return replace(self, **kw)

    def to(self, device) -> "ClientPopulation":
        return ClientPopulation(**{f.name: getattr(self, f.name).to(device)
                                   for f in fields(self)})


def make_population(key: torch.Tensor, n_clients: int,
                    category_probs=(0.25, 0.45, 0.30),
                    wifi_prob: float = 0.6,
                    init_battery_low: float = 60.0,
                    init_battery_high: float = 100.0,
                    samples_per_client: int = 128) -> ClientPopulation:
    """AI-Benchmark/MobiPerf-style heterogeneous population on ``key``'s
    device. Categories, networks and batteries equal the reference's draws
    bit for bit; the log-normal bandwidths go through ``normal``."""
    ks = prng.split(key, 6)
    category = prng.choice_p(ks[0], 3, (n_clients,),
                             category_probs).to(torch.int32)
    network = (prng.uniform(ks[1], (n_clients,)) > wifi_prob).to(torch.int32)
    wifi = network == 0
    base_down = torch.where(wifi, 40.0, 6.0)
    base_up = torch.where(wifi, 15.0, 2.0)
    ln_d = torch.exp(0.6 * prng.normal(ks[2], (n_clients,)))
    ln_u = torch.exp(0.6 * prng.normal(ks[3], (n_clients,)))
    battery = prng.uniform(ks[4], (n_clients,), init_battery_low,
                           init_battery_high)
    dev = key.device
    return ClientPopulation(
        category=category,
        network=network,
        down_mbps=base_down * ln_d,
        up_mbps=base_up * ln_u,
        battery_pct=battery,
        stat_util=torch.zeros(n_clients, dtype=torch.float32, device=dev),
        last_duration=torch.ones(n_clients, dtype=torch.float32, device=dev),
        explored=torch.zeros(n_clients, dtype=torch.bool, device=dev),
        last_round=torch.zeros(n_clients, dtype=torch.int32, device=dev),
        times_selected=torch.zeros(n_clients, dtype=torch.int32, device=dev),
        dropped=torch.zeros(n_clients, dtype=torch.bool, device=dev),
        n_samples=torch.full((n_clients,), samples_per_client,
                             dtype=torch.int32, device=dev),
    )


def scatter_stat_util(pop: ClientPopulation, idx: torch.Tensor,
                      mask: torch.Tensor,
                      stat_util: torch.Tensor) -> ClientPopulation:
    """Slot ``i`` writes ``stat_util[i]`` to client ``idx[i]`` iff
    ``mask[i]``; masked slots write to an extra entry N that is cut off
    (no host read, as the fused engines need)."""
    n = pop.n
    su = torch.cat([pop.stat_util, pop.stat_util.new_zeros(1)])
    target = torch.where(mask, idx.long(), torch.full_like(idx.long(), n))
    su = su.scatter(0, target, stat_util.to(su.dtype))
    return pop.replace(stat_util=su[:n])


def round_times(pop: ClientPopulation, model_bytes: float,
                local_steps: int, batch_size: int,
                up_bytes: float = None) -> Dict[str, torch.Tensor]:
    """Per-client download / compute / upload seconds for one round."""
    if up_bytes is None:
        up_bytes = model_bytes
    like = pop.down_mbps
    t_down = f32(model_bytes * 8, like) / (pop.down_mbps * 1e6)
    t_up = f32(up_bytes * 8, like) / (pop.up_mbps * 1e6)
    sps = energy.samples_per_sec(pop.category)
    t_comp = f32(local_steps * batch_size, like) / sps
    return {"down": t_down, "comp": t_comp, "up": t_up,
            "total": t_down + t_comp + t_up}


__all__ = ["ClientPopulation", "make_population", "scatter_stat_util",
           "round_times"]
