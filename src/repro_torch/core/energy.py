"""EAFL energy-consumption models (paper Sec. 4.2), in PyTorch.

Computation: E_comp = P * t with Table 2's per-category run-time power.
Communication: Table 1's linear battery-% per hour of upload/download over
WiFi or 3G (Kalic et al., MIPRO'12). The constants are this package's own
copy of the reference tables.

Every function is float32 elementwise in the form the reference's compiled
code evaluates: XLA rewrites ``x / 3600`` as ``x * (1/3600)``, folds
``100 * (x * (1/3600))`` into one constant multiplier, and fuses
``a * hours + b`` into one multiply-add. Evaluating those forms keeps the
battery trajectories equal to the reference's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.numerics import constant, f32, fma

# ---- Table 2: device categories (0 high-end, 1 mid-range, 2 low-end) ------
CATEGORY_POWER_W = (6.33, 5.44, 2.98)
CATEGORY_PERF_PER_W = (5.94, 4.03, 3.55)
CATEGORY_BATTERY_MAH = (4000.0, 3450.0, 3000.0)
N_CATEGORIES = 3

NOMINAL_VOLTAGE = 3.85          # V, typical Li-ion nominal
HTC_DESIRE_HD_WH = 1.230 * 3.7  # the phone Table 1 was measured on

# ---- Table 1: comm battery-% per hour: y = a*x + b -------------------------
# rows: network (0 wifi, 1 3g); cols: direction (0 download, 1 upload)
COMM_A = ((18.09, 21.24), (20.59, 15.31))
COMM_B = ((0.17, -2.68), (-1.09, 2.67))

IDLE_POWER_W = 0.03             # screen-off baseline
BUSY_POWER_W = 1.50             # normal interactive usage
DEFAULT_BUSY_FRACTION = 0.15    # fraction of wall time a user keeps device busy


def _table(values, index: torch.Tensor) -> torch.Tensor:
    return constant(values, torch.float32, index.device)[index.long()]


def battery_wh(category: torch.Tensor) -> torch.Tensor:
    """Full-battery energy in Wh per client category."""
    return _table(CATEGORY_BATTERY_MAH, category) * NOMINAL_VOLTAGE / 1000.0


def pct_to_joules(category: torch.Tensor, pct: torch.Tensor) -> torch.Tensor:
    """Battery-% -> joules: 1% of a full battery is ``battery_wh * 36`` J."""
    return pct * battery_wh(category) * 36.0


def samples_per_sec(category: torch.Tensor) -> torch.Tensor:
    """Training throughput proxy: perf/W x avg power."""
    return _table(CATEGORY_PERF_PER_W, category) * \
        _table(CATEGORY_POWER_W, category)


def _pct_per_watt_second(like: torch.Tensor) -> torch.Tensor:
    """100 * (1 / 3600) as the reference's folded constant."""
    return f32(100.0, like) * f32(1.0 / 3600.0, like)


def comp_battery_pct(category: torch.Tensor, t_sec) -> torch.Tensor:
    """Battery % consumed by ``t_sec`` seconds of on-device training:
    ``100 * (P * t / 3600) / battery_wh``."""
    e = _table(CATEGORY_POWER_W, category) * t_sec
    return e * _pct_per_watt_second(e) / battery_wh(category)


def comm_battery_pct(network: torch.Tensor, t_down_sec, t_up_sec,
                     category=None, scale_to_capacity: bool = False):
    """Battery % consumed by communication (Table 1), clamped at >= 0.
    ``a * hours + b`` is one fused multiply-add, as in the reference."""
    a = constant(COMM_A, torch.float32, network.device)
    b = constant(COMM_B, torch.float32, network.device)
    net = network.long()
    hour = f32(1.0 / 3600.0, a)
    down = fma(a[net, 0], t_down_sec * hour, b[net, 0])
    up = fma(a[net, 1], t_up_sec * hour, b[net, 1])
    pct = torch.clamp_min(down, 0.0) + torch.clamp_min(up, 0.0)
    if scale_to_capacity and category is not None:
        pct = pct * (f32(HTC_DESIRE_HD_WH, pct) / battery_wh(category))
    return pct


def idle_battery_pct(category: torch.Tensor, t_sec,
                     busy_fraction: float = DEFAULT_BUSY_FRACTION):
    """Battery % drained by an *unselected* device over ``t_sec`` seconds:
    ``100 * (p * t / 3600) / battery_wh`` with the constants folded."""
    p = IDLE_POWER_W * (1.0 - busy_fraction) + BUSY_POWER_W * busy_fraction
    bwh = battery_wh(category)
    return t_sec * (f32(p, bwh) * _pct_per_watt_second(bwh)) / bwh


@dataclass(frozen=True)
class EnergyModel:
    """Bundles the paper's energy models with the knobs we expose."""

    busy_fraction: float = DEFAULT_BUSY_FRACTION
    scale_comm_to_capacity: bool = False

    def round_cost_pct(self, category, network, t_comp_sec, t_down_sec,
                       t_up_sec):
        """Battery % a *selected* client spends on one full round."""
        comp = comp_battery_pct(category, t_comp_sec)
        comm = comm_battery_pct(network, t_down_sec, t_up_sec,
                                category, self.scale_comm_to_capacity)
        return comp + comm

    def idle_cost_pct(self, category, t_sec):
        return idle_battery_pct(category, t_sec, self.busy_fraction)
