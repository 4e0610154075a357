"""Client selectors: EAFL (the paper), Oort, Random and eafl-epj, in PyTorch.

EAFL and Oort share Oort's exploration/exploitation skeleton (EAFL changes
only the reward, Eq. 1):

  - an epsilon fraction of the K slots explores unexplored clients,
    epsilon decaying per round;
  - the rest exploits: top-reward explored clients, with a UCB-style
    staleness bonus so long-unselected clients get re-examined;
  - a pacer keeps the preferred round duration T of Eq. 2's penalty.

:func:`_device_select` is the fixed-shape selection step, index for index
the reference's ``select_device``. Exploration ranks the reference's
threefry rank bits (``repro_torch.prng``). Exploitation has two paths,
each held against its own reference twin:

  - ``use_kernel=True`` normalises the inputs and calls
    ``kernels.ops.topk_reward`` (the Hopper kernel on CUDA, its plain
    version on the CPU), like the reference's ``use_pallas=True``;
  - ``use_kernel=False`` ranks the affine-folded score of
    :func:`_mix_scores` with a stable sort (CPU only), like
    ``use_pallas=False``.

Every top-k here has a defined tie order, lowest index first, as
``lax.top_k`` has. A CUDA population always takes the kernel.

:func:`select_host` is the reference's eager numpy oracle, on the port's
own draws and scores (:func:`compute_scores`, the plain route's).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import rewards
from repro_torch.core.clients import ClientPopulation
from repro_torch.kernels import ops
from repro_torch.numerics import f32, fma, orderable_key


@dataclass(frozen=True)
class SelectorConfig:
    kind: str                     # eafl | oort | random | eafl-epj
    k: int = 10
    f: float = 0.25               # Eq. 1 mixing weight (paper uses 0.25)
    alpha: float = 2.0            # Eq. 2 straggler penalty exponent
    epsilon0: float = 0.9
    epsilon_decay: float = 0.98
    epsilon_min: float = 0.2
    ucb_c: float = 0.1
    pacer_t0: float = 120.0       # initial preferred round duration (s)
    pacer_delta: float = 30.0
    pacer_max: float = 1800.0
    normalize_reward: bool = True


@dataclass
class SelectorState:
    """Selector carry: Python scalars at creation, 0-d tensors (int32
    round, float32 rest) on the population's device after a step."""

    round: int = 0
    epsilon: float = 0.9
    pacer_T: float = 120.0
    util_ema: float = 0.0

    @classmethod
    def create(cls, cfg: SelectorConfig) -> "SelectorState":
        return cls(round=0, epsilon=cfg.epsilon0, pacer_T=cfg.pacer_t0)

    def canonical(self, device) -> "SelectorState":
        """Strongly typed 0-d tensors on ``device``."""
        f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        return SelectorState(
            round=torch.as_tensor(self.round, dtype=torch.int32,
                                  device=device),
            epsilon=f(self.epsilon), pacer_T=f(self.pacer_T),
            util_ema=f(self.util_ema))


def _rank_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """Random ranking keys: the top 23 of the reference's 32 threefry bits,
    as exact float32 integers (their order is the Gumbel-top-k order of
    ``jax.random.choice(replace=False)`` from the same key)."""
    return (prng.bits(key, (n,)) >> 9).to(torch.float32)


def _top_k_idx(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest float32 entries in ``lax.top_k``'s
    total order (+0 above -0, +NaN first, -NaN last), ties lowest index
    first."""
    return torch.sort(orderable_key(x), descending=True,
                      stable=True).indices[:k]


def ucb_bonus(staleness: torch.Tensor, t, c: float) -> torch.Tensor:
    """The exploration bonus ``c * sqrt(log(t + 1) / max(staleness, 1))``."""
    t_f = torch.as_tensor(t, dtype=torch.float32, device=staleness.device)
    return c * torch.sqrt(torch.log(t_f + 1.0)
                          / torch.clamp_min(staleness, 1))


def _ucb_bonus(cfg: SelectorConfig, pop: ClientPopulation, rnd):
    return ucb_bonus(rnd - pop.last_round, rnd, cfg.ucb_c)


def _score_inputs(cfg: SelectorConfig, state: SelectorState,
                  pop: ClientPopulation, predicted_cost_pct):
    """Raw score inputs ``(a, b, valid, mask, ucb, mode)``: ``valid`` is
    Eq. 1's normalisation set, ``mask`` the selectable set, and the score
    is ``where(mask, mix(a, b) * (1 + ucb), -inf)``."""
    util = rewards.oort_utility(pop.stat_util, pop.last_duration,
                                state.pacer_T, cfg.alpha)
    valid = pop.alive
    ucb = _ucb_bonus(cfg, pop, state.round)
    if cfg.kind == "oort":
        return util, torch.zeros_like(util), valid, valid, ucb, "oort"
    if cfg.kind == "eafl":
        power = rewards.projected_power(pop.battery_pct, predicted_cost_pct)
        return util, power, valid, valid, ucb, "eafl"
    if cfg.kind == "eafl-epj":
        # utility per unit energy, gated on surviving the round
        survives = pop.battery_pct > predicted_cost_pct
        return util, predicted_cost_pct, valid, valid & survives, ucb, \
            "eafl-epj"
    raise ValueError(cfg.kind)


def _mix_scores(cfg: SelectorConfig, a, b, valid, mask, ucb,
                mode: str) -> torch.Tensor:
    """The reference's ``use_pallas=False`` score, operation for
    operation: ``eafl`` folds min-max normalisation into the affine
    ``ca*a + cb*b + c0`` (the first product and the add fused)."""
    f = cfg.f
    if mode == "oort":
        s = a
    elif mode == "eafl":
        if cfg.normalize_reward:
            lo_a, ra = rewards.minmax_range(a, valid)
            lo_b, rb = rewards.minmax_range(b, valid)
            ca, cb = f32(f, a) / ra, f32(1.0 - f, b) / rb
            c0 = -fma(ca, lo_a, cb * lo_b)
            s = fma(ca, a, cb * b) + c0
        else:
            s = rewards.mix(f, a, b)
    elif mode == "eafl-epj":
        s = a / torch.maximum(b, f32(1e-3, b))
    else:
        raise ValueError(mode)
    return torch.where(mask, s * (1.0 + ucb), f32(float("-inf"), s))


def compute_scores(cfg: SelectorConfig, state: SelectorState,
                   pop: ClientPopulation,
                   predicted_cost_pct: torch.Tensor) -> torch.Tensor:
    """Per-client selection score for the exploitation slots."""
    state = state.canonical(pop.device)
    a, b, valid, mask, ucb, mode = _score_inputs(cfg, state, pop,
                                                 predicted_cost_pct)
    return _mix_scores(cfg, a, b, valid, mask, ucb, mode)


def _device_select(key: torch.Tensor, cfg: SelectorConfig,
                   state: SelectorState, pop: ClientPopulation,
                   predicted_cost_pct: torch.Tensor, use_kernel: bool):
    """Fixed-shape selection step: ``(idx (k,) int64, chosen (k,) bool,
    new_state)``; only the ``chosen`` slots are picks (exploit slots
    first, then exploration)."""
    if not use_kernel and pop.device.type == "cuda":
        raise ValueError("on CUDA the exploit top-k runs the topk_reward "
                         "kernel: use_kernel must be True")
    dev = pop.device
    n = pop.n
    k = min(cfg.k, n)
    st = state.canonical(dev)
    st = SelectorState(st.round + 1, st.epsilon, st.pacer_T, st.util_ema)
    valid = pop.alive
    k_eff = torch.clamp_max(valid.sum(), k).to(torch.int32)
    slots = torch.arange(k, device=dev)
    minus_one = f32(-1.0, st.epsilon)

    if cfg.kind == "random":
        g = torch.where(valid, _rank_bits(key, n), minus_one)
        return _top_k_idx(g, k), slots < k_eff, st

    explored = pop.explored & valid
    unexplored = valid & ~explored
    a, b, norm_valid, mask, ucb, mode = _score_inputs(cfg, st, pop,
                                                      predicted_cost_pct)
    mask = mask & explored

    n_unexp = unexplored.sum().to(torch.int32)
    # exploit slots are capped by the selectable explored pool
    n_expl_avail = mask.sum().to(torch.int32)
    n_explore = torch.minimum(
        torch.round(st.epsilon * k_eff).to(torch.int32), n_unexp)
    n_exploit = torch.minimum(k_eff - n_explore, n_expl_avail)
    n_explore = torch.minimum(k_eff - n_exploit, n_unexp)
    if use_kernel:
        if mode == "eafl" and cfg.normalize_reward:
            a = rewards.minmax_normalize(a, norm_valid)
            b = rewards.minmax_normalize(b, norm_valid)
        _, exploit_idx = ops.topk_reward(a, b, mask, ucb=ucb, f=cfg.f, k=k,
                                         mode=mode)
        exploit_idx = exploit_idx.long()
    else:
        score = _mix_scores(cfg, a, b, norm_valid, mask, ucb, mode)
        exploit_idx = _top_k_idx(score, k)

    g = torch.where(unexplored, _rank_bits(key, n), minus_one)
    explore_idx = _top_k_idx(g, k)

    take_exploit = slots < n_exploit
    idx = torch.where(take_exploit, exploit_idx,
                      explore_idx[torch.clamp(slots - n_exploit, 0, k - 1)])
    chosen = slots < (n_exploit + n_explore)

    # epsilon decay + pacer update on the selected utility mass, skipped
    # when no client is selectable (k_eff == 0)
    any_pick = k_eff > 0
    n_chosen = chosen.sum()
    zero = torch.zeros_like(st.util_ema)
    sel_util = torch.where(chosen, pop.stat_util[idx], zero).sum() \
        / torch.clamp_min(n_chosen, 1)
    epsilon = torch.where(
        any_pick,
        torch.clamp_min(st.epsilon * cfg.epsilon_decay, cfg.epsilon_min),
        st.epsilon)
    slow = (st.util_ema > 0.0) & (sel_util < 0.95 * st.util_ema)
    pacer = torch.where(
        any_pick & slow,
        torch.clamp_max(st.pacer_T + cfg.pacer_delta, cfg.pacer_max),
        st.pacer_T)
    ema = torch.where(any_pick, fma(0.9, st.util_ema, 0.1 * sel_util),
                      st.util_ema)
    return idx, chosen, SelectorState(st.round, epsilon, pacer, ema)


def select(key: torch.Tensor, cfg: SelectorConfig, state: SelectorState,
           pop: ClientPopulation,
           predicted_cost_pct: Optional[torch.Tensor] = None,
           use_kernel: Optional[bool] = None,
           ) -> Tuple[np.ndarray, SelectorState]:
    """Pick K clients: ``(indices (<=K,) int64 numpy, new_state)``.

    Host facade over :func:`_device_select`; ``use_kernel=None`` takes the
    kernel route on CUDA and the affine-folded plain route on the CPU (the
    reference's own pick there)."""
    if predicted_cost_pct is None:
        predicted_cost_pct = torch.zeros(pop.n, dtype=torch.float32,
                                         device=pop.device)
    if use_kernel is None:
        use_kernel = pop.device.type == "cuda"
    idx, chosen, new_state = _device_select(key, cfg, state, pop,
                                            predicted_cost_pct, use_kernel)
    return idx[chosen].cpu().numpy().astype(np.int64), new_state


def select_host(key: torch.Tensor, cfg: SelectorConfig, state: SelectorState,
                pop: ClientPopulation,
                predicted_cost_pct: Optional[torch.Tensor] = None,
                ) -> Tuple[np.ndarray, SelectorState]:
    """The reference's eager host selection (numpy argsort), the parity
    oracle of :func:`select`: ``(indices (<=K,) int64, new_state)`` with
    a state of Python numbers. The draws are the port's threefry on
    ``pop``'s device: ``random`` is ``jax.random.choice(replace=False,
    p=alive / n_alive)``'s Gumbel top-k, the explore leg ranks
    ``jax.random.gumbel``; the exploit leg ranks :func:`compute_scores`
    with a stable sort."""
    valid = pop.alive.cpu().numpy()
    n_valid = int(valid.sum())
    k = min(cfg.k, n_valid)
    state = SelectorState(state.round + 1, state.epsilon, state.pacer_T,
                          state.util_ema)
    if k == 0:
        return np.zeros((0,), np.int64), state

    if cfg.kind == "random":
        p = torch.from_numpy(valid / valid.sum()).to(torch.float32)
        idx = prng.choice_without_replacement(key, pop.n, k,
                                              p.to(pop.device))
        return idx.cpu().numpy().astype(np.int64), state

    if predicted_cost_pct is None:
        predicted_cost_pct = torch.zeros(pop.n, dtype=torch.float32,
                                         device=pop.device)

    explored = pop.explored.cpu().numpy() & valid
    unexplored = valid & ~explored
    score = compute_scores(cfg, state, pop,
                           predicted_cost_pct).cpu().numpy().copy()
    score[~explored] = -np.inf
    n_explore = min(int(round(float(state.epsilon) * k)),
                    int(unexplored.sum()))
    # exploit slots are capped by the selectable explored pool (a finite
    # score: for eafl-epj this excludes clients that would die mid-round)
    n_exploit = min(k - n_explore, int((score > -np.inf).sum()))
    n_explore = k - n_exploit     # leftovers go back to exploration
    n_explore = min(n_explore, int(unexplored.sum()))

    picks = []
    if n_exploit > 0:
        picks.append(np.argsort(-score, kind="stable")[:n_exploit])
    if n_explore > 0:
        g = prng.gumbel(key, (pop.n,)).cpu().numpy().copy()
        g[~unexplored] = -np.inf
        picks.append(np.argsort(-g, kind="stable")[:n_explore])
    idx = np.concatenate(picks) if picks else np.zeros((0,), np.int64)

    # epsilon decay + pacer update on the picked utility mass
    epsilon = max(cfg.epsilon_min, float(state.epsilon) * cfg.epsilon_decay)
    pacer_T = float(state.pacer_T)
    util_ema = float(state.util_ema)
    stat_util = pop.stat_util.cpu().numpy()
    sel_util = float(stat_util[idx].mean()) if len(idx) else 0.0
    if util_ema > 0.0 and sel_util < 0.95 * util_ema:
        pacer_T = min(cfg.pacer_max, pacer_T + cfg.pacer_delta)
    util_ema = 0.9 * util_ema + 0.1 * sel_util
    return idx.astype(np.int64), SelectorState(state.round, epsilon, pacer_T,
                                               util_ema)
