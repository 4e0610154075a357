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

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import rewards
from repro_torch.core.clients import ClientPopulation
from repro_torch.kernels import ops
from repro_torch.launch.mesh import asum, population_draw
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


def _rank_bits(key: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """Random ranking keys: the top 23 of the reference's 32 threefry bits,
    as exact float32 integers (their order is the Gumbel-top-k order of
    ``jax.random.choice(replace=False)`` from the same key). Prefix-stable:
    ``offset`` draws positions ``[offset, offset + n)`` of the stream."""
    return (prng.bits(key, (n,), offset) >> 9).to(torch.float32)


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
                mode: str, norm_stats=None) -> torch.Tensor:
    """The reference's ``use_pallas=False`` score, operation for
    operation: ``eafl`` folds min-max normalisation into the affine
    ``ca*a + cb*b + c0`` (the first product and the add fused).
    ``norm_stats`` injects the ``((lo_a, range_a), (lo_b, range_b))`` the
    select step reduced (over the mesh on a sharded population); the
    arithmetic is shared, so a shard's scores equal the single-device
    ones bitwise."""
    f = cfg.f
    if mode == "oort":
        s = a
    elif mode == "eafl":
        if cfg.normalize_reward:
            if norm_stats is None:
                lo_a, ra = rewards.minmax_range(a, valid)
                lo_b, rb = rewards.minmax_range(b, valid)
            else:
                (lo_a, ra), (lo_b, rb) = norm_stats
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


# Over a ``clients`` mesh (``launch/mesh.py``) the same step runs two-level:
# every per-client tensor is a shard block ``(S, n_loc)``, each shard emits
# its local top-k candidates, the candidates of every shard are gathered
# in shard order and one small top-k finishes. Each shard emits ties
# lowest local index first, so among equal values the gathered order is
# ascending global index: ``lax.top_k``'s order over the whole array.
# With bitwise-equal scores (the shared ``_mix_scores`` arithmetic, exactly
# associative min/max reductions for the normalisation, and prefix-stable
# rank bits) the result is index for index the single-device one.

def _local_topk(x: torch.Tensor, k_loc: int):
    """Each shard's ``k_loc`` largest entries of ``x (S, n_loc)`` in
    ``lax.top_k``'s order: ``(values, local indices)``, both ``(S,
    k_loc)``."""
    top = torch.sort(orderable_key(x), dim=-1, descending=True,
                     stable=True).indices[:, :k_loc]
    return x.gather(-1, top), top


def _merge_candidates(v_loc: torch.Tensor, i_loc: torch.Tensor, k: int,
                      axis) -> torch.Tensor:
    """Gather every shard's candidates (values and GLOBAL indices, ``(S,
    k_loc)``) in shard order and finish with one small top-k: the (k,)
    global indices."""
    v_all = axis.all_gather(v_loc).reshape(-1)
    i_all = axis.all_gather(i_loc).reshape(-1)
    return i_all[_top_k_idx(v_all, k)]


def _merge_topk(g_loc: torch.Tensor, k: int, k_loc: int, base: torch.Tensor,
                axis) -> torch.Tensor:
    """The exact two-level tournament: each shard's top ``k_loc``, then
    the candidate merge; tie for tie ``_top_k_idx(g, k)`` of the whole
    array."""
    v_loc, i_loc = _local_topk(g_loc, k_loc)
    return _merge_candidates(v_loc, i_loc + base[:, None], k, axis)


def _slot_owner(idx: torch.Tensor, base: torch.Tensor, n_loc: int):
    """``(own, loc)``, both ``(S, k)``: whether shard s holds the client of
    global slot index ``idx[j]``, and where (clamped into range)."""
    rel = idx[None, :] - base[:, None]
    return (rel >= 0) & (rel < n_loc), torch.clamp(rel, 0, n_loc - 1)


def _slot_gather(x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                 axis=None, dtype=torch.float32) -> torch.Tensor:
    """``x[idx]`` as ``dtype`` for the (k,) global slots where ``mask`` (0
    elsewhere). On a mesh, from the shards' ``(S, n_loc)`` blocks: exactly
    one shard owns each slot, so a sum over the shards reassembles the
    values without changing any of them (``dtype`` holds them exactly)."""
    if axis is None:
        vals = x[idx].to(dtype)
        return torch.where(mask, vals, torch.zeros_like(vals))
    n_loc = x.shape[-1]
    own, loc = _slot_owner(idx, axis.bases(n_loc, x.device), n_loc)
    vals = x.gather(-1, loc).to(dtype)
    # (a sum of integers widens to int64: cast back)
    return axis.psum(torch.where(own & mask, vals,
                                 torch.zeros_like(vals))).to(dtype)


def _exploit_kernel(a, b, mask, ucb, cfg: SelectorConfig, mode: str, k: int,
                    axis):
    """The exploit top-k through ``kernels.ops.topk_reward`` on normalised
    inputs: one launch on one device; on a mesh one launch a shard, the
    shard's first global index a constant ``index_offset``, then the
    candidate merge."""
    if axis is None:
        return ops.topk_reward(a, b, mask, ucb=ucb, f=cfg.f, k=k,
                               mode=mode)[1].long()
    n_loc = a.shape[-1]
    cands = [ops.topk_reward(a[s], b[s], mask[s], ucb=ucb[s], f=cfg.f,
                             k=min(k, n_loc), mode=mode,
                             index_offset=(axis.first + s) * n_loc)
             for s in range(a.shape[0])]
    return _merge_candidates(torch.stack([v for v, _ in cands]),
                             torch.stack([i for _, i in cands]).long(), k,
                             axis)


def _device_select(key: torch.Tensor, cfg: SelectorConfig,
                   state: SelectorState, pop: ClientPopulation,
                   predicted_cost_pct: torch.Tensor, use_kernel: bool,
                   axis=None, n_real: Optional[int] = None):
    """Fixed-shape selection step: ``(idx (k,) int64, chosen (k,) bool,
    new_state)``; only the ``chosen`` slots are picks (exploit slots
    first, then exploration).

    With a ``clients`` mesh as ``axis``, ``pop`` (every leaf) and
    ``predicted_cost_pct`` are this process's ``(S, n_loc)`` blocks of a
    population padded with inert clients (dead, explored), ``n_real`` the
    unpadded count: the outputs are replicated and index for index those
    of the unpadded population on one device. Only the top-k legs differ
    (the two-level tournament); the rank bits are each shard's slice of
    the prefix-stable stream."""
    dev = predicted_cost_pct.device
    if not use_kernel and dev.type == "cuda":
        raise ValueError("on CUDA the exploit top-k runs the topk_reward "
                         "kernel: use_kernel must be True")
    n_loc = predicted_cost_pct.shape[-1]
    k = min(cfg.k, n_loc if axis is None else n_real)
    if axis is None:
        topk = functools.partial(_top_k_idx, k=k)
    else:
        topk = functools.partial(_merge_topk, k=k, k_loc=min(k, n_loc),
                                 base=axis.bases(n_loc, dev), axis=axis)
    st = state.canonical(dev)
    st = SelectorState(st.round + 1, st.epsilon, st.pacer_T, st.util_ema)
    valid = pop.alive
    k_eff = torch.clamp_max(asum(valid, axis), k).to(torch.int32)
    slots = torch.arange(k, device=dev)
    minus_one = f32(-1.0, st.epsilon)
    bits = population_draw(lambda n, off: _rank_bits(key, n, off), n_loc,
                           axis)

    if cfg.kind == "random":
        return topk(torch.where(valid, bits, minus_one)), slots < k_eff, st

    explored = pop.explored & valid
    unexplored = valid & ~explored
    a, b, norm_valid, mask, ucb, mode = _score_inputs(cfg, st, pop,
                                                      predicted_cost_pct)
    mask = mask & explored
    norm_stats = None
    if mode == "eafl" and cfg.normalize_reward:
        norm_stats = (rewards.minmax_range(a, norm_valid, axis),
                      rewards.minmax_range(b, norm_valid, axis))

    n_unexp = asum(unexplored, axis).to(torch.int32)
    # exploit slots are capped by the selectable explored pool
    n_expl_avail = asum(mask, axis).to(torch.int32)
    n_explore = torch.minimum(
        torch.round(st.epsilon * k_eff).to(torch.int32), n_unexp)
    n_exploit = torch.minimum(k_eff - n_explore, n_expl_avail)
    n_explore = torch.minimum(k_eff - n_exploit, n_unexp)
    if use_kernel:
        if norm_stats is not None:
            a = rewards.minmax_normalize(a, norm_valid, norm_stats[0])
            b = rewards.minmax_normalize(b, norm_valid, norm_stats[1])
        exploit_idx = _exploit_kernel(a, b, mask, ucb, cfg, mode, k, axis)
    else:
        exploit_idx = topk(_mix_scores(cfg, a, b, norm_valid, mask, ucb,
                                       mode, norm_stats))

    explore_idx = topk(torch.where(unexplored, bits, minus_one))

    take_exploit = slots < n_exploit
    idx = torch.where(take_exploit, exploit_idx,
                      explore_idx[torch.clamp(slots - n_exploit, 0, k - 1)])
    chosen = slots < (n_exploit + n_explore)

    # epsilon decay + pacer update on the selected utility mass, skipped
    # when no client is selectable (k_eff == 0)
    any_pick = k_eff > 0
    n_chosen = chosen.sum()
    sel_util = _slot_gather(pop.stat_util, idx, chosen, axis).sum() \
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


def make_sharded_select_step(cfg: SelectorConfig, mesh, n_real: int,
                             use_kernel: Optional[bool] = None):
    """The sharded selection step over a ``clients`` mesh
    (``launch/mesh.py``): ``step(key, state, pop, predicted_cost_pct) ->
    (idx, chosen, new_state)``. ``pop`` and ``predicted_cost_pct`` are
    whole (N,) arrays, unpadded or padded: the step pads them (inert
    clients), takes this process's shards and draws only their rank bits.
    The outputs are replicated and equal :func:`_device_select` on the
    unpadded inputs. ``use_kernel=None`` takes the kernel on CUDA and the
    plain route on the CPU."""
    from repro_torch.launch.sharding import population_sharding, \
        shard_clients

    n_padded = mesh.n_padded(n_real)
    put_pop = population_sharding(mesh)

    def step(key, state, pop, predicted_cost_pct):
        if pop.n not in (n_real, n_padded):
            raise ValueError(f"the step was made for {n_real} clients, got "
                             f"{pop.n}")
        kernel = (pop.device.type == "cuda" if use_kernel is None
                  else use_kernel)
        return _device_select(key, cfg, state, put_pop(pop),
                              shard_clients(predicted_cost_pct, mesh),
                              kernel, axis=mesh, n_real=n_real)

    return step


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
