"""The FL coordinator loop, EAFL's Fig. 2 architecture, in PyTorch.

Runs REAL training: the ResNet speech-keyword classifier (the paper's
workload) on a non-IID label-restricted partition, with the energy/timing
simulation deciding who participates, who drops out, and how long each
round takes. Local training runs over the whole cohort at once
(``torch.func.vmap`` of ``grad_and_value`` over per-client parameters).

This is the reference's synchronous host loop (``engine="host"``), with
the same key schedule, so selection, dropout and battery trajectories
follow the reference's. Options not ported yet raise and name their
ROADMAP.md item: the fused/sharded engines, async aggregation, the knob
controller, fault injection and checkpointing.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import prng
from repro_torch.compression import compress_delta, wire_bytes
from repro_torch.configs.paper_resnet_speech import CONFIG as RESNET_CONFIG
from repro_torch.configs.paper_resnet_speech import ResNetConfig
from repro_torch.core.clients import (ClientPopulation, make_population,
                                      scatter_stat_util)
from repro_torch.core.energy import EnergyModel
from repro_torch.core.fairness import jains_index
from repro_torch.core.rewards import stat_utility
from repro_torch.core.selection import SelectorConfig, SelectorState, select
from repro_torch.data.partition import label_restricted_partition, make_test_set
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated.aggregation import (finite_rows,
                                               make_server_optimizer,
                                               server_update, tree_finite,
                                               weighted_delta,
                                               zero_nonfinite_rows)
from repro_torch.federated.simulation import round_cost_table, simulate_round
from repro_torch.models.resnet import init_resnet, resnet_forward, resnet_loss


@dataclass
class FLConfig:
    selector: SelectorConfig
    n_clients: int = 200
    rounds: int = 100
    local_steps: int = 10
    batch_size: int = 20            # paper: B=20
    client_lr: float = 0.05         # paper: lr=0.05
    server_opt: str = "yogi"        # paper: YoGi
    server_lr: float = 0.05
    samples_per_client: int = 64
    labels_per_client: int = 4      # paper: 10% of 35 labels
    n_classes: int = 35
    input_hw: int = 32
    data_noise: float = 0.5
    eval_every: int = 5
    eval_samples: int = 512
    deadline_s: Optional[float] = None
    seed: int = 0
    model: ResNetConfig = field(default_factory=lambda: RESNET_CONFIG)
    init_battery_low: float = 60.0
    init_battery_high: float = 100.0
    # simulated device workload (None -> derive from the proxy model)
    sim_model_bytes: Optional[float] = None
    sim_local_steps: Optional[int] = None
    idle_busy_fraction: float = 0.02
    # recharging availability model
    recharge_pct_per_hour: float = 0.0
    plugged_frac: float = 0.25
    rejoin_pct: float = 20.0
    # update compression: none | int8 | topk
    compression: str = "none"
    compression_sparsity: float = 0.05
    # FedProx proximal term on client SGD
    fedprox_mu: float = 0.0
    # over-provisioning: select ceil(overcommit*K), aggregate the fastest K
    overcommit: float = 1.0
    # async (FedBuff) knobs: not ported yet (ROADMAP.md, queue 1 item 11)
    buffer_size: Optional[int] = None
    max_concurrency: Optional[int] = None
    staleness_power: float = 0.5
    snapshot_ring_size: Optional[int] = None
    # faults and checkpoints: not ported yet (ROADMAP.md, queue 1 item 9)
    faults: Optional[Any] = None
    checkpoint_path: Optional[str] = None
    checkpoint_every: Optional[int] = None
    resume_from: Optional[str] = None
    # fleet energy budget (joules); controller: not ported (item 12)
    energy_budget_j: Optional[float] = None
    controller: Optional[Any] = None


def replace_selector_k(sel: SelectorConfig, k: int) -> SelectorConfig:
    return dataclasses.replace(sel, k=k)


def cap_stragglers(outcome, k: int):
    """Over-provisioning cap: keep only the fastest ``k`` successful
    clients; stragglers beyond ``k`` are abandoned (they already paid
    their energy). Returns a new outcome; only ``succeeded`` shrinks."""
    order = np.argsort(outcome.durations)
    keep = [i for i in order if outcome.succeeded[i]][:k]
    mask = np.zeros_like(outcome.succeeded)
    mask[keep] = True
    return dataclasses.replace(outcome, succeeded=outcome.succeeded & mask)


def _cohort_train_fn(model_cfg, local_steps: int, batch_size: int, lr: float,
                     fedprox_mu: float = 0.0, compression: str = "none",
                     compression_sparsity: float = 0.05):
    """Local SGD of a whole cohort from one global parameter tree.

    ``cohort(params, xs (C,M,H,W,1), ys (C,M), keys (C,2))`` returns
    ``(deltas (C,...), per_sample_loss (C,M), mean_step_loss (C,))``.
    Minibatch indices come from the batched threefry ``randint`` with the
    reference's per-client key schedule."""
    codec_params = ({"sparsity": compression_sparsity}
                    if compression == "topk" else {})

    def loss_fn(p, x, y, p0):
        loss, per_sample = resnet_loss(model_cfg, p, {"x": x, "y": y})
        if fedprox_mu:
            prox = sum(torch.sum(torch.square(a - b))
                       for a, b in zip(tree_leaves(p), tree_leaves(p0)))
            loss = loss + 0.5 * fedprox_mu * prox
        return loss, per_sample

    step_fn = vmap(grad_and_value(loss_fn, has_aux=True),
                   in_dims=(0, 0, 0, None))
    eval_fn = vmap(lambda p, x, y: resnet_loss(model_cfg, p,
                                               {"x": x, "y": y})[1])

    def cohort(params, xs, ys, keys):
        c, m = ys.shape
        idx = prng.randint(prng.split(keys, local_steps), (batch_size,), 0, m)
        rows = torch.arange(c, device=ys.device)[:, None]
        p = tree_map(lambda w: w.expand(c, *w.shape), params)
        losses = []
        for s in range(local_steps):
            bi = idx[:, s]
            grads, (loss, _) = step_fn(p, xs[rows, bi], ys[rows, bi], params)
            p = tree_map(lambda w, g: w - lr * g, p, grads)
            losses.append(loss)
        delta = tree_map(lambda a, b: a - b, p, params)
        if compression != "none":
            delta = vmap(lambda d: compress_delta(compression, d,
                                                  **codec_params).delta)(delta)
        per_sample = eval_fn(p, xs, ys)
        return delta, per_sample, torch.stack(losses, dim=1).mean(dim=1)

    return cohort


@dataclass
class FLHistory:
    round: List[int] = field(default_factory=list)
    wall_hours: List[float] = field(default_factory=list)
    round_duration: List[float] = field(default_factory=list)
    test_acc: List[float] = field(default_factory=list)
    train_loss: List[float] = field(default_factory=list)
    cum_dropouts: List[int] = field(default_factory=list)
    fairness: List[float] = field(default_factory=list)
    participation: List[float] = field(default_factory=list)
    mean_battery: List[float] = field(default_factory=list)
    retries: List[int] = field(default_factory=list)
    quarantined: List[int] = field(default_factory=list)
    update_skipped: List[int] = field(default_factory=list)
    # cumulative joules debited through each round (the ledger's f32 chain)
    energy_spent_j: List[float] = field(default_factory=list)
    controller_arm: List[int] = field(default_factory=list)
    budget_exhausted_round: Optional[int] = None
    # accuracy of the untrained model, the pad before the first eval
    init_acc: float = float("nan")

    def as_dict(self) -> Dict[str, Any]:
        return {k: (list(v) if isinstance(v, list) else v)
                for k, v in self.__dict__.items()}


def _recharge_step(cfg: FLConfig, pop: ClientPopulation,
                   krecharge: torch.Tensor,
                   duration_s: float) -> ClientPopulation:
    """A random ``plugged_frac`` of devices gains charge over the round's
    wall time; recovered dropouts rejoin. ``krecharge`` is this round's
    dedicated key."""
    if cfg.recharge_pct_per_hour <= 0.0:
        return pop
    kplug = prng.fold_in(krecharge, 7)
    plugged = prng.bernoulli(kplug, cfg.plugged_frac, (cfg.n_clients,))
    gain = cfg.recharge_pct_per_hour * duration_s / 3600.0
    battery = torch.clamp(pop.battery_pct + plugged.to(torch.float32) * gain,
                          0.0, 100.0)
    rejoin = pop.dropped & (battery >= cfg.rejoin_pct)
    return pop.replace(battery_pct=battery, dropped=pop.dropped & ~rejoin)


def _record_test_acc(hist: FLHistory, cfg: FLConfig, rnd: int, params,
                     test_acc_fn) -> None:
    """Eval every ``eval_every`` rounds (and on the last); other rounds pad
    with the last real evaluation (``init_acc`` before the first)."""
    if rnd % cfg.eval_every == 0 or rnd == cfg.rounds:
        hist.test_acc.append(float(test_acc_fn(params)))
    else:
        hist.test_acc.append(hist.test_acc[-1] if hist.test_acc
                             else hist.init_acc)


def _engine_setup(cfg: FLConfig, kpop: torch.Tensor, model_bytes: float):
    """Population + simulated-workload knobs."""
    pop = make_population(kpop, cfg.n_clients,
                          init_battery_low=cfg.init_battery_low,
                          init_battery_high=cfg.init_battery_high,
                          samples_per_client=cfg.samples_per_client)
    sim_steps = (cfg.sim_local_steps if cfg.sim_local_steps is not None
                 else cfg.local_steps)
    codec_params = ({"sparsity": cfg.compression_sparsity}
                    if cfg.compression == "topk" else {})
    up_bytes = wire_bytes(model_bytes, cfg.compression, **codec_params)
    energy_model = EnergyModel(busy_fraction=cfg.idle_busy_fraction)
    return pop, sim_steps, up_bytes, energy_model


def _reject_unported(cfg: FLConfig, mode: str, engine: str) -> None:
    if mode not in ("auto", "sync", "async"):
        raise ValueError(f"unknown mode {mode!r}; expected 'auto', 'sync' "
                         f"or 'async'")
    if mode == "async" or (mode == "auto" and (
            cfg.buffer_size is not None or cfg.max_concurrency is not None)):
        raise NotImplementedError(
            "async (FedBuff) aggregation is not ported yet "
            "(ROADMAP.md, queue 1 item 11)")
    if engine not in ("auto", "host"):
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet: the fused engine is "
            f"ROADMAP.md queue 1 item 10, the sharded one item 13")
    if cfg.controller is not None:
        raise NotImplementedError(
            "the knob controller is not ported yet (ROADMAP.md, queue 1 "
            "item 12)")
    if cfg.faults is not None:
        raise NotImplementedError(
            "fault injection is not ported yet (ROADMAP.md, queue 1 item 9)")
    if cfg.checkpoint_path is not None or cfg.resume_from is not None:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP.md, queue 1 item 9)")


def run_fl(cfg: FLConfig, verbose: bool = False, mode: str = "auto",
           engine: str = "auto", device: DeviceLike = None) -> FLHistory:
    """Run the full synchronous FL experiment (REAL training) on
    ``device`` (the CUDA card unless ``device="cpu"``)."""
    _reject_unported(cfg, mode, engine)
    dev = resolve_device(device)
    kpop, kdata, kmodel, ktest, kloop = prng.split(prng.PRNGKey(cfg.seed,
                                                                dev), 5)
    data = label_restricted_partition(
        kdata, cfg.n_clients, cfg.samples_per_client, cfg.n_classes,
        cfg.labels_per_client, cfg.input_hw, noise=cfg.data_noise)
    test = make_test_set(ktest, cfg.eval_samples, cfg.n_classes,
                         cfg.input_hw, noise=cfg.data_noise)

    params = init_resnet(kmodel, cfg.model)
    n_params = sum(x.numel() for x in tree_leaves(params))
    model_bytes = (cfg.sim_model_bytes if cfg.sim_model_bytes is not None
                   else n_params * 4.0)
    opt = make_server_optimizer(cfg.server_opt, cfg.server_lr)
    opt_state = opt.init(params)

    pop, sim_steps, up_bytes, energy_model = _engine_setup(cfg, kpop,
                                                           model_bytes)
    sel_state = SelectorState.create(cfg.selector)
    local_train = _cohort_train_fn(cfg.model, cfg.local_steps,
                                   cfg.batch_size, cfg.client_lr,
                                   cfg.fedprox_mu, cfg.compression,
                                   cfg.compression_sparsity)

    def test_acc_fn(p):
        logits = resnet_forward(cfg.model, p, test["x"])
        return (torch.argmax(logits, -1) == test["y"]).to(
            torch.float32).mean()

    # round-invariant predicted cost: the selector's power(i) every round
    _, pred_cost = round_cost_table(pop, energy_model, model_bytes,
                                    sim_steps, cfg.batch_size, up_bytes)

    hist = FLHistory()
    hist.init_acc = float(test_acc_fn(params))
    wall = 0.0
    cum_drop = 0
    last_loss = float("nan")
    spent = 0.0

    for rnd in range(1, cfg.rounds + 1):
        kloop, ksel, ktrain, krecharge = prng.split(kloop, 4)
        n_pick = int(np.ceil(cfg.selector.k * cfg.overcommit))
        sel_cfg = cfg.selector if n_pick == cfg.selector.k else \
            replace_selector_k(cfg.selector, n_pick)
        selected, sel_state = select(ksel, sel_cfg, sel_state, pop,
                                     pred_cost)
        if len(selected) == 0:
            break
        pop, outcome = simulate_round(
            pop, selected, energy_model, model_bytes, sim_steps,
            cfg.batch_size, rnd, cfg.deadline_s, up_bytes,
            energy_budget_j=cfg.energy_budget_j, spent_j=spent)
        spent = outcome.spent_after_j
        if not outcome.admitted and hist.budget_exhausted_round is None:
            hist.budget_exhausted_round = rnd
        cum_drop += outcome.new_dropouts
        if cfg.overcommit > 1.0:
            outcome = cap_stragglers(outcome, cfg.selector.k)

        pop = _recharge_step(cfg, pop, krecharge, outcome.round_duration)

        succ = outcome.selected[outcome.succeeded]
        skipped = 1
        n_quar = 0
        if len(succ) > 0:
            succ_t = torch.as_tensor(succ, dtype=torch.long, device=dev)
            keys = prng.split(ktrain, len(succ))
            deltas, per_sample, mean_losses = local_train(
                params, data["x"][succ_t], data["y"][succ_t], keys)
            # non-finite quarantine: zero both the weight and the delta row
            finite = finite_rows(deltas)
            weights = pop.n_samples[succ_t].to(torch.float32)
            w = torch.where(finite, weights, torch.zeros_like(weights))
            agg = weighted_delta(zero_nonfinite_rows(deltas, finite), w)
            n_quar = int((~finite).sum())
            if bool(finite.any()) and bool(tree_finite(agg)):
                params, opt_state = server_update(params, agg, opt,
                                                  opt_state)
                skipped = 0
            su = stat_utility(per_sample, w)
            pop = scatter_stat_util(pop, succ_t, finite, su)
            last_loss = float(mean_losses.mean())

        wall += outcome.round_duration / 3600.0
        hist.round.append(rnd)
        hist.wall_hours.append(wall)
        hist.round_duration.append(outcome.round_duration)
        hist.cum_dropouts.append(cum_drop)
        hist.fairness.append(float(jains_index(pop.times_selected)))
        hist.participation.append(float(outcome.succeeded.mean()))
        hist.mean_battery.append(float(pop.battery_pct.mean()))
        hist.train_loss.append(last_loss)
        hist.retries.append(int(outcome.retries))
        hist.quarantined.append(n_quar)
        hist.update_skipped.append(skipped)
        hist.energy_spent_j.append(spent)
        _record_test_acc(hist, cfg, rnd, params, test_acc_fn)
        if verbose and rnd % 10 == 0:
            print(f"[{cfg.selector.kind}] r={rnd} acc={hist.test_acc[-1]:.3f} "
                  f"loss={last_loss:.3f} drop={cum_drop} "
                  f"fair={hist.fairness[-1]:.3f} wall={wall:.2f}h")
    return hist
