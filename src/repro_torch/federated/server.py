"""The FL coordinator loop, EAFL's Fig. 2 architecture, in PyTorch.

Runs REAL training: the ResNet speech-keyword classifier (the paper's
workload) on a non-IID label-restricted partition, with the energy/timing
simulation deciding who participates, who drops out, and how long each
round takes. Local training runs over the whole cohort at once
(``torch.func.vmap`` of ``grad_and_value`` over per-client parameters).

Three synchronous engines, with the reference's key schedule, so
selection, dropout and battery trajectories follow the reference's:

- ``engine="host"`` (the default): the reference's host round loop, with
  fault injection, checkpoint/resume and the knob controller
  (``cfg.controller``, ``federated/controller.py``);
- ``engine="scanned"``: :func:`run_fl_scanned`, the whole round as one
  step with no host read, replayed from a CUDA graph on the card;
- ``engine="sharded"``: :func:`run_fl_sharded`, that step over a
  ``clients`` mesh (``launch/mesh.py``).

``mode="async"`` (or ``"auto"`` with ``buffer_size`` or
``max_concurrency`` set) runs the buffered-asynchronous (FedBuff) twins
of ``federated/async_server.py``: the host event loop for
``engine="host"``, the fused engine (``"scanned"``) or its twin over a
``clients`` mesh (``"sharded"``) otherwise. Mode and engine resolve
through the reference's dispatch (``simulation.resolve_aggregation``,
``resolve_train_engine``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import prng
from repro_torch.checkpoint import load_engine_checkpoint, segment_bounds
from repro_torch.compression import compress_delta, wire_bytes
from repro_torch.configs.paper_resnet_speech import CONFIG as RESNET_CONFIG
from repro_torch.configs.paper_resnet_speech import ResNetConfig
from repro_torch.core.clients import (ClientPopulation, make_population,
                                      scatter_stat_util)
from repro_torch.core.energy import EnergyModel
from repro_torch.core.fairness import jains_index
from repro_torch.core.rewards import stat_utility
from repro_torch.core.selection import (SelectorConfig, SelectorState,
                                        _slot_gather, _slot_owner,
                                        _top_k_idx, select)
from repro_torch.data.partition import label_restricted_partition, make_test_set
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated.aggregation import (finite_rows,
                                               make_server_optimizer,
                                               server_update, tree_finite,
                                               weighted_delta,
                                               zero_nonfinite_rows)
from repro_torch.federated.controller import (ControllerConfig,
                                              UCBController, arm_knobs)
from repro_torch.federated.faults import FaultConfig
from repro_torch.federated.replay import StepGraphs
from repro_torch.federated.simulation import (ENGINES, BudgetLedger,
                                              _concat_traj,
                                              _make_checkpointer,
                                              _round_step,
                                              resolve_aggregation,
                                              resolve_train_engine,
                                              round_cost_table, run_rounds,
                                              scatter_drop_rows,
                                              simulate_round, world_size)
from repro_torch.launch.mesh import asum, population_draw
from repro_torch.models.resnet import init_resnet, resnet_forward, resnet_loss
from repro_torch.numerics import f32


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
    # async (FedBuff) knobs: setting buffer_size or max_concurrency opts
    # into the async server (federated/async_server.py)
    buffer_size: Optional[int] = None
    max_concurrency: Optional[int] = None
    staleness_power: float = 0.5
    snapshot_ring_size: Optional[int] = None
    # faults: seed-driven transient client faults (federated/faults.py).
    # checkpoint_path turns on engine-carry snapshots (a literal "{round}"
    # makes one file per snapshot), checkpoint_every sets the cadence
    # (default: the last round only), resume_from continues a snapshot
    faults: Optional[FaultConfig] = None
    checkpoint_path: Optional[str] = None
    checkpoint_every: Optional[int] = None
    resume_from: Optional[str] = None
    # energy_budget_j: fleet-wide joules budget, enforced in every engine.
    # controller: between-rounds UCB bandit over discrete knob arms
    # (federated/controller.py) adapting k / buffer_size / staleness_power
    # / compression_sparsity from observed accuracy per joule; the sync
    # host loop only (the fused engines fix their knobs for the run)
    energy_budget_j: Optional[float] = None
    controller: Optional[ControllerConfig] = None


def replace_selector_k(sel: SelectorConfig, k: int) -> SelectorConfig:
    return dataclasses.replace(sel, k=k)


def cap_stragglers(outcome, k: int):
    """Over-provisioning cap: keep only the fastest ``k`` successful
    clients; stragglers beyond ``k`` are abandoned (they already paid
    their energy). Returns a new outcome; only ``succeeded`` shrinks.
    Equal durations keep the earlier slot, as the fused engine's top-k
    does."""
    order = np.argsort(outcome.durations, kind="stable")
    keep = [i for i in order if outcome.succeeded[i]][:k]
    mask = np.zeros_like(outcome.succeeded)
    mask[keep] = True
    return dataclasses.replace(outcome, succeeded=outcome.succeeded & mask)


def _cohort_train_fn(model_cfg, local_steps: int, batch_size: int, lr: float,
                     fedprox_mu: float = 0.0, compression: str = "none",
                     compression_sparsity: float = 0.05,
                     params_axis: Optional[int] = None):
    """Local SGD of a whole cohort.

    ``cohort(params, xs (C,M,H,W,1), ys (C,M), keys (C,2))`` returns
    ``(deltas (C,...), per_sample_loss (C,M), mean_step_loss (C,))``.
    ``params_axis=None`` trains every client from one global parameter
    tree (the sync engines); ``params_axis=0`` gives each client its own
    start parameters, stacked ``(C, ...)``, and its own FedProx anchor
    (the async engines: a completer trains from the version it
    downloaded). Minibatch indices come from the batched threefry
    ``randint`` with the reference's per-client key schedule."""
    if params_axis not in (None, 0):
        raise ValueError(f"params_axis must be None or 0, got {params_axis}")
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
                   in_dims=(0, 0, 0, params_axis))
    eval_fn = vmap(lambda p, x, y: resnet_loss(model_cfg, p,
                                               {"x": x, "y": y})[1])

    def cohort(params, xs, ys, keys):
        c, m = ys.shape
        idx = prng.randint(prng.split(keys, local_steps), (batch_size,), 0, m)
        rows = torch.arange(c, device=ys.device)[:, None]
        p = params if params_axis == 0 else \
            tree_map(lambda w: w.expand(c, *w.shape), params)
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


def _train_meta(cfg: FLConfig, family: str) -> Dict[str, Any]:
    """Checkpoint identity of a training run, the reference's: ``family``
    is ``"train-host"`` for the host loop (its snapshot also carries the
    Python-side FLHistory) and ``"train-sync"`` for the fused engine."""
    return {
        "family": family,
        "n_clients": int(cfg.n_clients),
        "rounds": int(cfg.rounds),
        "kind": cfg.selector.kind,
        "k": int(cfg.selector.k),
        "seed": int(cfg.seed),
        "deadline_s": (None if cfg.deadline_s is None
                       else float(cfg.deadline_s)),
        "overcommit": float(cfg.overcommit),
        "compression": cfg.compression,
        "server_opt": cfg.server_opt,
        "faults": (None if cfg.faults is None
                   else dataclasses.asdict(cfg.faults)),
        "energy_budget_j": (None if cfg.energy_budget_j is None
                            else float(cfg.energy_budget_j)),
    }


def _fused_setup(cfg: FLConfig, dev: torch.device):
    """The run's data, model, optimizer and population, from the seed's
    key split: the host loop's preamble, shared by the fused engine so
    both start from one state. Returns ``(kloop, data, test, params, opt, opt_state, pop, sim_steps,
    up_bytes, energy_model, model_bytes)``."""
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
    return (kloop, data, test, params, opt, opt_state, pop, sim_steps,
            up_bytes, energy_model, model_bytes)


def _accuracy_fn(model_cfg, test):
    def test_acc_fn(p):
        logits = resnet_forward(model_cfg, p, test["x"])
        return (torch.argmax(logits, -1) == test["y"]).to(
            torch.float32).mean()
    return test_acc_fn


def run_fl(cfg: FLConfig, verbose: bool = False, mode: str = "auto",
           engine: str = "auto", device: DeviceLike = None) -> FLHistory:
    """Run the full FL experiment (REAL training) on ``device`` (the CUDA
    card unless ``device="cpu"``).

    ``mode`` resolves through ``resolve_aggregation``, as the reference's:
    ``"sync"``, ``"async"`` (FedBuff, ``federated/async_server.py``), or
    ``"auto"``, async exactly when ``cfg.buffer_size`` or
    ``cfg.max_concurrency`` is set; an engine name is a ``ValueError``
    (engines are forced through ``run_rounds``). ``engine`` resolves
    through ``resolve_train_engine``: in the sync family ``"host"`` (and
    ``"auto"``) runs the host round loop and ``"scanned"``
    :func:`run_fl_scanned`; in the async family ``"host"`` runs the host
    event loop ``run_fl_async`` and ``"scanned"`` (and ``"auto"`` on one
    device) ``run_fl_async_scanned``; ``"sharded"`` runs
    :func:`run_fl_sharded` in the sync family and ``run_fl_async_sharded``
    in the async one (``"auto"`` on more than one device), over a mesh of
    the initialised ``torch.distributed`` group's ranks, else of one
    shard. The engines of a family produce the same trajectory within
    float tolerance.

    ``cfg.controller`` runs only in the sync host loop (a ``ValueError``
    elsewhere, as the reference's): before each round the UCB bandit
    pulls an arm whose knobs shape that round, and after it one extra
    evaluation, which draws no random number, rewards the arm with the
    accuracy gained per joule. With ``cfg.checkpoint_path`` the host loop
    snapshots its carry, history and controller (``"train-host"`` family:
    a snapshot the reference wrote resumes here); ``cfg.resume_from``
    continues one."""
    if mode in ENGINES:
        raise ValueError(
            f"run_fl takes 'auto'/'sync'/'async', not the engine name "
            f"{mode!r}; force engines via repro_torch.federated.run_rounds")
    mode = resolve_aggregation(mode, cfg.buffer_size, cfg.max_concurrency)
    engine = resolve_train_engine(cfg.n_clients, world_size(), mode=mode,
                                  engine=engine)
    if cfg.controller is not None and (mode == "async" or engine != "host"):
        # the controller turns knobs that are fixed in the fused engines
        # and structural in the async event loop
        raise ValueError(
            f"cfg.controller runs only in the synchronous host loop "
            f"(resolved mode={mode!r}, engine={engine!r}); use "
            f"run_fl(cfg, mode='sync', engine='host')")
    if mode == "async":
        from repro_torch.federated.async_server import (
            run_fl_async, run_fl_async_scanned, run_fl_async_sharded)
        if engine == "host":
            return run_fl_async(cfg, verbose=verbose, device=device)
        if engine == "sharded":
            return run_fl_async_sharded(cfg, verbose=verbose, device=device)
        return run_fl_async_scanned(cfg, verbose=verbose, device=device)
    if engine == "sharded":
        return run_fl_sharded(cfg, verbose=verbose, device=device)
    if engine == "scanned":
        return run_fl_scanned(cfg, verbose=verbose, device=device)
    dev = resolve_device(device)
    (kloop, data, test, params, opt, opt_state, pop, sim_steps, up_bytes,
     energy_model, model_bytes) = _fused_setup(cfg, dev)
    sel_state = SelectorState.create(cfg.selector)
    local_train = _cohort_train_fn(cfg.model, cfg.local_steps,
                                   cfg.batch_size, cfg.client_lr,
                                   cfg.fedprox_mu, cfg.compression,
                                   cfg.compression_sparsity)
    test_acc_fn = _accuracy_fn(cfg.model, test)
    faulty = cfg.faults is not None and cfg.faults.active

    # round-invariant predicted cost: the selector's power(i) every round
    _, pred_cost = round_cost_table(pop, energy_model, model_bytes,
                                    sim_steps, cfg.batch_size, up_bytes)

    ctrl = None if cfg.controller is None else UCBController(cfg.controller)
    # (wire bytes, predicted cost, train fn) of each sparsity an arm sets,
    # built once: the cost column depends only on fixed population fields
    tables: Dict[float, tuple] = {}

    def arm_tables(sparsity: float):
        if sparsity not in tables:
            ub = wire_bytes(model_bytes, cfg.compression,
                            **({"sparsity": sparsity}
                               if cfg.compression == "topk" else {}))
            _, pc = round_cost_table(pop, energy_model, model_bytes,
                                     sim_steps, cfg.batch_size, ub)
            tf = _cohort_train_fn(cfg.model, cfg.local_steps,
                                  cfg.batch_size, cfg.client_lr,
                                  cfg.fedprox_mu, cfg.compression, sparsity)
            tables[sparsity] = (ub, pc, tf)
        return tables[sparsity]

    meta = _train_meta(cfg, "train-host")
    ck = _make_checkpointer(cfg.checkpoint_path, cfg.checkpoint_every,
                            cfg.rounds, meta)
    start = 0
    if cfg.resume_from:
        templates = {"params": params, "opt_state": opt_state, "pop": pop,
                     "st": sel_state.canonical(dev), "kloop": kloop}
        start, state, saved, _ = load_engine_checkpoint(
            cfg.resume_from, templates, expect_meta=meta)
        params, opt_state, pop = (state["params"], state["opt_state"],
                                  state["pop"])
        sel_state, kloop = state["st"], state["kloop"]
        hist = FLHistory(**saved["hist"])
        wall = float(saved["wall"])
        cum_drop = int(saved["cum_drop"])
        last_loss = float(saved["last_loss"])
        # the ledger's f32 chain round-trips exactly through the float
        # history entry, so the resumed gate decisions match bitwise
        spent = hist.energy_spent_j[-1] if hist.energy_spent_j else 0.0
        probe_acc = float(saved.get("probe_acc", hist.init_acc))
        if ctrl is not None and "ctrl" in saved:
            ctrl.load_state(saved["ctrl"])
    else:
        hist = FLHistory()
        hist.init_acc = float(test_acc_fn(params))
        wall = 0.0
        cum_drop = 0
        last_loss = float("nan")
        spent = 0.0
        probe_acc = hist.init_acc

    for rnd in range(start + 1, cfg.rounds + 1):
        kloop, ksel, ktrain, krecharge = prng.split(kloop, 4)
        arm = arm_i = None
        arm_k = cfg.selector.k
        rnd_up_bytes, rnd_pred_cost, rnd_train = (up_bytes, pred_cost,
                                                  local_train)
        if ctrl is not None:
            # the arm is pulled before the round, so every knob it moves
            # shapes this round; an all-inherit arm changes no value
            arm_i = ctrl.choose(rnd)
            arm = cfg.controller.arms[arm_i]
            arm_k = int(arm_knobs(cfg.selector.k, arm.k))
            if arm.compression_sparsity is not None:
                rnd_up_bytes, rnd_pred_cost, rnd_train = arm_tables(
                    float(arm.compression_sparsity))
        n_pick = int(np.ceil(arm_k * cfg.overcommit))
        sel_cfg = cfg.selector if n_pick == cfg.selector.k else \
            replace_selector_k(cfg.selector, n_pick)
        selected, sel_state = select(ksel, sel_cfg, sel_state, pop,
                                     rnd_pred_cost)
        if len(selected) == 0:
            break
        spent_before = spent
        pop, outcome = simulate_round(
            pop, selected, energy_model, model_bytes, sim_steps,
            cfg.batch_size, rnd, cfg.deadline_s, rnd_up_bytes,
            faults=cfg.faults, energy_budget_j=cfg.energy_budget_j,
            spent_j=spent)
        spent = outcome.spent_after_j
        if not outcome.admitted and hist.budget_exhausted_round is None:
            hist.budget_exhausted_round = rnd
        cum_drop += outcome.new_dropouts
        agg_cap = (arm_k if arm is None or arm.buffer_size is None
                   else min(arm_k, int(arm.buffer_size)))
        if cfg.overcommit > 1.0 or agg_cap < n_pick:
            # keep the fastest agg_cap successful clients; agg_cap falls
            # below k only when an arm sets buffer_size
            outcome = cap_stragglers(outcome, agg_cap)

        pop = _recharge_step(cfg, pop, krecharge, outcome.round_duration)

        succ = outcome.selected[outcome.succeeded]
        skipped = 1
        n_quar = 0
        if len(succ) > 0:
            succ_t = torch.as_tensor(succ, dtype=torch.long, device=dev)
            keys = prng.split(ktrain, len(succ))
            deltas, per_sample, mean_losses = rnd_train(
                params, data["x"][succ_t], data["y"][succ_t], keys)
            if faulty:
                # corrupted-upload fault: the client trained and paid the
                # energy, but the delta that arrives is garbage
                bad = torch.as_tensor(outcome.corrupt[outcome.succeeded],
                                      device=dev)
                deltas = _poison(deltas, bad)
            # non-finite quarantine: zero both the weight and the delta row
            finite = finite_rows(deltas)
            weights = pop.n_samples[succ_t].to(torch.float32)
            w = torch.where(finite, weights, torch.zeros_like(weights))
            if (arm is not None and arm.staleness_power is not None
                    and arm.staleness_power > 0.0):
                # FedBuff-style damping of the sync cohort by arrival rank
                # (round duration), computed by numpy as the reference's
                w = w * torch.as_tensor(
                    _arrival_damping(outcome, arm.staleness_power),
                    device=dev)
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
        if ctrl is not None:
            hist.controller_arm.append(arm_i)
            # the reward probe: one extra evaluation, which draws no random
            # number, so the bookkeeping cannot move the trajectory
            acc_now = float(test_acc_fn(params))
            ctrl.update(arm_i, acc_now - probe_acc, spent - spent_before)
            probe_acc = acc_now
        _record_test_acc(hist, cfg, rnd, params, test_acc_fn)
        if verbose and rnd % 10 == 0:
            print(f"[{cfg.selector.kind}] r={rnd} acc={hist.test_acc[-1]:.3f} "
                  f"loss={last_loss:.3f} drop={cum_drop} "
                  f"fair={hist.fairness[-1]:.3f} wall={wall:.2f}h")
        if ck and ck.due(rnd):
            # kloop here is the carry that seeds round rnd+1, so a resumed
            # run re-enters the identical RNG chain
            ck_data = {"hist": hist.as_dict(), "wall": wall,
                       "cum_drop": cum_drop, "last_loss": last_loss}
            if ctrl is not None:
                ck_data["ctrl"] = ctrl.state_dict()
                ck_data["probe_acc"] = probe_acc
            ck.save(rnd,
                    {"params": params, "opt_state": opt_state, "pop": pop,
                     "st": sel_state, "kloop": kloop},
                    ck_data)
    return hist


def _arrival_damping(outcome, power: float) -> np.ndarray:
    """``(1 + rank) ** -power`` of each successful client's arrival rank
    (its round duration, ties in slot order), in float32 by numpy, as the
    reference's sync-cohort damping."""
    dur = np.asarray(outcome.durations)[outcome.succeeded]
    rank = np.argsort(np.argsort(dur, kind="stable"), kind="stable")
    return (1.0 + rank.astype(np.float32)) ** np.float32(-power)


def _poison(deltas, bad: torch.Tensor):
    """Rows ``bad`` of every stacked delta leaf become NaN."""
    return tree_map(lambda d: torch.where(
        bad.reshape((-1,) + (1,) * (d.ndim - 1)),
        torch.full((), float("nan"), dtype=d.dtype, device=d.device), d),
        deltas)


# ------------------------------------------------------ the fused engine
# The whole round as one step over tensors, with no host read: selection ->
# fault draw -> budget gate -> simulation -> straggler cap -> recharge ->
# masked fixed-width cohort local SGD -> corrupt injection -> quarantine ->
# weighted delta -> gated server update -> stat-util scatter; the eval on
# the scheduled rounds is a second step. On the card both are captured
# once in CUDA graphs and replayed (federated/replay.py); on the CPU they
# run eagerly. The carry (params, optimizer state, population, selector
# state, RNG chain, last accuracy, budget ledger) lives in static tensors.
#
# The engine runs over a ``clients`` mesh (``launch/mesh.py``; one shard
# for run_fl_scanned): selection and simulation shard-local
# (``simulation._round_step``); the cohort's per-slot data reassembled by
# one-owner-per-slot sums; the slot axis padded to a multiple of the shard
# count and split evenly, shard i training slots [i*n_per, (i+1)*n_per);
# each shard's weighted partial delta summed over the mesh; the server
# step and the eval on the replicated parameters. Selection, success
# masks, dropouts and battery are the same on any mesh (the same streams,
# elementwise battery arithmetic, exact max durations); the aggregate is
# a float32 reduction reordered by shard, so parameters and what follows
# them (accuracy, loss, stat utilities) agree within a tolerance across
# shard counts.
#
# Parity with the host loop (its oracle):
#   * the RNG chain is the host's: kloop, ksel, ktrain, krecharge =
#     split(kloop, 4) a round, and the slot with success-rank j trains with
#     split(ktrain, n_slots)[j], which equals the host's split(ktrain,
#     n_succ)[j] (threefry splits are prefix-stable);
#   * failed and abandoned slots train dead weight: their deltas enter
#     weighted_delta with weight exactly 0;
#   * the straggler cap is the stable top-k of -duration over the
#     successful slots, lowest slot first on ties, as cap_stragglers;
#   * the recharge gain is the host's double-precision
#     rate * duration / 3600 rounded once to float32;
#   * the server update is computed always and kept where some
#     non-quarantined slot succeeded and the aggregate is finite, as the
#     host's gate (the adaptive optimizers are not no-ops on zero deltas);
#   * train_loss and participation are reduced on the host from per-slot
#     outputs, over the compacted slots as the host loop does.
# One visible difference: the host loop stops when selection returns no
# client; the fused engine runs every round (empty rounds are inert).

_TRAIN_CARRY = ("params", "opt_state", "pop", "st", "kloop", "last_acc",
                "ledger")


def _recharge_gain(rate: float, duration: torch.Tensor) -> torch.Tensor:
    """``rate * duration / 3600`` in double precision, rounded once to
    float32: the host loop's Python arithmetic on the float32 duration
    (the division by a tensor, which CUDA does not turn into a product
    with a reciprocal)."""
    d = duration.to(torch.float64) * rate
    return torch.div(d, torch.full((), 3600.0, dtype=torch.float64,
                                   device=d.device)).to(torch.float32)


def _recharge_device(cfg: FLConfig, pop: ClientPopulation,
                     krecharge: torch.Tensor, duration: torch.Tensor,
                     axis=None, n_real: Optional[int] = None,
                     ) -> ClientPopulation:
    """:func:`_recharge_step` with the round's duration on the device (no
    host read), bitwise the host loop's. On a ``clients`` mesh (``axis``)
    the population is in shard blocks padded from ``n_real`` clients: each
    shard takes its slice of the population-wide plug-in draw, and pad
    clients never plug in, so they never rejoin."""
    if cfg.recharge_pct_per_hour <= 0.0:
        return pop
    kplug = prng.fold_in(krecharge, 7)
    n_loc = pop.battery_pct.shape[-1]
    plugged = population_draw(lambda n, off: prng.bernoulli(
        kplug, cfg.plugged_frac, (n,), off), n_loc, axis)
    if axis is not None:
        base = axis.bases(n_loc, plugged.device)
        plugged = plugged & ((base[:, None] + torch.arange(
            n_loc, device=plugged.device)) < n_real)
    gain = _recharge_gain(cfg.recharge_pct_per_hour, duration)
    battery = torch.clamp(pop.battery_pct + plugged.to(torch.float32) * gain,
                          0.0, 100.0)
    rejoin = pop.dropped & (battery >= cfg.rejoin_pct)
    return pop.replace(battery_pct=battery, dropped=pop.dropped & ~rejoin)


class _SlotSplit:
    """A trainer's slot axis of ``n`` rows over a ``clients`` mesh: padded
    to a multiple of the shard count and split evenly, shard i training
    rows ``[i*per, (i+1)*per)`` (the padded rows train with weight 0), so
    this process's ``S`` shards train rows ``[lo, hi)``. The slots' data
    come from their clients' one owner (:meth:`owned`), per-row results go
    back in slot order (:meth:`whole`), and the aggregate is
    ``weighted_delta``'s arithmetic with its reduction split by shard
    (:meth:`weighted_delta`; on one shard, ``weighted_delta`` itself)."""

    def __init__(self, n: int, mesh, S: int):
        self.n, self.mesh, self.S = n, mesh, S
        self.pad = (-n) % mesh.size()
        self.per = (n + self.pad) // mesh.size()
        self.lo, self.hi = mesh.first * self.per, (mesh.first + S) * self.per

    def local(self, a: torch.Tensor) -> torch.Tensor:
        """This process's rows of the slot-major ``a``, padded with 0."""
        if self.pad:
            a = torch.cat([a, a.new_zeros((self.pad, *a.shape[1:]))])
        return a[self.lo:self.hi]

    def whole(self, x_loc: torch.Tensor) -> torch.Tensor:
        """Per-row values of this process's rows, gathered over the mesh
        in slot order and cut to the ``n`` slots."""
        return self.mesh.all_gather(x_loc.reshape(self.S, self.per)
                                    ).reshape(-1)[:self.n]

    def owned(self, a_loc: torch.Tensor, own: torch.Tensor,
              loc: torch.Tensor) -> torch.Tensor:
        """The slots' rows of a per-client ``(S, n_loc, ...)`` block: each
        from its one owner (``_slot_owner``'s ``own``, ``loc``), the
        others' zeros summed over the mesh, which changes no value."""
        rows = torch.arange(self.S, device=a_loc.device)[:, None]
        vals = a_loc[rows, loc]
        keep = own.reshape(*own.shape, *(1,) * (vals.ndim - 2))
        return self.mesh.psum(torch.where(keep, vals,
                                          torch.zeros_like(vals)))

    def weighted_delta(self, deltas, w: torch.Tensor):
        """``weighted_delta(deltas, w)`` over the whole slot axis, from this
        process's rows of ``deltas``: normalised by the global weight, each
        shard's partial product summed over the mesh."""
        wn = self.local(w / torch.clamp_min(w.sum(), 1e-9)).reshape(
            self.S, self.per)
        return tree_map(lambda d: self.mesh.psum(torch.stack([
            torch.tensordot(wn[s].to(d.dtype), d_s, dims=1)
            for s, d_s in enumerate(d.reshape(self.S, self.per,
                                              *d.shape[1:]))])), deltas)


def _fused_runner(cfg: FLConfig, sel_cfg: SelectorConfig, agg_k: int,
                  energy_model: EnergyModel, opt, mesh, data_x, data_y,
                  test_x, test_y, t_total, cost):
    """The fused engine's two steps over the carry ``_TRAIN_CARRY``:
    ``(round_fn, eval_fn)``, each ``fn(carry, ctr) -> (carry, outs)``
    (``federated/replay.py``), on the ``clients`` ``mesh``: the
    population, ``data_x``/``data_y``, ``t_total`` and ``cost`` in shard
    blocks ``(S, n_loc, ...)``. ``sel_cfg.k`` is the over-provisioned slot
    count ``ceil(k * overcommit)``, ``agg_k`` the aggregation cap."""
    cohort = _cohort_train_fn(cfg.model, cfg.local_steps, cfg.batch_size,
                              cfg.client_lr, cfg.fedprox_mu, cfg.compression,
                              cfg.compression_sparsity)
    faulty = cfg.faults is not None and cfg.faults.active
    eval_acc = _accuracy_fn(cfg.model, {"x": test_x, "y": test_y})
    n_real = cfg.n_clients
    S, n_loc = cost.shape
    n_slots = min(sel_cfg.k, n_real)
    split = _SlotSplit(n_slots, mesh, S)
    neg_inf = f32(float("-inf"), cost)

    def round_fn(carry, ctr):
        params, opt_state, pop, st, kloop, last_acc, ledger = (
            carry[k] for k in _TRAIN_CARRY)
        kloop, ksel, ktrain, krecharge = prng.split(kloop, 4).unbind(-2)
        (pop, st, idx, chosen, dev, retries, corrupt,
         ledger) = _round_step(
            ksel, st, pop, t_total, cost, sel_cfg=sel_cfg,
            energy_model=energy_model, deadline_s=cfg.deadline_s,
            faults=cfg.faults, axis=mesh, n_real=n_real,
            energy_budget_j=cfg.energy_budget_j, ledger=ledger)
        mask = _slot_gather(dev.succeeded, idx, chosen, mesh) > 0
        if n_slots > agg_k:
            # the straggler cap ranks the fault-modified durations
            slot_dur = _slot_gather(dev.durations, idx, chosen, mesh)
            g = torch.where(mask, -slot_dur, neg_inf)
            keep = torch.zeros_like(mask).scatter(
                0, _top_k_idx(g, agg_k), torch.ones_like(mask))
            mask = mask & keep
        pop = _recharge_device(cfg, pop, krecharge, dev.round_duration, mesh,
                               n_real)
        # the cohort's data: one shard owns each slot's client
        own, loc = _slot_owner(idx, mesh.bases(n_loc, cost.device), n_loc)
        w = _slot_gather(pop.n_samples, idx, mask, mesh)
        # masked fixed-width cohort: every slot trains, the success-rank key
        # assignment reproduces the host's split bitwise
        ranks = torch.clamp(torch.cumsum(mask.to(torch.int64), 0) - 1, 0,
                            n_slots - 1)
        deltas, per_sample, mean_losses = cohort(
            params, split.local(split.owned(data_x, own, loc)),
            split.local(split.owned(data_y, own, loc)),
            split.local(prng.split(ktrain, n_slots)[ranks]))
        if faulty:
            bad = _slot_gather(corrupt, idx, chosen, mesh) > 0
            deltas = _poison(deltas, split.local(bad & mask))
        # quarantine on this process's slots, gathered back in slot order
        fin_loc = finite_rows(deltas)
        deltas = zero_nonfinite_rows(deltas, fin_loc)
        fin = split.whole(fin_loc)
        good = mask & fin
        wq = torch.where(fin, w, torch.zeros_like(w))
        agg = split.weighted_delta(deltas, wq)
        new_params, new_opt = server_update(params, agg, opt, opt_state)
        # the update is kept where some non-quarantined slot succeeded and
        # the aggregate is finite, as the host's gate
        ok = good.any() & tree_finite(agg)
        params = tree_map(lambda a, b: torch.where(ok, a, b), new_params,
                          params)
        opt_state = tree_map(lambda a, b: torch.where(ok, a, b), new_opt,
                             opt_state)
        su = split.whole(stat_utility(per_sample, split.local(wq)))
        losses = split.whole(mean_losses)
        pop = pop.replace(stat_util=scatter_drop_rows(
            pop.stat_util, loc, own & good, su))
        out = {
            "selected": idx.to(torch.int32),
            "chosen": chosen,
            "succeeded": mask,
            "round_duration": dev.round_duration,
            "new_dropouts": dev.new_dropouts,
            "energy_spent_pct": dev.energy_spent_pct,
            "mean_battery": asum(pop.battery_pct, mesh) / n_real,
            "fairness": jains_index(pop.times_selected, mesh, n_real),
            # per-slot losses; train_loss is reduced on the host over the
            # compacted slots, as the host loop reduces it
            "slot_losses": torch.where(mask, losses,
                                       torch.zeros_like(losses)),
            # the last evaluation; the eval step overwrites it on the
            # rounds it runs
            "test_acc": last_acc,
            "retries": retries,
            "quarantined": (mask & ~fin).sum().to(torch.int32),
            "update_skipped": (~ok).to(torch.int32),
            # the cumulative float32 ledger itself, as the host records it
            "energy_spent_j": ledger.spent_j,
            "budget_exhausted": ledger.exhausted_round,
        }
        return dict(params=params, opt_state=opt_state, pop=pop, st=st,
                    kloop=kloop, last_acc=last_acc, ledger=ledger), out

    def eval_fn(carry, ctr):
        acc = eval_acc(carry["params"])
        return dict(carry, last_acc=acc), {"test_acc": acc}

    return round_fn, eval_fn


def _reject_async_knobs(cfg: FLConfig, name: str) -> None:
    if cfg.buffer_size is not None or cfg.max_concurrency is not None:
        raise ValueError(
            f"{name} is a synchronous engine; cfg.buffer_size / "
            f"cfg.max_concurrency opt into the async server: use "
            f"run_fl(cfg, mode='async')")
    if cfg.controller is not None:
        raise ValueError(
            f"{name} fixes its knobs for the run; the adaptive controller "
            f"(cfg.controller) runs only in the host loop")


def _history_from_traj(cfg: FLConfig, init_acc: float,
                       traj: Dict[str, np.ndarray]) -> FLHistory:
    """:class:`FLHistory` from a fused-engine trajectory. The host float
    work is the host loop's: the float64 wall clock accumulated round by
    round, participation in float64, and train_loss as the float32 mean
    over the compacted successful slots."""
    hist = FLHistory(init_acc=init_acc)
    dur = np.asarray(traj["round_duration"])
    hist.round = list(range(1, cfg.rounds + 1))
    hist.wall_hours = [float(x) for x in
                       np.cumsum(dur.astype(np.float64) / 3600.0)]
    hist.round_duration = [float(x) for x in dur]
    hist.cum_dropouts = [int(x) for x in
                         np.cumsum(np.asarray(traj["new_dropouts"]))]
    n_succ = np.asarray(traj["succeeded"]).sum(axis=1).astype(np.float64)
    n_sel = np.asarray(traj["chosen"]).sum(axis=1).astype(np.float64)
    hist.participation = [float(x) for x in n_succ / np.maximum(n_sel, 1.0)]
    slot_losses = np.asarray(traj["slot_losses"])
    succ_mask = np.asarray(traj["succeeded"])
    last_loss = float("nan")
    for r in range(slot_losses.shape[0]):
        m = succ_mask[r]
        if m.any():
            last_loss = float(torch.from_numpy(slot_losses[r][m]).mean())
        hist.train_loss.append(last_loss)
    for name in ("test_acc", "fairness", "mean_battery", "energy_spent_j"):
        setattr(hist, name, [float(x) for x in np.asarray(traj[name])])
    for name in ("retries", "quarantined", "update_skipped"):
        setattr(hist, name, [int(x) for x in np.asarray(traj[name])])
    last = int(np.asarray(traj["budget_exhausted"])[-1])
    hist.budget_exhausted_round = last if last > 0 else None
    return hist


def _print_fused_history(cfg: FLConfig, hist: FLHistory) -> None:
    """The host loop's every-10-rounds progress line, after the run."""
    for rnd in range(10, len(hist.round) + 1, 10):
        i = rnd - 1
        print(f"[{cfg.selector.kind}] r={rnd} acc={hist.test_acc[i]:.3f} "
              f"loss={hist.train_loss[i]:.3f} drop={hist.cum_dropouts[i]} "
              f"fair={hist.fairness[i]:.3f} wall={hist.wall_hours[i]:.2f}h")


def _fused_do_eval(cfg: FLConfig, a: int, b: int) -> np.ndarray:
    """Eval schedule of absolute rounds ``(a, b]``: a resumed segment
    evaluates on exactly the rounds the uninterrupted run would."""
    rr = np.arange(a + 1, b + 1)
    return ((rr % cfg.eval_every) == 0) | (rr == cfg.rounds)


def _run_fused_elastic(cfg: FLConfig, steps, carry0: Dict[str, Any],
                       meta: Optional[Dict[str, Any]] = None,
                       history_fn=None,
                       capture: Optional[dict] = None,
                       mesh=None) -> FLHistory:
    """Segment, checkpoint and resume loop of the fused engines (sync and
    async): runs ``steps = (round_fn, eval_fn)`` over ``carry0`` (a dict
    of named carry trees, the checkpoint's state names) for
    ``cfg.rounds`` rounds. A round replays the round step, and on the
    scheduled rounds the eval step; the trajectory comes to the host once
    a segment. ``meta`` and ``history_fn(cfg, init_acc, traj)`` default
    to the sync family's; ``capture``, a dict, receives the whole
    trajectory under ``"traj"`` (a test hook). With a ``clients``
    ``mesh`` the carry's per-client entries (the population; the async
    family's event state and selection ranks) are in shard blocks: a
    snapshot holds them trimmed to the real clients (so it resumes under
    any shard count), and on a process-group mesh rank 0 writes it."""
    from repro_torch.federated.simulation import (_astate_gather,
                                                  _astate_put)
    from repro_torch.launch.sharding import (population_sharding,
                                             shard_clients)

    if meta is None:
        meta = _train_meta(cfg, "train-sync")
    if history_fn is None:
        history_fn = _history_from_traj
    n = cfg.n_clients

    def to_file(carry):
        if mesh is None:
            return carry
        out = dict(carry, pop=mesh.gather(carry["pop"], n))
        if "astate" in carry:
            out.update(astate=_astate_gather(carry["astate"], mesh, n),
                       slot_rank=mesh.gather(carry["slot_rank"], n))
        return out

    def from_file(carry):
        out = dict(carry, pop=population_sharding(mesh)(carry["pop"]))
        if "astate" in carry:
            out.update(astate=_astate_put(carry["astate"], mesh),
                       slot_rank=shard_clients(carry["slot_rank"], mesh))
        return out

    ck = _make_checkpointer(cfg.checkpoint_path, cfg.checkpoint_every,
                            cfg.rounds, meta)
    parts: List[Dict[str, Any]] = []
    if cfg.resume_from:
        start, carry, saved, _ = load_engine_checkpoint(
            cfg.resume_from, to_file(carry0), expect_meta=meta)
        if mesh is not None:
            carry = from_file(carry)
        parts.append(saved["traj"])
        init_acc = float(saved["init_acc"])
    else:
        start, carry = 0, carry0
        init_acc = float(carry0["last_acc"])
    graphs = StepGraphs(carry, cfg.rounds, start)
    graphs.add("round", steps[0], advance=True)
    graphs.add("eval", steps[1], row=-1)
    for a, b in segment_bounds(start, cfg.rounds, ck.every if ck else None):
        for do_eval in _fused_do_eval(cfg, a, b):
            graphs.run("round")
            if do_eval:
                graphs.run("eval")
        parts.append(graphs.fetch(a, b))
        if ck and ck.due(b):
            state = to_file(graphs.carry())
            if mesh is None or mesh.rank == 0:
                ck.save(b, state, {"traj": _concat_traj(parts),
                                   "init_acc": init_acc})
    traj = _concat_traj(parts)
    if capture is not None:
        capture["traj"] = traj
    return history_fn(cfg, init_acc, traj)


def run_fl_scanned(cfg: FLConfig, verbose: bool = False,
                   device: DeviceLike = None) -> FLHistory:
    """:func:`run_fl` with the whole round on the device and no host read
    inside it: on the card the round step is captured once in a CUDA
    graph and replayed every round; on the CPU it runs eagerly. It is
    :func:`run_fl_sharded` on a mesh of one shard.

    The host loop is the oracle: selected indices, masks, dropouts,
    retries, quarantines and skipped updates equal; battery, fairness,
    participation, wall hours and joules within float32 rounding; loss and
    accuracy within the tolerance of a cohort summed over more rows.
    Checkpoint knobs (``cfg.checkpoint_path``, ``checkpoint_every``,
    ``resume_from``) split the run into segments; the RNG chain rides in
    the carry, so segmented and resumed runs equal the uninterrupted one
    bitwise."""
    from repro_torch.launch.mesh import ClientMesh

    _reject_async_knobs(cfg, "run_fl_scanned")
    return _run_fused(cfg, verbose, device, ClientMesh(1))


def _run_fused(cfg: FLConfig, verbose: bool, device: DeviceLike,
               mesh) -> FLHistory:
    steps, carry0 = _fused_engine(cfg, resolve_device(device), mesh)
    hist = _run_fused_elastic(cfg, steps, carry0, mesh=mesh)
    if verbose:
        _print_fused_history(cfg, hist)
    return hist


def _fused_engine(cfg: FLConfig, dev: torch.device, mesh=None):
    """The fused engine's steps and fresh carry for ``cfg`` on ``dev``:
    ``((round_fn, eval_fn), carry0)``, over a ``clients`` ``mesh`` (one
    shard by default): the population and the clients' data in shard
    blocks."""
    from repro_torch.launch.mesh import ClientMesh
    from repro_torch.launch.sharding import population_sharding, \
        shard_clients

    mesh = ClientMesh(1) if mesh is None else mesh
    (kloop, data, test, params, opt, opt_state, pop, sim_steps, up_bytes,
     energy_model, model_bytes) = _fused_setup(cfg, dev)
    if "t" in opt_state:          # the step count rides in the graph too
        opt_state = dict(opt_state, t=opt_state["t"].to(dev))
    n_pick = int(np.ceil(cfg.selector.k * cfg.overcommit))
    sel_cfg = cfg.selector if n_pick == cfg.selector.k else \
        replace_selector_k(cfg.selector, n_pick)
    pop = population_sharding(mesh)(pop)
    t_total, cost = round_cost_table(pop, energy_model, model_bytes,
                                     sim_steps, cfg.batch_size, up_bytes)
    steps = _fused_runner(
        cfg, sel_cfg, int(cfg.selector.k), energy_model, opt, mesh,
        shard_clients(data["x"], mesh), shard_clients(data["y"], mesh),
        test["x"], test["y"], t_total, cost)
    acc0 = _accuracy_fn(cfg.model, test)(params)
    carry0 = dict(params=params, opt_state=opt_state, pop=pop,
                  st=SelectorState.create(cfg.selector).canonical(dev),
                  kloop=kloop, last_acc=acc0,
                  ledger=BudgetLedger.create(dev))
    return steps, carry0


def run_fl_sharded(cfg: FLConfig, verbose: bool = False, mesh=None,
                   n_shards: Optional[int] = None,
                   device: DeviceLike = None) -> FLHistory:
    """:func:`run_fl_scanned` over a ``clients`` mesh (``mesh``, or one of
    ``n_shards`` shards from ``launch/mesh.py::make_client_mesh``): the
    population, its data and the simulation in shard blocks, the cohort's
    local SGD split evenly over the shards, their weighted deltas summed.
    Each round is one step with no host read, replayed from a CUDA graph
    on the card.

    ``run_fl_scanned`` (one shard) is the oracle: selection, success
    masks, dropouts, durations and participation equal; parameters,
    accuracy, loss, battery and fairness within float32 reduction order
    (the ``--train`` matrix of ``launch/sharded_check.py`` states the
    tolerance). Its ``"train-sync"`` snapshots hold the population
    trimmed to the real clients, so they resume under any shard count and
    in ``run_fl_scanned``, and the other way round."""
    from repro_torch.launch.mesh import make_client_mesh

    _reject_async_knobs(cfg, "run_fl_sharded")
    return _run_fused(cfg, verbose, device,
                      make_client_mesh(n_shards) if mesh is None else mesh)


def run_selection_scanned(cfg: FLConfig, rounds: Optional[int] = None,
                          n_shards: Optional[int] = None, mesh=None,
                          mode: str = "auto", device: DeviceLike = None,
                          ) -> Tuple[ClientPopulation, Dict[str, Any]]:
    """Selection + energy + battery for ``rounds`` rounds with no training,
    from the population and simulated workload :func:`run_fl` builds,
    through the :func:`run_rounds` front door: ``mode`` (default
    ``"auto"``), ``cfg``'s async knobs and the population size pick the
    engine (``n_shards``/``mesh`` upgrade it to its sharded twin). No host
    read inside a round. Returns ``(final_pop,
    {"state": final_state, "engine": name, **traj})``."""
    dev = resolve_device(device)
    kpop, _kdata, kmodel, _ktest, kloop = prng.split(prng.PRNGKey(cfg.seed,
                                                                dev), 5)
    if cfg.sim_model_bytes is not None:
        model_bytes = cfg.sim_model_bytes
    else:
        params = init_resnet(kmodel, cfg.model)
        model_bytes = sum(x.numel() for x in tree_leaves(params)) * 4.0
    pop, sim_steps, up_bytes, energy_model = _engine_setup(cfg, kpop,
                                                           model_bytes)
    final_pop, final_state, traj = run_rounds(
        kloop, cfg.selector, pop, SelectorState.create(cfg.selector),
        energy_model, model_bytes, sim_steps, cfg.batch_size,
        rounds if rounds is not None else cfg.rounds, mode=mode,
        deadline_s=cfg.deadline_s, up_bytes=up_bytes,
        buffer_size=cfg.buffer_size, max_concurrency=cfg.max_concurrency,
        staleness_power=cfg.staleness_power, mesh=mesh, n_shards=n_shards,
        faults=cfg.faults, checkpoint_every=cfg.checkpoint_every,
        checkpoint_path=cfg.checkpoint_path, resume_from=cfg.resume_from)
    return final_pop, {"state": final_state, **traj}
