"""The fused engines, sync and async, on the card: each step replayed from
its CUDA graph equals the same step run eagerly, bit for bit, and a
replayed top-k launch equals an eager one. Needs a CUDA device and skips elsewhere; imports no
JAX (run with ``--noconftest`` on a machine without it)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.configs.paper_resnet_speech import reduced  # noqa: E402
from repro_torch.core.clients import make_population  # noqa: E402
from repro_torch.core.energy import EnergyModel  # noqa: E402
from repro_torch.core.selection import (SelectorConfig,  # noqa: E402
                                        SelectorState)
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated import simulation as tsim  # noqa: E402
from repro_torch.federated.faults import FaultConfig  # noqa: E402
from repro_torch.federated.replay import StepGraphs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

FAULTS = FaultConfig(seed=2, crash_prob=0.3, max_retries=2,
                     straggle_prob=0.3, corrupt_prob=0.2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs replay only on the card")
    return torch.device("cuda")


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k] == b[k]).all() or (
            a[k].dtype.kind == "f" and
            ((a[k] == b[k]) | ((a[k] != a[k]) & (b[k] != b[k]))).all()), k


def _both(make, rounds, names):
    """The trajectory of ``rounds`` rounds replayed and run eagerly (the
    same steps through ``StepGraphs._body``, the body a graph captures)."""
    out = []
    for replayed in (True, False):
        graphs = make()
        run = graphs.run if replayed else graphs._body
        for _ in range(rounds):
            for name in names:
                run(name)
        out.append(graphs.fetch(0, rounds))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("faults", [None, FAULTS])
def test_selection_replay_equals_eager(faults):
    dev = _card()
    cfg, em = SelectorConfig("eafl", k=100), EnergyModel(0.02)
    pop = make_population(prng.PRNGKey(5, dev), 50_000)
    step = tsim.make_round_engine(cfg, em, 3.0e6, 10, 20, 900.0,
                                  faults=faults)
    keys = prng.split(prng.PRNGKey(1, dev), 4)
    st = SelectorState.create(cfg).canonical(dev)
    before = ops.LAUNCHES["topk_reward"]
    replayed, eager = _both(
        lambda: tsim._selection_graphs(step, keys, pop, st, 4, 0), 4,
        ("round",))
    _equal(replayed, eager)
    # warm-up 1 + 4 replays, then 4 eager rounds
    assert ops.LAUNCHES["topk_reward"] - before == 9


@pytest.mark.gpu
def test_training_replay_equals_eager():
    dev = _card()
    cfg = tserver.FLConfig(selector=SelectorConfig("eafl", k=5),
                           n_clients=40, rounds=3, local_steps=2,
                           batch_size=4, samples_per_client=8,
                           model=dataclasses.replace(reduced(), input_hw=16),
                           input_hw=16, eval_samples=32, eval_every=2,
                           overcommit=1.4, faults=FAULTS,
                           recharge_pct_per_hour=30.0)

    def make():
        steps, carry0 = tserver._fused_engine(cfg, dev)
        graphs = StepGraphs(carry0, cfg.rounds)
        graphs.add("round", steps[0], advance=True)
        graphs.add("eval", steps[1], row=-1)
        return graphs

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        replayed, eager = _both(make, cfg.rounds, ("round", "eval"))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    _equal(replayed, eager)


@pytest.mark.gpu
def test_async_selection_replay_equals_eager():
    dev = _card()
    cfg, em = SelectorConfig("eafl", k=40), EnergyModel(0.02)
    pop = make_population(prng.PRNGKey(5, dev), 50_000)
    init_fill, step = tsim.make_async_round_engine(
        cfg, em, 3.0e6, 10, 20, buffer_size=10, max_concurrency=40,
        deadline_s=900.0, energy_budget_j=2e5)
    key0, keys, refill = tsim._async_xs(prng.PRNGKey(1, dev), 5)

    def make():
        st, astate, _, _ = init_fill(
            key0, pop, SelectorState.create(cfg).canonical(dev),
            tsim.AsyncEventState.create(pop.n, dev))
        return tsim._async_graphs(step, keys, refill,
                                  {"pop": pop, "st": st, "astate": astate},
                                  5, 0)

    replayed, eager = _both(make, 5, ("agg",))
    _equal(replayed, eager)
    assert replayed["staleness"].max() > 0


@pytest.mark.gpu
def test_async_training_replay_equals_eager():
    from repro_torch.federated import async_server as tasync
    dev = _card()
    cfg = tserver.FLConfig(selector=SelectorConfig("oort", k=5),
                           n_clients=40, rounds=4, local_steps=2,
                           batch_size=4, samples_per_client=8,
                           model=dataclasses.replace(reduced(), input_hw=16),
                           input_hw=16, eval_samples=32, eval_every=2,
                           buffer_size=2, max_concurrency=6,
                           recharge_pct_per_hour=30.0)

    def make():
        (kloop, data, test, params, opt, opt_state, pop, sim_steps,
         up_bytes, energy_model, model_bytes) = tserver._fused_setup(cfg, dev)
        opt_state = dict(opt_state, t=opt_state["t"].to(dev))
        fill, agg_fn, eval_fn = tasync._async_fused_runner(
            cfg, energy_model, sim_steps, model_bytes, up_bytes, opt,
            data["x"], data["y"], test["x"], test["y"])
        carry = fill(kloop, params, opt_state, pop,
                     SelectorState.create(cfg.selector).canonical(dev),
                     tserver._accuracy_fn(cfg.model, test)(params))
        graphs = StepGraphs(carry, cfg.rounds)
        graphs.add("agg", agg_fn, advance=True)
        graphs.add("eval", eval_fn, row=-1)
        return graphs

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        replayed, eager = _both(make, cfg.rounds, ("agg", "eval"))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    _equal(replayed, eager)


@pytest.mark.gpu
def test_replayed_topk_launch_equals_eager():
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(0)
    a, b, u = (torch.rand(200_000, generator=g).to(dev) for _ in range(3))
    valid = (torch.rand(200_000, generator=g) < 0.7).to(dev)
    kw = dict(f=0.25, k=100, ucb=u, mode="eafl")
    ops.topk_reward(a, b, valid, **kw)              # set-up outside capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = ops.topk_reward(a, b, valid, **kw)
    for seed in (1, 2, 3):
        g.manual_seed(seed)
        a.copy_(torch.rand(200_000, generator=g).to(dev))
        graph.replay()
        eager = ops.topk_reward(a, b, valid, **kw)
        assert torch.equal(static_out[1], eager[1])
        assert torch.equal(static_out[0].view(torch.int32),
                           eager[0].view(torch.int32))
