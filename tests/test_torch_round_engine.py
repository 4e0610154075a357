"""The port's fused selection engine (``run_rounds_scanned``) against its
host loop (``select`` + ``simulate_round`` with the same keys), and the
data twins of the reference's ``sample_speech_like`` and
``dirichlet_partition``, on the CPU.

Selected indices, masks, dropouts, retries and corrupt flags equal;
durations, joules and battery within rtol 1e-6 (the same float32 models;
the mean battery reduced over the population in another order); a
segmented or resumed run equals the uninterrupted one bitwise. Data:
labels exact, inputs within the ``erfinv`` tolerance of the normal draws
(``tests/test_torch_prng.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import data as jdata  # noqa: E402
from test_torch_training_engines import one_thread  # noqa: E402,F401
from repro_torch import data as tdata  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core.clients import make_population  # noqa: E402
from repro_torch.core.energy import EnergyModel  # noqa: E402
from repro_torch.core.selection import (SelectorConfig,  # noqa: E402
                                        SelectorState, select)
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated import simulation as tsim  # noqa: E402
from repro_torch.federated.faults import FaultConfig  # noqa: E402

MODEL_BYTES, STEPS, BATCH = 3.0e6, 400, 20
FAULTS = FaultConfig(seed=2, crash_prob=0.3, max_retries=2,
                     straggle_prob=0.3, corrupt_prob=0.2)


def _pop(n=40):
    pop = make_population(prng.PRNGKey(5, "cpu"), n, init_battery_low=5.0,
                          init_battery_high=40.0)
    g = torch.Generator().manual_seed(1)
    return pop.replace(explored=torch.rand(n, generator=g) < 0.5,
                       stat_util=torch.rand(n, generator=g) * 50)


def _host_rounds(key, cfg, pop, em, rounds, deadline_s, faults):
    keys = prng.split(key, rounds)
    _, cost = tsim.round_cost_table(pop, em, MODEL_BYTES, STEPS, BATCH)
    st = SelectorState.create(cfg)
    out = []
    for r in range(rounds):
        idx, st = select(keys[r], cfg, st, pop, cost)
        pop, o = tsim.simulate_round(pop, idx, em, MODEL_BYTES, STEPS, BATCH,
                                     r + 1, deadline_s, faults=faults)
        out.append((idx, o, float(pop.battery_pct.mean())))
    return pop, out


@pytest.mark.parametrize("kind", ["eafl", "oort", "random", "eafl-epj"])
@pytest.mark.parametrize("faulty", [False, True])
def test_scanned_matches_host_rounds(kind, faulty):
    cfg, em = SelectorConfig(kind, k=6), EnergyModel(0.02)
    faults = FAULTS if faulty else None
    key = prng.PRNGKey(9, "cpu")
    pop_h, host = _host_rounds(key, cfg, _pop(), em, 5, 900.0, faults)
    pop_s, st, traj = tsim.run_rounds_scanned(
        key, cfg, _pop(), SelectorState.create(cfg), em, MODEL_BYTES, STEPS,
        BATCH, 5, deadline_s=900.0, faults=faults)
    assert int(st.round) == 5
    for r, (idx, o, battery) in enumerate(host):
        chosen = traj["chosen"][r]
        np.testing.assert_array_equal(traj["selected"][r][chosen], idx)
        np.testing.assert_array_equal(traj["succeeded"][r][chosen],
                                      o.succeeded)
        np.testing.assert_array_equal(traj["corrupt"][r][chosen], o.corrupt)
        assert traj["new_dropouts"][r] == o.new_dropouts
        assert traj["retries"][r] == o.retries
        np.testing.assert_allclose(traj["round_duration"][r],
                                   o.round_duration, rtol=1e-6)
        np.testing.assert_allclose(traj["energy_spent_j"][r],
                                   o.energy_spent_j, rtol=1e-6)
        np.testing.assert_allclose(traj["mean_battery"][r], battery,
                                   rtol=1e-6)
    for f in ("battery_pct", "dropped", "times_selected", "last_round"):
        assert torch.equal(getattr(pop_h, f), getattr(pop_s, f)), f
    if faulty:
        assert traj["retries"].sum() > 0


def test_scanned_segments_and_resume_are_bitwise(tmp_path):
    cfg, em = SelectorConfig("eafl", k=6), EnergyModel(0.02)
    key = prng.PRNGKey(3, "cpu")
    args = (cfg, _pop(), SelectorState.create(cfg), em, MODEL_BYTES, STEPS,
            BATCH, 6)
    kw = dict(deadline_s=900.0, faults=FAULTS)
    pop, _, whole = tsim.run_rounds_scanned(key, *args, **kw)
    path = str(tmp_path / "sel-{round}.ckpt")
    _, _, seg = tsim.run_rounds_scanned(key, *args, checkpoint_every=4,
                                        checkpoint_path=path, **kw)
    pop_r, _, resumed = tsim.run_rounds_scanned(
        key, *args, resume_from=path.format(round=4), **kw)
    for traj in (seg, resumed):
        assert traj.keys() == whole.keys()
        for name in whole:
            np.testing.assert_array_equal(traj[name], whole[name], name)
    assert torch.equal(pop.battery_pct, pop_r.battery_pct)
    with pytest.raises(ValueError, match="checkpoint_path"):
        tsim.run_rounds_scanned(key, *args, checkpoint_every=2, **kw)


def test_run_selection_scanned():
    cfg = tserver.FLConfig(selector=SelectorConfig("eafl", k=4),
                           n_clients=30, rounds=3, sim_model_bytes=2.0e6)
    pop, out = tserver.run_selection_scanned(cfg, device="cpu")
    assert out["engine"] == "scanned" and int(out["state"].round) == 3
    assert out["selected"].shape == (3, 4) and pop.n == 30
    # the sharded twins, by a shard count or by name, raise from the
    # run_rounds front door (ROADMAP.md queue 1 item 13)
    for bad, match in ((dict(n_shards=2), "item 13"),
                       (dict(mode="sharded"), "item 13")):
        with pytest.raises(NotImplementedError, match=match):
            tserver.run_selection_scanned(cfg, device="cpu", **bad)
    # async is ported: it runs the async event engine
    _, out = tserver.run_selection_scanned(cfg, device="cpu", mode="async")
    assert out["engine"] == "async-scanned"


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_speech_like(seed):
    a = jdata.sample_speech_like(jax.random.PRNGKey(seed), 50, hw=16)
    b = tdata.sample_speech_like(prng.PRNGKey(seed, "cpu"), 50, hw=16)
    np.testing.assert_array_equal(np.asarray(a["y"]), b["y"].numpy())
    np.testing.assert_allclose(np.asarray(a["x"]), b["x"].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 3])
def test_dirichlet_labels_from_the_reference_probabilities(seed):
    """``jax.random.dirichlet`` draws gamma variates by rejection, which
    no port can reproduce bit for bit: the reference's per-client
    probabilities are injected, and the labels drawn from them must be
    the reference's."""
    kj = jax.random.PRNGKey(seed)
    ref = jdata.dirichlet_partition(kj, 7, 20, hw=16)
    ka, _, _ = jax.random.split(kj, 3)
    probs = jax.random.dirichlet(ka, 0.3 * jnp.ones(35), (7,))
    kb = prng.split(prng.PRNGKey(seed, "cpu"), 3)[1]
    y = tdata.labels_from_probs(kb, torch.from_numpy(np.array(probs)), 20)
    np.testing.assert_array_equal(np.asarray(ref["y"]), y.numpy())
    out = tdata.dirichlet_partition(prng.PRNGKey(seed, "cpu"), 7, 20, hw=16)
    assert out["x"].shape == (7, 20, 16, 16, 1)
    assert out["y"].shape == (7, 20) and int(out["y"].max()) < 35


def test_gamma_moments():
    """The port's own gamma draws (Marsaglia-Tsang from its threefry
    streams) have Gamma(a, 1)'s mean and variance, a."""
    for a in (0.3, 2.5):
        g = prng.gamma(prng.PRNGKey(1, "cpu"), a, (40_000,)).double()
        assert abs(float(g.mean()) - a) < 0.05 * a
        assert abs(float(g.var()) - a) < 0.1 * a


def test_selection_step_reads_nothing_on_the_host():
    from test_torch_training_engines import NoHostRead
    cfg, em = SelectorConfig("eafl", k=6), EnergyModel(0.02)
    step = tsim.make_round_engine(cfg, em, MODEL_BYTES, STEPS, BATCH, 900.0,
                                  faults=FAULTS)
    keys = prng.split(prng.PRNGKey(3, "cpu"), 3)
    graphs = tsim._selection_graphs(step, keys, _pop(), SelectorState.create(
        cfg).canonical("cpu"), 3, 0)
    graphs.run("round")     # makes the cost tables, as the card's warm-up
    with NoHostRead():
        for _ in range(2):
            graphs.run("round")
    assert graphs.fetch(0, 3)["selected"].shape == (3, 6)
