"""The port's FedBuff event engine (``make_async_round_engine``) and its
selection-only run (``run_async_scanned``) on the CPU.

The engine's ``init_fill`` and six steps against the reference's (jitted,
``use_pallas=False``) on the reference's population and keys: indices,
masks, staleness, versions, dropouts and the damping weights equal (the
weights bit for bit); durations, clocks, joules and batteries within rtol
1e-6 (float32 sums over the population in another order). The damping
``(1 + s) ** -p`` equals XLA's bit for bit. In the parity limit (buffer =
concurrency = k, p = 0) ``run_async_scanned`` selects what
``run_rounds_scanned`` selects; in-flight clients are never selected
again; the clock never runs backwards; segmented and resumed runs equal
the uninterrupted one bitwise; the step reads nothing on the host.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import EnergyModel as JEnergy  # noqa: E402
from repro.core import SelectorConfig as JSel  # noqa: E402
from repro.core import SelectorState as JState  # noqa: E402
from repro.core import make_population as jmake_population  # noqa: E402
from repro.federated import simulation as jsim  # noqa: E402
from test_torch_training_engines import (NoHostRead,  # noqa: E402,F401
                                         one_thread)
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core.clients import _FIELDS, make_population  # noqa: E402
from repro_torch.core.energy import EnergyModel  # noqa: E402
from repro_torch.core.selection import (SelectorConfig,  # noqa: E402
                                        SelectorState)
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated import simulation as tsim  # noqa: E402
from repro_torch.federated.faults import FaultConfig  # noqa: E402
from repro_torch.numerics import staleness_damping  # noqa: E402

MB, STEPS, BS = 85e6, 400, 20
EXACT = ("completed", "comp_chosen", "succeeded", "staleness", "agg_weight",
         "new_dropouts")
CASES = {"eafl": ("eafl", {}), "oort": ("oort", {}),
         "random": ("random", {}), "eafl-epj": ("eafl-epj", {}),
         "deadline": ("eafl", dict(deadline_s=300.0)),
         "budget": ("eafl", dict(energy_budget_j=40_000.0))}


def _reference_population(n=60):
    pop = jmake_population(jax.random.PRNGKey(3), n, init_battery_low=5.0,
                           init_battery_high=60.0)
    return pop.replace(
        stat_util=jax.random.uniform(jax.random.PRNGKey(4), (n,)) * 10,
        explored=jax.random.uniform(jax.random.PRNGKey(5), (n,)) < 0.4)


def _port(jpop):
    return convert.population({f: np.asarray(getattr(jpop, f))
                               for f in _FIELDS}, "cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_reference(case):
    kind, kw = CASES[case]
    kw = dict(buffer_size=3, max_concurrency=8, staleness_power=0.5, **kw)
    jpop = _reference_population()
    tpop = _port(jpop)
    jfill, jstep = jsim.make_async_round_engine(JSel(kind, k=4), JEnergy(),
                                                MB, STEPS, BS, **kw)
    tfill, tstep = tsim.make_async_round_engine(SelectorConfig(kind, k=4),
                                                EnergyModel(), MB, STEPS, BS,
                                                **kw)
    jfill, jstep = jax.jit(jfill), jax.jit(jstep)
    keys = jax.random.split(jax.random.PRNGKey(7), 7)
    jst, ja, i0, c0 = jfill(keys[0], jpop,
                            JState.create(JSel(kind, k=4)).canonical(),
                            jsim.AsyncEventState.create(jpop.n))
    tst, ta, ti0, tc0 = tfill(convert.key(keys[0], "cpu"), tpop,
                              SelectorState.create(SelectorConfig(kind, k=4)),
                              tsim.AsyncEventState.create(tpop.n, "cpu"))
    assert np.array_equal(np.asarray(i0), ti0.numpy())
    assert np.array_equal(np.asarray(c0), tc0.numpy())
    stale, failed = 0, False
    for r in range(1, 7):
        refill = r < 6
        jpop, jst, ja, jfl, (jr, jc) = jstep(keys[r], jpop, jst, ja,
                                             jnp.bool_(refill))
        tpop, tst, ta, tfl, (tr, tc) = tstep(convert.key(keys[r], "cpu"),
                                             tpop, tst, ta,
                                             torch.tensor(refill))
        for k, v in jfl.items():
            a, b = np.asarray(v), tfl[k].numpy()
            if k in EXACT:
                assert a.dtype == b.dtype and np.array_equal(a, b), (r, k)
            else:
                np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=k)
        assert np.array_equal(np.asarray(jr), tr.numpy()), r
        assert np.array_equal(np.asarray(jc), tc.numpy()), r
        for f in ("start_version", "server_version", "exhausted_round"):
            assert np.array_equal(np.asarray(getattr(ja, f)),
                                  getattr(ta, f).numpy()), f
        for f in ("t_done", "server_clock", "spent_j"):
            np.testing.assert_allclose(getattr(ta, f).numpy(),
                                       np.asarray(getattr(ja, f)),
                                       rtol=1e-6, err_msg=f)
        np.testing.assert_allclose(tpop.battery_pct.numpy(),
                                   np.asarray(jpop.battery_pct), rtol=1e-6)
        assert np.array_equal(np.asarray(jpop.dropped), tpop.dropped.numpy())
        assert int(tst.round) == int(jst.round)
        stale = max(stale, int(tfl["staleness"].max()))
        failed |= bool((tfl["comp_chosen"] & ~tfl["succeeded"]).any())
    assert stale > 0
    if case == "deadline":
        assert failed, "the deadline abandoned no arrival"
    if case == "budget":
        # refused at a refill, after the fill was admitted
        assert bool(tc0.any()) and int(ta.exhausted_round) > 1


@pytest.mark.parametrize("power", [0.0, 0.5, 1.0, 1.5])
def test_staleness_damping_is_xlas(power):
    s = np.arange(0, 6000, dtype=np.int32)
    ref = np.asarray(jax.jit(
        lambda x: (1.0 + x.astype(jnp.float32)) ** (-power))(jnp.asarray(s)))
    out = staleness_damping(torch.from_numpy(s), power).numpy()
    inside = s < 4096        # the powf table; beyond it within one ulp
    assert np.array_equal(out[inside].view(np.int32),
                          ref[inside].view(np.int32))
    np.testing.assert_allclose(out, ref, rtol=1.2e-7)


def _pop(n=60, low=15.0):
    pop = make_population(prng.PRNGKey(5, "cpu"), n, init_battery_low=low,
                          init_battery_high=90.0)
    g = torch.Generator().manual_seed(1)
    return pop.replace(stat_util=torch.rand(n, generator=g) * 10)


def _run(kind="eafl", rounds=12, pop=None, **kw):
    cfg = SelectorConfig(kind, k=kw.pop("k", 6))
    return tsim.run_async_scanned(
        prng.PRNGKey(2, "cpu"), cfg, _pop() if pop is None else pop,
        SelectorState.create(cfg), EnergyModel(), MB,
        kw.pop("steps", STEPS), BS, rounds, **kw)


@pytest.mark.parametrize("kind", ["eafl", "random"])
def test_parity_limit_selects_as_the_sync_engine(kind):
    cfg = SelectorConfig(kind, k=6)
    key = prng.PRNGKey(2, "cpu")
    sp, ss, sync = tsim.run_rounds_scanned(
        key, cfg, _pop(), SelectorState.create(cfg), EnergyModel(), MB,
        STEPS, BS, 10)
    ap, ast, asyn = _run(kind, rounds=10, buffer_size=6, max_concurrency=6,
                         staleness_power=0.0)
    np.testing.assert_array_equal(sync["selected"], asyn["selected"])
    np.testing.assert_array_equal(sync["chosen"], asyn["chosen"])
    for r in range(10):
        assert set(sync["selected"][r][sync["chosen"][r]]) == \
            set(asyn["completed"][r][asyn["comp_chosen"][r]])
    np.testing.assert_allclose(sync["round_duration"],
                               asyn["round_duration"], rtol=1e-6)
    np.testing.assert_array_equal(sync["total_dropped"],
                                  asyn["total_dropped"])
    assert asyn["staleness"].max() == 0
    np.testing.assert_array_equal(asyn["agg_weight"][asyn["succeeded"]], 1.0)
    assert int(ss.round) == int(ast.round) == 10
    assert torch.equal(sp.dropped, ap.dropped)


def test_in_flight_clients_are_never_selected_again():
    _, _, t = _run("random", rounds=20, pop=_pop(40), buffer_size=2,
                   max_concurrency=6)
    inflight = set(t["fill_selected"][t["fill_chosen"]].tolist())
    assert t["n_inflight"].max() <= 6
    for r in range(20):
        done = set(t["completed"][r][t["comp_chosen"][r]].tolist())
        assert done <= inflight
        inflight -= done
        if r + 1 < 20:
            new = set(t["selected"][r + 1][t["chosen"][r + 1]].tolist())
            assert not new & inflight
            inflight |= new


def test_deadline_clock_never_runs_backwards():
    """A flush that fails whole under a loose deadline lasts the deadline,
    beyond some survivors' remaining time: they arrive at offset 0 next,
    never negative."""
    _, _, t = _run("eafl", rounds=20, pop=_pop(60, low=2.0), k=8,
                   steps=1600, buffer_size=2, max_concurrency=8,
                   deadline_s=1e6)
    assert (t["round_duration"] >= 0.0).all()
    assert (np.diff(t["server_clock"]) >= -1e-3).all()
    assert (np.diff(t["mean_battery"]) <= 1e-6).all()
    assert (t["final_event_state"].t_done >= 0).all()


def test_knob_validation():
    cfg, em = SelectorConfig("eafl", k=4), EnergyModel()
    with pytest.raises(ValueError, match="max_concurrency"):
        tsim.make_async_round_engine(cfg, em, MB, STEPS, BS, buffer_size=8,
                                     max_concurrency=4)
    with pytest.raises(ValueError, match="buffer_size"):
        tsim.make_async_round_engine(cfg, em, MB, STEPS, BS, buffer_size=0)
    with pytest.raises(ValueError, match="fault"):
        _run(rounds=2, faults=FaultConfig(seed=1, crash_prob=0.5))
    with pytest.raises(ValueError, match="checkpoint_path"):
        _run(rounds=2, checkpoint_every=1)


def test_segmented_and_resumed_runs_are_bitwise(tmp_path):
    kw = dict(rounds=8, buffer_size=2, max_concurrency=6, deadline_s=900.0)
    pop, _, whole = _run(**kw)
    path = str(tmp_path / "async-{round}.ckpt")
    _, _, seg = _run(**kw, checkpoint_path=path, checkpoint_every=3)
    pop_r, st_r, resumed = _run(**kw, resume_from=path.format(round=6))
    for traj in (seg, resumed):
        assert traj.keys() == whole.keys()
        for name, v in whole.items():
            if name != "final_event_state":
                np.testing.assert_array_equal(traj[name], v, name)
        for a, b in zip(traj["final_event_state"],
                        whole["final_event_state"]):
            assert torch.equal(a, b)
    assert torch.equal(pop.battery_pct, pop_r.battery_pct)
    assert int(st_r.round) == 8


def test_run_selection_scanned_routes_async():
    cfg = tserver.FLConfig(selector=SelectorConfig("eafl", k=4),
                           n_clients=30, rounds=4, sim_model_bytes=2.0e6,
                           buffer_size=2, max_concurrency=5)
    pop, out = tserver.run_selection_scanned(cfg, device="cpu")
    assert out["engine"] == "async-scanned" and pop.n == 30
    assert out["completed"].shape == (4, 2)
    assert out["fill_selected"].shape == (5,)
    _, forced = tserver.run_selection_scanned(
        tserver.FLConfig(selector=SelectorConfig("eafl", k=4), n_clients=30,
                         rounds=4, sim_model_bytes=2.0e6), mode="async",
        device="cpu")
    assert forced["engine"] == "async-scanned"
    assert forced["completed"].shape == (4, 4)


def test_step_reads_nothing_on_the_host():
    cfg = SelectorConfig("eafl", k=6)
    step = tsim.make_async_round_engine(cfg, EnergyModel(), MB, STEPS, BS,
                                        buffer_size=2, max_concurrency=6,
                                        deadline_s=900.0,
                                        energy_budget_j=5e4)[1]
    init_fill = tsim.make_async_round_engine(cfg, EnergyModel(), MB, STEPS,
                                             BS, buffer_size=2,
                                             max_concurrency=6)[0]
    pop = _pop()
    key0, keys, refill = tsim._async_xs(prng.PRNGKey(3, "cpu"), 4)
    st, astate, _, _ = init_fill(key0, pop, SelectorState.create(
        cfg).canonical("cpu"), tsim.AsyncEventState.create(pop.n, "cpu"))
    graphs = tsim._async_graphs(step, keys, refill,
                                {"pop": pop, "st": st, "astate": astate},
                                4, 0)
    graphs.run("agg")       # makes the damping table, as the warm-up
    with NoHostRead():
        for _ in range(3):
            graphs.run("agg")
    traj = graphs.fetch(0, 4)
    assert traj["completed"].shape == (4, 2)
    assert traj["chosen"][-1].sum() == 0        # the last flush refills none
