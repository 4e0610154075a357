"""The port's dispatch (``resolve_engine``, ``resolve_aggregation``,
``resolve_train_engine``, ``run_rounds``) against the reference's.

Mirrors every test of ``tests/test_dispatch.py`` that needs no mesh, on
the port; the sharded legs (a forced name, ``n_shards``, an auto pick on
more than one device) raise ``NotImplementedError`` naming ROADMAP.md
queue 1 item 13. The resolvers are pure functions and must return the
reference's answer on every case of its matrix and of a wider one
(devices 1-8). Forced engine names give trajectories index for index
equal to direct calls of the engines, and (converted population, the
same key) to the reference's ``run_rounds``.
"""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import clients as jclients  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core.energy import EnergyModel as JEnergy  # noqa: E402
from repro.federated import simulation as jsim  # noqa: E402
from test_torch_training_engines import one_thread  # noqa: E402,F401
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs.paper_resnet_speech import reduced  # noqa: E402
from repro_torch.core.clients import make_population  # noqa: E402
from repro_torch.core.energy import EnergyModel  # noqa: E402
from repro_torch.core.selection import (SelectorConfig,  # noqa: E402
                                        SelectorState)
from repro_torch.federated import (ENGINE_CUTOVER_N, ENGINES,  # noqa: E402
                                   TRAIN_ENGINES, FLConfig,
                                   resolve_aggregation, resolve_engine,
                                   resolve_train_engine, run_fl, run_rounds,
                                   run_selection_scanned)
from repro_torch.federated import simulation as tsim  # noqa: E402

MB, STEPS, BS = 85e6, 400, 20


# ------------------------------------------------------------- resolution
@pytest.mark.parametrize("n,devices,mode,knobs,expected", [
    # single device: always the scanned engines, any N
    (1_000, 1, "auto", {}, "scanned"),
    (10_000_000, 1, "auto", {}, "scanned"),
    (10_000_000, 1, "auto", {"buffer_size": 4}, "async-scanned"),
    # multi-device: the cutover decides
    (10_000, 8, "auto", {}, "scanned"),
    (65_536, 8, "auto", {}, "scanned"),
    (ENGINE_CUTOVER_N - 1, 8, "auto", {}, "scanned"),
    (ENGINE_CUTOVER_N, 8, "auto", {}, "sharded"),
    (4_194_304, 8, "auto", {}, "sharded"),
    (4_194_304, 2, "auto", {}, "sharded"),
    # the async family rides the same placement rule
    (10_000, 8, "auto", {"buffer_size": 4}, "async-scanned"),
    (ENGINE_CUTOVER_N, 8, "auto", {"max_concurrency": 32},
     "async-sharded"),
    (ENGINE_CUTOVER_N, 8, "async", {}, "async-sharded"),
    (10_000, 8, "async", {}, "async-scanned"),
    (ENGINE_CUTOVER_N, 8, "sync", {}, "sharded"),
    (1_000, 4, "sync", {}, "scanned"),
])
def test_resolve_engine_matrix(n, devices, mode, knobs, expected):
    assert resolve_engine(n, devices, mode=mode, **knobs) == expected
    assert jsim.resolve_engine(n, devices, mode=mode, **knobs) == expected


def test_resolve_engine_forced_names_short_circuit():
    for name in ENGINES:
        assert resolve_engine(7, 1, mode=name) == name
        assert resolve_engine(10_000_000, 64, mode=name) == name


def test_resolve_engine_cutover_override():
    assert resolve_engine(1_000, 8, cutover_n=500) == "sharded"
    assert resolve_engine(499, 8, cutover_n=500) == "scanned"
    assert resolve_engine(1_000_000, 8, cutover_n=2_000_000) == "scanned"


def test_resolve_aggregation():
    assert resolve_aggregation("auto") == "sync"
    assert resolve_aggregation("auto", buffer_size=3) == "async"
    assert resolve_aggregation("auto", max_concurrency=12) == "async"
    assert resolve_aggregation("sync", buffer_size=3) == "sync"
    assert resolve_aggregation("async") == "async"
    assert resolve_aggregation("sharded") == "sync"
    assert resolve_aggregation("async-sharded") == "async"
    with pytest.raises(ValueError, match="unknown mode"):
        resolve_aggregation("turbo")


MODES = ("auto", "sync", "async") + ENGINES
KNOBS = ({}, {"buffer_size": 4}, {"max_concurrency": 32},
         {"buffer_size": 2, "max_concurrency": 8})
SIZES = (1, 7, 10_000, ENGINE_CUTOVER_N - 1, ENGINE_CUTOVER_N, 4_194_304)


def _outcome(fn, *a, **kw):
    try:
        return fn(*a, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


def test_resolvers_equal_the_reference_everywhere():
    """Every (n, devices 1-8, mode, knobs, cutover) and every training
    engine name: the same answer, or the same ``ValueError`` text."""
    for n, d, mode, knobs, cut in itertools.product(
            SIZES, range(1, 9), MODES + ("warp",), KNOBS,
            (None, 500, 2_000_000)):
        assert _outcome(resolve_engine, n, d, mode=mode, cutover_n=cut,
                        **knobs) == \
            _outcome(jsim.resolve_engine, n, d, mode=mode, cutover_n=cut,
                     **knobs), (n, d, mode, knobs, cut)
    for mode, knobs in itertools.product(MODES + ("warp",), KNOBS):
        assert _outcome(resolve_aggregation, mode, **knobs) == \
            _outcome(jsim.resolve_aggregation, mode, **knobs)
    for n, d, mode, engine in itertools.product(
            SIZES, range(1, 9), ("sync", "async"),
            ("auto",) + TRAIN_ENGINES + ("turbo",)):
        assert _outcome(resolve_train_engine, n, d, mode=mode,
                        engine=engine) == \
            _outcome(jsim.resolve_train_engine, n, d, mode=mode,
                     engine=engine), (n, d, mode, engine)


def test_default_device_count_is_the_world_size(monkeypatch):
    """Without ``torch.distributed`` a run plans for one device, whatever
    the host holds; inside a group of 4 processes it plans for 4."""
    assert tsim.world_size() == 1
    assert resolve_engine(4_194_304) == "scanned"
    assert resolve_train_engine(10, mode="async") == "scanned"
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    assert tsim.world_size() == 4
    assert resolve_engine(4_194_304) == "sharded"
    assert resolve_engine(10_000) == "scanned"
    assert resolve_train_engine(10, mode="async") == "sharded"
    assert resolve_train_engine(10, mode="sync") == "host"


def _args(n=32):
    cfg = SelectorConfig(kind="eafl", k=4)
    pop = make_population(prng.PRNGKey(0, "cpu"), n)
    return (prng.PRNGKey(0, "cpu"), cfg, pop, SelectorState.create(cfg),
            EnergyModel(), MB, STEPS, BS, 2)


def test_run_rounds_rejects_bad_combinations():
    args = _args()
    with pytest.raises(ValueError, match="unknown mode"):
        run_rounds(*args, mode="warp")
    with pytest.raises(ValueError, match="async knobs"):
        run_rounds(*args, mode="scanned", buffer_size=2)
    with pytest.raises(ValueError, match="async knobs"):
        run_rounds(*args, mode="sync", max_concurrency=8)
    # a forced single-device engine name and an explicit mesh contradict
    # each other: neither may be silently ignored
    with pytest.raises(ValueError, match="single-device"):
        run_rounds(*args, mode="scanned", n_shards=1)
    with pytest.raises(ValueError, match="single-device"):
        run_rounds(*args, mode="async-scanned", n_shards=1, buffer_size=2)
    # the reference's order: the mode first, then the mesh, then the knobs
    with pytest.raises(ValueError, match="unknown mode"):
        run_rounds(*args, mode="warp", n_shards=1, buffer_size=2)
    with pytest.raises(ValueError, match="single-device"):
        run_rounds(*args, mode="scanned", n_shards=1, buffer_size=2)


@pytest.mark.parametrize("mode,kw", [
    ("sharded", {}), ("async-sharded", {"buffer_size": 2}),
    ("auto", {"n_shards": 1}), ("auto", {"n_shards": 2, "buffer_size": 2}),
    ("sync", {"n_shards": 4})])
def test_sharded_legs_raise_item_13(mode, kw):
    with pytest.raises(NotImplementedError, match="item 13"):
        run_rounds(*_args(), mode=mode, **kw)


# --------------------------------------------- forced-engine trajectories
def _pop(n=128):
    pop = make_population(prng.PRNGKey(0, "cpu"), n, init_battery_low=15.0,
                          init_battery_high=90.0)
    return pop.replace(stat_util=prng.uniform(
        prng.fold_in(prng.PRNGKey(0, "cpu"), 1), (n,)) * 10)


def _run(mode, **kw):
    cfg = SelectorConfig(kind="eafl", k=8)
    return run_rounds(prng.PRNGKey(0, "cpu"), cfg, _pop(),
                      SelectorState.create(cfg), EnergyModel(), MB, STEPS,
                      BS, 5, mode=mode, **kw)


ASYNC = dict(buffer_size=3, max_concurrency=9, staleness_power=0.5)


def _same(t1, t2):
    for f in t1:
        if f not in ("engine", "final_event_state"):
            np.testing.assert_array_equal(np.asarray(t1[f]),
                                          np.asarray(t2[f]), f)


def test_forced_engines_equal_direct_calls():
    cfg = SelectorConfig(kind="eafl", k=8)
    args = (prng.PRNGKey(0, "cpu"), cfg, _pop(), SelectorState.create(cfg),
            EnergyModel(), MB, STEPS, BS, 5)
    _, _, t = _run("scanned")
    assert t["engine"] == "scanned"
    _same(t, tsim.run_rounds_scanned(*args)[2])
    _, _, t = _run("async-scanned", **ASYNC)
    assert t["engine"] == "async-scanned"
    _same(t, tsim.run_async_scanned(*args, **ASYNC)[2])


def test_auto_resolves_to_scanned_on_one_device_and_matches_forced():
    _, _, t_auto = _run("auto")
    _, _, t_forced = _run("scanned")
    assert t_auto["engine"] == "scanned"
    np.testing.assert_array_equal(t_auto["selected"], t_forced["selected"])


def test_auto_with_async_knobs_runs_async():
    _, _, t = _run("auto", buffer_size=3, max_concurrency=9)
    assert t["engine"] == "async-scanned"
    assert "staleness" in t and "server_clock" in t


@pytest.mark.parametrize("mode,kw", [("scanned", {}),
                                     ("async-scanned", ASYNC)])
def test_run_rounds_matches_the_reference(mode, kw):
    """The same population and key through both packages' front doors:
    the engine's name and the selection columns index for index."""
    n = 96
    jpop = jclients.make_population(jax.random.PRNGKey(4), n,
                                    init_battery_low=15.0,
                                    init_battery_high=90.0)
    jpop = jpop.replace(stat_util=jax.random.uniform(
        jax.random.PRNGKey(5), (n,)) * 10)
    f = {k: np.asarray(getattr(jpop, k))
         for k in jpop.__dataclass_fields__}
    tpop = convert.population(f, "cpu")
    jkey = jax.random.PRNGKey(6)
    jcfg = jsel.SelectorConfig("eafl", k=8)
    tcfg = SelectorConfig("eafl", k=8)
    _, _, jt = jsim.run_rounds(jkey, jcfg, jpop,
                               jsel.SelectorState.create(jcfg), JEnergy(),
                               MB, STEPS, BS, 4, mode=mode, **kw)
    _, _, tt = run_rounds(convert.key(jkey, "cpu"), tcfg, tpop,
                          SelectorState.create(tcfg), EnergyModel(), MB,
                          STEPS, BS, 4, mode=mode, **kw)
    assert tt["engine"] == jt["engine"] == mode
    cols = ("selected", "chosen", "succeeded", "total_dropped")
    if mode == "async-scanned":
        cols += ("completed", "comp_chosen", "staleness", "n_inflight")
    for c in cols:
        np.testing.assert_array_equal(tt[c], np.asarray(jt[c]), c)
    np.testing.assert_allclose(tt["round_duration"],
                               np.asarray(jt["round_duration"]), rtol=1e-6)


# --------------------------------------------------- FLConfig-level auto
def _flcfg(**kw):
    base = dict(
        selector=SelectorConfig(kind="eafl", k=4),
        n_clients=16, rounds=4, local_steps=2, batch_size=8,
        samples_per_client=16, eval_every=4, eval_samples=40,
        model=reduced(), input_hw=16,
        sim_model_bytes=85e6, sim_local_steps=400)
    base.update(kw)
    return FLConfig(**base)


def test_run_fl_auto_matches_explicit_modes():
    """``run_fl``'s default ``mode="auto"`` routes a knob-free config to
    the sync loop and a buffered one to the async engine, bit-identical to
    forcing the mode."""
    h_auto = run_fl(_flcfg(), device="cpu")
    h_sync = run_fl(_flcfg(), mode="sync", device="cpu")
    assert h_auto.wall_hours == h_sync.wall_hours
    assert h_auto.test_acc == h_sync.test_acc

    acfg = dict(buffer_size=2, max_concurrency=6)
    h_auto = run_fl(_flcfg(**acfg), device="cpu")
    h_async = run_fl(_flcfg(**acfg), mode="async", device="cpu")
    assert h_auto.wall_hours == h_async.wall_hours
    assert h_auto.test_acc == h_async.test_acc
    # the async loop's wall clock is the event clock, not a round barrier
    assert h_auto.wall_hours != h_sync.wall_hours


def test_run_fl_rejects_engine_names():
    for name in ENGINES:
        with pytest.raises(ValueError, match="engine name"):
            run_fl(_flcfg(), mode=name, device="cpu")
    with pytest.raises(ValueError, match="unknown training engine"):
        run_fl(_flcfg(), engine="turbo", device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        run_fl(_flcfg(), mode="turbo", device="cpu")


def test_run_selection_scanned_reports_engine():
    _, traj = run_selection_scanned(_flcfg(), rounds=3, device="cpu")
    assert traj["engine"] == "scanned"
    _, traj = run_selection_scanned(_flcfg(buffer_size=2), rounds=3,
                                    device="cpu")
    assert traj["engine"] == "async-scanned"
    with pytest.raises(NotImplementedError, match="item 13"):
        run_selection_scanned(_flcfg(), rounds=3, n_shards=1, device="cpu")


def test_no_item_12_or_14_refusal_is_left():
    """The controller (item 12) and the dispatch (item 14) have landed:
    no message of the port names them any more."""
    pkg = Path(tsim.__file__).resolve().parents[1]
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"item 1[24]\b", text), path
