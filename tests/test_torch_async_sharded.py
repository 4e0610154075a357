"""The port's sharded FedBuff engines on the CPU: ``run_async_sharded``
and ``run_fl_async_sharded`` over a ``clients`` mesh of D virtual shards
in one process, or of two gloo ranks.

* ``run_async_sharded`` on D = 1, 2, 3 and 8 shards equals
  ``run_async_scanned`` (``launch/sharded_check.py``'s async matrix: all
  four kinds buffered, the sync limit, a tight deadline that abandons, a
  flush in which every client dies; populations with a padded tail): the
  flush, refill, staleness and in-flight columns, the wall clock and the
  damping weights equal, the final event and selector states equal, the
  summed statistics and batteries within rtol 1e-6;
* on 1 and 3 shards it equals the reference's ``run_async_sharded`` on a
  one-device mesh (index columns equal, floats within rtol 1e-6), and
  ``"async"`` snapshots cross shard counts, engines and packages;
* ``run_fl_async_sharded`` is ``run_fl_async_scanned`` bitwise on one
  shard and, on three, exact on the bookkeeping with the floats within
  ``CLOSE`` (rtol 1e-5) and ``LOOSE`` (rtol 2e-3), in a case with a
  deadline that abandons, a budget that refuses and recharge; it meets
  the reference's ``run_fl_async_sharded`` on a one-device mesh (the
  reference's draws) within the same tolerances, and ``"train-async"``
  snapshots cross shard counts, engines and packages;
* the fill and the aggregation steps on three shards read nothing on the
  host; two gloo ranks equal two virtual shards.
"""
import functools
import multiprocessing as mp
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro.core.energy import EnergyModel as JEnergy  # noqa: E402
from repro.federated import async_server as jasync  # noqa: E402
from repro.federated import simulation as jsim  # noqa: E402
from repro.launch.mesh import make_client_mesh as jmesh  # noqa: E402
import torch_gloo_rank  # noqa: E402
from test_torch_async_training import (TRACE, _assert_traces_equal,  # noqa: E402
                                       _cfg, _jcfg, _rows)
from test_torch_server import _patch_reference_draws  # noqa: E402
from test_torch_sharded import _assert_close, _jmixed_pop  # noqa: E402
from test_torch_training_engines import (NoHostRead,  # noqa: E402,F401
                                         _assert_bitwise, one_thread)
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core.clients import make_population  # noqa: E402
from repro_torch.core.energy import EnergyModel  # noqa: E402
from repro_torch.core.selection import (SelectorConfig,  # noqa: E402
                                        SelectorState)
from repro_torch.federated import async_server as tasync  # noqa: E402
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated import simulation as tsim  # noqa: E402
from repro_torch.federated.replay import StepGraphs  # noqa: E402
from repro_torch.launch import sharded_check  # noqa: E402
from repro_torch.launch.mesh import ClientMesh  # noqa: E402
from repro_torch.launch.sharding import (population_sharding,  # noqa: E402
                                         shard_clients)

MB, STEPS, BS = 85e6, 400, 20
KINDS = ("eafl", "oort", "eafl-epj", "random")
EXACT = ("completed", "comp_chosen", "succeeded", "staleness", "selected",
         "chosen", "fill_selected", "fill_chosen", "total_dropped",
         "n_inflight", "new_dropouts", "round_duration", "server_clock",
         "agg_weight")
SUMMED = ("mean_battery", "energy_spent_pct", "energy_spent_j")


# ------------------------------------------------------ selection engine
def _matrix_case(case):
    """``(label, cfg, pop, kwargs)`` of one case of ``sharded_check``'s
    async matrix, at 203 clients (a padded tail on 2, 3 and 8 shards)
    and, for the flush in which every client dies, 253."""
    key = prng.PRNGKey(7, "cpu")
    n = 203
    pop = sharded_check.mixed_pop(key, n).replace(
        dropped=torch.zeros(n, dtype=torch.bool))
    kw = dict(buffer_size=3, max_concurrency=9)
    if case.startswith("buffered"):
        return SelectorConfig(case.split(" ")[1], k=10), pop, kw
    if case == "sync-limit":
        return SelectorConfig("oort", k=10), pop, dict(
            buffer_size=10, max_concurrency=10, staleness_power=0.0)
    if case == "tight-deadline":
        return SelectorConfig("eafl", k=10), pop, dict(
            kw, deadline_s=400.0, require_abandoned=True)
    low = make_population(key, 253, init_battery_low=1.0,
                          init_battery_high=12.0).replace(
        stat_util=prng.uniform(prng.fold_in(key, 8), (253,)) * 10)
    return SelectorConfig("eafl", k=8), low, dict(
        buffer_size=2, max_concurrency=8, deadline_s=1e6,
        require_abandoned=True, local_steps=1600)


@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("case", [f"buffered {k}" for k in KINDS]
                         + ["sync-limit", "tight-deadline", "flush-dies"])
def test_run_async_sharded_matches_scanned(case, d):
    cfg, pop, kw = _matrix_case(case)
    sharded_check._check_async(f"{case} D={d}", ClientMesh(d), cfg, pop,
                               prng.fold_in(prng.PRNGKey(7, "cpu"), 6),
                               EnergyModel(), rounds=5, **kw)


def _sel_run(engine, pop, rounds=6, **kw):
    cfg = SelectorConfig("eafl", k=10)
    fn = (tsim.run_async_scanned if engine == "scanned"
          else tsim.run_async_sharded)
    return fn(convert.key(jax.random.PRNGKey(9), "cpu"), cfg, pop,
              SelectorState.create(cfg), EnergyModel(0.02), MB, STEPS, BS,
              rounds, buffer_size=3, max_concurrency=9, deadline_s=400.0,
              **kw)


def _assert_sel_equal(a, b, rtol=0.0):
    """Two async selection runs: the index columns, the wall clock, the
    damping weights, the event state's clocks and versions and the
    dropouts equal; the summed floats and batteries within ``rtol`` (1e-6
    across packages, where the durations may also differ in the last
    bit)."""
    (pa, sa, ta), (pb, sb, tb) = a, b
    for f in EXACT:
        x, y = np.asarray(ta[f]), np.asarray(tb[f])
        if rtol and x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=rtol, err_msg=f)
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in SUMMED:
        np.testing.assert_allclose(ta[f], tb[f], rtol=1e-6, err_msg=f)
    ea, eb = ta["final_event_state"], tb["final_event_state"]
    np.testing.assert_array_equal(np.asarray(ea.start_version),
                                  np.asarray(eb.start_version))
    np.testing.assert_allclose(np.asarray(ea.t_done), np.asarray(eb.t_done),
                               rtol=rtol)
    assert int(ea.server_version) == int(eb.server_version)
    np.testing.assert_allclose(np.asarray(pa.battery_pct),
                               np.asarray(pb.battery_pct), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(pa.dropped),
                                  np.asarray(pb.dropped))
    assert int(sa.round) == int(sb.round)
    for f in ("epsilon", "pacer_T", "util_ema"):
        np.testing.assert_allclose(float(getattr(sa, f)),
                                   float(getattr(sb, f)), rtol=1e-6)


@pytest.fixture(scope="module")
def reference_async(tmp_path_factory):
    """The reference's ``run_async_sharded`` on a one-device mesh, on its
    population, with an ``"async"`` snapshot after aggregations 2 and 4."""
    path = str(tmp_path_factory.mktemp("ref") / "async-{round}.ckpt")
    jpop, tpop = _jmixed_pop(5, 203)
    jcfg = jsel.SelectorConfig("eafl", k=10)
    out = jsim.run_async_sharded(
        jax.random.PRNGKey(9), jcfg, jpop, jsel.SelectorState.create(jcfg),
        JEnergy(0.02), MB, STEPS, BS, 6, buffer_size=3, max_concurrency=9,
        deadline_s=400.0, mesh=jmesh(1), checkpoint_path=path,
        checkpoint_every=2)
    return out, tpop, path


@pytest.mark.parametrize("d", [1, 3])
def test_run_async_sharded_matches_reference_one_shard(reference_async, d):
    ref, tpop, _ = reference_async
    out = _sel_run("sharded", tpop, n_shards=d)
    assert np.asarray(ref[2]["staleness"]).max() > 0
    assert (~np.asarray(ref[2]["succeeded"])[
        np.asarray(ref[2]["comp_chosen"])]).any()
    _assert_sel_equal(out, ref, rtol=1e-6)


def test_async_snapshots_cross_shard_counts_engines_and_packages(
        reference_async, tmp_path):
    """A D = 3 snapshot resumes on 8 shards and in the single-device
    engine, a single-device one on 2 shards, each equal to the
    uninterrupted run; the reference's one-device-mesh snapshot resumes
    on 1 and 3 shards and in the single-device engine, each equal to the
    reference's uninterrupted run."""
    ref, tpop, ref_path = reference_async
    whole = _sel_run("scanned", tpop)
    p3 = str(tmp_path / "sh-{round}.ckpt")
    _sel_run("sharded", tpop, mesh=ClientMesh(3), checkpoint_every=2,
             checkpoint_path=p3)
    p1 = str(tmp_path / "sc-{round}.ckpt")
    _sel_run("scanned", tpop, checkpoint_every=3, checkpoint_path=p1)
    _assert_sel_equal(whole, _sel_run("sharded", tpop, n_shards=8,
                                      resume_from=p3.format(round=4)))
    _assert_sel_equal(whole, _sel_run("scanned", tpop,
                                      resume_from=p3.format(round=2)))
    _assert_sel_equal(whole, _sel_run("sharded", tpop, n_shards=2,
                                      resume_from=p1.format(round=3)))
    for d in (1, 3, None):
        kw = {} if d is None else {"n_shards": d}
        out = _sel_run("scanned" if d is None else "sharded", tpop,
                       resume_from=ref_path.format(round=4), **kw)
        _assert_sel_equal(out, ref, rtol=1e-6)


# -------------------------------------------------------------- trainer
# a deadline that abandons arrivals, a budget that refuses a refill at
# aggregation 5, and recharge, over 6 aggregations of flushes of 3
CASE = dict(deadline_s=600.0, sim_model_bytes=85e6, sim_local_steps=1600,
            energy_budget_j=60_000.0, recharge_pct_per_hour=30.0,
            plugged_frac=0.4)


@functools.lru_cache(maxsize=None)
def _scanned():
    cap = {}
    return tasync.run_fl_async_scanned(_cfg(**CASE), device="cpu",
                                       _capture=cap), cap["traj"]


@pytest.mark.parametrize("d", [1, 3])
def test_run_fl_async_sharded_matches_scanned(d):
    """On one shard the sharded trainer is the fused engine bitwise; on
    three the flush is split by shard and the aggregate reduced in
    another order: the flush, refill and version columns equal, the
    bookkeeping exact, the floats within CLOSE and LOOSE."""
    ref, ref_traj = _scanned()
    cap = {}
    out = tasync.run_fl_async_sharded(_cfg(**CASE), n_shards=d,
                                      device="cpu", _capture=cap)
    assert ref.budget_exhausted_round is not None
    assert ref_traj["staleness"].max() > 0
    assert (ref_traj["comp_chosen"] & ~ref_traj["succeeded"]).any()
    assert len(ref.round) == 6
    for f in TRACE + ("agg_weight", "server_version", "n_inflight",
                      "server_clock", "round_duration", "new_dropouts"):
        assert np.array_equal(cap["traj"][f], ref_traj[f]), f
    (_assert_bitwise if d == 1 else _assert_close)(ref, out)


@pytest.fixture(scope="module")
def reference_trainer(tmp_path_factory):
    """The reference's ``run_fl_async_sharded`` on a one-device mesh, its
    trajectory, and a ``train-async`` snapshot after aggregation 3."""
    path = str(tmp_path_factory.mktemp("ref") / "train-{round}.ckpt")
    cap = {}
    hist = jasync.run_fl_async_sharded(
        _jcfg(**CASE, checkpoint_path=path, checkpoint_every=3),
        mesh=jmesh(1), _capture=cap)
    return hist, cap["traj"], path


EXACT_HIST = ("round", "cum_dropouts", "quarantined", "update_skipped",
              "budget_exhausted_round")


@pytest.mark.parametrize("d", [1, 3])
def test_run_fl_async_sharded_matches_reference_one_shard(
        reference_trainer, monkeypatch, d):
    """On the reference's draws: the flush and refill columns equal the
    reference's sharded trainer's, the damping weights bit for bit, the
    history within CLOSE and LOOSE."""
    ref, ref_traj, _ = reference_trainer
    _patch_reference_draws(monkeypatch, _jcfg(**CASE))
    cap = {}
    out = tasync.run_fl_async_sharded(_cfg(**CASE), n_shards=d,
                                      device="cpu", _capture=cap)
    _assert_traces_equal(_rows(cap["traj"], 6),
                         _rows({k: np.asarray(v) for k, v in
                                ref_traj.items()}, 6))
    _assert_close(ref, out, exact=EXACT_HIST)


@pytest.mark.parametrize("engine,d", [("sharded", 1), ("sharded", 3),
                                      ("scanned", None)])
def test_reference_train_async_snapshot_resumes_here(
        reference_trainer, monkeypatch, engine, d):
    """The reference's sharded ``train-async`` snapshot after aggregation
    3 (event state and selection ranks trimmed, the ring and both keys in
    the carry) continues on 1 and 3 shards and in the fused engine, and
    the run meets the reference's uninterrupted one."""
    ref, _, path = reference_trainer
    _patch_reference_draws(monkeypatch, _jcfg(**CASE))
    cfg = _cfg(**CASE, resume_from=path.format(round=3))
    out = (tasync.run_fl_async_sharded(cfg, n_shards=d, device="cpu")
           if engine == "sharded" else
           tasync.run_fl_async_scanned(cfg, device="cpu"))
    _assert_close(ref, out, exact=EXACT_HIST)


def test_train_async_snapshots_cross_shard_counts_and_engines(tmp_path):
    """A 3-shard ``train-async`` snapshot resumes on 2 shards and in the
    fused engine; a fused-engine snapshot resumes on 3 shards; one shard
    continuing the fused engine's snapshot equals it bitwise."""
    whole, _ = _scanned()
    sh = str(tmp_path / "sh-{round}.ckpt")
    sc = str(tmp_path / "sc-{round}.ckpt")
    tasync.run_fl_async_sharded(_cfg(**CASE, checkpoint_path=sh,
                                     checkpoint_every=2), n_shards=3,
                                device="cpu")
    tasync.run_fl_async_scanned(_cfg(**CASE, checkpoint_path=sc,
                                     checkpoint_every=2), device="cpu")

    def resume(p):
        return _cfg(**CASE, resume_from=p)

    _assert_close(whole, tasync.run_fl_async_sharded(
        resume(sh.format(round=2)), n_shards=2, device="cpu"))
    _assert_close(whole, tasync.run_fl_async_scanned(
        resume(sh.format(round=4)), device="cpu"))
    _assert_close(whole, tasync.run_fl_async_sharded(
        resume(sc.format(round=2)), n_shards=3, device="cpu"))
    _assert_bitwise(whole, tasync.run_fl_async_sharded(
        resume(sc.format(round=4)), n_shards=1, device="cpu"))


# ------------------------------------------------------------ host reads
@pytest.mark.parametrize("step", ["selection", "training"])
def test_async_steps_read_nothing_on_the_host(step):
    """The fill and the aggregation steps on three shards under the
    dispatch mode that raises on any host read or host-data tensor."""
    mesh = ClientMesh(3)
    if step == "training":
        cfg = _cfg(**CASE)
        (kloop, data, test, params, opt, opt_state, pop, sim_steps,
         up_bytes, em, mb) = tserver._fused_setup(cfg, torch.device("cpu"))
        fill, agg_fn, eval_fn = tasync._async_fused_runner(
            cfg, em, sim_steps, mb, up_bytes, opt, mesh,
            shard_clients(data["x"], mesh), shard_clients(data["y"], mesh),
            test["x"], test["y"])
        args = (kloop, params, opt_state, population_sharding(mesh)(pop),
                SelectorState.create(cfg.selector).canonical("cpu"),
                torch.zeros(()))
        fill(*args)             # makes the tables
        with NoHostRead():
            carry0 = fill(*args)
        graphs = StepGraphs(carry0, cfg.rounds)
        graphs.add("agg", agg_fn, advance=True)
        graphs.add("eval", eval_fn, row=-1)
        graphs.run("agg")       # makes the damping table, as the warm-up
        with NoHostRead():
            for _ in range(3):
                graphs.run("agg")
                graphs.run("eval")
        assert graphs.fetch(0, 4)["completed"].shape == (4, 3)
        return
    cfg, pop, _ = _matrix_case("tight-deadline")
    init_fill, agg = tsim.make_async_round_engine(
        cfg, EnergyModel(), MB, STEPS, BS, buffer_size=3, max_concurrency=9,
        deadline_s=400.0, energy_budget_j=5e5, mesh=mesh, n_real=pop.n)
    key0, keys, refill = tsim._async_xs(prng.PRNGKey(3, "cpu"), 4)
    spop = population_sharding(mesh)(pop)
    st0 = SelectorState.create(cfg).canonical("cpu")
    astate0 = tsim._astate_put(tsim.AsyncEventState.create(pop.n, "cpu"),
                               mesh)
    init_fill(key0, spop, st0, astate0)     # makes the tables
    with NoHostRead():
        st, astate, _, _ = init_fill(key0, spop, st0, astate0)
    graphs = tsim._async_graphs(agg, keys, refill,
                                {"pop": spop, "st": st, "astate": astate},
                                4, 0, mesh, pop.n)
    graphs.run("agg")
    with NoHostRead():
        for _ in range(3):
            graphs.run("agg")
    traj = graphs.fetch(0, 4)
    assert traj["completed"].shape == (4, 3)
    assert traj["chosen"][-1].sum() == 0        # the last flush refills none


# ------------------------------------------------------------ gloo ranks
def test_gloo_ranks_equal_the_virtual_mesh():
    """Two gloo ranks (one shard each, spawned) running
    ``run_async_sharded`` equal two virtual shards in one process, on
    every rank, with a snapshot written by rank 0 alone."""
    cfg, pop, _ = _matrix_case("buffered eafl")
    args = (prng.PRNGKey(9, "cpu"), cfg, pop, SelectorState.create(cfg),
            EnergyModel(0.02), MB, STEPS, BS, 5)
    kw = dict(buffer_size=3, max_concurrency=9, deadline_s=600.0)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    fd, store = tempfile.mkstemp()
    os.close(fd)
    os.unlink(store)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "gloo-{round}.ckpt")
        procs = [ctx.Process(target=torch_gloo_rank.run_async_rank,
                             args=(r, 2, f"file://{store}", queue, args,
                                   dict(kw, checkpoint_path=ck,
                                        checkpoint_every=5)))
                 for r in range(2)]
        try:
            for p in procs:
                p.start()
            results = [queue.get(timeout=180) for _ in procs]
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
            if os.path.exists(store):
                os.unlink(store)
        assert all(p.exitcode == 0 for p in procs)
        assert os.path.exists(ck.format(round=5))
        pop_v, _, traj = tsim.run_async_sharded(*args, **kw, n_shards=2)
        resumed = tsim.run_async_scanned(*args, **kw,
                                         resume_from=ck.format(round=5))
    assert sorted(r for r, *_ in results) == [0, 1]
    for _, t, battery, t_done in results:
        for f in EXACT:
            np.testing.assert_array_equal(t[f], traj[f], f)
        np.testing.assert_array_equal(battery, pop_v.battery_pct.numpy())
        np.testing.assert_array_equal(
            t_done, traj["final_event_state"].t_done.numpy())
    for f in EXACT:
        np.testing.assert_array_equal(resumed[2][f], traj[f], f)


# ------------------------------------------------- the card's fault plants
def test_chip_faults_async_shard_faults_replace_live_functions():
    """Each planted fault of the sharded async engine (``chip_faults.py``)
    names a function its module reads, changes what that function returns
    on a 2-shard mesh and leaves the one-device call alone, and must fail
    phase 6n on the column it names."""
    import importlib
    from test_torch_isolation import _load
    _load("chip_smoke")
    faults = _load("chip_faults").ASYNC_SHARD_FAULTS
    mesh = ClientMesh(2)
    # equal values in both shards: the merge keeps the lower indices; the
    # start versions of a slot owned by the second shard
    g = torch.tensor([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0]])
    versions = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    slots = torch.tensor([4, 1])
    inputs = {
        "_merge_topk": ((g, 3, 3, mesh.bases(3, "cpu"), mesh), {}),
        "_slot_gather": ((versions, slots, torch.ones(2, dtype=torch.bool),
                          mesh), {"dtype": torch.int32}),
    }
    assert set(faults) == {"async_flush_merge_shards_reversed",
                           "async_start_version_read_locally"}
    for modules, attr, make_fault, phase, column in faults.values():
        assert phase == "6n" and column in ("completed", "staleness")
        module = importlib.import_module(modules[0])
        sound = getattr(module, attr)
        args, kw = inputs[attr]
        assert not torch.equal(make_fault(sound)(*args, **kw),
                               sound(*args, **kw)), attr
    plant = faults["async_start_version_read_locally"][2](tsim._slot_gather)
    one = (versions.reshape(-1), slots, torch.ones(2, dtype=torch.bool))
    assert torch.equal(plant(*one, dtype=torch.int32),
                       tsim._slot_gather(*one, dtype=torch.int32))
