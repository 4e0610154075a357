"""The port's sharded synchronous engines on the CPU.

A ``clients`` mesh (``repro_torch.launch.mesh``) of D virtual shards in
one process, or of two gloo ranks, against the port's single-device
engines and against the reference's sharded functions on a one-shard
mesh in this process:

* ``pad_population`` equals the reference's; ``minmax_range`` over a
  mesh (the reference's ``minmax_range_shard``) equals it bitwise; a shard's slice of a prefix-stable
  draw equals the global draw's;
* the sharded select step equals the reference's
  ``make_sharded_select_step`` (all four kinds, both routes; the
  state's floats within rtol 1e-6, as the single-device step's) and, on
  D = 1, 2, 3 and 8 shards, the single-device step: a padded tail, ties,
  an all-dropped first shard, an all-dropped population, k > n_loc;
* ``run_rounds_sharded`` (faults on) equals ``run_rounds_scanned`` on
  ``selected``/``chosen``/``succeeded``/``corrupt``, retries, dropouts,
  durations and battery; summed floats within rtol 1e-6;
* ``run_fl_sharded`` equals ``run_fl_scanned`` bitwise on one shard and,
  on three, exactly on the bookkeeping (``EXACT``) with the floats within
  the tolerances of the fused engine's own tests (``CLOSE`` rtol 1e-5,
  ``LOOSE`` rtol 2e-3); against the reference's ``run_fl_sharded`` on the
  reference's draws within the same tolerances;
* snapshots resume across shard counts, engines and packages; the round
  steps read nothing on the host; two gloo ranks equal two virtual
  shards.
"""
import dataclasses
import functools
import multiprocessing as mp
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import clients as jclients  # noqa: E402
from repro.core import rewards as jrewards  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core.energy import EnergyModel as JEnergy  # noqa: E402
from repro.federated import server as jserver  # noqa: E402
from repro.federated import simulation as jsim  # noqa: E402
from repro.federated.faults import FaultConfig as JFaults  # noqa: E402
from repro.launch.mesh import make_client_mesh as jmesh  # noqa: E402
import torch_gloo_rank  # noqa: E402
from test_torch_server import _cfgs, _patch_reference_draws  # noqa: E402
from test_torch_training_engines import (CLOSE, EXACT, FAULTS,  # noqa: E402
                                         LOOSE, NoHostRead, _assert_bitwise,
                                         _cfg, one_thread)  # noqa: F401
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import rewards  # noqa: E402
from repro_torch.core.clients import pad_population  # noqa: E402
from repro_torch.core.energy import EnergyModel  # noqa: E402
from repro_torch.core.selection import (SelectorConfig,  # noqa: E402
                                        SelectorState, _rank_bits,
                                        make_sharded_select_step)
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated import simulation as tsim  # noqa: E402
from repro_torch.examples import million_client_selection  # noqa: E402
from repro_torch.federated.faults import (FaultConfig,  # noqa: E402
                                          fault_streams)
from repro_torch.federated.replay import StepGraphs  # noqa: E402
from repro_torch.launch import sharded_check  # noqa: E402
from repro_torch.launch.mesh import ClientMesh  # noqa: E402
from repro_torch.launch.sharding import population_sharding  # noqa: E402

MB, STEPS, BS = 85e6, 400, 20
KINDS = ("eafl", "oort", "eafl-epj", "random")
SEL_FAULTS = dict(seed=2, crash_prob=0.3, max_retries=2, straggle_prob=0.3,
                  corrupt_prob=0.2)


def _jkey(key):
    return jnp.asarray(key.numpy().astype(np.uint32))


@functools.lru_cache(maxsize=None)
def _jmixed_pop(seed, n):
    """The reference's ``sharded_check._mixed_pop`` (its draws), and the
    port's copy of it."""
    jkey = jax.random.PRNGKey(seed)
    pop = jclients.make_population(jkey, n)
    ks = jax.random.split(jax.random.fold_in(jkey, 1), 3)
    pop = pop.replace(stat_util=jax.random.uniform(ks[0], (n,)) * 10,
                      explored=jax.random.bernoulli(ks[1], 0.6, (n,)),
                      dropped=jax.random.bernoulli(ks[2], 0.08, (n,)))
    return pop, convert.population(pop, "cpu")


# ---------------------------------------------------------------- pieces
@pytest.mark.parametrize("n,multiple", [(5, 1), (7, 3), (999, 8),
                                        (1000, 8)])
def test_pad_population_matches_reference(n, multiple):
    jpop, tpop = _jmixed_pop(1, 1000)
    jpop = jax.tree.map(lambda x: x[:n], jpop)
    tpop = convert.population(jpop, "cpu")
    jpad = jclients.pad_population(jpop, multiple)
    tpad = pad_population(tpop, multiple)
    assert tpad.n == jpad.n == n + (-n) % multiple
    for f in jclients._FIELDS:
        np.testing.assert_array_equal(getattr(tpad, f).numpy(),
                                      np.asarray(getattr(jpad, f)), f)


@pytest.mark.parametrize("d", [1, 2, 3, 8])
def test_minmax_range_shard_is_bitwise(d):
    mesh = ClientMesh(d)
    n = mesh.n_padded(1001)
    x = prng.normal(prng.PRNGKey(3, "cpu"), (n,)) * 7
    valid = prng.bernoulli(prng.PRNGKey(4, "cpu"), 0.7, (n,))
    lo, rng = rewards.minmax_range(x, valid)
    lo_s, rng_s = rewards.minmax_range(x.reshape(d, -1),
                                       valid.reshape(d, -1), mesh)
    assert torch.equal(lo, lo_s) and torch.equal(rng, rng_s)
    jlo, jrng = jrewards.minmax_range(jnp.asarray(x.numpy()),
                                      jnp.asarray(valid.numpy()))
    assert float(jlo) == float(lo_s) and float(jrng) == float(rng_s)


def test_shard_slices_are_the_global_draw():
    """Prefix-stable streams: a rank that draws only its positions
    ``[base, base + n_loc)`` gets the global draw's slice, and the first
    ``n_real`` of a padded draw are the unpadded draw (the reference's
    partitionable threefry, bit for bit)."""
    key = prng.PRNGKey(11, "cpu")
    n_real, mesh = 1001, ClientMesh(4)
    n_pad = mesh.n_padded(n_real)
    full = _rank_bits(key, n_pad)
    jfull = (jax.random.bits(_jkey(key), (n_pad,), jnp.uint32) >> 9)
    np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))
    assert torch.equal(full[:n_real], _rank_bits(key, n_real))
    n_loc = n_pad // 4
    assert torch.equal(mesh.draw(lambda n, off: _rank_bits(key, n, off),
                                 n_loc), full.reshape(4, n_loc))
    for rank in range(4):
        # what rank `rank` of a four-rank group draws for its one shard
        got = _rank_bits(key, n_loc, rank * n_loc)
        assert torch.equal(got, full[rank * n_loc:(rank + 1) * n_loc])
        streams = fault_streams(FaultConfig(seed=3, crash_prob=0.5), 2,
                                n_loc, "cpu", rank * n_loc)
        whole = fault_streams(FaultConfig(seed=3, crash_prob=0.5), 2, n_pad,
                              "cpu")
        for s, w in zip(streams, whole):
            assert torch.equal(s, w[rank * n_loc:(rank + 1) * n_loc])


# ------------------------------------------------------- selection step
@pytest.mark.parametrize("kind,route", [(k, "plain") for k in KINDS]
                         + [("eafl", "kernel")])
def test_select_step_matches_reference_one_shard(kind, route):
    """The port's step on one virtual shard against the reference's
    ``make_sharded_select_step`` on a one-device mesh (its ``use_pallas``
    leg in interpret mode; the port's kernel leg is the plain version on
    the CPU)."""
    n, kernel = 999, route == "kernel"
    jkey = jax.random.PRNGKey(7)
    jpop, tpop = _jmixed_pop(7, n)
    jpred = jnp.abs(jax.random.normal(jax.random.fold_in(jkey, 2), (n,))) * 5
    tpred = convert.tensor(jpred, "cpu")
    cfg_j, cfg_t = jsel.SelectorConfig(kind, k=12), SelectorConfig(kind, k=12)
    jstep = jsel.make_sharded_select_step(cfg_j, jmesh(1), n,
                                          use_pallas=kernel, interpret=True)
    tstep = make_sharded_select_step(cfg_t, ClientMesh(1), n,
                                     use_kernel=kernel)
    jst = jsel.SelectorState.create(cfg_j).canonical()
    tst = SelectorState.create(cfg_t)
    for r in range(3):
        kr = jax.random.fold_in(jkey, 100 + r)
        ji, jc, jst = jstep(kr, jst, jpop, jpred)
        ti, tc, tst = tstep(convert.key(kr, "cpu"), tst, tpop, tpred)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ti.numpy()[tc.numpy()],
                                      np.asarray(ji)[np.asarray(jc)])
        # the state's floats within rtol 1e-6, as the single-device
        # step's against the reference's (test_torch_selection.py)
        assert int(tst.round) == int(jst.round)
        for f in ("epsilon", "pacer_T", "util_ema"):
            np.testing.assert_allclose(float(getattr(tst, f)),
                                       float(getattr(jst, f)), rtol=1e-6)


@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["padded", "divisible", "ties",
                                  "first-shard-dropped", "all-dropped",
                                  "k>n_loc", "kernel"])
def test_virtual_mesh_matches_single_device(case, d):
    """``sharded_check``'s matrix, case by case: every kind, several
    rounds, the D-shard step against the single-device ``_device_select``
    (indices, chosen masks and selector state equal)."""
    mesh, key = ClientMesh(d), prng.PRNGKey(7, "cpu")
    pred = lambda n, salt: sharded_check._pred(key, n, salt)  # noqa: E731
    kinds, k, rounds, kernel = KINDS, 12, 3, False
    if case in ("padded", "divisible"):
        n = 999 if case == "padded" else 1024
        pop = sharded_check.mixed_pop(key, n)
    elif case == "ties":
        n, kinds, k, rounds = 1024, ("eafl", "oort", "eafl-epj"), 16, 2
        pop = sharded_check.mixed_pop(key, n).replace(
            stat_util=torch.ones(n), last_duration=torch.ones(n),
            battery_pct=torch.full((n,), 80.0),
            explored=torch.ones(n, dtype=torch.bool),
            dropped=torch.zeros(n, dtype=torch.bool),
            last_round=torch.zeros(n, dtype=torch.int32))
    elif case in ("first-shard-dropped", "all-dropped"):
        n = 1024
        pop = sharded_check.mixed_pop(key, n)
        dropped = (torch.arange(n) < max(n // d, 1) if case[0] == "f"
                   else torch.ones(n, dtype=torch.bool))
        pop = pop.replace(dropped=dropped)
    elif case == "k>n_loc":
        n = 5 * d              # 5 clients a shard, k = 12
        pop = sharded_check.mixed_pop(key, n)
    else:
        n, kinds, kernel = 1000, ("eafl", "oort", "eafl-epj"), True
        pop = sharded_check.mixed_pop(key, n)
    for kind in kinds:
        cfg = (SelectorConfig(kind, k=k, epsilon0=0.0, epsilon_min=0.0)
               if case == "ties" else SelectorConfig(kind, k=k))
        sharded_check._check_step(f"{case} {kind}", mesh, cfg, pop,
                                  pred(n, 2), key, rounds, kernel)


# ------------------------------------------------------- round engines
def _sel_pop(n=203):
    pop = sharded_check.mixed_pop(prng.PRNGKey(5, "cpu"), n)
    return pop.replace(battery_pct=pop.battery_pct * 0.1)


def _sel_run(engine, rounds=5, **kw):
    cfg = SelectorConfig("eafl", k=9)
    fn = (tsim.run_rounds_scanned if engine == "scanned"
          else tsim.run_rounds_sharded)
    return fn(prng.PRNGKey(9, "cpu"), cfg, kw.pop("pop", _sel_pop()),
              SelectorState.create(cfg), EnergyModel(0.02), MB, STEPS, BS,
              rounds, deadline_s=900.0, faults=FaultConfig(**SEL_FAULTS),
              **kw)


SEL_EXACT = ("selected", "chosen", "succeeded", "corrupt", "retries",
             "new_dropouts", "total_dropped", "round_duration")


def _assert_sel_parity(a, b):
    (pa, sa, ta), (pb, sb, tb) = a, b
    for f in SEL_EXACT:
        np.testing.assert_array_equal(ta[f], tb[f], f)
    for f in ("mean_battery", "energy_spent_pct", "energy_spent_j"):
        np.testing.assert_allclose(ta[f], tb[f], rtol=1e-6, err_msg=f)
    assert torch.equal(pa.battery_pct, pb.battery_pct)
    assert torch.equal(pa.dropped, pb.dropped)
    assert torch.equal(pa.stat_util, pb.stat_util)
    for f in ("round", "epsilon", "pacer_T", "util_ema"):
        assert float(getattr(sa, f)) == float(getattr(sb, f)), f


@pytest.mark.parametrize("d", [2, 3, 8])
def test_run_rounds_sharded_matches_scanned(d):
    scanned = _sel_run("scanned")
    assert scanned[2]["retries"].any() and scanned[2]["corrupt"].any()
    assert scanned[2]["new_dropouts"].any()
    _assert_sel_parity(scanned, _sel_run("sharded", mesh=ClientMesh(d)))


def test_run_rounds_sharded_matches_reference_one_shard():
    """The port's engine on 1 and 3 shards against the reference's
    ``run_rounds_sharded`` on a one-device mesh, on the reference's
    population: index columns equal, floats within rtol 1e-6."""
    jkey = jax.random.PRNGKey(9)
    jpop, tpop = _jmixed_pop(5, 203)
    jcfg = jsel.SelectorConfig("eafl", k=9)
    _, jst, jt = jsim.run_rounds_sharded(
        jkey, jcfg, jpop, jsel.SelectorState.create(jcfg), JEnergy(0.02),
        MB, STEPS, BS, 5, deadline_s=900.0, mesh=jmesh(1),
        faults=JFaults(**SEL_FAULTS))
    cfg = SelectorConfig("eafl", k=9)
    for d in (1, 3):
        _, st, tt = tsim.run_rounds_sharded(
            convert.key(jkey, "cpu"), cfg, tpop, SelectorState.create(cfg),
            EnergyModel(0.02), MB, STEPS, BS, 5, deadline_s=900.0,
            n_shards=d, faults=FaultConfig(**SEL_FAULTS))
        for f in SEL_EXACT:
            np.testing.assert_array_equal(tt[f], np.asarray(jt[f]), f)
        for f in ("mean_battery", "energy_spent_pct", "energy_spent_j"):
            np.testing.assert_allclose(tt[f], np.asarray(jt[f]), rtol=1e-6,
                                       err_msg=f)
        np.testing.assert_allclose(float(st.util_ema), float(jst.util_ema),
                                   rtol=1e-6)


def test_run_rounds_sharded_snapshots_cross_shard_counts(tmp_path):
    """A snapshot of the D = 3 engine resumes on 8 shards and in the
    single-device engine; one of the single-device engine resumes on 2
    shards: each equal to the uninterrupted run."""
    whole = _sel_run("scanned", rounds=6)
    p3 = str(tmp_path / "sh-{round}.ckpt")
    _sel_run("sharded", rounds=6, mesh=ClientMesh(3), checkpoint_every=2,
             checkpoint_path=p3)
    p1 = str(tmp_path / "sc-{round}.ckpt")
    _sel_run("scanned", rounds=6, checkpoint_every=3, checkpoint_path=p1)
    _assert_sel_parity(whole, _sel_run("sharded", rounds=6, n_shards=8,
                                       resume_from=p3.format(round=4)))
    _assert_sel_parity(whole, _sel_run("scanned", rounds=6,
                                       resume_from=p3.format(round=2)))
    _assert_sel_parity(whole, _sel_run("sharded", rounds=6, n_shards=2,
                                       resume_from=p1.format(round=3)))


# ------------------------------------------------------------- training
TRAIN_CASES = {
    "eafl": _cfg(),
    "faults+overcommit+recharge": _cfg(
        faults=FAULTS, energy_budget_j=2500.0, deadline_s=2.0,
        overcommit=1.5, recharge_pct_per_hour=30.0, plugged_frac=0.5),
}


@functools.lru_cache(maxsize=None)
def _scanned(case):
    return tserver.run_fl_scanned(TRAIN_CASES[case], device="cpu")


def _assert_close(ref, out, exact=EXACT):
    for f in exact:
        assert getattr(out, f) == getattr(ref, f), f
    for f in CLOSE:
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=1e-5, err_msg=f)
    for f in LOOSE:
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=2e-3, err_msg=f)
    np.testing.assert_allclose(out.init_acc, ref.init_acc, rtol=2e-3)


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_run_fl_sharded_matches_scanned(case, d):
    """On one shard the sharded engine is the fused engine bitwise; on
    three the reduction is split by shard."""
    cfg = TRAIN_CASES[case]
    capture = {}
    ref = _scanned(case)
    steps, carry0 = tserver._fused_engine(cfg, torch.device("cpu"),
                                          ClientMesh(d))
    out = tserver._run_fused_elastic(cfg, steps, carry0, capture=capture,
                                     mesh=ClientMesh(d))
    (_assert_bitwise if d == 1 else _assert_close)(ref, out)
    assert out.round == list(range(1, cfg.rounds + 1))
    if case != "eafl":
        assert sum(out.retries) and sum(out.quarantined)
    # the front door runs the same engine
    _assert_bitwise(out, tserver.run_fl(cfg, engine="sharded", device="cpu")
                    if d == 1 else tserver.run_fl_sharded(cfg, n_shards=d,
                                                          device="cpu"))


@pytest.fixture(scope="module")
def reference_sharded(tmp_path_factory):
    """The reference's ``run_fl_sharded`` on a one-device mesh, with a
    ``train-sync`` snapshot after every round."""
    path = str(tmp_path_factory.mktemp("ref") / "ref-{round}.ckpt")
    jcfg = dataclasses.replace(_cfgs("eafl")[0], checkpoint_path=path,
                               checkpoint_every=1)
    return jserver.run_fl_sharded(jcfg, mesh=jmesh(1)), path


def test_run_fl_sharded_matches_reference_one_shard(reference_sharded,
                                                    monkeypatch):
    ref, _ = reference_sharded
    jcfg, tcfg = _cfgs("eafl")
    _patch_reference_draws(monkeypatch, jcfg)
    for d in (1, 3):
        _assert_close(ref, tserver.run_fl_sharded(tcfg, n_shards=d,
                                                  device="cpu"),
                      exact=("round", "cum_dropouts", "quarantined",
                             "update_skipped", "budget_exhausted_round"))


@pytest.mark.parametrize("engine,d", [("sharded", 1), ("sharded", 3),
                                      ("scanned", None)])
def test_reference_sharded_snapshot_resumes_here(reference_sharded,
                                                 monkeypatch, engine, d):
    """The reference's sharded ``train-sync`` snapshot after round 1
    continues in the port's sharded engine (1 and 3 shards) and in its
    fused engine; the run equals the reference's uninterrupted one."""
    ref, path = reference_sharded
    jcfg, tcfg = _cfgs("eafl")
    _patch_reference_draws(monkeypatch, jcfg)
    cfg = dataclasses.replace(tcfg, resume_from=path.format(round=1))
    out = (tserver.run_fl_sharded(cfg, n_shards=d, device="cpu")
           if engine == "sharded" else tserver.run_fl_scanned(cfg,
                                                              device="cpu"))
    _assert_close(ref, out, exact=("round", "cum_dropouts", "quarantined",
                                   "update_skipped"))


def test_train_snapshots_cross_shard_counts_and_engines(tmp_path):
    """A 2-shard ``train-sync`` snapshot resumes on 3 shards and in the
    fused engine; a fused-engine snapshot resumes on 2 shards. One shard
    continuing the fused engine's snapshot equals it bitwise."""
    cfg = dataclasses.replace(TRAIN_CASES["faults+overcommit+recharge"],
                              rounds=4)
    whole = tserver.run_fl_scanned(cfg, device="cpu")
    sh = str(tmp_path / "sh-{round}.ckpt")
    sc = str(tmp_path / "sc-{round}.ckpt")
    tserver.run_fl_sharded(dataclasses.replace(
        cfg, checkpoint_path=sh, checkpoint_every=2), n_shards=2,
        device="cpu")
    tserver.run_fl_scanned(dataclasses.replace(
        cfg, checkpoint_path=sc, checkpoint_every=2), device="cpu")
    resume = lambda p: dataclasses.replace(cfg, resume_from=p)  # noqa: E731
    _assert_close(whole, tserver.run_fl_sharded(
        resume(sh.format(round=2)), n_shards=3, device="cpu"))
    _assert_close(whole, tserver.run_fl_scanned(resume(sh.format(round=2)),
                                                device="cpu"))
    _assert_close(whole, tserver.run_fl_sharded(
        resume(sc.format(round=2)), n_shards=2, device="cpu"))
    _assert_bitwise(whole, tserver.run_fl_sharded(
        resume(sc.format(round=2)), n_shards=1, device="cpu"))


@pytest.mark.parametrize("step", ["selection", "training"])
def test_round_step_reads_nothing_on_the_host(step):
    """Every step of the sharded engines on three shards under the
    dispatch mode that raises on any host read or host-data tensor."""
    mesh = ClientMesh(3)
    if step == "training":
        cfg = TRAIN_CASES["faults+overcommit+recharge"]
        steps, carry0 = tserver._fused_engine(cfg, torch.device("cpu"), mesh)
        graphs = StepGraphs(carry0, cfg.rounds)
        graphs.add("round", steps[0], advance=True)
        graphs.add("eval", steps[1], row=-1)
        names = ("round", "eval")
    else:
        cfg, pop = SelectorConfig("eafl", k=9), _sel_pop()
        step = tsim.make_round_engine(cfg, EnergyModel(), MB, STEPS, BS,
                                      900.0, faults=FaultConfig(**SEL_FAULTS),
                                      mesh=mesh, n_real=pop.n)
        graphs = tsim._selection_graphs(
            step, prng.split(prng.PRNGKey(0, "cpu"), 4),
            population_sharding(mesh)(pop),
            SelectorState.create(cfg).canonical("cpu"), 4, 0, mesh, pop.n)
        graphs.run("round")     # makes the cost tables, as the card's warm-up
        names = ("round",)
    with NoHostRead():
        for _ in range(3):
            for name in names:
                graphs.run(name)
    assert graphs.fetch(0, 3)["selected"].shape[0] == 3


def test_sharded_check_and_devices_flag(capsys):
    """``python -m repro_torch.launch.sharded_check --devices D`` on the
    CPU: ``--devices`` sets the virtual shard count, and the selection
    matrix passes. A shard count below 1 is refused by both command lines
    that take one."""
    for bad in ("0", "-2"):
        with pytest.raises(SystemExit):
            sharded_check.main(["--devices", bad, "--device", "cpu"])
        with pytest.raises(SystemExit):
            million_client_selection.main(["--devices", bad, "--device",
                                           "cpu"])
    assert sharded_check.main(["--devices", "3", "--n", "101", "--rounds",
                               "2", "--device", "cpu"]) == 0
    assert "parity OK (3 shards)" in capsys.readouterr().out


# ------------------------------------------------------------ gloo ranks
def test_gloo_ranks_equal_the_virtual_mesh():
    """Two gloo ranks (one shard each, spawned) equal two virtual shards
    in one process, on every rank. Each wait has its own timeout."""
    cfg = SelectorConfig("eafl", k=9)
    sel_args = (prng.PRNGKey(9, "cpu"), cfg, _sel_pop(),
                SelectorState.create(cfg), EnergyModel(0.02), MB, STEPS, BS,
                4)
    sel_kw = dict(deadline_s=900.0, faults=FaultConfig(**SEL_FAULTS))
    fl_cfg = TRAIN_CASES["eafl"]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    fd, store = tempfile.mkstemp()
    os.close(fd)
    os.unlink(store)
    procs = [ctx.Process(target=torch_gloo_rank.run_rank,
                         args=(r, 2, f"file://{store}", queue, sel_args,
                               sel_kw, fl_cfg))
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
    pop, _, traj = tsim.run_rounds_sharded(*sel_args, **sel_kw, n_shards=2)
    hist = tserver.run_fl_sharded(fl_cfg, n_shards=2, device="cpu").as_dict()
    assert sorted(r for r, *_ in results) == [0, 1]
    for _, t, battery, h in results:
        for f in SEL_EXACT:
            np.testing.assert_array_equal(t[f], traj[f], f)
        np.testing.assert_array_equal(battery, pop.battery_pct.numpy())
        assert h.keys() == hist.keys()
        for f in hist:
            np.testing.assert_array_equal(np.asarray(h[f], np.float64),
                                          np.asarray(hist[f], np.float64), f)
