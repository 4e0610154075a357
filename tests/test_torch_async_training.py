"""The port's FedBuff training engines on the CPU: its host event loop
(``run_fl(mode="async", engine="host")``) against the reference's
``run_fl_async``, and its fused engine (``run_fl_async_scanned``) against
its host loop.

The configuration is the reference's own (``tests/
test_async_training_engines.py``: 24 clients, k = 4, buffer 3, 6
concurrent, 6 aggregations, the reduced ResNet). The port runs on the
reference's draws (``test_torch_server._patch_reference_draws``) where it
is held against the reference. The flush and refill columns (completed,
comp_chosen, succeeded, staleness, start_version, selected, chosen) are
equal index for index and ``agg_weight`` bit for bit; the history as in
``tests/test_torch_training_engines.py``: integers equal, fairness,
participation, wall hours, battery and joules within rtol 1e-5, loss and
accuracy within rtol 2e-3 (convolutions summed in another order, and the
fused flush trains its full width). Segmented and resumed runs equal the
uninterrupted one bitwise.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_resnet_speech import reduced as jreduced  # noqa: E402
from repro.core.selection import SelectorConfig as JSel  # noqa: E402
from repro.federated import async_server as jasync  # noqa: E402
from repro.federated import server as jserver  # noqa: E402
from test_torch_server import _patch_reference_draws  # noqa: E402
from test_torch_training_engines import (NoHostRead,  # noqa: E402,F401
                                         _assert_bitwise, _assert_parity,
                                         one_thread)
from repro_torch.configs.paper_resnet_speech import reduced  # noqa: E402
from repro_torch.core.selection import SelectorConfig  # noqa: E402
from repro_torch.federated import async_server as tasync  # noqa: E402
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated.faults import FaultConfig  # noqa: E402
from repro_torch.federated.replay import StepGraphs  # noqa: E402

BASE = dict(n_clients=24, rounds=6, local_steps=3, batch_size=8,
            samples_per_client=24, eval_every=3, eval_samples=70,
            input_hw=16, buffer_size=3, max_concurrency=6,
            staleness_power=0.5)
TRACE = ("completed", "comp_chosen", "succeeded", "staleness",
         "start_version", "selected", "chosen")
DEADLINE = dict(deadline_s=600.0, sim_model_bytes=85e6, sim_local_steps=1600)
BUDGET = dict(energy_budget_j=2500.0, recharge_pct_per_hour=5.0,
              plugged_frac=0.4)


def _cfg(kind="eafl", **kw):
    return tserver.FLConfig(selector=SelectorConfig(kind, k=4),
                            model=reduced(), **{**BASE, **kw})


def _jcfg(kind="eafl", **kw):
    return jserver.FLConfig(selector=JSel(kind, k=4), model=jreduced(),
                            **{**BASE, **kw})


def _assert_traces_equal(trace, other):
    """Two lists of per-aggregation columns: index for index, and the
    damping weights bit for bit."""
    assert len(trace) == len(other)
    for r, (a, b) in enumerate(zip(trace, other)):
        for k in TRACE:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), \
                (r, k, a[k], b[k])
        wa, wb = np.asarray(a["agg_weight"]), np.asarray(b["agg_weight"])
        assert wa.dtype == wb.dtype == np.float32
        assert np.array_equal(wa.view(np.int32), wb.view(np.int32)), (r, wa,
                                                                      wb)


def _rows(traj, n):
    """The fused trajectory's first ``n`` aggregations as trace rows."""
    return [{k: traj[k][r] for k in TRACE + ("agg_weight",)}
            for r in range(n)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's host event loop, its trace, and a snapshot after
    aggregations 3 and 6, per case."""
    out = {}
    for case, kw in (("eafl", {}), ("deadline+budget", {**DEADLINE,
                                                        **BUDGET})):
        path = str(tmp_path_factory.mktemp("ref") / "async-{round}.ckpt")
        trace = []
        hist = jasync.run_fl_async(
            _jcfg(**kw, checkpoint_path=path, checkpoint_every=3),
            _trace=trace)
        out[case] = (kw, hist, trace, path)
    return out


@pytest.mark.parametrize("case", ["eafl", "deadline+budget"])
def test_host_loop_matches_reference(reference, case, monkeypatch):
    kw, ref, ref_trace, _ = reference[case]
    _patch_reference_draws(monkeypatch, _jcfg(**kw))
    trace = []
    out = tasync.run_fl_async(_cfg(**kw), device="cpu", _trace=trace)
    _assert_traces_equal(trace, ref_trace)
    _assert_parity(ref, out)
    if case == "eafl":
        assert max(int(np.max(t["staleness"])) for t in trace) > 0
    else:
        assert ref.budget_exhausted_round is not None


@pytest.mark.parametrize("r", [3])
def test_reference_host_snapshot_resumes_here(reference, r, monkeypatch):
    """A ``train-async-host`` snapshot the reference wrote after
    aggregation r (ring, selection ranks and both keys in its carry)
    resumes in the port's host loop and finishes as the reference did."""
    kw, ref, ref_trace, path = reference["eafl"]
    _patch_reference_draws(monkeypatch, _jcfg(**kw))
    trace = []
    out = tasync.run_fl_async(_cfg(**kw, resume_from=path.format(round=r)),
                              device="cpu", _trace=trace)
    _assert_traces_equal(trace, ref_trace[r:])
    _assert_parity(ref, out)
    # the aggregations before r come from the snapshot, as written there
    assert out.train_loss[:r] == ref.train_loss[:r]


@functools.lru_cache(maxsize=None)
def _engines(case):
    """``(host, host trace, fused, fused trajectory)`` of one case."""
    kind, kw = CASES[case]
    trace, cap = [], {}
    host = tasync.run_fl_async(_cfg(kind, **kw), device="cpu", _trace=trace)
    fused = tasync.run_fl_async_scanned(_cfg(kind, **kw), device="cpu",
                                        _capture=cap)
    return host, trace, fused, cap["traj"]


CASES = {"eafl": ("eafl", {}), "oort": ("oort", {}),
         "random": ("random", {}), "eafl-epj": ("eafl-epj", {}),
         "deadline": ("eafl", DEADLINE), "budget+recharge": ("eafl", BUDGET)}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_matches_host(case):
    host, trace, fused, traj = _engines(case)
    _assert_traces_equal(trace, _rows(traj, len(host.round)))
    for r, t in enumerate(trace):
        assert int(traj["server_version"][r]) == t["server_version"]
        assert int(traj["n_inflight"][r]) == t["n_inflight"]
    _assert_parity(host, fused)
    succ, chosen = traj["succeeded"], traj["comp_chosen"]
    if case == "deadline":
        assert not succ[chosen].all(), "the deadline abandoned no arrival"
    if case == "budget+recharge":
        assert host.budget_exhausted_round is not None


def test_fused_restart_parity_is_bitwise(tmp_path):
    """Killed after aggregation 3 and resumed (and run in segments of 3):
    bitwise the uninterrupted run, with the budget's ledger in the
    carry."""
    path = str(tmp_path / "fused-{round}.ckpt")
    cfg = _cfg(energy_budget_j=2500.0)
    whole = tasync.run_fl_async_scanned(cfg, device="cpu")
    seg = tasync.run_fl_async_scanned(dataclasses.replace(
        cfg, checkpoint_path=path, checkpoint_every=3), device="cpu")
    resumed = tasync.run_fl_async_scanned(dataclasses.replace(
        cfg, resume_from=path.format(round=3)), device="cpu")
    assert whole.budget_exhausted_round is not None
    _assert_bitwise(whole, seg)
    _assert_bitwise(whole, resumed)


def test_host_restart_parity_is_bitwise(tmp_path):
    path = str(tmp_path / "host-{round}.ckpt")
    cfg = _cfg("oort", **BUDGET)
    whole = tasync.run_fl_async(cfg, device="cpu")
    tasync.run_fl_async(dataclasses.replace(
        cfg, checkpoint_path=path, checkpoint_every=2), device="cpu")
    resumed = tasync.run_fl_async(dataclasses.replace(
        cfg, resume_from=path.format(round=2)), device="cpu")
    _assert_bitwise(whole, resumed)


def test_sync_limit_reproduces_the_sync_engine():
    """buffer = concurrency = k, staleness_power 0, a selector blind to
    the statistics: the async fused engine is the sync fused engine."""
    base = dict(BASE, buffer_size=None, max_concurrency=None)
    sync = tserver.run_fl_scanned(tserver.FLConfig(
        selector=SelectorConfig("random", k=4), model=reduced(), **base),
        device="cpu")
    asyn = tasync.run_fl_async_scanned(tserver.FLConfig(
        selector=SelectorConfig("random", k=4), model=reduced(),
        **dict(base, buffer_size=4, max_concurrency=4,
               staleness_power=0.0)), device="cpu")
    for f in ("test_acc", "train_loss", "participation", "cum_dropouts",
              "round_duration"):
        assert np.array_equal(np.asarray(getattr(sync, f)),
                              np.asarray(getattr(asyn, f)), equal_nan=True), f
    np.testing.assert_allclose(sync.wall_hours, asyn.wall_hours, rtol=1e-6)


def test_aggregation_step_reads_nothing_on_the_host():
    cfg = _cfg(**BUDGET, deadline_s=900.0)
    dev = torch.device("cpu")
    (kloop, data, test, params, opt, opt_state, pop, sim_steps, up_bytes,
     energy_model, model_bytes) = tserver._fused_setup(cfg, dev)
    fill, agg_fn, eval_fn = tasync._async_fused_runner(
        cfg, energy_model, sim_steps, model_bytes, up_bytes, opt,
        data["x"], data["y"], test["x"], test["y"])
    st = tserver.SelectorState.create(cfg.selector).canonical(dev)
    carry = fill(kloop, params, opt_state, pop, st,
                 tserver._accuracy_fn(cfg.model, test)(params))
    graphs = StepGraphs(carry, cfg.rounds)
    graphs.add("agg", agg_fn, advance=True)
    graphs.add("eval", eval_fn, row=-1)
    graphs.run("agg")       # makes the damping table, as the warm-up
    with NoHostRead():
        for _ in range(cfg.rounds - 1):
            graphs.run("agg")
            graphs.run("eval")
    traj = graphs.fetch(0, cfg.rounds)
    assert traj["completed"].shape == (cfg.rounds, 3)
    assert np.isfinite(traj["test_acc"]).all()


def test_run_fl_routes_async():
    """``auto`` with an async knob runs the fused engine, ``engine="host"``
    the host loop, and ``mode="async"`` without knobs the sync-parity
    geometry (buffer = concurrency = k)."""
    cfg = _cfg()
    _assert_bitwise(tserver.run_fl(cfg, device="cpu"), _engines("eafl")[2])
    plain = dataclasses.replace(cfg, buffer_size=None, max_concurrency=None,
                                rounds=2)
    trace = []
    tasync.run_fl_async(plain, device="cpu", _trace=trace)
    assert [t["completed"].shape for t in trace] == [(4,), (4,)]
    _assert_bitwise(tserver.run_fl(plain, mode="async", engine="host",
                                   device="cpu"),
                    tasync.run_fl_async(plain, device="cpu"))


@pytest.mark.parametrize("change,engine,exc,match", [
    ({}, "sharded", NotImplementedError, "item 13"),
    ({"faults": FaultConfig(seed=1, crash_prob=0.3)}, "auto", ValueError,
     "fault"),
    ({"overcommit": 1.5}, "host", ValueError, "overcommit"),
    ({"controller": object()}, "scanned", ValueError, "controller"),
    ({"snapshot_ring_size": 2}, "scanned", ValueError, "snapshot_ring_size"),
    ({"buffer_size": 7}, "host", ValueError, "max_concurrency"),
])
def test_async_rejections(change, engine, exc, match):
    with pytest.raises(exc, match=match):
        tserver.run_fl(_cfg(**change), engine=engine, device="cpu")


def test_engine_names_are_not_modes():
    with pytest.raises(ValueError, match="engine name"):
        tserver.run_fl(_cfg(), mode="async-scanned", device="cpu")
