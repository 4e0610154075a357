"""The port's fused engine (``run_fl(engine="scanned")``) against the
port's host loop, its oracle, on the CPU.

Integer and index outputs equal (rounds, dropouts, retries, quarantines,
skipped updates, the budget's exhausted round); fairness, participation,
wall hours, mean battery and joules within rtol 1e-5; train loss and test
accuracy within rtol 2e-3 (the masked fixed-width cohort trains and sums
over more rows than the host's), the tolerances of
``tests/test_torch_server.py``. One case runs against the reference's host
loop. Segmented and resumed runs equal the uninterrupted run bitwise. The
round step runs under a dispatch mode that raises on every host read,
the CPU's proof that a CUDA graph can capture it.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from test_torch_server import (_cfgs, _patch_reference_draws,  # noqa: E402
                               _reference, one_thread)  # noqa: F401
from repro_torch.configs.paper_resnet_speech import reduced  # noqa: E402
from repro_torch.core.selection import SelectorConfig  # noqa: E402
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated.faults import FaultConfig  # noqa: E402
from repro_torch.federated.replay import StepGraphs  # noqa: E402

COMMON = dict(n_clients=12, rounds=3, local_steps=1, batch_size=4,
              samples_per_client=8, input_hw=16, eval_samples=16,
              eval_every=2)
FAULTS = FaultConfig(seed=1, crash_prob=0.3, max_retries=2,
                     straggle_prob=0.3, corrupt_prob=0.3)
EXACT = ("round", "cum_dropouts", "retries", "quarantined", "update_skipped",
         "budget_exhausted_round")
CLOSE = ("fairness", "participation", "wall_hours", "mean_battery",
         "energy_spent_j", "round_duration")
LOOSE = ("train_loss", "test_acc")
FIELDS = EXACT[:-1] + CLOSE + LOOSE


def _cfg(kind="eafl", **kw):
    return tserver.FLConfig(selector=SelectorConfig(kind, k=3),
                            model=dataclasses.replace(reduced(), input_hw=16),
                            **{**COMMON, **kw})


def _assert_parity(host, fused):
    for f in EXACT:
        assert getattr(fused, f) == getattr(host, f), f
    for f in CLOSE:
        np.testing.assert_allclose(getattr(fused, f), getattr(host, f),
                                   rtol=1e-5, err_msg=f)
    for f in LOOSE:
        np.testing.assert_allclose(getattr(fused, f), getattr(host, f),
                                   rtol=2e-3, err_msg=f)
    np.testing.assert_allclose(fused.init_acc, host.init_acc, rtol=2e-3)


def _assert_bitwise(a, b):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(a, f), np.float64),
                              np.asarray(getattr(b, f), np.float64),
                              equal_nan=True), f
    assert a.budget_exhausted_round == b.budget_exhausted_round
    assert a.init_acc == b.init_acc


CASES = {
    "eafl": _cfg(), "oort": _cfg("oort"), "random": _cfg("random"),
    "eafl-epj": _cfg("eafl-epj"),
    "overcommit": _cfg(overcommit=1.5),
    "topk+recharge": _cfg(compression="topk", compression_sparsity=0.25,
                          recharge_pct_per_hour=40.0, plugged_frac=0.5,
                          init_battery_low=12.0, init_battery_high=30.0),
    # enabled but moving no battery: the recharge key must not leak into
    # the trajectory
    "inert-recharge": _cfg(recharge_pct_per_hour=50.0, plugged_frac=0.0),
    "faults": _cfg(faults=FAULTS, deadline_s=2.0),
    "budget": _cfg(energy_budget_j=2500.0, deadline_s=2.0,
                   compression="int8"),
}


@functools.lru_cache(maxsize=None)
def _runs(case):
    """``(host, fused)`` histories of ``CASES[case]``."""
    cfg = CASES[case]
    return (tserver.run_fl(cfg, device="cpu"),
            tserver.run_fl(cfg, engine="scanned", device="cpu"))


@pytest.mark.parametrize("case", list(CASES))
def test_scanned_matches_host(case):
    host, fused = _runs(case)
    _assert_parity(host, fused)
    if case == "faults":
        assert sum(host.retries) > 0 and sum(host.quarantined) > 0
    if case == "budget":
        assert host.budget_exhausted_round is not None


def test_inert_recharge_leaves_the_trajectory():
    _assert_bitwise(_runs("eafl")[1], _runs("inert-recharge")[1])


def test_scanned_matches_reference_host(monkeypatch):
    """The fused engine on the reference's draws against the reference's
    host loop (the budget, deadline, overcommit and int8 case)."""
    jcfg, tcfg = _cfgs("eafl-budget")
    ref = _reference("eafl-budget")
    _patch_reference_draws(monkeypatch, jcfg)
    out = tserver.run_fl(tcfg, engine="scanned", device="cpu")
    assert out.round == ref.round
    _assert_parity(ref, out)


def test_segmented_and_resumed_runs_are_bitwise(tmp_path):
    cfg = _cfg(faults=FAULTS, energy_budget_j=4000.0, overcommit=1.5,
               rounds=4)
    whole = tserver.run_fl_scanned(cfg, device="cpu")
    path = str(tmp_path / "ck-{round}.ckpt")
    seg = tserver.run_fl_scanned(dataclasses.replace(
        cfg, checkpoint_path=path, checkpoint_every=1), device="cpu")
    _assert_bitwise(whole, seg)
    for r in (1, 3):        # killed after round r, resumed
        resumed = tserver.run_fl_scanned(dataclasses.replace(
            cfg, resume_from=path.format(round=r)), device="cpu")
        _assert_bitwise(whole, resumed)


class NoHostRead(TorchDispatchMode):
    """Raises on every operator that reads a device value on the host,
    sizes its output from the data, or makes a tensor of host data (a
    copy from the host on the card, which a CUDA graph cannot capture)."""
    BANNED = ("_local_scalar_dense", "nonzero", "masked_select",
              "lift_fresh")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.BANNED:
            raise AssertionError(f"host read: {func}")
        if func is torch.ops.aten.index.Tensor and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            raise AssertionError("indexing with a bool mask")
        return func(*args, **(kwargs or {}))


def test_no_host_read_mode_catches_reads():
    x = torch.arange(4.0)
    for read in (lambda: bool(x.sum()), lambda: float(x[0]),
                 lambda: x[x > 1], lambda: torch.nonzero(x),
                 lambda: torch.tensor([1.0, 2.0])):
        with pytest.raises(AssertionError), NoHostRead():
            read()


@pytest.mark.parametrize("case", ["faults-overcommit-recharge", "oort"])
def test_round_step_reads_nothing_on_the_host(case):
    cfg = _cfg("oort") if case == "oort" else _cfg(
        faults=FAULTS, energy_budget_j=2500.0, deadline_s=2.0,
        overcommit=1.5, recharge_pct_per_hour=30.0)
    steps, carry0 = tserver._fused_engine(cfg, torch.device("cpu"))
    graphs = StepGraphs(carry0, cfg.rounds)
    graphs.add("round", steps[0], advance=True)
    graphs.add("eval", steps[1], row=-1)
    with NoHostRead():
        for _ in range(cfg.rounds):
            graphs.run("round")
            graphs.run("eval")
    traj = graphs.fetch(0, cfg.rounds)
    assert traj["selected"].shape == (cfg.rounds, 5 if case != "oort" else 3)
    assert np.isfinite(traj["test_acc"]).all()


def test_rejections():
    with pytest.raises(ValueError, match="async"):
        tserver.run_fl_scanned(_cfg(buffer_size=2), device="cpu")
    # the sharded engines of both families run (the async one once raised)
    assert tserver.run_fl(_cfg(), engine="sharded", device="cpu").round \
        == [1, 2, 3]
    assert tserver.run_fl(_cfg(), mode="async", engine="sharded",
                          device="cpu").round == [1, 2, 3]
    with pytest.raises(ValueError, match="unknown training engine"):
        tserver.run_fl(_cfg(), engine="fused", device="cpu")
