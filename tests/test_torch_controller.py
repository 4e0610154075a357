"""The port's UCB knob controller (``federated/controller.py``) and its
hooks in the host ``run_fl``, against the reference's.

The first ten tests mirror ``tests/test_budget_controller.py`` on the
port: the exhaustive-grid oracle (the controller's (joules, accuracy)
point is not clearly dominated by a fixed arm), the all-inherit arm
reproducing the controller-free run bitwise, the bandit's units and the
engines' refusals. Then the parity tests: ``choose``/``update`` equal to
the reference's on random reward streams; ``run_fl`` with a controller
against the reference's on the reference's draws
(``test_torch_server._patch_reference_draws``), the pulled arms, each
round's selected clients and the dropouts exact, the floats at
``tests/test_torch_server.py``'s tolerances (rtol 1e-5, and 2e-3 for
train loss and test accuracy); a reference ``train-host`` snapshot with
the controller's state resuming in the port's host loop.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs.paper_resnet_speech import reduced as jreduced  # noqa: E402
from repro.core.selection import SelectorConfig as JSel  # noqa: E402
from repro.federated import controller as jctrl  # noqa: E402
from repro.federated import server as jserver  # noqa: E402
from test_torch_server import _patch_reference_draws  # noqa: E402
from test_torch_training_engines import one_thread  # noqa: E402,F401
from repro_torch.configs.paper_resnet_speech import reduced  # noqa: E402
from repro_torch.core.selection import SelectorConfig  # noqa: E402
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated.controller import (Arm,  # noqa: E402
                                              ControllerConfig,
                                              UCBController, arm_knobs)

ARMS = (Arm(k=2), Arm(k=4), Arm(k=6))
#: domination margins: accuracy is a tiny-run statistic, energy a sum of
#: per-client joules; a clear win on both axes is required
ACC_EPS = 0.02
J_EPS = 0.05
BASE = dict(n_clients=24, rounds=6, local_steps=3, batch_size=8,
            samples_per_client=24, eval_every=2, eval_samples=70,
            input_hw=16)
#: arms that move every knob: sparsity under topk compression, the
#: aggregation cap, and the sync-cohort damping
KNOB_ARMS = (Arm(k=3, compression_sparsity=0.25),
             Arm(buffer_size=2, staleness_power=0.5),
             Arm(k=5, staleness_power=1.0))
KNOBS = dict(compression="topk", compression_sparsity=0.1)
CLOSE = ("fairness", "participation", "wall_hours", "mean_battery",
         "energy_spent_j", "round_duration")


def _cfg(**kw):
    base = dict(selector=SelectorConfig(kind="eafl", k=4), model=reduced(),
                **BASE)
    base.update(kw)
    return tserver.FLConfig(**base)


def _jarms(arms):
    return tuple(jctrl.Arm(**dataclasses.asdict(a)) for a in arms)


def _jcfg(arms, **kw):
    return jserver.FLConfig(selector=JSel("eafl", k=4), model=jreduced(),
                            controller=jctrl.ControllerConfig(
                                arms=_jarms(arms)),
                            **{**BASE, **kw})


def _tcfg(arms, **kw):
    return _cfg(controller=ControllerConfig(arms=arms), **kw)


# --------------------------------------------------------------- oracle

def test_controller_not_dominated_by_exhaustive_grid():
    ctrl_hist = tserver.run_fl(_cfg(controller=ControllerConfig(arms=ARMS)),
                               device="cpu")
    acc_c = ctrl_hist.test_acc[-1]
    j_c = ctrl_hist.energy_spent_j[-1]
    # pulls 1..3 are the untried arms in index order, then UCB takes over
    assert ctrl_hist.controller_arm[:3] == [0, 1, 2]
    assert len(ctrl_hist.controller_arm) == 6
    report = []
    for arm in ARMS:
        fixed = tserver.run_fl(_cfg(selector=SelectorConfig(kind="eafl",
                                                            k=arm.k)),
                               device="cpu")
        acc_a = fixed.test_acc[-1]
        j_a = fixed.energy_spent_j[-1]
        report.append((arm.describe(), acc_a, j_a))
        dominated = (acc_a >= acc_c + ACC_EPS
                     and j_a <= (1.0 - J_EPS) * j_c)
        assert not dominated, (
            f"controller (acc={acc_c:.4f}, J={j_c:.1f}) is dominated by "
            f"fixed {arm.describe()} (acc={acc_a:.4f}, J={j_a:.1f}); "
            f"grid: {report}")


def test_disabled_controller_reproduces_fixed_run_exactly():
    """One all-inherit arm: the controller turns no knob and its probe
    evaluation draws no random number, so the trajectory is bitwise the
    run without a controller."""
    plain = tserver.run_fl(_cfg(), device="cpu")
    ctrl = tserver.run_fl(_cfg(controller=ControllerConfig(arms=(Arm(),))),
                          device="cpu")
    assert ctrl.controller_arm == [0] * 6
    for f in ("test_acc", "train_loss", "energy_spent_j", "mean_battery",
              "fairness", "participation", "round_duration"):
        a, b = getattr(plain, f), getattr(ctrl, f)
        assert np.array_equal(np.asarray(a, dtype=np.float64),
                              np.asarray(b, dtype=np.float64),
                              equal_nan=True), f"{f} diverged: {a} vs {b}"


# ------------------------------------------------------- bandit unit

def test_untried_arms_pulled_first_in_index_order():
    ctrl = UCBController(ControllerConfig(arms=ARMS))
    order = []
    for t in range(1, 4):
        i = ctrl.choose(t)
        order.append(i)
        ctrl.update(i, acc_delta=0.01, energy_j=100.0)
    assert order == [0, 1, 2]


def test_choice_is_deterministic_with_tied_rewards():
    ctrl = UCBController(ControllerConfig(arms=ARMS))
    for i in range(3):
        ctrl.update(i, acc_delta=0.01, energy_j=100.0)
    # equal means and counts: the normalisation is all ones, and argmax's
    # lowest-index tie-break picks arm 0 every time
    assert all(ctrl.choose(t) == 0 for t in (4, 5, 6))


def test_controller_abandons_arm_whose_reward_collapses():
    ctrl = UCBController(ControllerConfig(arms=ARMS, ucb_c=0.0))
    rewards = (0.001, 0.05, 0.002)
    for i, r in enumerate(rewards):
        ctrl.update(i, acc_delta=r, energy_j=1.0)
    # with no exploration bonus the argmax is pure greed
    assert ctrl.choose(4) == 1
    # once the favourite's mean decays below the field, the next-best arm
    # takes over
    t = 4
    while ctrl.choose(t) == 1:
        ctrl.update(1, acc_delta=-0.05, energy_j=1.0)
        t += 1
        assert t < 20, "never abandoned the collapsing arm"
    assert ctrl.choose(t) == 2


def test_reward_floor_caps_refused_round_reward():
    ctrl = UCBController(ControllerConfig(arms=ARMS, reward_floor_j=1.0))
    # a refused round draws 0 J; the floor keeps the reward finite
    r = ctrl.update(0, acc_delta=0.5, energy_j=0.0)
    assert r == 0.5


def test_state_dict_roundtrip_and_shape_guard():
    ctrl = UCBController(ControllerConfig(arms=ARMS))
    ctrl.update(1, acc_delta=0.02, energy_j=50.0)
    state = ctrl.state_dict()
    clone = UCBController(ControllerConfig(arms=ARMS))
    clone.load_state(state)
    assert np.array_equal(clone.counts, ctrl.counts)
    assert np.array_equal(clone.reward_sums, ctrl.reward_sums)
    two = UCBController(ControllerConfig(arms=ARMS[:2]))
    with pytest.raises(ValueError, match="arms"):
        two.load_state(state)


def test_config_validation_and_knob_resolution():
    with pytest.raises(ValueError, match="at least one arm"):
        ControllerConfig(arms=())
    with pytest.raises(ValueError, match="reward_floor_j"):
        ControllerConfig(arms=(Arm(),), reward_floor_j=0.0)
    assert arm_knobs(4, None) == 4
    assert arm_knobs(4, 0) == 0   # 0 is a setting, not 'inherit'
    assert Arm().describe() == "inherit"
    assert Arm(k=2, buffer_size=3).describe() == "k=2,buffer_size=3"


# ------------------------------------------------ engine restrictions

def test_fused_engines_reject_controller():
    cfg = _cfg(controller=ControllerConfig(arms=(Arm(),)))
    with pytest.raises(ValueError, match="controller"):
        tserver.run_fl_scanned(cfg, device="cpu")
    with pytest.raises(ValueError, match="synchronous host loop"):
        tserver.run_fl(cfg, engine="scanned", device="cpu")


def test_async_mode_rejects_controller():
    cfg = _cfg(controller=ControllerConfig(arms=(Arm(),)),
               buffer_size=3, max_concurrency=6, staleness_power=0.5)
    with pytest.raises(ValueError, match="controller"):
        tserver.run_fl(cfg, device="cpu")


# ------------------------------------------------ parity with the reference

@settings(max_examples=80, deadline=None)
@given(n_arms=st.integers(1, 5), ucb_c=st.sampled_from([0.0, 0.1, 0.5, 2.0]),
       floor=st.sampled_from([0.5, 1.0, 30.0]),
       steps=st.lists(st.tuples(
           st.floats(-0.25, 0.25, allow_nan=False, width=32),
           st.floats(0.0, 512.0, allow_nan=False, width=32)),
           min_size=1, max_size=40))
def test_bandit_follows_the_reference(n_arms, ucb_c, floor, steps):
    """The same reward stream through both bandits: every pull, recorded
    reward and state equal exactly."""
    arms = tuple(Arm(k=i + 1) for i in range(n_arms))
    ours = UCBController(ControllerConfig(arms, ucb_c=ucb_c,
                                          reward_floor_j=floor))
    theirs = jctrl.UCBController(jctrl.ControllerConfig(
        _jarms(arms), ucb_c=ucb_c, reward_floor_j=floor))
    for t, (acc, joules) in enumerate(steps, 1):
        i = ours.choose(t)
        assert i == theirs.choose(t), t
        assert ours.update(i, acc, joules) == theirs.update(i, acc, joules)
    assert ours.state_dict() == theirs.state_dict()


def _recorded(module, monkeypatch):
    """Record every selection ``module.select`` returns."""
    picks = []
    select = module.select

    def spy(*a, **kw):
        idx, state = select(*a, **kw)
        picks.append(np.asarray(idx).tolist())
        return idx, state

    monkeypatch.setattr(module, "select", spy)
    return picks


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's host loop with each arm set, its selections, and
    (knob arms) a snapshot after rounds 3 and 6."""
    out = {}
    for case, arms, kw in (("arms", ARMS, {}), ("knobs", KNOB_ARMS, KNOBS)):
        path = str(tmp_path_factory.mktemp("ref") / "host-{round}.ckpt")
        with pytest.MonkeyPatch.context() as mp:
            picks = _recorded(jserver, mp)
            hist = jserver.run_fl(_jcfg(arms, checkpoint_path=path,
                                        checkpoint_every=3, **kw),
                                  engine="host")
        out[case] = (arms, kw, hist, picks, path)
    return out


def _assert_parity(ref, out):
    assert out.round == ref.round
    assert out.controller_arm == ref.controller_arm
    for f in ("cum_dropouts", "quarantined", "update_skipped", "retries",
              "budget_exhausted_round"):
        assert getattr(out, f) == getattr(ref, f), f
    for f in CLOSE:
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=1e-5, err_msg=f)
    for f in ("train_loss", "test_acc"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=2e-3, err_msg=f)


@pytest.mark.parametrize("case", ["arms", "knobs"])
def test_run_fl_with_controller_matches_reference(reference, case,
                                                  monkeypatch):
    arms, kw, ref, ref_picks, _ = reference[case]
    _patch_reference_draws(monkeypatch, _jcfg(arms, **kw))
    picks = _recorded(tserver, monkeypatch)
    out = tserver.run_fl(_tcfg(arms, **kw), device="cpu")
    assert picks == ref_picks
    _assert_parity(ref, out)
    # every arm was pulled, and the knobs moved the cohort sizes
    assert sorted(set(out.controller_arm)) == list(range(len(arms)))
    assert len({len(p) for p in picks}) > 1


def test_reference_snapshot_with_controller_resumes_here(reference,
                                                         monkeypatch):
    """A ``train-host`` snapshot the reference wrote after round 3, with
    its controller's counts, reward sums and probe accuracy, resumes in
    the port's host loop and finishes as the reference did."""
    arms, kw, ref, ref_picks, path = reference["knobs"]
    _patch_reference_draws(monkeypatch, _jcfg(arms, **kw))
    picks = _recorded(tserver, monkeypatch)
    out = tserver.run_fl(_tcfg(arms, resume_from=path.format(round=3), **kw),
                         device="cpu")
    assert picks == ref_picks[3:]
    _assert_parity(ref, out)
    # the rounds before the snapshot come from it, as the reference wrote them
    assert out.train_loss[:3] == ref.train_loss[:3]


def test_port_resume_with_controller_is_bitwise(tmp_path):
    path = str(tmp_path / "h-{round}.ckpt")
    cfg = _tcfg(KNOB_ARMS, **KNOBS)
    whole = tserver.run_fl(cfg, device="cpu")
    tserver.run_fl(dataclasses.replace(cfg, checkpoint_path=path,
                                       checkpoint_every=2), device="cpu")
    resumed = tserver.run_fl(dataclasses.replace(
        cfg, resume_from=path.format(round=4)), device="cpu")
    for k, v in whole.as_dict().items():
        assert np.array_equal(np.asarray(getattr(resumed, k), np.float64),
                              np.asarray(v, np.float64), equal_nan=True), k
