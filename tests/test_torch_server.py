"""The whole slice: the port's host ``run_fl`` against the reference's.

The port runs on the CPU with its population, data, test set and initial
weights replaced by the reference's draws (converted through
``repro_torch.convert``): the normal draws of the two packages differ in
``erfinv``'s last bits. The replacements receive the port's keys, which
are bit-exact copies of the reference's, and hand them to the reference's
functions. Everything after that (selection, simulation, local SGD,
aggregation, YoGi) is the port's own.

``round`` and ``cum_dropouts`` must be equal; fairness, participation,
wall hours, mean battery and joules within rtol 1e-5 (float32 sums over
the population in another order); train loss and test accuracy within
rtol 2e-3 (convolutions summed in another order, through a few SGD
steps)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import data as jdata  # noqa: E402
from repro.configs.paper_resnet_speech import reduced as jreduced  # noqa: E402
from repro.core import clients as jclients  # noqa: E402
from repro.core.selection import SelectorConfig as JSel  # noqa: E402
from repro.federated import server as jserver  # noqa: E402
from repro.models import resnet as jres  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.paper_resnet_speech import reduced as treduced  # noqa: E402
from repro_torch.core.selection import SelectorConfig as TSel  # noqa: E402
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated.controller import Arm, ControllerConfig  # noqa: E402

COMMON = dict(n_clients=12, rounds=3, local_steps=2, batch_size=4,
              samples_per_client=8, input_hw=16, eval_samples=16,
              eval_every=1)
EXTRA = {"eafl": {}, "random": {},
         "eafl-budget": dict(deadline_s=2.0, energy_budget_j=2500.0,
                             overcommit=1.5, compression="int8")}


def _cfgs(case):
    kind = case.split("-")[0]
    extra = EXTRA[case]
    j = jserver.FLConfig(selector=JSel(kind, k=3),
                         model=dataclasses.replace(jreduced(), input_hw=16),
                         **COMMON, **extra)
    t = tserver.FLConfig(selector=TSel(kind, k=3),
                         model=dataclasses.replace(treduced(), input_hw=16),
                         **COMMON, **extra)
    return j, t


@functools.lru_cache(maxsize=None)
def _reference(case):
    return jserver.run_fl(_cfgs(case)[0], engine="host")


def _jkey(key):
    return jnp.asarray(key.numpy().astype(np.uint32))


def _patch_reference_draws(monkeypatch, jcfg):
    def population(key, n, **kw):
        pop = jclients.make_population(_jkey(key), n, **kw)
        return convert.population(pop, "cpu")

    def dataset(fn):
        def draw(key, *a, **kw):
            out = fn(_jkey(key), *a, **kw)
            return convert.dataset({k: np.asarray(v) for k, v in out.items()},
                                   "cpu")
        return draw

    def params(key, cfg):
        p = jres.init_resnet(_jkey(key), jcfg.model)
        return convert.resnet_params(jax.tree.map(np.asarray, p), "cpu")

    monkeypatch.setattr(tserver, "make_population", population)
    monkeypatch.setattr(tserver, "label_restricted_partition",
                        dataset(jdata.label_restricted_partition))
    monkeypatch.setattr(tserver, "make_test_set",
                        dataset(jdata.make_test_set))
    monkeypatch.setattr(tserver, "init_resnet", params)


@pytest.mark.parametrize("case", ["eafl", "random", "eafl-budget"])
def test_run_fl_matches_reference(case, monkeypatch):
    jcfg, tcfg = _cfgs(case)
    ref = _reference(case)
    _patch_reference_draws(monkeypatch, jcfg)
    out = tserver.run_fl(tcfg, device="cpu")
    assert out.round == ref.round
    assert out.cum_dropouts == ref.cum_dropouts
    assert out.quarantined == ref.quarantined
    assert out.update_skipped == ref.update_skipped
    assert out.budget_exhausted_round == ref.budget_exhausted_round
    for f in ("fairness", "participation", "wall_hours", "mean_battery",
              "energy_spent_j", "round_duration"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=1e-5, err_msg=f)
    for f in ("train_loss", "test_acc"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=2e-3, err_msg=f)
    np.testing.assert_allclose(out.init_acc, ref.init_acc, rtol=2e-3)


# The async knobs and the knob controller are ported now (the controller
# runs in the sync host loop: tests/test_torch_controller.py). The case
# keeps its id and holds the reference's order of refusals: a controller
# with any engine but the host loop is the reference's ValueError, raised
# before the sharded engine's NotImplementedError (item 13).
@pytest.mark.parametrize("change,match", [
    pytest.param(dict(controller=ControllerConfig(arms=(Arm(),))),
                 "synchronous host loop", id="change1-item 12"),
])
def test_unported_options_raise(change, match):
    cfg = dataclasses.replace(_cfgs("eafl")[1], **change)
    for engine in ("sharded", "scanned"):
        with pytest.raises(ValueError, match=match):
            tserver.run_fl(cfg, engine=engine, device="cpu")


def test_async_knobs_route_to_the_async_engines(monkeypatch):
    """``buffer_size`` alone opts into async (mode ``auto``): the fused
    async engine runs, where it once raised."""
    called = []
    from repro_torch.federated import async_server
    monkeypatch.setattr(async_server, "run_fl_async_scanned",
                        lambda cfg, **kw: called.append(("scanned", kw)))
    monkeypatch.setattr(async_server, "run_fl_async",
                        lambda cfg, **kw: called.append(("host", kw)))
    cfg = dataclasses.replace(_cfgs("eafl")[1], buffer_size=2)
    tserver.run_fl(cfg, device="cpu")
    tserver.run_fl(cfg, engine="host", device="cpu")
    tserver.run_fl(_cfgs("eafl")[1], mode="async", device="cpu")
    assert [c[0] for c in called] == ["scanned", "host", "scanned"]


@pytest.mark.parametrize("engine", ["sharded"])
def test_unported_engines_raise(engine):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserver.run_fl(_cfgs("eafl")[1], engine=engine, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        tserver.run_fl(_cfgs("eafl")[1], mode="async", engine=engine,
                       device="cpu")


def test_port_runs_on_its_own_draws():
    """Without the reference's draws the port still trains: finite losses,
    exact key-derived selections, accuracies in [0, 1]."""
    out = tserver.run_fl(_cfgs("eafl")[1], device="cpu")
    assert out.round == [1, 2, 3]
    assert np.isfinite(out.train_loss).all()
    assert all(0.0 <= a <= 1.0 for a in out.test_acc)
