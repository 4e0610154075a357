"""Checkpoints: the port's EAFLCKPT files against the reference's.

A file written by either package loads in the other: parameters (OIHW
here, HWIO in the file and the reference), optimizer state, population,
selector state, PRNG keys (int64 words here, uint32 in the file) and
trajectory data, leaves in ``jax.tree.leaves`` order. A flipped byte, a
cut file and a checkpoint of another run raise ``CheckpointError``.
``segment_bounds`` equals the reference's. A ``train-host`` snapshot the
reference wrote at round r resumes in the port's host loop and finishes
as the reference's uninterrupted run (tolerances of
``tests/test_torch_server.py``); the port's own host loop resumes
bitwise.

The fused engines' ``train-sync`` carries have the same names, leaves and
dtypes in both packages, but no test resumes one across them: the port's
fused engine is held against its own host loop, not against the
reference's fused twin (ROADMAP.md, "Reference caveats")."""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_server import _cfgs, _patch_reference_draws  # noqa: E402
from test_torch_training_engines import one_thread  # noqa: E402,F401
from repro import checkpoint as jck  # noqa: E402
from repro.core import clients as jclients  # noqa: E402
from repro.core.selection import SelectorConfig as JSel  # noqa: E402
from repro.core.selection import SelectorState as JState  # noqa: E402
from repro.federated import server as jserver  # noqa: E402
from repro.federated.simulation import BudgetLedger as JLedger  # noqa: E402
from repro.models import resnet as jres  # noqa: E402
from repro.optim import yogi as jyogi  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.selection import SelectorConfig as TSel  # noqa: E402
from repro_torch.core.selection import SelectorState as TState  # noqa: E402
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated.simulation import BudgetLedger as TLedger  # noqa: E402


@functools.lru_cache(maxsize=None)
def _reference_state(seed=0):
    jcfg = _cfgs("eafl")[0]
    params = jres.init_resnet(jax.random.PRNGKey(seed), jcfg.model)
    opt_state = jyogi(0.05).init(params)
    opt_state = dict(opt_state, t=jnp.int32(5),
                     m=jax.tree.map(lambda x: x + 0.25, opt_state["m"]))
    pop = jclients.make_population(jax.random.PRNGKey(seed + 1), 12)
    st = JState(round=jnp.int32(3), epsilon=jnp.float32(0.7),
                pacer_T=jnp.float32(150.0), util_ema=jnp.float32(1.5))
    key = jax.random.split(jax.random.PRNGKey(seed + 2))[1]
    ledger = JLedger(spent_j=jnp.float32(123.5), exhausted_round=jnp.int32(2))
    return {"params": params, "opt_state": opt_state, "pop": pop, "st": st,
            "kloop": key, "ledger": ledger}


def _port(state):
    """The reference state as the port holds it."""
    np_tree = jax.tree.map(np.asarray, state["params"])
    opt = state["opt_state"]
    return {
        "params": convert.resnet_params(np_tree, "cpu"),
        "opt_state": convert.optimizer_state(
            {"m": jax.tree.map(np.asarray, opt["m"]),
             "v": jax.tree.map(np.asarray, opt["v"]),
             "t": np.asarray(opt["t"])}, "cpu"),
        "pop": convert.population(state["pop"], "cpu"),
        "st": TState(*(torch.as_tensor(np.array(x))
                       for x in jax.tree.leaves(state["st"]))),
        "kloop": convert.key(state["kloop"], "cpu"),
        "ledger": TLedger(*(torch.as_tensor(np.array(x))
                            for x in jax.tree.leaves(state["ledger"]))),
    }


def _templates(port_state):
    """Fresh trees of the same structure, shapes and dtypes."""
    return {name: tck.tree_unflatten(
        tck.tree_flatten(tree)[1],
        [torch.zeros_like(x) for x in tck.tree_flatten(tree)[0]])
        for name, tree in port_state.items()}


def _file_leaves(tree):
    return [tck.checkpoint.to_file(x) for x in tck.tree_flatten(tree)[0]]


def test_leaves_in_the_reference_order():
    state = _reference_state()
    port = _port(state)
    for name in state:
        ref = [np.asarray(x) for x in jax.tree.leaves(state[name])]
        got = _file_leaves(port[name])
        assert len(ref) == len(got), name
        for r, g in zip(ref, got):
            assert r.dtype == g.dtype and r.shape == g.shape, name
            np.testing.assert_array_equal(r, g, name)


def test_reference_engine_file_loads_here(tmp_path):
    state = _reference_state()
    port = _port(state)
    path = str(tmp_path / "ref.ckpt")
    traj = {"selected": np.arange(6, dtype=np.int32).reshape(2, 3)}
    meta = {"family": "train-host", "rounds": 4}
    jck.save_engine_checkpoint(path, rnd=2, state=state,
                               data={"traj": traj, "wall": 0.5}, meta=meta)
    rnd, got, data, got_meta = tck.load_engine_checkpoint(
        path, _templates(port), expect_meta=meta)
    assert rnd == 2 and got_meta == meta and data["wall"] == 0.5
    np.testing.assert_array_equal(data["traj"]["selected"], traj["selected"])
    for name in port:
        for a, b in zip(tck.tree_flatten(got[name])[0],
                        tck.tree_flatten(port[name])[0]):
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_port_engine_file_loads_in_the_reference(tmp_path):
    state = _reference_state()
    port = _port(state)
    path = str(tmp_path / "port.ckpt")
    tck.save_engine_checkpoint(path, rnd=3, state=port,
                               data={"hist": {"round": [1, 2, 3]}},
                               meta={"family": "sync"})
    templates = jax.tree.map(jnp.zeros_like, state)
    rnd, got, data, _ = jck.load_engine_checkpoint(
        path, templates, expect_meta={"family": "sync"})
    assert rnd == 3 and list(data["hist"]["round"]) == [1, 2, 3]
    for name in state:
        for a, b in zip(jax.tree.leaves(got[name]),
                        jax.tree.leaves(state[name])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_params_files_cross_both_ways(tmp_path):
    state = _reference_state()
    port = _port(state)
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jck.save_checkpoint(jpath, state["params"], step=7, extra={"lr": 0.5})
    params, step, extra = tck.load_checkpoint(jpath)
    assert step == 7 and extra == {"lr": 0.5}
    for a, b in zip(tck.tree_flatten(params)[0],
                    tck.tree_flatten(port["params"])[0]):
        assert torch.equal(a, b)
    tck.save_checkpoint(tpath, port["params"], step=8)
    jparams, step, _ = jck.load_checkpoint(tpath)
    assert step == 8
    for a, b in zip(jax.tree.leaves(jparams),
                    jax.tree.leaves(state["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bad_files_raise(tmp_path):
    port = _port(_reference_state())
    path = str(tmp_path / "c.ckpt")
    meta = {"family": "train-host", "seed": 0}
    tck.save_engine_checkpoint(path, rnd=1, state=port, meta=meta)
    raw = open(path, "rb").read()
    templates = _templates(port)

    def load(blob, expect=meta, tmpl=templates):
        bad = str(tmp_path / "bad.ckpt")
        with open(bad, "wb") as f:
            f.write(blob)
        return tck.load_engine_checkpoint(bad, tmpl, expect_meta=expect)

    load(raw)                                               # sound
    flipped = bytearray(raw)
    flipped[len(raw) // 2] ^= 0x40
    for blob, match in ((bytes(flipped), "CRC32"), (raw[:-9], "truncated"),
                        (raw[:10], "truncated"), (b"x" * 64, "magic")):
        with pytest.raises(tck.CheckpointError, match=match):
            load(blob)
    with pytest.raises(tck.CheckpointError, match="different run"):
        load(raw, expect={"family": "train-host", "seed": 1})
    small = dict(templates, pop=convert.population(
        jclients.make_population(jax.random.PRNGKey(0), 5), "cpu"))
    with pytest.raises(tck.CheckpointError, match="does not match"):
        load(raw, tmpl=small)
    with pytest.raises(tck.CheckpointError, match="no state component"):
        load(raw, tmpl=dict(templates, extra=port["kloop"]))
    with pytest.raises(tck.CheckpointError):
        tck.load_engine_checkpoint(str(tmp_path / "missing.ckpt"), templates)


def test_segment_bounds_equal_the_reference():
    for total in range(0, 9):
        for start in range(0, total + 1):
            for every in (None, 0, 1, 2, 3, 5, 10):
                assert list(tck.segment_bounds(start, total, every)) == \
                    list(jck.segment_bounds(start, total, every))
    with pytest.raises(ValueError):
        list(tck.segment_bounds(3, 2, 1))


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's host loop (budget, deadline, overcommit, int8)
    with a snapshot after every round."""
    jcfg = _cfgs("eafl-budget")[0]
    path = str(tmp_path_factory.mktemp("ref") / "host-{round}.ckpt")
    jcfg = dataclasses.replace(jcfg, checkpoint_path=path,
                               checkpoint_every=1)
    return jserver.run_fl(jcfg, engine="host"), path


@pytest.mark.parametrize("r", [1, 2])
def test_reference_host_snapshot_resumes_here(reference_run, r,
                                              monkeypatch):
    ref, path = reference_run
    jcfg, tcfg = _cfgs("eafl-budget")
    _patch_reference_draws(monkeypatch, jcfg)
    assert os.path.exists(path.format(round=r))
    out = tserver.run_fl(dataclasses.replace(
        tcfg, resume_from=path.format(round=r)), device="cpu")
    assert out.round == ref.round
    for f in ("cum_dropouts", "quarantined", "update_skipped", "retries",
              "budget_exhausted_round"):
        assert getattr(out, f) == getattr(ref, f), f
    for f in ("fairness", "participation", "wall_hours", "mean_battery",
              "energy_spent_j", "round_duration"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=1e-5, err_msg=f)
    for f in ("train_loss", "test_acc"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=2e-3, err_msg=f)
    # the rounds before r come from the snapshot, as the reference wrote them
    assert out.train_loss[:r] == ref.train_loss[:r]


def test_port_host_resume_is_bitwise(tmp_path):
    _, tcfg = _cfgs("eafl-budget")
    tcfg = dataclasses.replace(tcfg, rounds=4)
    whole = tserver.run_fl(tcfg, device="cpu")
    path = str(tmp_path / "h-{round}.ckpt")
    seg = tserver.run_fl(dataclasses.replace(
        tcfg, checkpoint_path=path, checkpoint_every=2), device="cpu")
    resumed = tserver.run_fl(dataclasses.replace(
        tcfg, resume_from=path.format(round=2)), device="cpu")
    for out in (seg, resumed):
        assert out.as_dict().keys() == whole.as_dict().keys()
        for k, v in whole.as_dict().items():
            assert np.array_equal(np.asarray(getattr(out, k), np.float64),
                                  np.asarray(v, np.float64),
                                  equal_nan=True), k
    with pytest.raises(tck.CheckpointError, match="different run"):
        tserver.run_fl(dataclasses.replace(
            tcfg, seed=1, resume_from=path.format(round=2)), device="cpu")


def test_selector_state_templates_agree():
    """The templates each package builds for a resume hold the same
    leaves (the port's canonical state is 0-d tensors)."""
    j = JState.create(JSel("eafl", k=3)).canonical()
    t = TState.create(TSel("eafl", k=3)).canonical("cpu")
    assert [np.asarray(x).dtype for x in jax.tree.leaves(j)] == \
        [x.numpy().dtype for x in tck.tree_flatten(t)[0]]
