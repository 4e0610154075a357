"""The port's runtime sanitizers (``repro_torch.analysis.runtime``) on the
CPU: ``strict_mode`` refuses every implicit host read and host-data
tensor (the fused engines' "no host read inside a round" contract, which
a CUDA graph needs) outside ``setup_transfers`` windows, and with
``debug_nans`` every NaN an eager operator makes; ``retrace_guard``
counts the step captures ``federated/replay.py`` logs.

The five fused engines run whole under ``strict_mode(debug_nans=True)``
(checkpointed and resumed runs under ``strict_mode()``) and give the
unguarded run's bits; a checkpointed 6-round run in 3 segments captures
each step once; a planted host read and a planted second ``StepGraphs``
are caught. The reference's sizes: 17 and 23 clients, 4-6 rounds."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.analysis import runtime  # noqa: E402
from repro_torch.analysis.runtime import (device_get,  # noqa: E402
                                          retrace_guard, setup_transfers,
                                          strict_mode)
from repro_torch.configs.paper_resnet_speech import reduced  # noqa: E402
from repro_torch.core.clients import make_population  # noqa: E402
from repro_torch.core.energy import EnergyModel  # noqa: E402
from repro_torch.core.selection import (SelectorConfig,  # noqa: E402
                                        SelectorState)
from repro_torch.federated import async_server as tasync  # noqa: E402
from repro_torch.federated import server as tserver  # noqa: E402
from repro_torch.federated import simulation as tsim  # noqa: E402
from repro_torch.federated.replay import StepGraphs  # noqa: E402

ASYNC = dict(buffer_size=3, max_concurrency=5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the engines are many small operators, which a
    team of threads in each of pytest's workers only slows."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(selector=SelectorConfig("eafl", k=4), n_clients=17, rounds=4,
                local_steps=1, batch_size=4, samples_per_client=8,
                input_hw=16, eval_samples=32, eval_every=2,
                model=dataclasses.replace(reduced(), input_hw=16))
    base.update(kw)
    return tserver.FLConfig(**base)


def _assert_bitwise(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        assert np.array_equal(np.asarray(da[k], np.float64),
                              np.asarray(db[k], np.float64),
                              equal_nan=True), k


def _assert_same_tree(a, b):
    assert type(a) is type(b)
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b)
    else:
        assert a == b


# ---------------------------------------------------------- strict mode


@pytest.mark.parametrize("read", ["float", "mask", "host-tensor", "item",
                                  "nonzero"])
def test_strict_mode_blocks_implicit_transfers(read):
    t = torch.arange(4.0)
    f = {"float": lambda: float(t.sum()), "mask": lambda: t[t > 0],
         "host-tensor": lambda: torch.tensor([1.0, 2.0]),
         "item": lambda: t[1].item(),
         "nonzero": lambda: torch.nonzero(t)}[read]
    with strict_mode():
        with pytest.raises(runtime.HostTransferError):
            f()
    f()                         # unguarded, it reads freely


def test_setup_transfers_window_and_device_get_are_exempt():
    with strict_mode():
        with setup_transfers():
            x = torch.tensor([1.0, 2.0, 3.0])
            assert float(x.sum()) == 6.0
        y = x * 2                           # device work stays legal
        got = device_get({"y": y, "n": (y[0], 3)})
        with pytest.raises(runtime.HostTransferError):
            float(y[0])                     # the window is closed again
    assert got["y"].tolist() == [2.0, 4.0, 6.0]
    assert float(got["n"][0]) == 2.0 and got["n"][1] == 3
    got["y"][0] = -1.0                      # its own memory
    assert float(y[0]) == 2.0


def test_debug_nans():
    x = torch.tensor([0.0, 1.0])
    with strict_mode():
        y = x / x                           # no NaN check unless asked
    assert torch.isnan(y[0])
    with strict_mode(debug_nans=True):
        z = x + 1
        with pytest.raises(runtime.NaNError):
            x / x
    # freed NaNs that the allocator may hand back: an allocation is not
    # checked (its bits are the allocator's)
    torch.empty(1 << 16).fill_(float("nan"))
    with strict_mode(debug_nans=True):
        assert torch.empty(1 << 16).shape == (1 << 16,)
    assert torch.equal(z, torch.tensor([1.0, 2.0]))


def test_a_planted_host_read_in_a_step_is_caught():
    steps, carry0 = tserver._fused_engine(_cfg(), torch.device("cpu"))

    def reads_the_host(carry, ctr):
        carry, outs = steps[1](carry, ctr)
        return carry, dict(outs, acc=torch.full((), outs["test_acc"].item()))

    graphs = StepGraphs(carry0, 2)
    graphs.add("eval", reads_the_host)
    with strict_mode(), pytest.raises(runtime.HostTransferError):
        graphs.run("eval")


# ------------------------------------------------- the fused engines


ENGINES = {
    "scanned": (tserver.run_fl_scanned, {}),
    "sharded-1": (functools.partial(tserver.run_fl_sharded, n_shards=1), {}),
    "sharded-4": (functools.partial(tserver.run_fl_sharded, n_shards=4), {}),
    "async-scanned": (tasync.run_fl_async_scanned, ASYNC),
}


@functools.lru_cache(maxsize=None)
def _unguarded(engine):
    run, extra = ENGINES[engine]
    return run(_cfg(**extra), device="cpu")


@pytest.mark.parametrize("engine", list(ENGINES))
def test_fused_engine_runs_strict_and_bitwise(engine):
    run, extra = ENGINES[engine]
    with strict_mode(debug_nans=True):
        strict = run(_cfg(**extra), device="cpu")
    _assert_bitwise(strict, _unguarded(engine))


@pytest.mark.parametrize("engine", ["scanned", "sharded-4", "async-scanned"])
def test_checkpointed_and_resumed_runs_strict(engine, tmp_path):
    run, extra = ENGINES[engine]
    ck = str(tmp_path / "strict_{round}.ck")
    with strict_mode():
        seg = run(_cfg(checkpoint_every=2, checkpoint_path=ck, **extra),
                  device="cpu")
        resumed = run(_cfg(resume_from=ck.format(round=2), **extra),
                      device="cpu")
    _assert_bitwise(seg, _unguarded(engine))
    _assert_bitwise(resumed, _unguarded(engine))


def _selection_inputs():
    pop = make_population(prng.PRNGKey(3, "cpu"), 23)
    sel = SelectorConfig("eafl", k=5)
    return (prng.PRNGKey(1, "cpu"), sel, pop, SelectorState.create(sel),
            EnergyModel(), 85e6, 10, 20)


@pytest.mark.parametrize("engine", ["rounds", "async"])
def test_selection_engines_run_strict_and_bitwise(engine, tmp_path):
    run = {"rounds": tsim.run_rounds_scanned,
           "async": functools.partial(tsim.run_async_scanned,
                                      **ASYNC)}[engine]
    args = _selection_inputs()
    plain = run(*args, rounds=4)
    with strict_mode(debug_nans=True):
        strict = run(*args, rounds=4)
    ck = str(tmp_path / "sel_{round}.ck")
    with strict_mode():
        run(*args, rounds=4, checkpoint_every=2, checkpoint_path=ck)
        resumed = run(*args, rounds=4, resume_from=ck.format(round=2))
    for out in (strict, resumed):
        _assert_same_tree(list(out), list(plain))


# ------------------------------------------------------ retrace guard


def test_one_capture_a_step_across_segments(tmp_path):
    ck = str(tmp_path / "seg_{round}.ck")
    cfg = _cfg(n_clients=23, rounds=6, checkpoint_every=2,
               checkpoint_path=ck)
    with strict_mode(), retrace_guard(watch=("round", "eval")) as log:
        tserver.run_fl_scanned(cfg, device="cpu")
    log.assert_compiled_once("round", "eval")
    assert log.compiles_of("round") == 1 and log.compiles_of("eval") == 1
    assert log.records[0].startswith("Capturing round with carry shapes "
                                     "and types [")
    # a resumed run builds its steps once too
    with retrace_guard(watch=("round", "eval")) as log:
        tserver.run_fl_scanned(dataclasses.replace(
            cfg, resume_from=ck.format(round=4)), device="cpu")
    assert log.compiles_of("round") == 1 and not log.retraced()


def test_a_planted_second_capture_is_detected():
    steps, carry0 = tserver._fused_engine(_cfg(), torch.device("cpu"))
    with retrace_guard(watch=("round",)) as log:
        for _ in range(2):      # a second StepGraphs over the same step
            graphs = StepGraphs(carry0, 4)
            graphs.add("round", steps[0], advance=True)
            graphs.run("round")
            graphs.run("round")
    assert log.compiles_of("round") == 2
    assert list(log.retraced().values()) == [2]
    with pytest.raises(AssertionError, match="recapture"):
        log.assert_no_retrace()
    once = runtime.CompileLog(records=log.records[:1])
    once.assert_compiled_once("round")
    with pytest.raises(AssertionError, match="expected a capture of 'eval'"):
        once.assert_compiled_once("eval")


def test_retrace_guard_restores_the_logger():
    import logging
    logger = logging.getLogger(runtime.REPLAY_LOGGER)
    level = logger.level
    with retrace_guard() as log:
        assert logger.isEnabledFor(logging.INFO)
    assert logger.level == level and log.records == []
