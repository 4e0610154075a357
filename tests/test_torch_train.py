"""The port's user front doors on the CPU: ``launch/train.py``'s ``fl``
subcommand and the example twins (``repro_torch.examples``).

``train fl`` must write the history ``run_fl`` returns for the same
arguments, exactly; ``train cohort`` parses its arguments and raises
(ROADMAP.md queue 1 item 16); without ``--device`` both need a card. The
examples run at a small size with ``--device cpu``: the quickstart's
histories equal ``run_fl`` of its configs, the million-client example's
own assertions (kernel == plain, ``select`` == ``select_host``) hold, and
the FedBuff example's parity leg holds.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_training_engines import one_thread  # noqa: E402,F401
from repro_torch.federated import run_fl  # noqa: E402
from repro_torch.launch import train  # noqa: E402

FL_ARGS = ["fl", "--rounds", "2", "--clients", "8", "--k", "2",
           "--local-steps", "1", "--batch-size", "4", "--selector", "oort"]


def test_train_fl_writes_the_run_fl_history(tmp_path):
    hist = train.main(FL_ARGS + ["--device", "cpu", "--out", str(tmp_path)])
    saved = json.loads((tmp_path / "history.json").read_text())
    cfg = train.fl_config(train.parser().parse_args(FL_ARGS))
    assert cfg.selector.kind == "oort" and cfg.n_clients == 8
    direct = run_fl(cfg, device="cpu")
    assert saved.keys() == direct.as_dict().keys()
    for k, v in direct.as_dict().items():
        assert np.array_equal(np.asarray(saved[k], np.float64),
                              np.asarray(v, np.float64), equal_nan=True), k
    assert saved["round"] == [1, 2] == hist.round


def test_train_cohort_parses_and_names_its_item():
    with pytest.raises(NotImplementedError, match="item 16"):
        train.main(["cohort", "--arch", "olmo-1b", "--steps", "2",
                    "--device", "cpu"])


def test_train_needs_cuda_or_an_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(FL_ARGS + ["--out", str(tmp_path)])
    assert not (tmp_path / "history.json").exists()


def test_quickstart_twin_runs_run_fl():
    from repro_torch.examples import quickstart
    out = quickstart.main(["--rounds", "2", "--clients", "12",
                           "--device", "cpu"])
    assert list(out) == ["eafl", "oort", "random"]
    direct = run_fl(quickstart.fl_config("oort", 2, 12, 0.25), device="cpu")
    assert out["oort"].test_acc == direct.test_acc
    assert out["oort"].cum_dropouts == direct.cum_dropouts


def test_million_client_selection_twin_checks_itself():
    from repro_torch.examples import million_client_selection as mcs
    times = mcs.main(["--n", "4099", "--k", "20", "--rounds", "2",
                      "--devices", "3", "--device", "cpu"])
    assert {"kernel_s", "select_s", "select_host_s", "scan_s",
            "shard_s"} <= set(times)


def test_async_fedbuff_twin_parity_leg():
    from repro_torch.examples import async_fedbuff
    sync, asyn = async_fedbuff.parity_demo(rounds=3, n=40, k=4,
                                           device="cpu")
    assert sync["engine"] == "scanned"
    assert asyn["engine"] == "async-scanned"
    cfg = async_fedbuff.fl_config("eafl", 2, buffer_size=2,
                                  max_concurrency=6, n_clients=16)
    assert run_fl(cfg, device="cpu").round == [1, 2]
