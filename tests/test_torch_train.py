"""The port's user front doors on the CPU: ``launch/train.py``'s ``fl``
subcommand and the example twins (``repro_torch.examples``).

``train fl`` must write the history ``run_fl`` returns for the same
arguments, exactly; ``train cohort`` parses its arguments and runs every
arch (here the vision frontend's); without ``--device`` both need a
card. ``train cohort`` and ``launch.serve`` run the MoE archs
(llama4-scout-17b-a16e, deepseek-v2-236b) at their reduced configs. The
examples run at a small size with ``--device cpu``: the quickstart's histories equal ``run_fl`` of its configs, the
million-client example's own assertions (kernel == plain, ``select`` ==
``select_host``) hold, the FedBuff example's parity leg holds, and the
serving example decodes in-range tokens at its defaults.
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


def test_train_cohort_parses_and_names_its_item(capsys):
    """Every arch trains (tests/test_torch_lm_train.py,
    tests/test_torch_lm_dense.py, tests/test_torch_lm_frontends.py, the
    MoE cases below): the vision frontend's ``--arch`` parses, runs its
    steps on batches that carry patch embeddings, and the summary line
    names it."""
    args = train.parser().parse_args(["cohort", "--arch", "internvl2-2b",
                                      "--steps", "3", "--device", "cpu"])
    assert (args.arch, args.steps, args.device) == ("internvl2-2b", 3, "cpu")
    losses = train.main_cohort(args)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "[cohort:internvl2-2b]" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "deepseek-v2-236b"])
def test_train_cohort_runs_an_moe_arch(arch, capsys):
    """``train cohort`` at the reference's defaults (10 AdamW steps of
    4 x 64 tokens); it raises unless its loss falls."""
    losses = train.main(["cohort", "--device", "cpu", "--arch", arch])
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert f"[cohort:{arch}]" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-scout-17b-a16e"])
def test_serve_runs_an_moe_arch(arch, capsys):
    """``python -m repro_torch.launch.serve --arch ARCH --device cpu`` at
    its defaults (batch 4, prompt 32, gen 16): in-range tokens."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--device", "cpu"])
    assert out.tokens.shape == (4, 16)
    assert f"[{arch}] batch=4 prompt=32 gen=16" in capsys.readouterr().out


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


def test_serve_decode_twin_decodes_at_its_defaults(capsys):
    """``python -m repro_torch.examples.serve_decode --device cpu``: reduced
    phi3-mini-3.8b, batch 2, prompt 16, gen 8, as the reference's
    example."""
    from repro_torch.configs import get_reduced
    from repro_torch.examples import serve_decode
    out = serve_decode.main(["--device", "cpu"])
    vocab = get_reduced("phi3-mini-3.8b").vocab_size
    assert out.tokens.shape == (2, 8) and out.prompt_logits.shape == (
        2, 1, vocab)
    assert bool(((out.tokens >= 0) & (out.tokens < vocab)).all())
    assert "[phi3-mini-3.8b] batch=2 prompt=16 gen=8" in \
        capsys.readouterr().out
