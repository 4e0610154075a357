"""The port's restart-parity checker, ``python -m
repro_torch.launch.elastic_check``, on the CPU: the round engines' matrix
(sync and async, single-device and on a 2-shard virtual mesh, faults, the
corruption smoke) and the async family of the training matrix, each
printing its OK line; a shard count below 1 is refused."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_training_engines import one_thread  # noqa: E402,F401
from repro_torch.launch import elastic_check  # noqa: E402


def test_engine_matrix(capsys):
    assert elastic_check.main(["--devices", "2", "--n", "101",
                               "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for leg in ("sync sharded random", "async sharded eafl",
                "fault-config mismatch refused", "corruption bit-flip",
                "corruption every-without-path"):
        assert f"  {leg}: OK" in out, leg
    assert "elastic parity OK (2 shards)" in out


def test_async_training_matrix(capsys):
    assert elastic_check.main(["--devices", "2", "--train", "--only",
                               "async", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for leg in ("train async host-vs-scanned", "train async-sharded eafl",
                "train cross-engine async scanned->sharded"):
        assert f"  {leg}: OK" in out, leg
    assert "train scanned eafl" not in out
    assert "elastic training parity OK (2 shards, async)" in out


@pytest.mark.parametrize("bad", ["0", "-2"])
def test_devices_below_one_are_refused(bad):
    with pytest.raises(SystemExit):
        elastic_check.main(["--devices", bad, "--device", "cpu"])
