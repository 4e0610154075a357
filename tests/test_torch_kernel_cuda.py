"""The Hopper ``topk_reward`` kernel against its plain version, on the
card. Skips with a reason where no CUDA device is present (the kernel has
no CPU or interpret mode); ``python3 chip_smoke.py`` runs the full matrix.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernel_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(4096, 1), (100_003, 100), (9000, 4096)])
@pytest.mark.parametrize("mode", ["eafl", "oort", "eafl-epj"])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8, torch.int32])
def test_kernel_equals_plain_version(n, k, mode, mask_dtype):
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(n + k)
    a, b, u = (torch.rand(n, generator=g).to(dev) for _ in range(3))
    valid = (torch.rand(n, generator=g) < 0.7).to(mask_dtype).to(dev)
    kw = dict(f=0.3, k=k, mode=mode, ucb=u, index_offset=7)
    before = ops.LAUNCHES["topk_reward"]
    kv, ki = ops.topk_reward(a, b, valid, **kw)
    pv, pi = ref.topk_reward(a, b, valid, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topk_reward"] == before + 1
    assert torch.equal(ki, pi)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
    dev = _card()
    a = torch.rand(100, device=dev)
    valid = torch.ones(100, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ops.topk_reward(a, a, valid, f=0.25, k=101)
    with pytest.raises(TypeError):
        ops.topk_reward(a.double(), a, valid, f=0.25, k=5)
