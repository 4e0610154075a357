"""The port's attention against the reference's, on the CPU.

The port's plain attention (``repro_torch.kernels.ref.flash_attention``,
which ``ops.flash_attention`` takes for CPU tensors) against the
reference's Pallas kernel in interpret mode and its oracle
``flash_attention_ref``; and the port's ``multihead_attention`` against
the reference's at S=1024, where both take the query-chunked path.
Inputs come from numpy with a seed. The port's functions take the model's
``(B, S, H, hd)`` layout, the reference's kernel ``(B, H, S, D)``.

Tolerances: 2e-5 in f32 (the JAX package's own, tests/test_kernels.py);
2e-2 in bf16, where both sides cast the softmax weights to bf16."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402


def _bhsd(shape, seed, n=3):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n)]


def _to_port(a, dtype=torch.float32):
    """(B, H, S, D) numpy -> (B, S, H, D) tensor."""
    return torch.from_numpy(a).transpose(1, 2).to(dtype)


@pytest.mark.parametrize("shape", [(1, 2, 128, 64), (2, 4, 256, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_reference_kernel_and_oracle(shape, causal):
    q, k, v = _bhsd(shape, sum(shape))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(*map(_to_port, (q, k, v)), causal=causal)
    assert ops.LAUNCHES["flash_attention"] == before   # CPU: plain version
    got = got.transpose(1, 2).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kern = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal,
                                           interpret=True))
    oracle = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(got, kern, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=2e-5)


def test_plain_attention_bf16_matches_oracle():
    q, k, v = _bhsd((2, 4, 128, 64), 7)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    oracle = np.asarray(jref.flash_attention_ref(jq, jk, jv), np.float32)
    got = ref.flash_attention(*(_to_port(a, torch.bfloat16)
                                for a in (q, k, v)))
    np.testing.assert_allclose(got.float().transpose(1, 2).numpy(), oracle,
                               atol=2e-2, rtol=2e-2)


def test_plain_attention_maps_query_heads_to_kv_heads():
    """GQA: query head h reads KV head h // G, as the reference model's
    reshape to (KH, G) does."""
    rs = np.random.RandomState(3)
    B, S, H, KH, D = 2, 64, 6, 2, 64
    q = rs.randn(B, S, H, D).astype(np.float32)
    k, v = (rs.randn(B, S, KH, D).astype(np.float32) for _ in range(2))
    got = ref.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    rep = lambda a: np.repeat(a, H // KH, axis=2).transpose(0, 2, 1, 3)
    oracle = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(rep(k)),
        jnp.asarray(rep(v)))).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_multihead_attention_chunked_path_matches_reference(use_kernel):
    """S=1024 > Q_CHUNK: the reference scans two 512-row query chunks; the
    port's plain route loops over them, and its kernel route (the plain
    version on the CPU) computes the same function in one piece."""
    rs = np.random.RandomState(11)
    B, S, H, KH, D = 1, 1024, 4, 2, 64
    q = rs.randn(B, S, H, D).astype(np.float32)
    k, v = (rs.randn(B, S, KH, D).astype(np.float32) for _ in range(2))
    exp = np.asarray(jattn.multihead_attention(*map(jnp.asarray, (q, k, v)),
                                               causal=True))
    got = tattn.multihead_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=True, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), exp, atol=2e-5, rtol=2e-5)
