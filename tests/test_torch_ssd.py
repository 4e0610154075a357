"""The port's SSD scan against the reference's, on the CPU.

The port's plain SSD (``repro_torch.kernels.ref.ssd_chunk``, the
sequential recurrence that ``ops.ssd_chunk`` takes for CPU tensors) and the
model's chunked plain route (``models.mamba._ssd_chunked``) against the
reference's Pallas kernel in interpret mode and its oracle
``ssd_chunk_ref``. Inputs come from numpy with a seed.

Tolerances are the JAX package's own (tests/test_kernels.py): 5e-4 in
f32, 1e-1 in bf16 (outputs of magnitude up to ~70 here)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402


def _inputs(B, S, nh, hd, ds, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, nh, hd).astype(np.float32)
    Bm = rs.randn(B, S, ds).astype(np.float32)
    Cm = rs.randn(B, S, ds).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(B, S, nh))).astype(np.float32)
    A = (-np.exp(rs.randn(nh))).astype(np.float32)
    return x, Bm, Cm, dt, A


@pytest.mark.parametrize("S", [64, 256])
def test_plain_ssd_matches_reference_kernel_and_oracle(S):
    args = _inputs(2, S, 4, 64, 16, S)
    before = ops.LAUNCHES["ssd_chunk"]
    got = ops.ssd_chunk(*map(torch.from_numpy, args)).numpy()
    assert ops.LAUNCHES["ssd_chunk"] == before   # CPU: plain version
    jargs = [jnp.asarray(a) for a in args]
    kern = np.asarray(jops.ssd_chunk(*jargs, interpret=True))
    oracle = np.asarray(jref.ssd_chunk_ref(*jargs))
    np.testing.assert_allclose(got, kern, atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(got, oracle, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("S", [64, 256])
def test_model_chunked_route_matches_oracle(S):
    """The plain route ``mamba2_forward`` takes off the card (chunks of
    ``SSD_CHUNK``=128, f32 compute dtype) computes the same scan."""
    cfg = get_reduced("zamba2-1.2b").with_(compute_dtype=torch.float32)
    args = _inputs(1, S, 4, 64, 16, S + 1)
    got = tmamba._ssd_chunked(cfg, *map(torch.from_numpy, args)).numpy()
    oracle = np.asarray(jref.ssd_chunk_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, oracle, atol=5e-4, rtol=5e-4)


def test_plain_ssd_bf16_matches_oracle():
    x, Bm, Cm, dt, A = _inputs(1, 128, 4, 64, 16, 5)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    got = ref.ssd_chunk(bf(x), bf(Bm), bf(Cm), torch.from_numpy(dt),
                        torch.from_numpy(A))
    assert got.dtype == torch.bfloat16
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    oracle = np.asarray(jref.ssd_chunk_ref(jb(x), jb(Bm), jb(Cm),
                                           jnp.asarray(dt), jnp.asarray(A)),
                        np.float32)
    np.testing.assert_allclose(got.float().numpy(), oracle, atol=1e-1,
                               rtol=1e-1)
