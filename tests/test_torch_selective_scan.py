"""The port's Mamba1 selective scan against the reference's, on the CPU.

The port's plain scan (``repro_torch.kernels.ref.selective_scan``, the
sequential recurrence that ``ops.selective_scan`` takes for CPU tensors)
against the reference's Pallas kernel in interpret mode and its oracle
``selective_scan_ref``, at the reference's own shapes and tolerances
(tests/test_kernels.py: 1e-4 in f32, 5e-2 in bf16); and the model's plain
Mamba1 route (``models.mamba.mamba1_forward``, ``use_kernel=False``)
against the reference's ``mamba1_forward`` with one block's parameters
carried across. Inputs come from numpy with a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SHAPES = [(1, 32, 64, 8), (2, 64, 128, 16), (1, 128, 256, 16)]


def _inputs(B, S, di, ds, seed, dtype="float32", dt_shift=0.0):
    """As the reference's test draws them: dt after softplus (of N(dt_shift,
    1)), A negative, D ones; x, dt, B, C rounded to ``dtype`` (numpy f32
    arrays)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, di).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(B, S, di) + dt_shift)).astype(np.float32)
    Bm = rs.randn(B, S, ds).astype(np.float32)
    Cm = rs.randn(B, S, ds).astype(np.float32)
    A = (-np.exp(rs.randn(di, ds))).astype(np.float32)
    D = np.ones((di,), np.float32)
    if dtype == "bfloat16":
        x, dt, Bm, Cm = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                         for a in (x, dt, Bm, Cm))
    return x, dt, Bm, Cm, A, D


def _torch(args, dtype):
    td = getattr(torch, dtype)
    return [torch.from_numpy(a).to(td) if i < 4 else torch.from_numpy(a)
            for i, a in enumerate(args)]


def _jax(args, dtype):
    jd = getattr(jnp, dtype)
    return [jnp.asarray(a, jd) if i < 4 else jnp.asarray(a)
            for i, a in enumerate(args)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_matches_reference_kernel_and_oracle(shape, dtype):
    B, S, di, ds = shape
    args = _inputs(B, S, di, ds, S + di, dtype)
    before = ops.LAUNCHES["selective_scan"]
    got = ops.selective_scan(*_torch(args, dtype))
    assert ops.LAUNCHES["selective_scan"] == before   # CPU: plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, di)
    got = got.float().numpy()
    jargs = _jax(args, dtype)
    kern = np.asarray(jops.selective_scan(*jargs, block_d=di // 2,
                                          interpret=True), np.float32)
    oracle = np.asarray(jref.selective_scan_ref(*jargs), np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, kern, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=tol)


def test_plain_scan_with_slow_decay_matches_oracle():
    """dt about 0.02 (as trained Mamba models set it): states remember
    about a thousand steps, so f32 rounding that drifts each step adds up;
    the plain version still meets the reference's 1e-4."""
    args = _inputs(1, 1024, 64, 16, 11, dt_shift=-4.0)
    got = ops.selective_scan(*map(torch.from_numpy, args)).numpy()
    oracle = np.asarray(jref.selective_scan_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, oracle, atol=1e-4, rtol=1e-4)


def test_plain_scan_reads_strided_b_and_c():
    """B and C as slices of one packed projection, as the model hands them
    over (batch and sequence strides of the packed width): the same result
    as from contiguous copies."""
    x, dt, Bm, Cm, A, D = _inputs(2, 40, 96, 16, 7)
    rs = np.random.RandomState(8)
    packed = np.concatenate([rs.randn(2, 40, 5).astype(np.float32), Bm, Cm],
                            axis=-1)
    tp = torch.from_numpy(packed)
    tB, tC = tp[..., 5:21], tp[..., 21:]
    assert not tB.is_contiguous() and tB.stride() == (40 * 37, 37, 1)
    got = ops.selective_scan(torch.from_numpy(x), torch.from_numpy(dt), tB,
                             tC, torch.from_numpy(A), torch.from_numpy(D))
    oracle = np.asarray(jref.selective_scan_ref(
        *map(jnp.asarray, (x, dt, Bm, Cm, A, D))))
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S", [1, 7, 33])
def test_model_plain_route_matches_reference_mamba1(S):
    """One reduced falcon-mamba-7b Mamba1 block (d_model 256, di 512, ds 8,
    dt_rank 16), the reference's parameters carried across, f32 compute:
    the port's plain route and its kernel route (on the CPU the kernel's
    plain version) against the reference's ``mamba1_forward``."""
    jcfg = jget_reduced("falcon-mamba-7b").with_(compute_dtype=jnp.float32)
    tcfg = get_reduced("falcon-mamba-7b").with_(compute_dtype=torch.float32)
    jp = jmamba.init_mamba1(jax.random.PRNGKey(S), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.RandomState(S).randn(2, S, jcfg.d_model).astype(np.float32)
    exp = np.asarray(jax.jit(lambda p, x: jmamba.mamba1_forward(jcfg, p, x))(
        jp, jnp.asarray(x)))
    for use_kernel in (False, True):
        got = tmamba.mamba1_forward(tcfg, tp, torch.from_numpy(x),
                                    use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), exp, atol=1e-4, rtol=1e-4,
                                   err_msg=f"use_kernel={use_kernel}")


def test_init_mamba1_materialises_a_log():
    """``A_log`` is a full (di, ds) tensor of log(1..ds), as the
    reference's, not a broadcast view."""
    cfg = get_reduced("falcon-mamba-7b")
    p = tmamba.init_mamba1(torch.Generator().manual_seed(0), cfg)
    jp = jmamba.init_mamba1(jax.random.PRNGKey(0), jget_reduced(
        "falcon-mamba-7b"))
    assert p["A_log"].is_contiguous()
    assert p["A_log"].shape == (cfg.d_inner, cfg.ssm_state)
    # torch's and XLA's log of 1..ds differ by one ulp in one column
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=2e-7, atol=0)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
