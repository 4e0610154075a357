"""The attention backward's plain version and the differentiable wrapper,
on the CPU.

``repro_torch.kernels.ref.flash_attention_bwd`` (the plain version of the
backward kernel, ``csrc/flash_attention_bwd.cu``) against torch's autograd
of the plain forward ``ref.flash_attention`` and against ``jax.vjp`` of
the reference's ``repro.models.attention.multihead_attention`` (the
reference has no backward kernel: it differentiates its pure-jnp
attention); the forward's log-sum-exp against the reference's scores; and
``ops.flash_attention`` under grad (an ``autograd.Function`` whose CPU
path is these plain versions), including a gradient that arrives
non-contiguous. Inputs come from numpy with a seed, in the model's
``(B, S, H, hd)`` layout.

Cases: causal and not, GQA (H 4 over KH 2), a ragged S (37, 100: not a
multiple of the kernel's 64-row tiles), hd 64 and 128. Tolerance: 2e-5 in
f32, the JAX package's own for attention (tests/test_kernels.py); bf16
outputs within 2e-2 of the f32 gradient of the same bf16 inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 2e-5
# B, S, H, KH, hd
CASES = [(2, 64, 4, 2, 64), (1, 100, 2, 2, 128), (1, 128, 4, 4, 64),
         (2, 37, 4, 2, 128)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, KH, D, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, H, D).astype(np.float32)
    k, v = (rs.randn(B, S, KH, D).astype(np.float32) for _ in range(2))
    do = rs.randn(B, S, H, D).astype(np.float32)
    return q, k, v, do


def _ids(case):
    return "x".join(map(str, case))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_bwd_matches_autograd_and_reference(case, causal):
    q, k, v, do = _inputs(*case, seed=sum(case))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_fwd_lse(tq, tk, tv, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (case[0], case[2],
                                                        case[1])
    got = ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal)

    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = ref.flash_attention(*leaves, causal=causal)
    auto = torch.autograd.grad(out, leaves, tdo)
    _, vjp = jax.vjp(lambda a, b, c: jattn.multihead_attention(
        a, b, c, causal=causal), *map(jnp.asarray, (q, k, v)))
    jax_grads = vjp(jnp.asarray(do))
    for name, g, a, j in zip("qkv", got, auto, jax_grads):
        assert g.shape == a.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=TOL, rtol=TOL,
                                   err_msg=f"d{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name} vs jax.vjp")


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_reference_scores(causal):
    """The saved log-sum-exp is the natural log of the row's sum over the
    scaled, masked scores, as the reference's softmax sees them."""
    B, S, H, KH, D = 2, 100, 4, 2, 64
    q, k, v, _ = _inputs(B, S, H, KH, D, seed=5)
    _, lse = ref.flash_attention_fwd_lse(*map(torch.from_numpy, (q, k, v)),
                                         causal=causal)
    kr = np.repeat(k, H // KH, axis=2)
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, kr) * D ** -0.5
    if causal:
        scores = jnp.where(jnp.tril(jnp.ones((S, S), bool)), scores, -1e30)
    np.testing.assert_allclose(lse.numpy(), np.asarray(
        jax.nn.logsumexp(scores, axis=-1)), atol=TOL, rtol=TOL)


def test_wrapper_is_differentiable_on_the_cpu():
    """Under grad ``ops.flash_attention`` is the autograd.Function: its
    output equals the plain forward's bit for bit, its backward is
    ``ref.flash_attention_bwd`` (for a gradient that arrives
    non-contiguous too), and nothing is launched on the CPU."""
    B, S, H, KH, D = 2, 100, 4, 2, 64
    q, k, v, do = _inputs(B, S, H, KH, D, seed=9)
    base = {n: ops.LAUNCHES[n] for n in ("flash_attention",
                                          "flash_attention_bwd")}
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(*leaves)
    assert out.grad_fn is not None
    with torch.no_grad():
        plain = ops.flash_attention(*leaves)
    assert plain.grad_fn is None and torch.equal(out, plain)
    # a (B, H, S, hd) buffer seen as (B, S, H, hd): not contiguous
    g = torch.from_numpy(np.ascontiguousarray(do.transpose(0, 2, 1, 3)))
    g = g.transpose(1, 2)
    assert not g.is_contiguous()
    got = torch.autograd.grad(out, leaves, g)
    o, lse = ref.flash_attention_fwd_lse(*(t.detach() for t in leaves))
    exp = ref.flash_attention_bwd(*(t.detach() for t in leaves), o, lse,
                                  torch.from_numpy(do))
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    direct = ops.flash_attention_bwd(*(t.detach() for t in leaves), o, lse, g)
    for a, b in zip(direct, exp):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert {n: ops.LAUNCHES[n] for n in base} == base


def test_bwd_bf16_close_to_f32():
    """bf16 inputs: the plain backward computes in f32 and rounds each
    gradient once, so it lies within bf16 rounding of the f32 gradient of
    the same (bf16-valued) inputs."""
    B, S, H, KH, D = 1, 64, 4, 2, 128
    arrs = [torch.from_numpy(a).to(torch.bfloat16)
            for a in _inputs(B, S, H, KH, D, seed=13)]
    q, k, v, do = arrs
    o, lse = ref.flash_attention_fwd_lse(q, k, v)
    got = ref.flash_attention_bwd(q, k, v, o, lse, do)
    o32, lse32 = ref.flash_attention_fwd_lse(q.float(), k.float(), v.float())
    exp = ref.flash_attention_bwd(q.float(), k.float(), v.float(), o32,
                                  lse32, do.float())
    for a, b in zip(got, exp):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=2e-2,
                                   rtol=2e-2)
