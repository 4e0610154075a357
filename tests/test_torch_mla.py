"""Multi-head latent attention and the attention kernel's q.k / v widths,
on the CPU.

- ``repro_torch.models.mla``: ``mla_forward`` (the decompressed form,
  through ``multihead_attention`` on both routes) and ``mla_decode`` (the
  absorbed form against the latent cache, full and ring) against
  ``repro.models.mla`` on the reference's weights, at reduced
  minicpm3-4b's widths (q.k 32 + 16, v 32, latent rank 64, q rank 96) and
  with ``q_lora_rank = 0`` (the ``wq`` path); f32, within 2e-4.
- The plain attention at a q.k width that is not v's (the widths
  minicpm3-4b's kernel pairs take, and GQA, where dv is summed over a KV
  head's query heads at v's width): ``ops.flash_attention`` (on the CPU
  the kernel's plain version), ``ref.flash_attention_bwd`` (the backward
  kernel's plain version) and ``ops.flash_attention`` under grad against
  ``repro.models.attention.multihead_attention`` and ``jax.vjp`` of it,
  within 2e-5 (the JAX package's attention tolerance, f32).
- The wrapper's checks (``kernels/flash_attention.py``): the built (q.k,
  v) pairs pass, in the backward's check too (the backward library is
  built for every forward pair, deepseek-v2-236b's (192, 128) included);
  an unbuilt pair and mismatched shapes raise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.attention import multihead_attention  # noqa: E402

TOL = 2e-5
MLA_TOL = 2e-4
B, S = 2, 40
# B, S, H, KH, Dqk, Dv: the reduced MLA pair, the full one with GQA, and
# a ragged S, and deepseek-v2-236b's full pair (192, 128) ragged
CASES = [(2, 64, 4, 4, 48, 32), (1, 37, 4, 2, 96, 64),
         (2, 70, 2, 2, 96, 64), (1, 33, 4, 4, 192, 128)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(q_lora):
    jcfg = jget_reduced("minicpm3-4b").with_(compute_dtype=jnp.float32)
    tcfg = get_reduced("minicpm3-4b").with_(compute_dtype=torch.float32)
    if not q_lora:
        jcfg, tcfg = jcfg.with_(q_lora_rank=0), tcfg.with_(q_lora_rank=0)
    return jcfg, tcfg


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module", params=[True, False], ids=["q_lora", "wq"])
def layer(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = jmla.init_mla(jax.random.PRNGKey(3), jcfg)
    tp = _torch(jp)
    gen = torch.Generator().manual_seed(0)
    assert set(mla.init_mla(gen, tcfg)) == set(tp)   # the reference's leaves
    rs = np.random.RandomState(1)
    x = (0.5 * rs.randn(B, S, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mla_forward_matches_reference(layer, use_kernel):
    jcfg, tcfg, jp, tp, x = layer
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jout, (jc, jk) = jax.jit(lambda p, x: jmla.mla_forward(
        jcfg, p, x, jnp.asarray(pos), return_kv=True))(jp, jnp.asarray(x))
    out, (c_kv, k_rope) = mla.mla_forward(
        tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos.copy()),
        return_kv=True, use_kernel=use_kernel)
    assert out.shape == (B, S, tcfg.d_model)
    for got, exp in ((out, jout), (c_kv, jc), (k_rope, jk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                   atol=MLA_TOL, rtol=MLA_TOL)


@pytest.mark.parametrize("ring,cache_len", [(False, 10), (True, 4)])
def test_mla_decode_matches_reference(layer, ring, cache_len):
    """10 absorbed-form steps against the latent cache; the 4-slot ring
    wraps. The outputs at every step and the final cache agree."""
    jcfg, tcfg, jp, tp, x = layer
    jc = jmla.init_mla_cache(jcfg, B, cache_len, jnp.float32)
    tc = mla.init_mla_cache(tcfg, B, cache_len, torch.float32)
    step = jax.jit(lambda p, x, c, i: jmla.mla_decode(jcfg, p, x, c, i, ring))
    for t in range(10):
        jout, jc = step(jp, jnp.asarray(x[:, t:t + 1]), jc, jnp.int32(t))
        before = {k: v.clone() for k, v in tc.items()}
        out, new = mla.mla_decode(tcfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                  tc, t, ring)
        for k in tc:                       # functional, as the reference
            assert torch.equal(tc[k], before[k])
        tc = new
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=MLA_TOL, rtol=MLA_TOL,
                                   err_msg=f"step {t}")
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=MLA_TOL, rtol=MLA_TOL)


def _attn_inputs(B, S, H, KH, D, Dv, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, S, H, D).astype(np.float32),
            rs.randn(B, S, KH, D).astype(np.float32),
            rs.randn(B, S, KH, Dv).astype(np.float32),
            rs.randn(B, S, H, Dv).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_at_two_widths_matches_reference(case, causal):
    """Forward and backward where q.k and v differ in width: the scale is
    the q.k width's, dq and dk come at it and dv at v's."""
    q, k, v, do = _attn_inputs(*case, seed=sum(case))
    Bq, Sq, H, _, D, Dv = case
    jfn = lambda q, k, v: jattn.multihead_attention(   # noqa: E731
        q, k, v, causal=causal, q_chunk=max(Sq, 1))
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jgrads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))

    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert out.shape == (Bq, Sq, H, Dv)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)
    plain = multihead_attention(tq, tk, tv, causal=causal, use_kernel=False)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)

    o, lse = ref.flash_attention_fwd_lse(tq, tk, tv, causal=causal)
    grads = ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    auto = torch.autograd.grad(ops.flash_attention(*leaves, causal=causal),
                               leaves, tdo)
    for name, g, a, e in zip(("dq", "dk", "dv"), grads, auto, jgrads):
        assert g.shape == e.shape and a.shape == e.shape, name
        np.testing.assert_allclose(g.numpy(), e, atol=TOL, rtol=TOL,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), e, atol=TOL, rtol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("widths", fa.HEAD_DIMS)
def test_wrapper_takes_the_built_pairs(widths):
    """The forward's check and the backward's take every pair of
    ``HEAD_DIMS`` (the backward's output shape still checked)."""
    D, Dv = widths
    for dtype in fa.DTYPES:
        q = torch.zeros(1, 8, 4, D, dtype=dtype)
        k = torch.zeros(1, 8, 2, D, dtype=dtype)
        v = torch.zeros(1, 8, 2, Dv, dtype=dtype)
        fa.check_inputs(q, k, v)
        o = torch.zeros(1, 8, 4, Dv, dtype=dtype)
        lse = torch.zeros(1, 4, 8)
        fa.check_bwd_inputs(q, k, v, o, lse, o)
        with pytest.raises(ValueError, match="output's shape"):
            fa.check_bwd_inputs(q, k, v, q if D != Dv else o[..., :8], lse,
                                o)


def test_backward_pairs_are_the_forwards_but_192_128():
    """The backward library is built for the forward's pairs, (192, 128)
    included: no pair is forward-only."""
    assert fa.BWD_HEAD_DIMS == fa.HEAD_DIMS
    assert (192, 128) in fa.BWD_HEAD_DIMS


@pytest.mark.parametrize("D,Dv", [(96, 48), (80, 80), (64, 32), (32, 32)])
def test_wrapper_rejects_unbuilt_pairs(D, Dv):
    q = torch.zeros(1, 8, 4, D)
    with pytest.raises(ValueError, match="not built"):
        fa.check_inputs(q, torch.zeros(1, 8, 4, D), torch.zeros(1, 8, 4, Dv))
    with pytest.raises(ValueError, match="must have shape"):
        fa.check_inputs(q, torch.zeros(1, 8, 4, D + 16),
                        torch.zeros(1, 8, 4, Dv))
