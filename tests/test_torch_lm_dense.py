"""The port's dense archs beyond olmo-1b against the reference's, on the CPU.

Each at its reduced config, the reference's ``init_params`` carried across
with ``convert.lm_params``, tokens from numpy with a seed:

- phi4-mini-3.8b: 2 dense layers, GQA with 4 query heads over 2 KV heads
  of 64, SwiGLU, RMSNorm, tied embeddings;
- phi3-mini-3.8b: 2 dense layers, 4 heads of 64 (hd 96 at full width);
- minicpm3-4b: 2 dense layers of MLA (``models/mla.py``: q through the
  rank-96 ``wdq``/``q_norm``/``wuq``, a rank-64 latent ``c_kv``, q.k width
  32 + 16 = 48, v width 32; the kernel pair (48, 32)), the absorbed decode
  against the ``(c_kv, k_rope)`` cache.

Checked: the configs and ``param_count`` equal the reference's;
``forward_logits`` on both routes (the plain query-chunked attention, and
the kernel route: on the CPU the kernel's plain version) within 2e-4 of
the reference's (abs and rel, f32); 12 ``decode_step``s with a full and an
8-slot ring cache within 2e-4, and the final caches; ``loss_fn``'s loss
and every gradient leaf of one f32 step (``jax.value_and_grad`` of the
reference's) within 1e-4 (loss relative, each leaf relative L2), on both
routes; ``train cohort`` of each arch on the CPU, its loss falling."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.data import lm_batch as jlm_batch  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward_logits as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import (decode_step, forward_logits,  # noqa: E402
                                init_cache, loss_fn)

ARCHS = ("phi4-mini-3.8b", "phi3-mini-3.8b", "minicpm3-4b")
PARAM_COUNTS = {"phi4-mini-3.8b": 3_835_822_080,
                "phi3-mini-3.8b": 3_722_379_264,
                "minicpm3-4b": 4_073_492_480}
# the full configs' attention widths (q.k, v) and the kernel pairs they
# need (kernels/flash_attention.py::HEAD_DIMS)
WIDTHS = {"phi4-mini-3.8b": (128, 128), "phi3-mini-3.8b": (96, 96),
          "minicpm3-4b": (96, 64)}
B, S = 2, 64
LOGIT_TOL = 2e-4
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


def _cfgs(arch):
    return (jget_reduced(arch).with_(compute_dtype=jnp.float32),
            get_reduced(arch).with_(compute_dtype=torch.float32))


def _tensors(tree):
    return [t for t in tree_leaves(tree) if t is not None]


@pytest.fixture(scope="module")
def weights(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def tokens(arch):
    rs = np.random.RandomState(0)
    return rs.randint(0, get_reduced(arch).vocab_size, (B, S)).astype(np.int32)


def test_config_matches_reference(arch):
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    for mine, ref in ((get_config(arch), jget_config(arch)),
                      (get_reduced(arch), jget_reduced(arch))):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(ref)
        for k in ("param_dtype", "compute_dtype"):   # torch vs jnp dtypes
            assert str(a.pop(k)) == f"torch.{np.dtype(b.pop(k)).name}"
        assert a == b
        assert mine.param_count() == ref.param_count()
        assert mine.resolved_head_dim == ref.resolved_head_dim
    cfg = get_config(arch)
    assert cfg.param_count() == PARAM_COUNTS[arch]
    qk = (cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.attn_kind == "mla"
          else cfg.resolved_head_dim)
    vd = cfg.v_head_dim if cfg.attn_kind == "mla" else qk
    assert (qk, vd) == WIDTHS[arch] and WIDTHS[arch] in HEAD_DIMS


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_matches_reference(arch, weights, tokens, use_kernel):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = weights
    exp = np.asarray(jax.jit(lambda p, t: jforward(jcfg, p, {"tokens": t}))(
        jp, jnp.asarray(tokens)))
    got = forward_logits(tcfg, tp, {"tokens": torch.from_numpy(tokens)},
                         device="cpu", use_kernel=use_kernel)
    assert got.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), exp, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("ring,cache_len", [(False, 12), (True, 8)])
def test_decode_sequence_matches_reference(arch, weights, tokens, ring,
                                          cache_len):
    """12 one-token steps; the 8-slot ring wraps. MLA decodes in the
    absorbed form against its latent cache, as the reference's."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = weights
    jc = jinit_cache(jcfg, B, cache_len=cache_len, dtype=jnp.float32)
    tc = init_cache(tcfg, B, cache_len, torch.float32, device="cpu")
    step = jax.jit(lambda p, b, c, i: jdecode(jcfg, p, b, c, i, ring=ring))
    for t in range(12):
        tok = tokens[:, t:t + 1]
        jl, jc = step(jp, {"tokens": jnp.asarray(tok)}, jc, jnp.int32(t))
        tl, tc = decode_step(tcfg, tp, {"tokens": torch.from_numpy(tok)}, tc,
                             t, ring=ring, device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"step {t}")
    mine = _tensors(tc)
    theirs = _tensors(convert.lm_cache(jax.tree.map(np.asarray, jc), tcfg,
                                       "cpu"))
    assert len(mine) == len(theirs) == 2 * tcfg.n_layers
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


@pytest.fixture(scope="module")
def reference(arch):
    """The reference's weights, one batch, and its loss and gradients."""
    jcfg, tcfg = _cfgs(arch)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    batch = jlm_batch(jax.random.PRNGKey(2), jcfg, B, S)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, batch), has_aux=True))(jp)
    return {"cfg": tcfg, "tree": jax.tree.map(np.asarray, jp),
            "batch": {k: torch.from_numpy(np.asarray(v))
                      for k, v in batch.items()},
            "loss": float(loss),
            "grads": _tensors(convert.lm_params(
                jax.tree.map(np.asarray, grads), tcfg, "cpu"))}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_loss_and_grads_match_reference(reference, use_kernel):
    params = convert.lm_params(reference["tree"], reference["cfg"], "cpu")
    leaves = _tensors(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = loss_fn(reference["cfg"], params, reference["batch"],
                      device="cpu", use_kernel=use_kernel)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), reference["loss"],
                               rtol=LOSS_RTOL)
    assert len(grads) == len(reference["grads"])
    for i, (g, e) in enumerate(zip(grads, reference["grads"])):
        assert g.shape == e.shape, i
        rel = float((g - e).norm() / e.norm())
        assert rel <= GRAD_REL_L2, (i, rel)


def test_train_cohort_cli(arch, capsys):
    """``train cohort`` at the reference's defaults (10 AdamW steps of
    4 x 64 tokens, lr 3e-3); it raises unless its loss falls."""
    losses = train.main(["cohort", "--device", "cpu", "--arch", arch])
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0]
    assert f"[cohort:{arch}]" in capsys.readouterr().out
