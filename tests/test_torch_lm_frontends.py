"""The port's vision frontend and multi-codebook heads against the
reference's, on the CPU.

Each arch at its reduced config, the reference's ``init_params`` carried
across with ``convert.lm_params``, tokens from numpy with a seed:

- internvl2-2b: 2 dense layers (GQA, 4 query heads over 2 KV heads of
  64, SwiGLU), tied embeddings; a batch's 16 precomputed patch embeddings
  ``vision_embeds`` (the reference's own draw, injected) go before the
  text, positions run over the patches and the text, and the loss ignores
  the patch positions;
- musicgen-large: 2 dense layers (4 heads of 64, tanh-GELU FFN), 2
  codebook streams of 128 tokens: their ``(2, 128, 256)`` embeddings
  summed on the way in, the untied ``(2, 256, 128)`` heads on the way out.

Checked: the configs and ``param_count`` equal the reference's;
``forward_logits`` on both routes (the plain query-chunked attention, and
the kernel route: on the CPU the kernel's plain version) within 2e-4 of
the reference's (abs and rel, f32); 12 ``decode_step``s with a full and an
8-slot ring cache within 2e-4, and the final caches (text tokens for
internvl2-2b, whose serving replays no patch block, as the reference's;
codebook tokens for musicgen-large); ``loss_fn``'s loss and every gradient
leaf of one f32 step (``jax.value_and_grad`` of the reference's) within
1e-4 (loss relative, each leaf relative L2), on both routes; ``lm_batch``'s
tokens and labels bitwise the reference's, its ``vision_embeds`` within
1e-6 relative L2 (``prng.normal``'s erfinv differs in the last bits);
``convert.lm_optimizer_state`` carries the codebook embedding's and heads'
AdamW moments across; ``make_prefill_step`` and ``make_train_step`` pass
the patch embeddings through; the serving step's f32 prompt replay equals
a forward over the same tokens, and ``generate`` decodes; ``train
cohort`` of each arch on the CPU, its loss falling."""
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
from repro.launch.steps import default_optimizer as jdefault_opt  # noqa: E402
from repro.launch.steps import make_train_step as jmake_step  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward_logits as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from test_torch_lm_dense import one_thread  # noqa: E402,F401
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.steps import (default_optimizer,  # noqa: E402
                                      make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import (decode_step, forward_logits,  # noqa: E402
                                init_cache, loss_fn)

ARCHS = ("internvl2-2b", "musicgen-large")
PARAM_COUNTS = {"internvl2-2b": 1_699_497_984,
                "musicgen-large": 2_449_473_536}
# the full configs' attention (heads, KV heads, head width): both widths
# are built in both attention kernels
ATTENTION = {"internvl2-2b": (16, 8, 128), "musicgen-large": (32, 32, 64)}
B, S = 2, 64
LOGIT_TOL = 2e-4
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 1e-4
VISION_REL_L2 = 1e-6


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


def _cfgs(arch):
    return (jget_reduced(arch).with_(compute_dtype=jnp.float32),
            get_reduced(arch).with_(compute_dtype=torch.float32))


def _tensors(tree):
    return [t for t in tree_leaves(tree) if t is not None]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def weights(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def batch(arch):
    """Numpy tokens (B, S) or (B, S, ncb) from a seed; for the vision
    frontend also the reference's ``vision_embeds`` draw (B, P, D)."""
    cfg = get_reduced(arch)
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    rs = np.random.RandomState(0)
    out = {"tokens": rs.randint(0, cfg.vocab_size,
                                (B, S) + books).astype(np.int32)}
    if cfg.frontend == "vision":
        out["vision_embeds"] = np.asarray(jlm_batch(
            jax.random.PRNGKey(3), jget_reduced(arch), B,
            S + cfg.n_patches)["vision_embeds"])
    return out


def test_config_matches_reference(arch):
    from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS, HEAD_DIMS
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
    hd = cfg.resolved_head_dim
    assert (cfg.n_heads, cfg.n_kv_heads, hd) == ATTENTION[arch]
    assert (hd, hd) in HEAD_DIMS and (hd, hd) in BWD_HEAD_DIMS


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_matches_reference(arch, weights, batch, use_kernel):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = weights
    exp = np.asarray(jax.jit(lambda p, b: jforward(jcfg, p, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = forward_logits(tcfg, tp, _torch_batch(batch), device="cpu",
                         use_kernel=use_kernel)
    books = (tcfg.n_codebooks,) if tcfg.n_codebooks > 1 else ()
    assert got.shape == (B, S + tcfg.n_patches) + books + (tcfg.vocab_size,)
    np.testing.assert_allclose(got.numpy(), exp, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("ring,cache_len", [(False, 12), (True, 8)])
def test_decode_sequence_matches_reference(arch, weights, batch, ring,
                                          cache_len):
    """12 one-token steps (a token a codebook for musicgen-large); the
    8-slot ring wraps."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = weights
    tokens = batch["tokens"]
    jc = jinit_cache(jcfg, B, cache_len=cache_len, dtype=jnp.float32)
    tc = init_cache(tcfg, B, cache_len, torch.float32, device="cpu")
    step = jax.jit(lambda p, b, c, i: jdecode(jcfg, p, b, c, i, ring=ring))
    for t in range(12):
        tok = tokens[:, t:t + 1]
        jl, jc = step(jp, {"tokens": jnp.asarray(tok)}, jc, jnp.int32(t))
        tl, tc = decode_step(tcfg, tp, {"tokens": torch.from_numpy(tok)}, tc,
                             t, ring=ring, device="cpu")
        assert tl.shape == jl.shape
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
    """The reference's weights, one ``lm_batch`` (its vision embeddings
    injected into the port's), its loss and gradients."""
    jcfg, tcfg = _cfgs(arch)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    batch = jlm_batch(jax.random.PRNGKey(2), jcfg, B, S)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, batch), has_aux=True))(jp)
    return {"cfg": tcfg, "tree": jax.tree.map(np.asarray, jp),
            "batch": _torch_batch(batch), "loss": float(loss),
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


def test_lm_batch_matches_reference(arch):
    """Tokens and labels bitwise; the vision embeddings within
    ``VISION_REL_L2``."""
    cfg = get_reduced(arch)
    for i in range(2):
        exp = jlm_batch(jax.random.fold_in(jax.random.PRNGKey(4), i),
                        jget_reduced(arch), 3, 40)
        got = lm_batch(prng.fold_in(prng.PRNGKey(4, "cpu"), i), cfg, 3, 40)
        assert set(got) == set(exp)
        text = 40 - cfg.n_patches
        books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        for name in ("tokens", "labels"):
            assert got[name].shape == (3, text) + books
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(exp[name]))
        if cfg.frontend == "vision":
            ve = got["vision_embeds"]
            assert ve.shape == (3, cfg.n_patches, cfg.d_model)
            assert ve.dtype == torch.float32
            assert _rel_l2(ve.numpy(), exp["vision_embeds"]) <= VISION_REL_L2


def test_optimizer_state_carries_the_codebook_leaves(arch):
    """One reference AdamW step, then its moments through
    ``convert.lm_optimizer_state``: every leaf (the embedding, of shape
    ``(ncb, V, D)`` for musicgen-large, and its untied ``(ncb, D, V)``
    heads among them) keeps its shape and values."""
    jcfg, tcfg = _cfgs(arch)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    opt = jdefault_opt()
    batch = jlm_batch(jax.random.PRNGKey(2), jcfg, B, 16 + jcfg.n_patches)
    jp, state, _, _ = jax.jit(jmake_step(jcfg, opt))(jp, opt.init(jp), batch)
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    ts = convert.lm_optimizer_state(jax.tree.map(np.asarray, state), tcfg,
                                    "cpu")
    books = (tcfg.n_codebooks,) if tcfg.n_codebooks > 1 else ()
    assert tp["embed"].shape == books + (tcfg.vocab_size, tcfg.d_model)
    if not tcfg.tie_embeddings:
        assert tp["lm_head"].shape == books + (tcfg.d_model, tcfg.vocab_size)
    assert int(ts["t"]) == 1
    for name in ("m", "v"):
        assert ts[name].keys() == tp.keys()
        for k in ("embed", "lm_head"):
            if k in tp:
                assert ts[name][k].shape == tp[k].shape
                np.testing.assert_array_equal(
                    ts[name][k].numpy(), np.asarray(state[name][k]))
        assert ([t.shape for t in _tensors(ts[name])]
                == [t.shape for t in _tensors(tp)])


def test_steps_pass_the_frontends_through(arch, weights, batch):
    """``make_prefill_step`` returns ``forward_logits`` of the whole batch
    (the patch embeddings too); ``make_train_step``'s loss is
    ``loss_fn``'s on the same ``lm_batch`` and its step moves every
    parameter leaf the loss reads."""
    _, tcfg = _cfgs(arch)
    _, tp = weights
    tb = _torch_batch(batch)
    np.testing.assert_array_equal(
        make_prefill_step(tcfg, device="cpu")(tp, tb).numpy(),
        forward_logits(tcfg, tp, tb, device="cpu").numpy())
    lb = lm_batch(prng.PRNGKey(5, "cpu"), tcfg, B, S)
    opt = default_optimizer()
    new, state, loss, metrics = make_train_step(tcfg, opt, device="cpu")(
        tp, opt.init(tp), lb)
    exp, _ = loss_fn(tcfg, tp, lb, device="cpu")
    assert float(loss) == float(exp) and float(metrics["ce"]) == float(exp)
    assert int(state["t"]) == 1
    assert all(not torch.equal(a, b)
               for a, b in zip(_tensors(new), _tensors(tp)))


def test_generate_replays_the_forward(arch, weights, batch):
    """The serving path: ``make_serve_step`` replaying 8 prompt tokens into
    an f32 cache gives, at every position, a forward's logits over the
    same tokens (for internvl2-2b with an empty patch block: serving
    carries text tokens only); ``generate`` (its bf16 cache, 4 tokens)
    returns (B, gen) or (B, gen, ncb) tokens in range, the first the
    argmax of its last prompt logits."""
    _, tcfg = _cfgs(arch)
    _, tp = weights
    prompt = torch.from_numpy(batch["tokens"][:, :8]).long()
    fb = {"tokens": prompt}
    if tcfg.frontend == "vision":
        fb["vision_embeds"] = torch.zeros((B, 0, tcfg.d_model))
    full = forward_logits(tcfg, tp, fb, device="cpu")
    cache = init_cache(tcfg, B, 8, torch.float32, device="cpu")
    step = make_serve_step(tcfg, ring=False, device="cpu")
    for t in range(8):
        logits, cache = step(tp, {"tokens": prompt[:, t:t + 1]}, cache, t)
        np.testing.assert_allclose(logits.numpy(), full[:, t:t + 1].numpy(),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"position {t}")
    out = generate(tcfg, tp, prompt, 4, device="cpu")
    books = (tcfg.n_codebooks,) if tcfg.n_codebooks > 1 else ()
    assert out.tokens.shape == (B, 4) + books
    assert out.prompt_logits.shape == (B, 1) + books + (tcfg.vocab_size,)
    assert bool(((out.tokens >= 0) & (out.tokens < tcfg.vocab_size)).all())
    assert torch.equal(out.tokens[:, :1], out.prompt_logits.argmax(-1))


def test_train_cohort_cli(arch, capsys):
    """``train cohort`` at the reference's defaults (10 AdamW steps of
    4 x 64 tokens, lr 3e-3; internvl2-2b's 64 positions are its 16 patches
    and 48 text tokens); it raises unless its loss falls."""
    losses = train.main(["cohort", "--device", "cpu", "--arch", arch])
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0]
    assert f"[cohort:{arch}]" in capsys.readouterr().out
