"""The port's LM serving paths against the reference's, on the CPU.

Each ported architecture at its reduced config, the reference's
``init_params`` carried across with ``convert.lm_params``, tokens from
numpy with a seed:

- zamba2-1.2b: 2 Mamba2 layers + the shared attention block, d_model 256;
  at (2, 256) the forward runs 2 SSD chunks of 128 and one
  ``shared_attn`` call.
- falcon-mamba-7b: 2 Mamba1 layers, d_model 256, ds 8; at (2, 256) the
  forward runs the selective scan over 256 steps in each layer.
- olmo-1b: 2 dense layers (GQA with 4 heads of 64, SwiGLU), d_model 256,
  the non-parametric LayerNorm, tied embeddings.

Tolerances: f32 logits within 2e-4 (abs and rel; sums run in another order,
measured max 7e-5 on logits of magnitude ~5); f32 decode steps and caches
within 1e-4. In bf16 the two frameworks round at other places (XLA's CPU
compiler fuses elementwise chains in f32), so the bf16 forward is held to
a max abs error of 0.3 and a mean of 0.03 on logits of magnitude ~5: about
ten bf16 ulps at most and two on average."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward_logits as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import (decode_step, forward_logits,  # noqa: E402
                                init_cache, init_params)

ARCHS = ("zamba2-1.2b", "falcon-mamba-7b", "olmo-1b")
PARAM_COUNTS = {"zamba2-1.2b": 1_104_535_296,
                "falcon-mamba-7b": 7_005_536_256,
                "olmo-1b": 1_176_764_416}
# cache leaves of the reduced configs: 2 per ssm layer, 2 per attention call
CACHE_LEAVES = {"zamba2-1.2b": 2 * 2 + 2, "falcon-mamba-7b": 2 * 2,
                "olmo-1b": 2 * 2}
B, S = 2, 256


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


def _cfgs(arch, compute):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    return (jget_reduced(arch).with_(compute_dtype=jd),
            get_reduced(arch).with_(compute_dtype=td))


@pytest.fixture(scope="module")
def weights(arch):
    """The reference's parameters (f32 in either compute dtype) and the
    port's copy of them."""
    jcfg, tcfg = _cfgs(arch, "f32")
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def tokens(arch):
    rs = np.random.RandomState(0)
    return rs.randint(0, get_reduced(arch).vocab_size, (B, S)).astype(np.int32)


def test_config_matches_reference(arch):
    for mine, ref in ((get_config(arch), jget_config(arch)),
                      (get_reduced(arch), jget_reduced(arch))):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(ref)
        for k in ("param_dtype", "compute_dtype"):   # torch vs jnp dtypes
            assert str(a.pop(k)) == f"torch.{np.dtype(b.pop(k)).name}"
        assert a == b
        assert mine.param_count() == ref.param_count()
        assert (mine.d_inner, mine.ssm_n_heads, mine.resolved_head_dim,
                mine.resolved_dt_rank) == (ref.d_inner, ref.ssm_n_heads,
                                           ref.resolved_head_dim,
                                           ref.resolved_dt_rank)
    assert get_config(arch).param_count() == PARAM_COUNTS[arch]
    assert get_config(arch).compute_dtype == torch.bfloat16
    assert len(ARCH_IDS) == 10
    assert [get_config(a).name for a in ARCH_IDS] == list(ARCH_IDS)
    assert [get_reduced(a).name for a in ARCH_IDS] == list(ARCH_IDS)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_matches_reference(arch, weights, tokens, use_kernel):
    """Both routes: the plain one (chunked SSD, or the Mamba1 loop over
    time), and the kernel route (on the CPU the kernels' plain versions)."""
    jcfg, tcfg = _cfgs(arch, "f32")
    jp, tp = weights
    exp = np.asarray(jax.jit(lambda p, t: jforward(jcfg, p, {"tokens": t}))(
        jp, jnp.asarray(tokens)))
    got = forward_logits(tcfg, tp, {"tokens": torch.from_numpy(tokens)},
                         device="cpu", use_kernel=use_kernel)
    assert got.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), exp, atol=2e-4, rtol=2e-4)
    prefill = make_prefill_step(tcfg, device="cpu")
    if not use_kernel:
        np.testing.assert_array_equal(
            prefill(tp, {"tokens": torch.from_numpy(tokens)}).numpy(),
            got.numpy())


def test_forward_logits_bf16_matches_reference(arch, weights, tokens):
    jcfg, tcfg = _cfgs(arch, "bf16")
    jp, tp = weights
    exp = np.asarray(jax.jit(lambda p, t: jforward(jcfg, p, {"tokens": t}))(
        jp, jnp.asarray(tokens)), np.float32)
    got = forward_logits(tcfg, tp, {"tokens": torch.from_numpy(tokens)},
                         device="cpu")
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - exp)
    assert err.max() <= 0.3 and err.mean() <= 0.03, (err.max(), err.mean())


@pytest.mark.parametrize("ring,cache_len", [(False, 16), (True, 8)])
def test_decode_sequence_matches_reference(arch, weights, tokens, ring,
                                          cache_len):
    """16 one-token steps; with ``ring=True`` an 8-slot sliding-window
    cache wraps twice (zamba2's attention; falcon's cache has no slots).
    Logits at every step and the final caches agree."""
    jcfg, tcfg = _cfgs(arch, "f32")
    jp, tp = weights
    jc = jinit_cache(jcfg, B, cache_len=cache_len, dtype=jnp.float32)
    tc = init_cache(tcfg, B, cache_len, torch.float32, device="cpu")
    step = jax.jit(lambda p, b, c, i: jdecode(jcfg, p, b, c, i, ring=ring))
    for t in range(16):
        tok = tokens[:, t:t + 1]
        jl, jc = step(jp, {"tokens": jnp.asarray(tok)}, jc, jnp.int32(t))
        tl, tc = decode_step(tcfg, tp, {"tokens": torch.from_numpy(tok)}, tc,
                             t, ring=ring, device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")
    mine = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tc))
    theirs = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), convert.lm_cache(jax.tree.map(np.asarray, jc),
                                              tcfg, "cpu")))
    assert len(mine) == len(theirs) == CACHE_LEAVES[arch]
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def test_generate_replay_matches_forward(arch):
    """The serve loop's prompt replay ends on the same logits as one
    forward over the prompt (the CPU twin of the card's check, in bf16 with
    the serve loop's bf16 cache, so at the bf16 tolerance), and greedy
    decoding yields in-range tokens."""
    _, tcfg = _cfgs(arch, "bf16")
    params = init_params(3, tcfg, device="cpu")
    prompt = torch.randint(0, tcfg.vocab_size, (3, 20),
                           generator=torch.Generator().manual_seed(4))
    out = generate(tcfg, params, prompt, gen=5, device="cpu")
    full = forward_logits(tcfg, params, {"tokens": prompt}, device="cpu")
    err = (out.prompt_logits.float() - full[:, -1:].float()).abs()
    assert err.max() <= 0.3 and err.mean() <= 0.03, (err.max(), err.mean())
    assert out.tokens.shape == (3, 5)
    assert bool(((out.tokens >= 0) & (out.tokens < tcfg.vocab_size)).all())


@pytest.mark.parametrize("ring,cache_len", [(False, 8), (True, 4)])
def test_decode_leaves_the_given_cache_unchanged(arch, weights, tokens, ring,
                                                 cache_len):
    """decode_step is functional, as the reference's: a caller that keeps
    an earlier cache (a snapshot to roll back to) can step from it again
    and gets the same logits and the same new cache."""
    _, tcfg = _cfgs(arch, "f32")
    _, tp = weights
    cache = init_cache(tcfg, B, cache_len, torch.float32, device="cpu")
    for t in range(5):
        _, cache = decode_step(tcfg, tp, {"tokens": torch.from_numpy(
            tokens[:, t:t + 1])}, cache, t, ring=ring, device="cpu")
    snapshot = [t.clone() for t in jax.tree.leaves(cache)]
    tok = {"tokens": torch.from_numpy(tokens[:, 5:6])}
    first, after = decode_step(tcfg, tp, tok, cache, 5, ring=ring,
                               device="cpu")
    for a, b in zip(jax.tree.leaves(cache), snapshot):
        assert torch.equal(a, b)
    again, after2 = decode_step(tcfg, tp, tok, cache, 5, ring=ring,
                                device="cpu")
    assert torch.equal(first, again)
    for a, b in zip(jax.tree.leaves(after), jax.tree.leaves(after2)):
        assert torch.equal(a, b)
