"""The port's mixture-of-experts archs against the reference's, on the CPU.

Each at its reduced config, the reference's ``init_params`` carried across
with ``convert.lm_params``, tokens from numpy with a seed:

- llama4-scout-17b-a16e: 2 MoE layers (4 experts, top 1, a shared
  expert), GQA with 4 query heads over 2 KV heads of 64;
- deepseek-v2-236b: 1 dense layer, then 1 MoE layer (4 experts, top 2, a
  shared expert), MLA with q.k width 32 + 16 and v width 32 (the kernel
  pair (48, 32); (192, 128) at full width). The loss and gradients also
  at the full config's MLA widths, q.k 128 + 64 and v 128 (the pair
  (192, 128), whose backward kernel trains deepseek on the card).

Before any logits are compared, the test asserts that both packages
routed every token of every MoE layer to the same experts and slots (the
port's ``moe.route`` recorded, the reference's dispatch read back by a
``jax.debug.callback``); a flip fails with the smallest top-k margin of
the layer, and is never reseeded away.

Checked, f32: the configs and ``param_count`` equal the reference's;
``forward_logits`` on both routes (the plain attention, and the kernel
route: on the CPU the kernel's plain version) within 2e-4; ``loss_fn``'s
``ce``, ``aux`` (the routers' loss, not zero) and loss within 1e-4
relative and every gradient leaf within 1e-4 relative L2 against
``jax.value_and_grad`` of the reference's, on both routes; ``remat``
against no remat (the recompute routes the tokens as the forward did);
16 decode steps replaying the forward at capacity factor 16 (no drops in
the forward) within the reference's 2e-2, and the reference's decode
logits within 2e-4; ``convert.lm_params`` gives the tree the port's
``init_params`` makes, leaf for leaf the reference's."""
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
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import (decode_step, forward_logits,  # noqa: E402
                                init_cache, init_params, loss_fn, moe)
from repro_torch.models.transformer import build_stages  # noqa: E402

ARCHS = ("llama4-scout-17b-a16e", "deepseek-v2-236b")
# the full configs' attention widths (q.k, v): the kernel pairs they need
WIDTHS = {"llama4-scout-17b-a16e": (128, 128),
          "deepseek-v2-236b": (192, 128)}
B, S = 2, 64
LOGIT_TOL = 2e-4
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 1e-4
REPLAY_ATOL = 2e-2        # tests/test_decode_consistency.py
DECODE_STEPS = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


def _cfgs(arch, **kw):
    return (jget_reduced(arch).with_(compute_dtype=jnp.float32, **kw),
            get_reduced(arch).with_(compute_dtype=torch.float32, **kw))


def _tensors(tree):
    return [t for t in tree_leaves(tree) if t is not None]


def _n_moe(cfg):
    return sum(n for kind, n in build_stages(cfg) if kind == "moe")


@pytest.fixture(scope="module")
def weights(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def tokens(arch):
    rs = np.random.RandomState(0)
    return rs.randint(0, get_reduced(arch).vocab_size, (B, S)).astype(np.int32)


class PortRoutes:
    """Records each ``moe.route`` call of the port: its (B, S, E, C)
    dispatch and its tokens' smallest top-k margin (the k-th probability
    less the next)."""

    def __init__(self, monkeypatch):
        self.dispatch, self.margin = [], []
        inner = moe.route

        def route(cfg, router_w, x):
            r = inner(cfg, router_w, x)
            E, K = cfg.n_experts, cfg.experts_per_token
            C = moe.expert_capacity(cfg, x.shape[1])
            d = np.zeros(tuple(x.shape[:2]) + (E, C), np.float32)
            e, c, keep = (t.numpy() for t in (r.experts, r.slots, r.keep))
            for b, s, k in zip(*np.nonzero(keep)):
                d[b, s, e[b, s, k], c[b, s, k]] = 1.0
            logits = x.detach().float() @ router_w.detach()
            p = torch.sort(torch.softmax(logits, -1), -1,
                           descending=True).values
            self.dispatch.append(d)
            self.margin.append(float((p[..., K - 1] - p[..., K]).min())
                               if K < E else float("inf"))
            return r

        monkeypatch.setattr(moe, "route", route)


def reference_routes(monkeypatch):
    """The reference's dispatch of each MoE layer, read back by a
    ``jax.debug.callback`` from inside its jitted layer scan (a function
    traced after this call)."""
    seen = []
    inner = jmoe.route

    def route(cfg, router_w, x):
        out = inner(cfg, router_w, x)
        jax.debug.callback(lambda d: seen.append(np.asarray(d)), out[0],
                           ordered=True)
        return out

    monkeypatch.setattr(jmoe, "route", route)
    return seen


def assert_same_routes(port, theirs, n_layers):
    assert len(theirs) == n_layers and len(port.dispatch) >= n_layers
    for layer, (mine, exp) in enumerate(zip(port.dispatch, theirs)):
        flips = int((mine != exp).any(axis=(2, 3)).sum())
        assert flips == 0, (
            f"MoE layer {layer}: {flips} tokens routed apart from the "
            f"reference (smallest top-k margin {port.margin[layer]:.3e})")


def test_config_matches_reference(arch):
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    for mine, ref in ((get_config(arch), jget_config(arch)),
                      (get_reduced(arch), jget_reduced(arch))):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(ref)
        for k in ("param_dtype", "compute_dtype"):   # torch vs jnp dtypes
            assert str(a.pop(k)) == f"torch.{np.dtype(b.pop(k)).name}"
        assert a == b
        for active in (False, True):
            assert mine.param_count(active) == ref.param_count(active)
    cfg = get_config(arch)
    assert cfg.tie_embeddings and cfg.rope_theta == 10_000.0
    qk = (cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.attn_kind == "mla"
          else cfg.resolved_head_dim)
    vd = cfg.v_head_dim if cfg.attn_kind == "mla" else qk
    assert (qk, vd) == WIDTHS[arch] and WIDTHS[arch] in HEAD_DIMS


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_matches_reference(arch, weights, tokens, use_kernel,
                                          monkeypatch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = weights
    theirs = reference_routes(monkeypatch)
    exp = np.asarray(jax.jit(lambda p, t: jforward(jcfg, p, {"tokens": t}))(
        jp, jnp.asarray(tokens)))
    jax.effects_barrier()
    port = PortRoutes(monkeypatch)
    got = forward_logits(tcfg, tp, {"tokens": torch.from_numpy(tokens)},
                         device="cpu", use_kernel=use_kernel)
    assert_same_routes(port, theirs, _n_moe(tcfg))
    assert got.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), exp, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


# the loss-and-gradient cases: each arch's reduced config, and reduced
# deepseek-v2-236b at the full config's MLA widths
FULL_MLA = {"qk_nope_dim": 128, "qk_rope_dim": 64, "v_head_dim": 128}
GRAD_CASES = {**{a: (a, {}) for a in ARCHS},
              "deepseek-v2-236b-full-mla": ("deepseek-v2-236b", FULL_MLA)}


@pytest.fixture(scope="module", params=list(GRAD_CASES))
def reference(request):
    """The reference's weights, one batch, its loss, ce, aux and
    gradients, and its routing of the batch's tokens, for a case of
    ``GRAD_CASES``."""
    arch, widths = GRAD_CASES[request.param]
    jcfg, tcfg = _cfgs(arch, **widths)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    batch = jlm_batch(jax.random.PRNGKey(2), jcfg, B, S)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, batch), has_aux=True))(jp)
    with pytest.MonkeyPatch.context() as mp:
        routes = reference_routes(mp)
        jax.jit(lambda p, t: jforward(jcfg, p, {"tokens": t}))(
            jp, batch["tokens"])
        jax.effects_barrier()
    return {"cfg": tcfg, "tree": jax.tree.map(np.asarray, jp),
            "batch": {k: torch.from_numpy(np.array(v))
                      for k, v in batch.items()},
            "loss": float(loss), "ce": float(metrics["ce"]),
            "aux": float(metrics["aux"]), "routes": routes,
            "grads": _tensors(convert.lm_params(
                jax.tree.map(np.asarray, grads), tcfg, "cpu"))}


def _loss_and_grads(ref, use_kernel=None, remat=True):
    params = convert.lm_params(ref["tree"], ref["cfg"], "cpu")
    leaves = _tensors(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = loss_fn(ref["cfg"], params, ref["batch"], remat=remat,
                            device="cpu", use_kernel=use_kernel)
    return loss, metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_loss_and_grads_match_reference(reference, use_kernel, monkeypatch):
    port = PortRoutes(monkeypatch)
    loss, metrics, grads = _loss_and_grads(reference, use_kernel)
    # the forward's routing first (the remat recompute records after it)
    assert_same_routes(port, reference["routes"], _n_moe(reference["cfg"]))
    assert float(metrics["aux"].detach()) > 0
    for name, got in (("loss", loss), ("ce", metrics["ce"]),
                      ("aux", metrics["aux"])):
        np.testing.assert_allclose(float(got.detach()), reference[name],
                                   rtol=LOSS_RTOL, err_msg=name)
    assert len(grads) == len(reference["grads"])
    for i, (g, e) in enumerate(zip(grads, reference["grads"])):
        assert g.shape == e.shape, i
        rel = float((g - e).norm() / e.norm())
        assert rel <= GRAD_REL_L2, (i, rel)


def test_remat_routes_as_the_forward(reference, monkeypatch):
    """Each layer's recompute in the backward routes its saved input as
    the forward did, and the gradients are those without remat."""
    n = _n_moe(reference["cfg"])
    port = PortRoutes(monkeypatch)
    loss, _, grads = _loss_and_grads(reference, remat=True)
    assert len(port.dispatch) == 2 * n      # the forward, then the recompute
    for fwd, again in zip(port.dispatch[:n], port.dispatch[n:][::-1]):
        np.testing.assert_array_equal(fwd, again)
    plain_loss, _, plain_grads = _loss_and_grads(reference, remat=False)
    assert float(loss.detach()) == float(plain_loss.detach())
    for g, e in zip(grads, plain_grads):
        torch.testing.assert_close(g, e, atol=1e-6, rtol=1e-6)


def test_decode_replays_prefill(arch, tokens):
    """At capacity factor 16 the forward drops no token (as
    tests/test_decode_consistency.py sets it); a decode token a row never
    fills its C = 4 slots."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=16.0)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tok = torch.from_numpy(tokens[:, :DECODE_STEPS])
    full = forward_logits(tcfg, tp, {"tokens": tok}, device="cpu")
    jc = jinit_cache(jcfg, B, cache_len=DECODE_STEPS, dtype=jnp.float32)
    tc = init_cache(tcfg, B, DECODE_STEPS, torch.float32, device="cpu")
    step = jax.jit(lambda p, b, c, i: jdecode(jcfg, p, b, c, i))
    steps = []
    for t in range(DECODE_STEPS):
        jl, jc = step(jp, {"tokens": jnp.asarray(tokens[:, t:t + 1])}, jc,
                      jnp.int32(t))
        tl, tc = decode_step(tcfg, tp, {"tokens": tok[:, t:t + 1]}, tc, t,
                             device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"step {t}")
        steps.append(tl)
    err = float((torch.cat(steps, dim=1) - full).abs().max())
    assert err < REPLAY_ATOL, err


def test_lm_params_round_trip(arch, weights):
    """The converted reference tree has the stages, keys and shapes of the
    port's own ``init_params`` (the expert stacks unstacked over the
    layers only; deepseek's dense layer a stage of its own), and each
    leaf is the reference's."""
    jp, tp = weights
    _, tcfg = _cfgs(arch)
    own = init_params(0, tcfg, device="cpu")
    shapes = lambda tree: torch.utils._pytree.tree_map(  # noqa: E731
        lambda t: tuple(t.shape), tree)
    assert shapes(own) == shapes(tp)
    stages = build_stages(tcfg)
    assert [kind for kind, _ in stages] == (
        ["dense", "moe"] if tcfg.first_k_dense else ["moe"])
    for (kind, n), st, jst in zip(stages, tp["stages"], jp["stages"]):
        assert len(st) == n
        for i, layer in enumerate(st):
            if kind == "moe":
                assert set(layer["ffn"]) == {"router", "w_gate", "w_up",
                                             "w_down", "shared"}
                E, D, Fd = tcfg.n_experts, tcfg.d_model, tcfg.moe_d_ff
                assert layer["ffn"]["w_down"].shape == (E, Fd, D)
            flat = jax.tree_util.tree_leaves_with_path(jst)
            for path, leaf in flat:
                mine = layer
                for p in path:
                    mine = mine[p.key]
                np.testing.assert_array_equal(mine.numpy(),
                                              np.asarray(leaf)[i])
