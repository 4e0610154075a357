"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against
the reference's ``repro.models.moe``, on the CPU.

At reduced llama4-scout-17b-a16e (4 experts, top 1, a shared expert) and
reduced deepseek-v2-236b (4 experts, top 2, a shared expert), f32:

- ``expert_capacity`` equals the reference's over a range of S, capacity
  factors and the full configs;
- the routing equals the reference's integer for integer: the expert ids
  (``lax.top_k`` of the softmax, ties lowest index first), every filled
  slot of the reference's (B, S, E, C) dispatch and every drop, on random
  inputs, on router logits full of ties (rows of x = 0, whose probs are
  uniform, and one-hot rows of x that read integer-valued logits from
  the router), and on a sequence whose top choice overflows C; the
  combine weights and the aux loss within 1e-6;
- ``moe_apply``'s output and aux loss within 1e-5 relative L2, and the
  gradients of both (every parameter leaf and x) against ``jax.vjp``
  within 1e-4 relative L2 a leaf; the router's gradient is not zero."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ("llama4-scout-17b-a16e", "deepseek-v2-236b")
B, S = 2, 64
APPLY_REL_L2 = 1e-5
GRAD_REL_L2 = 1e-4
ROUTE_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (jget_reduced(arch).with_(compute_dtype=jnp.float32, **kw),
            get_reduced(arch).with_(compute_dtype=torch.float32, **kw))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _rel(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float(np.linalg.norm(got - exp) / np.linalg.norm(exp))


def one_hots(routing, E, C, gates=False):
    """The reference's (B, S, E, C) dispatch (1 at each kept choice's
    expert and slot) or, with ``gates``, combine (the choice's gate there)
    of a port routing."""
    Bn, Sn, K = routing.experts.shape
    out = np.zeros((Bn, Sn, E, C), np.float32)
    e, c, keep, g = (t.detach().numpy() for t in (
        routing.experts, routing.slots, routing.keep, routing.gates))
    for b, s, r in zip(*np.nonzero(keep)):
        out[b, s, e[b, s, r], c[b, s, r]] = g[b, s, r] if gates else 1.0
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_matches_reference(arch):
    for cf in (1.0, 1.25, 2.0, 16.0):
        jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
        for seq in (1, 2, 3, 7, 16, 31, 64, 100, 1000, 4096):
            assert moe.expert_capacity(tcfg, seq) == \
                jmoe.expert_capacity(jcfg, seq), (cf, seq)
    full_j, full_t = jget_config(arch), get_reduced(arch).__class__(
        **{**jget_config(arch).__dict__, "param_dtype": torch.float32,
           "compute_dtype": torch.bfloat16})
    for seq in (1, 32, 1024, 4096):
        assert moe.expert_capacity(full_t, seq) == \
            jmoe.expert_capacity(full_j, seq)
    assert moe.expert_capacity(full_t, 1) == 4   # one decode token


def _route_inputs(arch, case, D, E):
    """x (B, S, D) and the router (D, E), f32, for one routing case."""
    rs = np.random.RandomState(7)
    if case == "random":
        return (rs.randn(B, S, D).astype(np.float32),
                (rs.randn(D, E) * D ** -0.5).astype(np.float32))
    if case == "ties":
        # one-hot rows of x read the router's rows as the logits exactly:
        # integers in {0, 1, 2}, so most tokens tie somewhere; a quarter
        # of the tokens are x = 0, whose probabilities are all equal
        router = rs.randint(0, 3, (D, E)).astype(np.float32)
        x = np.zeros((B, S, D), np.float32)
        rows = rs.randint(0, D, (B, S))
        for b in range(B):
            for s in range(S):
                if s % 4:
                    x[b, s, rows[b, s]] = 1.0
        return x, router
    # "overflow": every token's top choice is expert 1, then 2, then 3
    x = np.abs(rs.randn(B, S, D)).astype(np.float32) + 0.5
    router = (rs.randn(D, E) * 0.01).astype(np.float32)
    router[:, 1] += 1.0
    router[:, 2] += 0.5
    router[:, 3 % E] += 0.25
    return x, router


@pytest.mark.parametrize("case", ["random", "ties", "overflow"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch, case):
    jcfg, tcfg = _cfgs(arch)
    E, K = tcfg.n_experts, tcfg.experts_per_token
    C = moe.expert_capacity(tcfg, S)
    x, router = _route_inputs(arch, case, tcfg.d_model, E)
    jd, jc, jaux = jax.jit(lambda w, x: jmoe.route(jcfg, w, x))(
        jnp.asarray(router), jnp.asarray(x))
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, jidx = jax.lax.top_k(jprobs, K)
    r = moe.route(tcfg, torch.from_numpy(router), torch.from_numpy(x))
    np.testing.assert_array_equal(r.experts.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(one_hots(r, E, C), np.asarray(jd))
    assert r.keep.numpy().sum() == int(np.asarray(jd).sum())
    np.testing.assert_allclose(one_hots(r, E, C, gates=True), np.asarray(jc),
                               atol=ROUTE_TOL, rtol=ROUTE_TOL)
    np.testing.assert_allclose(float(r.aux), float(jaux), rtol=ROUTE_TOL)
    if case == "ties":
        zero = x.reshape(B * S, -1).any(-1).reshape(B, S) == 0
        # x = 0: uniform probabilities, the lowest ids win
        assert (r.experts.numpy()[zero] == np.arange(K)).all()
    if case == "overflow":
        assert (r.experts.numpy()[..., 0] == 1).all()
        assert (~r.keep.numpy()[..., 0]).sum() == B * (S - C)
        # rank-major: the top choices fill the first C slots in order
        np.testing.assert_array_equal(r.slots.numpy()[:, :, 0],
                                      np.tile(np.arange(S), (B, 1)))


@pytest.mark.parametrize("cotangent", ["out", "aux"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_and_grads_match_reference(arch, cotangent):
    """The output's gradient and the aux loss's apart: at top 1 (llama4)
    the renormalised gate is 1 whatever the probabilities, so the router's
    gradient through the output is zero but for rounding, which the two
    packages round differently (both read about 5e-5 against a w_gate
    gradient of order 1); that leaf is held to its size there instead.
    At capacity factor 1.0, so that some choices are dropped."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=1.0)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    tp = _torch_tree(jax.tree.map(np.asarray, jp))
    assert set(tp) == {"router", "w_gate", "w_up", "w_down", "shared"}
    rs = np.random.RandomState(5)
    x = rs.randn(B, S, tcfg.d_model).astype(np.float32)
    dout = rs.randn(B, S, tcfg.d_model).astype(np.float32)
    daux = np.float32(3.0)
    if cotangent == "aux":
        dout = np.zeros_like(dout)
    else:
        daux = np.float32(0.0)
    (jout, jaux), vjp = jax.vjp(lambda p, x: jmoe.moe_apply(jcfg, p, x),
                                jp, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(dout), jnp.asarray(daux)))

    leaves = {k: v for k, v in tp.items() if k != "shared"}
    leaves.update({f"shared.{k}": v for k, v in tp["shared"].items()})
    for t in leaves.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_apply(tcfg, tp, tx)
    assert out.shape == (B, S, tcfg.d_model) and out.dtype == torch.float32
    assert _rel(out.detach().numpy(), jout) <= APPLY_REL_L2
    np.testing.assert_allclose(float(aux.detach()), float(jaux),
                               rtol=APPLY_REL_L2)
    assert float(aux.detach()) > 0
    r = moe.route(tcfg, tp["router"].detach(), tx.detach())
    assert not r.keep.all(), "no choice dropped: the drop path is untested"
    names = list(leaves)
    grads = torch.autograd.grad(
        (out * torch.from_numpy(dout)).sum() + aux * float(daux),
        [leaves[n] for n in names] + [tx], allow_unused=True)
    exp = {k: v for k, v in jgp.items() if k != "shared"}
    exp.update({f"shared.{k}": v for k, v in jgp["shared"].items()})
    for n, g in zip(names + ["x"], grads):
        e = np.asarray(jgx if n == "x" else exp[n])
        g = np.zeros_like(e) if g is None else g.numpy()
        assert g.shape == e.shape, n
        if not np.any(e):     # the aux loss does not reach the experts
            assert not np.any(g), n
        elif n == "router" and cotangent == "out" and \
                tcfg.experts_per_token == 1:
            scale = np.linalg.norm(exp["w_gate"])
            assert np.linalg.norm(g) <= 1e-4 * scale
            assert np.linalg.norm(e) <= 1e-4 * scale
        else:
            assert _rel(g, e) <= GRAD_REL_L2, (n, _rel(g, e))
    router = np.linalg.norm(grads[names.index("router")].numpy())
    assert router > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_one_decode_token(arch):
    """One token a row (the decode step): C = 4, nothing dropped, the
    reference's output."""
    jcfg, tcfg = _cfgs(arch)
    jp = jmoe.init_moe(jax.random.PRNGKey(4), jcfg)
    tp = _torch_tree(jax.tree.map(np.asarray, jp))
    x = np.random.RandomState(6).randn(3, 1, tcfg.d_model).astype(np.float32)
    jout, jaux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    out, aux = moe.moe_apply(tcfg, tp, torch.from_numpy(x))
    assert moe.route(tcfg, tp["router"], torch.from_numpy(x)).keep.all()
    assert _rel(out.numpy(), jout) <= APPLY_REL_L2
    np.testing.assert_allclose(float(aux), float(jaux), rtol=APPLY_REL_L2)
