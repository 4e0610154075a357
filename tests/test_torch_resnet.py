"""ResNet forward, loss and gradients: port (NCHW/OIHW, F.conv2d) vs
reference (NHWC/HWIO, XLA convolutions) on converted weights.

Tolerance atol/rtol 1e-4: the two convolution libraries sum in different
orders in float32."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.func import grad  # noqa: E402

from repro.configs.paper_resnet_speech import reduced as jreduced  # noqa: E402
from repro.models import resnet as jres  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.paper_resnet_speech import reduced as treduced  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _setup(hw, seed=0, blocks=1, batch=6):
    jcfg = dataclasses.replace(jreduced(), input_hw=hw,
                               blocks_per_stage=blocks)
    tcfg = dataclasses.replace(treduced(), input_hw=hw,
                               blocks_per_stage=blocks)
    pj = jax.jit(jres.init_resnet, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    pt = convert.resnet_params(jax.tree.map(np.asarray, pj), "cpu")
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, hw, hw, 1).astype(np.float32)
    y = rs.randint(0, jcfg.n_classes, batch)
    return jcfg, tcfg, pj, pt, x, y


@pytest.mark.parametrize("hw,blocks", [(16, 1)])
def test_forward_loss_grads(hw, blocks):
    """reduced() has a stride-2 first block in stages 2 and 3; at 16 the
    sizes are even, so SAME padding is asymmetric (odd sizes are held in
    test_stride2_same_padding_is_xla_s)."""
    jcfg, tcfg, pj, pt, x, y = _setup(hw, blocks=blocks)
    lj = jax.jit(lambda p, x_: jres.resnet_forward(jcfg, p, x_))(
        pj, jnp.asarray(x))
    lt = tres.resnet_forward(tcfg, pt, torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), **TOL)

    bj = {"x": jnp.asarray(x), "y": jnp.asarray(y.astype(np.int32))}
    bt = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    (mj, sj), gj = jax.jit(jax.value_and_grad(
        lambda p: jres.resnet_loss(jcfg, p, bj), has_aux=True))(pj)
    mt, st = tres.resnet_loss(tcfg, pt, bt)
    np.testing.assert_allclose(float(mj), float(mt), **TOL)
    np.testing.assert_allclose(np.asarray(sj), st.numpy(), **TOL)
    gt = grad(lambda p: tres.resnet_loss(tcfg, p, bt)[0])(pt)
    gj = convert.resnet_params(jax.tree.map(np.asarray, gj), "cpu")
    flat_j = jax.tree_util.tree_leaves(gj)
    flat_t = jax.tree_util.tree_leaves(gt)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    acc_j = jax.jit(lambda p: jres.resnet_accuracy(jcfg, p, bj))(pj)
    acc_t = tres.resnet_accuracy(tcfg, pt, bt)
    assert float(acc_j) == float(acc_t)


@pytest.mark.parametrize("hw,k", [(16, 3), (15, 3), (16, 1)])
def test_stride2_same_padding_is_xla_s(hw, k):
    """A 3x3 stride-2 conv on an even size pads 0 before and 1 after;
    symmetric padding=1 would shift every window with equal shapes."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, hw, hw, 4).astype(np.float32)
    w = rs.randn(k, k, 4, 5).astype(np.float32)
    ref = np.asarray(jres.conv2d(jnp.asarray(x), jnp.asarray(w), stride=2))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    out = tres.conv2d(xt, wt, stride=2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ref, out, **TOL)
    if k == 3 and hw % 2 == 0:
        sym = F.conv2d(xt, wt, stride=2, padding=1).permute(0, 2, 3, 1)
        assert sym.shape == out.shape
        assert not np.allclose(ref, sym.numpy(), **TOL)


def test_group_norm_matches():
    rs = np.random.RandomState(2)
    for c in (4, 8, 16):
        x = rs.randn(3, 5, 5, c).astype(np.float32) * 3 + 1
        g = rs.rand(c).astype(np.float32)
        b = rs.randn(c).astype(np.float32)
        ref = jres.group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
        out = tres.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                              torch.from_numpy(g), torch.from_numpy(b))
        np.testing.assert_allclose(np.asarray(ref),
                                   out.permute(0, 2, 3, 1).numpy(), **TOL)


def test_init_structure_and_draws():
    """The port draws its own weights from the reference's key schedule:
    same tree, same shapes (OIHW), values close (normal via erfinv)."""
    jcfg, tcfg, pj, pt, _, _ = _setup(16, seed=3, blocks=1)
    own = tres.init_resnet(convert.key(jax.random.PRNGKey(3), "cpu"), tcfg)
    for a, b in zip(jax.tree_util.tree_leaves(pt),
                    jax.tree_util.tree_leaves(own)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
