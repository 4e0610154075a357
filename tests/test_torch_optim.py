"""Optimizers, aggregation and codecs: port vs reference on the same
trees. Tolerance rtol 1e-6 / atol 1e-7: float32 elementwise updates in the
reference's order (the weighted mean sums clients in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compression import codecs as jcodecs  # noqa: E402
from repro.federated import aggregation as jagg  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.compression import codecs as tcodecs  # noqa: E402
from repro_torch.federated import aggregation as tagg  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, lead=()):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(*lead, 4, 3).astype(np.float32),
            "stages": [{"b": rs.randn(*lead, 5).astype(np.float32)}],
            "head": rs.randn(*lead, 40).astype(np.float32)}


def _to_j(t):
    return jax.tree.map(jnp.asarray, t)


def _to_t(t):
    return jax.tree.map(torch.from_numpy, t)


def _assert_trees(j, t, **tol):
    lj = jax.tree_util.tree_leaves(j)
    lt = jax.tree_util.tree_leaves(t)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **(tol or TOL))


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adam", "yogi",
                                  "adagrad", "adamw"])
def test_optimizers_three_steps(name):
    make = {"sgd": lambda m: m.sgd(0.1),
            "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9),
            "adam": lambda m: m.adam(0.01),
            "yogi": lambda m: m.yogi(0.05),
            "adagrad": lambda m: m.adagrad(0.1),
            "adamw": lambda m: m.adamw(0.01, weight_decay=0.1)}[name]
    oj, ot = make(jopt), make(topt)
    pj, pt = _to_j(_tree(0)), _to_t(_tree(0))
    sj, st = oj.init(pj), ot.init(pt)
    for step in range(3):
        g = _tree(step + 1)
        uj, sj = jax.jit(oj.update)(_to_j(g), sj, pj)
        ut, st = ot.update(_to_t(g), st, pt)
        pj, pt = jopt.apply_updates(pj, uj), topt.apply_updates(pt, ut)
        _assert_trees(pj, pt)


@pytest.mark.parametrize("opt_name", ["yogi", "fedadam", "fedadagrad",
                                      "fedavg"])
def test_weighted_delta_and_server_update(opt_name):
    deltas = _tree(3, lead=(5,))
    w = np.array([64, 0, 32, 64, 16], np.float32)
    aj = jagg.weighted_delta(_to_j(deltas), jnp.asarray(w))
    at = tagg.weighted_delta(_to_t(deltas), torch.from_numpy(w))
    _assert_trees(aj, at, rtol=1e-6, atol=1e-6)
    oj = jagg.make_server_optimizer(opt_name, 0.05)
    ot = tagg.make_server_optimizer(opt_name, 0.05)
    pj, pt = _to_j(_tree(4)), _to_t(_tree(4))
    pj, _ = jagg.server_update(pj, aj, oj, oj.init(pj))
    pt, _ = tagg.server_update(pt, at, ot, ot.init(pt))
    _assert_trees(pj, pt, rtol=1e-6, atol=1e-6)
    with pytest.raises(KeyError):
        tagg.make_server_optimizer("nope", 0.1)


def test_quarantine_helpers():
    deltas = _tree(5, lead=(4,))
    deltas["w"][1, 0, 0] = np.nan
    deltas["head"][3, 7] = np.inf
    fj = jagg.finite_rows(_to_j(deltas))
    ft = tagg.finite_rows(_to_t(deltas))
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    zj = jagg.zero_nonfinite_rows(_to_j(deltas), fj)
    zt = tagg.zero_nonfinite_rows(_to_t(deltas), ft)
    _assert_trees(zj, zt)
    assert bool(jagg.tree_finite(zj)) == bool(tagg.tree_finite(zt)) is True
    assert bool(tagg.tree_finite(_to_t(deltas))) is False


@pytest.mark.parametrize("codec,params", [("none", {}), ("int8", {}),
                                          ("topk", {"sparsity": 0.05}),
                                          ("topk", {"sparsity": 0.2})])
def test_codecs(codec, params):
    delta = _tree(6)
    rj = jcodecs.compress_delta(codec, _to_j(delta), **params)
    rt = tcodecs.compress_delta(codec, _to_t(delta), **params)
    assert rj.wire_ratio == rt.wire_ratio == \
        tcodecs.compression_ratio(codec, **params)
    _assert_trees(rj.delta, rt.delta)
    assert tcodecs.wire_bytes(1000.0, codec, **params) == \
        jcodecs.wire_bytes(1000.0, codec, **params)
    # the cohort applies codecs per client under vmap
    stacked = _to_t(_tree(7, lead=(3,)))
    batched = torch.func.vmap(
        lambda d: tcodecs.compress_delta(codec, d, **params).delta)(stacked)
    for c in range(3):
        one = tcodecs.compress_delta(
            codec, jax.tree.map(lambda x: x[c], stacked), **params).delta
        _assert_trees(jax.tree.map(lambda x: x[c], batched), one)
