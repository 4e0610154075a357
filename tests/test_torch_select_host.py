"""The port's ``select_host`` (the eager numpy oracle) against the
reference's, and against the port's own ``select``.

The population is the reference's (``test_torch_selection._population``),
converted. The draws are each package's own threefry: the ``random``
kind's ``choice(replace=False, p=...)`` and the explore leg's Gumbel
ranks. Indices must be equal exactly, index for index, and the returned
state (Python numbers) exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from test_torch_selection import KINDS, _population  # noqa: E402

CASES = [dict(n=300, k=10, seed=0), dict(n=4099, k=64, seed=1),
         dict(n=300, k=10, seed=2, ties=True),
         dict(n=300, k=40, seed=3, epj_gate=True),
         dict(n=40, k=40, seed=4)]


def _states_equal(sj, st):
    assert int(sj.round) == int(st.round)
    for fld in ("epsilon", "pacer_T", "util_ema"):
        assert float(getattr(sj, fld)) == float(getattr(st, fld)), fld


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("kind", KINDS)
def test_select_host_matches_reference(kind, case):
    c = dict(CASES[case])
    n, k, seed = c.pop("n"), c.pop("k"), c.pop("seed")
    jpop, tpop, cost = _population(seed, n, **c)
    cfg_j, cfg_t = jsel.SelectorConfig(kind, k=k), tsel.SelectorConfig(kind,
                                                                       k=k)
    sj, st = jsel.SelectorState.create(cfg_j), tsel.SelectorState.create(cfg_t)
    kj = jax.random.PRNGKey(seed + 7)
    kt = convert.key(kj, "cpu")
    for _ in range(3):
        kj, ksj = jax.random.split(kj)
        kt, kst = prng.split(kt)
        ij, sj = jsel.select_host(ksj, cfg_j, sj, jpop, jnp.asarray(cost))
        it, st = tsel.select_host(kst, cfg_t, st, tpop,
                                  torch.from_numpy(cost))
        assert it.dtype == np.int64
        np.testing.assert_array_equal(it, ij)
        _states_equal(sj, st)
        # the picks join the explored pool, as after a round
        ex = np.array(jpop.explored)
        ex[ij] = True
        jpop = jpop.replace(explored=jnp.asarray(ex))
        tpop = tpop.replace(explored=torch.from_numpy(ex))


@pytest.mark.parametrize("kind", KINDS)
def test_select_equals_the_host_oracle(kind):
    """The port's ``select`` (both routes) picks what ``select_host`` picks
    on the same key: the oracle relation the million-client example
    asserts at fleet size."""
    jpop, tpop, cost = _population(5, 2000)
    cfg = tsel.SelectorConfig(kind, k=50)
    key = prng.PRNGKey(9, "cpu")
    cost = torch.from_numpy(cost)
    host, _ = tsel.select_host(key, cfg, tsel.SelectorState.create(cfg),
                               tpop, cost)
    for use_kernel in (False, True):
        dev, _ = tsel.select(key, cfg, tsel.SelectorState.create(cfg), tpop,
                             cost, use_kernel=use_kernel)
        np.testing.assert_array_equal(dev, host)


def test_no_valid_client_picks_nothing():
    _, tpop, cost = _population(0, 30)
    tpop = tpop.replace(dropped=torch.ones(30, dtype=torch.bool))
    cfg = tsel.SelectorConfig("eafl", k=5)
    idx, st = tsel.select_host(prng.PRNGKey(0, "cpu"), cfg,
                               tsel.SelectorState.create(cfg), tpop)
    assert idx.shape == (0,) and st.round == 1


def test_gumbel_and_choice_follow_the_reference():
    """The draws themselves: every Gumbel within two ulps of JAX's (of
    itself, or of 1 near 0, where the inner log's last bit shows), the
    order of the largest equal, and ``choice(replace=False, p)`` equal."""
    kj = jax.random.PRNGKey(11)
    kt = convert.key(kj, "cpu")
    gj = np.asarray(jax.random.gumbel(kj, (5000,)))
    gt = prng.gumbel(kt, (5000,)).numpy()
    np.testing.assert_allclose(gt, gj, rtol=2.5e-7, atol=2.4e-7)
    np.testing.assert_array_equal(np.argsort(-gt, kind="stable")[:500],
                                  np.argsort(-gj, kind="stable")[:500])
    valid = np.random.RandomState(0).rand(5000) < 0.8
    p = valid / valid.sum()
    cj = np.asarray(jax.random.choice(kj, 5000, (100,), replace=False,
                                      p=jnp.asarray(p)))
    ct = prng.choice_without_replacement(
        kt, 5000, 100, torch.from_numpy(p).to(torch.float32))
    np.testing.assert_array_equal(ct.numpy(), cj)
