"""``_device_select`` against the reference's ``select_device``.

``use_kernel=False`` is held against ``use_pallas=False`` (affine-folded
score + lax.top_k) and ``use_kernel=True`` against ``use_pallas=True`` in
interpret mode; never the two against each other. ``idx`` and ``chosen``
must be equal exactly; the SelectorState within rtol 1e-6 (float32 sums
of a few utilities, reduced in another order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import clients as jclients  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402

KINDS = ["eafl", "oort", "random", "eafl-epj"]


def _population(seed, n, ties=False, epj_gate=False):
    pop = jclients.make_population(jax.random.PRNGKey(seed), n)
    rs = np.random.RandomState(seed)
    f = {k: np.array(getattr(pop, k)) for k in tsel.ClientPopulation.
         __dataclass_fields__}
    f["stat_util"] = (rs.rand(n) * 50).astype(np.float32)
    f["explored"] = rs.rand(n) < 0.6
    f["last_duration"] = (rs.rand(n) * 400).astype(np.float32)
    f["last_round"] = rs.randint(0, 3, n).astype(np.int32)
    f["dropped"] = rs.rand(n) < 0.05
    cost = (rs.rand(n) * 30).astype(np.float32)
    if ties:
        # duplicated clients: every field of a group equals its first
        for start in range(0, n, 9):
            for k in f:
                f[k][start:start + 9:3] = f[k][start]
            cost[start:start + 9:3] = cost[start]
    if epj_gate:
        # a third of the clients would not survive the round
        cost[::3] = f["battery_pct"][::3] + 1.0
    jpop = jclients.ClientPopulation(**{k: jnp.asarray(v)
                                        for k, v in f.items()})
    return jpop, convert.population(f, "cpu"), cost


def _run(kind, use_kernel, *, n=300, k=10, f=0.25, rounds=3, seed=0,
         ties=False, epj_gate=False, normalize=True):
    jpop, tpop, cost = _population(seed, n, ties, epj_gate)
    cfg_j = jsel.SelectorConfig(kind, k=k, f=f, normalize_reward=normalize)
    cfg_t = tsel.SelectorConfig(kind, k=k, f=f, normalize_reward=normalize)
    sj, st = jsel.SelectorState.create(cfg_j), tsel.SelectorState.create(cfg_t)
    kj = jax.random.PRNGKey(seed + 100)
    kt = convert.key(kj, "cpu")
    tcost = torch.from_numpy(cost)
    for _ in range(rounds):
        kj, ksj = jax.random.split(kj)
        kt, kst = prng.split(kt)
        ij, cj, sj = jsel.select_device(ksj, cfg_j, sj, jpop,
                                        jnp.asarray(cost),
                                        use_pallas=use_kernel,
                                        interpret=True)
        it, ct, st = tsel._device_select(kst, cfg_t, st, tpop, tcost,
                                         use_kernel)
        np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
        np.testing.assert_array_equal(np.asarray(ij), it.numpy())
        assert int(sj.round) == int(st.round)
        for fld in ("epsilon", "pacer_T", "util_ema"):
            np.testing.assert_allclose(float(getattr(sj, fld)),
                                       float(getattr(st, fld)), rtol=1e-6)
        # the chosen clients join the explored pool, as after a round
        sel = np.asarray(ij)[np.asarray(cj)]
        ex = np.array(jpop.explored)
        ex[sel] = True
        jpop = jpop.replace(explored=jnp.asarray(ex))
        tpop = tpop.replace(explored=torch.from_numpy(ex))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_select_matches_reference(kind, use_kernel):
    # f=0.3 is not a power of two, so the fused multiply-add matters
    _run(kind, use_kernel, f=0.3)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ties_from_duplicated_clients(kind, use_kernel):
    _run(kind, use_kernel, ties=True, seed=1)


@pytest.mark.parametrize("kind", KINDS)
def test_k_larger_than_n(kind):
    _run(kind, False, n=7, k=12, seed=2)
    _run(kind, True, n=7, k=12, seed=2)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_eafl_epj_survival_mask(use_kernel):
    _run("eafl-epj", use_kernel, epj_gate=True, seed=3, rounds=4)


def test_unnormalized_eafl():
    _run("eafl", False, normalize=False, f=0.3, seed=4)
    _run("eafl", True, normalize=False, f=0.3, seed=4)


@pytest.mark.parametrize("kind", ["eafl", "oort", "eafl-epj"])
@pytest.mark.parametrize("f", [0.25, 0.3])
def test_compute_scores_bitwise(kind, f):
    jpop, tpop, cost = _population(5, 200)
    cfg_j = jsel.SelectorConfig(kind, f=f)
    cfg_t = tsel.SelectorConfig(kind, f=f)
    state = dataclasses.replace(jsel.SelectorState.create(cfg_j), round=2)
    sj = jax.jit(jsel.compute_scores, static_argnums=0)(
        cfg_j, state.canonical(), jpop, jnp.asarray(cost))
    st = tsel.compute_scores(
        cfg_t, tsel.SelectorState(2, 0.9, 120.0, 0.0), tpop,
        torch.from_numpy(cost))
    np.testing.assert_array_equal(np.asarray(sj).view(np.int32),
                                  st.numpy().view(np.int32))


def test_select_facade_trims_to_chosen():
    jpop, tpop, cost = _population(6, 50)
    cfg = tsel.SelectorConfig("eafl", k=8)
    idx, state = tsel.select(prng.PRNGKey(0, "cpu"), cfg,
                             tsel.SelectorState.create(cfg), tpop,
                             torch.from_numpy(cost))
    ij, _ = jsel.select(jax.random.PRNGKey(0), jsel.SelectorConfig("eafl",
                                                                   k=8),
                        jsel.SelectorState.create(jsel.SelectorConfig(
                            "eafl", k=8)), jpop, jnp.asarray(cost))
    assert idx.dtype == np.int64
    np.testing.assert_array_equal(ij, idx)
    assert int(state.round) == 1


@pytest.mark.parametrize("n,k", [(12, 12), (200, 17)])
def test_top_k_idx_orders_signed_zero_and_nan_as_lax_top_k(n, k):
    """The selector's top-k over scores with -0/+0 and -NaN/+NaN equals
    lax.top_k: indices exactly, the picked values bitwise."""
    rs = np.random.RandomState(n)
    nan = np.float32("nan")
    pool = np.array([0.0, -0.0, nan, -nan, -np.inf, np.inf], np.float32)
    x = rs.rand(n).astype(np.float32) - np.float32(0.5)
    pick = rs.rand(n) < 0.6
    x[pick] = pool[rs.randint(0, len(pool), int(pick.sum()))]
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    ti = tsel._top_k_idx(torch.from_numpy(x), k)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv).view(np.int32),
                                  x[ti.numpy()].view(np.int32))
