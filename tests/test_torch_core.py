"""Energy models, round times, rewards and fairness: port vs reference.

Tolerance rtol 1e-6: float32 elementwise arithmetic in the reference's
order, where log/exp/sqrt may differ by one ulp between the libraries.
The reference functions run under ``jax.jit``, as they do in the engines
(XLA then fuses ``a*x + b`` into one multiply-add, which the port
reproduces)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import clients as jclients  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import fairness as jfair  # noqa: E402
from repro.core import rewards as jrewards  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import clients as tclients  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import fairness as tfair  # noqa: E402
from repro_torch.core import rewards as trewards  # noqa: E402

RTOL = 1e-6


def _close(j, t, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=rtol, atol=atol)


def _inputs(seed, n=257):
    rs = np.random.RandomState(seed)
    return {
        "category": rs.randint(0, 3, n).astype(np.int32),
        "network": rs.randint(0, 2, n).astype(np.int32),
        "t": (rs.rand(n) * 5000).astype(np.float32),
        "t2": (rs.rand(n) * 900).astype(np.float32),
        "pct": (rs.rand(n) * 100).astype(np.float32),
        "loss": (rs.rand(n, 9) * 4).astype(np.float32),
        "valid": rs.rand(n) < 0.7,
        "x": (rs.randn(n) * 3).astype(np.float32),
        "counts": rs.randint(0, 6, n).astype(np.int32),
    }


T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_energy_models(seed):
    d = _inputs(seed)
    cat, net, t, t2, pct = (d[k] for k in ("category", "network", "t", "t2",
                                            "pct"))
    j = jax.jit
    _close(j(jenergy.battery_wh)(cat), tenergy.battery_wh(T(cat)))
    _close(j(jenergy.pct_to_joules)(cat, pct),
           tenergy.pct_to_joules(T(cat), T(pct)))
    _close(j(jenergy.samples_per_sec)(cat), tenergy.samples_per_sec(T(cat)))
    _close(j(jenergy.comp_battery_pct)(cat, t),
           tenergy.comp_battery_pct(T(cat), T(t)))
    for scale in (False, True):
        ref = j(lambda n_, a, b, c: jenergy.comm_battery_pct(
            n_, a, b, c, scale))(net, t, t2, cat)
        _close(ref, tenergy.comm_battery_pct(T(net), T(t), T(t2), T(cat),
                                             scale))
    _close(j(lambda c, s: jenergy.idle_battery_pct(c, s, 0.02))(cat, t),
           tenergy.idle_battery_pct(T(cat), T(t), 0.02))
    em_j, em_t = jenergy.EnergyModel(0.02), tenergy.EnergyModel(0.02)
    _close(j(em_j.round_cost_pct)(cat, net, t, t2, t),
           em_t.round_cost_pct(T(cat), T(net), T(t), T(t2), T(t)))
    # idle drain over one scalar round duration (the simulation's use)
    _close(j(em_j.idle_cost_pct)(cat, jnp.float32(1234.5)),
           em_t.idle_cost_pct(T(cat), torch.tensor(1234.5)))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("up_bytes", [None, 12345.0])
def test_population_and_round_times(seed, up_bytes):
    key = jax.random.PRNGKey(seed)
    pj = jclients.make_population(key, 999)
    pt = tclients.make_population(convert.key(key, "cpu"), 999)
    # categories, networks and batteries come from exact threefry draws
    for f in ("category", "network", "battery_pct", "n_samples", "explored"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, f)),
                                      getattr(pt, f).numpy())
    # bandwidths go through normal (erfinv differs in its last bits)
    for f in ("down_mbps", "up_mbps"):
        _close(getattr(pj, f), getattr(pt, f), rtol=1e-4)
    # round times on the SAME population (converted from the reference)
    pt = convert.population({f: np.asarray(getattr(pj, f))
                             for f in tclients._FIELDS}, "cpu")
    rj = jax.jit(lambda p: jclients.round_times(p, 52_000.0, 10, 20,
                                                up_bytes))(pj)
    rt = tclients.round_times(pt, 52_000.0, 10, 20, up_bytes)
    for k in ("down", "comp", "up", "total"):
        _close(rj[k], rt[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rewards(seed):
    d = _inputs(seed)
    loss, t, x, valid = d["loss"], d["t"], d["x"], d["valid"]
    n = d["counts"].astype(np.float32)
    j = jax.jit
    _close(j(jrewards.stat_utility)(loss, n),
           trewards.stat_utility(T(loss), T(n)))
    for alpha in (2.0, 1.5):
        _close(j(lambda a, b: jrewards.system_penalty(a, b, alpha))(
            jnp.float32(700.0), t),
            trewards.system_penalty(torch.tensor(700.0), T(t), alpha))
        _close(j(lambda a, b: jrewards.oort_utility(a, b, 700.0, alpha))(
            x, t), trewards.oort_utility(T(x), T(t), 700.0, alpha))
    _close(j(jrewards.projected_power)(d["pct"], x),
           trewards.projected_power(T(d["pct"]), T(x)))
    lo_j, r_j = j(jrewards.minmax_range)(x, valid)
    lo_t, r_t = trewards.minmax_range(T(x), T(valid))
    _close(lo_j, lo_t)
    _close(r_j, r_t)
    _close(j(jrewards.minmax_normalize)(x, valid),
           trewards.minmax_normalize(T(x), T(valid)))
    for f in (0.25, 0.3):
        for norm in (True, False):
            _close(j(lambda a, b, v: jrewards.eafl_reward(a, b, f, v, norm))(
                x, d["pct"], valid),
                trewards.eafl_reward(T(x), T(d["pct"]), f, T(valid), norm))


def test_minmax_range_empty_valid():
    x = np.arange(5, dtype=np.float32)
    none = np.zeros(5, bool)
    lo_j, r_j = jrewards.minmax_range(x, none)
    lo_t, r_t = trewards.minmax_range(T(x), T(none))
    assert float(lo_j) == float(lo_t) == float("inf")
    assert float(r_j) == float(r_t)


@pytest.mark.parametrize("seed", [0, 1])
def test_jains_index_and_stat_util_scatter(seed):
    d = _inputs(seed)
    _close(jfair.jains_index(d["counts"]), tfair.jains_index(T(d["counts"])))
    zeros = np.zeros(9, np.int32)
    assert float(jfair.jains_index(zeros)) == float(
        tfair.jains_index(T(zeros))) == 1.0
    pj = jclients.make_population(jax.random.PRNGKey(seed), 20)
    pt = convert.population(pj, "cpu")
    idx = np.array([3, 7, 11, 2])
    mask = np.array([True, False, True, True])
    su = np.array([1.5, 2.5, 3.5, 4.5], np.float32)
    out_j = jclients.scatter_stat_util(pj, jnp.asarray(idx),
                                       jnp.asarray(mask), jnp.asarray(su))
    out_t = tclients.scatter_stat_util(pt, T(idx), T(mask), T(su))
    np.testing.assert_array_equal(np.asarray(out_j.stat_util),
                                  out_t.stat_util.numpy())
