"""Round simulation: port vs reference ``round_cost_table`` and
``simulate_round`` (with a deadline, with a binding energy budget and with
injected faults).

Masks and counts are exact; battery, durations and joules within rtol 1e-6
(float32 elementwise models in the reference's order; sums of a cohort's
joules reduced in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import clients as jclients  # noqa: E402
from repro.core.energy import EnergyModel as JEnergy  # noqa: E402
from repro.federated import faults as jfaults  # noqa: E402
from repro.federated import simulation as jsim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.energy import EnergyModel as TEnergy  # noqa: E402
from repro_torch.federated import faults as tfaults  # noqa: E402
from repro_torch.federated import simulation as tsim  # noqa: E402

RTOL = 1e-6
MODEL_BYTES = 3.0e6


def _pops(seed, n=64):
    pj = jclients.make_population(jax.random.PRNGKey(seed), n,
                                  init_battery_low=2.0,
                                  init_battery_high=30.0)
    return pj, convert.population(pj, "cpu")


def _close(j, t, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(j), np.asarray(t), rtol=rtol)


@pytest.mark.parametrize("up_bytes", [None, 0.25 * MODEL_BYTES])
def test_round_cost_table(up_bytes):
    pj, pt = _pops(0)
    tj, cj = jsim.round_cost_table(pj, JEnergy(0.02), MODEL_BYTES, 400, 20,
                                   up_bytes)
    tt, ct = tsim.round_cost_table(pt, TEnergy(0.02), MODEL_BYTES, 400, 20,
                                   up_bytes)
    _close(tj, tt)
    _close(cj, ct)
    _close(jsim.predicted_round_cost_pct(pj, JEnergy(0.02), MODEL_BYTES, 400,
                                         20, up_bytes),
           tsim.predicted_round_cost_pct(pt, TEnergy(0.02), MODEL_BYTES, 400,
                                         20, up_bytes))


def _compare_rounds(deadline_s, budget, rounds=4, seed=1, faults=None):
    fj = None if faults is None else jfaults.FaultConfig(**faults)
    ft = None if faults is None else tfaults.FaultConfig(**faults)
    pj, pt = _pops(seed)
    rs = np.random.RandomState(seed)
    spent_j = spent_t = 0.0
    refused = 0
    for rnd in range(1, rounds + 1):
        sel = rs.choice(pj.n, 12, replace=False)
        pj, oj = jsim.simulate_round(pj, sel, JEnergy(0.02), MODEL_BYTES,
                                     2000, 20, rnd, deadline_s, faults=fj,
                                     energy_budget_j=budget, spent_j=spent_j)
        pt, ot = tsim.simulate_round(pt, sel, TEnergy(0.02), MODEL_BYTES,
                                     2000, 20, rnd, deadline_s, faults=ft,
                                     energy_budget_j=budget, spent_j=spent_t)
        spent_j, spent_t = oj.spent_after_j, ot.spent_after_j
        np.testing.assert_array_equal(oj.selected, ot.selected)
        np.testing.assert_array_equal(oj.succeeded, ot.succeeded)
        assert oj.new_dropouts == ot.new_dropouts
        assert oj.admitted == ot.admitted
        assert oj.retries == ot.retries
        np.testing.assert_array_equal(oj.corrupt, ot.corrupt)
        refused += not ot.admitted
        _close(oj.durations, ot.durations)
        for f in ("round_duration", "energy_spent_pct", "energy_spent_j",
                  "spent_after_j"):
            _close(getattr(oj, f), getattr(ot, f))
        for f in ("dropped", "explored", "last_round", "times_selected"):
            np.testing.assert_array_equal(np.asarray(getattr(pj, f)),
                                          getattr(pt, f).numpy())
        _close(pj.battery_pct, pt.battery_pct.numpy())
        _close(pj.last_duration, pt.last_duration.numpy())
    return refused, pt


def test_simulate_round_no_deadline():
    _, pt = _compare_rounds(None, None)
    assert bool(pt.dropped.any())       # the low batteries do run out


@pytest.mark.parametrize("deadline_s", [0.0, 300.0, 1500.0])
def test_simulate_round_deadline(deadline_s):
    _compare_rounds(deadline_s, None)


def test_simulate_round_binding_budget():
    refused, _ = _compare_rounds(600.0, 40_000.0, rounds=6, seed=2)
    assert refused > 0                  # the budget does bind


def test_budget_gate_and_ledger():
    pj, pt = _pops(3, 16)
    mask = np.zeros(16, bool)
    mask[[1, 4, 9]] = True
    cost = np.linspace(1, 9, 16).astype(np.float32)
    jj = jsim.cohort_energy_j(pj, mask, cost)
    jt = tsim.cohort_energy_j(pt, torch.from_numpy(mask),
                              torch.from_numpy(cost))
    _close(jj, jt)
    led = tsim.BudgetLedger.create()
    m2, admit, led2 = tsim.budget_gate(torch.from_numpy(mask), jt, led,
                                       float(jt) * 0.5, 3)
    assert not bool(admit) and not bool(m2.any())
    assert int(led2.exhausted_round) == 3
    m3, admit, _ = tsim.budget_gate(torch.from_numpy(mask), jt, led, None, 3)
    assert bool(admit) and bool((m3 == torch.from_numpy(mask)).all())


FAULTS = dict(seed=4, crash_prob=0.3, max_retries=2, retry_backoff_s=7.3,
              retry_cost_frac=0.15, straggle_prob=0.25, corrupt_prob=0.2)


@pytest.mark.parametrize("deadline_s,budget", [(None, None), (600.0, None),
                                               (600.0, 40_000.0)])
def test_simulate_round_faults(deadline_s, budget):
    """Straggle, crash with retries and corrupt updates: fail masks,
    retries and corrupt flags exact; the debit includes the retries'
    surcharge, also at the budget gate."""
    _compare_rounds(deadline_s, budget, rounds=5, seed=2, faults=FAULTS)


def test_faults_are_rejected():
    """Fault configurations that make no sense are refused, as in the
    reference."""
    for bad in (dict(crash_prob=1.5), dict(straggle_prob=-0.1),
                dict(crash_prob=1.0, max_retries=1), dict(max_retries=-1)):
        with pytest.raises(ValueError):
            tfaults.FaultConfig(**bad)
        with pytest.raises(ValueError):
            jfaults.FaultConfig(**bad)
    assert not tfaults.FaultConfig().active
    assert tfaults.FaultConfig(corrupt_prob=0.1).active
