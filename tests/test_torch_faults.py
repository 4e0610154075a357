"""Fault injection: the port's ``federated/faults.py`` against the
reference's, and the host ``run_fl`` with faults against the reference's.

The fault streams are threefry uniforms over ``fold_in`` keys, so they are
bit-exact; so are the geometric retry counts, the lost uploads and the
corrupt flags (the retry count is ``floor(log(u) * (1 / log p))`` with the
reciprocal folded to float32 as the reference's compiled program folds
it), and the straggle- and retry-modified durations and costs (one fused
multiply-add each, as there). The training run is held at the tolerances
of ``tests/test_torch_server.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_server import _cfgs, _patch_reference_draws  # noqa: E402
from test_torch_training_engines import one_thread  # noqa: E402,F401
from repro.federated import faults as jfaults  # noqa: E402
from repro.federated import server as jserver  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.federated import faults as tfaults  # noqa: E402
from repro_torch.federated import server as tserver  # noqa: E402

CONFIGS = [
    dict(seed=3, crash_prob=0.3, max_retries=2, straggle_prob=0.2,
         corrupt_prob=0.1),
    dict(seed=5, crash_prob=0.05, max_retries=7, retry_backoff_s=11.3,
         retry_cost_frac=0.37, straggle_prob=0.5, straggle_factor=2.7),
    dict(seed=1, crash_prob=0.9, max_retries=3),
    dict(seed=2, crash_prob=0.5),
    dict(seed=9, crash_prob=0.999, max_retries=40, corrupt_prob=1.0),
]
ROUNDS = (1, 2, 3, 77, 2**31 - 1)
N = 100_000


def _inputs(n):
    rng = np.random.default_rng(0)
    return (rng.uniform(1, 500, n).astype(np.float32),
            rng.uniform(0.01, 5, n).astype(np.float32))


@pytest.mark.parametrize("rnd", ROUNDS)
def test_fold_in_takes_a_device_round(rnd):
    key = prng.PRNGKey(11, "cpu")
    for dtype in (torch.int32, torch.int64):
        assert torch.equal(prng.fold_in(key, torch.tensor(rnd, dtype=dtype)),
                           prng.fold_in(key, rnd))
    ref = jax.random.fold_in(jax.random.PRNGKey(11), jnp.int32(rnd))
    np.testing.assert_array_equal(
        np.asarray(ref).astype(np.int64),
        prng.fold_in(key, torch.tensor(rnd, dtype=torch.int32)).numpy())


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_faults_equal_the_reference(i):
    """10^5 clients in one round and 257 in each of the others (the round
    number folded in from a device tensor): streams, retries, fail,
    corrupt, t_eff and cost_eff bitwise."""
    jc, tc = jfaults.FaultConfig(**CONFIGS[i]), tfaults.FaultConfig(
        **CONFIGS[i])
    run = jax.jit(lambda r, t, c: jfaults.faults_for_round(jc, r, t, c))
    streams = jax.jit(lambda r: jfaults.fault_streams(jc, r, 257))
    for j, rnd in enumerate(ROUNDS):
        t, c = _inputs(N if j == i % len(ROUNDS) else 257)
        r_t = torch.tensor(rnd, dtype=torch.int32)
        for a, b in zip(streams(jnp.int32(rnd)),
                        tfaults.fault_streams(tc, r_t, 257, "cpu")):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        te, ce, d = run(jnp.int32(rnd), t, c)
        te2, ce2, d2 = tfaults.faults_for_round(tc, r_t, torch.from_numpy(t),
                                                torch.from_numpy(c))
        for name in ("fail", "retries", "corrupt"):
            np.testing.assert_array_equal(np.asarray(getattr(d, name)),
                                          getattr(d2, name).numpy(), name)
        np.testing.assert_array_equal(np.asarray(te), te2.numpy())
        np.testing.assert_array_equal(np.asarray(ce), ce2.numpy())
        if tc.max_retries and len(t) == N:
            assert int(d2.retries.sum()) > 0


def test_inactive_faults_are_the_identity():
    t, c = (torch.from_numpy(a) for a in _inputs(64))
    for fc in (None, tfaults.FaultConfig(seed=4, max_retries=3)):
        te, ce, draw = tfaults.faults_for_round(fc, 1, t, c)
        assert te is t and ce is c and draw is None


FAULTS = dict(seed=1, crash_prob=0.3, max_retries=2, straggle_prob=0.3,
              corrupt_prob=0.3)


def test_host_run_fl_with_faults_matches_reference(monkeypatch):
    """Crash with retries, straggle and corrupt updates, with a deadline
    and a budget: the port's host loop on the reference's draws against
    the reference's host loop."""
    jcfg, tcfg = _cfgs("eafl")
    extra = dict(deadline_s=2.0, energy_budget_j=3000.0)
    jcfg = dataclasses.replace(jcfg, faults=jfaults.FaultConfig(**FAULTS),
                               **extra)
    tcfg = dataclasses.replace(tcfg, faults=tfaults.FaultConfig(**FAULTS),
                               **extra)
    ref = jserver.run_fl(jcfg, engine="host")
    _patch_reference_draws(monkeypatch, jcfg)
    out = tserver.run_fl(tcfg, device="cpu")
    for f in ("round", "cum_dropouts", "retries", "quarantined",
              "update_skipped", "budget_exhausted_round"):
        assert getattr(out, f) == getattr(ref, f), f
    assert sum(out.retries) > 0 and sum(out.quarantined) > 0
    for f in ("fairness", "participation", "wall_hours", "mean_battery",
              "energy_spent_j", "round_duration"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=1e-5, err_msg=f)
    for f in ("train_loss", "test_acc"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f),
                                   rtol=2e-3, err_msg=f)
