"""The port's snapshot ring under random FedBuff traffic: the host dict
ring (``_SnapshotRing``, the specification) and the array ring in the
engine carry (``SnapshotRingState`` with ``_ring_retain`` and
``_ring_release``) take the same retain, release and flush traffic, the
fuzz of ``tests/test_snapshot_ring.py``, and are checked against each
other and against a host recount.

Under any traffic the engine can make (flush the earliest min(B, in
flight), bump the version when something flushed, refill at most the
freed slots at the current version): no slot leaks, no live version is
freed, ``live_versions <= max_concurrency``, both rings agree on the live
versions, their counts and their parameters, and the success counters
match the recount."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.federated.async_server import (  # noqa: E402
    _I32_MAX, SnapshotRingState, _ring_create, _ring_lookup, _ring_release,
    _ring_retain, _SnapshotRing)

KEY = torch.zeros(2, dtype=torch.int64)


def _params_for(version: int):
    """A payload that tells versions apart: the ring must hand back the
    parameters of exactly the requested version."""
    return {"w": torch.full((2,), float(version))}


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


def _ring_live(ring: SnapshotRingState):
    """version -> (refs, succ, payload) of the array ring."""
    v, refs, succ = ring.version.tolist(), ring.refs.tolist(), \
        ring.succ.tolist()
    w = ring.params["w"]
    return {v[s]: (refs[s], succ[s], float(w[s, 0]))
            for s in range(len(v)) if v[s] >= 0}


def _drive(seq, buffer_size, max_concurrency, rng):
    array_ring = _ring_create(_params_for(0), max_concurrency)
    dict_ring = _SnapshotRing()
    in_flight = []           # one version entry per in-flight client
    succ_count = {}          # version -> successful completions so far
    version = 0

    # the fill: up to C clients at version 0
    n0 = seq[0] % (max_concurrency + 1)
    if n0 > 0:
        array_ring = _ring_retain(array_ring, _i32(version),
                                  _params_for(version), _i32(n0), KEY)
        dict_ring.retain(version, _params_for(version), n0)
        in_flight += [version] * n0

    for step in seq[1:]:
        # ---- flush the earliest min(B, in flight) arrivals -------------
        n_flush = min(buffer_size, len(in_flight))
        rng.shuffle(in_flight)       # the arrival order depends on traffic
        flushed, in_flight = in_flight[:n_flush], in_flight[n_flush:]
        v_eff = np.full((buffer_size,), _I32_MAX, np.int64)
        chosen = np.zeros((buffer_size,), bool)
        succ = np.zeros((buffer_size,), bool)
        for i, v in enumerate(flushed):
            v_eff[i], chosen[i] = v, True
            succ[i] = bool(step & (1 << i))
            if succ[i]:
                succ_count[v] = succ_count.get(v, 0) + 1
        slots = _ring_lookup(array_ring, torch.from_numpy(v_eff))
        for i, v in enumerate(flushed):
            assert float(array_ring.params["w"][slots[i], 0]) == float(v)
        array_ring = _ring_release(array_ring,
                                   torch.from_numpy(v_eff).to(torch.int32),
                                   torch.from_numpy(chosen),
                                   torch.from_numpy(succ))
        for v in flushed:
            dict_ring.release(v)
        if n_flush > 0:
            version += 1
            succ_count.setdefault(version, 0)
        # ---- refill at most the freed slots at the current version -----
        n_start = step % (max_concurrency - len(in_flight) + 1)
        array_ring = _ring_retain(array_ring, _i32(version),
                                  _params_for(version), _i32(n_start), KEY)
        if n_start > 0:
            dict_ring.retain(version, _params_for(version), n_start)
            in_flight += [version] * n_start

        # ---- the invariants ---------------------------------------------
        live = _ring_live(array_ring)
        assert len(live) <= max_concurrency, "ring overflow"
        assert int(array_ring.live_versions) == dict_ring.live_versions
        assert set(live) == set(dict_ring._params)
        expect_refs = {}
        for v in in_flight:
            expect_refs[v] = expect_refs.get(v, 0) + 1
        assert set(live) == set(expect_refs), "leak or premature free"
        for v, (refs, s, w) in live.items():
            assert refs == expect_refs[v] == dict_ring._refs[v], v
            assert w == float(v) == float(dict_ring.get(v)["w"][0]), v
            assert s == succ_count.get(v, 0), v
    return version


@settings(max_examples=60, deadline=None)
@given(seq=st.lists(st.integers(min_value=0, max_value=2 ** 16 - 1),
                    min_size=2, max_size=25),
       geometry=st.integers(min_value=0, max_value=8),
       rnd=st.randoms(use_true_random=False))
def test_ring_fuzz_no_leaks_no_premature_free(seq, geometry, rnd):
    buffer_size = 1 + geometry % 3
    max_concurrency = buffer_size + geometry // 3
    _drive(seq, buffer_size, max_concurrency, rnd)


def test_ring_retain_zero_count_is_noop():
    ring = _ring_create(_params_for(0), 4)
    before = ring.params["w"].clone()
    ring2 = _ring_retain(ring, _i32(3), _params_for(3), _i32(0), KEY)
    assert _ring_live(ring2) == {}
    assert torch.equal(ring2.params["w"], before)


def test_ring_release_of_masked_rows_is_noop():
    ring = _ring_create(_params_for(0), 4)
    ring = _ring_retain(ring, _i32(0), _params_for(0), _i32(2), KEY)
    masked = torch.full((3,), _I32_MAX, dtype=torch.int32)
    ring2 = _ring_release(ring, masked, torch.zeros(3, dtype=torch.bool),
                          torch.zeros(3, dtype=torch.bool))
    assert _ring_live(ring2) == {0: (2, 0, 0.0)}


def test_ring_retain_writes_in_place():
    """A retain copies one model into the ring's own tensors (a replayed
    step must not allocate a second ring)."""
    ring = _ring_create(_params_for(0), 3)
    w = ring.params["w"]
    ring2 = _ring_retain(ring, _i32(5), _params_for(5), _i32(1),
                         torch.tensor([7, 9]))
    assert ring2.params["w"] is w
    assert _ring_live(ring2) == {5: (1, 0, 5.0)}
    assert ring2.tkey[0].tolist() == [7, 9]
