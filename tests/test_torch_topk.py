"""The port's plain ``topk_reward`` against the reference Pallas kernel
(interpret mode on the CPU).

Indices must be equal exactly, and values bitwise (masked clients score
the finite SENTINEL in both). The reference kernel's block merge is a
global stable top-k, which is the plain version's definition. Sizes stay
small: interpret mode unrolls k argmax rounds per block."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import topk_select as jtk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.numerics import orderable_key  # noqa: E402


def _inputs(seed, n, ties=False, valid_frac=0.8, mode="eafl"):
    rs = np.random.RandomState(seed)
    a = rs.rand(n).astype(np.float32)
    b = rs.rand(n).astype(np.float32)
    if mode == "eafl-epj":
        b = (b * 0.01).astype(np.float32)     # straddles the 1e-3 floor
    if ties:
        a[::3] = a[0]
        b[::3] = b[0]
    valid = (rs.rand(n) < valid_frac).astype(np.int32)
    ucb = (rs.rand(n) * 0.3).astype(np.float32)
    return a, b, valid, ucb


def _check(a, b, valid, ucb, *, f, k, mode, block_n, offset=None):
    jv, ji = jtk.topk_reward(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(valid), f=f, k=k, block_n=block_n,
                             ucb=None if ucb is None else jnp.asarray(ucb),
                             mode=mode, interpret=True, index_offset=offset)
    T = torch.from_numpy
    tv, ti = tops.topk_reward(T(a), T(b), T(valid), f=f, k=k,
                              block_n=block_n,
                              ucb=None if ucb is None else T(ucb), mode=mode,
                              index_offset=offset or 0)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv).view(np.int32),
                                  tv.numpy().view(np.int32))
    return tv, ti


@pytest.mark.parametrize("mode", ["eafl", "oort", "eafl-epj"])
@pytest.mark.parametrize("with_ucb", [False, True])
@pytest.mark.parametrize("n,k,block_n", [(1000, 8, 256), (4096, 16, 1024)])
def test_modes_ucb_ragged(mode, with_ucb, n, k, block_n):
    a, b, valid, ucb = _inputs(n + k, n, mode=mode)
    _check(a, b, valid, ucb if with_ucb else None, f=0.3, k=k, mode=mode,
           block_n=block_n)


@pytest.mark.parametrize("mode", ["eafl", "oort"])
def test_ties_lowest_index_first(mode):
    a, b, valid, ucb = _inputs(7, 777, ties=True, valid_frac=1.0)
    _, ti = _check(a, b, valid, None, f=0.25, k=12, mode=mode, block_n=128)
    assert len(set(ti.tolist())) == 12


def test_sparse_valid_surfaces_sentinels():
    """Fewer valid clients than k: the rest of the slots are masked
    clients, SENTINEL-valued, lowest index first."""
    a, b, valid, ucb = _inputs(3, 900, valid_frac=0.004)
    assert 0 < valid.sum() < 10
    tv, ti = _check(a, b, valid, ucb, f=0.25, k=10, mode="eafl",
                    block_n=256)
    assert (tv.numpy() == np.float32(tref.SENTINEL)).sum() == \
        10 - valid.sum()


def test_k_equals_n_and_index_offset():
    a, b, valid, ucb = _inputs(11, 40, valid_frac=0.5)
    _check(a, b, valid, ucb, f=0.3, k=40, mode="eafl", block_n=4096)
    _check(a, b, valid, ucb, f=0.3, k=5, mode="eafl", block_n=16,
           offset=1000)


def test_wrapper_dispatch_and_limits():
    a, b, valid, ucb = _inputs(0, 300)
    T = torch.from_numpy
    before = dict(tops.LAUNCHES)
    tops.topk_reward(T(a), T(b), T(valid).bool(), f=0.25, k=4, block_n=64)
    assert tops.LAUNCHES == before      # the CPU path launches no kernel
    with pytest.raises(ValueError):
        tops.topk_reward(T(a), T(b), T(valid), f=0.25, k=65, block_n=64)
    with pytest.raises(ValueError):
        tops.topk_reward(T(a), T(b), T(valid), f=0.25, k=301)
    with pytest.raises(ValueError):
        tref.reward_score(T(a), T(b), T(valid), f=0.25, mode="nope")


def test_plain_version_matches_the_full_score_order():
    """The plain version is a stable descending sort of reward_score."""
    a, b, valid, ucb = _inputs(5, 513)
    T = torch.from_numpy
    s = tref.reward_score(T(a), T(b), T(valid), f=0.3, ucb=T(ucb))
    order = np.argsort(-s.numpy(), kind="stable")[:20]
    _, ti = tref.topk_reward(T(a), T(b), T(valid), f=0.3, k=20, ucb=T(ucb))
    np.testing.assert_array_equal(order, ti.numpy())


def test_reference_ops_wrapper_agrees():
    """The reference's jitted wrapper takes the same path as its module."""
    a, b, valid, ucb = _inputs(2, 512)
    jv, ji = jops.topk_reward(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(valid), f=0.25, k=6, block_n=128,
                              ucb=jnp.asarray(ucb), interpret=True)
    T = torch.from_numpy
    tv, ti = tops.topk_reward(T(a), T(b), T(valid), f=0.25, k=6,
                              ucb=T(ucb))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("mask_dtype", ["bool", "uint8", "int32", "int64"])
def test_wrapper_takes_any_mask_dtype(mask_dtype):
    """The kernel reads a one-byte mask; any other mask means ``!= 0``."""
    a, b, valid, ucb = _inputs(9, 700, valid_frac=0.5)
    T = torch.from_numpy
    mask = T(valid).to(getattr(torch, mask_dtype))
    tv, ti = tops.topk_reward(T(a), T(b), mask, f=0.3, k=9, ucb=T(ucb))
    pv, pi = tref.topk_reward(T(a), T(b), T(valid).bool(), f=0.3, k=9,
                              ucb=T(ucb))
    assert torch.equal(ti, pi)
    assert torch.equal(tv.view(torch.int32), pv.view(torch.int32))


# ------------------------------------------- the total order of ±0 and NaN
def _specials(seed, n):
    """Scores with -0/+0 and -NaN/+NaN mixed among ordinary values."""
    rs = np.random.RandomState(seed)
    nan = np.float32("nan")
    pool = np.array([0.0, -0.0, nan, -nan, np.inf, -np.inf, 1.0, -1.0],
                    np.float32)
    a = rs.rand(n).astype(np.float32) - np.float32(0.5)
    pick = rs.rand(n) < 0.5
    a[pick] = pool[rs.randint(0, len(pool), int(pick.sum()))]
    return a


def test_key_order_is_lax_top_k_order():
    """Unsigned order of the key equals lax.top_k's order of a sorted list
    of specials (listed from the top down)."""
    import jax
    nan = np.float32("nan")
    down = np.array([nan, np.inf, 1.0, 1e-38, 1e-45, 0.0, -0.0, -1e-45,
                     -1.0, -3e38, -np.inf, -nan], np.float32)
    rs = np.random.RandomState(0)
    x = down[rs.permutation(len(down))]
    _, ji = jax.lax.top_k(jnp.asarray(x), len(x))
    key = orderable_key(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.argsort(-key, kind="stable"),
                                  np.asarray(ji))
    np.testing.assert_array_equal(x[np.asarray(ji)].view(np.int32),
                                  down.view(np.int32))


@pytest.mark.parametrize("n,k", [(4, 4), (64, 10), (300, 300)])
def test_signed_zero_and_nan_match_lax_top_k(n, k):
    """The plain top-k of scores with ±0 and ±NaN (``oort`` without ucb
    scores ``a`` itself) against lax.top_k: indices exactly, values
    bitwise."""
    import jax
    a = np.array([0.1, -0.0, 0.5, 0.0], np.float32) if n == 4 else \
        _specials(n + k, n)
    valid = np.ones(n, np.int32)
    jv, ji = jax.lax.top_k(jnp.asarray(a), k)
    T = torch.from_numpy
    tv, ti = tops.topk_reward(T(a), T(a), T(valid), f=0.3, k=k, mode="oort",
                              block_n=max(k, 8))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv).view(np.int32),
                                  tv.numpy().view(np.int32))
    if n == 4:
        np.testing.assert_array_equal(ti.numpy(), [2, 0, 3, 1])


@pytest.mark.parametrize("seed", [0, 1])
def test_signed_zeros_match_reference_kernel(seed):
    """Where k takes in every tied zero, the reference kernel (interpret
    mode) orders them as lax.top_k does, and so does the plain version."""
    a = np.array([0.1, -0.0, 0.5, 0.3, 0.2, 0.9, 0.0, 0.4], np.float32)
    if seed:
        rs = np.random.RandomState(seed)
        a = rs.rand(40).astype(np.float32) - np.float32(0.5)
        a[rs.rand(40) < 0.3] = 0.0
        a[rs.rand(40) < 0.3] = -0.0
    valid = np.ones(len(a), np.int32)
    # every zero and two negatives below them
    k = len(a) if seed == 0 else int((a >= 0).sum()) + 2
    _, ti = _check(a, a, valid, None, f=0.3, k=k, mode="oort",
                   block_n=8 if seed == 0 else 64)
    if seed == 0:
        np.testing.assert_array_equal(ti.numpy(), [5, 2, 7, 3, 4, 0, 6, 1])
