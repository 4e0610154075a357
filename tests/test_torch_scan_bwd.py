"""The scan backward kernels' plain versions and the differentiable
wrappers, on the CPU.

``repro_torch.kernels.ref.ssd_chunk_bwd`` and ``ref.selective_scan_bwd``
(the plain versions of ``csrc/ssd_chunk_bwd.cu`` and
``csrc/selective_scan_bwd.cu``) against torch's autograd of the plain
forwards ``ref.ssd_chunk`` and ``ref.selective_scan``, and against
``jax.vjp`` of the reference's oracles ``ssd_chunk_ref`` and
``selective_scan_ref`` (the reference has no backward kernel: it
differentiates plain jnp); the two passes of the bf16 SSD backward kernel
in their plain form, ``ref.ssd_chunk_bwd_carry`` against a reverse
recurrence over the steps written here and ``ref.ssd_chunk_bwd_local`` on
that carry and the chunk states against ``ref.ssd_chunk_bwd`` and
``jax.vjp``; then ``ops.ssd_chunk`` and
``ops.selective_scan`` under grad, whose CPU path is the
``autograd.Function`` over these plain versions, on strided slices of one
packed projection (as the models give them) and a gradient that arrives
non-contiguous. Inputs come from numpy with a seed.

The selective-scan backward kernel's parts (dB and dC summed over each
cluster's channels, dA and dD per batch element) in their plain form,
``ref.selective_scan_bwd_parts``, summed, against the same; and the
wrapper's buffers and its 16-byte chunk copies on meta and CPU tensors.
Cases: S of 1, 63, 64, 65 and 130 (below, at and past the kernels'
64-step chunks and tiles), ds 8, 16 and 64, hd 64, dt around 0.7 and (S
130) around 0.02, where the state outlives a chunk. Tolerance: 1e-5
relative L2 per output in f32 (measured on the CPU: 4.3e-7 at most
against autograd, 8.8e-7 against jax.vjp; an output that is exactly zero,
dA at S = 1, must be zero)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import selective_scan_ref, ssd_chunk_ref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

REL_L2 = 1e-5
# S, ds, dt shift (softplus of N(shift, 1): about 0.7 at 0, 0.02 at -4)
SSD_CASES = [(1, 16, 0.0), (63, 64, 0.0), (64, 8, 0.0), (65, 16, 0.0),
             (130, 64, -4.0)]
SCAN_CASES = [(1, 8, 0.0), (63, 16, 0.0), (64, 64, 0.0), (65, 8, 0.0),
              (130, 16, -4.0)]
NH, HD, DI = 2, 64, 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _softplus(v):
    return np.log1p(np.exp(v)).astype(np.float32)


def _ssd_inputs(S, ds, shift, seed, B=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, NH, HD).astype(np.float32)
    Bm, Cm = (rs.randn(B, S, ds).astype(np.float32) for _ in range(2))
    dt = _softplus(rs.randn(B, S, NH) + shift)
    A = -np.exp(0.5 * rs.randn(NH)).astype(np.float32)
    dy = rs.randn(B, S, NH, HD).astype(np.float32)
    return (x, Bm, Cm, dt, A), dy


def _scan_inputs(S, ds, shift, seed, B=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, DI).astype(np.float32)
    dt = _softplus(rs.randn(B, S, DI) + shift)
    Bm, Cm = (rs.randn(B, S, ds).astype(np.float32) for _ in range(2))
    A = -np.exp(0.5 * rs.randn(DI, ds)).astype(np.float32)
    D = rs.randn(DI).astype(np.float32)
    dy = rs.randn(B, S, DI).astype(np.float32)
    return (x, dt, Bm, Cm, A, D), dy


def _close(got, exp, what):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape, what
    den = np.linalg.norm(exp)
    err = np.linalg.norm(got - exp)
    if den == 0.0:
        assert err == 0.0, (what, err)
    else:
        assert err <= REL_L2 * den, (what, err / den)


def _autograd(fn, args, dy):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    return torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(dy))


def _vjp(fn, args, dy):
    _, pull = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return jax.jit(pull)(jnp.asarray(dy))


def _ids(case):
    return "S{}-ds{}-shift{}".format(*case)


SSD_NAMES = ("dx", "dBm", "dCm", "ddt", "dA")


@functools.lru_cache(maxsize=None)
def _ssd_case(case):
    """A case's inputs, output gradient and ``jax.vjp`` of the reference's
    ``ssd_chunk_ref`` (computed once for the tests that read it)."""
    args, dy = _ssd_inputs(*case, seed=case[0] + case[1])
    return args, dy, [np.asarray(e) for e in _vjp(ssd_chunk_ref, args, dy)]


@pytest.mark.parametrize("case", SSD_CASES, ids=_ids)
def test_ssd_bwd_matches_autograd_and_reference(case):
    args, dy, vjp = _ssd_case(case)
    got = ref.ssd_chunk_bwd(*map(torch.from_numpy, args),
                            torch.from_numpy(dy))
    for name, g, a in zip(SSD_NAMES, got, args):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
    for name, g, e in zip(SSD_NAMES, got,
                          _autograd(ref.ssd_chunk, args, dy)):
        _close(g.numpy(), e.numpy(), f"{name} vs autograd, {case}")
    for name, g, e in zip(SSD_NAMES, got, vjp):
        _close(g.numpy(), e, f"{name} vs jax.vjp, {case}")


def _steps(args, dy, chunk=64):
    """The SSD step by step in float64: the state entering each chunk
    (``(B, n_chunks, nh, ds, hd)``) and K, each chunk's last state's
    gradient from the steps after the chunk, by the reverse recurrence
    ``after_t = a_{t+1} (C_{t+1} (x) dy_{t+1} + after_{t+1})``."""
    x, Bm, Cm, dt, A = (a.astype(np.float64) for a in args)
    dy = dy.astype(np.float64)
    Bsz, S, nh, hd = x.shape
    a = np.exp(dt * A)                                   # (B, S, nh)
    h = np.zeros((Bsz, nh, Bm.shape[-1], hd))
    states = []
    for t in range(S):
        if t % chunk == 0:
            states.append(h)
        h = (a[:, t, :, None, None] * h + dt[:, t, :, None, None]
             * Bm[:, t, None, :, None] * x[:, t, :, None, :])
    after = np.zeros_like(h)
    carry = [None] * len(states)
    for t in reversed(range(S)):
        if t == S - 1 or t % chunk == chunk - 1:
            carry[t // chunk] = after
        after = a[:, t, :, None, None] * (
            Cm[:, t, None, :, None] * dy[:, t, :, None, :] + after)
    return np.stack(states, 1), np.stack(carry, 1)


@pytest.mark.parametrize("case", SSD_CASES, ids=_ids)
def test_ssd_carry_matches_reverse_recurrence(case):
    """The carry pass's plain version (its recurrence over the chunks)
    against the reverse recurrence over the steps: zero for the last
    chunk, S of 1 a single chunk."""
    args, dy, _ = _ssd_case(case)
    x, Bm, Cm, dt, A = map(torch.from_numpy, args)
    got = ref.ssd_chunk_bwd_carry(Cm, dt, A, torch.from_numpy(dy))
    _, exp = _steps(args, dy)
    assert got.dtype == torch.float32 and got.shape == exp.shape
    assert not got[:, -1].any()
    if got.shape[1] > 1:
        _close(got.numpy(), exp, f"carry, {case}")


@pytest.mark.parametrize("case", SSD_CASES, ids=_ids)
def test_ssd_two_pass_matches_recurrence_and_reference(case):
    """The chunk-local pass's plain version on the plain carry and the
    chunk states: the gradients of ``ref.ssd_chunk_bwd`` and of
    ``jax.vjp`` of the reference."""
    args, dy, vjp = _ssd_case(case)
    targs = list(map(torch.from_numpy, args))
    tdy = torch.from_numpy(dy)
    states, _ = _steps(args, dy)
    carry = ref.ssd_chunk_bwd_carry(targs[2], targs[3], targs[4], tdy)
    got = ref.ssd_chunk_bwd_local(*targs, tdy,
                                  torch.from_numpy(states).float(), carry)
    for name, g, a in zip(SSD_NAMES, got, args):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
    for name, g, e in zip(SSD_NAMES, got, ref.ssd_chunk_bwd(*targs, tdy)):
        _close(g.numpy(), e.numpy(), f"{name} vs the recurrence, {case}")
    for name, g, e in zip(SSD_NAMES, got, vjp):
        _close(g.numpy(), e, f"{name} vs jax.vjp, {case}")


@pytest.mark.parametrize("case", SCAN_CASES, ids=_ids)
def test_scan_bwd_matches_autograd_and_reference(case):
    args, dy = _scan_inputs(*case, seed=case[0] + case[1])
    got = ref.selective_scan_bwd(*map(torch.from_numpy, args),
                                 torch.from_numpy(dy))
    names = ("dx", "ddt", "dBm", "dCm", "dA", "dD")
    for name, g, a in zip(names, got, args):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
    for name, g, e in zip(names, got,
                          _autograd(ref.selective_scan, args, dy)):
        _close(g.numpy(), e.numpy(), f"{name} vs autograd, {case}")
    for name, g, e in zip(names, got, _vjp(selective_scan_ref, args, dy)):
        _close(g.numpy(), np.asarray(e), f"{name} vs jax.vjp, {case}")


# S, ds, part channels (di = DI = 12: parts of 8 and 4 channels, or one),
# dt shift
PART_CASES = [(1, 16, 8, 0.0), (63, 8, 8, 0.0), (65, 16, 5, 0.0),
              (130, 16, 8, -4.0), (130, 8, 12, 0.0)]


@pytest.mark.parametrize("case", PART_CASES,
                         ids=lambda c: "S{}-ds{}-parts{}-shift{}".format(*c))
def test_scan_bwd_parts_sum_to_the_gradient(case):
    """``ref.selective_scan_bwd_parts``, the plain version of what the
    backward kernel writes (dB and dC summed over each run of
    ``part_channels`` channels, dA and dD per batch element), summed over
    the parts in order, against ``ref.selective_scan_bwd`` and ``jax.vjp``
    of the reference's ``selective_scan_ref``; di not a multiple of the
    part's channels where the case says so."""
    S, ds, part, shift = case
    args, dy = _scan_inputs(S, ds, shift, seed=S + ds + part)
    targs = list(map(torch.from_numpy, args))
    got = ref.selective_scan_bwd_parts(*targs, torch.from_numpy(dy), part)
    n_parts = -(-DI // part)
    assert [tuple(g.shape) for g in got] == [
        (2, S, DI), (2, S, DI), (2, n_parts, S, ds), (2, n_parts, S, ds),
        (2, DI, ds), (2, DI)]
    assert all(g.dtype == torch.float32 for g in got)
    sums = (got[0], got[1], got[2].sum(1), got[3].sum(1), got[4].sum(0),
            got[5].sum(0))
    names = ("dx", "ddt", "dBm", "dCm", "dA", "dD")
    exact = ref.selective_scan_bwd(*targs, torch.from_numpy(dy))
    for name, g, e in zip(names, sums, exact):
        _close(g.numpy(), e.numpy(), f"{name} vs the recurrence, {case}")
    for name, g, e in zip(names, sums, _vjp(selective_scan_ref, args, dy)):
        _close(g.numpy(), np.asarray(e), f"{name} vs jax.vjp, {case}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scan_bwd_buffers_and_chunks(dtype):
    """``launch_bwd``'s allocations on meta tensors: dx and ddt views of
    rows padded to whole 16-byte chunks, the f32 parts; ``chunked`` keeps
    an input whose rows start on chunks and copies one that does not (B
    and C after 3 columns of one projection, di of 100), equal values,
    padding zero."""
    from repro_torch.kernels import selective_scan as ss
    per = 16 // torch.empty(0, dtype=dtype).element_size()
    x = torch.empty(2, 7, 100, dtype=dtype, device="meta")
    Bm = torch.empty(2, 7, 16, dtype=dtype, device="meta")
    dx, ddt, dBp, dCp, dAp, dDp = ss.bwd_buffers(x, Bm, 128)
    for t in (dx, ddt):
        assert t.shape == (2, 7, 100) and t.dtype == dtype
        assert t.stride() == (7 * 104 if per == 8 else 7 * 100,
                              104 if per == 8 else 100, 1)
    assert dBp.shape == dCp.shape == (2, 1, 7, 16)
    assert dAp.shape == (2, 100, 16) and dDp.shape == (2, 100)
    assert {t.dtype for t in (dBp, dCp, dAp, dDp)} == {torch.float32}
    assert ss.bwd_buffers(torch.empty(1, 3, 257, device="meta"), Bm,
                          128)[2].shape == (1, 3, 3, 16)
    whole = torch.arange(2 * 7 * 35, dtype=torch.float32).reshape(
        2, 7, 35).to(dtype)
    aligned = torch.zeros(2, 7, 8 * per, dtype=dtype)
    assert ss.chunked(aligned) is aligned
    for t in (whole[..., 3:19], torch.ones(2, 7, 100, dtype=dtype)):
        c = ss.chunked(t)
        assert torch.equal(c, t) and c.data_ptr() % 16 == 0
        assert all(st % per == 0 for st in c.stride()[:-1])
        full = c.as_strided((2, 7, c.stride(1)), c.stride())
        assert not full[..., t.shape[-1]:].any()


def test_bwd_returns_the_inputs_dtypes():
    """bf16 inputs: dx, dBm, dCm (and the scan's ddt) come back in bf16,
    the SSD's ddt and dA and the scan's dA and dD in f32, as the kernels
    return them; the values are the f32 gradient of the same bf16 inputs,
    rounded once."""
    args, dy = _ssd_inputs(65, 16, 0.0, 3)
    bf = [torch.from_numpy(a).bfloat16() for a in args[:3]]
    rest = [torch.from_numpy(a) for a in args[3:]]
    tdy = torch.from_numpy(dy).bfloat16()
    got = ref.ssd_chunk_bwd(*bf, *rest, tdy)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 2
    exp = ref.ssd_chunk_bwd(*(t.float() for t in bf), *rest, tdy.float())
    for g, e in zip(got, exp):
        assert torch.equal(g, e.to(g.dtype))
    args, dy = _scan_inputs(65, 8, 0.0, 4)
    bf = [torch.from_numpy(a).bfloat16() for a in args[:4]]
    rest = [torch.from_numpy(a) for a in args[4:]]
    tdy = torch.from_numpy(dy).bfloat16()
    got = ref.selective_scan_bwd(*bf, *rest, tdy)
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 + [torch.float32] * 2
    exp = ref.selective_scan_bwd(*(t.float() for t in bf), *rest,
                                 tdy.float())
    for g, e in zip(got, exp):
        assert torch.equal(g, e.to(g.dtype))


def _grads(fn, split, whole, rest, dy):
    """Autograd's gradient of ``fn`` with respect to ``whole`` (a packed
    projection that ``split`` cuts into strided views, as the models'
    split of one projection does) and ``rest``, on fresh leaves."""
    leaves = [t.clone().requires_grad_(True) for t in (whole, *rest)]
    views = split(leaves[0])
    assert not any(v.is_contiguous() for v in views)
    y = fn(*views, *leaves[1:])
    return y, torch.autograd.grad(y, leaves, dy)


@pytest.mark.parametrize("S", [63, 130])
def test_ssd_wrapper_under_grad(S):
    """``ops.ssd_chunk`` under grad on the CPU is the autograd.Function
    (its backward the plain ``ssd_chunk_bwd``) and gives autograd's
    gradient of the plain forward, for x, B and C strided views of one
    projection and a non-contiguous output gradient."""
    rs = np.random.RandomState(S)
    whole = torch.from_numpy(rs.randn(2, S, NH * HD + 32).astype(np.float32))
    dt = torch.from_numpy(_softplus(rs.randn(2, S, NH)))
    A = torch.from_numpy(-np.exp(rs.randn(NH)).astype(np.float32))
    dy = torch.from_numpy(rs.randn(2, S, HD, NH).astype(np.float32))
    dy = dy.transpose(2, 3)                       # non-contiguous

    def split(w):
        xs, Bm, Cm = torch.split(w, [NH * HD, 16, 16], dim=-1)
        return xs.reshape(2, S, NH, HD), Bm, Cm

    before = dict(ops.LAUNCHES)
    y, got = _grads(ops.ssd_chunk, split, whole, (dt, A), dy)
    assert type(y.grad_fn).__name__ == "_SSDChunkBackward"
    assert ops.LAUNCHES == before                 # the CPU launches nothing
    _, exp = _grads(ref.ssd_chunk, split, whole, (dt, A), dy)
    for i, (g, e) in enumerate(zip(got, exp)):
        _close(g.numpy(), e.numpy(), f"ssd leaf {i}, S={S}")
    with torch.no_grad():                        # no grad: the plain forward
        assert torch.equal(ops.ssd_chunk(*split(whole), dt, A), y.detach())


@pytest.mark.parametrize("S", [63, 130])
def test_scan_wrapper_under_grad(S):
    """``ops.selective_scan`` under grad on the CPU, as the SSD's above,
    with B and C strided views of one projection."""
    rs = np.random.RandomState(S + 1)
    whole = torch.from_numpy(rs.randn(2, S, 20).astype(np.float32))
    x = torch.from_numpy(rs.randn(2, S, DI).astype(np.float32))
    dt = torch.from_numpy(_softplus(rs.randn(2, S, DI)))
    A = torch.from_numpy(-np.exp(rs.randn(DI, 8)).astype(np.float32))
    D = torch.from_numpy(rs.randn(DI).astype(np.float32))
    dy = torch.from_numpy(rs.randn(2, DI, S).astype(np.float32))
    dy = dy.transpose(1, 2)                       # non-contiguous

    def split(w):
        return torch.split(w, [4, 8, 8], dim=-1)[1:]

    def scan(fn):
        return lambda Bm, Cm, x, dt, A, D: fn(x, dt, Bm, Cm, A, D)

    before = dict(ops.LAUNCHES)
    y, got = _grads(scan(ops.selective_scan), split, whole, (x, dt, A, D),
                    dy)
    assert type(y.grad_fn).__name__ == "_SelectiveScanBackward"
    assert ops.LAUNCHES == before
    _, exp = _grads(scan(ref.selective_scan), split, whole, (x, dt, A, D),
                    dy)
    for i, (g, e) in enumerate(zip(got, exp)):
        _close(g.numpy(), e.numpy(), f"scan leaf {i}, S={S}")
