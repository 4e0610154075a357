"""The kernels' fake routes (``kernels/counting.py``): on ``FakeTensor``
inputs each ``ops`` wrapper returns fake outputs of its kernel's shapes
and dtypes and reports the dot FLOPs that ``FlopCounterMode`` counts over
its plain version (``kernels/ref.py``) at the same shapes; it builds and
launches nothing, whatever the fake device. Real CPU tensors still take
the plain version, real CUDA tensors the kernel."""
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.kernels import counting, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402

DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture
def no_build(monkeypatch):
    """Building or loading a library fails the test; the launch counts
    must not move."""
    def refuse(name):
        raise AssertionError(f"the fake route built or loaded {name}")
    monkeypatch.setattr(ops, "build_library", refuse)
    monkeypatch.setattr(ops, "load_library", refuse)
    before = (dict(ops.LAUNCHES), dict(ops.CAPTURED))
    yield
    assert (dict(ops.LAUNCHES), dict(ops.CAPTURED)) == before


def plain_count(fn, *args, **kw):
    """``fn``'s outputs on real CPU tensors and FlopCounterMode's count."""
    with FlopCounterMode(display=False) as mode:
        out = fn(*args, **kw)
    return out, mode.get_total_flops()


def fake_count(fn, *args, **kw):
    """``fn`` on fake copies of ``args`` (same shapes, dtypes, strides):
    its outputs and what :class:`counting.DotFlops` counted."""
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
        with counting.DotFlops() as flops:
            out = fn(*fargs, **kw)
    return out, flops


def same_meta(fake_out, real_out):
    fake_out = fake_out if isinstance(fake_out, tuple) else (fake_out,)
    real_out = real_out if isinstance(real_out, tuple) else (real_out,)
    assert len(fake_out) == len(real_out)
    for f, r in zip(fake_out, real_out):
        assert counting.is_fake(f)
        assert (tuple(f.shape), f.dtype) == (tuple(r.shape), r.dtype)


def attn_inputs(B, S, H, KH, dqk, dv, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(B, S, h, dqk, generator=g).to(dtype)
            for h in (H, KH))
    v = torch.randn(B, S, KH, dv, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("heads", [(4, 2), (2, 2)], ids=["gqa", "mha"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("pair", fa.HEAD_DIMS, ids=str)
def test_attention_fake_routes(pair, dtype, causal, heads, no_build):
    """Forward, forward with the log-sum-exp, backward: shapes, dtypes and
    counts of the plain versions, at every built width pair, ragged S."""
    (dqk, dv), (H, KH), B, S = pair, heads, 2, 33
    q, k, v = attn_inputs(B, S, H, KH, dqk, dv, dtype)
    exp, n = plain_count(ref.flash_attention, q, k, v, causal=causal)
    got, flops = fake_count(ops.flash_attention, q, k, v, causal=causal)
    same_meta(got, exp)
    assert flops.by_op == {"flash_attention": n}
    assert n == counting.attention_flops(B, S, H, dqk, dv)

    exp, n = plain_count(ref.flash_attention_fwd_lse, q, k, v,
                         causal=causal)
    got, flops = fake_count(fa.fake, q, k, v, causal=causal, with_lse=True)
    same_meta(got, exp)
    assert flops.total == n

    o, lse = exp
    do = torch.randn_like(o)
    exp, n = plain_count(ref.flash_attention_bwd, q, k, v, o, lse, do,
                         causal=causal)
    got, flops = fake_count(ops.flash_attention_bwd, q, k, v, o, lse, do,
                            causal=causal)
    same_meta(got, exp)
    assert flops.by_op == {"flash_attention_bwd": n}
    assert n == counting.attention_bwd_flops(B, S, H, dqk, dv)


def test_attention_fake_route_refuses_an_unbuilt_pair():
    q, k, v = attn_inputs(1, 8, 2, 2, 80, 80, torch.float32)
    with pytest.raises(ValueError, match="not built"):
        fake_count(ops.flash_attention, q, k, v)


def ssd_inputs(B, S, nh, hd, ds, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, nh, hd, generator=g).to(dtype)
    Bm, Cm = (torch.randn(B, S, ds, generator=g).to(dtype) for _ in "BC")
    dt = torch.rand(B, S, nh, generator=g) * 0.1
    A = -torch.rand(nh, generator=g)
    return x, Bm, Cm, dt, A


@pytest.mark.parametrize("S", [1, 63, 65, 130])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_ssd_fake_routes(dtype, S, no_build):
    B, nh, hd, ds = 2, 3, 64, 16
    args = ssd_inputs(B, S, nh, hd, ds, dtype)
    exp, n = plain_count(ref.ssd_chunk, *args)
    got, flops = fake_count(ops.ssd_chunk, *args)
    same_meta(got, exp)
    assert flops.by_op == {"ssd_chunk": n}
    assert n == counting.ssd_flops(B, S, nh, hd, ds)
    # under grad the forward also writes the f32 state entering each chunk
    got, _ = fake_count(sc.fake, *args, with_states=True)
    assert [tuple(t.shape) for t in got] == [
        (B, S, nh, hd), (B, -(-S // sc.CHUNK), nh, ds, hd)]
    assert got[1].dtype == torch.float32

    dy = torch.randn_like(args[0])
    exp, n = plain_count(ref.ssd_chunk_bwd, *args, dy)
    got, flops = fake_count(ops.ssd_chunk_bwd, *args, dy)
    same_meta(got, exp)
    assert flops.by_op == {"ssd_chunk_bwd": n}
    assert n == counting.ssd_bwd_flops(B, S, nh, hd, ds)


def scan_inputs(B, S, di, ds, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, di, generator=g).to(dtype)
    dt = (torch.rand(B, S, di, generator=g) * 0.1).to(dtype)
    Bm, Cm = (torch.randn(B, S, ds, generator=g).to(dtype) for _ in "BC")
    A = -torch.rand(di, ds, generator=g)
    D = torch.randn(di, generator=g)
    return x, dt, Bm, Cm, A, D


@pytest.mark.parametrize("S", [1, 63, 65, 130])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_scan_fake_routes(dtype, S, no_build):
    B, di, ds = 2, 200, 16
    args = scan_inputs(B, S, di, ds, dtype)
    exp, n = plain_count(ref.selective_scan, *args)
    got, flops = fake_count(ops.selective_scan, *args)
    same_meta(got, exp)
    assert flops.by_op == {"selective_scan": n}
    assert n == counting.scan_flops(B, S, di, ds)
    got, _ = fake_count(ss.fake, *args, with_states=True)
    assert [tuple(t.shape) for t in got] == [
        (B, S, di), (B, -(-S // ss.TILE), di, ds)]

    dy = torch.randn_like(args[0])
    exp, n = plain_count(ref.selective_scan_bwd, *args, dy)
    got, flops = fake_count(ops.selective_scan_bwd, *args, dy)
    same_meta(got, exp)
    assert flops.by_op == {"selective_scan_bwd": n}
    assert n == counting.scan_bwd_flops(B, S, di, ds)


def test_topk_fake_route(no_build):
    g = torch.Generator().manual_seed(0)
    a, b = torch.rand(5000, generator=g), torch.rand(5000, generator=g)
    valid = torch.rand(5000, generator=g) < 0.8
    exp, n = plain_count(ref.topk_reward, a, b, valid, f=0.25, k=100)
    got, flops = fake_count(ops.topk_reward, a, b, valid, f=0.25, k=100)
    same_meta(got, exp)
    assert n == 0 and flops.by_op == {"topk_reward": 0}


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_chunk",
                                    "selective_scan"])
def test_fake_routes_under_grad(kernel, no_build):
    """Under grad the autograd.Function's forward and backward both take
    the fake route: each reports its formula once."""
    if kernel == "flash_attention":
        args, fn = attn_inputs(2, 40, 4, 2, 64, 64, torch.bfloat16), \
            ops.flash_attention
        fwd = counting.attention_flops(2, 40, 4, 64, 64)
        bwd = counting.attention_bwd_flops(2, 40, 4, 64, 64)
    elif kernel == "ssd_chunk":
        args, fn = ssd_inputs(2, 70, 2, 64, 16, torch.bfloat16), \
            ops.ssd_chunk
        fwd = counting.ssd_flops(2, 70, 2, 64, 16)
        bwd = counting.ssd_bwd_flops(2, 70, 2, 64, 16)
    else:
        args, fn = scan_inputs(2, 70, 96, 16, torch.bfloat16), \
            ops.selective_scan
        fwd = counting.scan_flops(2, 70, 96, 16)
        bwd = counting.scan_bwd_flops(2, 70, 96, 16)
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a).requires_grad_(True) for a in args]
        with counting.DotFlops() as flops:
            out = fn(*fargs)
            grads = torch.autograd.grad(out, fargs, torch.ones_like(out))
    assert all(counting.is_fake(g) and g.shape == a.shape
               for g, a in zip(grads, fargs))
    assert flops.kernels == {kernel: fwd, f"{kernel}_bwd": bwd}


def test_fake_cuda_inputs_take_the_fake_route(no_build):
    """Inputs made on the CUDA device under FakeTensorMode: every wrapper
    returns fake CUDA outputs here, where no CUDA build exists, and builds
    and launches nothing."""
    def e(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="cuda")

    f32 = torch.float32
    with FakeTensorMode(), counting.DotFlops() as flops:
        q, k, v = e(2, 64, 4, 64), e(2, 64, 2, 64), e(2, 64, 2, 64)
        outs = [ops.flash_attention(q, k, v),
                *ops.flash_attention_bwd(q, k, v, e(2, 64, 4, 64),
                                         e(2, 4, 64, dtype=f32),
                                         e(2, 64, 4, 64))]
        x, bm, cm = e(2, 64, 4, 64), e(2, 64, 16), e(2, 64, 16)
        dt, a = e(2, 64, 4, dtype=f32), e(4, dtype=f32)
        outs += [ops.ssd_chunk(x, bm, cm, dt, a),
                 *ops.ssd_chunk_bwd(x, bm, cm, dt, a, e(2, 64, 4, 64))]
        x, bm, cm = e(2, 64, 96), e(2, 64, 16), e(2, 64, 16)
        sargs = (x, e(2, 64, 96), bm, cm, e(96, 16, dtype=f32),
                 e(96, dtype=f32))
        outs += [ops.selective_scan(*sargs),
                 *ops.selective_scan_bwd(*sargs, e(2, 64, 96))]
        outs += ops.topk_reward(e(1000, dtype=f32), e(1000, dtype=f32),
                                e(1000, dtype=torch.bool), f=0.5, k=10)
    assert all(counting.is_fake(t) and t.device.type == "cuda"
               for t in outs)
    assert flops.kernels == {
        "flash_attention": counting.attention_flops(2, 64, 4, 64, 64),
        "flash_attention_bwd": counting.attention_bwd_flops(2, 64, 4, 64,
                                                            64),
        "ssd_chunk": counting.ssd_flops(2, 64, 4, 64, 16),
        "ssd_chunk_bwd": counting.ssd_bwd_flops(2, 64, 4, 64, 16),
        "selective_scan": counting.scan_flops(2, 64, 96, 16),
        "selective_scan_bwd": counting.scan_bwd_flops(2, 64, 96, 16),
        "topk_reward": 0}


def test_real_cpu_tensors_take_the_plain_version(no_build):
    """A real tensor never takes the fake route: on the CPU the wrapper
    returns the plain version's numbers, and nothing is reported."""
    q, k, v = attn_inputs(1, 20, 2, 2, 64, 64, torch.float32)
    with counting.DotFlops() as flops:
        got = ops.flash_attention(q, k, v)
    assert not counting.is_fake(got)
    assert torch.equal(got, ref.flash_attention(q, k, v))
    assert flops.kernels == {}
    assert flops.by_op == {"aten.bmm": counting.attention_flops(1, 20, 2,
                                                                64, 64)}


def test_report_reaches_every_open_counter_and_no_other():
    counting.report("flash_attention", 5)      # no counter open: dropped
    with counting.DotFlops() as outer:
        counting.report("ssd_chunk", 3)
        with counting.DotFlops() as inner:
            counting.report("ssd_chunk", 4)
    counting.report("ssd_chunk", 7)
    assert outer.kernels == {"ssd_chunk": 7} and inner.kernels == {
        "ssd_chunk": 4}
    assert outer.total == 7


@pytest.mark.gpu
def test_real_cuda_tensors_launch_the_kernel():
    """On the card a real CUDA tensor still takes the kernel: the launch
    count moves, and the output is not fake."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (t.cuda() for t in attn_inputs(1, 64, 2, 2, 64, 64,
                                             torch.bfloat16))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert not counting.is_fake(out)
