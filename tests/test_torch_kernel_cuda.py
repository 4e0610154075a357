"""The Hopper kernels (``topk_reward``, and ``flash_attention``,
``ssd_chunk`` and ``selective_scan`` with their backward kernels) against
their plain versions, on the card. Skips with
a reason where no CUDA device is present (the kernels have no CPU or
interpret mode); ``python3 chip_smoke.py`` runs the full matrix.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernel_cuda.py

(``--noconftest`` where JAX is not installed: tests/conftest.py imports
it.)
"""
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.kernels import ops, ref  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(4096, 1), (100_003, 100), (9000, 4096)])
@pytest.mark.parametrize("mode", ["eafl", "oort", "eafl-epj"])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8, torch.int32])
def test_kernel_equals_plain_version(n, k, mode, mask_dtype):
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(n + k)
    a, b, u = (torch.rand(n, generator=g).to(dev) for _ in range(3))
    valid = (torch.rand(n, generator=g) < 0.7).to(mask_dtype).to(dev)
    kw = dict(f=0.3, k=k, mode=mode, ucb=u, index_offset=7)
    before = ops.LAUNCHES["topk_reward"]
    kv, ki = ops.topk_reward(a, b, valid, **kw)
    pv, pi = ref.topk_reward(a, b, valid, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topk_reward"] == before + 1
    assert torch.equal(ki, pi)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
    dev = _card()
    a = torch.rand(100, device=dev)
    valid = torch.ones(100, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ops.topk_reward(a, a, valid, f=0.25, k=101)
    with pytest.raises(TypeError):
        ops.topk_reward(a.double(), a, valid, f=0.25, k=5)


def _topk_same(a, b, valid, **kw):
    """One kernel launch against the plain version: indices exactly, values
    bitwise (the plain version takes no block_n)."""
    before = ops.LAUNCHES["topk_reward"]
    kv, ki = ops.topk_reward(a, b, valid, block_n=8192, **kw)
    pv, pi = ref.topk_reward(a, b, valid, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topk_reward"] == before + 1
    assert torch.equal(ki, pi)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    return kv, ki


def _specials(n, seed):
    """Half the scores from ±0, ±NaN and ±inf among values of both signs."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    nan = float("nan")
    pool = torch.tensor([0.0, -0.0, nan, -nan, float("inf"), -float("inf")])
    a = torch.rand(n, generator=g) - 0.5
    pick = torch.rand(n, generator=g) < 0.5
    a[pick] = pool[torch.randint(0, len(pool), (int(pick.sum()),),
                                 generator=g)]
    return a


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [
    (n, k) for n in (8191, 8193, 10_000, 4 * 2**20) for k in (1, 100, 8192)
    if k <= n])
def test_topk_tiles_and_merge_levels(n, k):
    """N on both sides of one and two 8192-client tiles (one launch below
    16384), and 4M clients: two merge levels at k = 100, twelve at 8192."""
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(n + k)
    a, b, u = (torch.rand(n, generator=g).to(dev) for _ in range(3))
    valid = (torch.rand(n, generator=g) < 0.8).to(dev)
    _topk_same(a, b, valid, f=0.3, k=k, ucb=u)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(4, 4), (9000, 4500), (20_000, 300),
                                  (1_048_576, 100)])
def test_topk_signed_zero_and_nan_order(n, k):
    """``oort`` without ucb scores ``a`` itself: +NaN first, +0 above -0,
    -NaN last, ties lowest index first, as lax.top_k."""
    dev = _card()
    a = (torch.tensor([0.1, -0.0, 0.5, 0.0]) if n == 4 else
         _specials(n, n)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    _, ki = _topk_same(a, a, valid, f=0.3, k=k, mode="oort")
    if n == 4:
        assert ki.tolist() == [2, 0, 3, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(5000, 100), (50_000, 1000)])
def test_topk_all_sentinel(n, k):
    """No valid client: the first k indices, every value SENTINEL."""
    dev = _card()
    a = torch.rand(n, device=dev)
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    kv, ki = _topk_same(a, a, valid, f=0.3, k=k, ucb=a)
    assert ki.tolist() == list(range(k))
    assert bool((kv == ref.SENTINEL).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [5000, 1_048_576])
def test_topk_index_offset(n):
    """The offset shifts the final list only, on one tile and after a
    merge."""
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(n)
    a, b = (torch.rand(n, generator=g).to(dev) for _ in range(2))
    valid = torch.ones(n, dtype=torch.uint8, device=dev)
    _, ki = _topk_same(a, b, valid, f=0.3, k=100, index_offset=1000)
    _, k0 = ops.topk_reward(a, b, valid, f=0.3, k=100)
    assert torch.equal(ki, k0 + 1000)


# ------------------------------------------------------------ attention
# tolerances of the JAX package's own kernel tests (tests/test_kernels.py):
# the kernel keeps the softmax weights in f32, the plain version casts them
# to the input dtype before the product with v, as the reference does
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 (the tensor-core kernel) also against the f32 attention of the same
# bf16 inputs, by relative L2 distance (chip_smoke.py's ATTN_BF16_REL_L2)
ATTN_BF16_REL_L2 = 3e-3
SSD_TOL = {torch.float32: 5e-4, torch.bfloat16: 1e-1}


def _attn_inputs(B, S, H, KH, D, dtype, dev, seed, layout="dense"):
    """``packed``: q, k, v as strided views of one projection, as a model
    may hold them; ``unaligned``: rows that start 4 elements into a wider
    buffer, so they are not 16-byte aligned."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if layout == "packed":
        qkv = torch.randn(B, S, (H + 2 * KH) * D, generator=g)
        qkv = qkv.to(dtype).to(dev)
        q = qkv[..., :H * D].view(B, S, H, D)
        k = qkv[..., H * D:(H + KH) * D].view(B, S, KH, D)
        v = qkv[..., (H + KH) * D:].view(B, S, KH, D)
        return q, k, v
    pad = 4 if layout == "unaligned" else 0
    return [torch.randn(B, S, h, D + pad, generator=g).to(dtype).to(dev)
            [..., pad:] for h in (H, KH, KH)]


ATTN_CASES = [(1, 32, 32, 32, 64, "dense"), (2, 256, 8, 2, 64, "dense"),
              (1, 1000, 4, 4, 128, "dense"), (2, 300, 4, 4, 64, "packed")]
UNALIGNED = [(2, 200, 4, 2, 64, "unaligned"), (1, 100, 2, 2, 128, "unaligned")]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KH,D,layout,dtype", [
    c + (dt,) for c in ATTN_CASES for dt in (torch.float32, torch.bfloat16)]
    + [c + (torch.float32,) for c in UNALIGNED])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_equals_plain(B, S, H, KH, D, layout, dtype,
                                             causal):
    """bf16 inputs run on the tensor cores, f32 (any row alignment) on
    scalar FMAs."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _attn_inputs(B, S, H, KH, D, dtype, dev, S + H, layout)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal)
    exp = ref.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == (B, S, H, D)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        exact = ref.flash_attention(q.float(), k.float(), v.float(),
                                    causal=causal)
        assert float((out.float() - exact).norm() / exact.norm()) \
            <= ATTN_BF16_REL_L2


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KH,D,layout", [
    (1, 32, 32, 32, 64, "dense"), (2, 100, 8, 2, 128, "dense"),
    (1, 385, 4, 2, 64, "dense"), (1, 4096, 8, 2, 64, "dense"),
    (1, 4096, 4, 1, 128, "dense"),
    (2, 100, 16, 4, 64, "packed"), (1, 32, 8, 2, 128, "packed"),
    (1, 4096, 8, 2, 128, "packed")])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_attention_shapes(B, S, H, KH, D, layout, causal):
    """The TMA + wgmma kernel: head sizes 64 and 128, S below one 128-row
    tile, ragged (385: the diagonal of a 192-row query tile crosses two
    128-key tiles) and at the prefill's length, GQA (H = 4 KH) and q, k, v
    as strided views of one projection."""
    dev = _card()
    q, k, v = _attn_inputs(B, S, H, KH, D, torch.bfloat16, dev, S + D,
                           layout)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal)
    exp = ref.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert out.shape == (B, S, H, D) and out.is_contiguous()
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
    exact = ref.flash_attention(q.float(), k.float(), v.float(),
                                causal=causal)
    assert float((out.float() - exact).norm() / exact.norm()) \
        <= ATTN_BF16_REL_L2


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KH,D,layout", UNALIGNED)
def test_flash_attention_rejects_unaligned_bf16(B, S, H, KH, D, layout):
    dev = _card()
    q, k, v = _attn_inputs(B, S, H, KH, D, torch.bfloat16, dev, 0, layout)
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == before


# ------------------------------------------------------------------ SSD
def _ssd_inputs(B, S, nh, hd, ds, dtype, dev, seed, shift=0.0, skip=0):
    """Bm and Cm are slices of one packed tensor, as in the model, after
    ``skip`` other columns (3: rows not 16-byte aligned). dt is
    softplus(N(shift, 1)): about 0.02 at shift -4 (slow decay)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, S, nh, hd, generator=g).to(dtype).to(dev)
    bc = torch.randn(B, S, skip + 2 * ds, generator=g).to(dtype).to(dev)
    dt = F.softplus(torch.randn(B, S, nh, generator=g) + shift).to(dev)
    A = -torch.exp(torch.randn(nh, generator=g)).to(dev)
    return x, bc[..., skip:skip + ds], bc[..., skip + ds:], dt, A


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,nh,hd,ds", [
    (1, 64, 4, 64, 16), (2, 200, 8, 64, 64), (1, 128, 2, 64, 128),
    (2, 32, 64, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_equals_plain(B, S, nh, hd, ds, dtype):
    dev = _card()
    x, Bm, Cm, dt, A = _ssd_inputs(B, S, nh, hd, ds, dtype, dev, S + nh)
    before = ops.LAUNCHES["ssd_chunk"]
    out = ops.ssd_chunk(x, Bm, Cm, dt, A)
    exp = ref.ssd_chunk(x, Bm, Cm, dt, A)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_chunk"] == before + 1
    assert out.dtype == dtype and out.shape == (B, S, nh, hd)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)


# the bf16 kernel against the f32 scan of its own inputs: chip_smoke.py's
# limit (sound readings about 1.66e-3; an att low part dropped 2.33e-3),
# and its own limit for slow decay, where a dropped low part of h or of
# w x reads 2.051e-3
SSD_BF16_REL_L2 = 2.2e-3
SSD_BF16_REL_L2_SLOW = 1.85e-3


def _ssd_held(args, dtype, limit=SSD_BF16_REL_L2):
    """One launch of the kernel against the plain version (and, bf16, by
    the tight check)."""
    B, S, nh, hd = args[0].shape
    before = ops.LAUNCHES["ssd_chunk"]
    out = ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_chunk"] == before + 1
    assert out.dtype == dtype and out.shape == (B, S, nh, hd)
    assert out.is_contiguous()
    exp = ref.ssd_chunk(*args)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        x, Bm, Cm, dt, A = args
        exact = ref.ssd_chunk(x.float(), Bm.float(), Cm.float(), dt, A)
        assert float((out.float() - exact).norm() / exact.norm()) <= limit


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 63, 65, 4095])
@pytest.mark.parametrize("ds", [16, 64, 128])
def test_ssd_tensor_core_kernel_edges(S, ds):
    """The bf16 tensor-core kernel (hd in two column slices, one CTA each):
    S of one step, one step short of and past a 64-step chunk, and a
    ragged last chunk after 63 whole ones; each state size; B and C
    strided slices of one packed tensor."""
    dev = _card()
    args = _ssd_inputs(2, S, 4, 64, ds, torch.bfloat16, dev, S + ds)
    _ssd_held(args, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_slow_decay(dtype):
    """dt about 0.02: the state outlives many chunks, so the carried state
    and its split halves decide the output."""
    dev = _card()
    args = _ssd_inputs(2, 1000, 8, 64, 64, dtype, dev, 7, shift=-4.0)
    _ssd_held(args, dtype, SSD_BF16_REL_L2_SLOW)


@pytest.mark.gpu
def test_ssd_kernel_unaligned_rows():
    """B and C after 3 other columns: rows not 16-byte aligned take the
    plain loads in place of cp.async, with the same result."""
    dev = _card()
    args = _ssd_inputs(2, 200, 4, 64, 64, torch.bfloat16, dev, 3, skip=3)
    assert args[1].data_ptr() % 16 != 0
    _ssd_held(args, torch.bfloat16)


@pytest.mark.gpu
def test_new_kernels_reject_what_they_do_not_take():
    dev = _card()
    q = torch.randn(1, 16, 2, 32, device=dev)
    with pytest.raises(ValueError, match="head size"):
        ops.flash_attention(q, q, q)
    q = torch.randn(1, 16, 2, 64, device=dev)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.bfloat16(), q)
    x, Bm, Cm, dt, A = _ssd_inputs(1, 16, 2, 64, 16, torch.float32, dev, 0)
    with pytest.raises(TypeError):
        ops.ssd_chunk(x, Bm.bfloat16(), Cm, dt, A)
    with pytest.raises(ValueError, match="not built"):
        ops.ssd_chunk(x[..., :32], Bm, Cm, dt, A)


# ------------------------------------------------------- selective scan
# the JAX package's tolerances (tests/test_kernels.py); bf16 also against
# the f32 scan of the same bf16 inputs by relative L2 distance, 3e-3: above
# chip_smoke.py's SCAN_BF16_REL_L2 (2.2e-3), since one rounding's relative
# L2 varies more over outputs as small as 64 values
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SCAN_BF16_REL_L2 = 3e-3


def _scan_inputs(B, S, di, ds, dtype, dev, seed):
    """B and C are slices of one packed tensor (after 3 other columns), as
    in the model."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, S, di, generator=g).to(dtype).to(dev)
    dt = F.softplus(torch.randn(B, S, di, generator=g)).to(dtype).to(dev)
    packed = torch.randn(B, S, 3 + 2 * ds, generator=g).to(dtype).to(dev)
    A = -torch.exp(torch.randn(di, ds, generator=g)).to(dev)
    D = torch.randn(di, generator=g).to(dev)
    return x, dt, packed[..., 3:3 + ds], packed[..., 3 + ds:], A, D


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,di,ds", [
    (1, 1, 64, 16), (2, 7, 96, 16), (1, 64, 512, 8), (2, 100, 200, 16),
    (4, 32, 1024, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_equals_plain(B, S, di, ds, dtype):
    """Ragged S (not a multiple of the 32-step tile) and di (not a multiple
    of the CTA's 64 channels), S = 1, strided B and C."""
    dev = _card()
    args = _scan_inputs(B, S, di, ds, dtype, dev, S + di)
    before = ops.LAUNCHES["selective_scan"]
    out = ops.selective_scan(*args)
    exp = ref.selective_scan(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["selective_scan"] == before + 1
    assert out.dtype == dtype and out.shape == (B, S, di)
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        exact = ref.selective_scan(*(t.float() for t in args))
        assert float((out.float() - exact).norm() / exact.norm()) \
            <= SCAN_BF16_REL_L2


@pytest.mark.gpu
@pytest.mark.parametrize("di", [96, 8192])
@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("S,shift", [(1, 0.0), (7, 0.0), (300, -4.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_edges(di, ds, S, shift, dtype):
    """di of one and a half CTAs and the model's 8192, ds 8 and 16, S = 1
    and 7 (one partial tile; the y reduction runs over groups of 4 steps),
    and slow decay (dt about 0.02, softplus of N(-4, 1)), where the cheap
    decay of the bf16 route and the f32 route's expf are held over many
    steps."""
    dev = _card()
    x, dt, Bm, Cm, A, D = _scan_inputs(2, S, di, ds, dtype, dev, S + di)
    if shift:
        g = torch.Generator(device="cpu").manual_seed(S)
        dt = F.softplus(torch.randn(2, S, di, generator=g) + shift) \
            .to(dtype).to(dev)
    args = (x, dt, Bm, Cm, A, D)
    before = ops.LAUNCHES["selective_scan"]
    out = ops.selective_scan(*args)
    exp = ref.selective_scan(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["selective_scan"] == before + 1
    assert out.dtype == dtype and out.shape == (2, S, di)
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        exact = ref.selective_scan(*(t.float() for t in args))
        assert float((out.float() - exact).norm() / exact.norm()) \
            <= SCAN_BF16_REL_L2


@pytest.mark.gpu
def test_selective_scan_rejects_what_it_does_not_take():
    dev = _card()
    x, dt, Bm, Cm, A, D = _scan_inputs(1, 16, 64, 16, torch.float32, dev, 0)
    before = ops.LAUNCHES["selective_scan"]
    with pytest.raises(TypeError):
        ops.selective_scan(x, dt.bfloat16(), Bm, Cm, A, D)
    with pytest.raises(ValueError, match="not built"):
        ops.selective_scan(x, dt, Bm[..., :4], Cm[..., :4], A[:, :4], D)
    with pytest.raises(ValueError, match="contiguous"):
        ops.selective_scan(x.transpose(1, 2).contiguous().transpose(1, 2),
                           dt, Bm, Cm, A, D)
    with pytest.raises(ValueError, match="A must be"):
        ops.selective_scan(x, dt, Bm, Cm, A[:32], D)
    assert ops.LAUNCHES["selective_scan"] == before


# ------------------------------------------- the CPU-side checks and build
@pytest.mark.parametrize("dtype,pad,raises", [
    (torch.bfloat16, 0, False), (torch.bfloat16, 4, True),
    (torch.float32, 4, False)])
def test_flash_attention_input_check_of_row_alignment(dtype, pad, raises):
    """The tensor-core kernel copies bf16 tiles by TMA, which needs 16-byte
    aligned rows, so the wrapper rejects bf16 rows that are not; f32 rows
    (the scalar kernel) may start anywhere."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros(2, 8, 4, 64 + pad, dtype=dtype)[..., pad:]
    if raises:
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.check_inputs(q, q, q)
    else:
        fa.check_inputs(q, q, q)


def test_each_library_builds_with_its_own_flags(monkeypatch):
    """Only the top-k library keeps -fmad=false (its bitwise FMA); each
    library's cached build follows its own source and flags alone."""
    assert "-fmad=false" in ops.nvcc_flags("topk_select")
    for name in ("flash_attention", "flash_attention_bwd", "ssd_chunk",
                 "ssd_chunk_bwd", "selective_scan", "selective_scan_bwd"):
        assert "-fmad=false" not in ops.nvcc_flags(name)
        assert "arch=compute_90a,code=sm_90a" in ops.nvcc_flags(name)
    before = {n: ops.library_path(n) for n in ops.EXTRA_FLAGS}
    assert len(set(before.values())) == len(before)
    monkeypatch.setitem(ops.EXTRA_FLAGS, "ssd_chunk", ("-lineinfo",))
    after = {n: ops.library_path(n) for n in ops.EXTRA_FLAGS}
    assert after["ssd_chunk"] != before["ssd_chunk"]
    assert after["topk_select"] == before["topk_select"]
    assert after["flash_attention"] == before["flash_attention"]
    assert after["selective_scan"] == before["selective_scan"]
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"]
    assert after["ssd_chunk_bwd"] == before["ssd_chunk_bwd"]
    assert after["selective_scan_bwd"] == before["selective_scan_bwd"]
    assert set(ops.LAUNCHES) == {"topk_reward", "flash_attention",
                                 "flash_attention_bwd", "ssd_chunk",
                                 "ssd_chunk_bwd", "selective_scan",
                                 "selective_scan_bwd"}


# --------------------------------------------------- attention backward
@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KH,D", [
    (1, 32, 4, 4, 64), (2, 100, 8, 2, 128), (1, 385, 4, 2, 64),
    (1, 1024, 16, 16, 128), (1, 32, 12, 4, 128), (2, 1000, 8, 2, 64),
    (1, 1000, 12, 4, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_backward_kernel(B, S, H, KH, D, dtype, causal):
    """The forward's log-sum-exp and the backward kernel against their
    plain versions on the same inputs, and the autograd.Function's
    gradients on the card: counted once a call, no plain route taken. The
    shapes hold the bf16 kernel's edges: S below one 128-key tile (32) and
    ragged (100, 385, 1000), G = 1, 3 and 4 query heads a KV head, hd 64
    and 128."""
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(S + D)
    q = torch.randn(B, S, H, D, generator=g).to(dtype).to(dev)
    k, v = (torch.randn(B, S, KH, D, generator=g).to(dtype).to(dev)
            for _ in range(2))
    do = torch.randn(B, S, H, D, generator=g).to(dtype).to(dev)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = {n: ops.LAUNCHES[n] for n in ("flash_attention",
                                            "flash_attention_bwd")}
    out = ops.flash_attention(*leaves, causal=causal)
    # the graph kept, so that the saved log-sum-exp can be read below
    grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    assert {n: ops.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention": 1, "flash_attention_bwd": 1}
    o, lse = ref.flash_attention_fwd_lse(q, k, v, causal=causal)
    tol = ATTN_TOL[dtype]
    _, kernel_lse = out.grad_fn.saved_tensors[3:5]
    torch.testing.assert_close(kernel_lse, lse, atol=tol, rtol=tol)
    exp = ref.flash_attention_bwd(q, k, v, out.detach(), kernel_lse, do,
                                  causal=causal)
    for got, want in zip(grads, exp):
        assert got.dtype == dtype and got.is_contiguous()
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KH,D,Dv,layout", [
    (1, 32, 4, 4, 96, 96, "dense"), (2, 385, 8, 4, 96, 96, "dense"),
    (1, 1024, 32, 32, 96, 96, "dense"), (1, 100, 8, 8, 96, 64, "dense"),
    (1, 1000, 40, 40, 96, 64, "mla"), (2, 333, 4, 4, 48, 32, "dense"),
    (1, 64, 4, 4, 48, 32, "mla"), (1, 1000, 24, 8, 128, 128, "dense")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_at_its_width_pairs(B, S, H, KH, D, Dv, layout, dtype,
                                      causal):
    """Both kernels at the (q.k, v) pairs of phi3-mini-3.8b (96, 96),
    minicpm3-4b (96, 64; reduced (48, 32)) and phi4-mini-3.8b (128, 128,
    GQA 3): the forward's output and log-sum-exp and the autograd.Function's
    gradients (dv at v's width) against the plain versions, ragged S, and
    the MLA layout (v a strided slice of the packed k_nope / v projection,
    k a concatenation), as ``models/mla.py`` makes them."""
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(S + D + Dv)
    q = torch.randn(B, S, H, D, generator=g).to(dtype).to(dev)
    k = torch.randn(B, S, KH, D, generator=g).to(dtype).to(dev)
    if layout == "mla":
        kv = torch.randn(B, S, KH, D + Dv, generator=g).to(dtype).to(dev)
        v = kv[..., D:]
    else:
        v = torch.randn(B, S, KH, Dv, generator=g).to(dtype).to(dev)
    do = torch.randn(B, S, H, Dv, generator=g).to(dtype).to(dev)
    # views of the inputs, v's strides kept
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = {n: ops.LAUNCHES[n] for n in ("flash_attention",
                                            "flash_attention_bwd")}
    out = ops.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    assert {n: ops.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention": 1, "flash_attention_bwd": 1}
    assert out.shape == (B, S, H, Dv)
    tol = ATTN_TOL[dtype]
    o, lse = ref.flash_attention_fwd_lse(q, k, v, causal=causal)
    torch.testing.assert_close(out.detach().float(), o.float(), atol=tol,
                               rtol=tol)
    _, kernel_lse = out.grad_fn.saved_tensors[3:5]
    torch.testing.assert_close(kernel_lse, lse, atol=tol, rtol=tol)
    exp = ref.flash_attention_bwd(q, k, v, out.detach(), kernel_lse, do,
                                  causal=causal)
    for got, want, t in zip(grads, exp, (q, k, v)):
        assert got.shape == t.shape and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    if dtype == torch.bfloat16:
        exact = ref.flash_attention(q.float(), k.float(), v.float(),
                                    causal=causal)
        assert float((out.detach().float() - exact).norm() / exact.norm()) \
            <= ATTN_BF16_REL_L2


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv", [(96, 48), (80, 80), (64, 32)])
def test_attention_rejects_an_unbuilt_width_pair(D, Dv):
    """Nothing falls back: a pair the libraries are not built for raises
    before any launch."""
    dev = _card()
    q, k = (torch.zeros(1, 64, 4, D, dtype=torch.bfloat16, device=dev)
            for _ in range(2))
    v = torch.zeros(1, 64, 4, Dv, dtype=torch.bfloat16, device=dev)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="not built"):
        ops.flash_attention(q, k, v)
    assert ops.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KH,layout", [
    (1, 32, 4, 4, "dense"), (2, 333, 8, 8, "mla"), (1, 1000, 16, 16, "mla"),
    (1, 129, 4, 2, "dense")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_forward_at_192_128(B, S, H, KH, layout, dtype, causal):
    """The forward at deepseek-v2-236b's MLA pair (q.k 192 = three
    64-column boxes, v 128) against its plain version, ragged S and the
    MLA layout (v a strided slice of the packed k_nope / v projection);
    bf16 also by the tight check. Under grad the forward and the backward
    kernel each launch once and the gradients equal the plain backward's
    (the full matrix: ``test_attention_backward_at_192_128``)."""
    dev = _card()
    D, Dv = 192, 128
    g = torch.Generator(device="cpu").manual_seed(S + H)
    q = torch.randn(B, S, H, D, generator=g).to(dtype).to(dev)
    k = torch.randn(B, S, KH, D, generator=g).to(dtype).to(dev)
    if layout == "mla":
        kv = torch.randn(B, S, KH, 128 + Dv, generator=g).to(dtype).to(dev)
        v = kv[..., 128:]
    else:
        v = torch.randn(B, S, KH, Dv, generator=g).to(dtype).to(dev)
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] - before["flash_attention"] == 1
    assert out.shape == (B, S, H, Dv) and out.dtype == dtype
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.flash_attention(
        q, k, v, causal=causal).float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        exact = ref.flash_attention(q.float(), k.float(), v.float(),
                                    causal=causal)
        assert float((out.float() - exact).norm() / exact.norm()) \
            <= ATTN_BF16_REL_L2
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    names = ("flash_attention", "flash_attention_bwd")
    before = dict(ops.LAUNCHES)
    o = ops.flash_attention(*leaves, causal=causal)
    do = torch.ones_like(o)
    grads = torch.autograd.grad(o, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    assert _launched(names, before) == {n: 1 for n in names}
    _, kernel_lse = o.grad_fn.saved_tensors[3:5]
    exp = ref.flash_attention_bwd(q, k, v, o.detach(), kernel_lse, do,
                                  causal=causal)
    for got, want in zip(grads, exp):
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


# the tight check of the bf16 backward (chip_smoke.ATTN_BWD_BF16_REL_L2):
# each gradient's relative L2 distance from the f32 backward of the same
# q, k, v, o, lse and do
ATTN_BWD_BF16_REL_L2 = 3.5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KH,layout", [
    (1, 32, 4, 4, "dense"), (1, 64, 2, 2, "dense"), (2, 333, 8, 4, "dense"),
    (1, 1000, 16, 16, "mla"), (1, 129, 6, 2, "mla"),
    (2, 1024, 8, 8, "dense")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_backward_at_192_128(B, S, H, KH, layout, dtype, causal):
    """The backward kernel at deepseek-v2-236b's MLA pair (q.k 192, v 128;
    in bf16 its own design, 64-key tiles, the two consumer warpgroups
    splitting S^T and dP^T by query columns and dK, dV by column boxes)
    against its plain version on the forward kernel's o and log-sum-exp,
    launched once a call: S below a tile, at a tile, ragged and a whole
    number of tiles, 1 and 2 and 3 query heads a KV head, the MLA layout
    (v a strided slice); bf16 also by the tight check."""
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    D, Dv = 192, 128
    g = torch.Generator(device="cpu").manual_seed(S + H + KH)
    q = torch.randn(B, S, H, D, generator=g).to(dtype).to(dev)
    k = torch.randn(B, S, KH, D, generator=g).to(dtype).to(dev)
    if layout == "mla":
        kv = torch.randn(B, S, KH, 128 + Dv, generator=g).to(dtype).to(dev)
        v = kv[..., 128:]
    else:
        v = torch.randn(B, S, KH, Dv, generator=g).to(dtype).to(dev)
    do = torch.randn(B, S, H, Dv, generator=g).to(dtype).to(dev)
    o, lse = fa.launch(ops.load_library("flash_attention"), q, k, v,
                       causal=causal, with_lse=True)
    before = dict(ops.LAUNCHES)
    grads = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert _launched(("flash_attention_bwd",), before) == {
        "flash_attention_bwd": 1}
    tol = ATTN_TOL[dtype]
    exp = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for got, want, t in zip(grads, exp, (q, k, v)):
        assert got.shape == t.shape and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    if dtype == torch.bfloat16:
        exact = ref.flash_attention_bwd(*(t.float() for t in (q, k, v, o)),
                                        lse, do.float(), causal=causal)
        for got, want in zip(grads, exact):
            assert float((got.float() - want).norm() / want.norm()) \
                <= ATTN_BWD_BF16_REL_L2


def _launched(names, before):
    return {n: ops.LAUNCHES[n] - before[n] for n in names}


@pytest.mark.gpu
@pytest.mark.parametrize("S,ds", [(1, 16), (63, 64), (64, 128), (65, 16),
                                  (300, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_backward_kernel(S, ds, dtype):
    """``ops.ssd_chunk`` under grad on the card: the forward kernel (with
    the chunk states) and the backward kernel, one launch each, no plain
    route taken; the gradients against the plain backward of the same
    inputs, x, B and C strided views of one projection as in the model,
    at the SSD's tolerances."""
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(S + ds)
    nh, hd = 4, 64
    whole = torch.randn(2, S, nh * hd + 2 * ds, generator=g).to(dtype).to(dev)
    dt = F.softplus(torch.randn(2, S, nh, generator=g)).to(dev)
    A = -torch.exp(torch.randn(nh, generator=g)).to(dev)
    dy = torch.randn(2, S, nh, hd, generator=g).to(dtype).to(dev)
    leaves = [t.clone().requires_grad_(True) for t in (whole, dt, A)]
    xs, Bm, Cm = torch.split(leaves[0], [nh * hd, ds, ds], dim=-1)
    names = ("ssd_chunk", "ssd_chunk_bwd")
    before = {n: ops.LAUNCHES[n] for n in names}
    y = ops.ssd_chunk(xs.reshape(2, S, nh, hd), Bm, Cm, *leaves[1:])
    dx, dB, dC, ddt, dA = torch.autograd.grad(
        y, [xs, Bm, Cm, leaves[1], leaves[2]], dy)
    torch.cuda.synchronize()
    assert _launched(names, before) == {"ssd_chunk": 1, "ssd_chunk_bwd": 1}
    xh, bv, cv = torch.split(whole, [nh * hd, ds, ds], dim=-1)
    exp = ref.ssd_chunk_bwd(xh.reshape(2, S, nh, hd).float(), bv.float(),
                            cv.float(), dt, A, dy.float())
    tol = SSD_TOL[dtype]
    for got, want in zip((dx.reshape(2, S, nh, hd), dB, dC, ddt, dA), exp):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("S,nh,ds,pad", [(130, 3, 64, 0), (65, 70, 16, 0),
                                         (200, 4, 128, 3)])
def test_ssd_backward_two_passes(S, nh, ds, pad):
    """The bf16 SSD backward's carry pass against ``ref.ssd_chunk_bwd_carry``
    and the whole backward against ``ref.ssd_chunk_bwd_local`` on the plain
    carry and the forward kernel's states: 70 heads take two chunk-local
    CTAs a chunk (dB and dC added across them); B and C whose rows start
    off 16 bytes (``pad``) are copied first. dx, dB and dC elementwise at
    the SSD's bf16 tolerance; the f32 outputs (the carry, ddt and dA: sums
    whose terms cancel, in another order than the plain version's) by
    relative L2, at chip_smoke.py's f32 limit of 1e-4."""
    from repro_torch.kernels import ssd_chunk as sc
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(S + nh + ds)
    bf = torch.bfloat16
    x = torch.randn(2, S, nh, 64, generator=g).to(bf).to(dev)
    bc = torch.randn(2, S, pad + 2 * ds, generator=g).to(bf).to(dev)
    Bm, Cm = bc[..., pad:pad + ds], bc[..., pad + ds:]
    dt = F.softplus(torch.randn(2, S, nh, generator=g)).to(dev)
    A = -torch.exp(torch.randn(nh, generator=g)).to(dev)
    dy = torch.randn(2, S, nh, 64, generator=g).to(bf).to(dev)

    def rel_l2(got, exp):
        return float((got - exp).norm() / exp.norm())

    carry = sc.launch_carry(ops.load_library("ssd_chunk_bwd"), Cm, dt, A, dy)
    plain = ref.ssd_chunk_bwd_carry(Cm, dt, A, dy)
    assert rel_l2(carry, plain) <= 1e-4
    _, states = sc.launch(ops.load_library("ssd_chunk"), x, Bm, Cm, dt, A,
                          with_states=True)
    got = ops.ssd_chunk_bwd(x, Bm, Cm, dt, A, dy, states)
    exp = ref.ssd_chunk_bwd_local(x, Bm, Cm, dt, A, dy, states, plain)
    for i, (a, e) in enumerate(zip(got, exp)):
        assert a.dtype == e.dtype and bool(torch.isfinite(a.float()).all())
        if a.dtype == bf:
            torch.testing.assert_close(a.float(), e.float(),
                                       atol=SSD_TOL[bf], rtol=SSD_TOL[bf])
        else:
            assert rel_l2(a, e) <= 1e-4, i


@pytest.mark.gpu
@pytest.mark.parametrize("S,di,ds", [(1, 96, 16), (63, 96, 8), (64, 512, 16),
                                     (65, 100, 16), (300, 256, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_selective_scan_backward_kernel(S, di, ds, dtype):
    """``ops.selective_scan`` under grad on the card, as the SSD's above:
    one forward and one backward launch; the gradients against the plain
    backward, B and C strided views of one projection."""
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(S + di + ds)
    x = torch.randn(2, S, di, generator=g).to(dtype).to(dev)
    dt = F.softplus(torch.randn(2, S, di, generator=g)).to(dtype).to(dev)
    bc = torch.randn(2, S, 3 + 2 * ds, generator=g).to(dtype).to(dev)
    A = -torch.exp(torch.randn(di, ds, generator=g)).to(dev)
    D = torch.randn(di, generator=g).to(dev)
    dy = torch.randn(2, S, di, generator=g).to(dtype).to(dev)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, bc, A, D)]
    Bm, Cm = leaves[2][..., 3:3 + ds], leaves[2][..., 3 + ds:]
    names = ("selective_scan", "selective_scan_bwd")
    before = {n: ops.LAUNCHES[n] for n in names}
    y = ops.selective_scan(leaves[0], leaves[1], Bm, Cm, *leaves[3:])
    grads = torch.autograd.grad(
        y, [leaves[0], leaves[1], Bm, Cm, leaves[3], leaves[4]], dy)
    torch.cuda.synchronize()
    assert _launched(names, before) == {"selective_scan": 1,
                                        "selective_scan_bwd": 1}
    exp = ref.selective_scan_bwd(x.float(), dt.float(),
                                 bc[..., 3:3 + ds].float(),
                                 bc[..., 3 + ds:].float(), A, D, dy.float())
    tol = SCAN_TOL[dtype]
    for got, want in zip(grads, exp):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
