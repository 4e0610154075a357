"""The port stands alone: no JAX, no reference package, no silent CPU.

An AST scan of every ``src/repro_torch/**/*.py``, ``chip_smoke.py``,
``chip_faults.py`` and ``chip_probes.py`` fails on any import of
``jax``/``jaxlib`` or of ``repro`` other than
``repro_torch``. Entry points called without ``device=`` raise when no
CUDA device is present."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / f"{name}.py" for name in ("chip_smoke", "chip_faults",
                                      "chip_probes")]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import energy\n"
                 "from repro_torch import prng\n")
    assert [n for n in _imported(f) if _forbidden(n)] == ["jax.numpy",
                                                           "repro.core"]


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch import prng
    from repro_torch.core.selection import SelectorConfig
    from repro_torch.federated.server import FLConfig, run_fl
    from repro_torch import resolve_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prng.PRNGKey(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fl(FLConfig(selector=SelectorConfig("eafl"), rounds=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_lm_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import (decode_step, forward_logits, init_cache,
                                    init_params)
    for arch in ("zamba2-1.2b", "falcon-mamba-7b"):
        cfg = get_reduced(arch)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(0, cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_cache(cfg, 1, 4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", arch, "--gen", "1", "--prompt-len", "2"])
        params = init_params(0, cfg, device="cpu")
        tokens = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
        with pytest.raises(RuntimeError, match="device='cpu'"):
            forward_logits(cfg, params, tokens)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_prefill_step(cfg)(params, tokens)
        cache = init_cache(cfg, 1, 4, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            decode_step(cfg, params, {"tokens": tokens["tokens"][:, :1]},
                        cache, 0)
        assert forward_logits(cfg, params, tokens, device="cpu").shape == \
            (1, 4, cfg.vocab_size)


def test_scan_covers_the_lm_slice():
    pkg = ROOT / "src" / "repro_torch"
    names = {p.relative_to(pkg).as_posix() for p in FILES
             if pkg in p.parents}
    assert {"configs/base.py", "configs/zamba2_1_2b.py", "models/common.py",
            "models/rope.py", "models/attention.py", "models/mamba.py",
            "models/blocks.py", "models/transformer.py", "launch/steps.py",
            "launch/serve.py", "kernels/flash_attention.py",
            "kernels/ssd_chunk.py", "configs/falcon_mamba_7b.py",
            "kernels/selective_scan.py"} <= names


def test_scan_covers_the_moe_slice():
    pkg = ROOT / "src" / "repro_torch"
    names = {p.relative_to(pkg).as_posix() for p in FILES
             if pkg in p.parents}
    assert {"models/moe.py", "configs/llama4_scout_17b_a16e.py",
            "configs/deepseek_v2_236b.py"} <= names


def test_moe_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.models import forward_logits, init_params
    for arch in ("llama4-scout-17b-a16e", "deepseek-v2-236b"):
        cfg = get_reduced(arch)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(0, cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", arch, "--gen", "1", "--prompt-len", "2"])
        params = init_params(0, cfg, device="cpu")
        tokens = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
        with pytest.raises(RuntimeError, match="device='cpu'"):
            forward_logits(cfg, params, tokens)
        assert forward_logits(cfg, params, tokens, device="cpu").shape == \
            (1, 4, cfg.vocab_size)


def test_scan_covers_the_async_slice():
    pkg = ROOT / "src" / "repro_torch"
    names = {p.relative_to(pkg).as_posix() for p in FILES
             if pkg in p.parents}
    assert {"federated/async_server.py", "federated/simulation.py",
            "federated/replay.py", "numerics.py"} <= names


def test_scan_covers_the_front_doors():
    """The controller, the ``train`` launcher and the example twins are
    in the scan (a package file is found by the glob, not listed)."""
    pkg = ROOT / "src" / "repro_torch"
    names = {p.relative_to(pkg).as_posix() for p in FILES
             if pkg in p.parents}
    assert {"federated/controller.py", "launch/train.py",
            "examples/__init__.py", "examples/quickstart.py",
            "examples/async_fedbuff.py",
            "examples/million_client_selection.py"} <= names


def test_scan_covers_the_analysis_slice():
    pkg = ROOT / "src" / "repro_torch"
    names = {p.relative_to(pkg).as_posix() for p in FILES
             if pkg in p.parents}
    assert {"analysis/__init__.py", "analysis/__main__.py",
            "analysis/engine.py", "analysis/callgraph.py",
            "analysis/rules.py", "analysis/runtime.py"} <= names


def test_the_lint_imports_no_torch():
    """``import repro_torch.analysis`` (and its rules and CLI) loads no
    torch until a runtime name is asked for."""
    import subprocess
    import sys
    code = ("import sys\n"
            "import repro_torch.analysis as a\n"
            "import repro_torch.analysis.rules, repro_torch.analysis.__main__\n"
            "assert 'torch' not in sys.modules, 'torch loaded early'\n"
            "a.strict_mode\n"
            "assert 'torch' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT,
                       env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr


def test_async_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch.core.selection import SelectorConfig
    from repro_torch.federated import (FLConfig, run_fl, run_fl_async,
                                       run_fl_async_scanned)
    cfg = FLConfig(selector=SelectorConfig("eafl", k=2), n_clients=8,
                   rounds=1, buffer_size=1, max_concurrency=2)
    for run in (run_fl, run_fl_async, run_fl_async_scanned):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(cfg)


def _load(name):
    import importlib.util
    import sys
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod    # chip_faults imports chip_smoke by name
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke():
    return _load("chip_smoke")


def test_chip_smoke_refuses_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert _chip_smoke().main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_holds_each_recorded_call_against_plain():
    """The card run records every call of the kernel's wrapper and checks
    its outputs against the plain version on the same inputs; a swapped
    pair of indices fails that check."""
    smoke = _chip_smoke()
    from repro_torch.kernels import ops, ref
    wrapper = ops.topk_reward
    g = torch.Generator().manual_seed(0)
    a, b, u = (torch.rand(500, generator=g) for _ in range(3))
    valid = torch.rand(500, generator=g) < 0.6
    with smoke.recording(ops) as calls:
        out = ops.topk_reward(a, b, valid, f=0.3, k=7, ucb=u)
    assert ops.topk_reward is wrapper
    assert len(calls) == 1 and torch.equal(calls[0][2][1], out[1])
    assert smoke.check_recorded(torch, ref, calls, "cpu") == 0.0
    ins, kw, (v, i) = calls[0]
    swapped = i.clone()
    swapped[[0, 1]] = swapped[[1, 0]]
    with pytest.raises(smoke.SmokeFailure, match="indices differ"):
        smoke.check_recorded(torch, ref, [(ins, kw, (v, swapped))], "cpu")
    with pytest.raises(smoke.SmokeFailure, match="not called"):
        smoke.check_recorded(torch, ref, [], "cpu")


@pytest.mark.parametrize("with_ucb,per_client", [(True, 13), (False, 9)])
def test_chip_smoke_bound_counts_each_byte_once(with_ucb, per_client):
    smoke = _chip_smoke()
    n, k = 1_048_576, 100
    x = torch.zeros(n)
    mask = torch.zeros(n, dtype=torch.bool)
    ms, by = smoke.bound(x, x, mask, x if with_ucb else None, k, "eafl")
    assert by == "bytes"
    assert ms == pytest.approx((per_client * n + 8 * k) / 3.35e12 * 1e3)


def test_chip_smoke_lm_bounds():
    """The bounds chip_smoke prints for the LM kernels at the prefill
    shape: attention is bound by operations (137.5 GFLOP of bf16 over the
    causal pairs; at minicpm3-4b's MLA widths 2 (96 + 64) FLOP a pair
    forward and 2 (3 96 + 2 64) backward, 1,117 GFLOP at its train step's
    (4, 4096, 40)), the SSD scan by bytes (138 MB)."""
    smoke = _chip_smoke()
    bf = dict(dtype=torch.bfloat16, device="meta")
    q = torch.empty(2, 4096, 32, 64, **bf)
    ms, by = smoke.attn_bound(q, q, q, causal=True)
    flops = 4 * 64 * (4096 * 4097 // 2) * 2 * 32
    assert by == "operations" and ms == pytest.approx(flops / 989e12 * 1e3)
    assert smoke.attn_bound(q, q, q, causal=False)[0] > ms
    pairs = 4096 * 4097 // 2
    qk, v = (torch.empty(2, 4096, 40, d, **bf) for d in (96, 64))
    ms, by = smoke.attn_bound(qk, qk, v, causal=True)
    assert by == "operations" and ms == pytest.approx(
        2 * (96 + 64) * pairs * 2 * 40 / 989e12 * 1e3)
    qk, v = (torch.empty(4, 4096, 40, d, **bf) for d in (96, 64))
    ms, by = smoke.bwd_bound(qk, qk, v, causal=True)
    assert by == "operations" and ms == pytest.approx(
        2 * (3 * 96 + 2 * 64) * pairs * 4 * 40 / 989e12 * 1e3)
    assert ms == pytest.approx(1.129, abs=1e-3)
    x = torch.empty(2, 4096, 64, 64, **bf)
    bc = torch.empty(2, 4096, 64, **bf)
    dt = torch.empty(2, 4096, 64, dtype=torch.float32, device="meta")
    A = torch.empty(64, dtype=torch.float32, device="meta")
    ms, by = smoke.ssd_bound(x, bc, bc, dt, A)
    nbytes = 2 * x.nbytes + 2 * bc.nbytes + dt.nbytes + A.nbytes
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_chip_smoke_scan_bound():
    """The selective scan at the falcon-mamba-7b prefill shape is bound by
    its 1,073,741,824 exponentials on the special-function units (16 a
    clock per SM), not by its 403,734,528 bytes; B and C are counted at
    their own size, not the packed projection's."""
    smoke = _chip_smoke()
    bf = dict(dtype=torch.bfloat16, device="meta")
    x = torch.empty(2, 4096, 8192, **bf)
    packed = torch.empty(2, 4096, 288, **bf)
    A = torch.empty(8192, 16, device="meta")
    D = torch.empty(8192, device="meta")
    Bm, Cm = packed[..., 256:272], packed[..., 272:]
    ms, by = smoke.scan_bound(x, x, Bm, Cm, A, D, 132, 1.98e9)
    assert by == "operations"
    assert ms == pytest.approx(2 * 4096 * 8192 * 16 / (16 * 132 * 1.98e9)
                               * 1e3)
    assert 3 * x.nbytes + Bm.nbytes + Cm.nbytes + A.nbytes + D.nbytes \
        == 403_734_528
    ms_bytes = 403_734_528 / 3.35e12 * 1e3
    assert ms > ms_bytes
    assert smoke.scan_bound(x, x, Bm, Cm, A, D, 132, 1e12) == (
        pytest.approx(ms_bytes), "bytes")


def test_chip_smoke_copies_keep_strides():
    """The timing copies and the recorded first calls keep a strided
    slice strided, as the model hands it to the kernel."""
    smoke = _chip_smoke()
    packed = torch.randn(2, 5, 11)
    Bm = packed[..., 3:7]
    c = smoke.clone_strided(Bm)
    assert c.stride() == Bm.stride() and torch.equal(c, Bm)
    assert c.data_ptr() != Bm.data_ptr()
    (sets, _) = smoke.copies((Bm, None), 50 * 2**20, most=2)
    assert len(sets) == 2 and sets[0][0].stride() == Bm.stride()


@pytest.mark.parametrize("kernel", ["ssd_chunk", "selective_scan"])
def test_chip_smoke_tight_scan_checks(kernel):
    """The tight check of each scan kernel: the f32 scan of bf16 inputs
    rounded to bf16 passes it, the same output 5% too large fails, and a
    NaN fails."""
    smoke = _chip_smoke()
    from repro_torch.kernels import ref
    dev = torch.device("cpu")
    if kernel == "ssd_chunk":
        args = smoke.ssd_inputs(torch, 1, 64, 2, 64, 16, torch.bfloat16,
                                dev, 0)
        out = ref.ssd_chunk(*(t.float() for t in args[:3]), *args[3:])
        read, limit = smoke.ssd_rel_l2, smoke.SSD_BF16_REL_L2
    else:
        args = smoke.scan_inputs(torch, 2, 40, 96, 16, torch.bfloat16, dev,
                                 0)
        out = ref.selective_scan(*(t.float() for t in args))
        read, limit = smoke.scan_rel_l2, smoke.SCAN_BF16_REL_L2
    out = out.bfloat16()
    ok = read(torch, ref, out, *args)
    assert smoke.held({"plain": ok}, limit, kernel) == ok
    with pytest.raises(smoke.SmokeFailure, match="relative L2"):
        smoke.held({"scaled": read(torch, ref, out * 1.05, *args)}, limit,
                   kernel)
    with pytest.raises(smoke.SmokeFailure, match="relative L2"):
        smoke.held({"plain": ok, "nan": float("nan")}, limit, kernel)


def test_chip_smoke_keeps_the_first_call_of_each_lm_kernel():
    smoke = _chip_smoke()
    from repro_torch.kernels import ops
    saved = ops.flash_attention
    q = torch.randn(1, 8, 2, 64)
    with smoke.first_calls(ops, ("flash_attention",)) as seen:
        out = ops.flash_attention(q, q, q, causal=True)
        ops.flash_attention(q + 1, q, q, causal=False)
    assert ops.flash_attention is saved
    (q0, _, _), kw, o = seen["flash_attention"]
    assert torch.equal(q0, q) and kw == {"causal": True}
    assert torch.equal(o, out)
    d = smoke.logit_diff(torch, out, out, "same")
    assert d["rel_l2"] == 0.0 and d["argmax_agree"] == 1.0


def test_chip_smoke_tight_attention_check():
    """The tight check of the bf16 attention kernel scales with the output:
    the f32 attention rounded to bf16 passes it, the same output 5% too
    large fails."""
    smoke = _chip_smoke()
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 256, 2, 64, generator=g).bfloat16()
               for _ in range(3))
    out = ref.flash_attention(q.float(), k.float(), v.float(),
                              causal=True).bfloat16()
    assert smoke.tight(torch, ref, out, q, k, v, True, "plain") \
        <= smoke.ATTN_BF16_REL_L2
    with pytest.raises(smoke.SmokeFailure, match="relative L2"):
        smoke.tight(torch, ref, out * 1.05, q, k, v, True, "scaled")


def test_chip_faults_refuses_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _chip_smoke()
    assert _load("chip_faults").main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


SCAN_KERNEL_FAULTS = [
    ("ssd_chunk", "carried_state_dropped"),
    ("ssd_chunk", "chunk_decay_not_applied"),
    ("ssd_chunk", "output_scaled_1.05"),
    ("ssd_chunk", "prefetched_chunk_from_stale_stage"),
    ("ssd_chunk", "h_low_part_dropped"),
    ("ssd_chunk", "wx_low_part_dropped"),
    ("selective_scan", "d_skip_dropped"),
    ("selective_scan", "state_reset_each_tile"),
    ("selective_scan", "decay_without_dt"),
    ("selective_scan", "state_in_bf16"),
    ("selective_scan", "last_tile_skipped"),
    ("selective_scan", "decay_without_log2e")]


def _kernel_body(src, fn):
    """The text of kernel ``fn`` (``"name("``) from its definition (the
    line after ``__global__``) to the next ``__global__`` or the end."""
    start = src.index(fn, src.index("__global__"))
    while not src[:start].rstrip().endswith(")"):
        start = src.index(fn, start + 1)    # skip mentions in comments
    end = src.find("__global__", start)
    return src[start:end if end >= 0 else len(src)]


@pytest.mark.parametrize("lib,fault", SCAN_KERNEL_FAULTS)
def test_chip_faults_plant_into_the_scan_kernels(lib, fault):
    """Each planted scan fault edits text that occurs once in its kernel
    source, inside the bf16 kernel function that KERNEL_FAULTS names (the
    tensor-core ``ssd_fwd_mma``, the selective scan's ``scan_fwd``)."""
    _chip_smoke()
    faults, fn = _load("chip_faults").KERNEL_FAULTS[lib]
    assert fn == {"ssd_chunk": "ssd_fwd_mma(",
                  "selective_scan": "scan_fwd("}[lib]
    old, new = faults[fault]
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
           f"{lib}.cu").read_text()
    assert src.count(old) == 1 and old != new
    assert old in _kernel_body(src, fn)


def test_chip_faults_scan_fault_list():
    """Every planted scan fault has its case above, and the list holds the
    ones aimed at the new designs."""
    _chip_smoke()
    cf = _load("chip_faults")
    planted = {(lib, name) for lib in ("ssd_chunk", "selective_scan")
               for name in cf.KERNEL_FAULTS[lib][0]}
    assert planted == set(SCAN_KERNEL_FAULTS)


@pytest.mark.parametrize("fault", ["output_scaled_1.05",
                                   "first_k_tile_skipped", "diagonal_masked",
                                   "accumulator_not_rescaled",
                                   "accumulator_in_bf16"])
def test_chip_faults_plant_into_the_tensor_core_kernel(fault):
    """Each planted fault edits text that occurs once in the kernel source,
    inside the tensor-core kernel (``flash_fwd_wgmma``), so an edit of the
    kernel cannot silently leave a fault unplanted."""
    _chip_smoke()
    faults, fn = _load("chip_faults").KERNEL_FAULTS["flash_attention"]
    assert fault in faults and fn == "flash_fwd_wgmma("
    old, new = faults[fault]
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
           "flash_attention.cu").read_text()
    assert src.count(old) == 1 and old != new
    assert src.index(old) > src.index(fn)


@pytest.mark.parametrize("fault", ["ties_highest_index_first",
                                   "last_radix_pass_skipped"])
def test_chip_faults_plant_into_the_topk_kernel(fault):
    """Each planted top-k fault edits text that occurs once in
    ``topk_select.cu``; phase 2's bitwise check must catch it on the card."""
    _chip_smoke()
    faults, fn = _load("chip_faults").KERNEL_FAULTS["topk_select"]
    old, new = faults[fault]
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
           "topk_select.cu").read_text()
    assert src.count(old) == 1 and old != new
    assert fn in src


def test_chip_smoke_topk_cases():
    """Phase 2 keeps its 105-case matrix and adds the radix select's edge
    cases, each a valid call of the wrapper (1 <= k <= min(block_n, N))."""
    cases, edges = _chip_smoke().topk_cases(_chip_smoke().TOPK_SIZES)
    assert len(cases) == 105
    assert {(c["n"], c["k"]) for c in edges} >= {
        (8191, 1), (8193, 8192), (4 * 2**20, 100), (4 * 2**20, 8192)}
    assert any(c.get("specials") for c in edges)
    assert any(c.get("valid_frac") == 0.0 for c in edges)
    assert all(1 <= c["k"] <= min(8192, c["n"]) for c in cases + edges)


PTXAS_REPORT = """\
ptxas info    : Compiling entry function '_ZN1a11ssd_fwd_mmaILi32ELi64ELb1EEEvPK' for 'sm_90a'
ptxas info    : Function properties for _ZN1a11ssd_fwd_mmaILi32ELi64ELb1EEEvPK
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN1a11ssd_fwd_mmaILi32ELi64ELb0EEEvPK' for 'sm_90a'
ptxas info    : Function properties for _ZN1a11ssd_fwd_mmaILi32ELi64ELb0EEEvPK
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
"""


def test_chip_smoke_reads_registers_and_spills_from_the_build():
    """Phase 1 logs each main-path kernel's registers and spills from
    ptxas's report; a kernel missing from the report fails the run."""
    smoke = _chip_smoke()
    usage = smoke.ptxas_usage(PTXAS_REPORT)
    assert len(usage) == 2
    main = smoke.MAIN_ENTRIES["ssd_chunk"]
    assert smoke.entry_usage(usage, main) == {
        "entries": 1, "registers": 128, "spill_bytes": 0}
    assert smoke.entry_usage(usage, "ssd_fwd_mma") == {
        "entries": 2, "registers": 128, "spill_bytes": 20}
    with pytest.raises(smoke.SmokeFailure, match="no kernel like"):
        smoke.entry_usage(usage, "scan_fwd")


def test_build_keeps_ptxas_report_beside_the_library():
    from repro_torch.kernels import ops
    for name in ops.EXTRA_FLAGS:
        flags = ops.nvcc_flags(name)
        assert flags[flags.index("-Xptxas") + 1] == "-v"
        log = ops.ptxas_log(name)
        assert log.parent == ops.library_path(name).parent
        assert log.name.startswith(ops.library_path(name).name)


def test_chip_probes_refuses_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _chip_smoke()
    _load("chip_faults")
    assert _load("chip_probes").main([]) != 0
    assert '"readings"' not in capsys.readouterr().out


def test_chip_probes_builds_another_checkouts_kernels(monkeypatch, tmp_path):
    """``--parent DIR`` builds DIR's SSD and scan sources and their and
    the attention's backward sources with this checkout's flags and
    launches them through DIR's own launchers (here this checkout, so a
    CPU tensor reaches the launcher and is refused)."""
    _chip_smoke()
    _load("chip_faults")
    probes = _load("chip_probes")
    from repro_torch.kernels import ops
    built = []

    def fake_run(cmd, **kw):
        built.append(cmd)
        return type("Done", (), {"returncode": 0, "stderr": ""})()

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(probes.subprocess, "run", fake_run)
    monkeypatch.setattr(probes.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(ops, "_nvcc", lambda: "nvcc")
    fns, paths = probes.load_parent(ops, ROOT, tmp_path)
    assert set(fns) == set(paths) == {"ssd_chunk", "selective_scan",
                                      "flash_attention_bwd", "ssd_chunk_bwd",
                                      "selective_scan_bwd"}
    assert all(p.parent == tmp_path for p in paths.values())
    srcs = sorted(Path(c[-1]).name for c in built)
    assert srcs == ["flash_attention_bwd.cu", "selective_scan.cu",
                    "selective_scan_bwd.cu", "ssd_chunk.cu",
                    "ssd_chunk_bwd.cu"]
    assert {n for part in probes.PARTS.values() for n in part} <= set(fns)
    assert all(c[1:1 + len(ops.NVCC_FLAGS)] == list(ops.NVCC_FLAGS)
               for c in built)
    x = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="runs on CUDA"):
        fns["ssd_chunk"](x, x[..., 0, :16], x[..., 0, :16], x[..., 0],
                         torch.ones(2))
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="runs on CUDA"):
        fns["flash_attention_bwd"](q, q, q, q, torch.zeros(1, 2, 4), q,
                                   causal=True)
    with pytest.raises(ValueError, match="runs on CUDA"):
        fns["ssd_chunk_bwd"](x, x[..., 0, :16], x[..., 0, :16], x[..., 0],
                             torch.ones(2), x, torch.zeros(1, 1, 2, 16, 64))


@pytest.mark.parametrize("table", ["SSD_PROBES", "SCAN_PROBES",
                                   "SSD_BWD_PROBES", "SCAN_BWD_PROBES",
                                   "WIDE_BWD_PROBES"])
def test_chip_probes_edits_occur_once(table):
    """Each design probe of chip_probes.py edits text that occurs once in
    its source (a stale edit would stop the script on the card)."""
    _chip_smoke()
    _load("chip_faults")
    probes = _load("chip_probes")
    lib = {"SSD_PROBES": "ssd_chunk", "SCAN_PROBES": "selective_scan",
           "SSD_BWD_PROBES": "ssd_chunk_bwd",
           "SCAN_BWD_PROBES": "selective_scan_bwd",
           "WIDE_BWD_PROBES": "flash_attention_bwd"}[table]
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
           f"{lib}.cu").read_text()
    for name, (old, new) in getattr(probes, table).items():
        for text, repl in ([(old, new)] if new is not None else old):
            assert src.count(text) == 1 and text != repl, (name, text)


@pytest.mark.parametrize("fault", ["dk_without_group_sum",
                                   "ragged_k_tile_not_masked",
                                   "ds_tile_unswizzled", "lse_in_base_2",
                                   "qk_columns_64_95_dropped",
                                   "scale_of_v_width",
                                   "dv_from_do_at_qk_width",
                                   "qk_third_box_dropped",
                                   "dk_third_box_dropped",
                                   "dv_boxes_swapped",
                                   "pt_ds_tiles_unswizzled"])
def test_chip_faults_plant_into_the_training_attention(fault):
    """Each planted fault of the training path's attention (and of both
    attention kernels at their width pairs) edits text that occurs once
    in its source, after the tensor-core kernel's definition (the
    backward's ``flash_bwd_wgmma``, at (192, 128) its
    ``flash_bwd_wgmma_wide``, the forward's ``flash_fwd_wgmma``), so an
    edit of a kernel cannot leave a fault unplanted."""
    _chip_smoke()
    cf = _load("chip_faults")
    lib, edits = {**cf.BWD_FAULTS, **cf.WIDTH_FAULTS, **cf.WIDE_FAULTS}[fault]
    fn = {"flash_attention_bwd": "flash_bwd_wgmma(",
          "flash_attention": "flash_fwd_wgmma("}[lib]
    if fault in cf.WIDE_FAULTS and lib == "flash_attention_bwd":
        fn = "flash_bwd_wgmma_wide("
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
           f"{lib}.cu").read_text()
    for old, new in edits:
        assert src.count(old) == 1 and old != new
        assert src.index(old) > src.index(fn)


def test_library_hash_covers_included_headers(monkeypatch, tmp_path):
    """A library's name hashes the ``csrc/`` headers its source includes,
    so an edit of a shared header rebuilds every library that includes it
    and no other."""
    from repro_torch.kernels import ops
    (tmp_path / "flash_attention_bwd.cu").write_text(
        '#include "hopper.cuh"\n#include <stdint.h>\nint x;\n')
    (tmp_path / "hopper.cuh").write_text('#include "more.cuh"\nint y;\n')
    (tmp_path / "more.cuh").write_text("int z;\n")
    (tmp_path / "ssd_chunk.cu").write_text("int w;\n")
    monkeypatch.setattr(ops, "CSRC", tmp_path)
    assert [p.name for p in ops.sources("flash_attention_bwd")] == [
        "flash_attention_bwd.cu", "hopper.cuh", "more.cuh"]
    before = {n: ops.library_path(n) for n in ("flash_attention_bwd",
                                               "ssd_chunk")}
    (tmp_path / "more.cuh").write_text("int z2;\n")
    after = {n: ops.library_path(n) for n in before}
    assert after["flash_attention_bwd"] != before["flash_attention_bwd"]
    assert after["ssd_chunk"] == before["ssd_chunk"]


def test_attention_libraries_share_the_hopper_header():
    """Both attention libraries include ``hopper.cuh``; the others include
    no header of ``csrc/``."""
    from repro_torch.kernels import ops
    assert {n: [p.name for p in ops.sources(n)[1:]]
            for n in ops.EXTRA_FLAGS} == {
        "topk_select": [], "flash_attention": ["hopper.cuh"],
        "flash_attention_bwd": ["hopper.cuh"], "ssd_chunk": [],
        "ssd_chunk_bwd": [], "selective_scan": [], "selective_scan_bwd": []}


BWD_SASS = """\
        code for sm_90a
        Function : _ZN1a15flash_bwd_wgmmaILi128EEEv14CUtensorMap_st
        /*0000*/                   UTMALDG.4D [UR8], [UR22] ;
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR16], RZ, !UPT, gsb0 ;
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, R180, gdesc[UR16].tnspB, R24, gsb0 ;
        /*0030*/               @P0 UTMAREDG.4D.ADD [UR24], [UR22] ;
        /*0040*/                   EXIT ;
        Function : _ZN1a13flash_bwd_mmaILi128EEEvPK
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   REDG.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R5 ;
"""


def test_chip_smoke_counts_the_backwards_hopper_instructions():
    """Phase 1 counts wgmma, TMA loads and reduce-adds of each backward
    entry from its SASS (modifiers and predicates dropped)."""
    smoke = _chip_smoke()
    new = smoke.sass_ops(BWD_SASS, "flash_bwd_wgmma")
    assert list(new.values()) == [{"UTMALDG": 1, "HGMMA": 2, "UTMAREDG": 1,
                                   "EXIT": 1}]
    old = next(iter(smoke.sass_ops(BWD_SASS, "flash_bwd_mma").values()))
    assert old == {"HMMA": 1, "REDG": 1}
    with pytest.raises(smoke.SmokeFailure, match="no function like"):
        smoke.sass_ops(BWD_SASS, "flash_fwd")


def test_chip_smoke_checks_ragged_full_width_scans():
    """Phases 8 and 12 hold each scan kernel at full width with a ragged
    last chunk or tile, beside the prefill's own shape."""
    smoke = _chip_smoke()
    assert (2, 4000, 64, 64, 64, 0.0) in smoke.SSD_SHAPES
    assert (2, 4095, 8192, 16, 0.0) in smoke.SCAN_SHAPES
    assert (2, 4096, 64, 64, 64, 0.0) in smoke.SSD_SHAPES
    assert (2, 4096, 8192, 16, 0.0) in smoke.SCAN_SHAPES


SASS = """\
        code for sm_90a
        Function : _ZN1a8scan_fwdI13__nv_bfloat16Li16EEEvPK
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   MUFU.EX2 R5, R4 ;
        /*0030*/                   FFMA R6, R5, R6, R7 ;
        /*0040*/                   MUFU.EX2 R8, R4 ;
        /*0050*/               @P1 BRA 0x10 ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/               @P2 BRA 0x0 ;
        /*0080*/                   EXIT ;
        Function : _ZN1a11ssd_fwd_mmaILi32ELi64ELb1EEEvPK
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   MUFU.EX2 R5, R4 ;
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0030*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0040*/               @P0 BRA 0x0 ;
        /*0050*/                   EXIT ;
"""


def test_chip_smoke_counts_the_scan_kernels_loops_in_sass():
    """Phase 1 reads each scan kernel's loop from cuobjdump's SASS: the
    selective scan's innermost loop with an exponential (instructions a
    state-step), the SSD's chunk loop (the longest with a barrier)."""
    smoke = _chip_smoke()
    loops = smoke.sass_loops(SASS, "scan_fwdI13")
    assert [lp["instructions"] for lp in loops] == [5, 8]
    assert loops[0]["ops"] == {"LDS": 1, "MUFU": 2, "FFMA": 1, "BRA": 1}
    assert smoke.scan_loop_counts(SASS) == {
        "instructions": 5, "mufu": 2, "per_state_step": 2.5}
    assert smoke.ssd_loop_counts(SASS) == {
        "kernel": "ssd_fwd_mmaILi32ELi64ELb1E", "instructions": 5,
        "HMMA": 2, "FFMA": 0, "MUFU": 1}
    with pytest.raises(smoke.SmokeFailure, match="no function like"):
        smoke.sass_loops(SASS, "flash_fwd")


SCAN_BWD_SASS = """\
        code for sm_90a
        Function : _ZN1a16scan_bwd_clusterI13__nv_bfloat16Li16EEEvPK
        /*0000*/                   LDS.64 R2, [R4] ;
        /*0010*/                   MUFU.EX2 R5, R4 ;
        /*0020*/                   FFMA R6, R5, R6, R7 ;
        /*0030*/                   MUFU.EX2 R8, R4 ;
        /*0040*/               @P1 BRA 0x0 ;
        /*0050*/                   MUFU.EX2 R5, R4 ;
        /*0060*/                   SHFL.BFLY PT, R7, R6, 0x10, 0x1f ;
        /*0070*/                   FADD R6, R6, R7 ;
        /*0080*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0090*/               @P2 BRA 0x50 ;
        /*00a0*/               @P3 BRA 0x0 ;
        /*00b0*/                   EXIT ;
        Function : _ZN1a8scan_bwdI13__nv_bfloat16Li16EEEvPK
        /*0000*/                   MUFU.EX2 R5, R4 ;
        /*0010*/                   REDG.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R5 ;
        /*0020*/               @P0 BRA 0x0 ;
        /*0030*/                   MUFU.EX2 R5, R4 ;
        /*0040*/               @P0 BRA 0x30 ;
        /*0050*/                   EXIT ;
"""


def test_chip_smoke_counts_the_scan_backwards_inner_loops():
    """Phase 1 reads the selective-scan backward's two inner loops from its
    SASS (its two shortest loops with an exponential: the first pass, 7/8
    of a tile's steps, and the sub-tile loop) and its global atomics and
    bulk reduce-adds, which the design has none of; the first design's
    entry, counted the same way, has its atomics."""
    smoke = _chip_smoke()
    assert smoke.MAIN_ENTRIES["selective_scan_bwd"] == \
        "scan_bwd_clusterI13__nv_bfloat16Li16E"
    got = smoke.scan_bwd_loop_counts(SCAN_BWD_SASS)
    assert got == {"first_pass": {"instructions": 5, "mufu": 2},
                   "sub_tile": {"instructions": 5, "mufu": 1},
                   "per_state_step": 7 / 8 * 5 / 2 + 5,
                   "REDG": 0, "ATOMG": 0, "UTMAREDG": 0}
    first = smoke.scan_bwd_loop_counts(SCAN_BWD_SASS,
                                       "scan_bwdI13__nv_bfloat16Li16E")
    assert first["REDG"] == 1 and first["first_pass"]["mufu"] == 1


def test_round_split_reads_a_trace():
    """Phase 6d's reading of a chrome trace: the union of the device
    operations over the span from the profiled round's start to the end of
    its last device operation, and the top operations by time."""
    cs = _chip_smoke()
    events = [
        {"ph": "X", "cat": "kernel", "name": "early", "ts": 0, "dur": 50},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#2",
         "ts": 100, "dur": 60},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 110, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 120, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 170, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 105,
         "dur": 90}]
    row = cs.round_split(events, "synthetic", top=2)
    assert row["span_ms"] == 0.1 and row["device_ops"] == 3
    assert abs(row["device_busy_ms"] - 0.06) < 1e-12
    assert abs(row["idle_share"] - 0.4) < 1e-12
    assert [t["name"] for t in row["top"]] == ["copy", "a"]
    with pytest.raises(cs.SmokeFailure):
        cs.round_split(events[2:], "no step")


def test_same_history_is_bitwise():
    cs = _chip_smoke()
    from repro_torch.federated.server import FLHistory
    a = FLHistory(round=[1, 2], train_loss=[float("nan"), 0.5],
                  budget_exhausted_round=None)
    b = FLHistory(round=[1, 2], train_loss=[float("nan"), 0.5],
                  budget_exhausted_round=None)
    assert cs.same_history(a, b)
    b.train_loss[1] = 0.5000001
    assert not cs.same_history(a, b)
    b.train_loss[1], b.budget_exhausted_round = 0.5, 2
    assert not cs.same_history(a, b)


def test_chip_smoke_flush_check_reads_the_event_clock():
    """Phase 6e's host recomputation of a flush: the earliest arrivals,
    equal times lowest index first; a flush in the other tie order, a
    wrong staleness or an undamped weight fails it."""
    import numpy as np
    smoke = _chip_smoke()
    inf = float("inf")
    t_done = np.array([5.0, inf, 2.0, 5.0, 2.0, 9.0], np.float32)
    start = np.array([0, 0, 1, 0, 2, 1], np.int32)
    before = (t_done, start, 2)
    done, stale = smoke.expected_flush(*before, 3)
    assert done.tolist() == [2, 4, 0] and stale.tolist() == [1, 0, 2]
    flush = {"completed": np.array([2, 4, 0]),
             "comp_chosen": np.ones(3, bool),
             "succeeded": np.array([True, True, False]),
             "staleness": np.array([1, 0, 2]),
             "agg_weight": np.array([2 ** -0.5, 1.0, 0.0], np.float32)}
    assert smoke.check_flush(flush, before, 3, 0.5, "cpu") == 2
    for name, bad in (("completed", np.array([4, 2, 0])),
                      ("completed", np.array([2, 4, 3])),
                      ("staleness", np.array([1, 1, 2])),
                      ("agg_weight", np.array([1.0, 1.0, 0.0], np.float32))):
        with pytest.raises(smoke.SmokeFailure):
            smoke.check_flush(dict(flush, **{name: bad}), before, 3, 0.5,
                              "cpu")


def test_chip_faults_async_faults_replace_live_functions():
    """Each planted async fault names a function its module reads, and
    changes what that function returns."""
    import importlib
    _chip_smoke()
    faults = _load("chip_faults").ASYNC_FAULTS
    assert set(faults) == {"flush_ties_highest_index_first",
                           "ring_lookup_one_version_off",
                           "damping_exponent_dropped"}
    from repro_torch.federated.async_server import _ring_create, \
        _ring_retain
    ring = _ring_retain(_ring_create({"w": torch.zeros(2)}, 3),
                        torch.tensor(4, dtype=torch.int32),
                        {"w": torch.ones(2)},
                        torch.tensor(1, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int64))
    ring = _ring_retain(ring, torch.tensor(5, dtype=torch.int32),
                        {"w": torch.ones(2)},
                        torch.tensor(1, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int64))
    inputs = {"_top_k_idx": (torch.tensor([1.0, 2.0, 2.0, 0.0]), 2),
              "_ring_lookup": (ring, torch.tensor([5, 4])),
              "staleness_damping": (torch.tensor([0, 1, 3]), 0.5)}
    for module, attr, make_fault, phase in faults.values():
        sound = getattr(importlib.import_module(module), attr)
        args = inputs[attr]
        assert phase in ("6e", "6f")
        assert not torch.equal(make_fault(sound)(*args), sound(*args)), attr


def test_chip_faults_shard_faults_replace_live_functions():
    """Each planted fault of the sharded engines names a function each of
    its modules reads, and changes what that function returns."""
    import importlib
    from repro_torch.launch.mesh import ClientMesh
    _chip_smoke()
    faults = _load("chip_faults").SHARD_FAULTS
    assert set(faults) == {"per_shard_leg_index_offset_dropped",
                           "merge_ties_highest_index_first",
                           "slot_gather_two_owners"}
    a, b = torch.tensor([0.5, 0.9, 0.1]), torch.tensor([0.2, 0.3, 0.4])
    # (args, keywords, the part of the result the fault changes)
    inputs = {
        "topk_reward": ((a, b, torch.ones(3, dtype=torch.bool)),
                        dict(f=0.25, k=2, index_offset=6), lambda r: r[1]),
        # equal values in both shards: the merge keeps the lower index
        "_merge_candidates": ((torch.tensor([[2.0, 1.0], [2.0, 0.0]]),
                               torch.tensor([[0, 1], [2, 3]]), 2,
                               ClientMesh(2)), {}, lambda r: r),
        "_slot_owner": ((torch.tensor([0, 3]), torch.tensor([0, 2]), 2), {},
                        lambda r: r[0]),
    }
    for modules, attr, make_fault, phase in faults.values():
        assert phase == "6k"
        sound = getattr(importlib.import_module(modules[0]), attr)
        for module in modules:
            assert getattr(importlib.import_module(module), attr) is sound
        args, kw, part = inputs[attr]
        assert not torch.equal(part(make_fault(sound)(*args, **kw)),
                               part(sound(*args, **kw))), attr


def test_chip_smoke_reads_each_rounds_pulled_k():
    """Phase 6h holds each round's top-k launch at the k its pulled arm
    sets, the config's where the arm inherits it."""
    from repro_torch.federated.controller import Arm
    from repro_torch.federated.server import FLHistory
    arms = (Arm(k=5), Arm(), Arm(k=20, staleness_power=0.5))
    hist = FLHistory(controller_arm=[0, 1, 2, 1])
    assert _chip_smoke().pulled_k(hist, arms, 10) == [5, 10, 20, 10]


def test_chip_smoke_scan_backward_bounds():
    """The bounds chip_smoke prints for the scan backward kernels at their
    train steps' shapes: the SSD's by its 419,430,400 bytes (0.1252 ms;
    its nine products a chunk and head are 77.3 GFLOP), the selective
    scan's by its 2,147,483,648 exponentials (0.5136 ms at 132 SMs and
    1,980 MHz), above its 1.34 GB."""
    smoke = _chip_smoke()
    bf = dict(dtype=torch.bfloat16, device="meta")
    f32 = dict(dtype=torch.float32, device="meta")
    x = torch.empty(4, 4096, 64, 64, **bf)
    bc = torch.empty(4, 4096, 128, **bf)
    Bm, Cm = bc[..., :64], bc[..., 64:]
    dt = torch.empty(4, 4096, 64, **f32)
    A = torch.empty(64, **f32)
    ms, by = smoke.ssd_bwd_bound(x, Bm, Cm, dt, A, x)
    nbytes = 3 * x.nbytes + 4 * Bm.nbytes + 2 * dt.nbytes + 2 * A.nbytes
    assert by == "bytes" and nbytes == 419_430_912
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    flops = 2 * 64 * (64 * (3 * 64 + 2 * 64) + 4 * 64 * 64) * 64 * 4 * 64
    assert flops == 77_309_411_328
    xs = torch.empty(4, 4096, 8192, **bf)
    packed = torch.empty(4, 4096, 288, **bf)
    sA = torch.empty(8192, 16, **f32)
    D = torch.empty(8192, **f32)
    ms, by = smoke.scan_bwd_bound(xs, xs, packed[..., 256:272],
                                  packed[..., 272:], sA, D, xs, 132, 1.98e9)
    assert by == "operations"
    assert ms == pytest.approx(2_147_483_648 / (16 * 132 * 1.98e9) * 1e3)
    assert 5 * xs.nbytes == 1_342_177_280


def test_chip_smoke_tight_backward_checks():
    """The tight check of a backward call: the f32 gradients of bf16
    inputs rounded to bf16 pass it; a bf16 gradient 5% too large, an f32
    one 1e-3 off, or a NaN fail it; a bf16 gradient of fewer than
    ``TIGHT_MIN_SIZE`` entries is not held; a gradient that is exactly
    zero reads 0."""
    smoke = _chip_smoke()
    from repro_torch.kernels import ref
    dev = torch.device("cpu")
    args = smoke.scan_inputs(torch, 2, 70, 96, 16, torch.bfloat16, dev, 0)
    dy = smoke.output_grad(torch, (2, 70, 96), torch.bfloat16, dev, 1)
    exact = ref.selective_scan_bwd(*(a.float() for a in args), dy.float())
    grads = [e.to(a.dtype) for e, a in zip(exact, args)]
    names = smoke.SCAN_BWD_NAMES
    rel = smoke.hold_grads(torch, grads, exact, names, "plain")
    assert 0 < rel["dx"] <= smoke.SCAN_BWD_BF16_REL_L2
    assert rel["dA"] == 0.0 and rel["dD"] == 0.0
    for i, bad in ((0, grads[0] * 1.05), (4, grads[4] * (1 + 1e-3)),
                   (5, grads[5] * float("nan"))):
        worse = list(grads)
        worse[i] = bad
        with pytest.raises(smoke.SmokeFailure, match="relative L2"):
            smoke.hold_grads(torch, worse, exact, names, "fault")
    small = list(grads)
    small[2] = grads[2][:, :1] * 1.05        # 32 entries: not held
    smoke.hold_grads(torch, small, [e[:, :1] if i == 2 else e
                                    for i, e in enumerate(exact)],
                     names, "small")
    zero = torch.zeros(3)
    assert smoke.grad_readings(torch, [zero], [zero], ["z"]) == {"z": 0.0}


def test_chip_smoke_case_failures_name_each_case():
    """Phase 21 runs every case and fails naming each case that failed
    (chip_faults.py reads them to tell which route a fault broke); the
    SSD backward's main entries are its two bf16 kernels, each read from
    ptxas's report."""
    smoke = _chip_smoke()
    err = smoke.CaseFailures("phase 21", {"1x64 bfloat16": "dx off",
                                          "1x65 bfloat16": "dB off"})
    assert isinstance(err, smoke.SmokeFailure)
    assert list(err.cases) == ["1x64 bfloat16", "1x65 bfloat16"]
    assert "2 cases" in str(err) and "dx off" in str(err)
    entries = smoke.MAIN_ENTRIES["ssd_chunk_bwd"]
    report = "".join(
        f"ptxas info    : Compiling entry function '_Z{e}Ev' for 'sm_90a'\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used {r} registers\n"
        for e, r in zip(entries, (96, 245)))
    use = smoke.entry_usage(smoke.ptxas_usage(report), entries)
    assert use == {entries[0]: {"entries": 1, "registers": 96,
                                "spill_bytes": 0},
                   entries[1]: {"entries": 1, "registers": 245,
                                "spill_bytes": 0}}


def test_chip_smoke_scan_train_step_plan():
    """The launches a scan arch's train step must make: each scan layer's
    forward twice (the step and the remat recompute), its backward once;
    zamba2-1.2b's shared attention block 6 times each way."""
    smoke = _chip_smoke()
    from repro_torch.configs import get_config
    pair, want = smoke.scan_step_plan(get_config("zamba2-1.2b"),
                                      "zamba2-1.2b")
    assert pair == ("ssd_chunk", "ssd_chunk_bwd") and want == {
        "ssd_chunk": 76, "ssd_chunk_bwd": 38, "flash_attention": 6,
        "flash_attention_bwd": 6}
    cfg = get_config("falcon-mamba-7b").with_(
        n_layers=smoke.FALCON_TRAIN_DEPTH)
    assert smoke.scan_step_plan(cfg, "falcon-mamba-7b")[1] == {
        "selective_scan": 32, "selective_scan_bwd": 16}


def test_chip_smoke_dense_train_plan():
    """The dense and MLA archs' train steps: each cut keeps the arch's
    width and at most its depth, and a step launches the attention
    forward twice a layer (the step and the remat recompute) and its
    backward once; each new width pair of the prefills is built."""
    smoke = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    assert set(smoke.DENSE_TRAIN_CUT) == set(smoke.DENSE_ARCHS)
    for arch, (layers, rows) in smoke.DENSE_TRAIN_CUT.items():
        cfg = get_config(arch)
        assert layers <= cfg.n_layers and 1 <= rows <= smoke.TRAIN_BATCH
        assert smoke.attention_step_plan(cfg.with_(n_layers=layers)) == {
            "flash_attention": 2 * layers, "flash_attention_bwd": layers}
    assert {(D, Dv) for *_, D, Dv in smoke.WIDTH_SHAPES} <= set(HEAD_DIMS)


@pytest.mark.parametrize("fault", ["ssd_chunk_decay_dropped",
                                   "ssd_da_term_dropped", "ssd_db_one_head",
                                   "ssd_carry_decay_dropped",
                                   "ssd_local_da_terms_dropped",
                                   "ssd_local_db_one_head",
                                   "ssd_local_dm_low_part_dropped",
                                   "scan_tile_decay_dropped",
                                   "scan_da_term_dropped",
                                   "scan_db_one_cta",
                                   "scan_rank_part_dropped",
                                   "scan_prefetch_current_tile",
                                   "scan_spare_block_unused",
                                   "scan_channel_round_dropped",
                                   "scan_sub0_state_stale"])
def test_chip_faults_plant_into_the_scan_backward(fault):
    """Each planted fault of a scan backward kernel edits text that occurs
    once in its source, inside the kernel (after its definition: the SSD's
    scalar f32 kernel, its bf16 carry pass or its chunk-local kernel, the
    selective scan's ``scan_bwd_cluster``), and its library's phase of
    chip_smoke.py is the one that must catch it."""
    smoke = _chip_smoke()
    faults = _load("chip_faults")
    lib, edits = faults.SCAN_BWD_FAULTS[fault]
    fn = (faults.SSD_BWD_FAULT_KERNELS[fault][0] if lib == "ssd_chunk_bwd"
          else "scan_bwd_cluster(")
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
           f"{lib}.cu").read_text()
    for old, new in edits:
        assert src.count(old) == 1 and old != new
        assert src.index(old) > src.index(fn)
    assert hasattr(smoke, faults.SCAN_BWD_PHASES[lib])


def test_chip_smoke_moe_serving_plan():
    """The MoE phases: each serving cut keeps the arch's width and at most
    its depth, its f32 weights at most 57 GB (the reckoning beside
    ``MOE_SERVE_CUT``), and its first two layers hold an MoE layer (the
    f32 route comparison); phase 32's shapes are the pair (192, 128), which
    both libraries are built for, deepseek's prefill among them; the train
    cut (``MOE_TRAIN_CUT``) keeps deepseek's dense first layer alone, its
    AdamW state (16 bytes a parameter) within the 13.80 GB of its
    reckoning, and the routes' depth reaches its first MoE layer."""
    smoke = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS, HEAD_DIMS
    assert set(smoke.MOE_SERVE_CUT) == set(smoke.MOE_ARCHS)
    for arch, layers in smoke.MOE_SERVE_CUT.items():
        cfg = get_config(arch)
        cut = cfg.with_(n_layers=layers)
        assert layers <= cfg.n_layers and smoke.moe_layers(cut) >= 1
        assert 4 * cut.param_count() <= 57e9
        assert smoke.moe_layers(cut.with_(n_layers=smoke.ROUTE_DEPTH)) >= 1
    assert {(D, Dv) for *_, D, Dv in smoke.WIDE_SHAPES} == {(192, 128)}
    assert (192, 128) in HEAD_DIMS and (192, 128) in BWD_HEAD_DIMS
    ds = get_config("deepseek-v2-236b")
    assert (smoke.PREFILL_BATCH, smoke.PREFILL_LEN, ds.n_heads, ds.n_heads,
            ds.qk_nope_dim + ds.qk_rope_dim, ds.v_head_dim) \
        in smoke.WIDE_SHAPES
    assert set(smoke.MOE_TRAIN_CUT) == {smoke.MOE_TRAIN_ARCH}
    layers, rows = smoke.MOE_TRAIN_CUT[smoke.MOE_TRAIN_ARCH]
    cut = ds.with_(n_layers=layers)
    assert smoke.moe_layers(cut) == 0 and rows == smoke.TRAIN_BATCH
    assert cut.param_count() == 862_257_152
    assert 16 * cut.param_count() <= 13.80e9
    assert smoke.moe_layers(ds.with_(n_layers=smoke.ROUTE_DEPTH)) == 1


@pytest.mark.parametrize("B,S,H,KH,budget", [
    (1, 40, 6, 6, 10**9), (2, 37, 6, 3, 2 * 2 * 37 * 37),
    (1, 33, 8, 8, 3 * 33 * 33), (2, 20, 4, 1, 1)])
def test_chip_smoke_plain_backward_by_head_slices(monkeypatch, B, S, H, KH,
                                                  budget):
    """``plain_bwd`` over slices of the KV heads (each with its query
    heads) equals one call of the plain backward, whether the slices
    divide the heads or not, and a budget below one slice still takes
    one KV head at a time."""
    smoke = _chip_smoke()
    from repro_torch.kernels import ref
    monkeypatch.setattr(smoke, "PLAIN_BWD_SCORES", budget)
    g = torch.Generator().manual_seed(S + H)
    q = torch.randn(B, S, H, 24, generator=g)
    k = torch.randn(B, S, KH, 24, generator=g)
    v = torch.randn(B, S, KH, 16, generator=g)
    do = torch.randn(B, S, H, 16, generator=g)
    o, lse = ref.flash_attention_fwd_lse(q, k, v, causal=True)
    whole = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    parts = smoke.plain_bwd(torch, ref, q, k, v, o, lse, do, causal=True)
    for got, exp in zip(parts, whole):
        assert got.shape == exp.shape
        torch.testing.assert_close(got, exp, atol=1e-6, rtol=1e-6)


def test_chip_smoke_reads_the_wide_backward_entry():
    """Phase 1 reads the backward's registers at (192, 128) from its own
    design's entry and finds ptxas's report of serialized wgmmas there."""
    smoke = _chip_smoke()
    assert smoke.bf16_entry("flash_attention_bwd", 192) == \
        "flash_bwd_wgmma_wide"
    assert smoke.bf16_entry("flash_attention_bwd", 128) == "flash_bwd_wgmma"
    assert smoke.bf16_entry("flash_attention", 192) == "flash_fwd_wgmma"
    name = "_ZN4abcd20flash_bwd_wgmma_wideILi192ELi128EEEv"
    report = ("ptxas info    : (C7511) Potential Performance Loss: "
              "wgmma.mma_async instructions are serialized due to "
              f"insufficient register resources in the function '{name}'")
    assert smoke.wgmma_serialized(report, "flash_bwd_wgmma_wide")
    assert not smoke.wgmma_serialized(report.replace("C7511", "C0000"),
                                      "flash_bwd_wgmma_wide")
    assert not smoke.wgmma_serialized(report, "flash_fwd_wgmma")


def test_chip_smoke_logit_diff_by_parts():
    """The logits' readings, taken a few positions at a time, equal the
    whole tensors' (the MoE phases' f32 logits pass 6 GB a copy)."""
    smoke = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    exp = torch.randn(2, 37, 50, generator=g)
    got = (exp + 0.01 * torch.randn(2, 37, 50, generator=g)).bfloat16()
    d = got.float() - exp
    for rows in (8, 256):
        parts = smoke.logit_diff(torch, got, exp, "x", rows=rows)
        assert parts["max_abs"] == float(d.abs().max())
        assert parts["argmax_agree"] == float(
            (got.float().argmax(-1) == exp.argmax(-1)).double().mean())
        assert abs(parts["rel_l2"] - float(d.norm() / exp.norm())) \
            <= 1e-6 * parts["rel_l2"]
    with pytest.raises(smoke.SmokeFailure, match="non-finite"):
        smoke.logit_diff(torch, got.float().log(), exp, "x", rows=8)


def test_chip_smoke_records_each_moe_layers_routing():
    """The routes the MoE phases compare: one record a MoE layer, in
    order; the same forward twice routes alike; the first two layers of a
    cut (``first_layers``) are the stages' first layers, not copies."""
    smoke = _chip_smoke()
    from repro_torch.configs import get_reduced
    from repro_torch.models import forward_logits, init_params
    cfg = get_reduced("deepseek-v2-236b").with_(n_layers=3)
    params = init_params(0, cfg, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16))}
    runs = []
    for margins in (False, True):
        with smoke.recorded_routes(torch, margins=margins) as calls:
            forward_logits(cfg, params, batch, device="cpu")
        runs.append(calls)
    assert len(runs[0]) == len(runs[1]) == smoke.moe_layers(cfg) == 2
    assert smoke.flipped_share(*runs) == [0.0, 0.0]
    assert all(r["margin"] >= 0 for r in runs[1])
    cut, p2 = smoke.first_layers(cfg, params, 2)
    assert cut.n_layers == 2 and [len(st) for st in p2["stages"]] == [1, 1]
    assert p2["stages"][1][0] is params["stages"][1][0]


def test_scan_covers_the_dryrun_slice():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for mod in ("kernels/counting.py", "launch/specs.py",
                "launch/roofline.py", "launch/dryrun.py"):
        assert f"src/repro_torch/{mod}" in names


def test_dryrun_needs_cuda_or_an_explicit_cpu_and_sets_nothing():
    """Importing the dry-run sets no environment variable (the
    reference's forces 512 host devices); tracing without ``device=``
    means the card, and raises with none."""
    import importlib
    import os

    before = dict(os.environ)
    dryrun = importlib.reload(importlib.import_module(
        "repro_torch.launch.dryrun"))
    assert dict(os.environ) == before
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch.configs import INPUT_SHAPES, get_reduced
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.trace_one(get_reduced("olmo-1b"), INPUT_SHAPES["decode_32k"])


def test_chip_smoke_phase43_cases_round_trip():
    """Phase 43's rows rebuild its cases (to run it again alone), and the
    spec check names the card it refuses."""
    smoke = _chip_smoke()
    from repro_torch.configs import get_config
    case = smoke.dryrun_train_case("phi3-mini-3.8b", get_config(
        "phi3-mini-3.8b").with_(n_layers=16), {"step_s": [9.0, 0.75, 0.25, 0.5],
                                               "peak_gib": 57.0})
    assert (case["measured_s"], case["best_s"], case["rows"]) == (
        0.5, 0.25, smoke.TRAIN_BATCH)
    row = {"label": case["label"], "arch": "phi3-mini-3.8b", "layers": 16,
           **{k: case[k] for k in ("mode", "rows", "len", "measured_s",
                                   "best_s", "measured_peak_gib")}}
    (back,) = smoke.dryrun_cases_from([row])
    assert back["cfg"] == case["cfg"] and {
        k: v for k, v in back.items() if k != "cfg"} == {
        k: v for k, v in case.items() if k != "cfg"}
