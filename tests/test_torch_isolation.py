"""The port stands alone: no JAX, no reference package, no silent CPU.

An AST scan of every ``src/repro_torch/**/*.py`` and ``chip_smoke.py``
fails on any import of ``jax``/``jaxlib`` or of ``repro`` other than
``repro_torch``. Entry points called without ``device=`` raise when no
CUDA device is present."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


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


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
