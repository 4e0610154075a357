"""The port's dry-run against the reference's, on the CPU: the specs
(``launch/specs.py``), the roofline (``launch/roofline.py``) and the CLI
(``python -m repro_torch.launch.dryrun``).

- specs: at full width, for the ten archs and the four input shapes, the
  batch and the cache have the reference's shapes and dtypes (the
  reference's ``jax.ShapeDtypeStruct`` trees, runs of layers unstacked);
  the parameters the reference's ``jax.eval_shape`` in leaf count (a
  stacked leaf counts once a layer), elements and bytes; at the reduced
  configs every parameter leaf is the reference's real one through
  ``convert.lm_params``.
- roofline: ``model_flops`` and ``analytic_memory_bytes`` equal the
  reference's for every arch, shape and 1, 256 or 512 devices; ``analyze``
  gives the reference's terms, dominant term and useful ratio when both
  are fed the same FLOPs and the reference's ``TPU_V5E``.
- the CLI on fake CPU tensors, and its refusal of the pod meshes.

The reference's ``repro.launch.dryrun`` is never imported: it forces 512
host devices on the process."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import TPU_V5E  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import H100_SXM, HardwareSpec  # noqa: E402
from repro_torch.launch import dryrun, roofline, specs  # noqa: E402
from repro_torch.models.transformer import build_stages  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def walk(tree, path=()):
    """``(path, leaf)`` of a nested dict / list tree, dict keys sorted,
    ``None`` leaves skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from walk(t, path + (i,))
    elif tree is not None:
        yield path, tree


def port_meta(tree):
    return {p: (tuple(t.shape), _name(t.dtype)) for p, t in walk(tree)}


def reference_meta(stages_tree, cfg, top=None):
    """The reference's tree of ``ShapeDtypeStruct`` as the port lays it
    out: each run of layers' stacked leaves unstacked into a list of
    per-layer dicts (``convert.lm_params``' mapping)."""
    out = {}
    for i, ((kind, n), st) in enumerate(zip(build_stages(cfg),
                                            stages_tree)):
        for p, leaf in walk(st):
            meta = (tuple(leaf.shape), str(np.dtype(leaf.dtype)))
            if kind == "shared_attn":
                if top == "stages":   # its weights live in shared_attn
                    continue
                out[(i,) + p] = meta
                continue
            assert leaf.shape[0] == n
            for layer in range(n):
                out[(i, layer) + p] = (meta[0][1:], meta[1])
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inputs_and_caches_match_the_reference_at_full_width(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    with FakeTensorMode():
        for name, shape in INPUT_SHAPES.items():
            jshape = JSHAPES[name]
            got = specs.input_specs(cfg, shape, "cpu")
            exp = jspecs.input_specs(jcfg, jshape)
            assert {k: (tuple(v.shape), _name(v.dtype))
                    for k, v in got.items()} == {
                k: (tuple(v.shape), str(np.dtype(v.dtype)))
                for k, v in exp.items()}, (arch, name)
            assert specs.cache_len_for(cfg, shape) == \
                jspecs.cache_len_for(jcfg, jshape)
            if shape.mode != "decode":
                continue
            got = port_meta(specs.cache_specs(cfg, shape, "cpu"))
            exp = reference_meta(jspecs.cache_specs(jcfg, jshape), cfg)
            assert got == exp, (arch, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_match_the_reference_at_full_width(arch):
    """Leaf count (a stacked leaf once a layer), elements and bytes of
    ``params_specs`` equal the reference's ``jax.eval_shape`` tree."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    ref = jspecs.params_specs(jcfg)
    exp = reference_meta(ref["stages"], cfg, top="stages")
    for k, v in ref.items():
        if k != "stages":
            exp.update({(k,) + p: (tuple(t.shape), str(np.dtype(t.dtype)))
                        for p, t in walk(v)})
    with FakeTensorMode():
        got = list(walk(specs.params_specs(cfg, "cpu")))
        assert all(t.device.type == "cpu" for _, t in got)
        got = [(tuple(t.shape), t.numel(), t.numel() * t.element_size())
               for _, t in got]

    def elements(shape):
        return int(np.prod(shape, dtype=np.int64))

    assert len(got) == len(exp)
    assert sum(n for _, n, _ in got) == sum(elements(s) for s, _ in
                                            exp.values())
    assert sum(b for _, _, b in got) == sum(
        elements(s) * np.dtype(d).itemsize for s, d in exp.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_match_the_reference_leaf_for_leaf_at_the_reduced_size(arch):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    tree = jax.jit(lambda key: jinit_params(key, jcfg))(
        jax.random.PRNGKey(0))
    ref = convert.lm_params(tree, cfg, device="cpu")
    with FakeTensorMode():
        got = port_meta(specs.params_specs(cfg, "cpu"))
    assert got == port_meta(ref)


def test_specs_describe_the_asked_device_and_need_a_fake_mode():
    cfg, shape = get_reduced("zamba2-1.2b"), INPUT_SHAPES["decode_32k"]
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        specs.input_specs(cfg, shape, "cpu")
    with FakeTensorMode():
        p = specs.params_specs(cfg, "cuda")
        c = specs.cache_specs(cfg, shape, "cuda")
        b = specs.input_specs(cfg, shape)           # the card by default
        leaves = [t for _, t in walk([p, c, b])]
        assert {t.device.type for t in leaves} == {"cuda"}
        with pytest.raises(RuntimeError, match="FakeTensorMode"):
            with torch._subclasses.fake_tensor.unset_fake_temporarily():
                specs.params_specs(cfg, "cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_bytes_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in INPUT_SHAPES.items():
        assert roofline.model_flops(cfg, shape) == \
            jrl.model_flops(jcfg, JSHAPES[name])
        for n_dev in (1, 256, 512):
            assert roofline.analytic_memory_bytes(cfg, shape, n_dev) == \
                jrl.analytic_memory_bytes(jcfg, JSHAPES[name], n_dev)


def hlo_with_dot(m: int, k: int, n: int) -> str:
    """An HLO module of one (m, k) x (k, n) product: 2 m k n dot FLOPs."""
    return (f"HloModule m\n\n"
            f"ENTRY %main.1 (x: f32[{m},{k}], w: f32[{k},{n}]) -> "
            f"f32[{m},{n}] {{\n"
            f"  %x = f32[{m},{k}] parameter(0)\n"
            f"  %w = f32[{k},{n}] parameter(1)\n"
            f"  ROOT %dot.1 = f32[{m},{n}] dot(%x, %w), "
            f"lhs_contracting_dims={{1}}, rhs_contracting_dims={{0}}\n}}\n")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analyze_matches_the_reference_on_the_same_flops(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for dims in ((64, 64, 64), (4096, 8192, 16384), (65536, 65536, 131072)):
        text = hlo_with_dot(*dims)
        flops = jrl.parse_hlo(text).dot_flops
        assert flops == 2 * np.prod(dims, dtype=np.float64)
        for name, shape in INPUT_SHAPES.items():
            for mesh in ((1, 1), (16, 16), (2, 16, 16)):
                exp = jrl.analyze(jcfg, JSHAPES[name], mesh, text, {},
                                  hw=TPU_V5E)
                got = roofline.analyze(cfg, shape, mesh, flops, hw=TPU_V5E)
                assert (got.t_compute, got.t_memory, got.t_collective,
                        got.dominant, got.useful_ratio,
                        got.model_flops_total, got.n_devices) == (
                    exp.t_compute, exp.t_memory, exp.t_collective,
                    exp.dominant, exp.useful_ratio, exp.model_flops_total,
                    exp.n_devices)
                assert got.row() == exp.row()


def test_hardware_spec_keeps_the_reference_fields_with_the_card_rates():
    import dataclasses

    assert [f.name for f in dataclasses.fields(HardwareSpec)] == [
        f.name for f in dataclasses.fields(type(TPU_V5E))]
    assert (H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM.ici_bw) == (
        989e12, 3.35e12, 450e9)
    cfg, shape = get_config("olmo-1b"), INPUT_SHAPES["train_4k"]
    rep = roofline.analyze(cfg, shape, (1, 1), 989e12)
    assert rep.t_compute == 1.0 and rep.collective_bytes_per_dev == 0.0
    assert rep.collective_by_type == {} and rep.peak_mem_bytes is None


def test_trace_one_counts_and_holds_memory_on_the_host_mesh():
    """A reduced train step: the count is the sum of its operations, the
    arguments and the peak are the storages' bytes, and every strategy
    gives the same numbers on one device."""
    cfg = get_reduced("olmo-1b")
    shape = INPUT_SHAPES["train_4k"].__class__("t", 128, 2, "train")
    rep, count = dryrun.trace_one(cfg, shape, "cpu")
    assert count.dot_flops == sum(count.flops_by_op.values()) > 0
    assert set(count.flops_by_op) == {"aten.mm", "flash_attention",
                                      "flash_attention_bwd"}
    n = cfg.param_count()
    # f32 parameters, AdamW's m and v, the int32 step and the batch
    assert count.argument_bytes == 3 * 4 * n + 4 + 2 * 2 * 128 * 4
    assert count.peak_live_bytes > count.argument_bytes + 3 * 4 * n
    assert rep.mesh == (1, 1) and rep.peak_mem_bytes == \
        count.peak_live_bytes
    for strategy in dryrun.STRATEGIES[1:]:
        assert dryrun.trace_one(cfg, shape, "cpu", strategy)[1].flops_by_op \
            == count.flops_by_op
    with pytest.raises(ValueError, match="strategy"):
        dryrun.trace_one(cfg, shape, "cpu", "pipeline")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)


def test_cli_one_pair_on_fake_cpu_tensors(tmp_path):
    out = tmp_path / "dry.jsonl"
    r = _cli("--arch", "olmo-1b", "--shape", "decode_32k", "--device",
             "cpu", "--strategy", "serve_tp", "--serve-dtype", "bf16",
             "--out", str(out))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "dry-run OK: 1 combinations" in r.stdout
    assert "memory_analysis" in r.stdout and "dominant=" in r.stdout
    assert "== olmo-1b x decode_32k x mesh[1, 1] [serve_tp] ==" in r.stdout
    rec = json.loads(out.read_text())
    assert rec["strategy"] == "serve_tp" and rec["device"] == "cpu"
    assert rec["dominant"] == "memory" and rec["collective_bytes_per_dev"] \
        == 0.0 and rec["peak_live_bytes"] >= rec["argument_bytes"] > 0


@pytest.mark.parametrize("mesh", ["single", "multi", "both"])
def test_cli_refuses_the_pod_meshes(mesh):
    r = _cli("--arch", "olmo-1b", "--shape", "decode_32k", "--device",
             "cpu", "--mesh", mesh)
    assert r.returncode != 0
    assert "ValueError" in r.stderr and "ROADMAP.md item 18" in r.stderr
    assert "dry-run OK" not in r.stdout
