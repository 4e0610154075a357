"""The dry-run's FLOP count against the reference's, on the CPU.

The port's count of a step (``launch/dryrun.py::trace_one`` on fake CPU
tensors: ``FlopCounterMode`` over the aten operations, each kernel's fake
route reporting its plain version's count) against the reference's
``parse_hlo`` dot FLOPs of the same step compiled on one CPU device
(``jax.jit(step).lower(specs).compile()``; the reference's dry-run module
is not imported: it forces 512 host devices). At the reduced configs:
prefill for the ten archs, train for olmo-1b, zamba2-1.2b,
falcon-mamba-7b and deepseek-v2-236b, decode for two archs, and a train
step of S above ``Q_CHUNK``.

They agree exactly but for what the two programs compute differently,
each a closed formula (:func:`port_minus_reference`, explained in
PERF.md):

- attention, train, S <= ``Q_CHUNK``: the backward kernel's plain version
  recomputes the scores q k^T (2 B H S^2 Dqk a layer); the reference's
  autodiff of one chunk keeps them. Above ``Q_CHUNK`` the reference's
  ``jax.checkpoint`` on each query chunk recomputes them too: no
  difference.
- Mamba2: the reference's chunked SSD (chunk Q) counts C B^T, the
  intra-chunk product and two state products, 2 B S Q ds + 2 B S Q nh hd
  + 4 B S nh hd ds, where the kernel's plain version (a recurrence)
  counts 2 B S nh hd ds; in training its autodiff doubles the chunked
  count and the remat recompute adds it again, against the kernel's
  backward formula 6 B S nh hd ds.
- Mamba1, train: the backward kernel's plain version forms dB_t as a
  product (2 B di ds a step); the reference's autodiff reduces the
  elementwise outer product instead, no dot.
- MoE: the reference dispatches and combines by one-hot einsums, 2 B S E
  C D each; the port gathers, and combines by a (1, K) x (K, D) product a
  token, 2 B S K D. Training: six one-hot products a layer in the
  reference (the recompute's combine is dead code to XLA), four combines
  in the port (forward, recompute, two in the backward).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.configs.base import InputShape as JShape  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.roofline import parse_hlo  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.attention import Q_CHUNK  # noqa: E402
from repro_torch.models.mamba import SSD_CHUNK  # noqa: E402
from repro_torch.models.moe import expert_capacity  # noqa: E402


def reference_dot_flops(arch: str, mode: str, B: int, S: int) -> float:
    cfg, shape = jget_reduced(arch), JShape("t", S, B, mode)
    params = jspecs.params_specs(cfg)
    batch = jspecs.input_specs(cfg, shape)
    if mode == "train":
        opt = jsteps.default_optimizer()
        lowered = jax.jit(jsteps.make_train_step(cfg, opt)).lower(
            params, jax.eval_shape(opt.init, params), batch)
    elif mode == "prefill":
        lowered = jax.jit(jsteps.make_prefill_step(cfg)).lower(params, batch)
    else:
        lowered = jax.jit(jsteps.make_serve_step(cfg, ring=False)).lower(
            params, batch, jspecs.cache_specs(cfg, shape),
            jax.ShapeDtypeStruct((), jnp.int32))
    return parse_hlo(lowered.compile().as_text()).dot_flops


def attention_calls(cfg) -> int:
    """Attention layers a forward runs (zamba2: its shared block's calls)."""
    if cfg.arch_type == "ssm":
        return 0
    if cfg.arch_type == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def port_minus_reference(cfg, mode: str, B: int, S: int) -> int:
    """The port's dot FLOPs less the reference's, by the module
    docstring's formulas."""
    d = 0
    if mode == "train" and S <= Q_CHUNK:
        dqk = (cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.attn_kind == "mla"
               else cfg.resolved_head_dim)
        d += attention_calls(cfg) * 2 * B * cfg.n_heads * S * S * dqk
    if cfg.ssm_variant == "mamba2" and mode != "decode":
        nh, hd, ds, Q = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state, \
            min(SSD_CHUNK, S)
        chunked = (2 * B * S * Q * ds + 2 * B * S * Q * nh * hd
                   + 4 * B * S * nh * hd * ds)
        kernel = 2 * B * S * nh * hd * ds
        if mode == "prefill":
            d -= cfg.n_layers * (chunked - kernel)
        else:
            d -= cfg.n_layers * (4 * chunked - 2 * kernel
                                 - 6 * B * S * nh * hd * ds)
    if cfg.ssm_variant == "mamba1" and mode == "train":
        d += cfg.n_layers * 2 * B * S * cfg.d_inner * cfg.ssm_state
    if cfg.n_experts and mode != "decode":
        E, K, D = cfg.n_experts, cfg.experts_per_token, cfg.d_model
        C = expert_capacity(cfg, S)
        n_moe = cfg.n_layers - cfg.first_k_dense
        onehot, combine = 2 * B * S * E * C * D, 2 * B * S * K * D
        d -= n_moe * ((2 * onehot - combine) if mode == "prefill"
                      else (6 * onehot - 4 * combine))
    return d


CASES = ([(arch, "prefill", 2, 256) for arch in ARCH_IDS]
         + [(arch, "train", 2, 256) for arch in (
             "olmo-1b", "zamba2-1.2b", "falcon-mamba-7b",
             "deepseek-v2-236b")]
         + [(arch, "decode", 2, 256) for arch in ("olmo-1b", "minicpm3-4b")]
         + [("olmo-1b", "train", 1, 2 * Q_CHUNK)])


@pytest.mark.parametrize("arch,mode,B,S", CASES,
                         ids=[f"{a}-{m}-{b}x{s}" for a, m, b, s in CASES])
def test_dot_flops_match_the_reference(arch, mode, B, S):
    cfg = get_reduced(arch)
    _, count = dryrun.trace_one(cfg, InputShape("t", S, B, mode), "cpu")
    expect = reference_dot_flops(arch, mode, B, S) + port_minus_reference(
        cfg, mode, B, S)
    assert count.dot_flops == expect, count.flops_by_op


def test_the_formulas_are_not_empty():
    """Each difference the docstring names is met by a case at 2 x 256."""
    by = {(a, m): port_minus_reference(get_reduced(a), m, b, s)
          for a, m, b, s in CASES if s == 256}
    assert by[("olmo-1b", "prefill")] == 0 and by[("olmo-1b", "decode")] \
        == 0
    assert port_minus_reference(get_reduced("olmo-1b"), "train", 1,
                                2 * Q_CHUNK) == 0
    assert by[("olmo-1b", "train")] > 0
    assert by[("zamba2-1.2b", "prefill")] < 0 and by[("zamba2-1.2b",
                                                      "train")] < 0
    assert by[("falcon-mamba-7b", "train")] > 0
    assert by[("falcon-mamba-7b", "prefill")] == 0
    assert by[("deepseek-v2-236b", "prefill")] < 0
    assert by[("llama4-scout-17b-a16e", "prefill")] < 0
