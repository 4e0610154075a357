"""The port's LM training against the reference's, on the CPU.

- ``markov_lm_tokens`` and ``lm_batch`` equal the reference's bit for bit
  (the port's threefry draws, the same key chain).
- ``loss_fn``'s loss, ``ce`` and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``loss_fn`` on the reference's
  weights (``convert.lm_params``), for reduced olmo-1b (dense, the
  attention route of the kernel: on the CPU the autograd.Function over the
  plain versions, and the plain route), reduced zamba2-1.2b (the plain
  chunked SSD, or the SSD kernel's autograd.Function over its plain
  forward and backward, and the shared attention block) and reduced
  falcon-mamba-7b (the plain loop over time, or the selective scan's
  autograd.Function), in f32.
- Three ``make_train_step`` AdamW steps of reduced olmo-1b against the
  reference's: losses, parameters and optimizer state
  (``convert.lm_optimizer_state``).
- ``remat=True`` equals ``remat=False``.
- ``train cohort --device cpu`` (olmo-1b, zamba2-1.2b, falcon-mamba-7b)
  and the federated LLM cohort example twin run at a tiny size, their
  losses decreasing.

Tolerances (f32; the frameworks sum in other orders): the loss within
1e-5 relative; each gradient leaf within 5e-5 relative L2 (measured
7.6e-6 at most, zamba2's SSD); after each of three AdamW steps every
parameter within one update (lr = 1e-4) of the reference's and all but
1e-3 of each leaf's entries within 1e-6 (``PARAM_ATOL``), the moments
within 1e-4 relative L2. Batches are 2 x 64 tokens."""
import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.data import lm_batch as jlm_batch  # noqa: E402
from repro.data import markov_lm_tokens as jmarkov  # noqa: E402
from repro.launch.steps import default_optimizer as jdefault_opt  # noqa: E402
from repro.launch.steps import make_train_step as jmake_step  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.data import lm_batch, markov_lm_tokens  # noqa: E402
from repro_torch.examples import federated_llm_cohort  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import (default_optimizer,  # noqa: E402
                                      make_train_step)
from repro_torch.models import loss_fn  # noqa: E402

B, S = 2, 64
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 5e-5
# An AdamW step moves each parameter by about lr = 1e-4 times
# m / (sqrt(v) + eps); where a gradient entry is near eps = 1e-8 that ratio
# follows the last bits of the gradient (measured: after a step, 1 or 2
# entries in 131,072 lie 1.3e-6 to 2.0e-5 apart, from run to run, and a
# leaf's update up to 1.1e-3 apart in relative L2). So no entry may lie
# more than one update (lr) apart, and at most 1e-3 of a leaf's entries
# more than 1e-6.
PARAM_ATOL = 1e-4
PARAM_CLOSE = 1e-6
FAR_SHARE = 1e-3
# The reference's chunked SSD (repro/models/mamba.py:186) masks exp(delta)
# after taking it: above the diagonal exp overflows to inf, and the
# backward's 0 * inf gives NaN in some entries of reduced zamba2's
# gradient (which ones depends on XLA's CPU code: 514 entries of 4 leaves
# in one process, also 15,104 of the embedding in another). The port
# masks the exponent first (repro_torch/models/mamba.py::_ssd_chunked), and
# its gradient must be finite everywhere; it is compared with the
# reference's where that is finite.
REFERENCE_NAN = ("zamba2-1.2b",)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (jget_reduced(arch).with_(compute_dtype=jnp.float32),
            get_reduced(arch).with_(compute_dtype=torch.float32))


def _tensors(tree):
    return [t for t in tree_leaves(tree) if t is not None]


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("seed,batch,seq,vocab", [
    (0, 2, 17, 512), (3, 4, 65, 50304), (11, 1, 1, 32000), (7, 3, 200, 64)])
def test_markov_tokens_bit_exact(seed, batch, seq, vocab):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    exp = np.asarray(jmarkov(jk, batch, seq, vocab))
    got = markov_lm_tokens(convert.key(np.asarray(jk), "cpu"), batch, seq,
                           vocab)
    assert got.dtype == torch.int64 and got.shape == (batch, seq)
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b",
                                  "falcon-mamba-7b"])
def test_lm_batch_bit_exact(arch):
    for i in range(3):
        jk = jax.random.fold_in(jax.random.PRNGKey(4), i)
        exp = jlm_batch(jk, jget_reduced(arch), 3, 33)
        got = lm_batch(prng.fold_in(prng.PRNGKey(4, "cpu"), i),
                       get_reduced(arch), 3, 33)
        assert set(got) == {"tokens", "labels"}
        for name in got:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(exp[name]))
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        lm_batch(prng.PRNGKey(0, "cpu"),
                 get_reduced("olmo-1b").with_(frontend="vision"), 1, 8)


def test_olmo_config_matches_reference():
    for mine, ref in ((get_config("olmo-1b"), jget_config("olmo-1b")),
                      (get_reduced("olmo-1b"), jget_reduced("olmo-1b"))):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(ref)
        for k in ("param_dtype", "compute_dtype"):   # torch vs jnp dtypes
            assert str(a.pop(k)) == f"torch.{np.dtype(b.pop(k)).name}"
        assert a == b
        assert mine.param_count() == ref.param_count()
    cfg = get_config("olmo-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.norm,
            cfg.act, cfg.tie_embeddings) == (16, 2048, 16, 16, 128, 8192,
                                             50304, "np_layernorm",
                                             "swiglu", True)


@pytest.fixture(scope="module",
                params=["olmo-1b", "zamba2-1.2b", "falcon-mamba-7b"])
def reference(request):
    """The reference's weights, one batch, and its loss and gradients."""
    arch = request.param
    jcfg, tcfg = _cfgs(arch)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    batch = jlm_batch(jax.random.PRNGKey(2), jcfg, B, S)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, batch), has_aux=True))(jp)
    tree = jax.tree.map(np.asarray, jp)
    return {"arch": arch, "cfg": tcfg, "tree": tree,
            "batch": {k: torch.from_numpy(np.asarray(v))
                      for k, v in batch.items()},
            "loss": float(loss), "ce": float(metrics["ce"]),
            "grads": _tensors(convert.lm_params(
                jax.tree.map(np.asarray, grads), tcfg, "cpu"))}


def _port_grads(ref, remat=True, use_kernel=None):
    params = convert.lm_params(ref["tree"], ref["cfg"], "cpu")
    leaves = _tensors(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = loss_fn(ref["cfg"], params, ref["batch"], remat=remat,
                            device="cpu", use_kernel=use_kernel)
    return loss, metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_loss_and_grads_match_reference(reference, use_kernel):
    loss, metrics, grads = _port_grads(reference, use_kernel=use_kernel)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(loss), reference["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["ce"]), reference["ce"],
                               rtol=LOSS_RTOL)
    assert len(grads) == len(reference["grads"])
    for i, (g, e) in enumerate(zip(grads, reference["grads"])):
        assert g.shape == e.shape, i
        assert bool(torch.isfinite(g).all()), i
        # compared where the reference is finite (REFERENCE_NAN)
        ok = torch.isfinite(e)
        if reference["arch"] not in REFERENCE_NAN:
            assert bool(ok.all()), i
        if ok.any():
            assert _rel_l2(g[ok], e[ok]) <= GRAD_REL_L2, (
                i, _rel_l2(g[ok], e[ok]))


def test_remat_equals_no_remat(reference):
    """Rematerialising each layer recomputes the same values: loss and
    gradients equal bit for bit."""
    with_remat = _port_grads(reference, remat=True)
    without = _port_grads(reference, remat=False)
    assert torch.equal(with_remat[0], without[0])
    for a, b in zip(with_remat[2], without[2]):
        assert torch.equal(a, b)


def test_train_steps_match_reference():
    """Three AdamW steps (``default_optimizer``: lr 1e-4, weight decay
    0.01) on three batches: the losses, the parameters and the optimizer
    state after each step."""
    jcfg, tcfg = _cfgs("olmo-1b")
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    jopt = jdefault_opt()
    jstate = jopt.init(jp)
    jstep = jax.jit(jmake_step(jcfg, jopt))
    params = convert.lm_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    opt = default_optimizer()
    state = opt.init(params)
    step = make_train_step(tcfg, opt, device="cpu")
    for i in range(3):
        jb = jlm_batch(jax.random.fold_in(jax.random.PRNGKey(2), i), jcfg,
                       B, S)
        before = [t.clone() for t in _tensors(params)]
        jp, jstate, jloss, _ = jstep(jp, jstate, jb)
        params, state, loss, metrics = step(
            params, state, {k: torch.from_numpy(np.asarray(v))
                            for k, v in jb.items()})
        # functional: the step leaves its inputs as they were
        assert loss.shape == () and not loss.requires_grad
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(metrics["ce"]), float(jloss),
                                   rtol=LOSS_RTOL)
        exp_p = _tensors(convert.lm_params(jax.tree.map(np.asarray, jp),
                                           tcfg, "cpu"))
        for a, e, p0 in zip(_tensors(params), exp_p, before):
            assert not a.requires_grad
            np.testing.assert_allclose(a.numpy(), e.numpy(), atol=PARAM_ATOL,
                                       rtol=0)
            far = float(((a - e).abs() > PARAM_CLOSE).float().mean())
            assert far <= FAR_SHARE, far
        exp_s = convert.lm_optimizer_state(jax.tree.map(np.asarray, jstate),
                                           tcfg, "cpu")
        assert int(state["t"]) == int(exp_s["t"]) == i + 1
        for name in ("m", "v"):
            for a, e in zip(_tensors(state[name]), _tensors(exp_s[name])):
                assert _rel_l2(a, e) <= 1e-4, (name, _rel_l2(a, e))
        assert any(not torch.equal(a, b)
                   for a, b in zip(_tensors(params), before))


def _cohort_args(**kw):
    args = dict(arch="olmo-1b", steps=6, batch=2, seq=32, lr=3e-3, seed=0,
                out=None, device="cpu")
    args.update(kw)
    return argparse.Namespace(**args)


def test_train_cohort_cli(tmp_path, capsys):
    """The reference's defaults (10 steps of 4 x 64 tokens, lr 3e-3)."""
    losses = train.main(["cohort", "--device", "cpu", "--out",
                         str(tmp_path)])
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0]
    assert (tmp_path / "cohort.msgpack").exists()
    out = capsys.readouterr().out
    assert "step 9: loss=" in out and "[cohort:olmo-1b]" in out
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        train.main_cohort(_cohort_args(arch="phi3-mini-3.8b"))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "falcon-mamba-7b"])
def test_train_cohort_cli_scan_archs(arch, tmp_path, capsys):
    """``train cohort`` of the reduced SSM archs (the reference's
    defaults: 10 steps of 4 x 64 tokens), which the scan kernels'
    backward kernels put on the card; on the CPU their plain routes."""
    losses = train.main(["cohort", "--device", "cpu", "--arch", arch,
                         "--out", str(tmp_path)])
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0]
    assert (tmp_path / "cohort.msgpack").exists()
    assert f"[cohort:{arch}]" in capsys.readouterr().out


def test_federated_llm_cohort_example(capsys):
    losses = federated_llm_cohort.main(["--device", "cpu", "--rounds", "4"])
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < losses[0]
    assert "round 4: clients=" in capsys.readouterr().out
