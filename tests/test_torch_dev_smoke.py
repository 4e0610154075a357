"""``python -m repro_torch.launch.dev_smoke``, the twin of the reference's
``scripts/dev_smoke.py``, on the CPU over all ten reduced archs: one
train forward/backward and one decode step each, all finite, with as many
parameters as the reference's ``init_params`` makes for the arch (its
shapes by ``jax.eval_shape``, nothing computed) and decode logits of the
reference's shape."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from test_torch_lm_dense import one_thread  # noqa: E402,F401
from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.launch import dev_smoke  # noqa: E402


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dev_smoke_runs_each_arch(arch, capsys):
    (row,) = dev_smoke.main(["--device", "cpu", arch])
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(1),
                                                 jget_reduced(arch)))
    assert row["params"] == sum(int(np.prod(s.shape))
                                for s in jax.tree.leaves(shapes))
    assert np.isfinite(row["loss"]) and np.isfinite(row["gnorm"])
    cfg = get_reduced(arch)
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    assert row["decode_logits"] == (2, 1) + books + (cfg.vocab_size,)
    assert capsys.readouterr().out.startswith(f"OK {arch} ")
