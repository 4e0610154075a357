"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must
see the real single CPU device; only repro.launch.dryrun forces 512."""
import jax
import pytest

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips with a reason elsewhere)")
