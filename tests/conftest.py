"""Test configuration.

Tests run on the CPU unless JAX_PLATFORMS says otherwise, over a virtual
8-device host mesh so the sharded paths (parallel/) are exercised without
several cards.  Tests marked `gpu` need a real card: the `gpu_device` and
`four_gpus` fixtures decide at run time, never at import, and skip them
elsewhere.  Run them on a GPU machine with `python -m pytest tests/ -m gpu`:
a marker expression that selects `gpu` leaves JAX's platform choice alone.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# no persistent compilation cache in tests: every test compiles what it
# runs, and the CLI's cache setup (utils/compile_cache.py) stays inert
os.environ.setdefault("JAX_ENABLE_COMPILATION_CACHE", "false")

import pytest  # noqa: E402


def pytest_configure(config):
    # the same on every xdist worker (it reads only the command line), so
    # every worker collects the same tests
    markexpr = config.getoption("markexpr") or ""
    if "gpu" not in markexpr.replace("not gpu", ""):
        os.environ.setdefault("JAX_PLATFORMS", "cpu")


def _gpus():
    import jax

    try:
        return jax.devices("gpu")
    except RuntimeError:
        return []


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX has none."""
    devices = _gpus()
    if not devices:
        pytest.skip("needs a GPU (run with `python -m pytest tests/ -m gpu` on a card)")
    return devices[0]


@pytest.fixture
def four_gpus():
    """Four GPUs, or a skip when JAX has fewer."""
    devices = _gpus()
    if len(devices) < 4:
        pytest.skip(f"needs 4 GPUs, found {len(devices)}")
    return devices[:4]
