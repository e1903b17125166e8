"""Test configuration: the CPU backend with an 8-device virtual mesh.

Tests exercise the full sharding/collective paths (the reference has no
distributed anything -- SURVEY.md section 2.2) on a simulated mesh, so by
default this forces ``JAX_PLATFORMS=cpu`` and 8 host devices before the
first ``import jax`` of any test module.

Tests marked ``chip`` need a GPU and take the ``chip`` fixture, which skips
them when the default device is not one. To run them on a card, set
``RINGZK_CHIP_TESTS=1``: the CPU is then not forced.

    RINGZK_CHIP_TESTS=1 python -m pytest tests -m chip
"""

import contextlib
import os

if os.environ.get("RINGZK_CHIP_TESTS") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            "--xla_force_host_platform_device_count=8 " + flags
        ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ringzk_tpu.utils import compile_cache  # noqa: E402

# protocol programs are large: recompiling on every run dominates wall-clock
compile_cache.enable()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260817)


@pytest.fixture
def chip():
    """The default device, when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs a GPU (default device is {dev.platform}); run with "
            "RINGZK_CHIP_TESTS=1 python -m pytest tests -m chip"
        )
    return dev


@contextlib.contextmanager
def env_override(var, value):
    """Set an env var for the block, restoring any pre-existing value
    (a bare ``del`` would clobber a runner-pinned RINGZK_* setting)."""
    prev = os.environ.get(var)
    os.environ[var] = value
    try:
        yield
    finally:
        if prev is None:
            del os.environ[var]
        else:
            os.environ[var] = prev
