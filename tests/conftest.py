"""Test configuration: run JAX on CPU with an 8-device virtual mesh.

Multi-chip sharding code paths are validated on virtual CPU devices
(`xla_force_host_platform_device_count`), per the project test strategy.
Must run before jax is imported anywhere.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import pytest

REFERENCE_SCENES = pathlib.Path("/root/reference/sample_scenes")


@pytest.fixture
def sample_scenes():
    if not REFERENCE_SCENES.exists():
        pytest.skip("reference sample scenes unavailable")
    return REFERENCE_SCENES


@pytest.fixture
def gpu():
    """The first GPU device; skips when JAX has none (always under this
    conftest, which pins the CPU backend: `python chip_smoke.py` runs the
    same checks on a GPU)."""
    import jax
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs a GPU (run python chip_smoke.py on one)")
    return device


@pytest.fixture(scope="session")
def scene_dir(tmp_path_factory):
    """Directory for the image files that generated test scenes load."""
    return tmp_path_factory.mktemp("scenes")
