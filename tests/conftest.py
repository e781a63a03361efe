"""Test config: force the JAX CPU backend with 8 fake devices so sharding
tests run without an accelerator (SURVEY.md §4.4). Tests that need a GPU
carry the ``gpu`` marker and skip here (see ``require_gpu`` below)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persist slow CPU compiles across suite runs
from gabor_color_image_segmentation.utils.jit_cache import (  # noqa: E402
    enable_compilation_cache,
)

enable_compilation_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from gabor_color_image_segmentation.data.synthetic import synthetic_mosaic  # noqa: E402


@pytest.fixture
def require_gpu():
    """Skip (at run time, never at collection) unless JAX sees a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run on the card via chip_smoke.py")


@pytest.fixture(scope="session")
def small_mosaic():
    """96x128 seeded texture mosaic + ground truth (fast CPU tests)."""
    rgb, gt = synthetic_mosaic(h=96, w=128, n_regions=4, seed=7)
    return rgb, gt


@pytest.fixture(scope="session")
def tiny_mosaic():
    rgb, gt = synthetic_mosaic(h=48, w=64, n_regions=3, seed=3)
    return rgb, gt


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
