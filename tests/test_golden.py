"""The golden oracle: its scipy filters equal OpenCV's (the reference
family's routines), and golden.pipeline mirrors segment_batch per preset."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gabor_color_image_segmentation.config import preset
from gabor_color_image_segmentation.data.synthetic import synthetic_mosaic
from gabor_color_image_segmentation.ops.bank import make_bank
from gabor_color_image_segmentation.utils.labels import align_labels
from golden.features import _corr2d, _sep_smooth, rgb_to_lab_np


@pytest.fixture(scope="module")
def channel():
    rgb, _ = synthetic_mosaic(h=61, w=83, n_regions=3, seed=5)
    return rgb_to_lab_np(rgb)[..., 0]


@pytest.mark.parametrize("group", [0, 1, 2])
@pytest.mark.parametrize("part", ["re", "im"])
def test_corr2d_equals_cv2_filter2d(channel, group, part):
    """scipy.ndimage.correlate(mode="mirror") == cv2.filter2D with
    BORDER_REFLECT_101, on the bank's own kernels (13, 25 and 31 wide)."""
    cv2 = pytest.importorskip("cv2")
    g = make_bank(preset("config0").bank).groups[group]
    k = g.filters_hwio[:, :, 0, 0 if part == "re" else 1].astype(np.float32)
    ref = cv2.filter2D(channel, cv2.CV_32F, k, borderType=cv2.BORDER_REFLECT_101)
    np.testing.assert_allclose(_corr2d(channel, k), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("group", [0, 2])
def test_sep_smooth_equals_cv2_sepfilter2d(channel, group):
    cv2 = pytest.importorskip("cv2")
    taps = np.asarray(make_bank(preset("config0").bank).groups[group].smooth_taps,
                      np.float32)
    ref = cv2.sepFilter2D(channel, cv2.CV_32F, taps, taps,
                          borderType=cv2.BORDER_REFLECT_101)
    np.testing.assert_allclose(_sep_smooth(channel, taps), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["config0", "config1", "config2", "config3", "config4"])
def test_segment_golden_mirrors_segment_batch(name):
    """golden.pipeline.segment_golden against the device pipeline (CPU,
    float32, small sizes; graph presets at a superpixel count that suits
    the size)."""
    from gabor_color_image_segmentation.models.pipeline import segment_batch
    from golden.pipeline import segment_golden

    cfg = preset(name).replace(dtype="float32", feature_impl="modulated")
    h, w = (64, 96)
    if cfg.graph.enabled:
        cfg = cfg.replace(graph=dataclasses.replace(
            cfg.graph, n_superpixels=48, n_regions=4))
    if name == "config4":
        h, w = 96, 128
        cfg = cfg.replace(tile_hw=(48, 64))
    rgb, _ = synthetic_mosaic(h=h, w=w, n_regions=4, seed=9)
    bank = make_bank(cfg.bank)
    dev = np.asarray(segment_batch(jnp.asarray(rgb)[None], cfg, bank, False)[0])[0]
    gold = segment_golden(rgb, cfg, bank)
    assert gold.shape == dev.shape == (h, w)
    agree = (align_labels(dev, gold) == gold).mean()
    assert agree > 0.999, f"{name}: agreement {agree}"
