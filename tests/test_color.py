"""RGB->CIELab parity: jnp vs numpy golden vs cv2 (SURVEY.md C2)."""

import cv2
import numpy as np

from gabor_color_image_segmentation.ops.color import rgb_to_lab
from golden.features import rgb_to_lab_np


def test_jax_matches_numpy_golden(rng):
    rgb = rng.random((17, 23, 3), dtype=np.float32)
    ours = np.asarray(rgb_to_lab(rgb))
    gold = rgb_to_lab_np(rgb)
    # golden accumulates in float64; 0.05 Lab units is fp32 pow() precision
    np.testing.assert_allclose(ours, gold, atol=0.05)


def test_matches_cv2(rng):
    rgb = rng.random((16, 16, 3), dtype=np.float32)
    gold = rgb_to_lab_np(rgb)
    ref = cv2.cvtColor(rgb, cv2.COLOR_RGB2Lab)
    np.testing.assert_allclose(gold, ref, atol=0.35)  # cv2 uses slightly
    # different matrix rounding; sub-0.35 Lab-unit agreement is parity here


def test_uint8_and_range(rng):
    rgb = (rng.random((8, 8, 3)) * 255).astype(np.uint8)
    lab = np.asarray(rgb_to_lab(rgb))
    assert lab[..., 0].min() >= -1e-3 and lab[..., 0].max() <= 100.001
    white = np.asarray(rgb_to_lab(np.ones((1, 1, 3), np.float32)))
    np.testing.assert_allclose(white[0, 0], [100.0, 0.0, 0.0], atol=2e-2)
