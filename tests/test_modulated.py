"""Modulated-separable path must match the direct depthwise path EXACTLY
(same math, different factorization) — and hence golden (SURVEY.md §4.1)."""

import numpy as np
import pytest

from gabor_color_image_segmentation.config import BankConfig
from gabor_color_image_segmentation.ops.bank import make_bank
from gabor_color_image_segmentation.ops.features import gabor_energies
from gabor_color_image_segmentation.ops.modulated import gabor_energies_mod
from golden.features import gabor_energies_golden, rgb_to_lab_np


@pytest.fixture(scope="module")
def lab(small_mosaic):
    rgb, _ = small_mosaic
    return rgb_to_lab_np(rgb)


@pytest.mark.parametrize(
    "cfg",
    [
        BankConfig(scales=(2.0, 4.0), orientations=3, frequencies=None),
        BankConfig(scales=(1.5, 3.0), orientations=2, frequencies=(0.1, 0.2)),
    ],
    ids=["smallbank", "freqgrid"],
)
def test_matches_direct_path(lab, cfg):
    bank = make_bank(cfg)
    direct = np.asarray(gabor_energies(lab[None], bank))[0]
    mod = np.asarray(gabor_energies_mod(lab[None], bank))[0]
    # identical math, float-order differences only; energies are O(1..3000)
    peak = np.abs(direct).max()
    np.testing.assert_allclose(mod, direct, atol=2e-3 * peak, rtol=1e-3)


def test_matches_golden(lab):
    cfg = BankConfig(scales=(2.0,), orientations=4, frequencies=None)
    bank = make_bank(cfg)
    gold = gabor_energies_golden(lab, bank)
    mod = np.asarray(gabor_energies_mod(lab[None], bank))[0]
    peak = np.abs(gold).max()
    np.testing.assert_allclose(mod, gold, atol=2e-3 * peak, rtol=1e-3)


def test_rejects_anisotropic():
    cfg = BankConfig(scales=(2.0,), orientations=2, gamma=0.5)
    bank = make_bank(cfg)
    with pytest.raises(ValueError, match="gamma"):
        gabor_energies_mod(np.zeros((1, 16, 16, 3), np.float32), bank)
