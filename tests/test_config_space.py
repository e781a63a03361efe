"""Coverage of config-space corners: RGB color space, psi != 0, ksize cap,
unnormalized features, anisotropic gamma (direct path only)."""

import dataclasses

import numpy as np

from gabor_color_image_segmentation.config import BankConfig, preset
from gabor_color_image_segmentation.metrics.pri import pri_np
from gabor_color_image_segmentation.models.pipeline import segment_image
from gabor_color_image_segmentation.ops.bank import make_bank
from gabor_color_image_segmentation.ops.features import gabor_energies
from golden.features import features_golden, gabor_energies_golden


def test_rgb_color_space(small_mosaic):
    rgb, gt = small_mosaic
    cfg = preset("config0").replace(color_space="rgb")
    labels, _ = segment_image(rgb, cfg)
    assert pri_np(np.asarray(labels), [gt]) > 0.8

    gold = features_golden(rgb, cfg.bank, cfg.cluster, color_space="rgb")
    assert gold.shape[-1] == 3 * cfg.bank.n_kernels + 3


def test_psi_nonzero_matches_golden(small_mosaic):
    from golden.features import rgb_to_lab_np

    rgb, _ = small_mosaic
    lab = rgb_to_lab_np(rgb)
    cfg = BankConfig(scales=(2.0,), orientations=3, psi=0.7)
    bank = make_bank(cfg)
    gold = gabor_energies_golden(lab, bank)
    ours = np.asarray(gabor_energies(lab[None], bank))[0]
    peak = np.abs(gold).max()
    np.testing.assert_allclose(ours, gold, atol=2e-3 * peak, rtol=1e-3)


def test_ksize_cap():
    cfg = BankConfig(scales=(16.0,), orientations=2, max_ksize=21)
    bank = make_bank(cfg)
    assert all(g.ksize == 21 for g in bank.groups)
    assert cfg.ksize_for(16.0) == 21


def test_unnormalized_features(small_mosaic):
    rgb, gt = small_mosaic
    cfg = preset("config0")
    cfg = cfg.replace(cluster=dataclasses.replace(cfg.cluster, normalize=False))
    labels, feats = segment_image(rgb, cfg)
    assert np.isfinite(np.asarray(feats)).all()
    assert np.asarray(labels).max() < cfg.cluster.k


def test_anisotropic_direct_path(small_mosaic):
    """gamma != 1 must route to the direct impl under 'auto' and match golden."""
    from golden.features import rgb_to_lab_np

    rgb, _ = small_mosaic
    lab = rgb_to_lab_np(rgb)
    cfg = BankConfig(scales=(2.5,), orientations=2, gamma=0.5)
    bank = make_bank(cfg)
    gold = gabor_energies_golden(lab, bank)
    ours = np.asarray(gabor_energies(lab[None], bank))[0]
    peak = np.abs(gold).max()
    np.testing.assert_allclose(ours, gold, atol=2e-3 * peak, rtol=1e-3)

    pcfg = preset("config0").replace(bank=cfg)  # auto -> direct on CPU
    labels, _ = segment_image(rgb, pcfg)
    assert np.asarray(labels).shape == rgb.shape[:2]
