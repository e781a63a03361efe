"""End-to-end runs of the remaining acceptance presets on the CPU backend:
config2 (GMM), config3 (ncut graph), mincut variant (SURVEY.md §4.3)."""

import dataclasses

import numpy as np
import pytest

from gabor_color_image_segmentation.config import GraphConfig, preset
from gabor_color_image_segmentation.data.synthetic import synthetic_mosaic
from gabor_color_image_segmentation.metrics.pri import pri_np
from gabor_color_image_segmentation.models.pipeline import (
    segment_batch,
    segment_images,
)
from gabor_color_image_segmentation.ops.bank import make_bank


@pytest.fixture(scope="module")
def batch2():
    imgs, gts = [], []
    for i in range(2):
        rgb, gt = synthetic_mosaic(h=96, w=128, n_regions=4, seed=20 + i)
        imgs.append(rgb)
        gts.append(gt)
    return np.stack(imgs), gts


def test_config2_gmm(batch2):
    imgs, gts = batch2
    cfg = preset("config2").replace(batch_size=2)
    cfg = cfg.replace(cluster=dataclasses.replace(cfg.cluster, n_iter=15))
    labels, _ = segment_batch(imgs, cfg, make_bank(cfg.bank))
    labels = np.asarray(labels)
    assert labels.shape == imgs.shape[:3]
    pris = [pri_np(labels[i], [gts[i]]) for i in range(2)]
    assert min(pris) > 0.72, pris  # k=5 GMM legitimately over-segments the 4-region mosaic


def test_config3_ncut(batch2):
    imgs, gts = batch2
    cfg = preset("config3").replace(batch_size=2)
    # pin the graph params this toy-geometry sanity gate was written for:
    # the round-5 production preset (900 cells, compactness 5, sigma scale
    # 0.1) is tuned for 321x481 and miscalibrated at 64 cells on a small
    # mosaic; the production operating point is pinned by the eval tables
    # (exp_config3_candidate_eval.py), not by this mechanism test
    cfg = cfg.replace(graph=dataclasses.replace(
        cfg.graph, n_superpixels=64, n_regions=4, slic_compactness=10.0,
        affinity_sigma_scale=1.0))
    labels, _ = segment_batch(imgs, cfg, make_bank(cfg.bank))
    labels = np.asarray(labels)
    assert labels.shape == imgs.shape[:3]
    assert labels.max() < cfg.graph.n_regions
    pris = [pri_np(labels[i], [gts[i]]) for i in range(2)]
    assert min(pris) > 0.8, pris


def test_mincut_variant(batch2):
    imgs, gts = batch2
    cfg = preset("config3").replace(batch_size=2)
    # mincut_k recalibrated after connectivity enforcement landed in the
    # superpixel stage: connected superpixels have cleaner means (no speckle
    # fragments), so inter-superpixel distances shrank and the merge
    # threshold follows (k=50 was tuned for fragmented maps; k=15 measures
    # PRI [0.943, 0.814] with sane region counts on this fixture, while
    # k=20 already over-merges image 2 into one region)
    cfg = cfg.replace(
        graph=GraphConfig(
            enabled=True, n_superpixels=64, cut="mincut", mincut_k=15.0, mincut_min_size=2
        )
    )
    labels = np.asarray(segment_images(imgs, cfg))
    assert labels.shape == imgs.shape[:3]
    pris = [pri_np(labels[i], [gts[i]]) for i in range(2)]
    assert min(pris) > 0.75, pris


def test_segment_batch_without_features(batch2):
    """with_features=False returns (labels, None); labels match the
    feature-returning path."""
    imgs, _ = batch2
    cfg = preset("config0").replace(batch_size=2)
    bank = make_bank(cfg.bank)
    ref, feats = segment_batch(imgs, cfg, bank)
    lab, none = segment_batch(imgs, cfg, bank, False)
    assert none is None and feats is not None
    assert (np.asarray(lab) == np.asarray(ref)).all()


@pytest.mark.parametrize(
    "preset_name,hw",
    [("config0", (97, 131)), ("config3", (60, 200))],
)
def test_off_nominal_image_sizes(preset_name, hw):
    """Odd and wide-rectangular shapes run end-to-end through both pipeline
    families (nothing in the contract requires 481x321)."""
    from gabor_color_image_segmentation.models.pipeline import segment_image

    h, w = hw
    rgb, _ = synthetic_mosaic(h=h, w=w, n_regions=4, seed=3)
    labels, _ = segment_image(rgb, preset(preset_name))
    lab = np.asarray(labels)
    assert lab.shape == (h, w) and lab.dtype == np.int32
    k = preset(preset_name).graph.n_regions if preset(
        preset_name
    ).graph.enabled else preset(preset_name).cluster.k
    assert 0 <= lab.min() and lab.max() < k
