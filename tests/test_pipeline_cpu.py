"""Integration test — BASELINE config 0 on the CPU backend (SURVEY.md §4.3):
full pipeline on a synthetic mosaic, golden parity + PRI quality floor."""

import numpy as np
import pytest

from gabor_color_image_segmentation.config import preset
from gabor_color_image_segmentation.metrics.pri import pri_np
from gabor_color_image_segmentation.models.pipeline import segment_image
from gabor_color_image_segmentation.utils.labels import align_labels
from golden.cluster import kmeans_golden
from golden.features import features_golden


@pytest.fixture(scope="module")
def cfg():
    # config0 shrunk spatially for CPU-test speed; same bank/cluster params
    return preset("config0")


def test_config0_end_to_end(small_mosaic, cfg):
    rgb, gt = small_mosaic
    labels, feats = segment_image(rgb, cfg)
    labels = np.asarray(labels)
    assert labels.shape == rgb.shape[:2]
    assert labels.dtype == np.int32
    assert 0 <= labels.min() and labels.max() < cfg.cluster.k
    # the mosaic has 4 well-separated regions; k=5 clustering must score high
    pri = pri_np(labels, [gt])
    assert pri > 0.85, f"PRI {pri}"


def test_config0_color_weighted_quality(small_mosaic, cfg):
    """On a color-dominant mosaic, upweighting color must segment ~perfectly."""
    import dataclasses

    rgb, gt = small_mosaic
    c = cfg.replace(cluster=dataclasses.replace(cfg.cluster, color_weight=2.0))
    labels, _ = segment_image(rgb, c)
    pri = pri_np(np.asarray(labels), [gt])
    assert pri > 0.95, f"PRI {pri}"


def test_config0_matches_golden(small_mosaic, cfg):
    rgb, _ = small_mosaic
    labels, _ = segment_image(rgb, cfg)
    labels = np.asarray(labels)

    gold_feats = features_golden(rgb, cfg.bank, cfg.cluster)
    h, w, d = gold_feats.shape
    gold_labels, _ = kmeans_golden(
        gold_feats.reshape(-1, d),
        cfg.cluster.k,
        cfg.cluster.n_iter,
        cfg.cluster.init_stride,
    )
    gold_labels = gold_labels.reshape(h, w)

    aligned = align_labels(labels, gold_labels)
    agree = (aligned == gold_labels).mean()
    assert agree > 0.99, f"golden label agreement {agree}"


def test_gabor_features_earn_their_cost():
    """Headline of the feature ablation: on the texture-ONLY split (regions
    share one base color and differ only in texture orientation/frequency),
    the full Gabor+color features with coherence cue weighting beat
    color-only features decisively — the filter bank carries the signal.
    Small 3-image version of the 12-image feature-ablation study."""
    import dataclasses

    from gabor_color_image_segmentation.config import preset
    from gabor_color_image_segmentation.data.synthetic import (
        synthetic_mosaic,
    )
    from gabor_color_image_segmentation.metrics.pri import pri_np
    from gabor_color_image_segmentation.models.pipeline import (
        segment_images,
    )
    from gabor_color_image_segmentation.ops.bank import make_bank

    imgs, gts = [], []
    for i in range(3):
        rgb, gt = synthetic_mosaic(
            h=96, w=128, n_regions=4, seed=3100 + i, texture_only=True
        )
        imgs.append(rgb)
        gts.append(gt)
    base = preset("config0").replace(feature_impl="modulated")

    def mean_pri(fset, cue):
        cfg = base.replace(
            cluster=dataclasses.replace(
                base.cluster, feature_set=fset, cue_weight=cue
            )
        )
        labels = np.asarray(
            segment_images(np.stack(imgs), cfg, make_bank(cfg.bank))
        )
        return float(
            np.mean([pri_np(labels[i], [gts[i]]) for i in range(len(imgs))])
        )

    full = mean_pri("full", "coherence")
    color = mean_pri("color", "static")
    assert full > color + 0.1, (
        f"full+coherence {full:.3f} must decisively beat color-only "
        f"{color:.3f} on the texture-only split"
    )
