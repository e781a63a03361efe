"""Golden mirror of ``models/pipeline.py::segment_batch`` for one image.

Same stage chain and schedule as the device pipeline for the presets'
paths: golden features, then k-means (plain or multigrid) or per-image GMM
EM, or the SLIC + connectivity + spectral n-cut graph stage on the
``graph.pool``-pooled grid. ``cluster.subsample`` > 1 and the min-cut
variant are not mirrored.
"""

from __future__ import annotations

import numpy as np

from gabor_color_image_segmentation.models.slic import grid_shape
from gabor_color_image_segmentation.ops.bank import make_bank
from golden.cluster import gmm_golden, kmeans_golden, kmeans_golden_multigrid
from golden.features import features_golden
from golden.graph import (
    enforce_connectivity_golden,
    graph_inputs_golden,
    ncut_golden,
    slic_golden,
)


def golden_inputs(rgb: np.ndarray, cfg, bank=None):
    """(H, W, 3) sRGB -> (standardized features, pooled Lab or None): what
    the clustering or graph stage consumes."""
    if bank is None:
        bank = make_bank(cfg.bank)
    c, g = cfg.cluster, cfg.graph
    if g.enabled:
        return graph_inputs_golden(rgb, cfg.bank, c, g.pool, cfg.color_space, bank)
    return features_golden(rgb, cfg.bank, c, cfg.color_space, bank), None


def golden_labels(feats: np.ndarray, lab, cfg) -> np.ndarray:
    """golden_inputs' output -> (H, W) int32 labels at full resolution."""
    c, g = cfg.cluster, cfg.graph
    if c.subsample != 1:
        raise ValueError("golden does not mirror cluster.subsample > 1")
    h, w, d = feats.shape
    if g.enabled:
        if g.cut != "ncut":
            raise ValueError(f"golden mirrors the ncut graph stage, not {g.cut!r}")
        gh, gw, _ = grid_shape(h, w, g.n_superpixels)
        sp = enforce_connectivity_golden(
            slic_golden(lab, g.n_superpixels, g.slic_compactness, g.slic_iters),
            gh * gw,
        )
        labels = ncut_golden(
            feats, sp, g.n_regions, g.affinity_sigma, gh * gw,
            g.affinity_sigma_scale,
        )
        f = 1 << g.pool
        return labels.repeat(f, axis=0).repeat(f, axis=1)
    x = feats.reshape(-1, d)
    if c.method == "gmm":
        labels = gmm_golden(
            x, c.k, c.n_iter, c.gmm_reg_covar, c.gmm_tol, (h, w),
            c.gmm_fit_pool, c.gmm_refine_iters,
        )[0]
    elif (
        c.coarse_iters > 0 and c.init_stride == 1
        and min(h, w) >= (1 << c.coarse_levels)
    ):
        labels = kmeans_golden_multigrid(
            x, c.k, (h, w), c.coarse_iters, c.refine_iters,
            c.coarse_levels, c.mid_iters,
        )[0]
    else:
        labels = kmeans_golden(x, c.k, c.n_iter, c.init_stride)[0]
    return labels.reshape(h, w).astype(np.int32)


def segment_golden(rgb: np.ndarray, cfg, bank=None) -> np.ndarray:
    """(H, W, 3) sRGB -> (H, W) int32 labels."""
    return golden_labels(*golden_inputs(rgb, cfg, bank), cfg)
