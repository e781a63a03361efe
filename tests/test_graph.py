"""Affinity graph + spectral n-cut + min-cut (SURVEY.md C11-C13)."""

import numpy as np

from gabor_color_image_segmentation.metrics.pri import pri_np
from gabor_color_image_segmentation.models.graph import (
    affinity_matrix,
    mincut_segment,
    ncut_segment,
    spectral_labels,
    superpixel_means,
)
from gabor_color_image_segmentation.models.slic import slic
from gabor_color_image_segmentation.utils.labels import align_labels
from golden.features import rgb_to_lab_np
from golden.graph import ncut_golden


def test_superpixel_means(rng):
    f = rng.random((100, 4)).astype(np.float32)
    labels = rng.integers(0, 7, 100)
    means, cnts = superpixel_means(f, labels, 8)
    for j in range(8):
        m = labels == j
        assert float(np.asarray(cnts)[j]) == m.sum()
        if m.any():
            np.testing.assert_allclose(np.asarray(means)[j], f[m].mean(0), atol=1e-5)


def test_affinity_properties(rng):
    f = rng.random((30, 5)).astype(np.float32)
    w = np.asarray(affinity_matrix(f))
    assert np.allclose(w, w.T, atol=1e-6)
    assert np.allclose(np.diag(w), 1.0, atol=1e-5)
    assert (w >= 0).all() and (w <= 1.0 + 1e-6).all()


def test_spectral_labels_separates_blocks(rng):
    """Two well-separated feature blocks -> clean 2-way cut."""
    f = np.concatenate(
        [rng.normal(0, 0.05, (20, 4)), rng.normal(3, 0.05, (25, 4))]
    ).astype(np.float32)
    w = affinity_matrix(f, sigma=0.5)
    labels = np.asarray(spectral_labels(w, 2))
    true = np.array([0] * 20 + [1] * 25)
    aligned = align_labels(labels, true)
    assert (aligned == true).mean() == 1.0


def test_spectral_matches_sklearn(rng):
    from sklearn.cluster import SpectralClustering
    from sklearn.metrics import adjusted_rand_score

    f = np.concatenate(
        [rng.normal(i * 3, 0.1, (20, 4)) for i in range(3)]
    ).astype(np.float32)
    w = np.asarray(affinity_matrix(f, sigma=0.5), np.float64)
    ours = np.asarray(spectral_labels(w, 3))
    sk = SpectralClustering(
        n_clusters=3, affinity="precomputed", random_state=0, assign_labels="kmeans"
    ).fit_predict(w)
    assert adjusted_rand_score(ours, sk) > 0.95


def test_ncut_end_to_end(small_mosaic):
    rgb, gt = small_mosaic
    lab = rgb_to_lab_np(rgb)
    # color-only features are enough on the mosaic
    feats = (lab / np.abs(lab).max()).astype(np.float32)
    labels = np.asarray(ncut_segment(feats, lab, 64, 4))
    assert labels.shape == lab.shape[:2]
    pri = pri_np(labels, [gt])
    assert pri > 0.85, f"ncut PRI {pri}"


def test_ncut_matches_golden(small_mosaic):
    rgb, _ = small_mosaic
    lab = rgb_to_lab_np(rgb)
    feats = (lab / np.abs(lab).max()).astype(np.float32)
    sp = np.asarray(slic(lab, 64, 10.0, 10))
    from gabor_color_image_segmentation.models.graph import (
        affinity_matrix,
        spectral_labels,
    )
    from gabor_color_image_segmentation.models.slic import grid_shape

    gh, gw, _ = grid_shape(*lab.shape[:2], 64)
    f, cnts = superpixel_means(
        feats.reshape(-1, 3), sp.reshape(-1), gh * gw
    )
    ours_regions = np.asarray(
        spectral_labels(affinity_matrix(f, counts=cnts), 4)
    )
    ours = ours_regions[sp.reshape(-1)].reshape(sp.shape)
    gold = ncut_golden(feats, sp, 4, n_sp=gh * gw)
    aligned = align_labels(ours, gold)
    agree = (aligned == gold).mean()
    # eigenvector sign/rotation ambiguity makes this the loosest parity gate
    # (SURVEY.md §7.4.1); identical SLIC input + deterministic kmeans keeps it high
    assert agree > 0.95, f"ncut agreement {agree}"


def test_mincut_merges_mosaic(small_mosaic):
    rgb, gt = small_mosaic
    lab = rgb_to_lab_np(rgb)
    feats = lab.astype(np.float32)
    sp = np.asarray(slic(lab, 64, 10.0, 10))
    labels = mincut_segment(feats, sp, k=50.0, min_size=2)
    n_regions = len(np.unique(labels))
    assert 2 <= n_regions <= 20, n_regions
    pri = pri_np(labels, [gt])
    assert pri > 0.8, f"mincut PRI {pri}"


def test_subspace_eigensolver_matches_eigh(rng):
    """Matmul-only top-k eigensolver spans the same n-cut embedding."""
    from sklearn.metrics import adjusted_rand_score

    from gabor_color_image_segmentation.models.graph import (
        smallest_eigvecs_subspace,
    )

    f = np.concatenate(
        [rng.normal(i * 3, 0.15, (25, 4)) for i in range(3)]
    ).astype(np.float32)
    w = np.asarray(affinity_matrix(f, sigma=0.6))
    # label-level agreement between the two eigensolvers
    a = np.asarray(spectral_labels(w, 3, eig_method="eigh"))
    b = np.asarray(spectral_labels(w, 3, eig_method="subspace"))
    assert adjusted_rand_score(a, b) > 0.95

    # subspace-level agreement: principal angles ~ 0
    import jax.numpy as jnp

    deg = w.sum(1)
    dis = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lsym = np.eye(len(w)) - dis[:, None] * w * dis[None, :]
    evals, evecs = np.linalg.eigh(lsym)
    exact = evecs[:, :3]
    approx = np.asarray(smallest_eigvecs_subspace(jnp.asarray(lsym, jnp.float32), 3))
    sv = np.linalg.svd(exact.T @ approx, compute_uv=False)
    assert sv.min() > 0.99, sv  # cos(principal angles) ~ 1


def test_resolve_graph_impls_dtype_aware():
    """The eigensolver resolves in dispatch.py for every dtype: "auto" is
    the exact dense eigh, explicit settings win, and SLIC has no choice
    left (the fused SLIC option was removed with its kernel)."""
    import dataclasses

    import pytest

    from gabor_color_image_segmentation.config import GraphConfig, preset
    from gabor_color_image_segmentation.dispatch import resolve_impls

    g = GraphConfig(enabled=True)
    for dtype in ("float32", "bfloat16"):
        cfg = preset("config3").replace(graph=g, dtype=dtype)
        assert resolve_impls(cfg, "gpu").eig == "eigh"
        forced = cfg.replace(graph=dataclasses.replace(g, eig_method="subspace"))
        assert resolve_impls(forced, "gpu").eig == "subspace"
    with pytest.raises(TypeError):
        GraphConfig(slic_impl="fused")


def test_graph_pool_pipeline_matches_golden(small_mosaic):
    """graph.pool=1 (the config4 multirate cut stage): the jitted pooled
    chain — full-res energies pooled by exact block means BEFORE assembly,
    SLIC + connectivity + n-cut on the pooled grid, 2x nearest upsample —
    vs the golden mirror of the identical schedule."""
    import dataclasses

    import jax.numpy as jnp

    from gabor_color_image_segmentation.config import preset
    from gabor_color_image_segmentation.models.pipeline import segment_image
    from gabor_color_image_segmentation.models.slic import grid_shape
    from gabor_color_image_segmentation.ops.bank import make_bank
    from golden.graph import (
        enforce_connectivity_golden,
        graph_inputs_golden,
        slic_golden,
    )

    rgb, gt = small_mosaic  # 96 x 128
    cfg = preset("config3").replace(feature_impl="modulated")
    cfg = cfg.replace(
        graph=dataclasses.replace(
            cfg.graph, n_superpixels=64, n_regions=4, pool=1
        )
    )
    bank = make_bank(cfg.bank)
    labels, _ = segment_image(jnp.asarray(rgb), cfg, bank)
    labels = np.asarray(labels)
    assert labels.shape == rgb.shape[:2]
    # upsampled labels are constant on 2x2 blocks by construction
    assert (labels[0::2, 0::2] == labels[1::2, 1::2]).all()
    assert (labels[0::2, 0::2] == labels[0::2, 1::2]).all()

    feats_g, lab_g = graph_inputs_golden(rgb, cfg.bank, cfg.cluster, pool=1)
    hp, wp = rgb.shape[0] // 2, rgb.shape[1] // 2
    sp = slic_golden(
        lab_g, 64, cfg.graph.slic_compactness, cfg.graph.slic_iters
    )
    gh, gw, _ = grid_shape(hp, wp, 64)
    sp = enforce_connectivity_golden(sp, gh * gw)
    gold = ncut_golden(feats_g, sp, 4, n_sp=gh * gw)
    gold = gold.repeat(2, axis=0).repeat(2, axis=1)
    aligned = align_labels(labels, gold)
    agree = (aligned == gold).mean()
    assert agree > 0.95, f"pooled graph vs golden agreement {agree}"

    pri = pri_np(labels, [gt])
    assert pri > 0.7, f"pooled graph PRI {pri}"


