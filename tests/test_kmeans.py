"""k-means golden parity + sklearn cross-validation (SURVEY.md C8)."""

import numpy as np
import pytest

from gabor_color_image_segmentation.models.kmeans import kmeans, maximin_init
from gabor_color_image_segmentation.utils.labels import align_labels
from golden.cluster import kmeans_golden, maximin_init_np


def _blobs(rng, n=2000, k=4, d=8, spread=0.08):
    centers = rng.normal(size=(k, d)) * 3.0
    labels = rng.integers(0, k, n)
    x = centers[labels] + rng.normal(size=(n, d)) * spread
    return x.astype(np.float32), labels


def test_maximin_init_matches_golden(rng):
    x, _ = _blobs(rng)
    ours = np.asarray(maximin_init(x, 4))
    gold = maximin_init_np(x, 4)
    np.testing.assert_allclose(ours, gold, atol=1e-5)


def test_labels_match_golden(rng):
    x, _ = _blobs(rng, n=3000, k=5, d=6)
    ours, c_ours = kmeans(x, 5, 20)
    gold, c_gold = kmeans_golden(x, 5, 20)
    agree = (np.asarray(ours) == gold).mean()
    assert agree > 0.999, f"label agreement {agree}"
    np.testing.assert_allclose(np.asarray(c_ours), c_gold, atol=1e-3)


def test_recovers_true_clusters(rng):
    x, true = _blobs(rng, n=4000, k=4, d=10, spread=0.05)
    labels, _ = kmeans(x, 4, 25)
    aligned = align_labels(np.asarray(labels), true)
    assert (aligned == true).mean() > 0.999


def test_matches_sklearn_quality(rng):
    """Same-or-better inertia than sklearn KMeans on well-separated blobs."""
    from sklearn.cluster import KMeans

    x, _ = _blobs(rng, n=2500, k=4, d=8)
    labels, centers = kmeans(x, 4, 25)
    sk = KMeans(n_clusters=4, n_init=1, random_state=0, max_iter=25).fit(x)
    ours_inertia = float(
        ((x - np.asarray(centers)[np.asarray(labels)]) ** 2).sum()
    )
    assert ours_inertia <= sk.inertia_ * 1.01


def test_empty_cluster_keeps_center():
    x = np.array([[0.0, 0], [0, 0.1], [10, 10], [10, 10.1]], np.float32)
    labels, centers = kmeans(x, 3, 5)
    assert np.asarray(labels).max() <= 2
    assert np.isfinite(np.asarray(centers)).all()


def test_subsampled_close_to_exact(rng):
    from gabor_color_image_segmentation.models.kmeans import kmeans_fit_assign

    x, _ = _blobs(rng, n=4000, k=4, d=10, spread=0.05)
    exact, _ = kmeans_fit_assign(x, 4, 25)
    import jax.numpy as jnp

    fast, _ = kmeans_fit_assign(x, 4, 25, jnp.float32, 4)
    from gabor_color_image_segmentation.utils.labels import align_labels

    aligned = align_labels(np.asarray(fast), np.asarray(exact))
    assert (aligned == np.asarray(exact)).mean() > 0.99


def test_multigrid_matches_golden(rng):
    """XLA multigrid schedule (pooled warmup + full-res refine) == the
    golden mirror, label for label."""
    from gabor_color_image_segmentation.models.kmeans import (
        kmeans_multigrid,
        pool2x2,
    )
    from golden.cluster import kmeans_golden_multigrid, pool2x2_np

    h, w, d = 40, 50, 6
    x, _ = _blobs(rng, n=h * w, k=4, d=d)
    # pooling mirrors exactly
    np.testing.assert_array_equal(
        np.asarray(pool2x2(x, h, w)), pool2x2_np(x, h, w)
    )
    ours, c_ours = kmeans_multigrid(x, 4, (h, w), 8, 6)
    gold, c_gold = kmeans_golden_multigrid(x, 4, (h, w), 8, 6)
    agree = (np.asarray(ours) == gold).mean()
    assert agree > 0.999, f"multigrid label agreement {agree}"
    np.testing.assert_allclose(np.asarray(c_ours), c_gold, atol=1e-3)


def test_multigrid_quality_close_to_full(rng):
    """Multigrid clusters as well as the full 25-iteration run on SPATIALLY
    COHERENT features (inertia within 2%). The schedule's premise is that
    2x2 neighbors are similar — true for image features, and exactly why it
    is an image-pipeline option keyed on (h, w), not a generic k-means mode
    (on spatially-shuffled blobs the pooled warmup averages unrelated
    points and measured 3x worse inertia at a tight refine cap)."""
    from gabor_color_image_segmentation.models.kmeans import kmeans_multigrid

    h, w, d, k = 60, 70, 8, 5
    # piecewise-constant feature map (spatial patches) + noise
    region = (np.arange(h)[:, None] // 12 * 7 + np.arange(w)[None, :] // 14) % k
    centers = rng.normal(size=(k, d)) * 3.0
    x = (
        centers[region.reshape(-1)]
        + rng.normal(size=(h * w, d)) * 0.3
    ).astype(np.float32)
    full_l, full_c = kmeans(x, k, 25)
    mg_l, mg_c = kmeans_multigrid(x, k, (h, w), 10, 5)

    def inertia(l, c):
        return float(((x - np.asarray(c)[np.asarray(l)]) ** 2).sum())

    assert inertia(mg_l, mg_c) <= inertia(full_l, full_c) * 1.02


def test_multigrid_levels2_matches_golden(rng):
    """coarse_levels=2 (4x4 coarse grid): XLA == golden, label for label,
    and the 4x4 grid is exactly pool2x2 applied twice in both."""
    from gabor_color_image_segmentation.models.kmeans import (
        kmeans_multigrid,
        pool2x2,
    )
    from golden.cluster import kmeans_golden_multigrid, pool2x2_np

    h, w, d = 48, 56, 6
    x, _ = _blobs(rng, n=h * w, k=4, d=d)
    p2 = pool2x2(x, h, w)
    np.testing.assert_array_equal(
        np.asarray(pool2x2(p2, h // 2, w // 2)),
        pool2x2_np(pool2x2_np(x, h, w), h // 2, w // 2),
    )
    ours, c_ours = kmeans_multigrid(x, 4, (h, w), 8, 6, coarse_levels=2)
    gold, c_gold = kmeans_golden_multigrid(x, 4, (h, w), 8, 6, coarse_levels=2)
    agree = (np.asarray(ours) == gold).mean()
    assert agree > 0.999, f"levels-2 multigrid label agreement {agree}"
    np.testing.assert_allclose(np.asarray(c_ours), c_gold, atol=1e-3)


def test_multigrid_mid_levels_matches_golden(rng):
    """mid_iters > 0 (intermediate 2x2-level passes between the 4x4 warmup
    and full-res refinement): XLA == golden, label for label."""
    from gabor_color_image_segmentation.models.kmeans import kmeans_multigrid
    from golden.cluster import kmeans_golden_multigrid

    h, w, d = 48, 56, 6
    x, _ = _blobs(rng, n=h * w, k=4, d=d)
    ours, c_ours = kmeans_multigrid(
        x, 4, (h, w), 8, 2, coarse_levels=2, mid_iters=3
    )
    gold, c_gold = kmeans_golden_multigrid(
        x, 4, (h, w), 8, 2, coarse_levels=2, mid_iters=3
    )
    agree = (np.asarray(ours) == gold).mean()
    assert agree > 0.999, f"mid-level multigrid label agreement {agree}"
    np.testing.assert_allclose(np.asarray(c_ours), c_gold, atol=1e-3)
    # the mid passes must actually move the centers: under-converge the
    # warmup (1 coarse pass) so the intermediate level has work to do
    _, c_skip = kmeans_multigrid(x, 4, (h, w), 1, 0, coarse_levels=2)
    _, c_mid = kmeans_multigrid(x, 4, (h, w), 1, 0, coarse_levels=2,
                                mid_iters=3)
    assert (np.asarray(c_skip) != np.asarray(c_mid)).any()




def _patch_image(rng, h, w, d, k, noise=0.3):
    """Piecewise-constant feature map (spatial patches) + noise, flat."""
    region = (np.arange(h)[:, None] // 12 * 7 + np.arange(w)[None, :] // 14) % k
    centers = rng.normal(size=(k, d)) * 3.0
    return (
        centers[region.reshape(-1)] + rng.normal(size=(h * w, d)) * noise
    ).astype(np.float32)


# (dtype, init_stride, coarse_iters, refine_iters, coarse_levels, mid_iters)
BATCH_CASES = {
    "plain": ("float32", 1, 0, 10, 1, 0),
    "init_stride": ("float32", 3, 0, 10, 1, 0),
    "multigrid_l1": ("float32", 1, 8, 6, 1, 0),
    "multigrid_l2": ("float32", 1, 15, 1, 2, 0),
    "multigrid_mid": ("float32", 1, 15, 1, 2, 3),
    "bf16_multigrid_mid": ("bfloat16", 1, 15, 1, 2, 3),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_kmeans_batch_matches_golden(case, rng):
    """The batched XLA Lloyd (the pipeline's entry) against golden per
    image, at the schedules the presets use."""
    import jax.numpy as jnp

    from gabor_color_image_segmentation.models.kmeans import kmeans_batch
    from golden.cluster import kmeans_golden_multigrid

    dtype, stride, coarse, refine, levels, mid = BATCH_CASES[case]
    h, w, d, k = 48, 64, 12, 5
    xs = np.stack([_patch_image(rng, h, w, d, k) for _ in range(3)])
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    labels, _ = kmeans_batch(
        jnp.asarray(xs), k, 10, dt, 1, stride, (h, w), coarse, refine,
        levels, mid,
    )
    labels = np.asarray(labels)
    assert labels.shape == (3, h * w)
    for i in range(3):
        x = xs[i]
        if dtype == "bfloat16":  # golden sees the rounded features
            x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        if coarse:
            gold, _ = kmeans_golden_multigrid(x, k, (h, w), coarse, refine, levels, mid)
        else:
            gold, _ = kmeans_golden(x, k, 10, stride)
        agree = (align_labels(labels[i], gold) == gold).mean()
        assert agree > 0.999, f"{case} image {i}: agreement {agree}"
