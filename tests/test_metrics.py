"""PRI / VoI / covering metric properties + sklearn parity (SURVEY.md C15,
L6 region-metric family, §4.2)."""

import numpy as np

from gabor_color_image_segmentation.metrics.pri import (
    pri_np,
    rand_index_jax,
    rand_index_np,
)
from gabor_color_image_segmentation.metrics.region import (
    covering_jax,
    covering_np,
    mean_covering_np,
    mean_voi_np,
    voi_jax,
    voi_np,
)


def test_identity_is_one(rng):
    x = rng.integers(0, 5, (30, 40))
    assert rand_index_np(x, x) == 1.0
    assert pri_np(x, [x, x]) == 1.0


def test_matches_sklearn(rng):
    from sklearn.metrics import rand_score

    a = rng.integers(0, 5, 500)
    b = rng.integers(0, 4, 500)
    assert abs(rand_index_np(a, b) - rand_score(a, b)) < 1e-12


def test_jax_matches_np(rng):
    a = rng.integers(0, 6, (20, 30)).astype(np.int32)
    b = rng.integers(0, 4, (20, 30)).astype(np.int32)
    ours = float(rand_index_jax(a, b, 6, 4))
    gold = rand_index_np(a, b)
    assert abs(ours - gold) < 1e-5


def test_permutation_invariance(rng):
    a = rng.integers(0, 5, 300)
    b = rng.integers(0, 5, 300)
    perm = np.array([3, 0, 4, 1, 2])
    assert abs(rand_index_np(perm[a], b) - rand_index_np(a, b)) < 1e-12


# --- region metrics: Variation of Information + segmentation covering ----


def test_voi_identity_and_symmetry(rng):
    x = rng.integers(0, 5, (30, 40))
    y = rng.integers(0, 4, (30, 40))
    # identity VoI is zero up to float cancellation (H + H - 2I computed
    # from independently-accumulated entropies; exact 0.0 held only by
    # accident of the shared-rng draw order)
    assert abs(voi_np(x, x)) < 1e-12
    assert abs(voi_np(x, y) - voi_np(y, x)) < 1e-12
    assert abs(mean_voi_np(x, [x, x])) < 1e-12


def test_voi_matches_sklearn_decomposition(rng):
    # VoI = H(a) + H(b) - 2 I(a, b); cross-check against sklearn's
    # mutual_info_score (nats) + scipy entropy of the marginals.
    from scipy.stats import entropy
    from sklearn.metrics import mutual_info_score

    a = rng.integers(0, 5, 500)
    b = rng.integers(0, 4, 500)
    h_a = entropy(np.bincount(a) / a.size)
    h_b = entropy(np.bincount(b) / b.size)
    mi = mutual_info_score(a, b)
    assert abs(voi_np(a, b) - (h_a + h_b - 2 * mi)) < 1e-10


def test_voi_refinement_is_conditional_entropy():
    # splitting one GT region in the prediction costs exactly H(pred | gt)
    gt = np.zeros(100, np.int64)
    pred = np.repeat([0, 1], 50)  # a clean 50/50 split of the single region
    assert abs(voi_np(pred, gt) - np.log(2.0)) < 1e-12


def test_covering_identity_bounds(rng):
    x = rng.integers(0, 5, (30, 40))
    y = rng.integers(0, 4, (30, 40))
    assert covering_np(x, x) == 1.0
    assert 0.0 < covering_np(x, y) <= 1.0
    assert mean_covering_np(x, [x, x]) == 1.0


def test_covering_brute_force(rng):
    # direct per-region loop definition on a small map
    pred = rng.integers(0, 4, (12, 17))
    gt = rng.integers(0, 3, (12, 17))
    total = 0.0
    for g in np.unique(gt):
        rg = gt == g
        best = 0.0
        for p in np.unique(pred):
            rp = pred == p
            inter = np.sum(rg & rp)
            union = np.sum(rg | rp)
            best = max(best, inter / union)
        total += rg.sum() * best
    assert abs(covering_np(pred, gt) - total / gt.size) < 1e-12


def test_covering_direction_is_gt_by_pred():
    # covering is of the GT regions BY the prediction and is asymmetric:
    # gt = {A: 80 px, B: 20 px}, pred = one region of 100 px.
    #   covering(pred, gt) = (80*(80/100) + 20*(20/100)) / 100 = 0.68
    #   covering(gt, pred) = 100*(80/100) / 100            = 0.80
    gt = np.repeat([0, 1], [80, 20])
    pred = np.zeros(100, np.int64)
    assert abs(covering_np(pred, gt) - 0.68) < 1e-12
    assert abs(covering_np(gt, pred) - 0.80) < 1e-12

    # splitting a GT region halves its best overlap: {A split 40/40, B kept}
    split = np.repeat([0, 1, 2], [40, 40, 20])
    expect = (80 * (40 / 80) + 20 * 1.0) / 100
    assert abs(covering_np(split, gt) - expect) < 1e-12


def test_region_jax_matches_np(rng):
    a = rng.integers(0, 6, (20, 30)).astype(np.int32)
    b = rng.integers(0, 4, (20, 30)).astype(np.int32)
    assert abs(float(voi_jax(a, b, 6, 4)) - voi_np(a, b)) < 1e-5
    assert abs(float(covering_jax(a, b, 6, 4)) - covering_np(a, b)) < 1e-6
