"""Boundary-F metric: protocol properties + host/device agreement."""

import numpy as np

from gabor_color_image_segmentation.metrics.boundary import (
    boundaries_np,
    default_tolerance,
    fboundary_jax,
    fboundary_np,
)


def _halves(h=40, w=60, split=30):
    x = np.zeros((h, w), np.int32)
    x[:, split:] = 1
    return x


def test_perfect_match():
    gt = _halves()
    p, r, f = fboundary_np(gt, [gt])
    assert p == r == f == 1.0


def test_shifted_within_tolerance():
    gt = _halves(split=30)
    pred = _halves(split=32)  # 2px shift < tol (~0.54 for 40x60... check)
    tol = default_tolerance(40, 60)
    if tol >= 2.0:
        p, r, f = fboundary_np(pred, [gt], tol_frac=0.05)
        assert f == 1.0
    # with a generous tolerance the shifted boundary fully matches
    p, r, f = fboundary_np(pred, [gt], tol_frac=0.05)
    assert f == 1.0
    # with a tiny tolerance it fully misses
    p, r, f = fboundary_np(pred, [gt], tol_frac=1e-6)
    assert f == 0.0


def test_extra_boundaries_reduce_precision_not_recall():
    gt = _halves()
    pred = gt.copy()
    pred[10:20, 10] = 2  # spurious region boundary far from the true one
    pred[10:20, :10] = 2
    p, r, f = fboundary_np(pred, [gt], tol_frac=0.02)
    assert r == 1.0
    assert p < 1.0


def test_multiple_gts_union_precision():
    gt1 = _halves(split=20)
    gt2 = _halves(split=40)
    pred = _halves(split=20)
    p, _, _ = fboundary_np(pred, [gt1, gt2], tol_frac=0.02)
    assert p == 1.0  # matches gt1 fully, union rule


def test_device_matches_host_on_clean_case():
    gt = _halves()
    pred = _halves(split=32)
    tol = 4.0
    prf = np.asarray(fboundary_jax(pred, gt, tol))
    p, r, f = fboundary_np(pred, [gt], tol_frac=tol / np.hypot(40, 60))
    # one-to-one vs dilated agree when boundaries are same-cardinality curves
    np.testing.assert_allclose(prf, [p, r, f], atol=1e-6)


def test_boundary_extraction():
    x = _halves(split=3)
    b = boundaries_np(x)
    assert b[:, 2].all() and not b[:, 0].any() and not b[:, 4].any()


def test_tolerance_monotonicity():
    """F never decreases as the matching tolerance grows (SURVEY.md §4.2)."""
    rng = np.random.default_rng(1)
    pred = (rng.random((40, 60)) < 0.5).astype(np.int32)
    gt = (rng.random((40, 60)) < 0.5).astype(np.int32)
    fs = [fboundary_np(pred, [gt], tol_frac=t)[2] for t in (0.001, 0.01, 0.05, 0.1)]
    assert all(a <= b + 1e-12 for a, b in zip(fs, fs[1:])), fs


def test_device_dt_exactness():
    """The truncated distance transform is exact within its radius."""
    from scipy.ndimage import distance_transform_edt

    from gabor_color_image_segmentation.metrics.boundary import _truncated_sq_dt

    rng = np.random.default_rng(2)
    mask = rng.random((32, 48)) < 0.03
    if not mask.any():
        mask[10, 10] = True
    r = 6
    ours = np.asarray(_truncated_sq_dt(mask, r))
    exact = distance_transform_edt(~mask) ** 2
    inside = exact <= r * r
    np.testing.assert_allclose(ours[inside], exact[inside], atol=1e-4)
    assert (ours[~inside] >= r * r).all()


# ---------------------------------------------------------------------------
# optimal matcher: correctness vs brute force + measured greedy gap
# ---------------------------------------------------------------------------


def _brute_force_max_matching(pairs, n_g):
    """Classic augmenting-path maximum bipartite matching (small instances).

    pairs: list over pred pixels of candidate gt indices."""
    match_g = [-1] * n_g

    def try_augment(i, seen):
        for j in pairs[i]:
            if j in seen:
                continue
            seen.add(j)
            if match_g[j] == -1 or try_augment(match_g[j], seen):
                match_g[j] = i
                return True
        return False

    count = 0
    for i in range(len(pairs)):
        count += try_augment(i, set())
    return count


def test_optimal_matcher_is_maximum_cardinality():
    """Hopcroft-Karp matched count == brute-force optimum on random maps."""
    from gabor_color_image_segmentation.metrics.boundary import (
        _candidate_pairs,
        _match_one,
    )

    rng = np.random.default_rng(0)
    for seed in range(8):
        rng = np.random.default_rng(seed)
        pred = np.zeros((24, 24), bool)
        gt = np.zeros((24, 24), bool)
        pred[rng.random((24, 24)) < 0.12] = True
        gt[rng.random((24, 24)) < 0.12] = True
        tol = 1.6
        pm, gm = _match_one(pred, gt, tol)
        pp, gg = np.argwhere(pred), np.argwhere(gt)
        pairs = _candidate_pairs(pp, gg, tol)
        ref = _brute_force_max_matching([list(js) for js in pairs], len(gg))
        assert int(pm.sum()) == int(gm.sum()) == ref, (pm.sum(), ref)


def test_greedy_gap_measured():
    """The greedy matcher's gap to optimal, MEASURED across seeds. The round-1
    docstring claimed '~1% of optimal' — FALSE: on wavy boundary pairs greedy
    loses up to ~13% of matches (measured 29 vs 33 at tol=3 on seed 100),
    which is exactly why the optimal matcher is now the reported one. The
    pin documents the measured envelope (ratios 0.76-0.94 over these seeds;
    greedy is 1/2-optimal in theory)."""
    from gabor_color_image_segmentation.metrics.boundary import (
        _match_one,
        _match_one_greedy,
    )

    ratios = []
    for seed in range(10):
        rng = np.random.default_rng(100 + seed)
        # jittered segmentation-ish boundaries: two wavy label maps
        x = np.linspace(0, 4 * np.pi, 64)
        split_a = (24 + 5 * np.sin(x + rng.random() * 6)).astype(int)
        split_b = (24 + 5 * np.sin(x + rng.random() * 6)).astype(int)
        a = np.zeros((64, 64), np.int32)
        b = np.zeros((64, 64), np.int32)
        for r in range(64):
            a[r, split_a[r]:] = 1
            b[r, split_b[r]:] = 1
        pa, ga = boundaries_np(a), boundaries_np(b)
        tol = 3.0
        opt = int(_match_one(pa, ga, tol)[0].sum())
        grd = int(_match_one_greedy(pa, ga, tol)[0].sum())
        if opt:
            ratios.append(grd / opt)
            assert grd / opt >= 0.75, (seed, grd, opt)
    assert np.mean(ratios) >= 0.82, ratios


def test_fboundary_matcher_choice():
    """Optimal >= greedy on every aggregate; identical on clean cases."""
    gt = _halves()
    assert fboundary_np(gt, [gt], matcher="greedy") == (1.0, 1.0, 1.0)
    rng = np.random.default_rng(5)
    pred = np.where(rng.random((40, 60)) < 0.5, gt, 1 - gt)
    f_opt = fboundary_np(pred, [gt])[2]
    f_grd = fboundary_np(pred, [gt], matcher="greedy")[2]
    assert f_opt >= f_grd - 1e-12
