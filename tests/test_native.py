"""C++ native boundary matcher: builds, loads, matches the Python fallback."""

import numpy as np

from gabor_color_image_segmentation.utils import native


def test_builds_and_loads():
    assert native.get_lib() is not None, "g++ build of native matcher failed"


def test_matches_python_fallback(rng):
    from gabor_color_image_segmentation.metrics import boundary

    pred = rng.integers(0, 60, (200, 2)).astype(np.int32)
    gt = rng.integers(0, 60, (180, 2)).astype(np.int32)
    tol = 3.0
    n_pm, n_gm = native.greedy_match_native(pred, gt, tol)

    # force the python fallback by monkeypatching
    import gabor_color_image_segmentation.utils.native as nat

    real = nat.greedy_match_native
    try:
        nat.greedy_match_native = lambda *a, **k: None
        pb = np.zeros((64, 64), bool)
        gb = np.zeros((64, 64), bool)
        pb[pred[:, 0], pred[:, 1]] = True
        gb[gt[:, 0], gt[:, 1]] = True
        # duplicate coordinates collapse in the mask form; compare counts via
        # unique points instead
        up = np.unique(pred, axis=0)
        ug = np.unique(gt, axis=0)
        n_pm2, n_gm2 = real(up, ug, tol)
        pm_py, gm_py = boundary._match_one_greedy(pb, gb, tol)
        assert n_pm2.sum() == pm_py.sum()
        assert n_gm2.sum() == gm_py.sum()
    finally:
        nat.greedy_match_native = real


def test_counts_sane():
    pred = np.array([[0, 0], [0, 5], [0, 10]], np.int32)
    gt = np.array([[1, 0], [1, 5]], np.int32)
    pm, gm = native.greedy_match_native(pred, gt, 2.0)
    assert pm.sum() == 2 and gm.sum() == 2
    assert not pm[2]
