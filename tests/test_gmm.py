"""GMM EM golden parity + sklearn cross-check (SURVEY.md C9)."""

import numpy as np
import pytest

from gabor_color_image_segmentation.models.gmm import gmm_fit
from gabor_color_image_segmentation.utils.labels import align_labels
from golden.cluster import gmm_golden


def _blobs(rng, n=1500, k=3, d=6, spread=0.15):
    centers = rng.normal(size=(k, d)) * 3.0
    labels = rng.integers(0, k, n)
    x = centers[labels] + rng.normal(size=(n, d)) * spread * (1 + labels[:, None])
    return x.astype(np.float32), labels


def test_labels_match_golden(rng):
    x, _ = _blobs(rng)
    ours, resp, _ = gmm_fit(x, 3, n_iter=30)
    gold, gresp, _ = gmm_golden(x, 3, n_iter=30)
    agree = (np.asarray(ours) == gold).mean()
    assert agree > 0.995, f"label agreement {agree}"
    # responsibilities: fp32 EM vs float64 EM
    np.testing.assert_allclose(np.asarray(resp), gresp, atol=5e-2)


def test_recovers_true_clusters(rng):
    x, true = _blobs(rng, n=3000, k=4, d=8, spread=0.1)
    labels, _, _ = gmm_fit(x, 4, n_iter=30)
    aligned = align_labels(np.asarray(labels), true)
    assert (aligned == true).mean() > 0.99


def test_matches_sklearn_quality(rng):
    """Comparable log-likelihood to sklearn GaussianMixture."""
    from sklearn.mixture import GaussianMixture

    x, _ = _blobs(rng, n=2000, k=3, d=5)
    _, _, params = gmm_fit(x, 3, n_iter=40)
    sk = GaussianMixture(3, max_iter=40, reg_covar=1e-4, random_state=0).fit(x)

    from scipy.stats import multivariate_normal

    def loglik(weights, means, covs):
        probs = np.stack(
            [
                w * multivariate_normal.pdf(x, m, c, allow_singular=True)
                for w, m, c in zip(weights, means, covs)
            ]
        ).sum(0)
        return np.log(np.maximum(probs, 1e-300)).mean()

    ours = loglik(
        np.asarray(params.weights), np.asarray(params.means), np.asarray(params.covs)
    )
    theirs = loglik(sk.weights_, sk.means_, sk.covariances_)
    assert ours > theirs - 0.05, (ours, theirs)


def test_weights_sum_to_one(rng):
    x, _ = _blobs(rng, n=800, k=3)
    _, resp, params = gmm_fit(x, 3, n_iter=10)
    np.testing.assert_allclose(float(np.asarray(params.weights).sum()), 1.0, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(resp).sum(axis=1), np.ones(x.shape[0]), atol=1e-4
    )


def test_subsampled_close_to_exact(rng):
    from gabor_color_image_segmentation.models.gmm import gmm_predict
    from gabor_color_image_segmentation.utils.labels import align_labels

    x, _ = _blobs(rng, n=3000, k=3, d=6, spread=0.1)
    exact = np.asarray(gmm_predict(x, 3, 20))
    fast = np.asarray(gmm_predict(x, 3, 20, subsample=4))
    aligned = align_labels(fast, exact)
    assert (aligned == exact).mean() > 0.98


def test_tol_early_exit_matches_golden(rng):
    """sklearn-style tol early exit: device path and golden stop by the same
    rule and agree on labels (f32 vs f64 may differ by an iteration near
    convergence — responsibilities there are already stable)."""
    x, _ = _blobs(rng)
    ours, resp, _ = gmm_fit(x, 3, n_iter=30, tol=1e-3)
    gold, gresp, _ = gmm_golden(x, 3, n_iter=30, tol=1e-3)
    agree = (np.asarray(ours) == gold).mean()
    assert agree > 0.99, f"label agreement {agree}"
    np.testing.assert_allclose(np.asarray(resp), gresp, atol=6e-2)


def test_tol_zero_is_fixed_count(rng):
    """tol=0 is bit-identical to the fixed-iteration contract."""
    x, _ = _blobs(rng, n=800, k=3, d=5)
    a, ra, _ = gmm_fit(x, 3, n_iter=12)
    b, rb, _ = gmm_fit(x, 3, n_iter=12, tol=0.0)
    assert (np.asarray(a) == np.asarray(b)).all()
    np.testing.assert_array_equal(np.asarray(ra), np.asarray(rb))




def _patch_image(rng, h, w, d, k):
    region = (np.arange(h)[:, None] // 16 * 5 + np.arange(w)[None, :] // 20) % k
    centers = rng.normal(size=(k, d)) * 2.5
    scale = 0.2 + 0.1 * np.arange(k)[region.reshape(-1), None]
    return (
        centers[region.reshape(-1)] + rng.normal(size=(h * w, d)) * scale
    ).astype(np.float32)


# (n_iter, tol, fit_pool, refine_iters, h, w)
GMM_CASES = {
    "fixed_count": (12, 0.0, 0, 0, 48, 64),
    "tol": (30, 1e-3, 0, 0, 48, 64),
    "pooled_fit_refine": (30, 1e-3, 2, 1, 160, 224),
}


@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_batch_matches_golden(case, rng):
    """The vmapped XLA EM (the pipeline's GMM path) against golden per
    image: fixed count, sklearn tol, and config2's pooled fit + refine."""
    import jax
    import jax.numpy as jnp

    from gabor_color_image_segmentation.models.gmm import gmm_predict

    n_iter, tol, pool, refine, h, w = GMM_CASES[case]
    k, d = 4, 6
    xs = np.stack([_patch_image(rng, h, w, d, k) for _ in range(2)])
    labels = np.asarray(jax.vmap(
        lambda x: gmm_predict(x, k, n_iter, 1e-4, 1, tol, (h, w), pool, refine)
    )(jnp.asarray(xs)))
    for i in range(2):
        gold, _, _ = gmm_golden(xs[i], k, n_iter, 1e-4, tol, (h, w), pool, refine)
        agree = (align_labels(labels[i], gold) == gold).mean()
        assert agree > 0.999, f"{case} image {i}: agreement {agree}"
