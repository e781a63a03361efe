"""JAX full-covariance GMM with per-image EM (SURVEY.md C9).

sklearn semantics (_gaussian_mixture.py: _estimate_gaussian_parameters /
_compute_precision_cholesky / _estimate_log_gaussian_prob; _base.py e-step),
in batched matmul form:

  * init: hard responsibilities from deterministic k-means (models/kmeans.py)
  * M-step: means via one-hot-style matmul; covariances via the
    E[xx^T] - mu mu^T form (k small static -> k matmuls of (D,N)@(N,D)),
    never materializing the (N,k,D) diff tensor
  * E-step: batched Cholesky + triangular solve for Mahalanobis, log-sum-exp
    responsibilities
  * fixed iteration count (lax.fori_loop) so the solver vmaps over a batch

Everything fp32 (features are standardized, reg_covar stabilizes Cholesky);
the golden path (golden/cluster.py gmm_golden) is float64 — parity tests use
responsibility tolerances + label agreement.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from gabor_color_image_segmentation.models.kmeans import kmeans
from gabor_color_image_segmentation.ops.precision import precision_for

_LOG2PI = 1.8378770664093453


class GMMParams(NamedTuple):
    weights: jnp.ndarray  # (k,)
    means: jnp.ndarray  # (k, D)
    covs: jnp.ndarray  # (k, D, D)


def _m_step(x: jnp.ndarray, resp: jnp.ndarray, reg_covar: float) -> GMMParams:
    n, d = x.shape
    k = resp.shape[1]
    nk = jnp.sum(resp, axis=0) + 10.0 * jnp.finfo(resp.dtype).eps  # (k,)
    # HIGHEST: a DEFAULT f32 dot may round its operands (TF32 on the GPU),
    # which can drive a full-size image's EM into a different basin
    means = jnp.dot(resp.T, x, preferred_element_type=jnp.float32,
                    precision=precision_for(jnp.float32)) / nk[:, None]

    def cov_j(j):
        rx = resp[:, j : j + 1] * x  # (N, D)
        exx = jnp.dot(x.T, rx, preferred_element_type=jnp.float32,
                      precision=precision_for(jnp.float32)) / nk[j]
        c = exx - jnp.outer(means[j], means[j])
        return c + reg_covar * jnp.eye(d, dtype=x.dtype)

    covs = jnp.stack([cov_j(j) for j in range(k)])
    return GMMParams(nk / n, means, covs)


def _log_prob(x: jnp.ndarray, params: GMMParams) -> jnp.ndarray:
    """(N, D) -> (N, k) weighted log prob log w_j + log N(x | mu_j, S_j).

    Mahalanobis distances via a triangular solve against each component's
    Cholesky factor (batched library calls)."""
    n, d = x.shape

    def per_component(mean, cov):
        chol = jnp.linalg.cholesky(cov)  # lower
        diff = (x - mean).T  # (D, N)
        y = jax.scipy.linalg.solve_triangular(chol, diff, lower=True)
        maha = jnp.sum(y * y, axis=0)  # (N,)
        log_det = jnp.sum(jnp.log(jnp.diagonal(chol)))
        return -0.5 * (d * _LOG2PI + maha) - log_det

    lp = jax.vmap(per_component)(params.means, params.covs)  # (k, N)
    return lp.T + jnp.log(params.weights)


def _e_step(x: jnp.ndarray, params: GMMParams) -> Tuple[jnp.ndarray, jnp.ndarray]:
    weighted = _log_prob(x, params)
    norm = jax.scipy.special.logsumexp(weighted, axis=1, keepdims=True)
    return weighted - norm, jnp.mean(norm)


def gmm_fit_levels(h: int, w: int, fit_pool: int) -> Tuple[int, int, int]:
    """Pooled-fit grid actually used: number of 2x2 poolings applied (each
    level needs a non-degenerate grid and >= 4096 pooled pixels) and the
    resulting (h, w). Single source of truth for the schedule — this
    solver and golden both follow it."""
    lv = 0
    while (
        lv < fit_pool and h >= 4 and w >= 4
        and (h // 2) * (w // 2) >= 4096
    ):
        h, w = h // 2, w // 2
        lv += 1
    return h, w, lv


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7, 8))
def gmm_fit(
    x: jnp.ndarray,
    k: int,
    n_iter: int = 30,
    reg_covar: float = 1e-4,
    kmeans_iters: int = 10,
    tol: float = 0.0,
    hw: Tuple[int, int] = None,
    fit_pool: int = 0,
    refine_iters: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray, GMMParams]:
    """(N, D) -> (labels (N,) int32, resp (N, k), params). vmap for batches.

    tol > 0 enables sklearn's convergence rule (GaussianMixture tol,
    _base.py fit_predict): stop when the mean log-likelihood improves by
    less than tol between EM iterations. tol=0 runs exactly n_iter
    iterations (the fixed-count contract shared with golden/cluster.py).

    fit_pool > 0 (requires hw): the mixture is fitted on the
    2x2^fit_pool-mean-pooled pixel grid (models.kmeans.pool2x2 applied
    fit_pool times — exact block means) and only the final E-step labels
    the full-resolution pixels. Same schedule as golden/cluster.py::gmm_golden.

    refine_iters > 0: that many full-resolution EM iterations run after
    the (pooled) fit loop, before the final E-step — restores the
    covariance scale that the block-mean fit shrinks."""
    x = x.astype(jnp.float32)
    fit_x = x
    if fit_pool > 0:
        from gabor_color_image_segmentation.models.kmeans import pool2x2

        h, w = hw
        _, _, lv = gmm_fit_levels(h, w, fit_pool)
        for _ in range(lv):
            fit_x = pool2x2(fit_x, h, w)
            h, w = h // 2, w // 2
    init_labels, _ = kmeans(fit_x, k, kmeans_iters)
    resp0 = jax.nn.one_hot(init_labels, k, dtype=jnp.float32)
    params0 = _m_step(fit_x, resp0, reg_covar)

    def em(params):
        log_resp, ll = _e_step(fit_x, params)
        return _m_step(fit_x, jnp.exp(log_resp), reg_covar), ll

    if tol == 0.0:
        params = lax.fori_loop(0, n_iter, lambda _, p: em(p)[0], params0)
    else:

        def cond(carry):
            return carry[3]

        def body(carry):
            i, params, prev_ll, _ = carry
            new, ll = em(params)
            go = (i + 1 < n_iter) & (jnp.abs(ll - prev_ll) >= tol)
            return i + 1, new, ll, go

        _, params, _, _ = lax.while_loop(
            cond, body, (jnp.int32(0), params0, jnp.float32(-jnp.inf), n_iter > 0)
        )
    for _ in range(refine_iters):  # full-res refinement (see docstring)
        log_resp, _ = _e_step(x, params)
        params = _m_step(x, jnp.exp(log_resp), reg_covar)
    log_resp, _ = _e_step(x, params)
    labels = jnp.argmax(log_resp, axis=1).astype(jnp.int32)
    return labels, jnp.exp(log_resp), params


def gmm_predict(
    x: jnp.ndarray,
    k: int,
    n_iter: int = 30,
    reg_covar: float = 1e-4,
    subsample: int = 1,
    tol: float = 0.0,
    hw: Tuple[int, int] = None,
    fit_pool: int = 0,
    refine_iters: int = 0,
) -> jnp.ndarray:
    """Labels-only entry used by the pipeline.

    subsample > 1 fits EM on every n-th pixel and runs one final E-step over
    all pixels (documented speed knob, exact when 1 — same contract as
    kmeans_fit_assign). fit_pool > 0 fits on the pooled grid instead (see
    gmm_fit, incl. refine_iters); the two knobs are mutually exclusive."""
    if subsample == 1:
        return gmm_fit(x, k, n_iter, reg_covar, 10, tol, hw, fit_pool,
                       refine_iters)[0]
    x = x.astype(jnp.float32)
    _, _, params = gmm_fit(x[::subsample], k, n_iter, reg_covar, 10, tol)
    log_resp, _ = _e_step(x, params)
    return jnp.argmax(log_resp, axis=1).astype(jnp.int32)
