"""Golden clustering: numpy Lloyd k-means (deterministic maximin init shared
with the device path) and sklearn-semantics GMM EM.

Init contract (shared with models/kmeans.py): deterministic farthest-point
("maximin") seeding — center 0 is the point farthest from the data mean;
center i maximizes the min squared distance to chosen centers; argmax ties
break to the lowest index. Fully deterministic, so golden and device paths start
from identical centers and label parity is testable without PRNG coupling.
"""

from __future__ import annotations

import numpy as np


def maximin_init_np(x: np.ndarray, k: int) -> np.ndarray:
    """x: (N, D) -> (k, D) deterministic farthest-point centers.

    Distance form mirrors models/kmeans.py maximin_init exactly:
    ||x||^2 - 2 x@c + ||c||^2 (matvec form), so golden and device paths make
    identical seed picks up to dtype rounding."""
    xsq = (x * x).sum(axis=1)

    def dist_to(c):
        return xsq - 2.0 * (x @ c) + (c * c).sum()

    mean = x.mean(axis=0)
    idx = int(np.argmax(dist_to(mean)))
    centers = [x[idx]]
    dmin = dist_to(x[idx])
    for _ in range(k - 1):
        idx = int(np.argmax(dmin))
        centers.append(x[idx])
        dmin = np.minimum(dmin, dist_to(x[idx]))
    return np.stack(centers).astype(x.dtype)


def pool2x2_np(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """(N=h*w, D) -> ((h//2)*(w//2), D) exact 2x2 block means; the numpy
    mirror of models.kmeans.pool2x2 (identical f32 summation order)."""
    h2, w2 = h // 2, w // 2
    d = x.shape[-1]
    g = x[: h * w].reshape(h, w, d)[: 2 * h2, : 2 * w2].astype(np.float32)
    s = (g[0::2, 0::2] + g[0::2, 1::2]) + (g[1::2, 0::2] + g[1::2, 1::2])
    return (0.25 * s).astype(x.dtype).reshape(h2 * w2, d)


def kmeans_golden_multigrid(
    x: np.ndarray, k: int, hw: tuple[int, int], coarse_iters: int,
    refine_iters: int, coarse_levels: int = 1, mid_iters: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Mirror of the device multigrid Lloyd schedule
    (models/kmeans.py::kmeans_multigrid): maximin
    seed + coarse_iters Lloyd on the pooled grid (pool2x2 applied
    ``coarse_levels`` times — level 2 = exact 4x4 block means, because 2x2
    means of 2x2 means ARE the 4x4 mean), then — with mid_iters > 0 —
    mid_iters Lloyd passes at each INTERMEDIATE pooled level ascending
    (coarsest-1 .. the 2x2 level), then refine_iters full-resolution Lloyd
    from the warm centers."""
    x = x.astype(np.float32)
    levels = []
    xp, (h, w) = x, hw
    for _ in range(coarse_levels):
        xp = pool2x2_np(xp, h, w)
        h, w = h // 2, w // 2
        levels.append(xp)
    _, centers = kmeans_golden(levels[-1], k, coarse_iters)
    if mid_iters > 0:
        for xl in reversed(levels[:-1]):
            _, centers = kmeans_golden(xl, k, mid_iters, centers0=centers)
    return kmeans_golden(x, k, refine_iters, centers0=centers)


def kmeans_golden(
    x: np.ndarray, k: int, n_iter: int = 25, init_stride: int = 1,
    centers0: np.ndarray = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd iterations from maximin init. x: (N,D) -> (labels (N,), centers (k,D)).

    Empty-cluster rule (shared contract): an empty cluster keeps its previous
    center. Distance = squared euclidean; label ties -> lowest center index
    (np.argmin behaviour, matches jnp.argmin). init_stride seeds maximin from
    every n-th row — the identical subset the device path uses. centers0
    overrides the init (the multigrid refine stage).
    """
    x = x.astype(np.float32)
    if centers0 is None:
        centers = maximin_init_np(x[::init_stride], k).astype(np.float32)
    else:
        centers = centers0.astype(np.float32).copy()
    labels = np.zeros(x.shape[0], dtype=np.int32)
    # assignment scores drop the per-pixel ||x||^2 (constant across centers)
    # — identical reduction to models/kmeans.py for label parity
    def assign(centers):
        d = (centers**2).sum(axis=1) - 2.0 * (x @ centers.T)
        return np.argmin(d, axis=1).astype(np.int32)

    for _ in range(n_iter):
        labels = assign(centers)
        for j in range(k):
            m = labels == j
            if m.any():
                centers[j] = x[m].mean(axis=0)
    return assign(centers), centers


def gmm_golden(
    x: np.ndarray,
    k: int,
    n_iter: int = 30,
    reg_covar: float = 1e-4,
    tol: float = 0.0,
    hw: tuple[int, int] = None,
    fit_pool: int = 0,
    refine_iters: int = 0,
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Full-covariance GMM EM with k-means (maximin) init; sklearn semantics
    (_gaussian_mixture.py: estimate params / precision cholesky / log prob).

    tol > 0 mirrors models/gmm.py (and sklearn GaussianMixture.tol): stop
    when the mean log-likelihood improves by less than tol between EM
    iterations. fit_pool > 0 (requires hw) mirrors the device pooled-fit
    schedule: the mixture is fitted on the 2x2^fit_pool block-mean grid
    (pool2x2_np applied fit_pool times) and the final E-step labels every
    full-resolution pixel. refine_iters > 0 then runs that many
    full-resolution EM iterations before the final E-step (restores the
    covariance scale the block-mean fit shrinks — device twin:
    models/gmm.py::gmm_fit). Returns (labels (N,), resp (N,k), params
    dict).
    """
    x = x.astype(np.float64)
    n, d = x.shape
    fit_x = x
    if fit_pool > 0:
        # level guard replicated from models/gmm.py::gmm_fit_levels
        # (schedule parity): stop before the grid degenerates or the fit
        # set is tiny
        h, w = hw
        for _ in range(fit_pool):
            if h < 4 or w < 4 or (h // 2) * (w // 2) < 4096:
                break
            fit_x = pool2x2_np(fit_x, h, w)
            h, w = h // 2, w // 2
    m = fit_x.shape[0]
    labels, centers = kmeans_golden(fit_x.astype(np.float32), k, n_iter=10)
    # initial responsibilities from hard k-means labels
    resp = np.zeros((m, k))
    resp[np.arange(m), labels] = 1.0
    weights, means, covs = _m_step(fit_x, resp, reg_covar)
    prev_ll = -np.inf
    for _ in range(n_iter):
        log_resp, ll = _e_step_ll(fit_x, weights, means, covs)
        resp = np.exp(log_resp)
        weights, means, covs = _m_step(fit_x, resp, reg_covar)
        if tol > 0.0 and abs(ll - prev_ll) < tol:
            break
        prev_ll = ll
    for _ in range(refine_iters):  # full-res refinement (see docstring)
        log_resp, _ = _e_step_ll(x, weights, means, covs)
        weights, means, covs = _m_step(x, np.exp(log_resp), reg_covar)
    log_resp = _e_step(x, weights, means, covs)
    labels = np.argmax(log_resp, axis=1).astype(np.int32)
    return labels, np.exp(log_resp), {"weights": weights, "means": means, "covs": covs}


def _m_step(x, resp, reg_covar):
    n, d = x.shape
    k = resp.shape[1]
    nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
    means = (resp.T @ x) / nk[:, None]
    covs = np.empty((k, d, d))
    for j in range(k):
        diff = x - means[j]
        covs[j] = (resp[:, j][:, None] * diff).T @ diff / nk[j]
        covs[j].flat[:: d + 1] += reg_covar
    return nk / n, means, covs


def _e_step_ll(x, weights, means, covs):
    """(log responsibilities, mean log-likelihood) — the EM convergence
    statistic is the mean of the log-sum-exp normalizer (sklearn's
    lower_bound_), mirrored in models/gmm.py::_e_step."""
    n, d = x.shape
    k = means.shape[0]
    log_prob = np.empty((n, k))
    for j in range(k):
        chol = np.linalg.cholesky(covs[j])
        y = np.linalg.solve(chol, (x - means[j]).T)
        maha = (y**2).sum(axis=0)
        log_det = np.log(np.diag(chol)).sum()
        log_prob[:, j] = -0.5 * (d * np.log(2 * np.pi) + maha) - log_det
    weighted = log_prob + np.log(weights)
    norm = _logsumexp(weighted)
    return weighted - norm[:, None], norm.mean()


def _e_step(x, weights, means, covs):
    """Log responsibilities via precision Cholesky (sklearn formulation)."""
    n, d = x.shape
    k = means.shape[0]
    log_prob = np.empty((n, k))
    for j in range(k):
        chol = np.linalg.cholesky(covs[j])  # lower
        # y = chol^{-1} (x - mu)^T  => mahalanobis = ||y||^2
        y = np.linalg.solve(chol, (x - means[j]).T)
        maha = (y**2).sum(axis=0)
        log_det = np.log(np.diag(chol)).sum()
        log_prob[:, j] = -0.5 * (d * np.log(2 * np.pi) + maha) - log_det
    weighted = log_prob + np.log(weights)
    norm = _logsumexp(weighted)
    return weighted - norm[:, None]


def _logsumexp(a: np.ndarray) -> np.ndarray:
    m = a.max(axis=1)
    return m + np.log(np.exp(a - m[:, None]).sum(axis=1))
