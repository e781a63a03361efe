"""JAX k-means (SURVEY.md C8) — batched Lloyd iterations.

Both Lloyd steps are matmuls: the assignment step's pairwise distances are one
matmul (||x||^2 - 2 x.c + ||c||^2), the update step is a one-hot matmul
(centers = onehot(labels)^T @ x / counts). Iteration count is static
(lax.fori_loop) so the whole solver jits and vmaps over a batch of images.

Init contract (shared with golden/cluster.py): deterministic farthest-point
("maximin") seeding — no PRNG, so the golden CPU path and this path start
identically and final labels are comparable without permutation games.
Empty-cluster rule: keep the previous center. Ties: lowest index (argmin /
argmax first-hit, identical in numpy and jnp).

sklearn's Lloyd (_kmeans.py:630 _kmeans_single_lloyd) is the semantic model;
the k-means++ PRNG init is replaced by the deterministic seeding above.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from gabor_color_image_segmentation.ops.precision import (
    precision_for as _precision_for,
)


def maximin_init(x: jnp.ndarray, k: int, stride: int = 1) -> jnp.ndarray:
    """x: (N, D) -> (k, D) deterministic farthest-point centers.

    ``stride`` seeds from every stride-th row only — the farthest-point
    scan is k sequential full passes over x, which at BSDS scale costs as
    much as several Lloyd iterations; a strided subset keeps determinism
    (golden mirrors the identical subset) at ~1/stride the cost.

    Distance form: ||x||^2 is precomputed once, then each step's distance to
    the new center is xsq - 2 x@c + ||c||^2 — one matvec per step; golden
    mirrors the identical form, so seeds agree exactly."""
    x = jnp.asarray(x)  # fori_loop body indexes x with a traced index
    if stride > 1:
        x = x[::stride]
    n, d = x.shape
    # single-use cast: a named f32 alias of x would materialize a full copy
    xsq = jnp.sum(jnp.square(x.astype(jnp.float32)), axis=1)  # (N,) f32

    def dist_to(c):
        cf = c.astype(jnp.float32)
        cross = jnp.dot(
            x, c, preferred_element_type=jnp.float32,
            precision=_precision_for(x.dtype),
        )
        return xsq - 2.0 * cross + jnp.sum(cf * cf)

    mean = jnp.mean(x, axis=0, dtype=jnp.float32).astype(x.dtype)
    idx0 = jnp.argmax(dist_to(mean))
    c0 = x[idx0]
    centers = jnp.zeros((k, d), x.dtype).at[0].set(c0)
    dmin = dist_to(c0)

    def body(i, carry):
        centers, dmin = carry
        idx = jnp.argmax(dmin)
        c = x[idx]
        centers = centers.at[i].set(c)
        dmin = jnp.minimum(dmin, dist_to(c))
        return centers, dmin

    # the last center needs only argmax(dmin) — updating dmin for it would be
    # a full wasted pass over x
    centers, dmin = lax.fori_loop(1, k - 1, body, (centers, dmin))
    if k > 1:
        centers = centers.at[k - 1].set(x[jnp.argmax(dmin)])
    return centers


def pool2x2(x: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """(..., N=h*w, D) pixel features -> (..., (h//2)*(w//2), D) exact 2x2
    block means (odd edge row/col cropped from the POOLED view only).

    Ordered f32 sum ((x00 + x01) + (x10 + x11)) * 0.25, cast back to x.dtype
    — golden/cluster.py::pool2x2_np mirrors the identical order. This is the
    coarse grid of the multigrid Lloyd schedule (ClusterConfig.coarse_iters).
    """
    h2, w2 = h // 2, w // 2
    lead, d = x.shape[:-2], x.shape[-1]
    g = x[..., : h * w, :].reshape(*lead, h, w, d)
    g = g[..., : 2 * h2, : 2 * w2, :].astype(jnp.float32)
    s = (g[..., 0::2, 0::2, :] + g[..., 0::2, 1::2, :]) + (
        g[..., 1::2, 0::2, :] + g[..., 1::2, 1::2, :]
    )
    return (0.25 * s).astype(x.dtype).reshape(*lead, h2 * w2, d)


def _assign_scores(x: jnp.ndarray, centers: jnp.ndarray, dtype) -> jnp.ndarray:
    """(N,D), (k,D) -> (N,k) assignment scores c_sq - 2 x.c (one matmul).

    The pixel's own ||x||^2 is constant across centers, so it is dropped from
    the argmin — same labels, one fewer pass over x (the golden path applies
    the identical reduction so label parity is exact)."""
    c_sq = jnp.sum(centers * centers, axis=1)
    cross = jnp.dot(
        x.astype(dtype),
        centers.T.astype(dtype),
        preferred_element_type=jnp.float32,
        precision=_precision_for(dtype),
    )
    return c_sq - 2.0 * cross


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def kmeans(
    x: jnp.ndarray,
    k: int,
    n_iter: int = 25,
    dtype=jnp.float32,
    init_stride: int = 1,
    centers0: jnp.ndarray = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Lloyd k-means. x: (N, D) float -> (labels (N,) int32, centers (k, D)).

    vmap over a leading batch axis for per-image clustering of a batch.
    dtype=bfloat16 halves the Lloyd-loop HBM traffic (the dominant cost at
    D ~ 243); labels may differ from the fp32 path on borderline pixels.
    init_stride seeds maximin from a strided subset (golden mirrors it).
    centers0 overrides the init (used by kmeans_batch to hoist large-image
    inits out of the vmap — see there); must equal maximin_init's output
    for golden parity.
    """
    # keep x in the matmul dtype throughout — upcasting a bf16 feature tensor
    # to f32 here would double the Lloyd loop's HBM traffic
    x_mm = x.astype(dtype)
    if centers0 is None:
        centers0 = maximin_init(x_mm, k, init_stride).astype(jnp.float32)
    else:
        centers0 = centers0.astype(jnp.float32)

    def step(centers):
        labels = jnp.argmin(_assign_scores(x_mm, centers, dtype), axis=1)
        onehot = jax.nn.one_hot(labels, k, dtype=dtype)  # (N,k)
        counts = jnp.sum(onehot.astype(jnp.float32), axis=0)  # (k,)
        sums = jnp.dot(
            onehot.T, x_mm, preferred_element_type=jnp.float32,
            precision=_precision_for(dtype),
        )
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        return jnp.where(counts[:, None] > 0, new, centers)

    # Early exit at the Lloyd fixed point (sklearn's tol=0 semantics): once
    # centers stop changing, every further iteration is a no-op, so stopping
    # is bitwise-identical to running the full n_iter. Under vmap the batched
    # while_loop runs until the slowest image converges.
    def cond(carry):
        i, centers, changed = carry
        return (i < n_iter) & changed

    def body(carry):
        i, centers, _ = carry
        new = step(centers)
        return i + 1, new, jnp.any(new != centers)

    # init flag is data-derived (always True) rather than a literal: under
    # shard_map on a multi-axis mesh the body's flag is VARYING over the
    # other mesh axes whenever x is, and while_loop requires the init
    # carry's vma type to match (parallel/tiled_graph.py runs this solver
    # replicated inside the distributed cut chain)
    true0 = jnp.any(centers0 == centers0)
    _, centers, _ = lax.while_loop(cond, body, (jnp.int32(0), centers0, true0))
    labels = jnp.argmin(_assign_scores(x_mm, centers, dtype), axis=1).astype(
        jnp.int32
    )
    return labels, centers


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def kmeans_fit_assign(
    x: jnp.ndarray,
    k: int,
    n_iter: int = 25,
    dtype=jnp.float32,
    subsample: int = 1,
    init_stride: int = 1,
    centers0: jnp.ndarray = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Lloyd on every ``subsample``-th pixel, final assignment on all pixels.

    subsample=1 is exactly ``kmeans``. Larger values cut the Lloyd-loop HBM
    traffic by that factor (the dominant e2e cost at D ~ 243) at the price of
    centers fitted on a strided pixel subset — a documented speed/parity
    trade-off (OFF by default in every preset). centers0 (if given) must be
    the maximin init of the SUBSAMPLED view."""
    if subsample == 1:
        return kmeans(x, k, n_iter, dtype, init_stride, centers0)
    _, centers = kmeans(x[::subsample], k, n_iter, dtype, init_stride, centers0)
    labels = jnp.argmin(
        _assign_scores(x.astype(dtype), centers, dtype), axis=1
    ).astype(jnp.int32)
    return labels, centers


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7))
def kmeans_multigrid(
    x: jnp.ndarray,
    k: int,
    hw: Tuple[int, int],
    coarse_iters: int,
    refine_iters: int,
    dtype=jnp.float32,
    coarse_levels: int = 1,
    mid_iters: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Multigrid Lloyd (XLA path): maximin seed + ``coarse_iters`` Lloyd
    iterations on the pooled grid (pool2x2 applied ``coarse_levels`` times;
    level 2 = exact 4x4 block means), optionally ``mid_iters`` Lloyd
    iterations at each intermediate pooled level (ascending), then up to
    ``refine_iters`` full-resolution iterations (fixed-point early exit)
    and a full-res assignment. x: (N, D) with N = h*w. Deterministic
    schedule, mirrored by golden/cluster.py::kmeans_golden_multigrid."""
    levels = []
    xp, (h, w) = x, hw
    for _ in range(coarse_levels):
        xp = pool2x2(xp, h, w)
        h, w = h // 2, w // 2
        levels.append(xp)
    _, centers = kmeans(levels[-1], k, coarse_iters, dtype)
    if mid_iters > 0:
        for xl in reversed(levels[:-1]):
            _, centers = kmeans(xl, k, mid_iters, dtype, centers0=centers)
    return kmeans(x, k, refine_iters, dtype, centers0=centers)


def kmeans_batch(
    x: jnp.ndarray,
    k: int,
    n_iter: int = 25,
    dtype=jnp.float32,
    subsample: int = 1,
    init_stride: int = 1,
    hw: Tuple[int, int] = None,
    coarse_iters: int = 0,
    refine_iters: int = 10,
    coarse_levels: int = 1,
    mid_iters: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched per-image k-means: (B, N, D) -> ((B, N) labels, (B, k, D)).

    Multigrid schedule when ``coarse_iters`` > 0 (and ``hw`` given, no
    subsampling); otherwise plain Lloyd on every ``subsample``-th pixel."""
    multigrid = (
        coarse_iters > 0 and hw is not None
        and subsample == 1 and init_stride == 1
        and hw[0] >= (1 << coarse_levels) and hw[1] >= (1 << coarse_levels)
    )
    fit_view = x if subsample == 1 else x[:, ::subsample]
    if multigrid:
        return jax.vmap(
            lambda f: kmeans_multigrid(
                f, k, hw, coarse_iters, refine_iters, dtype, coarse_levels,
                mid_iters,
            )
        )(x)
    centers0 = None
    if fit_view.shape[1] > 1_000_000:
        # large images: the vmapped init would keep a temporary the size
        # of the whole batch live; a sequential lax.map keeps one image's.
        # Same maximin math -> same seeds -> parity unchanged.
        centers0 = lax.map(
            lambda xi: maximin_init(xi.astype(dtype), k, init_stride).astype(
                jnp.float32
            ),
            fit_view,
        )
    fit = lambda f, c0: kmeans_fit_assign(
        f, k, n_iter, dtype, subsample, init_stride, c0
    )
    if centers0 is None:
        labels, centers = jax.vmap(lambda f: fit(f, None))(x)
    else:
        labels, centers = jax.vmap(fit)(x, centers0)
    return labels, centers


def kmeans_image(
    features: jnp.ndarray, k: int, n_iter: int = 25
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(H, W, D) features -> ((H, W) int32 labels, (k, D) centers)."""
    h, w, d = features.shape
    labels, centers = kmeans(features.reshape(h * w, d), k, n_iter)
    return labels.reshape(h, w), centers
