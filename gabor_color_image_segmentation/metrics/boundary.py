"""Boundary F-measure, BSDS500 protocol (SURVEY.md C16).

Boundary extraction: a pixel is boundary iff its label differs from its
right or down neighbor (thin, deterministic, identical host/device).

Matching (tolerance = 0.0075 * image diagonal, the BSDS default):

  * ``fboundary_np`` — host, EXACT one-to-one matching. The BSDS bench's
    CSA assignment maximizes the number of matches within tolerance (the
    distances only order equal-cardinality solutions), and precision/recall
    depend ONLY on that count — so maximum-cardinality bipartite matching
    (scipy's Hopcroft-Karp over the tolerance graph) reports the exact
    protocol number. This is the reported matcher.
  * ``_match_one_greedy`` — the previous greedy-by-increasing-distance
    matcher (C++ native / cKDTree); kept as the fast approximate variant.
    Its gap to optimal is MEASURED, not asserted — and the round-1 "~1% of
    optimal" folklore was WRONG: tests/test_boundary.py measures up to
    ~13% fewer matches on wavy boundary pairs, which is why the optimal
    matcher is the reported number now.
  * ``fboundary_jax`` — device, the standard "loose" dilated matching used
    for fast iteration: a boundary pixel matches if ANY counterpart lies
    within tolerance (no uniqueness). Computed with an exact truncated
    Euclidean distance transform done as two separable 1-D min-plus passes
    (vectorized shifts -> VPU friendly).

Per BSDS convention with multiple human GTs: precision counts a predicted
pixel as correct if it matches ANY human's boundary; recall accumulates
matched GT pixels over ALL humans.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# boundary extraction
# ---------------------------------------------------------------------------


def boundaries_np(labels: np.ndarray) -> np.ndarray:
    b = np.zeros(labels.shape, bool)
    b[:, :-1] |= labels[:, :-1] != labels[:, 1:]
    b[:-1, :] |= labels[:-1, :] != labels[1:, :]
    return b


def boundaries_jax(labels: jnp.ndarray) -> jnp.ndarray:
    h = jnp.pad(labels[:, :-1] != labels[:, 1:], ((0, 0), (0, 1)))
    v = jnp.pad(labels[:-1, :] != labels[1:, :], ((0, 1), (0, 0)))
    return h | v


def default_tolerance(h: int, w: int, frac: float = 0.0075) -> float:
    return frac * math.hypot(h, w)


# ---------------------------------------------------------------------------
# host: greedy one-to-one matching (the reported number)
# ---------------------------------------------------------------------------


def _candidate_pairs(pp: np.ndarray, gg: np.ndarray, tol: float):
    """cKDTree candidate lists: for each pred pixel, gt indices within tol."""
    from scipy.spatial import cKDTree

    tree = cKDTree(gg)
    return tree.query_ball_point(pp, r=tol)


def _match_one_greedy(pred_b: np.ndarray, gt_b: np.ndarray, tol: float):
    """One-to-one GREEDY matching by increasing distance. Returns
    (pred_matched, gt_matched) masks over the respective boundary-pixel
    lists. Uses the C++ native matcher when available (utils/native.py);
    identical tie-break (d, i, j) in the Python fallback. Approximate:
    tests pin its measured gap to the optimal matcher."""
    pp = np.argwhere(pred_b)
    gg = np.argwhere(gt_b)
    pm = np.zeros(len(pp), bool)
    gm = np.zeros(len(gg), bool)
    if len(pp) == 0 or len(gg) == 0:
        return pm, gm

    from gabor_color_image_segmentation.utils.native import greedy_match_native

    native = greedy_match_native(pp, gg, tol)
    if native is not None:
        return native

    pairs = _candidate_pairs(pp, gg, tol)
    cand = [
        (float(np.hypot(*(pp[i] - gg[j]))), i, j)
        for i, js in enumerate(pairs)
        for j in js
    ]
    cand.sort()
    for _, i, j in cand:
        if not pm[i] and not gm[j]:
            pm[i] = True
            gm[j] = True
    return pm, gm


def _match_one(pred_b: np.ndarray, gt_b: np.ndarray, tol: float):
    """One-to-one OPTIMAL matching (maximum-cardinality bipartite matching
    on the within-tolerance graph, Hopcroft-Karp). Precision/recall depend
    only on the match count, so this reports the exact BSDS CSA number."""
    pp = np.argwhere(pred_b)
    gg = np.argwhere(gt_b)
    pm = np.zeros(len(pp), bool)
    gm = np.zeros(len(gg), bool)
    if len(pp) == 0 or len(gg) == 0:
        return pm, gm

    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    pairs = _candidate_pairs(pp, gg, tol)
    lens = np.fromiter((len(js) for js in pairs), np.int64, len(pairs))
    indptr = np.concatenate([[0], np.cumsum(lens)])
    if indptr[-1] == 0:
        return pm, gm
    indices = np.concatenate(
        [np.asarray(js, np.int64) for js in pairs if len(js)]
    )
    graph = csr_matrix(
        (np.ones(indptr[-1], np.int8), indices, indptr),
        shape=(len(pp), len(gg)),
    )
    match = maximum_bipartite_matching(graph, perm_type="column")
    pm = match != -1
    gm[match[pm]] = True
    return pm, gm


def fboundary_np(
    pred_labels: np.ndarray,
    gts: Sequence[np.ndarray],
    tol_frac: float = 0.0075,
    matcher: str = "optimal",
) -> Tuple[float, float, float]:
    """BSDS boundary benchmark for one image -> (precision, recall, F).

    matcher="optimal" (reported): exact maximum-cardinality matching.
    matcher="greedy": the approximate distance-greedy variant."""
    h, w = pred_labels.shape
    tol = default_tolerance(h, w, tol_frac)
    match = _match_one if matcher == "optimal" else _match_one_greedy
    pred_b = boundaries_np(pred_labels)
    pp_n = int(pred_b.sum())
    pred_matched = np.zeros(pp_n, bool)
    sum_r = 0
    cnt_r = 0
    for gt in gts:
        gt_b = boundaries_np(gt)
        pm, gm = match(pred_b, gt_b, tol)
        pred_matched |= pm
        sum_r += int(gm.sum())
        cnt_r += int(gt_b.sum())
    precision = pred_matched.sum() / max(pp_n, 1)
    recall = sum_r / max(cnt_r, 1)
    f = 2 * precision * recall / max(precision + recall, 1e-12)
    return float(precision), float(recall), float(f)


# ---------------------------------------------------------------------------
# device: dilated matching via truncated Euclidean distance transform
# ---------------------------------------------------------------------------


def _truncated_sq_dt(mask: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Exact squared Euclidean distance transform, truncated at `radius`
    (values > radius^2 are clamped to radius^2 + 1). Two separable 1-D
    min-plus passes over vectorized shifts — O(radius) VPU ops."""
    big = jnp.float32(radius * radius + 1)
    d = jnp.where(mask, 0.0, big)  # (H, W)

    def pass_axis(d, axis):
        out = d
        for s in range(1, radius + 1):
            shifted_f = jnp.full_like(d, big)
            shifted_b = jnp.full_like(d, big)
            if axis == 0:
                shifted_f = shifted_f.at[s:, :].set(d[:-s, :] + s * s)
                shifted_b = shifted_b.at[:-s, :].set(d[s:, :] + s * s)
            else:
                shifted_f = shifted_f.at[:, s:].set(d[:, :-s] + s * s)
                shifted_b = shifted_b.at[:, :-s].set(d[:, s:] + s * s)
            out = jnp.minimum(out, jnp.minimum(shifted_f, shifted_b))
        return out

    # exact 2-D: column pass on 0/big field, then row pass min-plus combines
    d = pass_axis(d, 0)
    d = pass_axis(d, 1)
    return jnp.minimum(d, big)


@partial(jax.jit, static_argnums=(2,))
def fboundary_jax(
    pred_labels: jnp.ndarray, gt_labels: jnp.ndarray, tol: float
) -> jnp.ndarray:
    """Dilated-matching (P, R, F) for one (pred, gt) pair on device.

    Slightly optimistic vs the one-to-one matcher (no uniqueness constraint);
    use for fast sweeps, report fboundary_np numbers.
    """
    r = int(math.ceil(tol))
    pred_b = boundaries_jax(pred_labels)
    gt_b = boundaries_jax(gt_labels)
    dt_gt = _truncated_sq_dt(gt_b, r)
    dt_pred = _truncated_sq_dt(pred_b, r)
    t2 = tol * tol
    matched_p = jnp.sum(jnp.where(pred_b, (dt_gt <= t2).astype(jnp.float32), 0.0))
    matched_g = jnp.sum(jnp.where(gt_b, (dt_pred <= t2).astype(jnp.float32), 0.0))
    np_ = jnp.maximum(jnp.sum(pred_b.astype(jnp.float32)), 1.0)
    ng = jnp.maximum(jnp.sum(gt_b.astype(jnp.float32)), 1.0)
    p = matched_p / np_
    rr = matched_g / ng
    f = 2 * p * rr / jnp.maximum(p + rr, 1e-12)
    return jnp.stack([p, rr, f])
