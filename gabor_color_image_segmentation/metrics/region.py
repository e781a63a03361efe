"""Region-based segmentation metrics: Variation of Information and
Segmentation Covering (SURVEY.md L6 — the BSDS500 region-metric family
alongside PRI, per the benchmark of Arbelaez et al., TPAMI 2011).

Both are functions of the label contingency table only, so the host and
device versions share the exact math with metrics/pri.py:

  VoI(S, G)      = H(S) + H(G) - 2 I(S, G)          (natural log, nats;
                   0 = identical partitions, lower is better)
  Covering(S->G) = (1/N) sum_{R in G} |R| max_{R' in S} |R ∩ R'| / |R ∪ R'|
                   (the benchmark's reported direction: how well the
                   machine segmentation S covers the ground-truth regions;
                   1 = perfect, higher is better)

Multi-ground-truth aggregation mirrors pri_np: the mean over the GT set.

Device versions build the contingency as a one-hot matmul with static
label-count bounds, like metrics/pri.rand_index_jax.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


def _contingency_np(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(kp, kg) float64 contingency table of two integer label maps."""
    p = pred.reshape(-1)
    g = gt.reshape(-1)
    _, pi = np.unique(p, return_inverse=True)
    _, gi = np.unique(g, return_inverse=True)
    kp, kg = pi.max() + 1, gi.max() + 1
    return (
        np.bincount(pi * kg + gi, minlength=kp * kg)
        .reshape(kp, kg)
        .astype(np.float64)
    )


def voi_np(pred: np.ndarray, gt: np.ndarray) -> float:
    """Variation of Information (nats) between two label maps."""
    cont = _contingency_np(pred, gt)
    n = cont.sum()
    pij = cont / n
    pi = pij.sum(axis=1)
    pj = pij.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        h_p = -np.sum(pi * np.log(np.where(pi > 0, pi, 1.0)))
        h_g = -np.sum(pj * np.log(np.where(pj > 0, pj, 1.0)))
        mi = np.sum(
            np.where(
                pij > 0,
                pij * (np.log(np.where(pij > 0, pij, 1.0))
                       - np.log(np.outer(np.where(pi > 0, pi, 1.0),
                                         np.where(pj > 0, pj, 1.0)))),
                0.0,
            )
        )
    return float(h_p + h_g - 2.0 * mi)


def mean_voi_np(pred: np.ndarray, gts: Sequence[np.ndarray]) -> float:
    """Mean VoI vs a set of ground truths (lower is better)."""
    if len(gts) == 0:
        raise ValueError("need at least one ground truth")
    return float(np.mean([voi_np(pred, g) for g in gts]))


def covering_np(pred: np.ndarray, gt: np.ndarray) -> float:
    """Covering of the ground-truth regions by the predicted segments."""
    cont = _contingency_np(pred, gt)  # (kp, kg); rows = pred segments
    n = cont.sum()
    a = cont.sum(axis=0)  # |R| per GT region
    b = cont.sum(axis=1)  # |R'| per pred segment
    union = b[:, None] + a[None, :] - cont
    overlap = np.where(union > 0, cont / union, 0.0)
    best = overlap.max(axis=0)  # per GT region: best-matching pred segment
    return float(np.sum(a * best) / n)


def mean_covering_np(pred: np.ndarray, gts: Sequence[np.ndarray]) -> float:
    """Mean covering vs a set of ground truths (higher is better)."""
    if len(gts) == 0:
        raise ValueError("need at least one ground truth")
    return float(np.mean([covering_np(pred, g) for g in gts]))


def _contingency_jax(
    pred: jnp.ndarray, gt: jnp.ndarray, n_pred: int, n_gt: int
) -> jnp.ndarray:
    op = jax.nn.one_hot(pred.reshape(-1), n_pred, dtype=jnp.float32)
    og = jax.nn.one_hot(gt.reshape(-1), n_gt, dtype=jnp.float32)
    return jnp.dot(op.T, og, preferred_element_type=jnp.float32)


@partial(jax.jit, static_argnums=(2, 3))
def voi_jax(
    pred: jnp.ndarray, gt: jnp.ndarray, n_pred: int, n_gt: int
) -> jnp.ndarray:
    """Device VoI; label values must lie in [0, n_pred) / [0, n_gt)."""
    cont = _contingency_jax(pred, gt, n_pred, n_gt)
    n = jnp.sum(cont)
    pij = cont / n
    pi = jnp.sum(pij, axis=1)
    pj = jnp.sum(pij, axis=0)
    safe = lambda x: jnp.where(x > 0, x, 1.0)
    h_p = -jnp.sum(pi * jnp.log(safe(pi)))
    h_g = -jnp.sum(pj * jnp.log(safe(pj)))
    mi = jnp.sum(
        jnp.where(
            pij > 0,
            pij * (jnp.log(safe(pij)) - jnp.log(safe(pi)[:, None])
                   - jnp.log(safe(pj)[None, :])),
            0.0,
        )
    )
    return h_p + h_g - 2.0 * mi


@partial(jax.jit, static_argnums=(2, 3))
def covering_jax(
    pred: jnp.ndarray, gt: jnp.ndarray, n_pred: int, n_gt: int
) -> jnp.ndarray:
    """Device covering of GT regions by pred segments (same bounds rule)."""
    cont = _contingency_jax(pred, gt, n_pred, n_gt)
    n = jnp.sum(cont)
    a = jnp.sum(cont, axis=0)
    b = jnp.sum(cont, axis=1)
    union = b[:, None] + a[None, :] - cont
    overlap = jnp.where(union > 0, cont / union, 0.0)
    return jnp.sum(a * jnp.max(overlap, axis=0)) / n
