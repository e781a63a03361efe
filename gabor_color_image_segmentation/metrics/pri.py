"""Probabilistic Rand Index (SURVEY.md C15).

PRI(S, {G_t}) = mean_t RI(S, G_t), where RI is the Rand index computed from
the pair-confusion counts of the contingency table (the exact form sklearn's
rand_score uses — _supervised.py: pair_confusion_matrix / rand_score).

Host (numpy, arbitrary label counts) and device (jnp, static max label count,
contingency as a one-hot matmul) versions share the same math.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


def rand_index_np(pred: np.ndarray, gt: np.ndarray) -> float:
    """Rand index between two integer label maps (any shape, elementwise pairs)."""
    pred = pred.reshape(-1)
    gt = gt.reshape(-1)
    n = pred.size
    # contingency via flat bincount
    _, pi = np.unique(pred, return_inverse=True)
    _, gi = np.unique(gt, return_inverse=True)
    kp, kg = pi.max() + 1, gi.max() + 1
    cont = np.bincount(pi * kg + gi, minlength=kp * kg).reshape(kp, kg).astype(np.float64)
    sum_ij = (cont * (cont - 1)).sum() / 2.0
    a = cont.sum(axis=1)
    b = cont.sum(axis=0)
    sum_a = (a * (a - 1)).sum() / 2.0
    sum_b = (b * (b - 1)).sum() / 2.0
    total = n * (n - 1) / 2.0
    # agreements = pairs together in both + pairs apart in both
    return float((total + 2.0 * sum_ij - sum_a - sum_b) / total)


def pri_np(pred: np.ndarray, gts: Sequence[np.ndarray]) -> float:
    """Probabilistic Rand Index vs a set of ground-truth segmentations."""
    if len(gts) == 0:
        raise ValueError("need at least one ground truth")
    return float(np.mean([rand_index_np(pred, g) for g in gts]))


@partial(jax.jit, static_argnums=(2, 3))
def rand_index_jax(
    pred: jnp.ndarray, gt: jnp.ndarray, n_pred: int, n_gt: int
) -> jnp.ndarray:
    """Device Rand index; label values must lie in [0, n_pred) / [0, n_gt)."""
    p = pred.reshape(-1)
    g = gt.reshape(-1)
    n = p.shape[0]
    op = jax.nn.one_hot(p, n_pred, dtype=jnp.float32)
    og = jax.nn.one_hot(g, n_gt, dtype=jnp.float32)
    cont = jnp.dot(op.T, og, preferred_element_type=jnp.float32)
    sum_ij = jnp.sum(cont * (cont - 1.0)) / 2.0
    a = jnp.sum(cont, axis=1)
    b = jnp.sum(cont, axis=0)
    sum_a = jnp.sum(a * (a - 1.0)) / 2.0
    sum_b = jnp.sum(b * (b - 1.0)) / 2.0
    total = n * (n - 1) / 2.0
    return (total + 2.0 * sum_ij - sum_a - sum_b) / total


def pri_jax(pred: jnp.ndarray, gts: jnp.ndarray, n_pred: int, n_gt: int) -> jnp.ndarray:
    """pred: (H,W), gts: (T,H,W) -> scalar PRI (device)."""
    ri = jax.vmap(lambda g: rand_index_jax(pred, g, n_pred, n_gt))(gts)
    return jnp.mean(ri)
