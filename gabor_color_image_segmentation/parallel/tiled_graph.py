"""Distributed graph-cut stage over the ``space`` mesh axis (SURVEY.md §5.7;
BASELINE config 4: "fused filter→cluster→cut chain").

Closes the round-2 acceptance-spec gap: the tiled/sharded machinery ended at
globally-consistent k-means. This module runs the FULL graph stage — SLIC
superpixels, cv2-semantics connectivity enforcement, superpixel feature
moments, affinity + spectral n-cut — on a row-sharded image, with exactly
the communication structure SURVEY §5.7 prescribes:

* **SLIC** (mirrors ``models/slic.py::slic``): every device assigns its own
  pixels against the replicated (S, 5) centroid table (global y
  coordinates), and the per-cluster (sum, count) moments are ``psum``'d so
  every device steps IDENTICAL centroids — the same distributed-Lloyd shape
  as ``kmeans_sharded``. Communication: one (S, 6)-sized psum per iteration.
* **Connectivity enforcement** (mirrors
  ``models/slic.py::enforce_connectivity_device`` rule-for-rule): connected
  components by run-min fixpoint sweeps, made global by exchanging ONE
  boundary row per neighbor per iteration (``lax.ppermute``) and merging
  component ids across equal-label strip seams; component sizes and the
  surviving-root bitmap live in (H*W,)-sized tables psum'd to every device
  (integer adds — order-free, so the result is BIT-EQUAL to the single-chip
  pass); small-fragment adoption iterates the identical Jacobi update with
  single-row halos. All fixpoint loops carry a psum'd global convergence
  flag.
* **Moments → cut**: per-shard superpixel feature sums/counts are psum'd
  (the "tiny per-tile superpixel stats" gather — (S, D+1) per image);
  affinity + spectral n-cut then run REPLICATED on every device (S is a few
  hundred; identical inputs give identical outputs on every shard), and the
  (S,)-sized region table broadcasts back to pixels locally.

The multirate knob (``GraphConfig.pool``) is honored exactly like the
single-chip path: strips pool their energies/Lab by local 2x2 block means
(strip heights divisible by 2^pool keep blocks strip-local, so pooling is
bitwise the untiled pooling), the graph runs on the pooled strip, and the
final labels upsample locally.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from gabor_color_image_segmentation.config import PipelineConfig
from gabor_color_image_segmentation.models.slic import (
    _pass_extreme,
    _shift2d,
    grid_shape,
    slic_assign,
    slic_geometry,
    slic_moments,
    slic_pixel_arrays,
    slic_seed_coords,
    slic_update,
)


def _psum_any(flag: jnp.ndarray, sync_axes) -> jnp.ndarray:
    """Global OR of per-device booleans. ``sync_axes`` must name EVERY mesh
    axis of the enclosing shard_map, not just the space axis the data rides
    on: data-dependent while_loops whose bodies contain collectives must run
    the SAME trip count on every device — otherwise the space groups of a
    2-D batch x space mesh diverge and the ppermutes deadlock (measured: XLA
    CPU AwaitAndLogIfStuck abort). Reducing the convergence flag over all
    axes makes every group run to the slowest group's count; the extra
    iterations are idempotent no-ops (run-min/adoption fixpoints)."""
    return lax.psum(flag.astype(jnp.int32), sync_axes) > 0


def _neighbor_rows(
    x: jnp.ndarray, axis_name: str, fill
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(rows, W[, C]) strip -> (top halo, bottom halo), each (1, W[, C]).

    top halo = previous device's LAST row (``fill`` on device 0); bottom
    halo = next device's FIRST row (``fill`` on the last device)."""
    idx = lax.axis_index(axis_name)
    n = lax.axis_size(axis_name)
    from_prev = lax.ppermute(
        x[-1:], axis_name, [(i, (i + 1) % n) for i in range(n)]
    )
    from_next = lax.ppermute(
        x[:1], axis_name, [(i, (i - 1) % n) for i in range(n)]
    )
    top = jnp.where(idx == 0, jnp.full_like(from_prev, fill), from_prev)
    bot = jnp.where(idx == n - 1, jnp.full_like(from_next, fill), from_next)
    return top, bot


# ---------------------------------------------------------------------------
# Distributed SLIC (local assignment, psum'd centroid moments)
# ---------------------------------------------------------------------------


def slic_sharded(
    lab: jnp.ndarray,
    h: int,
    w: int,
    n_superpixels: int,
    ruler: float,
    n_iter: int,
    axis_name: str,
) -> jnp.ndarray:
    """(rows, W, 3) Lab strip of an (h, w) image -> (rows, W) int32
    superpixel labels in [0, gh*gw), globally consistent.

    ONE semantic source with ``models/slic.py::slic`` (VERDICT r3 weak #4):
    the distance/candidate/tie-break/update math is the shared ``slic_assign`` /
    ``slic_moments`` / ``slic_update`` helpers — this wrapper only supplies
    the global row offset, psums the moments, and reconstructs the seed
    colors (each (iy, ix) sample lives on exactly one device — mask + psum
    rebuilds the replicated (S, 3) table exactly, one non-zero addend per
    entry). Identical candidate sets and tie-breaks; only the f32 psum
    reduction order differs from the single-chip run."""
    rows = lab.shape[0]
    gh, gw, spatial_w = slic_geometry(h, w, n_superpixels, ruler)
    n_sp = gh * gw
    row0 = lax.axis_index(axis_name) * rows
    flat, cand = slic_pixel_arrays(lab, h, w, gh, gw, row0=row0)

    cyg, cxg, iy, ix = slic_seed_coords(h, w, gh, gw)
    iy, ix = iy.reshape(-1), ix.reshape(-1)
    own = (iy >= row0) & (iy < row0 + rows)
    iy_loc = jnp.clip(iy - row0, 0, rows - 1)
    init_color = lax.psum(
        jnp.where(own[:, None], lab[iy_loc, ix].astype(jnp.float32), 0.0),
        axis_name,
    )  # (S, 3)
    centroids = jnp.concatenate(
        [init_color, cyg.reshape(-1, 1), cxg.reshape(-1, 1)], axis=-1
    )

    def body(_, centroids):
        labels = slic_assign(flat, centroids, cand, spatial_w)
        sums, cnts = slic_moments(labels, flat, n_sp)
        return slic_update(
            centroids, lax.psum(sums, axis_name), lax.psum(cnts, axis_name)
        )

    centroids = lax.fori_loop(0, n_iter, body, centroids)
    return slic_assign(flat, centroids, cand, spatial_w).reshape(rows, w).astype(
        jnp.int32
    )


# ---------------------------------------------------------------------------
# Distributed connectivity enforcement (bit-equal to the single-chip pass)
# ---------------------------------------------------------------------------


def _cc_sharded(
    labels: jnp.ndarray, axis_name: str, w: int, sync_axes=None
) -> jnp.ndarray:
    """(rows, W) strip labels -> (rows, W) component ids (= min GLOBAL flat
    pixel index of each 4-connected equal-label component).

    Local run-min prefix-doubling sweeps (the single-chip algorithm on the
    strip) alternate with a one-row boundary merge: each device takes the
    min of its seam rows' component ids against the neighbor's seam row
    wherever the SLIC labels match across the seam. Integer min is
    order-free, so the fixed point equals the single-chip result exactly."""
    rows = labels.shape[0]
    if sync_axes is None:
        sync_axes = axis_name
    row0 = lax.axis_index(axis_name) * rows
    comp0 = (
        row0 * w
        + jnp.arange(rows * w, dtype=jnp.int32).reshape(rows, w)
    )
    lab3 = labels[None]

    def seam_merge(comp):
        top_lab, bot_lab = _neighbor_rows(labels, axis_name, -1)
        top_cmp, bot_cmp = _neighbor_rows(comp, axis_name, jnp.int32(2**30))
        first = jnp.where(
            labels[:1] == top_lab, jnp.minimum(comp[:1], top_cmp), comp[:1]
        )
        last = jnp.where(
            labels[-1:] == bot_lab, jnp.minimum(comp[-1:], bot_cmp), comp[-1:]
        )
        if rows == 1:
            return jnp.minimum(first, last)
        return jnp.concatenate([first, comp[1:-1], last], axis=0)

    def body(state):
        comp, _ = state
        new = _pass_extreme(seam_merge(comp)[None], lab3, "min")[0]
        return new, _psum_any(jnp.any(new != comp), sync_axes)

    comp = _pass_extreme(comp0[None], lab3, "min")[0]
    # the init flag must be data-derived (not a constant True): on a 2-D
    # batch x space mesh the body's psum over ``space`` leaves the flag
    # VARYING over the batch axis, and while_loop requires carry vma types
    # to match the init
    flag0 = _psum_any(jnp.any(labels >= jnp.min(labels)), sync_axes)
    comp, _ = lax.while_loop(lambda s: s[1], body, (comp, flag0))
    return comp


def enforce_connectivity_sharded(
    labels: jnp.ndarray,
    n_sp: int,
    h: int,
    axis_name: str,
    min_size: int | None = None,
    s_max: int | None = None,
    sync_axes=None,
) -> jnp.ndarray:
    """(rows, W) int32 SLIC labels, row-sharded over ``axis_name`` ->
    (rows, W) 4-connected superpixels in [0, s_max) — the cv2
    ``enforceLabelConnectivity`` semantics of
    ``models/slic.py::enforce_connectivity_device``, BIT-EQUAL to running
    that pass on the gathered image (every step is integer arithmetic with
    order-free reductions; pinned by tests/test_tiling.py).

    Global tables are (H*W,)-sized int32 (component sizes, survivor bitmap)
    psum'd across shards — 2 MB at config4's pooled 4K grid.
    """
    rows, w = labels.shape
    n = h * w
    if sync_axes is None:
        sync_axes = axis_name
    if min_size is None:
        min_size = max(1, n // n_sp // 4)
    if s_max is None:
        s_max = n_sp
    row0 = lax.axis_index(axis_name) * rows

    comp = _cc_sharded(labels, axis_name, w, sync_axes)
    comp_flat = comp.reshape(-1)
    gidx = row0 * w + jnp.arange(rows * w, dtype=jnp.int32)
    is_root = comp_flat == gidx

    # component sizes at root indices: integer scatter-add + psum (exact)
    counts = lax.psum(
        jnp.zeros((n,), jnp.int32).at[comp_flat].add(1), axis_name
    )
    # survivor bitmap, replicated: each root contributes from its owner
    survives_loc = is_root & (counts[comp_flat] >= min_size)
    bitmap = lax.psum(
        jnp.zeros((n,), jnp.int32).at[gidx].add(survives_loc.astype(jnp.int32)),
        axis_name,
    )
    newid = jnp.cumsum(bitmap) - 1  # raster order of root pixels
    table = jnp.where((bitmap > 0) & (newid < s_max), newid, -1)  # (n,)
    lab = table[comp_flat].reshape(rows, w).astype(jnp.int32)

    kept = lab >= 0

    def adopt_body(state):
        lab, kept, _, t = state
        top_lab, bot_lab = _neighbor_rows(lab, axis_name, 0)
        top_kept, bot_kept = _neighbor_rows(
            kept.astype(jnp.int32), axis_name, 0
        )
        labp = jnp.concatenate([top_lab, lab, bot_lab], axis=0)
        keptp = jnp.concatenate(
            [top_kept, kept.astype(jnp.int32), bot_kept], axis=0
        )
        cand = lab
        have = jnp.zeros_like(kept)
        # reverse priority order so the first-listed neighbor wins the where
        for dy, dx in ((1, 0), (0, 1), (0, -1), (-1, 0)):  # d,r,l,up
            if dx:
                nl = _shift2d(lab, 0, dx, 0)
                nk = _shift2d(kept, 0, dx, False)
            else:
                nl = lax.dynamic_slice(labp, (1 + dy, 0), (rows, w))
                nk = lax.dynamic_slice(keptp, (1 + dy, 0), (rows, w)) > 0
            cand = jnp.where(nk, nl, cand)
            have = have | nk
        adopt = (~kept) & have
        lab = jnp.where(adopt, cand, lab)
        kept = kept | adopt
        more = _psum_any(~jnp.all(kept), sync_axes)
        return lab, kept, more, t + 1

    # safety cap at h + w steps (models/slic.py's guard): any
    # absorbed pixel is within that L1 distance of a kept one when any
    # survivor exists; leftovers clamp to id 0
    def adopt_cond(state):
        _, _, more, t = state
        return jnp.logical_and(more, t < h + w)

    lab, _, _, _ = lax.while_loop(
        adopt_cond,
        adopt_body,
        (lab, kept, _psum_any(~jnp.all(kept), sync_axes), jnp.int32(0)),
    )
    return jnp.maximum(lab, 0)


# ---------------------------------------------------------------------------
# Moments gather + replicated cut
# ---------------------------------------------------------------------------


def superpixel_means_sharded(
    feats: jnp.ndarray, sp: jnp.ndarray, n_sp: int, axis_name: str
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(N_local, D) features + (N_local,) superpixel ids -> replicated
    ((S, D) means, (S,) counts) via psum'd one-hot moments — the SURVEY
    §5.7 "gather per-tile superpixel stats (small) to all cores" step."""
    hi = jax.lax.Precision.HIGHEST
    onehot = jax.nn.one_hot(sp, n_sp, dtype=jnp.float32)  # (N_loc, S)
    sums = lax.psum(
        jnp.dot(
            onehot.T, feats.astype(jnp.float32),
            preferred_element_type=jnp.float32, precision=hi,
        ),
        axis_name,
    )
    cnts = lax.psum(jnp.sum(onehot, axis=0), axis_name)
    return sums / jnp.maximum(cnts, 1.0)[:, None], cnts


def graph_cut_strip(
    feats: jnp.ndarray,
    lab: jnp.ndarray,
    cfg: PipelineConfig,
    h: int,
    axis_name: str,
    sync_axes=None,
) -> jnp.ndarray:
    """Distributed SURVEY-C10..C12 chain on a row-sharded (pooled) image.

    feats: (rows, W, D) standardized strip features; lab: (rows, W, 3) Lab
    strip; ``h`` = GLOBAL (pooled) image height. Returns (rows, W) int32
    region labels (strip of the global label map). The affinity + n-cut
    stage runs replicated per device on the psum'd S-node stats.
    """
    from gabor_color_image_segmentation.models.graph import (
        affinity_matrix,
        spectral_labels,
    )

    g = cfg.graph
    rows, w, d = feats.shape
    sp = slic_sharded(
        lab, h, w, g.n_superpixels, g.slic_compactness, g.slic_iters,
        axis_name,
    )
    gh, gw, _ = grid_shape(h, w, g.n_superpixels)
    sp = enforce_connectivity_sharded(
        sp, gh * gw, h, axis_name, sync_axes=sync_axes
    )
    means, cnts = superpixel_means_sharded(
        feats.reshape(rows * w, d), sp.reshape(-1), gh * gw, axis_name
    )
    aff = affinity_matrix(means, g.affinity_sigma, cnts,
                          g.affinity_sigma_scale)
    regions = spectral_labels(aff, g.n_regions, eig_method=g.eig_method)
    return regions[sp.reshape(-1)].reshape(rows, w).astype(jnp.int32)
