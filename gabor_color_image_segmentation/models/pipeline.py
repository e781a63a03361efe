"""End-to-end pipeline composition (SURVEY.md §3.1/§3.5).

One pure function ``segment_batch``: (B, H, W, 3) sRGB -> (B, H, W) int32
label maps, fully jit-compiled — color transform, Gabor features, clustering
and (optionally) the superpixel/graph-cut stage stay on the device.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from gabor_color_image_segmentation.config import PipelineConfig
from gabor_color_image_segmentation.dispatch import energies_fn
from gabor_color_image_segmentation.ops.bank import GaborBank, make_bank
from gabor_color_image_segmentation.ops.color import rgb_to_lab
from gabor_color_image_segmentation.ops.features import assemble_features


def _color_transform(rgb: jnp.ndarray, color_space: str) -> jnp.ndarray:
    if rgb.dtype == jnp.uint8:
        rgb = rgb.astype(jnp.float32) / 255.0
    if color_space == "lab":
        return rgb_to_lab(rgb)
    return rgb.astype(jnp.float32)


def compute_energies(
    rgb: jnp.ndarray, cfg: PipelineConfig, bank: GaborBank,
    pool: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(B,H,W,3) sRGB -> ((B,H>>pool,W>>pool,E) energies, (B,H,W,3) color).

    ``pool`` > 0 returns 2^pool-block-mean-pooled energies (the graph
    branch's multirate grid). On the tiled path the pooling happens
    per-window inside gabor_energies_tiled — the same means, but the
    full-res NHWC energies never materialize; color is always returned
    full-res."""
    dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    color = _color_transform(rgb, cfg.color_space)
    fn = energies_fn(cfg)
    _, h, w, _ = color.shape
    if cfg.tile_hw is not None and (h > cfg.tile_hw[0] or w > cfg.tile_hw[1]):
        # large images: spatial tiling bounds the feature stage's device
        # memory (ops/tiled.py; config 4)
        from gabor_color_image_segmentation.ops.tiled import (
            gabor_energies_tiled,
        )

        energies = gabor_energies_tiled(
            color, bank, dtype, cfg.tile_hw, fn, pool
        )
    else:
        energies = fn(color, bank, dtype)
        for _ in range(pool):
            energies = _pool2x2_nhwc(energies)
    return energies, color


def compute_features(
    rgb: jnp.ndarray, cfg: PipelineConfig, bank: GaborBank
) -> jnp.ndarray:
    """(B,H,W,3) sRGB -> (B,H,W,D) standardized pixel features."""
    energies, color = compute_energies(rgb, cfg, bank)
    return assemble_features(energies, color, cfg.cluster)


def _pool2x2_nhwc(x: jnp.ndarray) -> jnp.ndarray:
    """(B,H,W,C) -> (B,H//2,W//2,C) exact 2x2 block means — the ordered f32
    sum of models/kmeans.py::pool2x2 (((x00+x01)+(x10+x11))*0.25, cast back),
    mirrored bit-for-bit by golden/graph pooling.

    The (W, C) -> (W/2, 2C) reshape keeps the linear order, so the column
    split is a contiguous slice. Casts stay per-operand so no full-res f32
    copy of the (large, at 4K) energies materializes."""
    h2, w2 = x.shape[1] // 2, x.shape[2] // 2
    c = x.shape[3]
    g = x[:, : 2 * h2, : 2 * w2]
    f32 = jnp.float32
    gp = g.reshape(g.shape[0], 2 * h2, w2, 2 * c)
    e, o = gp[:, 0::2], gp[:, 1::2]  # even / odd pixel rows
    s = (
        e[..., :c].astype(f32) + e[..., c:].astype(f32)
    ) + (o[..., :c].astype(f32) + o[..., c:].astype(f32))
    return (0.25 * s).astype(x.dtype)


@partial(jax.jit, static_argnums=(1, 2, 3))
def segment_batch(
    rgb: jnp.ndarray, cfg: PipelineConfig, bank: GaborBank,
    with_features: bool = True,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """(B,H,W,3) sRGB -> ((B,H,W) int32 labels, (B,H,W,D) features).

    Per-image clustering vmaps the solver over the batch. The graph stage
    (SLIC + n-cut), when enabled, refines the label maps (models/graph.py).

    with_features=False returns (labels, None); serving wants label maps,
    not per-pixel features, and XLA then drops the feature output.
    """
    b, h, w, _ = rgb.shape
    if cfg.graph.enabled:
        # the graph stage replaces the pixel-cluster labels wholesale, so
        # the cluster solver is not emitted at all
        from gabor_color_image_segmentation.models.graph import (
            graph_segment_batch,
        )

        p = cfg.graph.pool
        if p and (h % (1 << p) or w % (1 << p)):
            raise ValueError(
                f"graph.pool={p} needs H, W divisible by {1 << p}, got {h}x{w}"
            )
        with jax.named_scope("features"):
            # energies are computed at FULL resolution (filtering a pooled
            # image is not the same operator), then pooled by exact block
            # means BEFORE assembly so standardization moments are measured
            # on the grid the graph stage actually clusters. The pooling
            # rides inside compute_energies (per-window on the tiled path).
            energies, color = compute_energies(rgb, cfg, bank, pool=p)
            same = cfg.color_space == "lab"
            lab = color if same else _color_transform(rgb, "lab")
            for _ in range(p):
                color = _pool2x2_nhwc(color)
                lab = color if same else _pool2x2_nhwc(lab)
            feats = assemble_features(energies, color, cfg.cluster)
        with jax.named_scope("graph_cut"):
            labels = graph_segment_batch(feats, lab, cfg)
        if p:
            f = 1 << p
            labels = jnp.repeat(jnp.repeat(labels, f, axis=1), f, axis=2)
        # with pool > 0 the returned features are the POOLED grid's —
        # the tensor the graph stage actually consumed
        return labels, (feats if with_features else None)

    with jax.named_scope("features"):
        feats = compute_features(rgb, cfg, bank)
    d = feats.shape[-1]
    flat = feats.reshape(b, h * w, d)

    kmeans_dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    if cfg.cluster.method == "kmeans":
        from gabor_color_image_segmentation.models.kmeans import kmeans_batch

        with jax.named_scope("cluster"):
            labels = kmeans_batch(
                flat,
                cfg.cluster.k,
                cfg.cluster.n_iter,
                kmeans_dtype,
                cfg.cluster.subsample,
                cfg.cluster.init_stride,
                (h, w),
                cfg.cluster.coarse_iters,
                cfg.cluster.refine_iters,
                cfg.cluster.coarse_levels,
                cfg.cluster.mid_iters,
            )[0].reshape(b, h, w).astype(jnp.int32)
    elif cfg.cluster.method == "gmm":
        from gabor_color_image_segmentation.models.gmm import gmm_predict

        cluster = lambda f: gmm_predict(
            f,
            cfg.cluster.k,
            cfg.cluster.n_iter,
            cfg.cluster.gmm_reg_covar,
            cfg.cluster.subsample,
            cfg.cluster.gmm_tol,
            (h, w),
            cfg.cluster.gmm_fit_pool,
            cfg.cluster.gmm_refine_iters,
        )
        with jax.named_scope("cluster"):
            labels = jax.vmap(cluster)(flat).reshape(b, h, w).astype(jnp.int32)
    else:
        raise ValueError(cfg.cluster.method)

    return labels, (feats if with_features else None)


def segment_image(rgb: jnp.ndarray, cfg: PipelineConfig, bank: GaborBank = None):
    """Single-image convenience wrapper -> ((H,W) labels, (H,W,D) features)."""
    if bank is None:
        bank = make_bank(cfg.bank)
    labels, feats = segment_batch(rgb[None], cfg, bank)
    return labels[0], feats[0]


def segment_images(rgb: jnp.ndarray, cfg: PipelineConfig, bank: GaborBank = None):
    """Host-orchestrated batch entry point: (B,H,W,3) -> (B,H,W) int32.

    Identical to ``segment_batch`` for device-only configs; additionally
    handles the host-side stages: the min-cut graph variant (sequential
    union-find, SURVEY.md §7.4) and SLIC connectivity enforcement.
    """
    import numpy as np

    if bank is None:
        bank = make_bank(cfg.bank)
    g = cfg.graph
    if not (g.enabled and g.cut == "mincut"):
        # labels-only: the eval/serving entry point never consumes the
        # feature tensor
        labels, _ = segment_batch(rgb, cfg, bank, False)
        return labels

    from gabor_color_image_segmentation.models.graph import mincut_segment
    from gabor_color_image_segmentation.models.slic import (
        enforce_connectivity_device,
        grid_shape,
        slic_batch,
    )

    p = g.pool

    def prep(b):
        # same pooled-graph input rule as the jitted ncut branch above
        energies, color = compute_energies(b, cfg, bank)
        same = cfg.color_space == "lab"
        lab = color if same else _color_transform(b, "lab")
        for _ in range(p):
            energies = _pool2x2_nhwc(energies)
            color = _pool2x2_nhwc(color)
            lab = color if same else _pool2x2_nhwc(lab)
        return assemble_features(energies, color, cfg.cluster), lab

    feats, lab = jax.jit(prep)(jnp.asarray(rgb))
    hp, wp = rgb.shape[1] >> p, rgb.shape[2] >> p
    gh, gw, _ = grid_shape(hp, wp, g.n_superpixels)
    sp = jax.jit(
        lambda l: enforce_connectivity_device(
            slic_batch(l, g.n_superpixels, g.slic_compactness, g.slic_iters),
            gh * gw,
        )
    )(lab)
    feats_np = np.asarray(feats)
    sp_np = np.asarray(sp)
    out = np.stack(
        [
            mincut_segment(feats_np[i], sp_np[i], g.mincut_k, g.mincut_min_size)
            for i in range(rgb.shape[0])
        ]
    )
    if p:
        out = out.repeat(1 << p, axis=1).repeat(1 << p, axis=2)
    return jnp.asarray(out)
