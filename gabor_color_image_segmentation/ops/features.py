"""Gabor feature extraction — plain-XLA path (SURVEY.md C4-C7).

Pipeline per scale-group (all inside one jit; XLA fuses the elementwise
stages into the convs):

    pad(reflect101) -> depthwise complex conv -> |.| magnitude
    -> separable Gaussian energy smoothing -> per-pixel energy vector

Convolution convention is CORRELATION with REFLECT_101 borders, matching
``cv2.filter2D`` defaults (imgproc.hpp:1619-1649 — filter2D computes
correlation; BORDER_REFLECT_101 is the default border), which the golden CPU
path uses verbatim. ``lax.conv_general_dilated`` computes correlation
natively, so filters are used unflipped.

Feature layout contract (shared with golden/ and all three implementations):

    energies = concat over scale groups of per-group blocks; within a group
    the block is KERNEL-major, channel-minor:

        energies[..., group_offset(g) + j_within_group * C + ch]

    (feature order is irrelevant to the clustering stages — distances are
    permutation-invariant across dims; golden/ and every implementation
    emit the identical order.)

    features = concat([energies, color]) -> (..., 3N + 3)
    optional per-image standardization; color dims scaled by color_weight.

ops/modulated.py and the Triton kernel (ops/gabor_triton.py) compute the
same map faster for isotropic banks; this module is the reference-shaped
form and the path for anisotropic banks.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from gabor_color_image_segmentation.config import ClusterConfig
from gabor_color_image_segmentation.ops.bank import GaborBank, ScaleGroup
from gabor_color_image_segmentation.ops.precision import precision_for

_DN = lax.conv_dimension_numbers((1, 1, 1, 1), (1, 1, 1, 1), ("NHWC", "HWIO", "NHWC"))


def _reflect_pad(x: jnp.ndarray, rh: int, rw: int) -> jnp.ndarray:
    """REFLECT_101 pad of NHWC along H, W."""
    return jnp.pad(x, ((0, 0), (rh, rh), (rw, rw), (0, 0)), mode="reflect")


def _conv_precision(dtype):
    """ops/precision.py's rule for convolutions."""
    return precision_for(jnp.dtype(dtype))


def _depthwise_conv(x: jnp.ndarray, filt: jnp.ndarray, dtype) -> jnp.ndarray:
    """VALID depthwise-grouped correlation. x: (B,H,W,C), filt: (k,k,1,F) per
    channel; the filter block is tiled across C groups -> (B,H',W',C*F)."""
    c = x.shape[-1]
    f = jnp.tile(filt, (1, 1, 1, c))  # (k,k,1,C*F): group order = channel-major
    out = lax.conv_general_dilated(
        x.astype(dtype),
        f.astype(dtype),
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=_DN,
        feature_group_count=c,
        preferred_element_type=jnp.float32,
        precision=_conv_precision(dtype),
    )
    return out


def _separable_smooth(x: jnp.ndarray, taps: jnp.ndarray, dtype) -> jnp.ndarray:
    """Depthwise separable Gaussian with REFLECT_101 borders. x: (B,H,W,C)."""
    c = x.shape[-1]
    r = taps.shape[0] // 2
    tv = jnp.tile(taps.reshape(-1, 1, 1, 1), (1, 1, 1, c))  # (k,1,1,C)
    th = jnp.tile(taps.reshape(1, -1, 1, 1), (1, 1, 1, c))  # (1,k,1,C)
    x = _reflect_pad(x, r, 0)
    x = lax.conv_general_dilated(
        x.astype(dtype), tv.astype(dtype), (1, 1), "VALID",
        dimension_numbers=_DN, feature_group_count=c,
        preferred_element_type=jnp.float32,
        precision=_conv_precision(dtype),
    )
    x = _reflect_pad(x, 0, r)
    x = lax.conv_general_dilated(
        x.astype(dtype), th.astype(dtype), (1, 1), "VALID",
        dimension_numbers=_DN, feature_group_count=c,
        preferred_element_type=jnp.float32,
        precision=_conv_precision(dtype),
    )
    return x


def _group_energies(img: jnp.ndarray, group: ScaleGroup, dtype) -> jnp.ndarray:
    """Energies for one scale group. img: (B,H,W,C) -> (B,H,W,n_g*C) in
    contract order (kernel-major, channel-minor)."""
    b, h, w, c = img.shape
    n = len(group.kernel_indices)
    r = group.ksize // 2
    filt = jnp.asarray(group.filters_hwio)  # (k,k,1,2n)
    x = _reflect_pad(img, r, r)
    resp = _depthwise_conv(x, filt, dtype)  # (B,H,W,C*2n) [ch-major groups]
    re = resp[..., 0::2]
    im = resp[..., 1::2]
    mag = jnp.sqrt(re * re + im * im)  # (B,H,W,C*n) channel-major
    taps = jnp.asarray(group.smooth_taps)
    sm = _separable_smooth(mag, taps, dtype)
    # channel-major -> kernel-major (contract order; cheap last-dim shuffle)
    return jnp.transpose(sm.reshape(b, h, w, c, n), (0, 1, 2, 4, 3)).reshape(
        b, h, w, n * c
    )


def energy_index(bank: GaborBank, n_channels: int, kernel_idx: int, ch: int) -> int:
    """Contract-order position of (global kernel index, channel) in the
    energy axis: group blocks in bank.groups order, kernel-major within."""
    offset = 0
    for g in bank.groups:
        if kernel_idx in g.kernel_indices:
            j = g.kernel_indices.index(kernel_idx)
            return offset + j * n_channels + ch
        offset += len(g.kernel_indices) * n_channels
    raise IndexError(kernel_idx)


def gabor_energies(
    img: jnp.ndarray, bank: GaborBank, dtype=jnp.float32
) -> jnp.ndarray:
    """(B,H,W,C) image (Lab or RGB channels) -> (B,H,W,N*C) smoothed energies
    in contract order (group blocks; kernel-major, channel-minor within)."""
    parts = [_group_energies(img, g, dtype) for g in bank.groups]
    return jnp.concatenate(parts, axis=-1)


def assemble_features(
    energies: jnp.ndarray,
    color: jnp.ndarray,
    cluster_cfg: ClusterConfig,
    eps: float = 1e-6,
) -> jnp.ndarray:
    """Pixel feature vectors: energies ++ color, optionally standardized
    per-image (mean/std over pixels).

    After per-dim standardization the E energy dims would out-vote the 3
    color dims E/3-fold, so the color block is rescaled by sqrt(E/3) to give
    the texture and color cues equal total variance; ``color_weight`` is a
    user multiplier on top of that balance (same rule in golden/features.py).

    energies: (B,H,W,E), color: (B,H,W,3) -> (B,H,W,E+3) float32.

    ``cluster_cfg.feature_set`` ablates one cue: "color" drops the energy
    block entirely (color-only clustering, unit scale), "texture" drops the
    color block. "full" is bit-identical to the pre-knob behavior.
    """
    fs = getattr(cluster_cfg, "feature_set", "full")
    if fs == "color":
        energies = energies[..., :0]
    elif fs == "texture":
        color = color[..., :0]
    elif fs != "full":
        raise ValueError(f"unknown feature_set {fs!r}")
    out_dtype = energies.dtype if energies.dtype == jnp.bfloat16 else jnp.float32
    feats = jnp.concatenate(
        [energies.astype(out_dtype), color.astype(out_dtype)], axis=-1
    )
    e = energies.shape[-1]
    nc = color.shape[-1]
    cw = cluster_cfg.color_weight * float(np.sqrt(e / 3.0)) if e else 1.0
    scale = jnp.concatenate(
        [jnp.ones((e,), jnp.float32), jnp.full((nc,), cw, jnp.float32)]
    )
    if cluster_cfg.normalize:
        # moments accumulate in f32 regardless of the storage dtype. One-pass
        # variance (E[x^2] - mu^2, golden mirrors the identical formula): a
        # named f32 copy of the feature tensor would MATERIALIZE (10.4 GB for
        # a 4K batch-8 — measured HBM OOM); with the casts appearing once per
        # consumer XLA fuses them into the reductions and the normalize.
        mean = jnp.mean(feats, axis=(1, 2), keepdims=True, dtype=jnp.float32)
        sq = jnp.mean(
            jnp.square(feats.astype(jnp.float32)), axis=(1, 2), keepdims=True
        )
        var = jnp.maximum(sq - jnp.square(mean), 0.0)
        std = jnp.sqrt(var)
        out = (feats.astype(jnp.float32) - mean) / (std + eps) * scale
    else:
        out = feats.astype(jnp.float32) * scale
    if getattr(cluster_cfg, "cue_weight", "static") == "coherence":
        cw_ = coherence_weights(out, eps)
        p = float(getattr(cluster_cfg, "coherence_pow", 1.0))
        out = out * (cw_ if p == 1.0 else cw_ ** p)
    return out.astype(out_dtype)


_COH_BLOCK = 8  # coherence pooling window (pixels per side)


def coherence_weights(feats: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """(B, H, W, D) -> (B, 1, 1, D) per-image region-scale coherence weights:
    std of 8x8 block means over std (ClusterConfig.cue_weight docstring;
    golden mirror: golden/features.py::coherence_weights_np). Identity when
    the image is too small to pool (< 2 blocks per side)."""
    b, h, w, d = feats.shape
    n = _COH_BLOCK
    hb, wb = h // n, w // n
    if hb < 2 or wb < 2:
        return jnp.ones((b, 1, 1, d), jnp.float32)
    f = feats[:, : hb * n, : wb * n].astype(jnp.float32)
    p = jnp.mean(f.reshape(b, hb, n, wb, n, d), axis=(2, 4))
    pm = jnp.mean(p, axis=(1, 2), keepdims=True)
    pv = jnp.maximum(
        jnp.mean(jnp.square(p), axis=(1, 2), keepdims=True) - jnp.square(pm),
        0.0,
    )
    fm = jnp.mean(f, axis=(1, 2), keepdims=True)
    fv = jnp.maximum(
        jnp.mean(jnp.square(f), axis=(1, 2), keepdims=True) - jnp.square(fm),
        0.0,
    )
    return jnp.sqrt(pv) / (jnp.sqrt(fv) + eps)


@partial(jax.jit, static_argnums=(1, 2, 3))
def _features_jit(lab, bank, cluster_cfg, dtype):
    energies = gabor_energies(lab, bank, dtype)
    return assemble_features(energies, lab, cluster_cfg)


def gabor_features(
    lab: jnp.ndarray,
    bank: GaborBank,
    cluster_cfg: Optional[ClusterConfig] = None,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Convenience: (B,H,W,3) color-space image -> (B,H,W,3N+3) features."""
    if cluster_cfg is None:
        cluster_cfg = ClusterConfig()
    return _features_jit(lab, bank, cluster_cfg, dtype)
