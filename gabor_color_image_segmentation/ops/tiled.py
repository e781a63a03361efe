"""Single-device spatial tiling of the feature stage (SURVEY.md §5.7, config 4).

The XLA feature forms materialize several full-size float32 planes per scale
group, so at 4K the stage's device memory grows with the image area. This
wrapper bounds it by running any energies impl on overlapping windows:

    slice windows of (tile + halo on every side that is NOT a true image
    border) -> run the impl per window -> keep the interior (halo = max
    conv radius + smoothing radius over scale groups).

Why windows clamp at true borders instead of pre-reflecting the image: the
border contract reflects the MAGNITUDE map, and for diagonal orientations
mag(conv(reflect(img))) != reflect(mag(conv(img))) — feeding an impl
reflected input rows at a true border changes its output (up to ~30% of
the energy scale). Clamped windows start exactly at the border, so the
impl's own reflect-magnitude machinery applies there, as in the untiled
run. At interior seams the halo rows are REAL neighbor pixels, and every
kept pixel's full dependency cone (conv + smoothing footprint) lies inside
the window. Ragged edges shift the last window inward.

Contract: tiled == untiled in exact arithmetic for every feature impl. In
floats they differ by rounding only, because what an impl computes from a
pixel's neighbourhood depends on the window origin: the modulation phases
of ops/modulated.py, and the tensor-core tile alignment of the Triton
kernel, which also centres and rounds each window's input on its own in
bfloat16 mode. The bounds, as max |tiled - untiled| / max |untiled|:
float32 (every dot at HIGHEST) 2e-5; bfloat16 5e-3, the size of bf16
rounding itself (tests/test_gabor_triton.py::test_tiled_matches_untiled;
tests/test_tiling.py bounds the labels).

This is the single-device analog of parallel/tiling.py's multi-device
shard_map + ppermute halo exchange: same halo algebra, slicing instead of
collectives.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax.numpy as jnp
from jax import lax

from gabor_color_image_segmentation.ops.bank import GaborBank


def gabor_energies_tiled(
    color: jnp.ndarray,
    bank: GaborBank,
    dtype,
    tile_hw: Tuple[int, int],
    energies_fn: Callable[[jnp.ndarray, GaborBank, object], jnp.ndarray],
    pool: int = 0,
) -> jnp.ndarray:
    """(B, H, W, C) -> (B, H>>pool, W>>pool, C*N) energies, tile-by-tile.

    energies_fn is any of gabor_energies / gabor_energies_mod /
    gabor_energies_triton (identical signatures and output layout).

    ``pool`` > 0 applies the pipeline's exact 2x2-block-mean pooling
    (models/pipeline.py::_pool2x2_nhwc, the golden-mirrored order) to each
    tile's INTERIOR before writing it out — bitwise equal to pooling the
    assembled full-res map (tile offsets/sizes are 2^pool-aligned, so
    every 2^pool block lies inside one tile), while the full-res NHWC
    energies never materialize."""
    b, h, w, c = color.shape
    th = min(tile_hw[0], h)
    tw = min(tile_hw[1], w)
    halo = bank.config.max_halo
    ys = sorted({min(i * th, h - th) for i in range(-(-h // th))})
    xs = sorted({min(j * tw, w - tw) for j in range(-(-w // tw))})
    if pool:
        from gabor_color_image_segmentation.models.pipeline import (
            _pool2x2_nhwc,
        )

        f = 1 << pool
        align = [th, tw, h, w] + list(ys) + list(xs)
        if any(v % f for v in align):
            raise ValueError(
                f"tiled pooling needs tile/image geometry divisible by "
                f"{f}, got tile {th}x{tw} over {h}x{w} at offsets "
                f"{ys}x{xs}"
            )
    out = None
    for y0 in ys:
        for x0 in xs:
            # halo only on sides that are not true image borders (see module
            # docstring); clamp keeps the impl's border handling authentic
            y_lo = max(0, y0 - halo)
            y_hi = min(h, y0 + th + halo)
            x_lo = max(0, x0 - halo)
            x_hi = min(w, x0 + tw + halo)
            win = lax.slice(color, (0, y_lo, x_lo, 0), (b, y_hi, x_hi, c))
            e = energies_fn(win, bank, dtype)[
                :, y0 - y_lo : y0 - y_lo + th, x0 - x_lo : x0 - x_lo + tw
            ]
            for _ in range(pool):
                e = _pool2x2_nhwc(e)
            p = pool and (1 << pool) or 1
            if out is None:
                out = jnp.zeros(
                    (b, h // p, w // p, e.shape[-1]), e.dtype
                )
            out = out.at[:, y0 // p : (y0 + th) // p,
                         x0 // p : (x0 + tw) // p].set(e)
    return out
