"""RGB -> CIELab color transform (SURVEY.md C2).

Semantics: sRGB (D65) -> linear RGB -> XYZ -> CIELab, matching
``cv2.cvtColor(img, COLOR_RGB2LAB)`` on float32 input (L in [0, 100],
a/b roughly [-128, 127]). Implemented in jnp so it fuses into the feature
front-end under jit; the golden path calls the same function on numpy via
``jax.device_get`` or uses cv2 directly (tests cross-check both).
"""

from __future__ import annotations

import jax.numpy as jnp

# sRGB -> XYZ (D65) matrix, IEC 61966-2-1.
_RGB2XYZ = (
    (0.4124564, 0.3575761, 0.1804375),
    (0.2126729, 0.7151522, 0.0721750),
    (0.0193339, 0.1191920, 0.9503041),
)
# D65 reference white.
_WHITE = (0.95047, 1.0, 1.08883)

_DELTA = 6.0 / 29.0


def srgb_to_linear(c: jnp.ndarray) -> jnp.ndarray:
    """Inverse sRGB gamma. Input in [0, 1]."""
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _lab_f(t: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(
        t > _DELTA**3,
        jnp.cbrt(t),
        t / (3.0 * _DELTA**2) + 4.0 / 29.0,
    )


def rgb_to_lab(rgb: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) sRGB in [0, 1] -> (..., 3) CIELab (L in [0,100]).

    Accepts uint8 input (auto-scaled by 1/255).
    """
    if rgb.dtype == jnp.uint8:
        rgb = rgb.astype(jnp.float32) / 255.0
    rgb = rgb.astype(jnp.float32)
    lin = srgb_to_linear(rgb)
    # Explicit per-channel FMAs, NOT ``lin @ m.T``: a DEFAULT-precision f32
    # matmul may round its operands (TF32 on the GPU), an error that would
    # dominate the fp32-mode feature-parity budget. This form is exact f32.
    r, g, b_ = lin[..., 0], lin[..., 1], lin[..., 2]
    m = _RGB2XYZ
    xyz = jnp.stack(
        [m[i][0] * r + m[i][1] * g + m[i][2] * b_ for i in range(3)],
        axis=-1,
    )
    xyz = xyz / jnp.asarray(_WHITE, dtype=jnp.float32)
    f = _lab_f(xyz)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return jnp.stack([L, a, b], axis=-1)
