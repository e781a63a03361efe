"""Modulated-separable Gabor features — the fast formulation (SURVEY.md C4-C6).

A Gabor kernel is a modulated Gaussian: K(d) = G_sigma(d) * exp(-i w.d)
(with this bank's cv2-compatible sign convention, ops/bank.py). Correlation
with it factors EXACTLY (for gamma == 1, the isotropic default) into

    resp(p) = exp(i w.p) * [ (I_pad(q) * exp(-i w.q)) (*) G_sigma ](p)

where (*) is a separable 1-D Gaussian pass per axis — the square truncation
window of the direct kernel is itself separable, so equality is exact, not
an approximation. This turns the O(k^2) 2-D depthwise conv (which XLA lowers
to the VPU) into: elementwise modulation + shared-tap 1-D passes + elementwise
demodulation — ~8x fewer FLOPs.

DC correction parity: the direct bank subtracts mean(Re K) from the real
part (ops/bank.py), i.e. the corrected real response is
Re(resp) - mu_j * boxsum(I) with boxsum = correlation with ones(k,k) — also
separable and shared per group. This module reproduces that exactly.

Used as: (a) the plain-XLA feature path ("modulated"), (b) the reference
the Triton kernel (ops/gabor_triton.py) is tested against.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
from jax import lax

from gabor_color_image_segmentation.ops.bank import GaborBank, ScaleGroup
from gabor_color_image_segmentation.ops.features import _reflect_pad


def _envelope_taps(sigma: float, radius: int) -> np.ndarray:
    """UNNORMALIZED 1-D Gaussian envelope taps exp(-t^2 / 2 sigma^2); the
    product of two of these equals the direct kernel's 2-D envelope."""
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    return np.exp(-0.5 * (t / sigma) ** 2).astype(np.float32)


def _sep_1d(x: jnp.ndarray, taps: jnp.ndarray, axis: int, dtype) -> jnp.ndarray:
    """VALID depthwise 1-D correlation along H (axis=1) or W (axis=2).

    Deliberately an ORDERED unrolled shift-multiply-add, not
    lax.conv_general_dilated: the conv lowering's accumulation order varies
    with the input SHAPE (~1e-3 absolute drift between a 256-row image and
    its 32-row strips), which breaks the bitwise tiled==untiled contract
    (parallel/tiling.py). Tap-ordered f32 accumulation is
    shape-independent, so strips and whole images produce identical floats;
    XLA fuses the k-term elementwise chain into one pass."""
    k = taps.shape[0]
    n = x.shape[axis]
    xs = x.astype(dtype)
    taps = taps.astype(dtype)
    acc = None
    for t in range(k):
        sl = lax.slice_in_dim(xs, t, t + n - k + 1, axis=axis)
        term = (taps[t] * sl).astype(jnp.float32)
        acc = term if acc is None else acc + term
    return acc


def group_frequencies(group: ScaleGroup, bank: GaborBank) -> np.ndarray:
    """Angular frequency vectors w_j = (2 pi / lambda_j)(cos th_j, sin th_j)
    for each kernel in the group, shape (n_g, 2) float64."""
    params = bank.config.kernel_params()
    out = []
    for idx in group.kernel_indices:
        _, theta, lam, _ = params[idx]
        w = 2.0 * math.pi / lam
        out.append((w * math.cos(theta), w * math.sin(theta)))
    return np.asarray(out)


def _dc_mu(group: ScaleGroup, bank: GaborBank) -> np.ndarray:
    """Recompute mu_j = mean(Re K_j) (pre-correction) per kernel, (n_g,)."""
    from gabor_color_image_segmentation.ops.bank import gabor_kernel

    params = bank.config.kernel_params()
    cfg = bank.config
    mus = []
    for idx in group.kernel_indices:
        sigma, theta, lam, ksize = params[idx]
        k = gabor_kernel(ksize, sigma, theta, lam, cfg.gamma, cfg.psi)
        mus.append(float(np.real(k).mean()))
    return np.asarray(mus, np.float32)


def modulated_group_magnitudes(
    img: jnp.ndarray,
    group: ScaleGroup,
    bank: GaborBank,
    dtype=jnp.float32,
    h_halo: int = 0,
    y0=0,
) -> jnp.ndarray:
    """DC-corrected response magnitudes for one scale group (pre-smoothing).

    img: (B, H_in, W, C) -> (B, H_out, W, n_g*C) magnitudes, contract order.

    Spatial-tiling hooks (parallel/tiling.py, two-level halo exchange):
      * ``h_halo`` — the input already carries ``h_halo >= p`` REAL neighbor
        rows on both H sides (H_out = H_in - 2*h_halo); no internal H
        padding happens, so interior-seam magnitudes equal the untiled run
        bitwise. h_halo=0 (default) reflect-pads H internally.
      * ``y0`` — GLOBAL image row of output row 0. The modulation /
        demodulation phases use global coordinates, so a strip's plane-wave
        values are bitwise-identical to the untiled run's (the phase shift
        cancels only in exact arithmetic, not in float).
    """
    if bank.config.gamma != 1.0:
        raise ValueError("modulated path requires isotropic envelope gamma=1")
    b, h_in, w, c = img.shape
    n = len(group.kernel_indices)
    p = group.ksize // 2

    env = jnp.asarray(_envelope_taps(group.sigma, p))
    freqs = group_frequencies(group, bank)  # (n, 2) [wx, wy]
    mus = jnp.asarray(_dc_mu(group, bank))  # (n,)

    if h_halo:
        if h_halo < p:
            raise ValueError(f"h_halo {h_halo} < conv radius {p}")
        h = h_in - 2 * h_halo
        xpad = _reflect_pad(img[:, h_halo - p : h_in - (h_halo - p)], 0, p)
    else:
        h = h_in
        xpad = _reflect_pad(img, p, p)  # (B, H+2p, W+2p, C)

    # plane waves over PADDED coords (q runs from y0-p in global rows)
    yy = (jnp.arange(-p, h + p, dtype=jnp.float32) + y0).reshape(-1, 1)
    xx = jnp.arange(-p, w + p, dtype=jnp.float32).reshape(1, -1)
    wx = jnp.asarray(freqs[:, 0], jnp.float32).reshape(1, 1, -1)
    wy = jnp.asarray(freqs[:, 1], jnp.float32).reshape(1, 1, -1)
    phase_q = wx * xx[..., None] + wy * yy[..., None]  # (H+2p, W+2p, n)
    cos_q = jnp.cos(phase_q)
    sin_q = jnp.sin(phase_q)

    # modulated channels: M = I * exp(-i w q) -> re = I cos, im = -I sin
    # layout: (B, Hp, Wp, C*2n), channel-major: [c0k0re, c0k0im, c0k1re, ...]
    xe = xpad[..., :, None, None]  # (B,Hp,Wp,C,1,1)
    mod = jnp.stack([cos_q, -sin_q], axis=-1)  # (Hp,Wp,n,2)
    m = (xe * mod[None, :, :, None, :, :]).reshape(b, h + 2 * p, w + 2 * p, c * 2 * n)

    # separable envelope blur (exact equivalent of the 2-D truncated envelope)
    v = _sep_1d(m, env, axis=1, dtype=dtype)  # (B, H, Wp, C*2n)
    g = _sep_1d(v, env, axis=2, dtype=dtype)  # (B, H, W, C*2n)
    g = g.reshape(b, h, w, c, n, 2)

    # boxsum for DC correction: correlation with ones(k,k), separable
    ones = jnp.ones((group.ksize,), jnp.float32)
    box = _sep_1d(_sep_1d(xpad, ones, 1, dtype), ones, 2, dtype)  # (B,H,W,C)

    # demodulate at pixel coords p (q grid restricted to the interior)
    phase_p = phase_q[p : p + h, p : p + w]  # (H, W, n)
    cos_p = jnp.cos(phase_p)[None, :, :, None, :]
    sin_p = jnp.sin(phase_p)[None, :, :, None, :]
    re = cos_p * g[..., 0] - sin_p * g[..., 1]  # (B,H,W,C,n)
    im = sin_p * g[..., 0] + cos_p * g[..., 1]
    re = re - mus.reshape(1, 1, 1, 1, -1) * box[..., None]
    # (B,H,W,C,n) -> contract order: kernel-major, channel-minor
    mag = jnp.sqrt(re * re + im * im)
    return jnp.transpose(mag, (0, 1, 2, 4, 3)).reshape(b, h, w, n * c)


def smooth_group_magnitudes(
    mag: jnp.ndarray, group: ScaleGroup, dtype=jnp.float32, h_halo: int = 0
) -> jnp.ndarray:
    """Gaussian energy smoothing of a group's magnitude maps.

    h_halo=0: reflect-pads H (the border contract: reflect the MAGNITUDE
    map). h_halo>0: the input carries h_halo >= r magnitude rows on both H
    sides (real neighbor rows — or, at a true border, the caller's
    REFLECT_101 of owned magnitudes, which IS the contract); no internal H
    padding. W always reflect-pads locally (W is never sharded)."""
    r = group.smooth_radius
    smooth = jnp.asarray(group.smooth_taps)
    if h_halo:
        if h_halo < r:
            raise ValueError(f"h_halo {h_halo} < smooth radius {r}")
        m = mag[:, h_halo - r : mag.shape[1] - (h_halo - r)]
    else:
        m = _reflect_pad(mag, r, 0)
    s = _sep_1d(m, smooth, 1, dtype)
    s = _sep_1d(_reflect_pad(s, 0, r), smooth, 2, dtype)
    return s


def modulated_group_energies(
    img: jnp.ndarray, group: ScaleGroup, bank: GaborBank, dtype=jnp.float32
) -> jnp.ndarray:
    """Energies for one scale group via modulation. img: (B,H,W,C) ->
    (B,H,W,C*n_g) smoothed energies (channel-major, group-kernel minor) —
    identical values (up to float assoc) to features._group_energies."""
    mag = modulated_group_magnitudes(img, group, bank, dtype)
    return smooth_group_magnitudes(mag, group, dtype)


def gabor_energies_mod(
    img: jnp.ndarray, bank: GaborBank, dtype=jnp.float32
) -> jnp.ndarray:
    """(B,H,W,C) -> (B,H,W,N*C) energies, contract order; fast XLA path."""
    parts = [modulated_group_energies(img, g, bank, dtype) for g in bank.groups]
    return jnp.concatenate(parts, axis=-1)
