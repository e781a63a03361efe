"""Gabor energies as two Pallas kernels compiled through Triton (GPU).

Same map as ops/modulated.py (isotropic envelope, gamma == 1), computed
without materializing the float32 complex planes of the XLA form. For an
isotropic envelope the DC-uncorrected Gabor kernel is separable:

    K(dy, dx) = G(dy) e^{-i wy dy} * G(dx) e^{-i wx dx} = kv(dy) kh(dx)

so the response is a complex vertical 1-D pass over the image followed by
a complex horizontal pass, and the DC correction subtracts mu_j times the
box sum of the image, exactly as in ops/modulated.py. Every 1-D pass is a
product with a banded Toeplitz tile, which the tensor cores take as a
``dot`` (bf16 operands, f32 accumulation; f32 operands at HIGHEST).

Kernel 1 (``_mag_kernel``), one program per (image, 32x32 magnitude tile):
    for each channel: load the 64x64 input window (tile + conv halo),
    box = Bv @ X @ Bh; for each kernel j of the scale group:
    V = Kv_j @ X (complex), G = V @ Kh_j (complex),
    mag = |G - mu_j box| -> (B, n*C, Hm, Wm) magnitudes in device memory.
Kernel 2 (``_smooth_kernel``), one program per (image, channel, 64x64
output tile): out = Sv_i @ mag_window @ Sh_k, where the smoothing
Toeplitz tiles fold in the REFLECT_101 border of the MAGNITUDE map (the
border contract, CLAUDE.md) — one pair of tiles per tile row / column.

The wrapper pads, runs both kernels per scale group and returns NHWC
energies in contract order (ops/features.py docstring). ``interpret=True``
runs the same kernels in the Pallas interpreter (CPU tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gabor_color_image_segmentation.ops.bank import GaborBank, ScaleGroup
from gabor_color_image_segmentation.ops.modulated import (
    _dc_mu,
    _envelope_taps,
    group_frequencies,
)
from gabor_color_image_segmentation.ops.precision import precision_for

TM = 32  # magnitude tile (rows = cols) of kernel 1
P = 16  # conv halo of kernel 1's input window: supports radius <= P
XW = TM + 2 * P  # kernel 1 input window (64)
TS = 64  # output tile of kernel 2
R = 32  # smoothing halo of kernel 2's window: supports radius <= R
MW = TS + 2 * R  # kernel 2 magnitude window (128)


def fits(bank_config) -> bool:
    """True when every scale group's conv and smoothing radii fit the
    kernels' fixed halos."""
    return bank_config.max_conv_radius <= P and bank_config.max_smooth_radius <= R


def _band(taps: np.ndarray, n_out: int, n_in: int, shift: int) -> np.ndarray:
    """(n_out, n_in) correlation matrix T[o, o + shift + t] = taps[t]."""
    t = np.zeros((n_out, n_in), taps.dtype)
    for o in range(n_out):
        t[o, o + shift : o + shift + len(taps)] = taps
    return t


def _reflect101(i: int, n: int) -> int:
    while i < 0 or i >= n:
        i = -i if i < 0 else 2 * (n - 1) - i
    return i


def _smooth_tiles(taps: np.ndarray, n: int, n_tiles: int) -> np.ndarray:
    """(n_tiles * TS, MW) float32: row block i maps the magnitude window of
    output tile i (image rows [i*TS - R, i*TS - R + MW)) to its TS outputs,
    REFLECT_101 of the magnitude folded in; rows past the image are zero."""
    r = len(taps) // 2
    out = np.zeros((n_tiles * TS, MW), np.float64)
    for i in range(n_tiles):
        y0 = i * TS
        for o in range(TS):
            y = y0 + o
            if y >= n:
                break
            for t in range(len(taps)):
                idx = _reflect101(y + t - r, n) - (y0 - R)
                assert 0 <= idx < MW, (y, t, idx)
                out[i * TS + o, idx] += taps[t]
    return out.astype(np.float32)


def _group_operands(group: ScaleGroup, bank: GaborBank):
    """Host-built, per scale group: complex Toeplitz tiles of every kernel
    (vertical (n*TM, XW), horizontal (n*XW, TM); real and imaginary parts),
    the box tiles, and the DC-correction means mu_j."""
    p = group.ksize // 2
    env = _envelope_taps(group.sigma, p).astype(np.float64)
    d = np.arange(-p, p + 1, dtype=np.float64)
    freqs = group_frequencies(group, bank)  # (n, 2) [wx, wy]
    kv = [env * np.exp(-1j * wy * d) for _, wy in freqs]
    kh = [env * np.exp(-1j * wx * d) for wx, _ in freqs]
    shift = P - p

    def vert(part):
        return np.concatenate([_band(part(k), TM, XW, shift) for k in kv])

    def horiz(part):
        return np.concatenate([_band(part(k), TM, XW, shift).T for k in kh])

    ones = np.ones(2 * p + 1)
    return dict(
        kv_re=vert(np.real), kv_im=vert(np.imag),
        kh_re=horiz(np.real), kh_im=horiz(np.imag),
        bv=_band(ones, TM, XW, shift), bh=_band(ones, TM, XW, shift).T,
        mu=_dc_mu(group, bank),
    )


def _mag_kernel(
    x_ref, kv_re_ref, kv_im_ref, kh_re_ref, kh_im_ref, bv_ref, bh_ref,
    mu_ref, out_ref, *, n: int, c: int, mm_dtype, precision,
):
    b = pl.program_id(0)
    y0 = pl.program_id(1) * TM
    x0 = pl.program_id(2) * TM

    def dot(u, v):
        return jax.lax.dot(
            u.astype(mm_dtype), v.astype(mm_dtype), precision=precision,
            preferred_element_type=jnp.float32,
        )

    bv, bh = bv_ref[...], bh_ref[...]
    for ch in range(c):
        x = x_ref[b, ch, pl.ds(y0, XW), pl.ds(x0, XW)]  # (XW, XW)
        box = dot(dot(bv, x), bh)  # (TM, TM)

        def body(j, carry, x=x, box=box, ch=ch):
            rows = pl.ds(j * TM, TM)
            cols = pl.ds(j * XW, XW)
            v_re = dot(kv_re_ref[rows, :], x)  # (TM, XW)
            v_im = dot(kv_im_ref[rows, :], x)
            h_re = kh_re_ref[cols, :]  # (XW, TM)
            h_im = kh_im_ref[cols, :]
            g_re = dot(v_re, h_re) - dot(v_im, h_im)
            g_im = dot(v_re, h_im) + dot(v_im, h_re)
            re = g_re - mu_ref[j] * box
            mag = jnp.sqrt(re * re + g_im * g_im)
            out_ref[b, j * c + ch, pl.ds(y0, TM), pl.ds(x0, TM)] = mag.astype(
                out_ref.dtype
            )
            return carry

        jax.lax.fori_loop(0, n, body, 0)


def _smooth_kernel(m_ref, sv_ref, sh_ref, out_ref, *, nc: int, mm_dtype,
                   precision):
    bc = pl.program_id(0)
    b, ch = bc // nc, bc % nc
    i = pl.program_id(1)
    k = pl.program_id(2)
    m = m_ref[b, ch, pl.ds(i * TS, MW), pl.ds(k * TS, MW)]  # (MW, MW)
    sv = sv_ref[pl.ds(i * TS, TS), :]  # (TS, MW)
    sh = sh_ref[pl.ds(k * MW, MW), :]  # (MW, TS)
    v = jax.lax.dot(sv.astype(mm_dtype), m.astype(mm_dtype),
                    precision=precision, preferred_element_type=jnp.float32)
    s = jax.lax.dot(v.astype(mm_dtype), sh.astype(mm_dtype),
                    precision=precision, preferred_element_type=jnp.float32)
    out_ref[b, ch, pl.ds(i * TS, TS), pl.ds(k * TS, TS)] = s.astype(
        out_ref.dtype
    )


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _triton_group(
    img: jnp.ndarray, group: ScaleGroup, bank: GaborBank, dtype,
    interpret: bool,
) -> jnp.ndarray:
    """(B, H, W, C) -> (B, H, W, n*C) smoothed energies of one scale group,
    contract order (kernel-major, channel-minor)."""
    b, h, w, c = img.shape
    n = len(group.kernel_indices)
    p = group.ksize // 2
    if p > P or group.smooth_radius > R:
        raise ValueError(
            f"scale group radii (conv {p}, smoothing {group.smooth_radius}) "
            f"exceed the kernel halos ({P}, {R})"
        )
    mm_dtype = jnp.bfloat16 if dtype == jnp.bfloat16 else jnp.float32
    precision = precision_for(mm_dtype)
    ops = _group_operands(group, bank)

    def mat(a):  # host constants, rounded once to the matmul dtype
        return jnp.asarray(a, jnp.float32).astype(mm_dtype)

    # output tiles of kernel 2; the magnitude map it reads covers image rows
    # [-R, nty*TS + R) and columns likewise — kernel 1's grid
    nty, ntx = _cdiv(h, TS), _cdiv(w, TS)
    hm, wm = nty * TS + 2 * R, ntx * TS + 2 * R
    # input: image rows [-R - P, hm - R + P); REFLECT_101 by the conv radius
    # (the magnitudes of rows [0, H) see exactly the untiled conv input),
    # zeros beyond (those magnitudes get zero smoothing weight). Centering
    # per image and channel leaves the DC-corrected response unchanged and
    # keeps the bf16 operands small.
    x = jnp.transpose(img.astype(jnp.float32), (0, 3, 1, 2))
    x = x - jnp.mean(x, axis=(2, 3), keepdims=True)
    x = jnp.pad(x, ((0, 0), (0, 0), (p, p), (p, p)), mode="reflect")
    top = R + P - p
    x = jnp.pad(x, ((0, 0), (0, 0), (top, hm + 2 * P - top - (h + 2 * p)),
                    (top, wm + 2 * P - top - (w + 2 * p))))
    x = x.astype(mm_dtype)

    mags = pl.pallas_call(
        functools.partial(_mag_kernel, n=n, c=c, mm_dtype=mm_dtype,
                          precision=precision),
        grid=(b, hm // TM, wm // TM),
        out_shape=jax.ShapeDtypeStruct((b, n * c, hm, wm), mm_dtype),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="gabor_magnitude",
    )(
        x, mat(ops["kv_re"]), mat(ops["kv_im"]), mat(ops["kh_re"]),
        mat(ops["kh_im"]), mat(ops["bv"]), mat(ops["bh"]),
        jnp.asarray(ops["mu"], jnp.float32),
    )

    taps = np.asarray(group.smooth_taps, np.float64)
    sv = _smooth_tiles(taps, h, nty)  # (nty*TS, MW)
    sh = np.concatenate(
        [t.T for t in np.split(_smooth_tiles(taps, w, ntx), ntx)]
    )  # (ntx*MW, TS)
    out = pl.pallas_call(
        functools.partial(_smooth_kernel, nc=n * c, mm_dtype=mm_dtype,
                          precision=precision),
        grid=(b * n * c, nty, ntx),
        out_shape=jax.ShapeDtypeStruct((b, n * c, nty * TS, ntx * TS),
                                       jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="gabor_smooth",
    )(mags, mat(sv), mat(sh))
    return jnp.transpose(out[:, :, :h, :w], (0, 2, 3, 1))


def gabor_energies_triton(
    img: jnp.ndarray, bank: GaborBank, dtype=jnp.float32,
    interpret: bool = False,
) -> jnp.ndarray:
    """(B,H,W,C) -> (B,H,W,N*C) smoothed energies, contract order.

    Drop-in for ops/modulated.py::gabor_energies_mod (gamma == 1): float32
    energies in both modes. bf16 mode computes with bf16 operands and keeps
    the magnitudes bf16 between the kernels; float32 mode runs every dot at
    HIGHEST. (Storing the energies in bf16 as well moves per-image GMM EM
    into another basin on config2 — golden agreement 0.545 vs 0.9994.)"""
    if bank.config.gamma != 1.0:
        raise ValueError("the Triton feature kernel requires gamma == 1")
    parts = [_triton_group(img, g, bank, dtype, interpret) for g in bank.groups]
    return jnp.concatenate(parts, axis=-1)
