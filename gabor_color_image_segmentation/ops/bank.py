"""Gabor filter-bank construction (SURVEY.md C3).

Kernel math matches ``cv2.getGaborKernel`` (params documented at
opencv2/imgproc.hpp:1433-1447): rotated coordinates

    x' =  x cos(theta) + y sin(theta)
    y' = -x sin(theta) + y cos(theta)

Gaussian envelope ``exp(-(x'^2 + gamma^2 y'^2) / (2 sigma^2))`` and complex
carrier ``exp(i (2 pi x' / lambda + psi))``. The real part with psi equals
cv2's kernel exactly (verified in tests/test_bank.py).

Construction is done ONCE per config in numpy — kernel weights are config
constants, shared verbatim by the golden CPU path and the device path, so
kernel-weight parity is exact by construction. The bank is laid out for the
device feature stage as:

  * per-scale groups (kernels in a group share ksize and smoothing sigma),
  * within a group, an HWIO filter block of shape (k, k, 1, 2 * n_in_group)
    with real/imag parts interleaved as separate output channels
    (even = real, odd = imag),
  * a separable Gaussian smoothing kernel per group.

DC correction: the real part has its mean subtracted so a constant image
yields zero energy (texture features should not respond to flat color; the
color channels carry that information instead). This is a documented design
choice of this framework, applied identically in golden and device paths.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from gabor_color_image_segmentation.config import BankConfig


def gabor_kernel(
    ksize: int,
    sigma: float,
    theta: float,
    lambd: float,
    gamma: float = 1.0,
    psi: float = 0.0,
) -> np.ndarray:
    """Complex Gabor kernel, shape (ksize, ksize), complex128.

    Real part == cv2.getGaborKernel((ksize, ksize), sigma, theta, lambd,
    gamma, psi, CV_64F); imag part uses sin of the same phase.
    """
    half = ksize // 2
    # cv2 stores the kernel point-reflected (kernel[ymax-y, xmax-x] = G(x, y));
    # negating the grid reproduces that exactly, so kernel weights match
    # cv2.getGaborKernel bit-for-bit at float64.
    y, x = (-g for g in np.mgrid[-half : half + 1, -half : half + 1].astype(np.float64))
    ct, st = math.cos(theta), math.sin(theta)
    xr = x * ct + y * st
    yr = -x * st + y * ct
    envelope = np.exp(-(xr**2 + (gamma**2) * yr**2) / (2.0 * sigma**2))
    phase = 2.0 * math.pi * xr / lambd + psi
    return envelope * (np.cos(phase) + 1j * np.sin(phase))


def gaussian_kernel_1d(sigma: float, radius: int) -> np.ndarray:
    """Normalized 1-D Gaussian taps, shape (2*radius+1,), float64.

    Matches scipy.ndimage.gaussian_filter's kernel (_gaussian_kernel1d) for
    order=0: exp(-x^2 / 2 sigma^2) normalized to sum 1.
    """
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


@dataclass(frozen=True, eq=False)  # eq=False: hash by identity (jit static arg)
class ScaleGroup:
    """All kernels sharing one envelope sigma (hence ksize + smoothing)."""

    sigma: float
    ksize: int
    smooth_sigma: float
    smooth_radius: int
    # (ksize, ksize, 1, 2*n) HWIO float32; output channel 2j = Re, 2j+1 = Im
    filters_hwio: np.ndarray
    # (2*smooth_radius+1,) float32 separable smoothing taps
    smooth_taps: np.ndarray
    # flat kernel indices (into BankConfig.kernel_params order) of this group
    kernel_indices: Tuple[int, ...]


@dataclass(frozen=True, eq=False)  # eq=False: hash by identity (jit static arg)
class GaborBank:
    """Materialized bank: per-scale groups + global metadata."""

    config: BankConfig
    groups: Tuple[ScaleGroup, ...]
    n_kernels: int

    @property
    def max_halo(self) -> int:
        return max(g.ksize // 2 + g.smooth_radius for g in self.groups)

    @property
    def max_conv_radius(self) -> int:
        return max(g.ksize // 2 for g in self.groups)

    @property
    def max_smooth_radius(self) -> int:
        return max(g.smooth_radius for g in self.groups)

    def complex_kernels(self) -> List[np.ndarray]:
        """Flat list of complex kernels in kernel-index order (golden path)."""
        out: List[np.ndarray] = [None] * self.n_kernels  # type: ignore
        for g in self.groups:
            for j, idx in enumerate(g.kernel_indices):
                re = g.filters_hwio[:, :, 0, 2 * j]
                im = g.filters_hwio[:, :, 0, 2 * j + 1]
                out[idx] = re.astype(np.float64) + 1j * im.astype(np.float64)
        return out


@functools.lru_cache(maxsize=64)
def make_bank(cfg: BankConfig) -> GaborBank:
    """Memoized per BankConfig: GaborBank hashes by identity (it holds numpy
    arrays), so returning the SAME object per config keeps jit caches warm."""
    params = cfg.kernel_params()  # [(sigma, theta, lambda, ksize)] flat order
    groups: List[ScaleGroup] = []
    for s_idx, sigma in enumerate(cfg.scales):
        idxs = [i for i, p in enumerate(params) if p[0] == sigma]
        if not idxs:
            continue
        ksize = cfg.ksize_for(sigma)
        filters = np.zeros((ksize, ksize, 1, 2 * len(idxs)), dtype=np.float32)
        for j, i in enumerate(idxs):
            _, theta, lam, _ = params[i]
            k = gabor_kernel(ksize, sigma, theta, lam, cfg.gamma, cfg.psi)
            re = np.real(k)
            re = re - re.mean()  # DC-correct the real part (see module docstring)
            filters[:, :, 0, 2 * j] = re.astype(np.float32)
            filters[:, :, 0, 2 * j + 1] = np.imag(k).astype(np.float32)
        smooth_sigma = cfg.smooth_sigma_for(sigma)
        radius = cfg.smooth_radius_for(sigma)
        groups.append(
            ScaleGroup(
                sigma=float(sigma),
                ksize=ksize,
                smooth_sigma=smooth_sigma,
                smooth_radius=radius,
                filters_hwio=filters,
                smooth_taps=gaussian_kernel_1d(smooth_sigma, radius).astype(np.float32),
                kernel_indices=tuple(idxs),
            )
        )
    return GaborBank(config=cfg, groups=tuple(groups), n_kernels=len(params))
