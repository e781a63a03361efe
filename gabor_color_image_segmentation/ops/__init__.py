"""Core ops: color transform, Gabor bank, feature extraction (XLA + a Triton kernel)."""

from gabor_color_image_segmentation.ops.color import rgb_to_lab, srgb_to_linear
from gabor_color_image_segmentation.ops.bank import (
    GaborBank,
    gabor_kernel,
    gaussian_kernel_1d,
    make_bank,
)

__all__ = [
    "rgb_to_lab",
    "srgb_to_linear",
    "GaborBank",
    "gabor_kernel",
    "gaussian_kernel_1d",
    "make_bank",
]
