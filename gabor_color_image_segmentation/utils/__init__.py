"""Utilities: label-map tools, feature cache, profiling helpers."""

from gabor_color_image_segmentation.utils.labels import (
    relabel_contiguous,
    align_labels,
    agreement_rate,
)

__all__ = ["relabel_contiguous", "align_labels", "agreement_rate"]
