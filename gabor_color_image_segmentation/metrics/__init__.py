"""Evaluation metrics (SURVEY.md L6): BSDS500 PRI, boundary-F, VoI and
segmentation covering."""

from gabor_color_image_segmentation.metrics.pri import (
    rand_index_np,
    pri_np,
    pri_jax,
)
from gabor_color_image_segmentation.metrics.region import (
    voi_np,
    mean_voi_np,
    covering_np,
    mean_covering_np,
    voi_jax,
    covering_jax,
)

__all__ = [
    "rand_index_np",
    "pri_np",
    "pri_jax",
    "voi_np",
    "mean_voi_np",
    "covering_np",
    "mean_covering_np",
    "voi_jax",
    "covering_jax",
]
