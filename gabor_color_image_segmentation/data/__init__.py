"""Data / IO layer (SURVEY.md L0): BSDS500 loader + synthetic stand-in."""

from gabor_color_image_segmentation.data.synthetic import (
    synthetic_mosaic,
    synthetic_dataset,
    synthetic_mosaic_multigt,
)
from gabor_color_image_segmentation.data.bsds import BSDS500, bsds_available

__all__ = ["synthetic_mosaic", "synthetic_mosaic_multigt", "synthetic_dataset", "BSDS500", "bsds_available"]
