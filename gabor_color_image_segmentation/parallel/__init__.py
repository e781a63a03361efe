"""Parallel execution layer: device meshes, data-parallel sharding, spatial
tiling with halo exchange (SURVEY.md §2.2, §5.7)."""

from gabor_color_image_segmentation.parallel.sharding import (
    make_mesh,
    segment_batch_sharded,
)

__all__ = ["make_mesh", "segment_batch_sharded"]
