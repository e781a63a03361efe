"""gabor_color_image_segmentation — Gabor color image segmentation in JAX.

A JAX / XLA / Pallas framework, run on an NVIDIA GPU, with the capabilities of the
reference repo ``CVMethods/gabor_color_image_segmentation`` (see SURVEY.md):

    image -> CIELab -> Gabor filter bank -> per-channel complex conv ->
    magnitude -> Gaussian energy smoothing -> pixel features (energy + color)
    -> {k-means | GMM} clustering and/or {SLIC superpixels -> affinity graph
    -> spectral normalized cut | graph merge min-cut} -> label map
    -> BSDS500 PRI / boundary-F evaluation.

Design stance (SURVEY.md §7.1): one pure-functional jit-compiled pipeline,
NHWC float32 (bfloat16 fast path), explicit PRNG keys, frozen dataclass
configs, batch-of-images as the unit of work, data-parallel sharding over a
``jax.sharding.Mesh`` and spatial tiling with halo exchange for large images.

The reference's source is not available (SURVEY.md §0); behavioural parity
is established against the in-repo CPU golden path (``golden/``) built from
the library routines the reference family uses (scipy/sklearn).
"""

from gabor_color_image_segmentation.config import (
    BankConfig,
    ClusterConfig,
    GraphConfig,
    PipelineConfig,
    PRESETS,
    preset,
)

__version__ = "0.1.0"

__all__ = [
    "BankConfig",
    "ClusterConfig",
    "GraphConfig",
    "PipelineConfig",
    "PRESETS",
    "preset",
    "__version__",
]
