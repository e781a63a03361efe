"""CPU golden path — the executable parity oracle (SURVEY.md §0.3, §7.2).

The reference's source is not available, so this package IS the behavioural
reference for the device build: it implements the reference family's
pipeline with the library semantics cited in SURVEY.md §2 (cv2.filter2D
correlation + REFLECT_101 borders, here through scipy.ndimage; separable
Gaussian smoothing; sklearn k-means/GMM semantics). It is also the CPU
baseline of the benchmark.

Pure numpy/scipy — no JAX computation here; ``golden.pipeline`` mirrors
``segment_batch`` for one image.
"""

from golden.features import features_golden, rgb_to_lab_np
from golden.cluster import kmeans_golden, gmm_golden, maximin_init_np
from golden.pipeline import segment_golden

__all__ = [
    "features_golden",
    "rgb_to_lab_np",
    "kmeans_golden",
    "gmm_golden",
    "maximin_init_np",
    "segment_golden",
]
