"""Visualization (SURVEY.md C18): segment overlays and boundary images."""

from __future__ import annotations

import numpy as np

# fixed qualitative palette (repeats beyond 12 regions)
_PALETTE = np.array(
    [
        [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
        [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
        [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
    ],
    dtype=np.uint8,
)


def label_colors(labels: np.ndarray) -> np.ndarray:
    """(H, W) int labels -> (H, W, 3) uint8 color image."""
    return _PALETTE[labels % len(_PALETTE)]


def overlay(labels: np.ndarray, rgb: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Blend label colors over the source image, boundary pixels in black."""
    from gabor_color_image_segmentation.metrics.boundary import boundaries_np

    col = label_colors(labels).astype(np.float32)
    base = rgb.astype(np.float32)
    out = (1 - alpha) * base + alpha * col
    b = boundaries_np(labels)
    out[b] = 0.0
    return out.clip(0, 255).astype(np.uint8)


def save_label_map(labels: np.ndarray, path: str, rgb: np.ndarray | None = None):
    import cv2

    img = overlay(labels, rgb) if rgb is not None else label_colors(labels)
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def plot_metrics(jsonl_path: str, out_png: str):
    """Histogram of per-image PRI / boundary-F from an eval jsonl."""
    import json

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pri, fb = [], []
    with open(jsonl_path) as f:
        for line in f:
            row = json.loads(line)
            if row.get("pri") is not None:
                pri.append(row["pri"])
            if row.get("f_boundary") is not None:
                fb.append(row["f_boundary"])
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(pri, bins=20)
    axes[0].set_title(f"PRI (mean {np.mean(pri):.3f})" if pri else "PRI")
    axes[1].hist(fb, bins=20)
    axes[1].set_title(f"boundary F (mean {np.mean(fb):.3f})" if fb else "boundary F")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
