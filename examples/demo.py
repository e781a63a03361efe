"""End-to-end demo: segment a synthetic texture mosaic with three pipeline
families (k-means, GMM, SLIC + n-cut), score against ground truth, and save
overlays. Runs anywhere (CPU or GPU, no dataset needed); with BSDS500_ROOT
set, pass --bsds <image-id> to use a real image instead.

Run: python examples/demo.py [--out-dir out/] [--bsds 100075]
"""

import argparse
import os

import numpy as np

import gabor_color_image_segmentation as gcis
from gabor_color_image_segmentation.data import synthetic_mosaic
from gabor_color_image_segmentation.metrics import pri_np
from gabor_color_image_segmentation.metrics.boundary import fboundary_np
from gabor_color_image_segmentation.models.pipeline import (
    segment_image,
    segment_images,
)
from gabor_color_image_segmentation.utils.visualize import save_label_map


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="demo_out")
    ap.add_argument("--bsds", default=None, help="BSDS500 image id")
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)

    if args.bsds:
        from gabor_color_image_segmentation.data.bsds import BSDS500
        rgb, gts = BSDS500().load("test", args.bsds)
    else:
        rgb, gt = synthetic_mosaic(h=321, w=481, n_regions=5, seed=args.seed)
        gts = [gt]

    runs = [
        ("kmeans", gcis.preset("config0")),
        ("gmm", gcis.preset("config0").replace(
            cluster=gcis.preset("config2").cluster)),
        ("slic_ncut", gcis.preset("config3")),
    ]
    for name, cfg in runs:
        if cfg.graph.enabled:
            labels = np.asarray(segment_images(rgb[None], cfg)[0])
        else:
            labels = np.asarray(segment_image(rgb, cfg)[0])
        pri = pri_np(labels, gts)
        p, r, f = fboundary_np(labels, gts)
        out = os.path.join(args.out_dir, f"{name}.png")
        save_label_map(labels, out, rgb=rgb)
        print(f"{name:10s} regions={len(np.unique(labels)):3d} "
              f"PRI={pri:.4f} F={f:.4f} (P={p:.3f} R={r:.3f}) -> {out}")


if __name__ == "__main__":
    main()
