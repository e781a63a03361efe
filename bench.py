"""End-to-end benchmark — prints ONE JSON line.

Metric (BASELINE.json): BSDS500-shaped megapixels/sec/chip end-to-end
(host uint8 batch in -> int32 label maps out) on the flagship workload:
full 8x5x2 Gabor bank over CIELab, batch of 16 481x321 images, k-means k=5
(BASELINE config 1). ``vs_baseline`` is the speedup over the CPU golden path
(the reference-equivalent implementation, SURVEY.md §6 — the reference
published no numbers; the golden path defines the 100x denominator).

Thin wrapper over gabor_color_image_segmentation.benchmark (also
reachable as ``cli.py bench``).

Usage:
    python bench.py                 # GPU bench + stored CPU baseline
    python bench.py --measure-cpu   # re-measure the CPU golden baseline too
    python bench.py --preset config0 --batch 4 --iters 5
"""

from __future__ import annotations

import argparse
import json


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="config1")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument(
        "--dtype",
        default="bfloat16",
        choices=["float32", "bfloat16"],
        help="production mode is bfloat16 (feature parity 1.6e-3 rel-to-peak,"
        " >=99.9%% label agreement vs golden); float32 is parity-grade",
    )
    ap.add_argument(
        "--subsample",
        type=int,
        default=1,
        help="fit Lloyd on every n-th pixel, assign all (1 = exact semantics)",
    )
    ap.add_argument("--measure-cpu", action="store_true")
    ap.add_argument("--cpu-images", type=int, default=1)
    args = ap.parse_args()

    from gabor_color_image_segmentation.benchmark import run_benchmark

    result = run_benchmark(
        preset_name=args.preset,
        batch_size=args.batch,
        iters=args.iters,
        dtype=args.dtype,
        subsample=args.subsample,
        measure_cpu=args.measure_cpu,
        cpu_images=args.cpu_images,
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
