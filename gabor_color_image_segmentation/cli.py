"""gaborseg CLI (SURVEY.md C19): run / eval / bench / info.

    python -m gabor_color_image_segmentation.cli run  --preset config0 --image img.jpg --out seg.png
    python -m gabor_color_image_segmentation.cli eval --preset config3 --split test --out results.jsonl --resume
    python -m gabor_color_image_segmentation.cli info --preset config1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


def _add_preset_args(p):
    p.add_argument("--preset", default="config0")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--k", type=int, default=None, help="cluster count override")
    p.add_argument("--method", choices=["kmeans", "gmm"], default=None)
    p.add_argument("--cut", choices=["ncut", "mincut"], default=None)
    p.add_argument("--color-space", choices=["lab", "rgb"], default=None)
    p.add_argument(
        "--feature-impl", choices=["auto", "direct", "modulated", "triton"], default=None
    )
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument(
        "--cue-weight", choices=["static", "coherence"], default=None,
        help="feature cue weighting; 'coherence' with --coherence-pow 2 is "
        "the measured recommendation for texture-dominated imagery",
    )
    p.add_argument("--coherence-pow", type=float, default=None)
    p.add_argument(
        "--feature-set", choices=["full", "color", "texture"], default=None
    )


def _build_cfg(args):
    from gabor_color_image_segmentation.config import preset

    cfg = preset(args.preset)
    if args.batch:
        cfg = cfg.replace(batch_size=args.batch)
    if args.k:
        cfg = cfg.replace(cluster=dataclasses.replace(cfg.cluster, k=args.k))
    if args.method:
        cfg = cfg.replace(cluster=dataclasses.replace(cfg.cluster, method=args.method))
    if args.cut:
        cfg = cfg.replace(
            graph=dataclasses.replace(cfg.graph, enabled=True, cut=args.cut)
        )
    if args.color_space:
        cfg = cfg.replace(color_space=args.color_space)
    if args.feature_impl:
        cfg = cfg.replace(feature_impl=args.feature_impl)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if args.cue_weight:
        cfg = cfg.replace(
            cluster=dataclasses.replace(cfg.cluster, cue_weight=args.cue_weight)
        )
    if args.coherence_pow is not None:
        cfg = cfg.replace(
            cluster=dataclasses.replace(
                cfg.cluster, coherence_pow=args.coherence_pow
            )
        )
    if args.feature_set:
        cfg = cfg.replace(
            cluster=dataclasses.replace(cfg.cluster, feature_set=args.feature_set)
        )
    return cfg


def cmd_run(args):
    import cv2

    from gabor_color_image_segmentation.models.pipeline import segment_images

    cfg = _build_cfg(args)
    if args.image:
        bgr = cv2.imread(args.image, cv2.IMREAD_COLOR)
        if bgr is None:
            sys.exit(f"cannot read image: {args.image}")
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    else:
        from gabor_color_image_segmentation.data.synthetic import synthetic_mosaic

        rgb, _ = synthetic_mosaic(h=321, w=481, n_regions=5, seed=args.seed)
    labels = np.asarray(segment_images(rgb[None], cfg))[0]
    print(
        json.dumps(
            {
                "shape": list(labels.shape),
                "n_regions": int(len(np.unique(labels))),
                "preset": args.preset,
            }
        )
    )
    if args.out:
        from gabor_color_image_segmentation.utils.visualize import save_label_map

        save_label_map(labels, args.out, rgb=rgb)
        print(f"wrote {args.out}", file=sys.stderr)


def cmd_eval(args):
    from gabor_color_image_segmentation.eval import (
        evaluate,
        evaluate_sweep,
        load_split,
    )

    cfg = _build_cfg(args)
    data = load_split(args.split, limit=args.limit)
    if args.sweep_k:
        ks = [int(k) for k in args.sweep_k.split(",")]
        summary = evaluate_sweep(data, cfg, ks, out_path=args.out or "/tmp/gaborseg_sweep")
    else:
        summary = evaluate(
            data,
            cfg,
            out_path=args.out,
            resume=args.resume,
            profile_dir=args.profile,
            debug_nans=args.debug_nans,
        )
    print(json.dumps(summary))


def cmd_bench(args):
    from gabor_color_image_segmentation.benchmark import run_benchmark

    from gabor_color_image_segmentation.config import preset

    cfg = _build_cfg(args)  # honors ALL preset-override flags (--k, --method, ...)
    if not args.dtype:
        cfg = cfg.replace(dtype="bfloat16")  # bench default is production mode
    # unmodified preset -> let run_benchmark use the stored CPU baseline
    stock = cfg == preset(args.preset).replace(dtype=cfg.dtype, batch_size=cfg.batch_size)
    print(
        json.dumps(
            run_benchmark(
                preset_name=args.preset,
                batch_size=cfg.batch_size,
                iters=args.iters,
                dtype=cfg.dtype,
                subsample=args.subsample,
                measure_cpu=args.measure_cpu,
                cfg=None if stock else cfg,
            )
        )
    )


def cmd_info(args):
    from gabor_color_image_segmentation.config import PRESETS
    from gabor_color_image_segmentation.ops.bank import make_bank

    cfg = _build_cfg(args)
    bank = make_bank(cfg.bank)
    print(
        json.dumps(
            {
                "preset": cfg.name,
                "presets": sorted(PRESETS),
                "n_kernels": bank.n_kernels,
                "groups": [
                    {
                        "sigma": g.sigma,
                        "ksize": g.ksize,
                        "n_kernels": len(g.kernel_indices),
                        "smooth_sigma": g.smooth_sigma,
                    }
                    for g in bank.groups
                ],
                "max_halo": bank.max_halo,
                "feature_dim": 3 * bank.n_kernels + 3,
                "config": dataclasses.asdict(cfg),
            },
            indent=2,
        )
    )


def main(argv=None):
    from gabor_color_image_segmentation.utils.jit_cache import (
        enable_compilation_cache,
    )

    enable_compilation_cache()  # 104.6 -> 6.2 s cold start (jit_cache.py)
    ap = argparse.ArgumentParser(prog="gaborseg")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="segment one image")
    _add_preset_args(p_run)
    p_run.add_argument("--image", default=None, help="input image (else synthetic)")
    p_run.add_argument("--out", default=None, help="output overlay png")
    p_run.add_argument("--seed", type=int, default=0)
    p_run.set_defaults(fn=cmd_run)

    p_eval = sub.add_parser("eval", help="evaluate a split")
    _add_preset_args(p_eval)
    p_eval.add_argument("--split", default="test")
    p_eval.add_argument("--limit", type=int, default=None)
    p_eval.add_argument("--out", default=None, help="per-image jsonl path")
    p_eval.add_argument("--resume", action="store_true")
    p_eval.add_argument("--profile", default=None, help="jax profiler trace dir")
    p_eval.add_argument("--debug-nans", action="store_true", help="jax_debug_nans")
    p_eval.add_argument(
        "--sweep-k",
        default=None,
        help="comma list of region/cluster counts; reports ODS/OIS-style "
        "best-k aggregation (BSDS operating-point protocol analog)",
    )
    p_eval.set_defaults(fn=cmd_eval)

    p_bench = sub.add_parser("bench", help="end-to-end throughput (one JSON line)")
    _add_preset_args(p_bench)  # provides --preset/--batch/--dtype overrides
    p_bench.add_argument("--iters", type=int, default=20)
    p_bench.add_argument("--subsample", type=int, default=1)
    p_bench.add_argument("--measure-cpu", action="store_true")
    p_bench.set_defaults(fn=cmd_bench)

    p_info = sub.add_parser("info", help="describe a preset / bank")
    _add_preset_args(p_info)
    p_info.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
