"""Benchmark-loop evaluation harness (SURVEY.md §3.4, §5.3-5.5).

Runs a PipelineConfig over a dataset split (BSDS500 if present, else the
synthetic stand-in), batching images onto the device, computing PRI and
boundary-F per image, and appending one JSON line per image to an output
file. ``resume=True`` skips image ids already present in the output (the
reference family's feature-cache-as-resume analog at experiment level).
Per-image isolation: a failed/degenerate image yields a sentinel row, never
a batch abort (SURVEY.md §5.3).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger("gaborseg.eval")

from gabor_color_image_segmentation.config import PipelineConfig
from gabor_color_image_segmentation.metrics.boundary import fboundary_np
from gabor_color_image_segmentation.metrics.pri import pri_np
from gabor_color_image_segmentation.metrics.region import (
    mean_covering_np,
    mean_voi_np,
)
from gabor_color_image_segmentation.models.pipeline import segment_images
from gabor_color_image_segmentation.ops.bank import make_bank


def _batches(
    items: List[Tuple[str, np.ndarray, list]], batch_size: int
) -> Iterator[List[Tuple[str, np.ndarray, list]]]:
    for i in range(0, len(items), batch_size):
        yield items[i : i + batch_size]


def _done_ids(path: str) -> set:
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["id"])
                except (json.JSONDecodeError, KeyError):
                    continue
    return done


def evaluate(
    dataset: Iterable[Tuple[str, np.ndarray, Sequence[np.ndarray]]],
    cfg: PipelineConfig,
    out_path: Optional[str] = None,
    resume: bool = False,
    profile_dir: Optional[str] = None,
    debug_nans: bool = False,
) -> dict:
    """Run cfg over (id, rgb, gts) items -> summary dict; jsonl side effect."""
    import jax

    if debug_nans:  # the device-side numerical 'sanitizer' (SURVEY.md §5.2)
        jax.config.update("jax_debug_nans", True)

    bank = make_bank(cfg.bank)
    done = _done_ids(out_path) if (resume and out_path) else set()
    items = [(i, rgb, gts) for (i, rgb, gts) in dataset if i not in done]

    rows: List[dict] = []
    out_f = open(out_path, "a") if out_path else None
    profile_ctx = (
        jax.profiler.trace(profile_dir) if profile_dir else _NullCtx()
    )
    t_start = time.perf_counter()
    pixels = 0
    try:
        with profile_ctx:
            for chunk in _batches(items, cfg.batch_size):
                ids = [c[0] for c in chunk]
                rgbs = np.stack([c[1] for c in chunk])
                gts = [c[2] for c in chunk]
                pixels += rgbs.shape[0] * rgbs.shape[1] * rgbs.shape[2]
                t0 = time.perf_counter()
                labels = np.asarray(segment_images(rgbs, cfg, bank))
                log.info(
                    "batch %s..%s: segment %.1f ms (%d images)",
                    ids[0], ids[-1], (time.perf_counter() - t0) * 1e3, len(ids),
                )
                for i, image_id in enumerate(ids):
                    row = {"id": image_id}
                    try:
                        row["pri"] = pri_np(labels[i], gts[i]) if gts[i] else None
                        if gts[i]:
                            p, r, f = fboundary_np(labels[i], gts[i])
                            row.update(precision=p, recall=r, f_boundary=f)
                            row["voi"] = mean_voi_np(labels[i], gts[i])
                            row["covering"] = mean_covering_np(
                                labels[i], gts[i]
                            )
                        row["n_regions"] = int(len(np.unique(labels[i])))
                    except Exception as e:  # per-image isolation (§5.3)
                        row["error"] = repr(e)
                    rows.append(row)
                    if out_f:
                        out_f.write(json.dumps(row) + "\n")
                        out_f.flush()
    finally:
        if out_f:
            out_f.close()
    wall = time.perf_counter() - t_start

    ok = [r for r in rows if "error" not in r and r.get("pri") is not None]
    summary = {
        "config": cfg.name,
        "n_images": len(rows),
        "n_failed": len(rows) - len(ok),
        "mean_pri": float(np.mean([r["pri"] for r in ok])) if ok else None,
        "mean_f_boundary": (
            float(np.mean([r["f_boundary"] for r in ok]))
            if ok and "f_boundary" in ok[0]
            else None
        ),
        "mean_voi": (
            float(np.mean([r["voi"] for r in ok]))
            if ok and "voi" in ok[0]
            else None
        ),
        "mean_covering": (
            float(np.mean([r["covering"] for r in ok]))
            if ok and "covering" in ok[0]
            else None
        ),
        "wall_s": wall,
        "mp_per_s": pixels / 1e6 / wall if wall > 0 else None,
    }
    return summary


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def evaluate_sweep(
    dataset,
    cfg: PipelineConfig,
    ks: Sequence[int],
    out_path: Optional[str] = None,
) -> dict:
    """ODS/OIS-style aggregation over the segmentation scale parameter
    (SURVEY.md §3.4): the BSDS benchmark reports the best operating point of
    a detector's threshold sweep; the region-segmentation analog sweeps the
    region count k. ODS = best single k over the whole split; OIS = best k
    chosen per image.

    Runs ``evaluate`` once per k (region count for the graph stage when
    enabled, else cluster k) and aggregates PRI and boundary-F.
    """
    import dataclasses

    if not out_path:
        raise ValueError("evaluate_sweep requires out_path (per-k jsonl files)")
    items = list(dataset)
    per_k: dict[int, List[dict]] = {}
    for k in ks:
        if cfg.graph.enabled:
            cfg_k = cfg.replace(graph=dataclasses.replace(cfg.graph, n_regions=k))
        else:
            cfg_k = cfg.replace(cluster=dataclasses.replace(cfg.cluster, k=k))
        path = f"{out_path}.k{k}.jsonl"
        evaluate(items, cfg_k, out_path=path)
        with open(path) as f:
            per_k[k] = [json.loads(line) for line in f]

    def agg(metric: str, best=max) -> dict:
        """best=max for higher-is-better metrics, best=min for VoI."""
        means = {
            k: float(np.mean([r[metric] for r in rows if r.get(metric) is not None]))
            for k, rows in per_k.items()
        }
        ods_k = best(means, key=means.get)
        # OIS: best k per image
        n = len(per_k[ks[0]])
        ois_vals = []
        for i in range(n):
            vals = [
                per_k[k][i][metric]
                for k in ks
                if per_k[k][i].get(metric) is not None
            ]
            if vals:
                ois_vals.append(best(vals))
        return {
            "ods_k": int(ods_k),
            "ods": means[ods_k],
            "ois": float(np.mean(ois_vals)) if ois_vals else None,
            "per_k": {int(k): v for k, v in means.items()},
        }

    return {
        "config": cfg.name,
        "ks": [int(k) for k in ks],
        "n_images": len(items),
        "pri": agg("pri"),
        "f_boundary": agg("f_boundary"),
        "voi": agg("voi", best=min),
        "covering": agg("covering"),
    }


def load_split(
    split: str = "test",
    limit: Optional[int] = None,
    image_hw: Tuple[int, int] = (321, 481),
    n_synthetic: int = 20,
):
    """BSDS500 split if available, else deterministic synthetic stand-in."""
    from gabor_color_image_segmentation.data.bsds import BSDS500, bsds_available
    from gabor_color_image_segmentation.data.synthetic import synthetic_dataset

    if bsds_available():
        ds = BSDS500()
        return list(ds.iter_split(split, limit=limit))
    h, w = image_hw
    n = limit if limit is not None else n_synthetic
    return list(synthetic_dataset(n, h=h, w=w, seed={"train": 0, "val": 1000, "test": 2000}.get(split, 0)))
