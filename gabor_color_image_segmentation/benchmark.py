"""End-to-end throughput benchmark core (SURVEY.md §6; BASELINE metric).

Shared by the repo-root ``bench.py`` (one JSON line) and ``cli.py bench``.
Measures end-to-end MP/s on the GPU: each timed step uploads the host uint8
batch, runs the jitted pipeline and copies the int32 label maps back to
the host, ended by ``block_until_ready``. Without a GPU it refuses to run.
"""

from __future__ import annotations

import time

import numpy as np

# CPU golden-path throughput for the same workloads (MP/s), measured on a
# 1-core x86 host via measure_cpu_golden (2026-08-16; config4 re-measured
# 2026-08-20 after the preset moved to the pooled cut chain).
# Method-correct: config2's golden runs the f64 GMM EM, config3's runs
# SLIC + spectral n-cut, config4's the full filter->cluster->cut chain.
CPU_BASELINE_MP_S = {
    "config0": 0.1632,
    "config1": 0.0113,
    "config2": 0.00087,
    "config3": 0.02925,
    "config4": 0.1276,
}


def build_batch(cfg, n_images: int) -> np.ndarray:
    from gabor_color_image_segmentation.data import synthetic_mosaic

    h, w = cfg.image_hw
    return np.stack(
        [
            synthetic_mosaic(h=h, w=w, n_regions=5, seed=100 + i)[0]
            for i in range(n_images)
        ]
    )


def require_gpu():
    """The jax devices the measurement runs on; raises without a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"benchmark needs a GPU; jax backend is {jax.default_backend()!r}"
        )
    return jax.devices()


def device_info() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    devs = require_gpu()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def bench_device(cfg, batch: np.ndarray, iters: int) -> float:
    """MP/s for host uint8 batch in -> host int32 label maps out."""
    import jax

    from gabor_color_image_segmentation.models.pipeline import segment_batch
    from gabor_color_image_segmentation.ops.bank import make_bank

    require_gpu()
    bank = make_bank(cfg.bank)

    def step():
        labels, _ = segment_batch(jax.device_put(batch), cfg, bank, False)
        return np.asarray(labels.block_until_ready())

    step()  # warm-up / compile
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    dt = (time.perf_counter() - t0) / iters
    mp = batch.shape[0] * batch.shape[1] * batch.shape[2] / 1e6
    return mp / dt


def measure_cpu_golden(cfg, batch: np.ndarray, n_images: int = 1) -> float:
    """Golden-path (reference-equivalent) throughput in MP/s: the same
    stage chain as the preset under test (golden/pipeline.py)."""
    from golden.pipeline import segment_golden
    from gabor_color_image_segmentation.ops.bank import make_bank

    bank = make_bank(cfg.bank)
    t0 = time.perf_counter()
    for i in range(n_images):
        segment_golden(batch[i], cfg, bank)
    dt = (time.perf_counter() - t0) / n_images
    return batch.shape[1] * batch.shape[2] / 1e6 / dt


def run_benchmark(
    preset_name: str = "config1",
    batch_size: int | None = None,
    iters: int = 20,
    dtype: str = "bfloat16",
    subsample: int = 1,
    measure_cpu: bool = False,
    cpu_images: int = 1,
    cfg=None,
) -> dict:
    """Returns the result dict (the content of bench.py's one JSON line).

    Pass ``cfg`` (a PipelineConfig) to benchmark an arbitrary configuration
    (the CLI's preset-override flags build one); the stored CPU baseline is
    only trusted for unmodified presets."""
    import dataclasses
    import sys

    from gabor_color_image_segmentation.config import preset
    from gabor_color_image_segmentation.utils.jit_cache import (
        enable_compilation_cache,
    )

    enable_compilation_cache()  # persist the pipeline executable across runs

    stock = cfg is None
    if cfg is None:
        cfg = preset(preset_name).replace(dtype=dtype)
    if subsample != 1:
        cfg = cfg.replace(
            cluster=dataclasses.replace(cfg.cluster, subsample=subsample)
        )
    if batch_size:
        cfg = cfg.replace(batch_size=batch_size)
    batch = build_batch(cfg, cfg.batch_size)

    mp_s = bench_device(cfg, batch, iters)

    cpu_mp_s = CPU_BASELINE_MP_S.get(preset_name) if stock else None
    if measure_cpu or cpu_mp_s is None:
        cpu_mp_s = measure_cpu_golden(cfg, batch, cpu_images)
        print(
            f"# measured CPU golden baseline: {cpu_mp_s:.4f} MP/s",
            file=sys.stderr,
        )
    vs = mp_s / cpu_mp_s if cpu_mp_s else None
    return {
        "device": device_info(),
        "metric": f"end-to-end MP/s/chip ({cfg.name}: "
        f"{cfg.bank.n_kernels}-kernel bank, batch {cfg.batch_size}, "
        f"{cfg.cluster.method} k={cfg.cluster.k})",
        "value": round(mp_s, 3),
        "unit": "MP/s/chip",
        "vs_baseline": round(vs, 1) if vs else None,
    }
