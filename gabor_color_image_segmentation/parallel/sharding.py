"""Data-parallel batch sharding over a device mesh (SURVEY.md §3.5).

DP is the primary strategy (BASELINE config 4: "data-parallel batch"): the
image batch shards over the ``batch`` mesh axis; each device runs the full
filter->feature->cluster chain on its shard with no cross-device traffic.
Tested on a fake 8-device CPU mesh (SURVEY.md §4.4) and on four GPUs
(chip_smoke.py --four).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gabor_color_image_segmentation.config import PipelineConfig
from gabor_color_image_segmentation.ops.bank import GaborBank
from gabor_color_image_segmentation.models.pipeline import segment_batch


def make_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """1-D data-parallel mesh over the first n devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("batch",))


def _shard_map_unchecked(f, mesh, in_specs, out_specs):
    """shard_map with replication/VMA checking off: the solvers' early-exit
    while_loops carry batch-varying convergence flags, which the VMA checker
    rejects for locally-run programs."""
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False,
    )


@lru_cache(maxsize=None)
def make_sharded_fn(
    cfg: PipelineConfig, bank: GaborBank, mesh: Mesh,
    with_features: bool = True,
):
    """Jitted data-parallel segmenter: (B,H,W,3) sharded over mesh('batch') ->
    sharded (labels, features-or-None). Exposed so callers can
    ``.lower().compile()`` it and inspect the HLO — the DP leg must contain
    ZERO collectives. Built once per (cfg, bank, mesh, with_features), so
    repeated calls reuse one traced and compiled program.

    shard_map, not jit+GSPMD: each shard runs the FULL per-shard program
    locally — including the Triton feature kernel, whose custom call has
    no SPMD partitioning rule (under plain jit the partitioner would have
    to all-gather around it, breaking the zero-communication DP contract).
    The pipeline is batch-pointwise, so per-shard execution is exactly the
    sharded semantics.
    """
    out_specs = (P("batch"), P("batch") if with_features else None)
    return jax.jit(
        _shard_map_unchecked(
            partial(segment_batch, cfg=cfg, bank=bank,
                    with_features=with_features),
            mesh=mesh,
            in_specs=P("batch"),
            out_specs=out_specs,
        )
    )


def segment_batch_sharded(
    rgb: jax.Array, cfg: PipelineConfig, bank: GaborBank, mesh: Mesh,
    with_features: bool = True,
) -> Tuple[jax.Array, Optional[jax.Array]]:
    """(B,H,W,3) batch sharded over mesh('batch') -> sharded (labels, features).

    B must be divisible by the mesh size. The per-image pipeline is
    batch-pointwise, so sharding the batch axis makes XLA partition the whole
    program with zero communication (the embarrassingly-parallel benchmark
    loop, SURVEY.md §3.4-3.5). with_features=False serves sharded label maps
    only and returns (labels, None).
    """
    fn = make_sharded_fn(cfg, bank, mesh, with_features)
    rgb = jax.device_put(rgb, NamedSharding(mesh, P("batch")))
    return fn(rgb)
