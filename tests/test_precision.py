"""Precision audit (ops/precision.py): in float32 parity mode every f32
dot_general and convolution the pipeline lowers to carries HIGHEST, so no
site silently runs in TF32 on the GPU. Lowered on the CPU at small shapes;
the StableHLO is backend-independent at this level."""

import dataclasses
import re

import numpy as np
import pytest

from gabor_color_image_segmentation.config import preset
from gabor_color_image_segmentation.models.pipeline import segment_batch
from gabor_color_image_segmentation.ops.bank import make_bank

_OP = re.compile(r"stablehlo\.(dot_general|convolution)")
_F32_OPERAND = re.compile(r":\s*\(tensor<[^>]*xf32>|,\s*tensor<[^>]*xf32>\)")


def _unpinned_f32_ops(text: str):
    bad, n = [], 0
    for line in text.splitlines():
        if not _OP.search(line) or not _F32_OPERAND.search(line):
            continue
        n += 1
        if "DEFAULT" in line or "HIGHEST" not in line:
            bad.append(line.strip()[:200])
    return n, bad


CASES = {
    "config0": {},
    "config0-direct": {"feature_impl": "direct"},
    "config1": {},
    "config2": {},
    "config3": {},
    "config3-subspace": {"eig": "subspace"},
    "config4": {"tile_hw": (48, 64)},
}


@pytest.mark.parametrize("case", list(CASES))
def test_fp32_mode_pins_highest(case):
    name = case.split("-")[0]
    extra = dict(CASES[case])
    cfg = preset(name).replace(dtype="float32")
    if "eig" in extra:
        cfg = cfg.replace(graph=dataclasses.replace(
            cfg.graph, eig_method=extra.pop("eig")))
    cfg = cfg.replace(**extra)
    if cfg.graph.enabled:
        cfg = cfg.replace(graph=dataclasses.replace(cfg.graph, n_superpixels=48))
    h, w = (96, 128) if name == "config4" else (48, 64)
    rgb = np.zeros((2, h, w, 3), np.uint8)
    text = segment_batch.lower(rgb, cfg, make_bank(cfg.bank), False).as_text()
    n, bad = _unpinned_f32_ops(text)
    assert n > 0, "no f32 dot or convolution lowered — audit regex stale?"
    assert not bad, "\n".join(bad)


def test_audit_catches_a_default_f32_dot():
    import jax
    import jax.numpy as jnp

    text = jax.jit(lambda a: jnp.dot(a, a)).lower(jnp.ones((4, 4))).as_text()
    n, bad = _unpinned_f32_ops(text)
    assert n == 1 and len(bad) == 1
