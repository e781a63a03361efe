"""dispatch.resolve_impls: the one place implementation choices resolve,
and the options removed with their kernels raise."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gabor_color_image_segmentation.config import (
    BankConfig,
    GraphConfig,
    PipelineConfig,
    preset,
)
from gabor_color_image_segmentation.dispatch import energies_fn, resolve_impls


@pytest.mark.parametrize(
    "feature_impl,dtype,backend,gamma,want",
    [
        ("auto", "bfloat16", "gpu", 1.0, "triton"),
        ("auto", "float32", "gpu", 1.0, "modulated"),
        ("auto", "bfloat16", "cpu", 1.0, "modulated"),
        ("auto", "float32", "cpu", 1.0, "modulated"),
        ("auto", "bfloat16", "gpu", 0.5, "direct"),
        ("direct", "bfloat16", "gpu", 1.0, "direct"),
        ("modulated", "bfloat16", "gpu", 1.0, "modulated"),
        ("triton", "float32", "gpu", 1.0, "triton"),
    ],
)
def test_feature_resolution(feature_impl, dtype, backend, gamma, want):
    cfg = preset("config0").replace(
        feature_impl=feature_impl, dtype=dtype,
        bank=dataclasses.replace(preset("config0").bank, gamma=gamma),
    )
    assert resolve_impls(cfg, backend).feature == want


@pytest.mark.parametrize(
    "impl,backend,module",
    [
        ("auto", "cpu", "ops.modulated"),
        ("direct", "cpu", "ops.features"),
        ("modulated", "gpu", "ops.modulated"),
        ("auto", "gpu", "ops.gabor_triton"),
    ],
)
def test_energies_fn_follows_resolution(impl, backend, module):
    """The pipeline's energies function is the one resolve_impls names."""
    cfg = preset("config0").replace(feature_impl=impl, dtype="bfloat16")
    fn = energies_fn(cfg, backend)
    assert fn.__module__ == f"gabor_color_image_segmentation.{module}"


def test_auto_keeps_xla_when_the_bank_exceeds_the_kernel_halos():
    wide = BankConfig(scales=(12.0,), max_ksize=51)
    cfg = PipelineConfig(bank=wide, dtype="bfloat16")
    assert resolve_impls(cfg, "gpu").feature == "modulated"


@pytest.mark.parametrize(
    "kwargs,backend,match",
    [
        ({"feature_impl": "pallas"}, "gpu", "unknown feature_impl"),
        ({"feature_impl": "fused"}, "cpu", "unknown feature_impl"),
        ({"feature_impl": "triton"}, "cpu", "compiles for a GPU"),
        ({"feature_impl": "triton", "bank": BankConfig(gamma=0.5)}, "gpu",
         "gamma"),
        ({"graph": GraphConfig(eig_method="lanczos")}, "gpu",
         "unknown eig_method"),
    ],
)
def test_unknown_or_removed_options_raise(kwargs, backend, match):
    cfg = preset("config0").replace(**kwargs)
    with pytest.raises(ValueError, match=match):
        resolve_impls(cfg, backend)


@pytest.mark.parametrize(
    "make",
    [
        lambda: GraphConfig(slic_impl="fused"),
        lambda: PipelineConfig(mesh_shape=(8,)),
    ],
    ids=["slic_impl", "mesh_shape"],
)
def test_removed_config_fields_raise(make):
    with pytest.raises(TypeError):
        make()


@pytest.mark.parametrize("impl", ["pallas", "triton"])
def test_pipeline_refuses_unusable_feature_impl(impl):
    """On the CPU backend the pipeline raises instead of silently running
    another implementation or an interpreter."""
    from gabor_color_image_segmentation.models.pipeline import segment_batch
    from gabor_color_image_segmentation.ops.bank import make_bank

    cfg = preset("config0").replace(feature_impl=impl)
    rgb = np.zeros((1, 32, 32, 3), np.uint8)
    with pytest.raises(ValueError):
        segment_batch(jnp.asarray(rgb), cfg, make_bank(cfg.bank))


@pytest.mark.parametrize("eig_method,want", [("auto", "eigh"), ("eigh", "eigh"),
                                              ("subspace", "subspace")])
def test_eig_resolution(eig_method, want):
    cfg = preset("config3").replace(
        graph=dataclasses.replace(preset("config3").graph, eig_method=eig_method)
    )
    for backend in ("cpu", "gpu"):
        assert resolve_impls(cfg, backend).eig == want
