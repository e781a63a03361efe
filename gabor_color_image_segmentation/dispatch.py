"""The one place where a configuration's implementation choices resolve.

Every stage with more than one implementation reads its choice from
``resolve_impls`` (the feature stage through ``energies_fn``); no other
module branches on the backend.

* Feature stage (``PipelineConfig.feature_impl``):
    "direct"    — depthwise 2-D convolutions (any envelope aspect ratio)
    "modulated" — modulate + separable blur, plain XLA (gamma == 1)
    "triton"    — the fused Pallas kernel compiled through Triton
                  (ops/gabor_triton.py; gamma == 1, GPU only)
    "auto"      — "direct" for anisotropic banks; otherwise "triton" for
                  bfloat16 production runs on a GPU when the bank's radii
                  fit the kernel's halos, and "modulated" everywhere else
                  (float32 is parity mode, which keeps the exact-f32 XLA
                  form).
* Eigensolver (``GraphConfig.eig_method``): "eigh" (dense, exact) or
  "subspace" (matmul-only subspace iteration); "auto" is "eigh".

SLIC superpixels and connectivity enforcement have one implementation
each (the exact-f32 XLA forms in models/slic.py), so nothing resolves
for them. An unknown or removed option raises ``ValueError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

FEATURE_IMPLS = ("auto", "direct", "modulated", "triton")
EIG_METHODS = ("auto", "eigh", "subspace")


class Impls(NamedTuple):
    feature: str
    eig: str


def resolve_eig_method(eig_method: str) -> str:
    if eig_method not in EIG_METHODS:
        raise ValueError(
            f"unknown eig_method {eig_method!r}; have {EIG_METHODS}"
        )
    return "eigh" if eig_method == "auto" else eig_method


def _triton_fits(bank_config) -> bool:
    from gabor_color_image_segmentation.ops.gabor_triton import fits

    return fits(bank_config)


def resolve_impls(cfg, backend: Optional[str] = None) -> Impls:
    """(PipelineConfig, JAX backend name) -> concrete implementation names.

    ``backend`` defaults to ``jax.default_backend()``."""
    impl = cfg.feature_impl
    if impl not in FEATURE_IMPLS:
        raise ValueError(
            f"unknown feature_impl {impl!r}; have {FEATURE_IMPLS}"
        )
    if backend is None:
        import jax

        backend = jax.default_backend()
    isotropic = cfg.bank.gamma == 1.0
    if impl == "auto":
        if not isotropic:
            impl = "direct"
        elif backend == "gpu" and cfg.dtype == "bfloat16" and _triton_fits(
            cfg.bank
        ):
            impl = "triton"
        else:
            impl = "modulated"
    if impl in ("modulated", "triton") and not isotropic:
        raise ValueError(f"feature_impl={impl!r} requires gamma == 1")
    if impl == "triton" and backend != "gpu":
        raise ValueError(
            f"feature_impl='triton' compiles for a GPU; backend is {backend!r}"
        )
    return Impls(impl, resolve_eig_method(cfg.graph.eig_method))


def energies_fn(cfg, backend: Optional[str] = None):
    """The feature stage's energies function for ``cfg``. Every choice
    shares the (img, bank, dtype) signature and the NHWC contract-order
    output."""
    impl = resolve_impls(cfg, backend).feature
    if impl == "triton":
        from gabor_color_image_segmentation.ops.gabor_triton import (
            gabor_energies_triton,
        )

        return gabor_energies_triton
    if impl == "modulated":
        from gabor_color_image_segmentation.ops.modulated import (
            gabor_energies_mod,
        )

        return gabor_energies_mod
    from gabor_color_image_segmentation.ops.features import gabor_energies

    return gabor_energies
