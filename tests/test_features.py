"""Feature-stage golden parity: XLA path vs cv2 golden path (SURVEY.md §4.1)."""

import numpy as np
import pytest

from gabor_color_image_segmentation.config import BankConfig, ClusterConfig
from gabor_color_image_segmentation.ops.bank import make_bank
from gabor_color_image_segmentation.ops.features import (
    assemble_features,
    gabor_energies,
)
from golden.features import (
    assemble_features_np,
    gabor_energies_golden,
    rgb_to_lab_np,
)

CFG = BankConfig(scales=(2.0, 4.0), orientations=3, frequencies=None)


@pytest.fixture(scope="module")
def lab(small_mosaic):
    rgb, _ = small_mosaic
    return rgb_to_lab_np(rgb)


@pytest.fixture(scope="module")
def bank():
    return make_bank(CFG)


def test_energies_match_golden(lab, bank):
    gold = gabor_energies_golden(lab, bank)
    ours = np.asarray(gabor_energies(lab[None], bank))[0]
    assert ours.shape == gold.shape == (*lab.shape[:2], 3 * bank.n_kernels)
    # fp32 conv accumulation differences; energies are O(1..100)
    np.testing.assert_allclose(ours, gold, atol=5e-3, rtol=1e-4)


def test_feature_assembly_matches_golden(lab, bank):
    ccfg = ClusterConfig(normalize=True, color_weight=0.7)
    gold_e = gabor_energies_golden(lab, bank)
    gold = assemble_features_np(gold_e, lab, ccfg)
    ours = np.asarray(
        assemble_features(gabor_energies(lab[None], bank), lab[None], ccfg)
    )[0]
    np.testing.assert_allclose(ours, gold, atol=2e-2)


def test_constant_image_has_zero_energy(bank):
    img = np.full((1, 40, 48, 3), 7.5, np.float32)
    e = np.asarray(gabor_energies(img, bank))
    assert np.abs(e).max() < 1e-2  # DC-corrected real + zero-mean imag


def test_rotation_equivariance():
    """Rotating the image by 90 deg permutes orientation channels (SURVEY §4.2)."""
    cfg = BankConfig(scales=(2.0,), orientations=4, frequencies=(0.15,))
    bank = make_bank(cfg)
    rng = np.random.default_rng(0)
    img = rng.random((64, 64, 1)).astype(np.float32)
    e = np.asarray(gabor_energies(img[None], bank))[0]
    e_rot = np.asarray(gabor_energies(np.rot90(img)[None].copy(), bank))[0]
    # orientation theta + 90deg: kernel index o -> (o + 2) mod 4
    for o in range(4):
        a = np.rot90(e[..., o])
        b = e_rot[..., (o + 2) % 4]
        # compare interiors (borders differ through reflect padding)
        m = 12
        np.testing.assert_allclose(a[m:-m, m:-m], b[m:-m, m:-m], atol=1e-2)


def test_batch_consistency(lab, bank):
    two = np.stack([lab, lab[::-1].copy()])
    e2 = np.asarray(gabor_energies(two, bank))
    e0 = np.asarray(gabor_energies(lab[None], bank))[0]
    np.testing.assert_allclose(e2[0], e0, atol=1e-5)


def test_energy_index_helper(bank):
    from gabor_color_image_segmentation.ops.features import energy_index

    seen = set()
    for g in bank.groups:
        for kidx in g.kernel_indices:
            for ch in range(3):
                pos = energy_index(bank, 3, kidx, ch)
                assert pos not in seen
                seen.add(pos)
    assert seen == set(range(3 * bank.n_kernels))


def test_feature_set_and_coherence_golden(small_mosaic):
    """feature_set ablation + cue_weight="coherence" match the golden
    mirror; "full"/"static" is bit-identical to the pre-knob behavior."""
    import dataclasses

    import jax.numpy as jnp

    from gabor_color_image_segmentation.config import ClusterConfig, preset
    from gabor_color_image_segmentation.models.pipeline import (
        compute_features,
    )
    from gabor_color_image_segmentation.ops.bank import make_bank
    from golden.features import features_golden

    rgb, _ = small_mosaic
    cfg = preset("config0").replace(feature_impl="modulated")
    bank = make_bank(cfg.bank)
    for fset, cue, pw in (
        ("full", "static", 1.0), ("color", "static", 1.0),
        ("texture", "static", 1.0), ("full", "coherence", 1.0),
        ("full", "coherence", 2.0),
    ):
        cc = dataclasses.replace(cfg.cluster, feature_set=fset,
                                 cue_weight=cue, coherence_pow=pw)
        ours = np.asarray(
            compute_features(jnp.asarray(rgb)[None], cfg.replace(cluster=cc),
                             bank)
        )[0]
        gold = features_golden(rgb, cfg.bank, cc, bank=bank)
        assert ours.shape == gold.shape, (fset, cue, ours.shape, gold.shape)
        scale = np.abs(gold).max()
        err = np.abs(ours - gold).max() / scale
        assert err < 2e-3, f"{fset}/{cue}/p={pw}: rel err {err}"
    # dims: color-only = 3, texture-only = E, full = E + 3
    e = bank.n_kernels * 3
    cc = dataclasses.replace(cfg.cluster, feature_set="color")
    f_c = compute_features(jnp.asarray(rgb)[None], cfg.replace(cluster=cc), bank)
    assert f_c.shape[-1] == 3
    cc = dataclasses.replace(cfg.cluster, feature_set="texture")
    f_t = compute_features(jnp.asarray(rgb)[None], cfg.replace(cluster=cc), bank)
    assert f_t.shape[-1] == e


