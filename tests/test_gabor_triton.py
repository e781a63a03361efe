"""The Triton feature kernels (ops/gabor_triton.py) in the Pallas
interpreter against the plain XLA form (ops/modulated.py), plus the
host-built operands and the wrapper's shapes. The compiled kernel runs only
on a GPU (``gpu`` marker; chip_smoke.py runs the same check on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest

from gabor_color_image_segmentation.config import BankConfig, preset
from gabor_color_image_segmentation.data.synthetic import synthetic_mosaic
from gabor_color_image_segmentation.ops import gabor_triton as gt
from gabor_color_image_segmentation.ops.bank import make_bank
from gabor_color_image_segmentation.ops.modulated import (
    gabor_energies_mod,
    modulated_group_energies,
)
from golden.features import rgb_to_lab_np

# max |triton - modulated f32| / max |modulated f32|: float32 runs every dot
# at HIGHEST (only summation order differs); bfloat16 rounds the image, the
# complex taps and the vertical pass to bf16 (the XLA bf16 form's own error
# is of the same order, ~3e-3)
BOUND = {"float32": 2e-5, "bfloat16": 1.5e-2}


def _lab(h, w, seed=1):
    rgb, _ = synthetic_mosaic(h=h, w=w, n_regions=3, seed=seed)
    return jnp.asarray(rgb_to_lab_np(rgb))[None]


def _rel_err(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    return float(np.abs(out - ref).max() / np.abs(ref).max())


GROUPS = [("config0", i) for i in range(3)] + [("config1", i) for i in range(5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bank_name,group", GROUPS)
def test_group_matches_modulated(bank_name, group, dtype):
    """Every scale group of both preset banks, both dtypes."""
    bank = make_bank(preset(bank_name).bank)
    g = bank.groups[group]
    lab = _lab(45, 70)
    out = gt._triton_group(lab, g, bank, jnp.dtype(dtype), True)
    ref = modulated_group_energies(lab, g, bank, jnp.float32)
    assert out.dtype == jnp.float32
    assert _rel_err(out, ref) < BOUND[dtype]


@pytest.mark.parametrize("hw", [(33, 97), (70, 45), (17, 130)])
def test_odd_sizes_match_modulated(hw):
    """Sizes that are not multiples of any tile, tall and wide, and an
    image shorter than the largest smoothing radius (reflections fold more
    than once)."""
    bank = make_bank(preset("config0").bank)
    lab = _lab(*hw, seed=4)
    out = gt.gabor_energies_triton(lab, bank, jnp.float32, interpret=True)
    ref = gabor_energies_mod(lab, bank, jnp.float32)
    assert _rel_err(out, ref) < BOUND["float32"]


def test_batch_of_two_matches_per_image():
    bank = make_bank(preset("config0").bank)
    lab = jnp.concatenate([_lab(40, 56, 2), _lab(40, 56, 3)])
    g = bank.groups[1]
    both = np.asarray(gt._triton_group(lab, g, bank, jnp.float32, True))
    for i in range(2):
        one = np.asarray(gt._triton_group(lab[i:i + 1], g, bank, jnp.float32, True))
        np.testing.assert_allclose(both[i:i + 1], one, rtol=1e-6, atol=1e-3)


# max |tiled - untiled| / max |untiled|, both through the Triton kernel
# (ops/tiled.py contract). bfloat16: each window centres and rounds its own
# input, so the two runs differ by bf16 rounding (measured 1.5e-3 to 2.1e-3
# on three 96x128 mosaics, the same size as their distance from float32).
TILED_BOUND = {"float32": 2e-5, "bfloat16": 5e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_matches_untiled(dtype):
    """ops/tiled.py windows with the Triton kernel inside equal the untiled
    run up to rounding (tiled.py contract), in both modes."""
    from gabor_color_image_segmentation.ops.tiled import gabor_energies_tiled

    bank = make_bank(preset("config0").bank)
    lab = _lab(96, 128, 7)
    fn = lambda x, b, d: gt.gabor_energies_triton(x, b, d, interpret=True)
    ref = fn(lab, bank, jnp.dtype(dtype))
    tiled = gabor_energies_tiled(lab, bank, jnp.dtype(dtype), (40, 50), fn)
    assert _rel_err(tiled, ref) < TILED_BOUND[dtype]


@pytest.mark.parametrize("n", [2, 5, 64, 100])
def test_smooth_tiles_fold_reflect101(n):
    """Each row block of the smoothing tiles equals REFLECT_101 padding +
    VALID correlation on the rows it owns (the magnitude border contract)."""
    rng = np.random.default_rng(n)
    taps = rng.random(2 * 7 + 1)
    n_tiles = -(-n // gt.TS)
    tiles = gt._smooth_tiles(taps, n, n_tiles).astype(np.float64)
    sig = rng.random(n)
    padded = np.pad(sig, 7, mode="reflect")
    ref = np.correlate(padded, taps, mode="valid")
    window = np.zeros(n_tiles * gt.TS + 2 * gt.R)
    window[gt.R:gt.R + n] = sig
    for i in range(n_tiles):
        got = tiles[i * gt.TS:(i + 1) * gt.TS] @ window[i * gt.TS:i * gt.TS + gt.MW]
        rows = slice(i * gt.TS, min(n, (i + 1) * gt.TS))
        np.testing.assert_allclose(got[: rows.stop - rows.start], ref[rows], rtol=1e-6)
        assert (got[rows.stop - rows.start:] == 0).all()


def test_band_operands_are_the_separable_kernel():
    """kv_j (x) kh_j rebuilt from the band tiles is the bank's 2-D complex
    kernel before DC correction (K = G(dy) G(dx) e^{-i w.d})."""
    bank = make_bank(preset("config0").bank)
    g = bank.groups[0]
    ops = gt._group_operands(g, bank)
    p = g.ksize // 2
    shift = gt.P - p
    j = 1
    kv = ops["kv_re"][j * gt.TM] + 1j * ops["kv_im"][j * gt.TM]
    kh = ops["kh_re"][j * gt.XW:(j + 1) * gt.XW, 0] + 1j * ops["kh_im"][j * gt.XW:(j + 1) * gt.XW, 0]
    k2 = np.outer(kv[shift:shift + 2 * p + 1], kh[shift:shift + 2 * p + 1])
    re = g.filters_hwio[:, :, 0, 2 * j].astype(np.float64)
    im = g.filters_hwio[:, :, 0, 2 * j + 1].astype(np.float64)
    # the bank's real part is DC-corrected: add mu back before comparing
    np.testing.assert_allclose(k2.real, re + ops["mu"][j], atol=1e-5)
    np.testing.assert_allclose(np.abs(k2.imag), np.abs(im), atol=1e-5)


def test_fits_and_rejects():
    assert gt.fits(preset("config1").bank) and gt.fits(preset("config0").bank)
    wide = BankConfig(scales=(12.0,), max_ksize=51)
    assert not gt.fits(wide)
    bank = make_bank(wide)
    with pytest.raises(ValueError, match="halos"):
        gt.gabor_energies_triton(_lab(40, 40), bank, jnp.float32, interpret=True)
    with pytest.raises(ValueError, match="gamma"):
        gt.gabor_energies_triton(
            _lab(40, 40), make_bank(BankConfig(gamma=0.5)), jnp.float32,
            interpret=True,
        )


@pytest.mark.gpu
def test_compiled_kernel_matches_modulated(require_gpu):
    """The kernels as Triton compiles them for the card (chip_smoke.py's
    feature-kernel phase checks the same at config1's full widths)."""
    bank = make_bank(preset("config1").bank)
    lab = _lab(96, 128)
    ref = gabor_energies_mod(lab, bank, jnp.float32)
    for dtype in ("float32", "bfloat16"):
        out = gt.gabor_energies_triton(lab, bank, jnp.dtype(dtype))
        assert _rel_err(out, ref) < BOUND[dtype]
