"""Gabor-bank construction: cv2 parity + bank properties (SURVEY.md §4.1-2)."""

import math

import cv2
import numpy as np
import pytest

from gabor_color_image_segmentation.config import BankConfig
from gabor_color_image_segmentation.ops.bank import (
    gabor_kernel,
    gaussian_kernel_1d,
    make_bank,
)


@pytest.mark.parametrize("sigma,theta,lambd,psi", [
    (2.0, 0.0, 4.0, 0.0),
    (3.0, math.pi / 4, 6.0, math.pi / 2),
    (4.0, 2.1, 8.0, 1.0),
])
def test_real_part_matches_cv2(sigma, theta, lambd, psi):
    ksize = 2 * int(math.ceil(3 * sigma)) + 1
    ours = np.real(gabor_kernel(ksize, sigma, theta, lambd, gamma=1.0, psi=psi))
    ref = cv2.getGaborKernel((ksize, ksize), sigma, theta, lambd, 1.0, psi, cv2.CV_64F)
    np.testing.assert_allclose(ours, ref, atol=1e-12)


def test_imag_part_is_quadrature():
    k0 = gabor_kernel(15, 2.0, 0.3, 5.0, psi=0.0)
    # imag(psi=0) == real(psi=-pi/2): sin(x) = cos(x - pi/2)
    k90 = gabor_kernel(15, 2.0, 0.3, 5.0, psi=-math.pi / 2)
    np.testing.assert_allclose(np.imag(k0), np.real(k90), atol=1e-12)


def test_bank_shapes_and_dc():
    cfg = BankConfig(scales=(2.0, 4.0), orientations=4, frequencies=(0.1, 0.2))
    bank = make_bank(cfg)
    assert bank.n_kernels == 2 * 4 * 2 == cfg.n_kernels
    seen = set()
    for g in bank.groups:
        assert g.filters_hwio.shape == (g.ksize, g.ksize, 1, 2 * len(g.kernel_indices))
        # real part is DC-corrected: zero response to a constant image
        for j in range(len(g.kernel_indices)):
            assert abs(g.filters_hwio[:, :, 0, 2 * j].sum()) < 1e-4
        seen.update(g.kernel_indices)
    assert seen == set(range(bank.n_kernels))


def test_default_frequency_from_bandwidth():
    cfg = BankConfig(scales=(3.0,), orientations=1, frequencies=None)
    (sigma, theta, lam, ksize) = cfg.kernel_params()[0]
    assert math.isclose(sigma / lam, 0.56, rel_tol=1e-6)


def test_gaussian_taps_match_scipy():
    from scipy.ndimage._filters import _gaussian_kernel1d

    sigma, radius = 2.5, 8
    ours = gaussian_kernel_1d(sigma, radius)
    ref = _gaussian_kernel1d(sigma, 0, radius)[::-1]
    np.testing.assert_allclose(ours, ref, atol=1e-12)


def test_max_halo():
    cfg = BankConfig(scales=(2.0, 4.0), orientations=2)
    bank = make_bank(cfg)
    expected = max(
        cfg.ksize_for(s) // 2 + cfg.smooth_radius_for(s) for s in cfg.scales
    )
    assert bank.max_halo == expected == cfg.max_halo
