"""Golden feature extraction: 2-D correlation + separable Gaussian smoothing.

Convention contract shared with the device path (ops/features.py
docstring): correlation, REFLECT_101 borders, per-channel depthwise
responses, complex magnitude, per-scale Gaussian energy smoothing,
contract-order energy layout, optional per-image standardization with
color_weight scaling.

The filters are scipy.ndimage's ``correlate``/``correlate1d`` in
``mode="mirror"``, which is OpenCV's BORDER_REFLECT_101 and equals the
reference family's ``cv2.filter2D``/``cv2.sepFilter2D`` (tests/test_golden.py
checks this where OpenCV is installed).
"""

from __future__ import annotations


import numpy as np
from scipy import ndimage

from gabor_color_image_segmentation.config import BankConfig, ClusterConfig
from gabor_color_image_segmentation.ops.bank import GaborBank, make_bank

# sRGB -> XYZ (D65); identical constants to ops/color.py.
_RGB2XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ]
)
_WHITE = np.array([0.95047, 1.0, 1.08883])
_DELTA = 6.0 / 29.0


def rgb_to_lab_np(rgb: np.ndarray) -> np.ndarray:
    """Numpy mirror of ops.color.rgb_to_lab (same math, float64 accumulate)."""
    if rgb.dtype == np.uint8:
        rgb = rgb.astype(np.float64) / 255.0
    rgb = rgb.astype(np.float64)
    lin = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    xyz = lin @ _RGB2XYZ.T / _WHITE
    f = np.where(xyz > _DELTA**3, np.cbrt(xyz), xyz / (3 * _DELTA**2) + 4.0 / 29.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], axis=-1).astype(np.float32)


def _corr2d(ch: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """2-D correlation with REFLECT_101 borders (= cv2.filter2D)."""
    return ndimage.correlate(
        ch.astype(np.float32), kernel.astype(np.float32), mode="mirror"
    )


def _sep_smooth(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Separable correlation, rows then columns, REFLECT_101 borders
    (= cv2.sepFilter2D)."""
    t = taps.astype(np.float32)
    y = ndimage.correlate1d(x.astype(np.float32), t, axis=1, mode="mirror")
    return ndimage.correlate1d(y, t, axis=0, mode="mirror")


def gabor_energies_golden(img: np.ndarray, bank: GaborBank) -> np.ndarray:
    """(H,W,C) channels -> (H,W,N*C) smoothed energies, contract order
    (group blocks; kernel-major, channel-minor — ops/features.py docstring)."""
    h, w, c = img.shape
    n = bank.n_kernels
    out = np.zeros((h, w, n * c), dtype=np.float32)
    offset = 0
    for g in bank.groups:
        for j in range(len(g.kernel_indices)):
            k_re = g.filters_hwio[:, :, 0, 2 * j]
            k_im = g.filters_hwio[:, :, 0, 2 * j + 1]
            for ch in range(c):
                re = _corr2d(img[:, :, ch], k_re)
                im = _corr2d(img[:, :, ch], k_im)
                mag = np.sqrt(re * re + im * im)
                out[:, :, offset + j * c + ch] = _sep_smooth(mag, g.smooth_taps)
        offset += len(g.kernel_indices) * c
    return out


def assemble_features_np(
    energies: np.ndarray,
    color: np.ndarray,
    cluster_cfg: ClusterConfig,
    eps: float = 1e-6,
) -> np.ndarray:
    fs = getattr(cluster_cfg, "feature_set", "full")
    if fs == "color":  # ablation knob — mirrors ops/features.py
        energies = energies[..., :0]
    elif fs == "texture":
        color = color[..., :0]
    feats = np.concatenate(
        [energies.astype(np.float32), color.astype(np.float32)], axis=-1
    )
    if cluster_cfg.normalize:
        # one-pass variance E[x^2] - mu^2, the exact formula the device
        # path uses (ops/features.py assemble_features: a two-pass std would
        # force a materialized f32 copy of the feature tensor on-device)
        flat = feats.reshape(-1, feats.shape[-1]).astype(np.float64)
        mean = flat.mean(axis=0)
        var = np.maximum((flat * flat).mean(axis=0) - mean * mean, 0.0)
        std = np.sqrt(var)
        feats = ((feats - mean) / (std + eps)).astype(np.float32)
    e = energies.shape[-1]
    # equal-total-variance balance of energy vs color blocks; see
    # ops/features.py assemble_features docstring (shared contract)
    cw = cluster_cfg.color_weight * float(np.sqrt(e / 3.0)) if e else 1.0
    scale = np.concatenate(
        [np.ones((e,), np.float32), np.full((color.shape[-1],), cw, np.float32)]
    )
    feats = feats * scale
    if getattr(cluster_cfg, "cue_weight", "static") == "coherence":
        cwts = coherence_weights_np(feats, eps)
        p = float(getattr(cluster_cfg, "coherence_pow", 1.0))
        feats = feats * (cwts if p == 1.0 else cwts ** p)
    return feats


def coherence_weights_np(feats: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Numpy mirror of ops/features.py::coherence_weights — per-dim
    std(8x8 block means)/std over the same cropped region, one-pass
    E[x^2]-mu^2 variances (f64 accumulate)."""
    h, w, d = feats.shape
    n = 8
    hb, wb = h // n, w // n
    if hb < 2 or wb < 2:
        return np.ones((1, 1, d), np.float32)
    f = feats[: hb * n, : wb * n].astype(np.float64)
    p = f.reshape(hb, n, wb, n, d).mean(axis=(1, 3))
    pv = np.maximum((p * p).mean((0, 1)) - p.mean((0, 1)) ** 2, 0.0)
    fv = np.maximum((f * f).mean((0, 1)) - f.mean((0, 1)) ** 2, 0.0)
    return (np.sqrt(pv) / (np.sqrt(fv) + eps)).astype(np.float32)[None, None]


def features_golden(
    rgb: np.ndarray,
    bank_cfg: BankConfig,
    cluster_cfg: ClusterConfig | None = None,
    color_space: str = "lab",
    bank: GaborBank | None = None,
) -> np.ndarray:
    """(H,W,3) sRGB -> (H,W,3N+3) pixel features. Golden end-to-end front-end."""
    if cluster_cfg is None:
        cluster_cfg = ClusterConfig()
    if bank is None:
        bank = make_bank(bank_cfg)
    if color_space == "lab":
        img = rgb_to_lab_np(rgb)
    elif color_space == "rgb":
        img = rgb.astype(np.float32)
        if rgb.dtype == np.uint8:
            img = img / 255.0
    else:
        raise ValueError(color_space)
    energies = gabor_energies_golden(img, bank)
    return assemble_features_np(energies, img, cluster_cfg)
