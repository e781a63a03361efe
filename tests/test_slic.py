"""SLIC superpixels: golden parity + structural properties (SURVEY.md C10)."""

import numpy as np
import pytest

from gabor_color_image_segmentation.models.slic import (
    enforce_connectivity,
    grid_shape,
    slic,
)
from golden.features import rgb_to_lab_np
from golden.graph import slic_golden


def test_matches_golden(small_mosaic):
    rgb, _ = small_mosaic
    lab = rgb_to_lab_np(rgb)
    ours = np.asarray(slic(lab, 64, 10.0, 10))
    gold = slic_golden(lab, 64, 10.0, 10)
    agree = (ours == gold).mean()
    assert agree > 0.999, f"SLIC agreement {agree}"


def test_label_range_and_coverage(small_mosaic):
    rgb, _ = small_mosaic
    lab = rgb_to_lab_np(rgb)
    n_target = 64
    labels = np.asarray(slic(lab, n_target, 10.0, 10))
    gh, gw, _ = grid_shape(*lab.shape[:2], n_target)
    assert labels.min() >= 0 and labels.max() < gh * gw
    # most cells survive as non-empty superpixels
    assert len(np.unique(labels)) > 0.7 * gh * gw


def test_locality(small_mosaic):
    """Each superpixel stays within a ~2-cell radius of its seed (SLIC ruler)."""
    rgb, _ = small_mosaic
    lab = rgb_to_lab_np(rgb)
    labels = np.asarray(slic(lab, 64, 10.0, 10))
    h, w = labels.shape
    gh, gw, s = grid_shape(h, w, 64)
    yy, xx = np.mgrid[0:h, 0:w]
    for v in np.unique(labels):
        m = labels == v
        cy, cx = (v // gw + 0.5) * h / gh, (v % gw + 0.5) * w / gw
        assert np.abs(yy[m] - cy).max() < 2.5 * s
        assert np.abs(xx[m] - cx).max() < 2.5 * s


def test_enforce_connectivity():
    # construct a label map with a disconnected fragment + a tiny island
    labels = np.zeros((20, 20), np.int32)
    labels[:, 10:] = 1
    labels[0:2, 0:2] = 1  # fragment of label 1 inside label 0 region
    labels[10, 3] = 2  # one-pixel island
    out = enforce_connectivity(labels, min_size=8)
    # islands absorbed; components contiguous
    from scipy import ndimage

    for v in np.unique(out):
        cc, n = ndimage.label(out == v)
        assert n == 1, f"label {v} split into {n} components"
    assert (out[0:2, 0:2] == out[3, 3]).all()  # fragment absorbed into region 0


def test_device_connectivity_matches_golden(small_mosaic):
    """enforce_connectivity_device == the numpy mirror, bit for bit."""
    from gabor_color_image_segmentation.models.slic import (
        enforce_connectivity_device,
    )
    from golden.graph import enforce_connectivity_golden

    rgb, _ = small_mosaic
    lab = rgb_to_lab_np(rgb)
    sp = np.asarray(slic(lab, 64, 10.0, 10))
    gh, gw, _ = grid_shape(*lab.shape[:2], 64)
    dev = np.asarray(enforce_connectivity_device(sp[None], gh * gw))[0]
    gold = enforce_connectivity_golden(sp, n_sp=gh * gw)
    assert (dev == gold).all()


def test_device_connectivity_crafted():
    """cv2 semantics: >= min_size components survive (renumbered in raster
    order), smaller fragments absorbed; output 4-connected."""
    from gabor_color_image_segmentation.models.slic import (
        enforce_connectivity_device,
    )
    from scipy import ndimage

    labels = np.zeros((20, 20), np.int32)
    labels[:, 10:] = 1
    labels[15:18, 2:5] = 1  # 9px fragment of label 1 inside label 0's region
    labels[10, 3] = 2  # one-pixel island
    # min_size default = 400 // 3 // 4 = 33 > 9: both fragments absorbed
    out = np.asarray(enforce_connectivity_device(labels[None], 3))[0]
    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    for v in np.unique(out):
        cc, ncc = ndimage.label(out == v, structure=structure)
        assert ncc == 1, f"label {v} split into {ncc} components"
    # raster renumbering: left region root (0,0) -> 0, right root (0,10) -> 1
    assert (out[:, 10:] == 1).all()
    assert out[10, 3] == 0 and (out[15:18, 2:5] == 0).all()  # absorbed
    assert set(np.unique(out)) == {0, 1}

    # a LARGE secondary fragment becomes its own superpixel (cv2 renumber)
    labels2 = np.zeros((20, 20), np.int32)
    labels2[:, 10:] = 1
    labels2[12:20, 0:6] = 1  # 48px >= min_size fragment of label 1
    out2 = np.asarray(enforce_connectivity_device(labels2[None], 3))[0]
    assert (out2[:, 10:] == 1).all()  # roots in raster order: 0, then right=1
    assert len(np.unique(out2)) == 3  # the big fragment got a NEW id (2)
    assert (out2[12:20, 0:6] == 2).all()


def test_graph_path_superpixels_are_connected(small_mosaic):
    """Property: every superpixel feeding the affinity graph in the config3
    device path is 4-connected (VERDICT round-1 item 5)."""
    import dataclasses

    import jax.numpy as jnp
    from scipy import ndimage

    from gabor_color_image_segmentation.config import preset
    from gabor_color_image_segmentation.models.slic import (
        enforce_connectivity_device,
        slic_batch,
    )

    rgb, _ = small_mosaic
    lab = rgb_to_lab_np(rgb)
    cfg = preset("config3")
    g = dataclasses.replace(cfg.graph, n_superpixels=64)
    gh, gw, _ = grid_shape(*lab.shape[:2], 64)
    # the exact sequence graph_segment_batch runs before superpixel_means
    sp = slic_batch(
        jnp.asarray(lab)[None], g.n_superpixels, g.slic_compactness,
        g.slic_iters,
    )
    raw = np.asarray(sp)[0]
    sp = np.asarray(enforce_connectivity_device(sp, gh * gw))[0]
    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    for v in np.unique(sp):
        cc, ncc = ndimage.label(sp == v, structure=structure)
        assert ncc == 1, f"superpixel {v} split into {ncc} components"
    # full-rule check (min_size survival, raster renumbering, s_max clamp,
    # absorption priority) via the bit-exact numpy mirror
    from golden.graph import enforce_connectivity_golden

    assert (sp == enforce_connectivity_golden(raw, n_sp=gh * gw)).all()




@pytest.mark.parametrize("n_sp", [64, 588, 800, 900])
def test_slic_batch_matches_golden(n_sp, small_mosaic, tiny_mosaic):
    """The batched exact-f32 XLA SLIC (the graph stage's entry) against
    golden per image, at the superpixel counts the graph configs use."""
    import jax.numpy as jnp

    from gabor_color_image_segmentation.models.slic import slic_batch

    rgb = small_mosaic[0]
    labs = np.stack([
        rgb_to_lab_np(rgb),
        rgb_to_lab_np(np.ascontiguousarray(rgb[::-1, ::-1])),
    ])
    out = np.asarray(slic_batch(jnp.asarray(labs), n_sp, 5.0, 10))
    gh, gw, _ = grid_shape(*labs.shape[1:3], n_sp)
    for i in range(2):
        gold = slic_golden(labs[i], n_sp, 5.0, 10)
        agree = (out[i] == gold).mean()
        assert agree > 0.999, f"n_sp={n_sp} image {i}: agreement {agree}"
        assert out[i].max() < gh * gw


def _blocky(rng, h, w, cells):
    """Random label map of small blocks: many fragments of every label."""
    coarse = rng.integers(0, cells, size=(h // 3 + 1, w // 3 + 1))
    return np.repeat(np.repeat(coarse, 3, 0), 3, 1)[:h, :w].astype(np.int32)


@pytest.mark.parametrize("kind", ["noise", "blocks", "slic900"])
def test_connectivity_batch_matches_golden(kind, small_mosaic):
    """enforce_connectivity_device over a batch == the numpy mirror per
    image, bit for bit: pixel noise (every component below min_size — the
    guarded degenerate case), blocky fragments, and real SLIC output at
    config3's superpixel count."""
    import jax.numpy as jnp

    from gabor_color_image_segmentation.models.slic import (
        enforce_connectivity_device,
    )
    from golden.graph import enforce_connectivity_golden

    rng = np.random.default_rng(11)
    h, w = 96, 128
    if kind == "noise":
        sp = rng.integers(0, 64, size=(2, h, w)).astype(np.int32)
        n_sp = 64
    elif kind == "blocks":
        sp = np.stack([_blocky(rng, h, w, 48) for _ in range(2)])
        n_sp = 48
    else:
        lab = rgb_to_lab_np(small_mosaic[0])
        gh, gw, _ = grid_shape(h, w, 900)
        n_sp = gh * gw
        one = np.asarray(slic(lab, 900, 5.0, 10))
        sp = np.stack([one, one[::-1].copy()])
    dev = np.asarray(enforce_connectivity_device(jnp.asarray(sp), n_sp))
    for i in range(2):
        gold = enforce_connectivity_golden(sp[i], n_sp=n_sp)
        assert (dev[i] == gold).all(), f"{kind} image {i}"
