"""BSDS500 loader round-trip on a synthesized on-disk layout (C1)."""

import json
import os

import numpy as np
import pytest


@pytest.fixture()
def fake_bsds(tmp_path):
    import cv2
    from scipy.io import savemat

    root = tmp_path / "BSDS500"
    for split in ("train", "val", "test"):
        (root / "images" / split).mkdir(parents=True)
        (root / "groundTruth" / split).mkdir(parents=True)

    rng = np.random.default_rng(0)

    def write(split, image_id, h, w):
        rgb = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        cv2.imwrite(
            str(root / "images" / split / f"{image_id}.jpg"),
            cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
        )
        # BSDS groundTruth: 1x n cell array of structs with 'Segmentation'
        segs = [
            {"Segmentation": rng.integers(1, 6, (h, w)).astype(np.uint16)}
            for _ in range(3)
        ]
        gt = np.zeros((1, len(segs)), dtype=object)
        for i, s in enumerate(segs):
            gt[0, i] = s
        savemat(str(root / "groundTruth" / split / f"{image_id}.mat"),
                {"groundTruth": gt})

    write("test", "100007", 321, 481)  # landscape
    write("test", "100039", 481, 321)  # portrait (loader must transpose)
    return str(root)


def test_loader_roundtrip(fake_bsds):
    from gabor_color_image_segmentation.data.bsds import BSDS500, bsds_available

    assert bsds_available(fake_bsds)
    ds = BSDS500(fake_bsds)
    ids = ds.ids("test")
    assert ids == ["100007", "100039"]
    for image_id in ids:
        rgb, gts = ds.load("test", image_id)
        assert rgb.shape == (321, 481, 3)  # portrait transposed to landscape
        assert len(gts) == 3
        for g in gts:
            assert g.shape == (321, 481)
            assert g.min() == 0  # 1-based -> 0-based


def test_eval_on_fake_bsds(fake_bsds, monkeypatch, tmp_path):
    monkeypatch.setenv("BSDS500_ROOT", fake_bsds)
    from gabor_color_image_segmentation.config import preset
    from gabor_color_image_segmentation.eval import evaluate, load_split

    data = load_split("test")
    assert len(data) == 2
    cfg = preset("config0").replace(batch_size=2)
    summary = evaluate(data, cfg, out_path=str(tmp_path / "out.jsonl"))
    assert summary["n_images"] == 2
    assert summary["n_failed"] == 0
    assert summary["mean_pri"] is not None


def test_plot_metrics(tmp_path):
    from gabor_color_image_segmentation.utils.visualize import plot_metrics

    p = tmp_path / "rows.jsonl"
    with open(p, "w") as f:
        for i in range(10):
            f.write(json.dumps({"pri": 0.7 + 0.01 * i, "f_boundary": 0.5}) + "\n")
    out = tmp_path / "hist.png"
    plot_metrics(str(p), str(out))
    assert os.path.getsize(out) > 1000
