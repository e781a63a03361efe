"""CLI + eval-harness smoke tests (SURVEY.md C19, §3.4)."""

import json
import os

import numpy as np

from gabor_color_image_segmentation.cli import main as cli_main
from gabor_color_image_segmentation.eval import evaluate, load_split
from gabor_color_image_segmentation.config import preset


def test_cli_info(capsys):
    cli_main(["info", "--preset", "config1"])
    out = json.loads(capsys.readouterr().out)
    assert out["n_kernels"] == 80
    assert out["feature_dim"] == 243


def test_cli_run_synthetic(capsys, tmp_path):
    out_png = str(tmp_path / "seg.png")
    cli_main(["run", "--preset", "config0", "--out", out_png])
    out = json.loads(capsys.readouterr().out)
    assert out["shape"] == [321, 481]
    assert os.path.exists(out_png)


def test_eval_resume(tmp_path):
    cfg = preset("config0").replace(batch_size=2, image_hw=(96, 128))
    data = load_split("val", limit=4, image_hw=(96, 128))
    out = str(tmp_path / "r.jsonl")
    s1 = evaluate(data, cfg, out_path=out, resume=True)
    assert s1["n_images"] == 4
    assert s1["mean_pri"] and s1["mean_pri"] > 0.7
    assert s1["mean_f_boundary"] is not None
    # resume skips everything
    s2 = evaluate(data, cfg, out_path=out, resume=True)
    assert s2["n_images"] == 0
    with open(out) as f:
        assert len(f.readlines()) == 4


def test_feature_cache(tmp_path):
    from gabor_color_image_segmentation.utils.cache import FeatureCache

    cache = FeatureCache(str(tmp_path / "feats.h5"))
    cfg = preset("config0")
    x = np.random.default_rng(0).random((8, 8, 39)).astype(np.float32)
    assert cache.get("img1", cfg) is None
    cache.put("img1", cfg, x)
    np.testing.assert_array_equal(cache.get("img1", cfg), x)
    # different bank -> different fingerprint -> miss
    cfg2 = preset("config1")
    assert cache.get("img1", cfg2) is None


def test_eval_sweep_ods_ois(tmp_path, tiny_mosaic):
    """ODS/OIS-style k-sweep: per-k means, best fixed k (ODS), best-per-image
    (OIS >= ODS by construction)."""
    import json

    from gabor_color_image_segmentation.config import preset
    from gabor_color_image_segmentation.eval import evaluate_sweep

    rgb, gt = tiny_mosaic
    data = [("a", rgb, [gt]), ("b", rgb[:, ::-1].copy(), [gt[:, ::-1].copy()])]
    cfg = preset("config0").replace(feature_impl="modulated")
    out = str(tmp_path / "sweep")
    s = evaluate_sweep(data, cfg, ks=[2, 3], out_path=out)
    assert s["ks"] == [2, 3]
    assert s["pri"]["ods_k"] in (2, 3)
    assert s["pri"]["ois"] >= s["pri"]["ods"] - 1e-9
    assert set(s["pri"]["per_k"]) == {2, 3}
    # per-k jsonl side effects exist
    for k in (2, 3):
        rows = [json.loads(l) for l in open(f"{out}.k{k}.jsonl")]
        assert len(rows) == 2
