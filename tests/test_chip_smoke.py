"""chip_smoke.py refuses to run without a GPU, and its last line has the
agreed format. (The script itself runs on the card.)"""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_no_gpu_exits_nonzero_in_process(argv, capsys):
    assert chip_smoke.main(argv) != 0
    assert capsys.readouterr().out == ""


def _run(script_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(script_dir, "chip_smoke.py")],
        cwd=script_dir, env=env, capture_output=True, text=True, timeout=300,
    )


def test_no_gpu_exits_nonzero_from_the_repo():
    proc = _run(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")] * count
    line = chip_smoke.result_line(devs)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": count},
    }
