"""Every alias package at the repository root (a former import name)
resolves to the modules of ``gabor_color_image_segmentation`` themselves."""

import importlib
import pathlib

import pytest

import gabor_color_image_segmentation as pkg

ROOT = pathlib.Path(pkg.__file__).resolve().parents[1]
ALIASES = sorted(
    d.name for d in ROOT.iterdir()
    if d.name.startswith(pkg.__name__ + "_") and (d / "__init__.py").exists()
)


def test_there_is_an_alias():
    assert ALIASES


@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize(
    "sub", ["", ".config", ".models.pipeline", ".parallel.sharding"]
)
def test_alias_is_the_same_module(alias, sub):
    old = importlib.import_module(alias + sub)
    new = importlib.import_module(pkg.__name__ + sub)
    assert old is new
    assert new.__spec__.name == new.__name__


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_from_import(alias):
    cfg = importlib.import_module(alias + ".config").preset("config0")
    from gabor_color_image_segmentation.config import PipelineConfig

    assert isinstance(cfg, PipelineConfig)
