"""The package's former import name, kept as an alias.

Importing any module under this name gives the module of the same dotted
path under ``gabor_color_image_segmentation``: the same object, not a copy,
so classes, jit caches and module state are shared by both names.
"""

import importlib
import importlib.abc
import importlib.util
import sys

_TARGET = "gabor_color_image_segmentation"


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if not name.startswith(__name__ + "."):
            return None
        real = importlib.import_module(_TARGET + name[len(__name__):])
        spec = importlib.util.spec_from_loader(name, self)
        spec.loader_state = real
        return spec

    def create_module(self, spec):
        real = spec.loader_state
        spec.loader_state = real.__spec__  # the import system resets __spec__
        return real

    def exec_module(self, module):
        module.__spec__ = module.__spec__.loader_state


sys.meta_path.insert(0, _Alias())
sys.modules[__name__] = importlib.import_module(_TARGET)
