"""HDF5 feature cache (SURVEY.md C17).

The reference family persists per-image intermediates (features) between
pipeline stages so experiments resume cheaply. The device pipeline keeps
everything in device memory within a run, so this cache only matters at experiment
boundaries: cache features once, re-cluster with different k/methods without
re-running the filter bank.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np


class FeatureCache:
    """Append-only HDF5 store keyed by (image_id, config fingerprint)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    @staticmethod
    def fingerprint(cfg) -> str:
        import dataclasses

        blob = json.dumps(dataclasses.asdict(cfg.bank), sort_keys=True) + cfg.color_space
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    def _key(self, image_id: str, fp: str) -> str:
        return f"{fp}/{image_id}"

    def get(self, image_id: str, cfg) -> Optional[np.ndarray]:
        import h5py

        if not os.path.exists(self.path):
            return None
        key = self._key(image_id, self.fingerprint(cfg))
        with h5py.File(self.path, "r") as f:
            if key in f:
                return f[key][...]
        return None

    def put(self, image_id: str, cfg, features: np.ndarray) -> None:
        import h5py

        key = self._key(image_id, self.fingerprint(cfg))
        with h5py.File(self.path, "a") as f:
            if key in f:
                del f[key]
            f.create_dataset(
                key, data=features, compression="gzip", compression_opts=1
            )
