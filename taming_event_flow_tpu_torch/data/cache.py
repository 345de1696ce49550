"""Preprocessed-sample cache: the port's own copy of
``taming_event_flow_tpu/data/cache.py``.

Loader outputs are cached per (source file, pass index) so repeated epochs
skip event decoding and encoding (reference ``dataloader/cache.py:9-105``),
gzip-compressed, in the JAX package's on-disk layout. h5py and PyYAML are
imported by the methods that use them.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


class CacheDataset:
    def __init__(self, config: Dict, directory: str, mode: str = "train"):
        import yaml

        # sample-schema version: bumped whenever the loader's output dict
        # changes shape or keys, so a stale cache is dropped
        self.keys = {"schema": 2}
        for key in ["path", "mode", "window", "voxel"]:
            self.keys[key] = config["data"].get(key)
        for key in ["resolution", "augment", "augment_prob"]:
            self.keys[key] = config["loader"].get(key)

        os.makedirs(directory, exist_ok=True)
        self.dir = os.path.join(directory, f"cache_{mode}")
        dict_file = os.path.join(self.dir, "dataset_keys.yml")
        if os.path.exists(self.dir):
            if os.path.isfile(dict_file):
                with open(dict_file) as f:
                    existing = yaml.safe_load(f)
                if existing != self.keys:
                    # settings changed -> invalidate the whole cache
                    for fn in os.listdir(self.dir):
                        os.remove(os.path.join(self.dir, fn))
                    self._write_keys(dict_file)
            else:
                self._write_keys(dict_file)
        else:
            os.makedirs(self.dir, exist_ok=True)
            self._write_keys(dict_file)

    def _write_keys(self, path):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.keys, f, default_flow_style=False)

    def _cache_path(self, source_filename: str) -> str:
        return os.path.join(self.dir, os.path.basename(source_filename))

    def update(self, source_filename: str, sample: Dict[str, np.ndarray]):
        """Append one sample under the next pass index."""
        import h5py

        path = self._cache_path(source_filename)
        if not os.path.isfile(path):
            f = h5py.File(path, "w")
            f.attrs["idx"] = 0
        else:
            f = h5py.File(path, "a")
            f.attrs["idx"] += 1
        try:
            for key, val in sample.items():
                f.create_dataset(
                    f"{key}/{f.attrs['idx']:09d}",
                    data=np.asarray(val, np.float32),
                    compression="gzip",
                    compression_opts=1,
                )
        finally:
            f.close()

    def load(self, source_filename: str,
             idx: int) -> Tuple[Dict[str, np.ndarray], bool]:
        import h5py

        path = self._cache_path(source_filename)
        if not os.path.isfile(path):
            return {}, False
        out: Dict[str, np.ndarray] = {}
        entry = f"{idx:09d}"
        with h5py.File(path, "r") as f:
            for key in f.keys():
                if entry in f[key]:
                    out[key] = f[f"{key}/{entry}"][:]
                else:
                    return {}, False
        return out, True
