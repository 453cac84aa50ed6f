"""Offline RL dataset I/O.

The port's own copy of ``ray_tpu/rllib/offline.py`` (numpy only; the port
imports nothing of ``ray_tpu``): the same files, the same shuffle order and
the same ``next`` draws from ``np.random.RandomState(seed)``, so each
package reads the other's files to equal batches.

Reference parity: rllib/offline/ (JsonWriter json_writer.py, JsonReader
json_reader.py — the newline-delimited-JSON experience format used for
offline training and off-policy evaluation). Arrays serialize as nested
lists; a SampleBatch per line.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterator, Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch, concat_samples


class JsonWriter:
    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.max_file_size = max_file_size
        self._index = 0
        self._fh = None
        self._bytes = 0

    def _rotate(self):
        if self._fh is not None:
            self._fh.close()
        name = os.path.join(self.path, f"output-{self._index:05d}.json")
        self._index += 1
        self._fh = open(name, "w")
        self._bytes = 0

    def write(self, batch: SampleBatch):
        if self._fh is None or self._bytes > self.max_file_size:
            self._rotate()
        rec = {k: np.asarray(v).tolist() for k, v in batch.items()}
        line = json.dumps(rec) + "\n"
        self._fh.write(line)
        self._bytes += len(line)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class JsonReader:
    def __init__(self, path: str, shuffle: bool = True,
                 seed: Optional[int] = None):
        if os.path.isdir(path):
            self.files = sorted(glob.glob(os.path.join(path, "*.json")))
        else:
            self.files = sorted(glob.glob(path))
        if not self.files:
            raise FileNotFoundError(f"no offline data under {path!r}")
        self._rng = np.random.RandomState(seed)
        self.shuffle = shuffle

    def read_all(self) -> SampleBatch:
        return concat_samples(list(self.iter_batches()))

    def iter_batches(self) -> Iterator[SampleBatch]:
        files = list(self.files)
        if self.shuffle:
            self._rng.shuffle(files)
        for f in files:
            with open(f) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    yield SampleBatch({k: np.asarray(v)
                                       for k, v in rec.items()})

    def next(self) -> SampleBatch:
        """One uniformly random stored batch (reference: JsonReader.next)."""
        f = self.files[self._rng.randint(len(self.files))]
        with open(f) as fh:
            lines = [ln for ln in fh if ln.strip()]
        rec = json.loads(lines[self._rng.randint(len(lines))])
        return SampleBatch({k: np.asarray(v) for k, v in rec.items()})
