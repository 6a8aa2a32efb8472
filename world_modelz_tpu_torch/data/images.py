"""Frame-image dataset: a cached recursive file scan and robust decoding.

Port of ``world_modelz_tpu.data.images`` (reference: ``load_file_list`` /
``FileListImageDataset``, minecraft/train_vqae.py:105-150), the tokenizer
trainer's ``files`` dataset: glob a directory tree, filter by a regex, cache
the list as JSON, decode images (with PIL, imported when an image is read)
to float32 RGB in [0, 1], and pass over files that do not decode.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Callable, List, Optional, Sequence

import numpy as np


def load_file_list(manifest_path: str, directory_glob: str,
                   pattern: str = r".*\.png$") -> List[str]:
    """The files under ``directory_glob`` (recursive) whose paths match
    ``pattern`` (case-insensitive), as absolute paths; read from the JSON
    list at ``manifest_path`` when it holds one, else written there
    (train_vqae.py:105-130)."""
    if os.path.isfile(manifest_path):
        with open(manifest_path) as f:
            cached = json.load(f)
        if cached:
            return cached
    rx = re.compile(pattern, flags=re.IGNORECASE)
    files = [os.path.abspath(fn) for fn in glob.iglob(directory_glob, recursive=True)
             if os.path.isfile(fn) and rx.match(fn)]
    if not files:
        raise RuntimeError(f"No files matching {pattern!r} under {directory_glob!r}")
    os.makedirs(os.path.dirname(manifest_path) or ".", exist_ok=True)
    with open(manifest_path, "w") as f:
        json.dump(files, f)
    return files


def _decode_image(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) float32 in [0, 1], or None when the file does not decode
    (train_vqae.py:142-150)."""
    try:
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), np.float32) / 255.0
    except Exception:
        return None


class FileListImageDataset:
    """Batches of decoded images from a file list, shuffled each epoch by
    ``default_rng(seed)``; an undecodable file is replaced by the next draw
    (``next_batch``) or the next index (``__getitem__``), so batches keep
    their shape. Its ``repr`` names the list and the seed and no object
    address: Grain checks it when it restores a state (the JAX class's
    default ``repr`` differs in every process, so its Grain runs over files
    cannot resume)."""

    def __init__(
        self,
        file_names: Sequence[str],
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        self.file_names = list(file_names)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.transform = transform
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(len(self.file_names))
        self._cursor = len(self.file_names)  # the first draw shuffles
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.file_names)

    def __repr__(self) -> str:
        return (f"FileListImageDataset(n={len(self.file_names)}, "
                f"first={self.file_names[0] if self.file_names else None!r}, "
                f"seed={self.seed}, shuffle={self.shuffle})")

    def _decoded(self, path: str) -> Optional[np.ndarray]:
        img = _decode_image(path)
        if img is not None and self.transform is not None:
            img = self.transform(img)
        return img

    def __getitem__(self, i: int) -> np.ndarray:
        """Record ``i`` (the random-access protocol of
        ``data/grain_pipeline.py``): the first file from index ``i`` on that
        decodes."""
        n = len(self.file_names)
        for k in range(n):
            img = self._decoded(self.file_names[(i + k) % n])
            if img is not None:
                return img
        raise RuntimeError("no decodable images in the file list")

    def _next_index(self) -> int:
        if self._cursor >= len(self._order):
            if self.shuffle:
                self._rng.shuffle(self._order)
            self._cursor = 0
            self.epoch += 1
        idx = int(self._order[self._cursor])
        self._cursor += 1
        return idx

    def next_batch(self) -> np.ndarray:
        """(B, H, W, 3) float32 of the next ``batch_size`` files that
        decode."""
        out: List[np.ndarray] = []
        while len(out) < self.batch_size:
            img = self._decoded(self.file_names[self._next_index()])
            if img is not None:
                out.append(img)
        return np.stack(out)
