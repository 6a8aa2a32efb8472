"""Metric logging to a JSONL file (port of
``world_modelz_tpu.utils.logging.MetricLogger``'s JSONL sink).

Records are appended to ``{output_dir}/{name}_metrics.jsonl`` and flushed:
- ``log``: ``{"step", "t", <metrics>}``;
- ``log_histogram``: ``{"step", "t", "histogram", "counts", "edges"}``, the
  ``np.histogram`` of the values (edges rounded to 6 places);
- ``log_image``: the image as a PNG under ``images/{key}_{step:07d}.png``
  beside the metrics file, and ``{"step", "t", "image", "path"}`` with its
  path relative to that file.

With ``use_wandb`` the scalar metrics also go to wandb, as the JAX
logger sends them; without the ``wandb`` package it warns and logs to the
JSONL file only, as the JAX logger does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from world_modelz_tpu_torch.utils.image import save_image


class MetricLogger:
    def __init__(
        self,
        output_dir: str,
        name: str,
        use_wandb: bool = False,
        project: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        tags: Optional[str] = None,
    ):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{name}_metrics.jsonl")
        self._file = open(self.path, "a")
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(
                    project=project or name,
                    config=config or {},
                    tags=(tags or "").split(",") if tags else [],
                    name=name,
                )
                self._wandb = wandb
            except ImportError:
                print("wandb requested but not installed; logging to JSONL only")

    def _write(self, step: int, **fields: Any) -> None:
        record = {"step": step, "t": round(time.time() - self._t0, 3), **fields}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def log(self, step: int, **metrics: Any) -> None:
        record = {}
        for k, v in metrics.items():
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, (np.floating, np.integer)):
                v = v.item()
            record[k] = v
        self._write(step, **record)
        if self._wandb is not None:
            self._wandb.log(record, step=step)

    def log_histogram(
        self, step: int, key: str, values: Any, bins: int = 64
    ) -> None:
        """The (counts, edges) of ``np.histogram(values, bins)``, as the
        JAX logger's JSONL record (the reference logs the sampler weights'
        histogram, minecraft/main2.py:298-300)."""
        if hasattr(values, "detach"):
            values = values.detach().cpu().numpy()
        counts, edges = np.histogram(np.asarray(values).reshape(-1), bins=bins)
        self._write(step, histogram=key, counts=counts.tolist(),
                    edges=np.round(edges, 6).tolist())

    def log_image(self, step: int, key: str, image: np.ndarray) -> None:
        """Write ``image`` (float [0, 1], HWC or NHWC) as a PNG beside the
        metrics file and record its relative path (main2.py:334-338)."""
        root = os.path.dirname(self.path)
        out_dir = os.path.join(root, "images")
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{key}_{step:07d}.png")
        save_image(np.asarray(image), fn)
        self._write(step, image=key, path=os.path.relpath(fn, root))

    def close(self) -> None:
        self._file.close()


class NullLogger:
    """A ``MetricLogger`` that writes nothing: the logger of every rank but
    rank 0 in a data-parallel run."""

    path = None

    def log(self, step: int, **metrics: Any) -> None:
        pass

    def log_histogram(self, step: int, key: str, values: Any, **kw: Any) -> None:
        pass

    def log_image(self, step: int, key: str, image: np.ndarray) -> None:
        pass

    def close(self) -> None:
        pass


def rank_logger(rank: int, *args: Any, **kwargs: Any):
    """``MetricLogger(*args, **kwargs)`` on rank 0, a ``NullLogger`` on the
    others."""
    return MetricLogger(*args, **kwargs) if rank == 0 else NullLogger()
