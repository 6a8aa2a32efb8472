"""Metric logging to a JSONL file (port of
``world_modelz_tpu.utils.logging.MetricLogger``: ``log`` and ``close``).

One record per ``log`` call, ``{"step", "t", <metrics>}``, appended to
``{output_dir}/{name}_metrics.jsonl`` and flushed. wandb, histograms and
image records are not ported (ROADMAP A.8): ``use_wandb=True`` raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


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
        if use_wandb:
            raise NotImplementedError(
                "wandb logging is not ported to world_modelz_tpu_torch yet "
                "(ROADMAP A.8)")
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{name}_metrics.jsonl")
        self._file = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, **metrics: Any) -> None:
        record = {"step": step, "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, (np.floating, np.integer)):
                v = v.item()
            record[k] = v
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()
