"""Checkpoints with the reference's embedded-config contract.

Port of ``world_modelz_tpu.train.checkpoint`` in the port's own format: a
checkpoint is the directory ``{directory}/step_{step:07d}/`` holding
``state.pt`` (``torch.save`` of any nest of dicts, lists and tensors) and
``wmz_config.json`` (``{"step", "config"}``), written last, beside any extra
files (name -> bytes, e.g. a Grain pipeline's ``grain_state.json``). The
config file is the completeness marker: ``latest_checkpoint`` lists only
directories where it landed, so a complete checkpoint has its extra files. Reading the JAX package's orbax checkpoints waits for the
orbax -> numpy export tool.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import torch

STATE_FILE = "state.pt"
CONFIG_FILE = "wmz_config.json"


def _map_tensors(tree: Any, fn) -> Any:
    """``fn`` applied to every tensor of a nest of dicts, lists, tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree.detach())
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def save_checkpoint(
    directory: str,
    step: int,
    state: Any,
    config: Optional[Dict[str, Any]] = None,
    extra_files: Optional[Dict[str, bytes]] = None,
) -> str:
    """Write ``state`` + ``config`` (and ``extra_files``, name -> bytes)
    under ``directory/step_XXXXXXX``; tensors are written from host copies.
    Returns the path."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step:07d}")
    os.makedirs(path, exist_ok=True)
    marker = os.path.join(path, CONFIG_FILE)
    if os.path.exists(marker):
        os.remove(marker)  # an overwrite is incomplete until it lands again
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_map_tensors(state, torch.Tensor.cpu), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    for name, payload in (extra_files or {}).items():
        with open(os.path.join(path, name), "wb") as f:
            f.write(payload)
    with open(marker + ".tmp", "w") as f:
        json.dump({"step": step, "config": config or {}}, f, indent=2)
    os.replace(marker + ".tmp", marker)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest COMPLETE checkpoint under ``directory`` (or None): one whose
    ``wmz_config.json`` landed."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        d
        for d in os.listdir(directory)
        if d.startswith("step_")
        and os.path.isfile(os.path.join(directory, d, CONFIG_FILE))
    )
    return os.path.join(directory, steps[-1]) if steps else None


def restore_checkpoint(
    path: str, map_location: Any = "cpu"
) -> Tuple[Any, int, Dict[str, Any]]:
    """(state, step, config) of the checkpoint at ``path``; tensors are
    loaded to ``map_location``."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, CONFIG_FILE)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(
            f"{path} is not a complete checkpoint (no {CONFIG_FILE})")
    state = torch.load(
        os.path.join(path, STATE_FILE), map_location=map_location,
        weights_only=True,
    )
    with open(meta_path) as f:
        meta = json.load(f)
    return state, meta.get("step", 0), meta.get("config", {})


class AsyncCheckpointSaver:
    """Overlap checkpoint writes with training.

    ``save`` snapshots the state into fresh device buffers (the trainer
    updates its tensors in place, so the live ones must not be read later)
    and runs the host copy and the write on a background thread. At most
    one save is in flight: a new ``save()`` (and ``wait()``) joins the
    previous one first and re-raises any error it hit. Call ``wait()``
    before reading ``latest_checkpoint`` and on exit.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(
        self,
        directory: str,
        step: int,
        state: Any,
        config: Optional[Dict[str, Any]] = None,
        extra_files: Optional[Dict[str, bytes]] = None,
    ) -> str:
        self.wait()
        snapshot = _map_tensors(state, torch.Tensor.clone)  # same device
        path = os.path.join(os.path.abspath(directory), f"step_{step:07d}")

        def _write():
            try:
                save_checkpoint(directory, step, snapshot, config, extra_files)
            except Exception as e:  # surfaces on the next save/wait
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        return path


GRAIN_STATE_FILE = "grain_state.json"


def pipeline_files(state: Optional[bytes]) -> Optional[Dict[str, bytes]]:
    """The extra files of a checkpoint for an input pipeline's consumed
    position (``PrefetchIterator.consumed_state()``; None without one)."""
    return {GRAIN_STATE_FILE: state} if state is not None else None


def restore_pipeline(pipeline: Any, checkpoint: str) -> bool:
    """Put a checkpointable pipeline (one with ``set_state``) back to the
    position the checkpoint at ``checkpoint`` recorded, when it recorded
    one; returns whether it did."""
    path = os.path.join(checkpoint, GRAIN_STATE_FILE)
    if not (hasattr(pipeline, "set_state") and os.path.exists(path)):
        return False
    with open(path, "rb") as f:
        pipeline.set_state(f.read())
    print("input pipeline resumed from", path)
    return True
