"""A Grain-backed input pipeline: deterministic, checkpointable batches.

Port of ``world_modelz_tpu.data.grain_pipeline``. ``GrainClipPipeline``
streams the records of any random-access dataset (``__len__`` +
``__getitem__``: ``MovingMNIST``, ``TrajectoryClipDataset``,
``FileListImageDataset``) through a Grain ``DataLoader`` (``grain`` is
imported when a pipeline is made):

- the ``IndexSampler`` derives every record index from (seed, position), so
  one seed gives one record stream, whatever the worker count;
- ``get_state``/``set_state`` round-trip the iterator's position (JSON
  bytes), which the trainers keep beside each checkpoint
  (``grain_state.json``) and restore on ``--checkpoint``;
- ``shard_index``/``shard_count`` give each host a disjoint record slice;
- ``worker_count`` > 0 decodes in Grain worker processes.

Iteration is by record and ``sample_batch(n)`` stacks ``n`` of them, so a
trainer draws training and evaluation batches of other sizes from one
stream and the position stays exact.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class GrainClipPipeline:
    """Deterministic batch stream over a random-access dataset.

    Args:
      dataset: random-access source (``__len__``/``__getitem__``) of numpy
        arrays of one shape.
      batch_size: the default batch size of ``sample_batch``.
      seed: the sampler's seed; with ``shuffle`` it fixes every epoch's
        permutation.
      shuffle: a seeded order reshuffled every epoch, else sequential.
      num_epochs: None streams forever.
      shard_index, shard_count: this host's slice of the records.
      worker_count: Grain worker processes (0: in this process).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        seed: int = 0,
        shuffle: bool = True,
        num_epochs: Optional[int] = None,
        shard_index: int = 0,
        shard_count: int = 1,
        worker_count: int = 0,
    ):
        import grain

        self.batch_size = batch_size
        shard = grain.sharding.ShardOptions(
            shard_index=shard_index, shard_count=shard_count, drop_remainder=True)
        sampler = grain.samplers.IndexSampler(
            num_records=len(dataset), shard_options=shard, shuffle=shuffle,
            num_epochs=num_epochs, seed=seed)
        self._loader = grain.DataLoader(
            data_source=dataset, sampler=sampler, worker_count=worker_count)
        self._it = iter(self._loader)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self.sample_batch(self.batch_size)

    def sample_batch(self, batch_size: Optional[int] = None) -> np.ndarray:
        """The next ``batch_size`` (default: the pipeline's) records,
        stacked."""
        n = self.batch_size if batch_size is None else batch_size
        return np.stack([next(self._it) for _ in range(n)], axis=0)

    def get_state(self) -> bytes:
        return self._it.get_state()

    def set_state(self, state: bytes) -> None:
        self._it.set_state(state)

    def close(self) -> None:
        """Drop the iterator (and with it any worker processes)."""
        it, self._it = self._it, iter(())
        del it
