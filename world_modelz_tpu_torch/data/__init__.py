"""Host-side input pipelines: the procedural MovingMNIST and synthetic
trajectory sources, the buffered trajectory-clip sampler and the
prefetching device feeder."""

from world_modelz_tpu_torch.data.moving_mnist import MovingMNIST
from world_modelz_tpu_torch.data.prefetch import PrefetchIterator
from world_modelz_tpu_torch.data.trajectory import (
    BufferedTrajectorySampler,
    SyntheticTrajectorySource,
)

__all__ = [
    "MovingMNIST",
    "PrefetchIterator",
    "SyntheticTrajectorySource",
    "BufferedTrajectorySampler",
]
