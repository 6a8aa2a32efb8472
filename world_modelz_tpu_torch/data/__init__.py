"""Host-side input pipelines: the procedural MovingMNIST and synthetic
trajectory sources and the prefetching device feeder."""

from world_modelz_tpu_torch.data.moving_mnist import MovingMNIST
from world_modelz_tpu_torch.data.prefetch import PrefetchIterator
from world_modelz_tpu_torch.data.trajectory import SyntheticTrajectorySource

__all__ = ["MovingMNIST", "PrefetchIterator", "SyntheticTrajectorySource"]
