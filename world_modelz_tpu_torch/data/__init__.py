"""Host-side input pipelines: the procedural MovingMNIST source and the
prefetching device feeder."""

from world_modelz_tpu_torch.data.moving_mnist import MovingMNIST
from world_modelz_tpu_torch.data.prefetch import PrefetchIterator

__all__ = ["MovingMNIST", "PrefetchIterator"]
