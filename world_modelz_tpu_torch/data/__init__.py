"""Host-side input pipelines: the procedural MovingMNIST and synthetic
trajectory sources, video files, image files, the trajectory-clip
samplers, on-device compositing of trajectory batches, the Grain pipeline
(``data.grain_pipeline``) and the prefetching device feeder."""

from world_modelz_tpu_torch.data.device_composite import as_frames, composite_clips
from world_modelz_tpu_torch.data.images import FileListImageDataset, load_file_list
from world_modelz_tpu_torch.data.moving_mnist import MovingMNIST
from world_modelz_tpu_torch.data.prefetch import PrefetchIterator, batch_to
from world_modelz_tpu_torch.data.trajectory import (
    BufferedTrajectorySampler,
    SyncTrajectorySampler,
    SyntheticTrajectorySource,
    TrajectoryClipDataset,
    VideoFileTrajectorySource,
)

__all__ = [
    "MovingMNIST",
    "as_frames",
    "batch_to",
    "composite_clips",
    "BufferedTrajectorySampler",
    "SyncTrajectorySampler",
    "SyntheticTrajectorySource",
    "TrajectoryClipDataset",
    "VideoFileTrajectorySource",
    "FileListImageDataset",
    "load_file_list",
    "PrefetchIterator",
]
