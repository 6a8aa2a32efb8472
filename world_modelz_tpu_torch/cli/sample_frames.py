"""Frame export: write trajectory frames as per-trajectory PNG directories.

Port of ``world_modelz_tpu.cli.sample_frames`` (reference:
minecraft/sample_frames.py:178-240): walk the source's trajectories, keep a
frame and then skip a random ``skip_frames_min``..``skip_frames_max``
frames (drawn from ``default_rng(manual_seed)``), save each kept frame as
``<output_dir>/<trajectory>/<count:06d>.png``, and write the manifest
(``file_list_fn``, a JSON list of absolute paths) that ``data.images.
load_file_list`` and so the tokenizer trainer's ``--dataset files`` read. A
trajectory that fails to decode is reported and passed over
(sample_frames.py:231-235). ``--dataset minerl`` raises: the ``minerl``
package and its data are absent (ROADMAP A.8).

    python -m world_modelz_tpu_torch.cli.sample_frames --output_dir outputs/frames
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np

from world_modelz_tpu_torch.data import SyntheticTrajectorySource
from world_modelz_tpu_torch.utils.config import dataclass_cli, unported
from world_modelz_tpu_torch.utils.image import save_image


@dataclasses.dataclass
class SampleFramesConfig:
    dataset: str = "synthetic"  # synthetic (minerl raises)
    output_dir: str = "outputs/frames"
    skip_frames_min: int = 2
    skip_frames_max: int = 5
    max_trajectories: int = 0  # 0 = all
    manual_seed: int = 0
    file_list_fn: str = "file_list.json"


def make_source(cfg: SampleFramesConfig):
    if cfg.dataset == "minerl":
        raise unported("--dataset minerl (the minerl package and its data)", "A.8")
    if cfg.dataset != "synthetic":
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    return SyntheticTrajectorySource()


def run(cfg: SampleFramesConfig) -> List[str]:
    """Write the frames and the manifest; returns the manifest's paths."""
    rng = np.random.default_rng(cfg.manual_seed)
    source = make_source(cfg)
    os.makedirs(cfg.output_dir, exist_ok=True)
    manifest: List[str] = []
    names = list(source.trajectory_names())
    if cfg.max_trajectories:
        names = names[: cfg.max_trajectories]
    for name in names:
        traj_dir = os.path.join(cfg.output_dir, name.replace("/", "_"))
        os.makedirs(traj_dir, exist_ok=True)
        try:
            count = skip = 0
            for frame in source.load_frames(name):
                if skip > 0:
                    skip -= 1
                    continue
                skip = int(rng.integers(cfg.skip_frames_min, cfg.skip_frames_max + 1))
                fn = os.path.join(traj_dir, f"{count:06d}.png")
                save_image(frame.astype(np.float32) / 255.0, fn)
                manifest.append(os.path.abspath(fn))
                count += 1
            print(f"{name}: {count} frames")
        except Exception as e:  # an undecodable trajectory is passed over
            print(f"{name}: FAILED ({e})")
    manifest_path = os.path.join(cfg.output_dir, cfg.file_list_fn)
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    print(f"manifest: {manifest_path} ({len(manifest)} frames)")
    return manifest


def main(argv=None):
    run(dataclass_cli(SampleFramesConfig, argv))


if __name__ == "__main__":
    main()
