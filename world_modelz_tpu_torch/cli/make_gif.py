"""Assemble frame PNGs into an animated GIF.

Port of ``world_modelz_tpu.cli.make_gif`` (reference:
vq-video-diffusion/make_gif.sh:3, ImageMagick's ``convert -delay 20 -loop
0 frame_*.png out.gif``): the PNGs matching ``--pattern``, in sorted
order, are read as RGB (``utils.image.read_png``: 8-bit grayscale, RGB or
RGBA) and written by ``utils.image.save_gif``, dithered onto the web
palette as the JAX CLI's PIL does.

    python -m world_modelz_tpu_torch.cli.make_gif --pattern 'out/rollout_frame_*.png' \\
        --output out/rollout.gif
"""

from __future__ import annotations

import dataclasses
import glob

import numpy as np

from world_modelz_tpu_torch.utils.config import dataclass_cli
from world_modelz_tpu_torch.utils.image import read_png, save_gif


@dataclasses.dataclass
class MakeGifConfig:
    pattern: str = "frame_*.png"
    output: str = "out.gif"
    fps: float = 5.0  # make_gif.sh uses -delay 20 (1/100ths) = 5 fps


def run(cfg: MakeGifConfig) -> str:
    files = sorted(glob.glob(cfg.pattern))
    if not files:
        raise FileNotFoundError(f"no frames match {cfg.pattern!r}")
    frames = []
    for f in files:
        img = read_png(f)
        rgb = np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img[..., :3]
        frames.append(rgb.astype(np.float32) / 255.0)
    save_gif(frames, cfg.output, fps=cfg.fps)
    print(f"{cfg.output}: {len(frames)} frames")
    return cfg.output


def main(argv=None):
    run(dataclass_cli(MakeGifConfig, argv))


if __name__ == "__main__":
    main()
