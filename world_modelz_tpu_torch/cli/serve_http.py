"""Serve a trained video-diffusion checkpoint, or an exported artifact,
over HTTP.

Port of ``world_modelz_tpu.cli.serve_http``: restores the denoiser and its
tokenizer from a checkpoint of the denoiser trainer (f32, eval mode, as
the rollout CLI restores them), or loads an artifact of
``cli.export_rollout`` (``--exported``: the programs captured as CUDA
graphs on the GPU, no checkpoint needed), builds the batched
``RolloutService`` (request coalescing, size ladder, streaming sessions)
and exposes it through the stdlib HTTP front end (``serve_http.py``).

    python -m world_modelz_tpu_torch.cli.serve_http \\
        --checkpoint outputs/video_diffusion/step_0075000 --port 8000
    python -m world_modelz_tpu_torch.cli.serve_http --exported artifacts/m3_serve

    # client (either package's):
    from world_modelz_tpu_torch.serve_http import http_generate
    video = http_generate("http://127.0.0.1:8000", seed_clip)

``--platform ""`` (the default) serves on the GPU and raises without
one; ``--platform cpu`` serves on the CPU.
"""

from __future__ import annotations

import dataclasses
import os

from world_modelz_tpu_torch._device import platform_device
from world_modelz_tpu_torch.utils.config import dataclass_cli


@dataclasses.dataclass
class ServeHTTPConfig:
    checkpoint: str = ""  # video-diffusion checkpoint (this or --exported)
    # artifact dir (cli/export_rollout.py): serve without the checkpoint;
    # num_frames/iterations/topk come from the artifact and the related
    # flags below are ignored
    exported: str = ""
    platform: str = ""  # "" = the GPU (raises without one), "cpu"
    use_ema: bool = False
    host: str = "127.0.0.1"
    port: int = 8000
    # bearer auth for every route but /healthz (or WMZ_SERVE_TOKEN).
    # Tokens ride plaintext HTTP: front with a TLS-terminating proxy
    # before binding beyond localhost.
    auth_token: str = ""
    num_frames: int = 8  # generated frames per request
    num_iterations: int = 30  # unmask iterations per frame (main2.py:81)
    topk: int = -1
    # "fast" (10 iterations, topk 25) or "reference" (30, -1); see
    # cli/rollout.py SAMPLER_PRESETS. Empty = the explicit flags above.
    preset: str = ""
    batch_size: int = 8  # max coalesced batch (power-of-two ladder below)
    max_wait_s: float = 0.05
    # serve lone requests at once when the arrival rate cannot fill a
    # batch within max_wait_s anyway (serve.py adaptive_wait)
    adaptive_wait: bool = False
    manual_seed: int = 0


def build_service(cfg: ServeHTTPConfig):
    """Checkpoint or artifact -> (ready RolloutService, the checkpoint's
    step or ``"aot:<dir>"``)."""
    from world_modelz_tpu_torch.serve import RolloutService

    # resolve the preset before the artifact branch: an exported program's
    # sampler settings are frozen at export, so --preset with --exported
    # would be silently ignored
    if cfg.preset:
        from world_modelz_tpu_torch.cli.rollout import SAMPLER_PRESETS

        if cfg.preset not in SAMPLER_PRESETS:
            raise SystemExit(
                f"unknown --preset {cfg.preset!r}; "
                f"choose from {sorted(SAMPLER_PRESETS)}"
            )
        if cfg.exported:
            raise SystemExit(
                "--preset cannot be applied to --exported: the artifact "
                "keeps the iterations it was exported with. Re-export with "
                "the preset's settings, or serve from --checkpoint."
            )
        p = SAMPLER_PRESETS[cfg.preset]
        cfg = dataclasses.replace(
            cfg, num_iterations=p["num_eval_iterations"], topk=p["topk"])
        print(f"sampler preset {cfg.preset}: {cfg.num_iterations} "
              f"iterations, topk {cfg.topk}")

    device = platform_device(cfg.platform)
    common = dict(batch_size=cfg.batch_size, max_wait_s=cfg.max_wait_s,
                  adaptive_wait=cfg.adaptive_wait, seed=cfg.manual_seed)
    if cfg.exported:
        from world_modelz_tpu_torch.aot import AOTPrograms

        progs = AOTPrograms.load(cfg.exported, device)
        return RolloutService(programs=progs, **common), f"aot:{cfg.exported}"
    from world_modelz_tpu_torch.cli.export_rollout import restore_denoiser

    tok, model, _, step = restore_denoiser(cfg.checkpoint, cfg.use_ema, device)
    svc = RolloutService(
        tok, model, num_frames=cfg.num_frames,
        num_iterations=cfg.num_iterations, sample_topk=cfg.topk,
        device=device, **common)
    return svc, step


def run(cfg: ServeHTTPConfig):
    from world_modelz_tpu_torch.serve_http import RolloutHTTPServer

    if not cfg.checkpoint and not cfg.exported:
        raise ValueError(
            "--checkpoint (video-diffusion run) or --exported (artifact) is "
            "required"
        )
    svc, step = build_service(cfg)
    token = cfg.auth_token or os.environ.get("WMZ_SERVE_TOKEN", "")
    server = RolloutHTTPServer(svc, host=cfg.host, port=cfg.port, auth_token=token)
    print(
        f"serving step-{step} checkpoint on http://{cfg.host}:{server.port} "
        f"(batch<= {svc._batch_size}, {svc.num_frames} frames/request, "
        f"device {svc._device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        svc.close()


def main(argv=None):
    run(dataclass_cli(ServeHTTPConfig, argv))


if __name__ == "__main__":
    main()
