"""Command-line entry points mirroring the JAX package's ``cli``.

Each module exposes a config dataclass, a ``train(cfg)`` (or ``run(cfg)``)
function and a ``main(argv)`` CLI wrapper. Ported: ``video_diffusion``
(the denoiser trainer with its evaluation), ``train_vqae`` (the tokenizer
trainer), ``sparse_diffusion`` (the sparse space-time trainer with its
evaluation), ``rollout`` (checkpoint -> frames, GIF, FVD, PSNR/SSIM),
``make_gif`` (PNGs -> GIF), ``export_rollout`` (checkpoint -> serving
artifact), ``serve_http`` (a checkpoint or an artifact behind the HTTP
front end), ``sample_frames`` (trajectories -> PNG directories and a file
list) and the reference-checkpoint importers ``import_torch_vqae`` and
``import_torch_video``.
"""
