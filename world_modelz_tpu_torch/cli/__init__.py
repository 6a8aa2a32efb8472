"""Command-line entry points mirroring the JAX package's ``cli``.

Each module exposes a config dataclass, a ``train(cfg)`` function and a
``main(argv)`` CLI wrapper. Ported: ``video_diffusion`` (the denoiser
trainer), ``train_vqae`` (the tokenizer trainer) and ``sparse_diffusion``
(the sparse space-time trainer with its evaluation).
"""
