"""world_modelz_tpu_torch — the PyTorch/CUDA port of world_modelz_tpu.

Five paths run here. Serving: tokenizer encode (conv encoder +
nearest-code search) -> iterative-unmask rollout over the
local-3D-attention denoiser -> tokenizer decode, from the modules or from
an exported artifact whose programs replay as CUDA graphs, behind an HTTP
front end. Training: the
masked-diffusion trainer (``cli.video_diffusion``) over frozen-tokenizer
clips (MovingMNIST, shipped as pixels or as sprite trajectories composited
inside the step, synthetic trajectories, video files; native sources or a
Grain stream), with the attention's backward kernels. Tokenizer
training: the VQ-VAE trainer (``cli.train_vqae``), with the fused VQ
search + EMA statistics kernel. Sparse space-time diffusion: the trainer
``cli.sparse_diffusion`` (a dense transformer over token subsets of
synthetic trajectory volumes, with the flash-attention kernels) and its
chunked volume sweep. Evaluation: the rollout CLI (``cli.rollout``) from a
trained checkpoint to frames, GIFs, FVD and PSNR/SSIM, and the denoiser
trainer's periodic evaluation. The sparse trainer also takes
mixture-of-experts FFNs (``parallel.moe``) and external tokenizers
(``models.external``). SOM-DDPM: the five stages of ``cli.som_pipeline``
(the SOM autoencoder, the SOM fit, the finetune, the latent dataset, the
UNet DDPM). Layouts at public functions follow the
JAX package: NHWC images in [0, 1], (B, S, H, W) token grids,
(B, S, H, W, heads * dh) attention operands.

Every kernel of those paths is hand-written CUDA for Hopper (``csrc/``), built
with ``nvcc`` on first use (``kernels/_build.py``) and bound through ctypes.
A kernel wrapper launches its kernel for a CUDA tensor and takes the plain
PyTorch version only for a CPU tensor.

Entry points take ``device=None``, which means ``"cuda"``; pass
``device="cpu"`` to run on the CPU.

Subpackages
-----------
ops        vector quantization (lookups, the EMA training forward,
           dead-code revival, the kernels' plain versions), the SOM
kernels    CUDA kernel wrappers, the attentions' autograd Functions, launch
           counters, the nvcc build
models     tokenizer convs, local-3D and dense attention transformers
           (mixture-of-experts FFNs), the two denoisers, external
           tokenizers, the SOM autoencoder, the UNet
parallel   the mixture-of-experts FFN (one device)
diffusion  corruption, iterative-unmask sampler and multi-frame rollout;
           sparse position samplers and the volume sweep; the DDPM
serve      batched rollout service (request coalescing, sessions)
serve_http the stdlib HTTP front end and its client
aot        serving artifacts: export, and the programs as CUDA graphs
train      optimizer, schedules, EMA, loss-aware sampler, guard, checkpoints
data       MovingMNIST, synthetic trajectories, video and image files, the
           clip samplers, the compiled host compositor (``data.native``),
           on-device compositing, the Grain pipeline, the prefetching
           device feeder
cli        the trainers (``python -m ...cli.video_diffusion``,
           ``python -m ...cli.train_vqae``,
           ``python -m ...cli.sparse_diffusion``), the rollout
           (``...cli.rollout``), ``...cli.make_gif``, serving:
           ``...cli.export_rollout``, ``...cli.serve_http``, and tools:
           ``...cli.sample_frames``, ``...cli.import_torch_vqae``,
           ``...cli.import_torch_video``, ``...cli.import_torch_sparse``;
           the SOM-DDPM stages (``...cli.som_pipeline <stage>``)
utils      dataclass CLI configs, image grids, PNGs and GIFs, the JSONL
           logger, PSNR/SSIM, the FVD harness, FLOP counts, profiling
convert    weight bridge from the JAX package's numpy parameter trees
"""

__version__ = "0.1.0"
