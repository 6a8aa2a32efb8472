#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's hand-written CUDA kernels from ``world_modelz_tpu_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on
the card, checks the full-width denoiser, the tokenizer and the sparse
denoiser on the card against the same modules on the CPU (logits, and the
denoisers' parameter gradients through the backward kernels), drives the serving path
(``RolloutService``: encode -> 30-iteration unmask rollout -> decode) at the
``serve/m3_g8`` configuration, holds each trainer's step program (its whole
train step captured as one CUDA graph) bitwise to its eager step at full
width (auto, fused, gradient accumulation, trajectory batches composited in
the step, sparse) and times the two, holds the I3D FVD network to the CPU
on seeded random weights, holds on-device MovingMNIST compositing
(``data/device_composite.py``) to the CPU and to the host compositor and
times the host data layer (the compiled compositor, which must be the one
that runs, against its numpy path, for MovingMNIST and for the sparse
trainer's source), drives the masked-diffusion trainer
(``cli.video_diffusion.train``) at ``train_step/m3_b64_g8_full`` for 60
steps at ``--steps_per_dispatch`` 1 and then 10, each on pixels, on
trajectories composited in the step graph (``--device_composite``) twice
and on pixels again, with their timing reports (each data format's losses
and checkpoints bitwise equal across k), drives the rollout CLI (``cli.rollout.run``: the f32
denoiser of that run's checkpoint, PNGs, GIF, FVD with three extractors,
PSNR/SSIM)
and the trainer's ``--eval`` on it, exports that checkpoint
(``cli.export_rollout``) and serves the artifact over HTTP
(``cli.serve_http``: its programs captured as CUDA graphs, held bitwise to
the live service, timed against it), drives serving and training again with
the whole-block fused attention
(``backend="fused"``, the ``local3d_block`` kernel), drives the tokenizer
trainer (``cli.train_vqae.train``) at ``train_vqae/mnist_b96`` for 200
steps, and drives the sparse space-time
trainer (``cli.sparse_diffusion.train``) at ``train_sparse/s16_n1024_b16``
for 60 steps with its evaluation sweep, and again at ``--steps_per_dispatch``
4 (bitwise equal), holds the mixture-of-experts FFN's main path to its
einsum form and the CPU's routing (``check_moe``), drives the sparse trainer
with 8 experts (its step graph bitwise to its eager step) and with the
external tokenizer at taming's Gumbel f8 widths (``--tokenizer taming:``,
card vs CPU), and the five stages of the SOM-DDPM pipeline
(``cli.som_pipeline``) at the JAX defaults' widths with the SOM's BMU search
against float64 and the UNet against the CPU, all with random seeded
weights. The trainers' kernel
launches from their step graphs are counted as captured x replays and held
to the profiler's counts.

Run from the repository root, on a machine with a GPU and the CUDA toolkit
(no network needed):

    python3 chip_smoke.py

Without a GPU, or without the ``world_modelz_tpu_torch`` package beside this
file, it exits non-zero and prints no result. Any failed phase raises. The
line before the last is the card's name and power limit as nvidia-smi
reports them; the last line of standard output is one JSON object naming
the device.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: HBM rate, and the peak rate for each
# operand type (bf16 and TF32 tensor cores, f32 CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
# TF32 products the split-TF32 kernels (the f32 flash forward, the VQ
# search) execute per f32 product (lo hi + hi lo + hi hi); the VQ search
# drops lo hi for a bf16 x, which is exact in TF32
SPLIT_TF32_PRODUCTS = 3

# serve/m3_g8 (benchmarks/serve_bench.py): 64x64x1 frames, S = 6 context
# frames, 8x8 token grid
SEQ, IMG, CHANNELS = 6, 64, 1
TOKENIZER = dict(embedding_dim=64, num_embeddings=512, downscale_steps=3,
                 hidden_planes=128, in_channels=CHANNELS)
GRID = IMG // 2 ** TOKENIZER["downscale_steps"]
DENOISER = dict(data_shape=(SEQ, GRID, GRID), dim=384, num_classes=512,
                extents=(3, 1, 1), depth=20, dim_head=128, mlp_dim=512,
                heads=1)
SERVICE = dict(batch_size=8, num_frames=8, num_iterations=30, sample_topk=-1)
# train_step/m3_b64_g8_full (benchmarks/perf_ledger.py:850-959): the
# flagship trainer at batch 64 on MovingMNIST, bf16 compute on f32 masters
TRAIN = dict(
    batch_size=64, bf16=True, tok_bf16=True, ema_decay=0.999, lr=1e-4,
    weight_decay=1e-7, warmup=10, max_steps=60, eval_interval=0,
    log_interval=10, checkpoint_interval=60, p_max_uniform=0.1,
    n_past=SEQ - 1, image_size=IMG, num_digits=2, digit_size=24,
    dim=DENOISER["dim"], depth=DENOISER["depth"],
    dim_head=DENOISER["dim_head"], heads=DENOISER["heads"],
    mlp_dim=DENOISER["mlp_dim"], extents=DENOISER["extents"], dropout=0.0,
)

# the rollout CLI (cli.rollout) on drive_training's step-60 checkpoint:
# serve/m3_g8's batch of 8 clips and 8 frames; FVD over 64 clips a side
# (8 batches), each extractor's features 8 clips at a time
ROLLOUT = dict(batch_size=8, num_frames=8, fvd_clips=64, fvd_batch_size=8)

# train_vqae/mnist_b96: the tokenizer that serve/m3_g8 and
# train_step/m3_b64_g8_full consume (TOKENIZER), trained on MovingMNIST
# with the JAX trainer's defaults (cli/train_vqae.py:53-100); cut to 200
# steps (default 10,000), lr halved at step 100 (default every 3,000),
# dead-code revival every 50 (default 500), checkpoints every 100
VQAE_TRAIN = dict(
    dataset="moving_mnist", image_size=IMG, batch_size=96, optimizer="AdamW",
    lr=2e-4, weight_decay=1e-4, loss_fn="MAE", latent_loss_weight=0.005,
    nan_guard=True, max_steps=200, lr_decay_interval=100,
    vq_reuse_interval=50, checkpoint_interval=100, log_interval=10,
    **TOKENIZER,
)

# train_sparse/s16_n1024_b16: the sparse space-time trainer at its
# as-trained configuration (scripts/chain_train_sparse.sh:58-67,
# benchmarks/perf_ledger.py:672-702): 16x16x16 token volumes of 64x64x3
# synthetic trajectories, 1,024-token subsets, a dense 8-layer transformer
# of width 512 with 8 heads of 64 on the flash kernels, bf16 on f32
# masters. Its tokenizer: 3 channels, 2 downscale steps (chain stage 1).
SPARSE_TOKENIZER = dict(embedding_dim=64, num_embeddings=512, downscale_steps=2,
                        hidden_planes=128, in_channels=3)
SPARSE_MODEL = dict(shape=(16, 16, 16), dim=512, num_classes=512, depth=8,
                    dim_head=64, mlp_dim=1024, heads=8, attn_backend="flash")
# cuts, each logged: 60 steps (default 30,000), warmup 10 (500) and the
# cosine over 60, a 4,000-frame buffer (75,000), checkpoints every 30
# (2,500), one evaluation at step 60 (every 5,000)
SPARSE_TRAIN = dict(
    dataset="synthetic", image_size=64, S=16, H=16, W=16, skip_frames=2,
    num_context=1024, sampling_type="neighbors", dim=512, depth=8, heads=8,
    mlp_dim=1024, attn_backend="flash", batch_size=16, bf16=True,
    ema_decay=0.999, lr=1e-4, change_batch_interval=4, nan_guard=True,
    max_steps=60, warmup=10, buffer_size=4000, checkpoint_interval=30,
    eval_interval=60, log_interval=10, eval_batch_size=8,
    num_eval_iterations=100,
)

# the fused block's check (check_local3d_block): name, (B, S, H, W), dim,
# heads, dim_head, extents, {dtype: the kernel wmz_local3d_block must
# launch}; the serving and training shapes of the m3 denoiser,
# benchmarks/perf_ledger.py's attn_block/m3 (6 x 16 x 16), two heads with
# an asymmetric window, a width not a multiple of 64, and a bf16 block the
# tensor-core kernel does not take (head size 32, a width not a multiple
# of 8), which the CUDA-core kernel runs
BLOCK_MMA, BLOCK_CORES = "local3d_block_mma_kernel", "local3d_block_kernel"
BLOCK_CASES = [
    ("serving", (8, SEQ, GRID, GRID), 384, 1, 128, (3, 1, 1),
     {"float32": BLOCK_CORES, "bfloat16": BLOCK_MMA}),
    ("train_m3_b64", (64, SEQ, GRID, GRID), 384, 1, 128, (3, 1, 1), {"bfloat16": BLOCK_MMA}),
    ("attn_block_m3", (8, 6, 16, 16), 384, 1, 128, (3, 1, 1), {"bfloat16": BLOCK_MMA}),
    ("multihead", (8, SEQ, GRID, GRID), 384, 2, 64, (1, 2, 1),
     {"float32": BLOCK_CORES, "bfloat16": BLOCK_MMA}),
    ("dim200", (8, SEQ, GRID, GRID), 200, 1, 128, (3, 1, 1),
     {"float32": BLOCK_CORES, "bfloat16": BLOCK_MMA}),
    ("cores_bf16", (8, SEQ, GRID, GRID), 196, 2, 32, (1, 2, 1), {"bfloat16": BLOCK_CORES}),
]

# the served denoiser's dense layers (check_dense_tf32; the split-TF32 kernel
# csrc/dense_tf32.cu): rows SEQ x GRID x GRID = 384 a clip at each size b of
# the serving ladder, and each launch's layers (N, K) with its epilogue: q |
# k | v in one launch, the output projection and the MLP's down projection
# with the residual, its up projection with the GELU. The rollout CLI and
# the trainer's --eval run the same layers at 8 clips (b = 8). The logits
# over the last frame's GRID x GRID = 64 rows a clip stay with cuBLAS (the
# kernel is slower there); they are checked and timed beside it all the same.
DENSE_LADDER = (1, 2, 4, 8)
DENSE_CASES = [
    ("qkv", SEQ * GRID * GRID, ((128, 384),) * 3, "none"),
    ("to_out", SEQ * GRID * GRID, ((384, 128),), "residual"),
    ("up", SEQ * GRID * GRID, ((512, 384),), "gelu"),
    ("down", SEQ * GRID * GRID, ((384, 512),), "residual"),
    ("logits", GRID * GRID, ((512, 384),), "none"),
]
# the other f32 forwards that take the kernel, once each at their rows M:
# the sparse evaluation (SPARSE_TRAIN's eval_batch_size x num_context rows at
# SPARSE_MODEL's widths: the fused [q | k | v], the output projection, the
# MLP, the logits), the external tokenizer's 8,192-class logits (2 clips x
# 512 context tokens), and rows that fill no tile (a chunk's remainder)
_SP_ROWS = SPARSE_TRAIN["eval_batch_size"] * SPARSE_TRAIN["num_context"]
_SP_DIM, _SP_MLP = SPARSE_MODEL["dim"], SPARSE_MODEL["mlp_dim"]
_SP_INNER = SPARSE_MODEL["heads"] * SPARSE_MODEL["dim_head"]
DENSE_OTHER_CASES = [
    ("sparse_qkv", _SP_ROWS, ((3 * _SP_INNER, _SP_DIM),), "none"),
    ("sparse_to_out", _SP_ROWS, ((_SP_DIM, _SP_INNER),), "residual"),
    ("sparse_up", _SP_ROWS, ((_SP_MLP, _SP_DIM),), "gelu"),
    ("sparse_down", _SP_ROWS, ((_SP_DIM, _SP_MLP),), "residual"),
    ("sparse_logits", _SP_ROWS, ((SPARSE_MODEL["num_classes"], _SP_DIM),), "none"),
    ("external_logits", 2 * 512, ((8192, _SP_DIM),), "none"),
    ("ragged_rows", 1000, ((_SP_DIM, _SP_INNER),), "residual"),
]
# the kernel against float64, over max(1, |Y|): the CPU test's bound on the
# plain version (tests/test_torch_port_dense_split_tf32.py), 16 ulps of 1;
# against its plain version (the same chunks summed on the card in another
# order) twice that, as each lies within it of float64
DENSE_TF32_TOL = 2.0**-19
F32_TOL = 1e-4  # f32 kernel vs plain: the same sums in another order
# the f32 local3d_fwd kernels, by the launch log's name: the cluster kernel
# at head sizes 64 and 128, one warp a query at the others
F32_CLUSTER, F32_CORES = "local3d_fwd_cluster_kernel<", "local3d_fwd_kernel<float"
# backward kernels vs plain, times max(1, max |grad|): f32 sums in another
# order
BWD_F32_TOL = 1e-4
# the bf16 local-3D backward pair vs plain versions fed the same bf16
# operands, rounding P and dS (and dK, dV partials) where the TPU backward
# for the shape does: times max |grad| (one bf16 step of the largest
# gradient), and at least this share of dq, dk and dv bitwise equal
LOCAL3D_BWD_BF16_TOL = 2.0**-7
LOCAL3D_BWD_BF16_EQUAL = 0.99
# the bf16 flash backward pair vs plain versions that round P and dS at the
# same points: times max |grad| (one bf16 step of the largest gradient),
# and at least this share of dq, dk and dv bitwise equal
FLASH_BWD_BF16_TOL = 2.0**-7
FLASH_BWD_BF16_EQUAL = 0.99
# the bf16 forwards (flash_fwd, local3d_fwd) and the bf16 fused block
# (local3d_block) vs plain versions that round at the TPU kernels' points,
# fed the same bf16 operands: times max |out|, and at least this share of
# out bitwise equal
FWD_BF16_TOL = 2.0**-7
FWD_BF16_EQUAL = 0.99
# the FVD harness's tiny features, card vs CPU (f32 convolutions with TF32
# off), relative to max |feature|
FEATURE_RTOL = 1e-4
STAT_TOL = 1e-4  # lse and delta (f32 in both), times max(1, max |stat|)
# card vs CPU gradient of each parameter tensor, times max(max |its CPU
# gradient|, GRAD_FLOOR x the largest gradient of any tensor)
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-2
# device_ms: the profile's device time against CUDA events around the same
# calls: relative slack, and the gap allowed between two queued kernels
PROFILE_AGREE = 0.05
PROFILE_GAP_US = 2.0
LOGIT_TOL = 1e-3  # 20 f32 layers, cuBLAS vs CPU BLAS summation order
# bf16 logits of the fused and the unfused denoiser on the card, times
# max(1, max |f32 logits|): 20 bf16 layers round at different points (the
# fused block rounds P before V and sums its products in another order),
# each rounding 2^-8 relative
BLOCK_BF16_LOGIT_TOL = 5e-2
PIXEL_RTOL = 1e-4  # f32 convolutions, cuDNN vs CPU, relative to max |pixel|
VQ_GAP = 1e-3  # rows whose two nearest codes differ by more must agree
# vq_train_stats vs float64 sums over the kernel's own indices: the
# worst-case f32 rounding of the kernel's sums (at most 141 adds in one
# chain; the kernel's longest is 72 at N = 6,144; 64-term dot products and
# norms per row), relative to sum |x| for dw and to sum (|x|^2 + |e_k|^2)
# for err
VQ_DW_RTOL = 1e-5
VQ_ERR_RTOL = 3e-5
# one f32 tokenizer train step, card vs CPU: loss and BatchNorm running
# statistics relative to max(1, |value|); the new codebook relative to
# max(1, max |codebook|), on the codes no near-tied row moved between
TOK_STEP_TOL = 1e-4
# its parameter gradients against float64 on the CPU, each relative to
# max(max |its grad|, GRAD_FLOOR x the largest gradient): the f32 gradient
# of a BatchNorm stack is itself up to ~2e-2 off float64 in the encoder,
# so the card's may be off by GRAD_SPREAD x the CPU's worst f32 error, and
# by TOK_GRAD_TOL at least (cuDNN's f32 algorithms sum in other orders)
TOK_GRAD_TOL = 1e-3
GRAD_SPREAD = 2.0


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_kernels(prof):
    """The profile's device events by name, without the GPU ranges of user
    annotations (``Optimizer.step`` ...), which would count their kernels
    twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernels_run(torch, fn, launches: int = 1):
    """The names (``name<args>``) of the kernels one call of ``fn``
    launches, as the library's launch log names them
    (``_build.kernels_launched``): which kernel a C entry picked. Fewer
    than ``launches`` raises."""
    import re

    from world_modelz_tpu_torch.kernels import _build

    lines = _build.kernels_launched(fn)
    torch.cuda.synchronize()
    # "void (anonymous namespace)::name<args>(params)" -> "name<args>"
    found = (re.search(r"(\w+(?:<[^()]*>)?)\(", line) for line in lines)
    names = sorted(m.group(1) for m in found if m)
    if len(names) < launches:
        raise AssertionError(
            f"kernels_run: the launch log names {names}, not {launches} kernels")
    return names


def device_ms(torch, fn, iters: int, warmup: int = 3, label: str = "") -> float:
    """Mean device time per call of ``fn`` in ms: the kernels and copies it
    issues, as torch.profiler (CUPTI) traces them, without the host's gaps
    between launches. With ``label``, logs the split by kernel.

    Each profile is held against CUDA events around the same calls. The
    calls are queued behind a spin kernel long enough for the host to
    enqueue them all before the device starts on them, so the events see
    the device's time alone, host gaps excluded. A profile that records
    less than that (minus PROFILE_GAP_US per kernel for the gaps between
    queued kernels, and PROFILE_AGREE of slack), or more, is taken again;
    after three disagreements (the profiler drops events now and then, or
    traces none) the events' time of the last attempt is the result, and
    the log says so. Where the host could not get ahead of the spin
    (``fn`` syncs), the events only bound the profile from above, and as
    the result they include the host's gaps."""
    from torch.profiler import ProfilerActivity, profile

    host = []
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    # spin for twice the host's enqueue time of the calls, and 2 ms more
    spin_ms = min(2e3 * min(host[-2:]) * iters + 2.0, 500.0)
    cycles = int(spin_ms * spin_cycles_per_ms(torch))
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marks[0].record()
            torch.cuda._sleep(cycles)
            marks[1].record()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            host_s = time.perf_counter() - t0
            marks[2].record()
            torch.cuda.synchronize()
        events = [e for e in device_kernels(prof) if "spin_kernel" not in e.key]
        us = sum(e.self_device_time_total for e in events)
        launched = sum(e.count for e in events)
        events_us = marks[1].elapsed_time(marks[2]) * 1e3
        shielded = host_s * 1e3 < 0.9 * marks[0].elapsed_time(marks[1])
        low = (us + PROFILE_GAP_US * launched < (1 - PROFILE_AGREE) * events_us
               if shielded else us == 0)
        if not low and us <= (1 + PROFILE_AGREE) * events_us:
            break
        log(f"  profile {attempt + 1} disagrees with CUDA events: {us:.3f} us "
            f"in {launched} kernels vs {events_us:.3f} us "
            f"({'shielded' if shielded else 'host-bound'}); profiling again")
    else:
        log(f"  {label or 'device_ms'}: the profiler and CUDA events disagree "
            f"three times; the CUDA events' {events_us:.3f} us for {iters} calls "
            f"is the result ({'device alone' if shielded else 'host gaps included'})")
        return events_us / 1e3 / iters
    if label:
        for e in events:
            log(f"  {label}: {e.self_device_time_total / 1e3 / iters:.5f} ms "
                f"per call in {e.key[:70]}")
    return us / 1e3 / iters


_SPIN = {}


def spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms of device time,
    measured once."""
    if "rate" not in _SPIN:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(1_000_000)  # warm
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SPIN["rate"] = 10_000_000 / start.elapsed_time(end)
    return _SPIN["rate"]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events: the device time or, for a short kernel, the host's launch
    rate, whichever is slower."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def window_pairs(s, h, w, extents) -> int:
    """Valid (query, key) pairs of one (batch, head): the window is a
    product of three clipped intervals."""
    def axis(n, e):
        return sum(min(i + e, n - 1) - max(i - e, 0) + 1 for i in range(n))
    return axis(s, extents[0]) * axis(h, extents[1]) * axis(w, extents[2])


def local3d_executed_ops(b, s, h, w, heads, dh, extents) -> int:
    """The products the tensor-core local3d_fwd executes (2 flops per
    multiply-add): each warp (16 query positions of a block's 64 or 32)
    takes Q K^T over every
    staged 64-position tile of its block's key band in each frame of the
    window in sweep 1, and Q K^T and P V again in sweep 2, over 32 keys of
    the tile where the band is one tile and the warp's own band fits in
    32 (csrc/local3d_fwd.cu, local3d_mma.cuh)."""
    es, eh, _ = extents
    hw = h * w
    # query positions per block: 64, or 32 where 64 positions' key band
    # would not fit one 64-position tile
    own = 64 if min((min(64, hw) - 1) // w + 1 + 2 * eh, h) * w <= 64 else 32

    def band(p0, p1):
        return max(p0 // w - eh, 0) * w, (min((p1 - 1) // w + eh, h - 1) + 1) * w

    keys = 0  # tile keys dotted per query row, summed over warps and frames
    for f in range(s):
        frames = min(f + es, s - 1) - max(f - es, 0) + 1
        for p0 in range(0, hw, own):
            lo, hi = band(p0, min(p0 + own, hw))
            tiles = -(-(hi - lo) // 64)
            for pw in range(p0, p0 + own, 16):
                wlo, whi = band(pw, max(min(pw + 16, hw), pw + 1))
                narrow = tiles == 1 and whi - wlo <= 32
                keys += frames * tiles * (32 if narrow else 64)
    return keys * b * heads * 3 * 2 * 16 * dh


def local3d_cluster_executed_ops(b, s, h, w, heads, dh, extents, step_keys) -> int:
    """The products the f32 cluster local3d_fwd executes (2 flops per
    multiply-add, f32 FMAs): per 64-query tile, frame of the window and
    staged step of ``step_keys`` keys of the tile's key band, each group of
    8 lanes serves two neighbouring queries and walks the keys of the box
    that holds both windows in that step, both queries scoring every key;
    a warp's 4 groups walk as many 4-key batches as the group with the most
    keys needs, so q k is taken for every key of those batches, P V for
    the group's own keys (csrc/local3d_fwd.cu:local3d_fwd_cluster_kernel)."""
    es, eh, ew = extents
    hw = h * w
    macs = 0  # multiply-adds of one (batch, head), over its frames' windows
    for f in range(s):
        frames = min(f + es, s - 1) - max(f - es, 0) + 1
        for p0 in range(0, hw, 64):
            p1 = min(p0 + 64, hw)
            lo = max(p0 // w - eh, 0) * w
            hi = (min((p1 - 1) // w + eh, h - 1) + 1) * w
            boxes = []  # each group's box: rows, first and last column
            for g in range(32):
                hq, wq = zip(*(divmod(min(p0 + 2 * g + i, p1 - 1), w) for i in range(2)))
                boxes.append((range(max(min(hq) - eh, 0), min(max(hq) + eh, h - 1) + 1),
                              max(min(wq) - ew, 0), min(max(wq) + ew, w - 1)))
            for t0 in range(lo, hi, step_keys):
                t1 = min(t0 + step_keys, hi)
                n = [sum(max(min(t1, r * w + c1 + 1) - max(t0, r * w + c0), 0)
                         for r in rows) for rows, c0, c1 in boxes]
                for warp in range(8):
                    most = max(n[4 * warp: 4 * warp + 4])
                    macs += frames * (4 * -(-most // 4) * 4 + sum(n[4 * warp: 4 * warp + 4]))
    return macs * b * heads * 2 * dh * 2


def local3d_bwd_executed_ops(b, s, h, w, heads, dh, extents, partial_rows=0):
    """The products the tensor-core backward pair executes (2 flops per
    multiply-add), as (pass 1, pass 2): each block of 64 rows (64 positions
    of a frame, or 32 of two frames where 64 positions' band would not fit
    one 64-position tile) against each 64-position tile of the other
    side's band in each frame of its frames' windows; pass 1 takes 5
    products of 64 x 64 x dh a tile (sweep 1: Q K^T, G V^T; sweep 2: both
    again and dS K), pass 2 takes 4 (K Q^T, V G^T, P^T G, dS^T Q), its
    tiles starting at each segment of ``partial_rows`` rows
    (csrc/local3d_bwd.cu)."""
    es, eh, _ = extents
    hw = h * w
    frames = 1 if min((min(64, hw) - 1) // w + 1 + 2 * eh, h) * w <= 64 else 2
    own = 64 // frames

    def band(p0, p1):
        return max(p0 // w - eh, 0) * w, (min((p1 - 1) // w + eh, h - 1) + 1) * w

    def tiles(lo, hi, seg):  # staged tiles of a frame's band
        return sum(-(-(min(hi, c + seg) - max(lo, c)) // 64)
                   for c in range(lo // seg * seg, hi, seg))

    seg2 = partial_rows * w if partial_rows else hw
    tile_pairs = [0, 0]  # (block, tile) pairs of each pass
    for s0 in range(0, s, frames):
        s1 = min(s0 + frames - 1, s - 1)
        window = min(s1 + es, s - 1) - max(s0 - es, 0) + 1
        for p0 in range(0, hw, own):
            lo, hi = band(p0, min(p0 + own, hw))
            tile_pairs[0] += window * tiles(lo, hi, hw)
            tile_pairs[1] += window * tiles(lo, hi, seg2)
    unit = b * heads * 2 * 64 * 64 * dh
    return tile_pairs[0] * unit * 5, tile_pairs[1] * unit * 4


def ptxas_summary(build_log: str):
    """One line per compiled kernel of nvcc's ``-Xptxas -v`` output: its
    name and template arguments, registers, barriers and shared memory, and
    spills where there are any; and every line that reports an error."""
    import re

    lines, name = [], None
    for line in build_log.splitlines():
        if "error" in line:
            lines.append(line.strip())
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
            # Itanium mangling: a name follows its length, which may sit at
            # the end of a longer run of hex digits
            for m in re.finditer(r"\d+", name):
                run = m.group()
                cands = [name[m.end(): m.end() + int(run[i:])] for i in range(len(run))]
                cand = next((c for c in cands if c.endswith("_kernel")), None)
                if cand:
                    rest = name[m.end() + len(cand):]
                    name = cand + rest[: rest.find("EE") + 1]
                    break
            spill = ""
        elif name and "spill stores" in line and not line.strip().startswith(
                "0 bytes stack frame, 0 bytes spill stores"):
            spill = "; " + line.strip()
        elif name and "Used" in line and "registers" in line:
            lines.append(f"{name}: {line.split('Used', 1)[1].strip()}{spill}")
            name = None
    return lines


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases


def check_local3d(torch, dev):
    """Kernel A against its plain version, ``local3d_attention_rounded``
    fed the same operands, at the serving, training and a multi-head
    asymmetric shape, at 34-frame clips (which the TPU forward normalises
    P for), at 16 x 16 frames at batch 8 and 2 (blocks of 32 queries,
    with one and two groups of warps), at a 12-frame clip with a frame
    extent of 5 (a window of 11 frames: more than a cluster's 8 CTAs, so
    a CTA takes several), at 64 x 32 frames (which the TPU forward takes
    H-tiled in f32: `_attn_kernel_tiled`; key bands of 128 keys, two steps),
    and at head size 32 in both of the TPU's rounding routes, in f32 (the
    cluster kernel at dh 64 and 128, one warp a query at 32) and bf16 (the
    tensor-core kernel at dh 64 and 128, the rounding CUDA-core kernel at
    32, both rounding P where the TPU kernel does).
    The launch log must name the kernel each f32 case expects. bf16 must
    lie within FWD_BF16_TOL x max |out| and be at least FWD_BF16_EQUAL
    bitwise equal, f32 within F32_TOL; two launches must be bitwise equal.
    Logs each case's time, bounds (bytes and operations) and share of the
    bound, and the products each kernel executes.
    Returns the serving-shape records, bf16 (the serving path's) and f32
    (the rollout CLI's)."""
    import torch.nn.functional as F

    from world_modelz_tpu_torch.kernels import local3d as kl
    from world_modelz_tpu_torch.kernels import local3d_attention_fwd
    from world_modelz_tpu_torch.models.attention import local3d_attention_rounded

    cases = [  # name, (B, S, H, W), heads, dh, extents
        ("serving", (8, 6, 8, 8), 1, 128, (3, 1, 1)),
        ("train_m3_b64", (64, 6, 8, 8), 1, 128, (3, 1, 1)),
        ("training", (8, 6, 16, 16), 1, 128, (3, 1, 1)),
        ("frames16_b2", (2, 6, 16, 16), 1, 128, (3, 1, 1)),
        ("multihead", (8, 6, 8, 8), 2, 64, (1, 2, 1)),
        ("clip34", (2, 34, 8, 8), 1, 128, (3, 1, 1)),
        ("clip34_multihead", (2, 34, 8, 8), 2, 64, (1, 2, 1)),
        ("frames12_es5", (2, 12, 8, 8), 1, 128, (5, 1, 1)),
        ("frames64x32_tiled", (1, 2, 64, 32), 1, 128, (3, 1, 1)),
        ("multihead_dh32", (8, 6, 8, 8), 2, 32, (1, 2, 1)),
        ("clip34_dh32", (2, 34, 8, 8), 2, 32, (1, 1, 1)),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    serving = {}
    for name, (b, s, h, w), heads, dh, ext in cases:
        for dtype in (torch.float32, torch.bfloat16):
            shape = (b, s, h, w, heads * dh)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            divide_after = kl.divides_after_product(shape, heads, ext, dtype)
            out = local3d_attention_fwd(q, k, v, ext, heads)
            again = local3d_attention_fwd(q, k, v, ext, heads)
            plain = local3d_attention_rounded(q, k, v, ext, heads, divide_after)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"local3d {name} {dtype}: two launches differ")
            err = float((out.float() - plain.float()).abs().max())
            peak = float(plain.float().abs().max())
            bf16 = dtype == torch.bfloat16
            lim = FWD_BF16_TOL * peak if bf16 else F32_TOL
            if not err <= lim:
                raise AssertionError(
                    f"local3d {name} {dtype}: max abs err {err} > {lim}")
            equal = float((out == plain).float().mean())
            if bf16 and not equal >= FWD_BF16_EQUAL:
                raise AssertionError(
                    f"local3d {name} {dtype}: {equal:.4f} bitwise equal < "
                    f"{FWD_BF16_EQUAL}")
            kernel = lambda: local3d_attention_fwd(q, k, v, ext, heads)  # noqa: E731
            ran = kernels_run(torch, kernel)
            tensor_cores = any("mma" in n for n in ran)
            if name == "train_m3_b64" and bf16 and not tensor_cores:
                raise AssertionError(f"local3d {name} bf16 ran {ran}, not the tensor cores")
            if not bf16:
                want = F32_CLUSTER if dh in (64, 128) else F32_CORES
                if not all(n.startswith(want) for n in ran):
                    raise AssertionError(f"local3d {name} float32 ran {ran}, not {want}")
            ms = device_ms(torch, kernel, 100)
            launch_ms = cuda_ms(torch, kernel, 200)
            plain_ms = device_ms(torch, lambda: local3d_attention_rounded(
                q, k, v, ext, heads, divide_after), 10)
            # library yardstick: SDPA over all S*H*W tokens with a dense
            # boolean window mask
            n = s * h * w
            qs, ks, vs = (t.reshape(b, n, heads, dh).transpose(1, 2) for t in (q, k, v))
            mask = window_mask(torch, dev, s, h, w, ext)
            lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask), 20)
            isz = torch.tensor([], dtype=dtype).element_size()
            nbytes = 4 * q.numel() * isz
            ops = 4 * dh * heads * b * window_pairs(s, h, w, ext)
            tname = str(dtype).replace("torch.", "")
            bound_ms, bound_by = bound(nbytes, ops, tname)
            executed = ""
            if tensor_cores:
                done = local3d_executed_ops(b, s, h, w, heads, dh, ext)
                executed = (f" executed {done / ops:.3f}x the window's products "
                            f"({done / ms / 1e9:.2f} TFLOP/s)")
            elif not bf16 and dh in (64, 128):
                # the stages are the launch log's second template argument
                stages = int(ran[0].rstrip(">").split(",")[-1])
                done = local3d_cluster_executed_ops(b, s, h, w, heads, dh, ext,
                                                    96 if stages == 2 else 64)
                executed = (f" executed {done / ops:.3f}x the window's products "
                            f"in f32 FMAs ({done / ms / 1e9:.2f} TFLOP/s)")
            log(f"local3d_fwd {name} {tname} {shape} extents={ext} kernel={ran} "
                f"(divide_after={divide_after}): max_abs_err={err:.3g} (tol "
                f"{lim:.3g}) bitwise_equal={equal:.5f}; repeat bitwise; "
                f"kernel_ms={ms:.5f} ({ops / ms / 1e9:.2f} TFLOP/s;{executed}) "
                f"back_to_back_ms={launch_ms:.5f} plain_ms={plain_ms:.5f} "
                f"library_ms={lib_ms:.5f} (kernel/SDPA {ms / lib_ms:.4f}) "
                f"bound_us={bound_ms * 1e3:.4f} ({bound_by}; bytes "
                f"{nbytes / HBM_BYTES_PER_S * 1e6:.4f}, operations "
                f"{ops / PEAK_OPS_PER_S[tname] * 1e6:.4f}) share of the bound "
                f"{bound_ms / ms:.4f}")
            if name == "serving":
                serving[tname] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=lib_ms)
    return serving["bfloat16"], serving["float32"]


def block_operands(torch, gen, dev, b, s, h, w, dim, heads, dh, dtype):
    """x_kv, q_in and the six weights and biases of one fused attention
    block, in nn.Linear's layout, scaled as nn.Linear's initialisation
    scales them (fan_in^-1/2) so that activations stay O(1)."""
    inner = heads * dh

    def rand(*shape, fan_in=1):
        return (torch.randn(shape, generator=gen, device=dev) * fan_in**-0.5).to(dtype)

    x_kv, q_in = rand(b, s, h, w, dim), rand(b, s, h, w, dim)
    wk, wv, wq = (rand(inner, dim, fan_in=dim) for _ in range(3))
    bv = rand(inner, fan_in=dim)
    wo, bo = rand(dim, inner, fan_in=inner), rand(dim, fan_in=inner)
    return x_kv, q_in, wk, wv, bv, wq, wo, bo


def check_local3d_block(torch, dev, cases=None):
    """The fused block kernel (``local3d_block_fwd``) against its plain
    version at the serving (f32, bf16), training, attn_block/m3,
    multi-head and dim-200 shapes, and in bf16 at a shape the tensor-core
    kernel does not take: bf16 within FWD_BF16_TOL x max |out|
    and at least FWD_BF16_EQUAL bitwise equal (the plain version rounds
    where the TPU block does, so a kernel that rounds elsewhere fails), f32
    within F32_TOL x max(1, max |out|); two launches bitwise equal; the
    kernel that ran is the case's; in f32, the
    Function's gradients of all eight operands against autograd through
    the plain composition. Times the kernel beside the port's unfused
    attention-only route on the same inputs. Returns the serving-shape
    bf16 record."""
    import ctypes

    import torch.nn.functional as F

    from world_modelz_tpu_torch.kernels import (
        _build,
        load_library,
        local3d_attention_fwd,
        local3d_block_fwd,
        local3d_block_reference,
    )
    from world_modelz_tpu_torch.kernels.local3d_block import _kernel_args

    lib = load_library()
    for line in ptxas_summary(str(_build.BUILD_INFO.get("log", ""))):
        if "local3d_block" in line:
            log(f"local3d_block ptxas: {line}")
    cases = BLOCK_CASES if cases is None else cases
    gen = torch.Generator(device=dev).manual_seed(14)
    serving = None
    for name, (b, s, h, w), dim, heads, dh, ext, kernels in cases:
        for dtype, want in ((getattr(torch, d), k) for d, k in kernels.items()):
            ops = block_operands(torch, gen, dev, b, s, h, w, dim, heads, dh, dtype)
            out = local3d_block_fwd(*ops, ext, heads)
            again = local3d_block_fwd(*ops, ext, heads)
            plain = local3d_block_reference(*ops, ext, heads)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"local3d_block {name} {dtype}: two launches differ")
            tname = str(dtype).replace("torch.", "")
            err = float((out.float() - plain.float()).abs().max())
            peak = float(plain.float().abs().max())
            bf16 = dtype == torch.bfloat16
            lim = FWD_BF16_TOL * peak if bf16 else F32_TOL * max(1.0, peak)
            if not err <= lim:
                raise AssertionError(
                    f"local3d_block {name} {tname}: max abs err {err} > {lim}")
            equal = float((out == plain).float().mean())
            if bf16 and not equal >= FWD_BF16_EQUAL:
                raise AssertionError(
                    f"local3d_block {name} {tname}: {equal:.4f} bitwise equal < "
                    f"{FWD_BF16_EQUAL}")
            kernel = lambda: local3d_block_fwd(*ops, ext, heads)  # noqa: E731
            ran = kernels_run(torch, kernel)
            if len(ran) != 1 or not ran[0].startswith(want + "<"):
                raise AssertionError(f"local3d_block {name} {tname} ran {ran}, not {want}")
            grad_note = ""
            if dtype == torch.float32:
                grad_note = " " + check_block_grads(
                    torch, gen, ops, ext, heads, f"local3d_block {name}")

            def unfused():  # the attention-only route: cuBLAS + local3d_fwd
                x_kv, q_in, wk, wv, bv, wq, wo, bo = ops
                a = local3d_attention_fwd(F.linear(q_in, wq), F.linear(x_kv, wk),
                                          F.linear(x_kv, wv, bv), ext, heads)
                return F.linear(a, wo, bo)

            ms = device_ms(torch, kernel, 50)
            b2b = cuda_ms(torch, kernel, 100)
            plain_ms = device_ms(
                torch, lambda: local3d_block_reference(*ops, ext, heads), 5)
            unfused_ms = device_ms(torch, unfused, 50)
            rows, inner = b * s * h * w, heads * dh
            isz = ops[0].element_size()
            nbytes = (3 * rows * dim + sum(t.numel() for t in ops[2:])) * isz
            ops_n = (2 * rows * inner * 4 * dim
                     + 4 * dh * heads * b * window_pairs(s, h, w, ext))
            bound_ms, bound_by = bound(nbytes, ops_n, tname)
            threads = ctypes.c_int(0)
            grid = lib.wmz_local3d_block_grid(*_kernel_args(ext, heads, ops), ctypes.byref(threads))
            log(f"local3d_block {name} {tname} (B, S, H, W)={(b, s, h, w)} dim={dim} "
                f"heads={heads}x{dh} extents={ext} kernel={ran}: max_abs_err={err:.3g} "
                f"(tol {lim:.3g}) bitwise_equal={equal:.5f}; repeat bitwise;{grad_note} "
                f"kernel_ms={ms:.5f} ({ops_n / ms / 1e9:.2f} TFLOP/s) "
                f"back_to_back_ms={b2b:.5f} plain_ms={plain_ms:.5f} "
                f"unfused_ms={unfused_ms:.5f} (cuBLAS projections + local3d_fwd; "
                f"kernel/unfused {ms / unfused_ms:.4f}) library_ms=null "
                f"bound_us={bound_ms * 1e3:.4f} ({bound_by}); cooperative grid "
                f"{grid} blocks of {threads.value}")
            if name == "serving" and bf16:
                serving = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=None, unfused_ms=unfused_ms)
            del ops, out, again, plain
        torch.cuda.empty_cache()
    return serving


def check_block_grads(torch, gen, ops, ext, heads, label):
    """Gradients of all eight operands of the fused Function (f32) against
    autograd through the plain composition, each within BWD_F32_TOL x
    max(1, max |its gradient|); returns a log fragment."""
    import torch.nn.functional as F

    from world_modelz_tpu_torch.kernels import local3d_block
    from world_modelz_tpu_torch.models.attention import local3d_attention

    leaves = [t.detach().clone().requires_grad_() for t in ops]
    ref_leaves = [t.detach().clone().requires_grad_() for t in ops]
    out = local3d_block(*leaves, ext, heads)
    g = torch.randn(out.shape, generator=gen, device=out.device)
    got = torch.autograd.grad(out, leaves, g)
    x_kv, q_in, wk, wv, bv, wq, wo, bo = ref_leaves
    a = local3d_attention(F.linear(q_in, wq), F.linear(x_kv, wk),
                          F.linear(x_kv, wv, bv), ext, heads)
    want = torch.autograd.grad(F.linear(a, wo, bo), ref_leaves, g)
    worst = 0.0
    for name, gg, ww in zip(("x_kv", "q_in", "wk", "wv", "bv", "wq", "wo", "bo"),
                            got, want):
        err = float((gg - ww).abs().max())
        lim = BWD_F32_TOL * max(1.0, float(ww.abs().max()))
        worst = max(worst, err / lim)
        if not err <= lim:
            raise AssertionError(f"{label} d{name}: max abs err {err} > {lim}")
    return f"gradients of 8 operands within {worst:.3g} of their limits;"


def window_mask(torch, dev, s, h, w, extents):
    """(S*H*W, S*H*W) bool: True where the key lies in the query's window
    (the dense mask the SDPA yardstick takes)."""
    pos = torch.stack(torch.meshgrid(
        torch.arange(s), torch.arange(h), torch.arange(w),
        indexing="ij"), -1).reshape(s * h * w, 3).to(dev)
    return ((pos[:, None, :] - pos[None, :, :]).abs()
            <= torch.tensor(extents, device=dev)).all(-1)


def check_local3d_bwd(torch, dev, depth=DENOISER["depth"]):
    """The split backward pair against its plain versions fed the same
    operands, at the training slice's shape, train_step_bench's shape, a
    multi-head asymmetric one, 34-frame clips (the TPU's per-frame route:
    dK and dV partials rounded per query frame), a 32 x 32 frame (the
    split route), a 64 x 32 frame (the H-tiled route: partials per 4 rows)
    and head size 32 (the rounding CUDA-core kernels), in f32 and bf16.
    bf16 dq, dk and dv must lie within LOCAL3D_BWD_BF16_TOL x max |x| and
    be at least LOCAL3D_BWD_BF16_EQUAL bitwise equal, f32 within
    BWD_F32_TOL x max(1, max |x|); lse and delta within STAT_TOL; two
    launches bitwise equal. Times the timed cases beside SDPA's backward
    with the dense window mask. Returns {kernel: record} at the slice's
    shape in bf16."""
    import torch.nn.functional as F

    from world_modelz_tpu_torch.kernels import (
        local3d_attention_fwd,
        local3d_bwd_dkv,
        local3d_bwd_dq,
    )
    from world_modelz_tpu_torch.kernels import _build
    from world_modelz_tpu_torch.kernels import local3d as kl
    from world_modelz_tpu_torch.models.attention import (
        local3d_attention_bwd_dkv,
        local3d_attention_bwd_dq,
    )

    for line in ptxas_summary(str(_build.BUILD_INFO.get("log", ""))):
        if "local3d_bwd" in line:
            log(f"local3d_bwd ptxas: {line}")
    cases = [  # name, (B, S, H, W), heads, dh, extents, dtypes, timed
        ("train_m3_b64", (64, 6, 8, 8), 1, 128, (3, 1, 1), ("float32", "bfloat16"), True),
        ("train_bench", (8, 6, 16, 16), 1, 128, (3, 1, 1), ("float32", "bfloat16"), True),
        ("multihead", (8, 6, 8, 8), 2, 64, (1, 2, 1), ("float32", "bfloat16"), True),
        ("clip34", (2, 34, 8, 8), 1, 128, (3, 1, 1), ("bfloat16",), True),
        ("clip34_multihead", (2, 34, 8, 8), 2, 64, (1, 2, 1), ("bfloat16",), False),
        ("frames32_split", (1, 2, 32, 32), 1, 128, (3, 1, 1), ("bfloat16",), False),
        ("frames64x32_tiled", (1, 2, 64, 32), 1, 128, (3, 1, 1), ("bfloat16",), True),
        ("dh32", (8, 6, 8, 8), 2, 32, (1, 2, 1), ("float32", "bfloat16"), True),
        ("dh32_clip34", (2, 34, 8, 8), 2, 32, (1, 1, 1), ("bfloat16",), False),
    ]
    gen = torch.Generator(device=dev).manual_seed(5)
    records = {}
    for name, (b, s, h, w), heads, dh, ext, dtypes, timed in cases:
        for dtype in (getattr(torch, d) for d in dtypes):
            shape = (b, s, h, w, heads * dh)
            q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                          for _ in range(4))
            route = kl.bwd_route(shape, heads, ext, dtype)

            def dq_fn():
                return local3d_bwd_dq(q, k, v, g, ext, heads)

            dq, lse, delta = dq_fn()
            dkv_fn = lambda: local3d_bwd_dkv(  # noqa: E731
                q, k, v, g, lse, delta, ext, heads)
            dk, dv = dkv_fn()
            again = (*dq_fn(), *dkv_fn())
            ran = kernels_run(torch, lambda: (dq_fn(), dkv_fn()), launches=2)
            tensor_cores = all(any("mma" in n and pass_ in n for n in ran)
                               for pass_ in ("dq", "dkv"))
            if name == "train_m3_b64" and dtype == torch.bfloat16 and not tensor_cores:
                raise AssertionError(f"local3d_bwd {name} bf16 ran {ran}, not the tensor cores")
            p_dq, p_lse, p_delta = local3d_attention_bwd_dq(q, k, v, g, ext, heads)
            p_dk, p_dv = local3d_attention_bwd_dkv(
                q, k, v, g, p_lse, p_delta, ext, heads)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip((dq, lse, delta, dk, dv), again)):
                raise AssertionError(f"local3d_bwd {name} {dtype}: two launches differ")
            bf16 = dtype == torch.bfloat16
            errs, equal = {}, {}
            for label, got, want in (
                    ("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv, p_dv),
                    ("lse", lse, p_lse), ("delta", delta, p_delta)):
                err = float((got.float() - want.float()).abs().max())
                peak = float(want.float().abs().max())
                errs[label] = err
                if label in ("lse", "delta"):
                    lim = STAT_TOL * max(1.0, peak)
                elif bf16:
                    lim = LOCAL3D_BWD_BF16_TOL * peak
                    equal[label] = float((got == want).float().mean())
                    if not equal[label] >= LOCAL3D_BWD_BF16_EQUAL:
                        raise AssertionError(
                            f"local3d_bwd {name} {dtype} {label}: "
                            f"{equal[label]:.5f} bitwise equal < {LOCAL3D_BWD_BF16_EQUAL}")
                else:
                    lim = BWD_F32_TOL * max(1.0, peak)
                if not err <= lim:
                    raise AssertionError(
                        f"local3d_bwd {name} {dtype} {label}: max abs err {err} > {lim}")
            tname = str(dtype).replace("torch.", "")
            head = (f"local3d_bwd {name} {tname} {shape} extents={ext} route={route.kind} "
                    f"partial_rows={route.partial_rows} kernels={ran}: max_abs_err " + " ".join(
                        f"{key}={val:.3g}" for key, val in errs.items())
                    + (" bitwise_equal " + " ".join(
                        f"{key}={val:.5f}" for key, val in equal.items()) if bf16 else "")
                    + "; repeat bitwise")
            if not timed:
                dq_ms = device_ms(torch, dq_fn, 20)
                dkv_ms = device_ms(torch, dkv_fn, 20)
                log(f"{head}; dq_ms={dq_ms:.5f} dkv_ms={dkv_ms:.5f}")
                continue
            isz = torch.tensor([], dtype=dtype).element_size()
            pairs = b * heads * window_pairs(s, h, w, ext)
            stats = 2 * lse.numel() * 4
            dq_ms = device_ms(torch, dq_fn, 50)
            dkv_ms = device_ms(torch, dkv_fn, 50)
            # CUDA events over back-to-back launches: a cross-check of the
            # profiler's sums
            dq_b2b = cuda_ms(torch, dq_fn, 100)
            dkv_b2b = cuda_ms(torch, dkv_fn, 100)
            fwd_ms = device_ms(
                torch, lambda: local3d_attention_fwd(q, k, v, ext, heads), 50)
            p_dq_ms = device_ms(torch, lambda: local3d_attention_bwd_dq(
                q, k, v, g, ext, heads), 5)
            p_dkv_ms = device_ms(torch, lambda: local3d_attention_bwd_dkv(
                q, k, v, g, lse, delta, ext, heads), 5)
            # library yardstick: SDPA forward + backward over all S*H*W
            # tokens with the dense boolean window mask
            n = s * h * w
            qs, ks, vs, gs = (t.reshape(b, n, heads, dh).transpose(1, 2)
                              .detach().requires_grad_(t is not g)
                              for t in (q, k, v, g))
            mask = window_mask(torch, dev, s, h, w, ext)

            def sdpa_fwd():
                return F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), gs)

            with torch.no_grad():
                lib_fwd_ms = device_ms(torch, sdpa_fwd, 20)
            lib_ms = device_ms(torch, sdpa_fwd_bwd, 20)
            lib_bwd_ms = lib_ms - lib_fwd_ms
            bounds = {
                "local3d_bwd_dq": bound(
                    5 * q.numel() * isz + stats, 6 * dh * pairs, tname),
                "local3d_bwd_dkv": bound(
                    6 * q.numel() * isz + stats, 8 * dh * pairs, tname),
            }
            executed = ""
            if tensor_cores:
                e1, e2 = local3d_bwd_executed_ops(b, s, h, w, heads, dh, ext,
                                                  route.partial_rows)
                executed = (f" executed dq {e1 / 1e9:.3f} GFLOP ({e1 / dq_ms / 1e9:.2f} "
                            f"TFLOP/s) dkv {e2 / 1e9:.3f} GFLOP ({e2 / dkv_ms / 1e9:.2f} "
                            f"TFLOP/s);")
            log(f"{head}; dq_ms={dq_ms:.5f} dkv_ms={dkv_ms:.5f} (back_to_back "
                f"{dq_b2b:.5f}, {dkv_b2b:.5f}) pair_ms={dq_ms + dkv_ms:.5f} "
                f"(pair/SDPA bwd {(dq_ms + dkv_ms) / lib_bwd_ms:.4f});{executed} "
                f"plain_dq_ms={p_dq_ms:.5f} plain_dkv_ms={p_dkv_ms:.5f} | "
                f"fwd+dq+dkv_ms={fwd_ms + dq_ms + dkv_ms:.5f} vs "
                f"SDPA fwd+bwd library_ms={lib_ms:.5f} "
                f"(fwd {lib_fwd_ms:.5f}, bwd {lib_bwd_ms:.5f}) | bound_us "
                f"dq={bounds['local3d_bwd_dq'][0] * 1e3:.4f} "
                f"({bounds['local3d_bwd_dq'][1]}) "
                f"dkv={bounds['local3d_bwd_dkv'][0] * 1e3:.4f} "
                f"({bounds['local3d_bwd_dkv'][1]}) | "
                f"{depth} launches of each per train step")
            if name == "train_m3_b64" and bf16:
                for kname, ms, plain_ms, err in (
                        ("local3d_bwd_dq", dq_ms, p_dq_ms,
                         max(errs["dq"], errs["lse"], errs["delta"])),
                        ("local3d_bwd_dkv", dkv_ms, p_dkv_ms,
                         max(errs["dk"], errs["dv"]))):
                    records[kname] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bounds[kname][0], bound_by=bounds[kname][1],
                        library_ms=lib_bwd_ms)
            del q, k, v, g, dq, dk, dv, again, p_dq, p_dk, p_dv
        torch.cuda.empty_cache()
    return records


# pairs of equal codes (lower, higher) at K = 512: in one lane (12, 13), the
# lower in a higher lane of the quad (20: lane 2, 25: lane 0), across a chunk
# boundary (63, 64), across chunks and code splits (7, 300; 128, 511)
VQ_TIED = ((12, 13), (20, 25), (63, 64), (7, 300), (128, 511))


def vq_tie_case(torch, dev, n, dtype, k=TOKENIZER["num_embeddings"],
                d=TOKENIZER["embedding_dim"]):
    """A (k, d) codebook whose codes VQ_TIED[i][1] (those below k) repeat
    VQ_TIED[i][0], rows equal to the higher copy (every other row), two rows
    all NaN, and the codes the search must pick for those rows: the lower
    copy (ties go to the lowest k), 0 for all-NaN distances. Returns (x,
    codebook, rows, want)."""
    tied = [(lo, hi) for lo, hi in VQ_TIED if hi < k]
    gen = torch.Generator(device=dev).manual_seed(3)
    codebook = torch.randn((k, d), generator=gen, device=dev)
    for lo, hi in tied:
        codebook[hi] = codebook[lo]
    x = torch.randn((n, d), generator=gen, device=dev)
    rows = torch.arange(0, n, 2, device=dev)
    pick = torch.tensor(tied, device=dev)[rows % len(tied)]
    x[rows] = codebook[pick[:, 1]]
    want = pick[:, 0]
    nan_rows = torch.tensor([1, n - 1], device=dev)
    x[nan_rows] = float("nan")
    return (x.to(dtype), codebook, torch.cat([rows, nan_rows]),
            torch.cat([want, torch.zeros_like(nan_rows)]))


def check_vq_ties(torch, name, got, rows, want):
    """The search's picks for vq_tie_case's rows: the lower of two equal
    codes, 0 for an all-NaN row."""
    wrong = int((got[rows].long() != want).sum())
    if wrong:
        raise AssertionError(
            f"{name}: {wrong} of {rows.numel()} tied or all-NaN rows did not "
            f"take the lowest code")


def check_vq(torch, dev, cases=None, ties=None, records=None):
    """Kernel B against its plain version at the serving encode batch (f32,
    as the tokenizer feeds it, and bf16), at the training step's encode
    batch (64 clips of S frames), at the tokenize-benchmark batch, at
    the sparse trainer's encode batch (N = 65,536) and at a shape off the
    main paths (K not a whole number of 64-code chunks, D below 64, a
    ragged N); then ties and all-NaN rows (vq_tie_case) at the serving
    batch (f32, bf16: at K = 512 the plan splits a 128-row tile's codes over
    four CTAs) and the sparse trainer's (one split). ``cases`` ((name, N,
    dtype, codebook)) and ``ties`` ((N, K, D)) replace those; ``records``
    takes each f32 case's record by name. Returns the serving f32
    record."""
    from world_modelz_tpu_torch.kernels import vq_encode_nearest
    from world_modelz_tpu_torch.ops.vq import vq_encode

    k, d = TOKENIZER["num_embeddings"], TOKENIZER["embedding_dim"]
    ties = ties or [(n, k, d) for n in (8 * SEQ * GRID * GRID, SPARSE_TRAIN["batch_size"]
                                        * SPARSE_TRAIN["S"] * SPARSE_TRAIN["H"]
                                        * SPARSE_TRAIN["W"])]
    gen = torch.Generator(device=dev).manual_seed(1)
    codebook = torch.randn((k, d), generator=gen, device=dev)
    serving = None
    # its own generator: the other cases keep their inputs
    odd = torch.randn((101, 24), generator=torch.Generator(device=dev).manual_seed(2),
                      device=dev)
    cases = cases or [("serving", 8 * SEQ * GRID * GRID, torch.float32, codebook),
             ("serving", 8 * SEQ * GRID * GRID, torch.bfloat16, codebook),
             ("train", TRAIN["batch_size"] * SEQ * GRID * GRID, torch.float32, codebook),
             ("bench", 256 * GRID * GRID, torch.float32, codebook),
             # the sparse trainer's encode: 16 clips of 16 frames, 16x16
             ("sparse_train", SPARSE_TRAIN["batch_size"] * SPARSE_TRAIN["S"]
              * SPARSE_TRAIN["H"] * SPARSE_TRAIN["W"], torch.float32, codebook),
             ("odd_shape", 1000, torch.float32, odd)]
    for name, n, dtype, codebook in cases:
        k, d = codebook.shape
        e_sq = (codebook * codebook).sum(-1)
        x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        got = vq_encode_nearest(x, codebook)
        if not torch.equal(got, vq_encode_nearest(x, codebook)):
            raise AssertionError(f"vq {name}: two launches differ")
        ran = kernels_run(torch, lambda: vq_encode_nearest(x, codebook), 2)
        if not any(r.startswith("vq_encode_kernel") for r in ran):
            raise AssertionError(f"vq {name}: the search kernel did not run: {ran}")
        if dtype == torch.bfloat16 and not torch.equal(
                got, vq_encode_nearest(x.float(), codebook)):
            # bf16 drops the lo_x product, which is all zeros for these values
            raise AssertionError(
                f"vq {name}: bf16 x and the same values in f32 pick other codes")
        got = got.long()
        want = vq_encode(codebook[None], x[:, None]).reshape(-1).long()
        dist = ((x.double()[:, None, :] - codebook.double()[None]) ** 2).sum(-1)
        top2 = dist.topk(2, dim=-1, largest=False).values
        untied = (top2[:, 1] - top2[:, 0]) > VQ_GAP
        agree = got == want
        share = float(agree.float().mean())
        if share < 0.999 or not bool(agree[untied].all()):
            raise AssertionError(
                f"vq {name}: indices agree on {share:.5f} of rows, "
                f"{int((~agree & untied).sum())} disagreements beyond the gap")
        # the objective's error: distance of the kernel's code minus the
        # distance of the plain version's code, in f64
        regret = float((dist.gather(1, got[:, None])
                        - dist.gather(1, want[:, None])).abs().max())
        kernel = lambda: vq_encode_nearest(x, codebook)  # noqa: E731
        ms = device_ms(torch, kernel, 100, label=f"vq_encode {name}")
        launch_ms = cuda_ms(torch, kernel, 200)
        plain_ms = device_ms(
            torch, lambda: vq_encode(codebook[None], x[:, None]), 10)
        # the cuBLAS route (two calls, so no library_ms): f32 GEMM, TF32 off
        xf = x.float()
        cublas_ms = device_ms(torch, lambda: torch.addmm(
            e_sq, xf, codebook.T, alpha=-2.0).argmin(1), 100)
        nbytes = n * d * x.element_size() + k * d * 4 + n * 4
        products = SPLIT_TF32_PRODUCTS - (dtype == torch.bfloat16)
        bound_ms, bound_by = bound(nbytes, products * 2 * n * k * d, "tf32")
        f32_bound_ms = bound(nbytes, 2 * n * k * d + 2 * k * d + 2 * n * k, "float32")[0]
        tname = str(dtype).replace("torch.", "")
        log(f"vq_encode {name} {tname} N={n} K={k} D={d}: agree={share:.5f} "
            f"max_abs_err={regret:.3g} (distance) repeat bitwise; kernels "
            f"{', '.join(ran)} | kernel_ms={ms:.5f} "
            f"back_to_back_ms={launch_ms:.5f} plain_ms={plain_ms:.5f} "
            f"library_ms=null cublas_route_ms={cublas_ms:.5f} "
            f"(kernel/route {ms / cublas_ms:.4f}) | bound_us={bound_ms * 1e3:.4f} "
            f"({bound_by}; {products} TF32 products at the TF32 peak), on the "
            f"CUDA cores at the f32 peak {f32_bound_ms * 1e3:.4f}")
        if dtype == torch.float32:
            rec = dict(max_abs_err=regret, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=None, cublas_route_ms=cublas_ms)
            if records is not None:
                records[name] = rec
            if name == "serving":
                serving = rec
        del x, xf
    for n, k, d in ties:
        for dtype in (torch.float32, torch.bfloat16):
            x, codebook, rows, want = vq_tie_case(torch, dev, n, dtype, k, d)
            name = f"vq ties N={n} K={k} D={d} {str(dtype).replace('torch.', '')}"
            check_vq_ties(torch, name, vq_encode_nearest(x, codebook), rows, want)
            plain = vq_encode(codebook[None], x[:, None]).reshape(-1)
            check_vq_ties(torch, f"{name} (plain version)", plain, rows, want)
            log(f"{name}: {rows.numel() - 2} tied rows took the lower code, "
                f"2 all-NaN rows code 0")
    return serving


def check_vq_train(torch, dev, n_train=VQAE_TRAIN["batch_size"] * GRID * GRID,
                   cases=None, ties=None, records=None):
    """Kernel C (``vq_train_stats``) against its plain version and float64
    sums at the tokenizer trainer's batch (96 frames of 8x8 latents), at a
    ragged N, with a codebook whose codes but 12 lie far from the data,
    and at a shape off the main paths (K = 101, D = 24, N = 1,000); then
    ties and all-NaN rows (vq_tie_case) at N = 3,072 (four code splits at
    K = 512) and at the training batch. ``cases`` ((name, N, codebook))
    and ``ties`` ((N, K, D)) replace those; ``records`` takes each case's
    record by name. Returns the training-shape record."""
    from world_modelz_tpu_torch.kernels import vq_encode_nearest, vq_train_stats
    from world_modelz_tpu_torch.ops.vq import vq_train_stats_reference

    k, d = TOKENIZER["num_embeddings"], TOKENIZER["embedding_dim"]
    ties = ties or [(n, k, d) for n in (8 * SEQ * GRID * GRID, n_train)]
    gen = torch.Generator(device=dev).manual_seed(6)
    codebook = torch.randn((k, d), generator=gen, device=dev)
    far = codebook.clone()
    far[12:] += 100.0  # 500 codes no row is near
    record = None
    for name, n, cb in cases or (("train", n_train, codebook),
                                 ("ragged", n_train + 37, codebook),
                                 ("mostly_dead", n_train, far),
                                 ("odd_shape", 1000, torch.randn(
                                     (101, 24), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(7)))):
        k, d = cb.shape
        x = torch.randn((n, d), generator=gen, device=dev)
        idx, q, cnt, err, dw = vq_train_stats(x, cb)
        ran = kernels_run(torch, lambda: vq_train_stats(x, cb), 3)
        if len(ran) != 3 or "vq_train_search_kernel" not in ran:
            raise AssertionError(
                f"vq_train {name}: expected the prep, search and statistics "
                f"launches, the log names {ran}")
        p_idx = vq_train_stats_reference(x, cb)[0]
        enc = vq_encode_nearest(x, cb)
        again = vq_train_stats(x, cb)
        torch.cuda.synchronize()
        il = idx.long()
        x64, e64 = x.double(), cb.double()
        x_sq, e_sq = (x64 * x64).sum(-1), (e64 * e64).sum(-1)
        dist = x_sq[:, None] + e_sq[None] - 2.0 * (x64 @ e64.T)  # (N, K) f64
        top2 = dist.topk(2, dim=-1, largest=False).values
        untied = (top2[:, 1] - top2[:, 0]) > VQ_GAP
        agree = idx == p_idx
        share = float(agree.float().mean())
        if share < 0.999 or not bool(agree[untied].all()):
            raise AssertionError(
                f"vq_train {name}: indices agree with the plain version on "
                f"{share:.5f} of rows, {int((~agree & untied).sum())} beyond "
                f"the gap")
        if not (torch.equal(idx, enc) and torch.equal(q, cb[il])):
            raise AssertionError(
                f"vq_train {name}: idx/q differ from vq_encode_nearest + gather")
        if not torch.equal(cnt, torch.bincount(il, minlength=k).float()):
            raise AssertionError(f"vq_train {name}: counts are not exact")
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float64, device=dev)  # noqa: E731
        dw64 = zeros(k, d).index_add_(0, il, x64)
        dw_lim = VQ_DW_RTOL * zeros(k, d).index_add_(0, il, x64.abs())
        err64 = zeros(k).index_add_(0, il, dist.gather(1, il[:, None])[:, 0].clamp_min(0))
        err_lim = VQ_ERR_RTOL * zeros(k).index_add_(0, il, x_sq + e_sq[il])
        dw_err, err_err = (dw.double() - dw64).abs(), (err.double() - err64).abs()
        if not (bool((dw_err <= dw_lim).all()) and bool((err_err <= err_lim).all())):
            raise AssertionError(
                f"vq_train {name}: dw or err beyond its limit (dw "
                f"{float((dw_err / dw_lim.clamp_min(1e-30)).max()):.3g}, err "
                f"{float((err_err / err_lim.clamp_min(1e-30)).max()):.3g} of it)")
        if not all(torch.equal(a, b) for a, b in zip((idx, q, cnt, err, dw), again)):
            raise AssertionError(f"vq_train {name}: two launches differ")
        dead = int((cnt == 0).sum())
        if name == "mostly_dead" and dead < k - 12:
            raise AssertionError(f"vq_train {name}: only {dead} dead codes")
        kernel = lambda: vq_train_stats(x, cb)  # noqa: E731
        ms = device_ms(torch, kernel, 100, label=f"vq_train_stats {name}")
        launch_ms = cuda_ms(torch, kernel, 200)
        plain_ms = device_ms(torch, lambda: vq_train_stats_reference(x, cb), 10)
        e_sq32 = (cb * cb).sum(-1)
        cublas_ms = device_ms(torch, lambda: torch.addmm(
            e_sq32, x, cb.T, alpha=-2.0).argmin(1), 100)
        # x in; idx, q out; codebook in; cnt, err, dw out
        nbytes = n * d * 4 + n * 4 + n * d * 4 + k * d * 4 + 2 * k * 4 + k * d * 4
        ops = 2 * n * k * d + 2 * k * d + 2 * n * k + 2 * n * d + n * d
        bound_ms, bound_by = bound(nbytes, SPLIT_TF32_PRODUCTS * 2 * n * k * d, "tf32")
        f32_bound_ms = bound(nbytes, ops, "float32")[0]
        err_max = float(max(dw_err.max(), err_err.max()))
        log(f"vq_train_stats {name} float32 N={n} K={k} D={d}: agree={share:.5f} "
            f"dead codes {dead}; idx/q equal vq_encode_nearest + gather, cnt "
            f"exact, repeat bitwise; max_abs_err dw={float(dw_err.max()):.3g} "
            f"err={float(err_err.max()):.3g} (limits {VQ_DW_RTOL} x sum|x|, "
            f"{VQ_ERR_RTOL} x sum(|x|^2+|e|^2); worst used "
            f"{float((dw_err / dw_lim.clamp_min(1e-30)).max()):.3g}, "
            f"{float((err_err / err_lim.clamp_min(1e-30)).max()):.3g}) "
            f"kernels {', '.join(ran)} | "
            f"kernel_ms={ms:.5f} back_to_back_ms={launch_ms:.5f} "
            f"plain_ms={plain_ms:.5f} library_ms=null "
            f"cublas_route_ms={cublas_ms:.5f} (search only; kernel/route "
            f"{ms / cublas_ms:.4f}) | bound_us={bound_ms * 1e3:.4f} ({bound_by}; "
            f"{SPLIT_TF32_PRODUCTS} TF32 products at the TF32 peak), on the CUDA "
            f"cores at the f32 peak {f32_bound_ms * 1e3:.4f}")
        rec = dict(max_abs_err=err_max, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None, cublas_route_ms=cublas_ms)
        if records is not None:
            records[name] = rec
        if name == "train":
            record = rec
    for n, k, d in ties:
        x, cb, rows, want = vq_tie_case(torch, dev, n, torch.float32, k, d)
        name = f"vq_train ties N={n} K={k} D={d}"
        idx, q, cnt, _, _ = vq_train_stats(x, cb)
        check_vq_ties(torch, name, idx, rows, want)
        check_vq_ties(torch, f"{name} (plain version)",
                      vq_train_stats_reference(x, cb)[0], rows, want)
        il = idx.long()
        if not (torch.equal(idx, vq_encode_nearest(x, cb)) and torch.equal(q, cb[il])
                and torch.equal(cnt, torch.bincount(il, minlength=cb.shape[0]).float())):
            raise AssertionError(
                f"{name}: idx/q/cnt differ from vq_encode_nearest, its gather "
                f"and its counts")
        log(f"{name}: {rows.numel() - 2} tied rows took the lower code, 2 "
            f"all-NaN rows code 0; idx equal vq_encode_nearest, q its gather, "
            f"cnt exact")
    return record


def check_flash(torch, dev, depth=SPARSE_MODEL["depth"]):
    """The three flash kernels against their plain versions at the sparse
    trainer's shape (B=16, H=8, N=1,024, D=64, bf16), the evaluation's (B=8,
    f32, as the sweep runs the f32 masters), a ragged N, and D=128 in bf16
    and f32. q, k and v are the head views of one fused (B, N, 3 * H * D)
    tensor, as DenseAttention hands them over. Each kernel is fed the same
    inputs as its plain version (the operands in their own dtype, so that
    both round P and dS to bf16 at the same points, and the kernels' own
    out, lse and delta), and must repeat bitwise. In bf16, out must lie
    within FWD_BF16_TOL x max |out| and be at least FWD_BF16_EQUAL bitwise
    equal, dq, dk and dv within FLASH_BWD_BF16_TOL x max |x| and at least
    FLASH_BWD_BF16_EQUAL bitwise equal, which a kernel that rounds P or dS
    elsewhere fails. The forward that runs must be the bf16 or the
    split-TF32 tensor-core kernel, as the dtype says. Logs each kernel's TFLOP/s (4, 6 and 8 B H N^2 D
    operations; the bf16 forward executes 6, Q K^T twice; the f32 forward
    3 x 4, three TF32 products for each f32 one, whose bound is restated
    at the TF32 peak beside the CUDA cores' f32 one). Returns {kernel:
    record} at the training shape, and under "flash_fwd_eval" the f32
    forward's record at the evaluation sweep's shape."""
    import torch.nn.functional as F

    from world_modelz_tpu_torch.kernels import (
        _build,
        flash_attention_fwd,
        flash_bwd_dkv,
        flash_bwd_dq,
    )
    from world_modelz_tpu_torch.models.attention import (
        dense_attention_bwd_dkv,
        dense_attention_bwd_dq,
        dense_attention_fwd,
    )

    cases = [  # name, (B, H, N, D), dtype
        ("train", (16, 8, 1024, 64), torch.bfloat16),
        ("eval", (8, 8, 1024, 64), torch.float32),
        ("ragged", (16, 8, 1000, 64), torch.bfloat16),
        ("d128_bf16", (8, 4, 1024, 128), torch.bfloat16),
        ("d128", (8, 4, 1024, 128), torch.float32),
        ("one_block", (8, 8, 512, 64), torch.bfloat16),  # P / l rounded
    ]
    for line in ptxas_summary(str(_build.BUILD_INFO.get("log", ""))):
        if "flash_fwd" in line:
            log(f"flash_fwd ptxas: {line}")
    gen = torch.Generator(device=dev).manual_seed(10)
    records = {}
    for name, (b, h, n, d), dtype in cases:
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=dev).to(dtype)
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, -1))
        g = torch.randn((b, n, h, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
        scale = d**-0.5
        out, lse = flash_attention_fwd(q, k, v, scale)
        dq, delta = flash_bwd_dq(q, k, v, out, g, lse, scale)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, scale)
        again = (*flash_attention_fwd(q, k, v, scale),
                 *flash_bwd_dq(q, k, v, out, g, lse, scale),
                 *flash_bwd_dkv(q, k, v, g, lse, delta, scale))
        p_out, p_lse = dense_attention_fwd(q, k, v, scale)
        p_dq, p_delta = dense_attention_bwd_dq(q, k, v, out, g, lse, scale)
        p_dk, p_dv = dense_attention_bwd_dkv(q, k, v, g, lse, delta, scale)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b_) for a, b_ in zip(
                (out, lse, dq, delta, dk, dv), again)):
            raise AssertionError(f"flash {name}: two launches differ")
        ran = kernels_run(torch, lambda: flash_attention_fwd(q, k, v, scale))
        want = "flash_fwd_mma_kernel<" if dtype == torch.bfloat16 else "flash_fwd_tf32_kernel<"
        if len(ran) != 1 or not ran[0].startswith(want):
            raise AssertionError(f"flash {name}: the forward ran {ran}, not {want}...>")
        bf16 = dtype == torch.bfloat16
        fwd_tol = FWD_BF16_TOL if bf16 else F32_TOL
        bwd_tol = FLASH_BWD_BF16_TOL if bf16 else BWD_F32_TOL
        errs, equal = {}, {}
        for label, got, want, tol in (
                ("out", out, p_out, fwd_tol), ("lse", lse, p_lse, STAT_TOL),
                ("dq", dq, p_dq, bwd_tol), ("delta", delta, p_delta, STAT_TOL),
                ("dk", dk, p_dk, bwd_tol), ("dv", dv, p_dv, bwd_tol)):
            err = float((got.float() - want.float()).abs().max())
            scale_x = float(want.float().abs().max())
            rounded = bf16 and label not in ("lse", "delta")
            lim = tol * (scale_x if rounded else max(1.0, scale_x))
            errs[label] = err
            if not err <= lim:
                raise AssertionError(
                    f"flash {name} {dtype} {label}: max abs err {err} > {lim}")
            if rounded:
                need = FWD_BF16_EQUAL if label == "out" else FLASH_BWD_BF16_EQUAL
                equal[label] = float((got == want).float().mean())
                if not equal[label] >= need:
                    raise AssertionError(
                        f"flash {name} {dtype} {label}: {equal[label]:.4f} bitwise "
                        f"equal < {need}")
        del p_out, p_lse, p_dq, p_delta, p_dk, p_dv
        tname = str(dtype).replace("torch.", "")
        isz = qkv.element_size()
        elems = b * h * n * d
        work = b * h * n * n * d
        ops = {"flash_fwd": 4 * work, "flash_bwd_dq": 6 * work,
               "flash_bwd_dkv": 8 * work}
        # the f32 forward executes SPLIT_TF32_PRODUCTS TF32 products for
        # each f32 product: its bound is that work at the TF32 peak
        fwd_ops, fwd_type = ((ops["flash_fwd"], tname) if bf16 else
                             (SPLIT_TF32_PRODUCTS * ops["flash_fwd"], "tf32"))
        fwd_bytes = 4 * elems * isz + b * h * n * 4
        bounds = {  # (bytes in and out, products), each input read once
            "flash_fwd": bound(fwd_bytes, fwd_ops, fwd_type),
            "flash_bwd_dq": bound(6 * elems * isz + 2 * b * h * n * 4,
                                  ops["flash_bwd_dq"], tname),
            "flash_bwd_dkv": bound(6 * elems * isz + 2 * b * h * n * 4,
                                   ops["flash_bwd_dkv"], tname),
        }
        ms = {
            "flash_fwd": device_ms(torch, lambda: flash_attention_fwd(q, k, v, scale), 20),
            "flash_bwd_dq": device_ms(
                torch, lambda: flash_bwd_dq(q, k, v, out, g, lse, scale), 10),
            "flash_bwd_dkv": device_ms(
                torch, lambda: flash_bwd_dkv(q, k, v, g, lse, delta, scale), 10),
        }
        b2b = cuda_ms(torch, lambda: flash_attention_fwd(q, k, v, scale), 20)
        plain_ms = {
            "flash_fwd": device_ms(torch, lambda: dense_attention_fwd(q, k, v, scale), 3),
            "flash_bwd_dq": device_ms(torch, lambda: dense_attention_bwd_dq(
                q, k, v, out, g, lse, scale), 3),
            "flash_bwd_dkv": device_ms(torch, lambda: dense_attention_bwd_dkv(
                q, k, v, g, lse, delta, scale), 3),
        }
        # library yardstick: SDPA forward, and forward + backward, on the
        # same views
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, scale=scale)

        with torch.no_grad():
            lib_fwd = device_ms(torch, sdpa, 10)
        lib_all = device_ms(
            torch, lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), g), 10)
        lib = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_all - lib_fwd,
               "flash_bwd_dkv": lib_all - lib_fwd}
        log(f"flash {name} {tname} (B, H, N, D)={(b, h, n, d)}: max_abs_err "
            + " ".join(f"{key}={val:.3g}" for key, val in errs.items())
            + f" (tol fwd {fwd_tol}, bwd {bwd_tol}, stats {STAT_TOL}, x max(1, "
            f"max|x|){'; bf16 out and grads x max|x|' if bf16 else ''})"
            + "".join(f" {key} {val:.4f} bitwise equal" for key, val in equal.items())
            + "; repeat bitwise | " + " ".join(
                f"{key}: kernel_ms={ms[key]:.5f} "
                f"({ops[key] / ms[key] / 1e9:.2f} TFLOP/s) plain_ms={plain_ms[key]:.5f} "
                f"bound_us={bounds[key][0] * 1e3:.4f} ({bounds[key][1]})"
                for key in ms)
            + (f" | fwd executes 6 B H N^2 D: {6 * work / ms['flash_fwd'] / 1e9:.2f} "
               "TFLOP/s" if bf16 else
               f" | fwd executes {SPLIT_TF32_PRODUCTS} x 4 B H N^2 D in TF32: "
               f"{fwd_ops / ms['flash_fwd'] / 1e9:.2f} TFLOP/s, bound at the TF32 peak "
               f"{bounds['flash_fwd'][0] * 1e3:.4f} us, on the CUDA cores at the f32 peak "
               f"{bound(fwd_bytes, ops['flash_fwd'], tname)[0] * 1e3:.4f} us; kernel/SDPA "
               f"{ms['flash_fwd'] / lib_fwd:.4f}")
            + f" | fwd kernel {ran[0]}"
            + f" | fwd back_to_back_ms={b2b:.5f} | SDPA fwd library_ms="
            f"{lib_fwd:.5f}, fwd+bwd {lib_all:.5f} | {depth} launches of each "
            f"per train step")
        if name == "train":
            for key, err_keys in (("flash_fwd", ("out", "lse")),
                                  ("flash_bwd_dq", ("dq", "delta")),
                                  ("flash_bwd_dkv", ("dk", "dv"))):
                records[key] = dict(
                    max_abs_err=max(errs[e] for e in err_keys), ms=ms[key],
                    plain_ms=plain_ms[key], bound_ms=bounds[key][0],
                    bound_by=bounds[key][1], library_ms=lib[key])
        if name == "eval":
            records["flash_fwd_eval"] = dict(
                max_abs_err=max(errs["out"], errs["lse"]), ms=ms["flash_fwd"],
                plain_ms=plain_ms["flash_fwd"], bound_ms=bounds["flash_fwd"][0],
                bound_by=bounds["flash_fwd"][1], library_ms=lib_fwd)
        del qkv, q, k, v, g, out, lse, dq, delta, dk, dv, again, qs, ks, vs
        torch.cuda.empty_cache()
    return records


def check_dense_tf32(torch, dev, launches=None, smi="", ladder=DENSE_LADDER,
                     cases=DENSE_CASES, others=DENSE_OTHER_CASES, denoiser=DENOISER):
    """The f32 dense layers' split-TF32 kernel (``kernels.dense_tf32``) at
    the served denoiser's shapes (DENSE_CASES at each size of ``ladder``)
    and at the other forwards' (DENSE_OTHER_CASES): against float64 within
    DENSE_TF32_TOL x max(1, |Y|) and its plain version within twice that,
    two launches bitwise equal, the launch log naming
    ``dense_tf32_kernel``; timed beside its bound (three TF32 products at
    the TF32 peak, or the bytes), its plain version, cuBLAS's f32
    ``F.linear`` (TF32 off; the library yardstick) and the route before the
    kernel (``F.linear`` and the GELU or the residual add as their own
    ops), with the launch's plan. Then the denoiser's forward at the
    largest size captured as a CUDA graph under ``torch.inference_mode``
    (4 depth launches of the kernel, the logits on cuBLAS, and ``depth``
    f32 local-3D launches captured; a replay bitwise the eager forward),
    and a bf16 training step with autograd (no launch of the kernel).
    Returns the records by case, the served forward's sums by size, and
    the b = 8 forward's sums at the top level."""
    import torch.nn.functional as F

    from world_modelz_tpu_torch.kernels import _build
    from world_modelz_tpu_torch.kernels import dense_tf32 as kd
    from world_modelz_tpu_torch.models import VqVideoDiffusionModel
    from world_modelz_tpu_torch.train.dispatch import capture

    gen = torch.Generator(device=dev).manual_seed(22)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def check_case(label, m, layers, epi):
        k = layers[0][1]
        xs = [rand(m, k)] + ([rand(m, k)] if len(layers) > 1 else [])
        ws = [rand(n, k, scale=k**-0.5) for n, _ in layers]
        bs = [None, None, rand(layers[2][0], scale=0.1)] if len(layers) > 1 else [
            rand(layers[0][0], scale=0.1)]
        problems = [(xs[min(i, len(xs) - 1)], ws[i], bs[i]) for i in range(len(layers))]
        res = rand(m, layers[0][0]) if epi == "residual" else None
        gelu = epi == "gelu"

        def kernel():
            if len(problems) > 1:
                return kd.dense_tf32_group(problems)
            x, w, bias = problems[0]
            return [kd.dense_tf32(x, w, bias, gelu=gelu, residual=res)]

        def plain():
            return [kd.dense_tf32_reference(x, w, bias, gelu=gelu, residual=res)
                    for x, w, bias in problems]

        def route():  # the parent's: cuBLAS f32, then the epilogue's own op
            ys = [F.linear(x, w, bias) for x, w, bias in problems]
            if gelu:
                return [F.gelu(ys[0], approximate="tanh")]
            return [ys[0] + res] if res is not None else ys

        got = kernel()
        if not all(torch.equal(a, c) for a, c in zip(got, kernel())):
            raise AssertionError(f"dense_tf32 {label}: two launches differ")
        ran = kernels_run(torch, kernel)
        if ran != ["dense_tf32_kernel"]:
            raise AssertionError(f"dense_tf32 {label}: the launch log names {ran}")
        err_f64 = err_plain = 0.0
        for y, want, (x, w, bias) in zip(got, plain(), problems):
            ref = x.double() @ w.double().T
            if bias is not None:
                ref = ref + bias.double()
            if gelu:
                ref = F.gelu(ref, approximate="tanh")
            if res is not None:
                ref = ref + res.double()
            scale = ref.abs().clamp(min=1.0)
            err_f64 = max(err_f64, float(((y.double() - ref).abs() / scale).max()))
            err_plain = max(err_plain, float(((y.double() - want.double()).abs()
                                              / scale).max()))
            del ref, scale, want
        if not (err_f64 <= DENSE_TF32_TOL and err_plain <= 2 * DENSE_TF32_TOL):
            raise AssertionError(
                f"dense_tf32 {label}: error {err_f64:.3g} against float64 (tol "
                f"{DENSE_TF32_TOL:.3g}), {err_plain:.3g} against the plain version "
                f"(tol {2 * DENSE_TF32_TOL:.3g})")
        ms = device_ms(torch, kernel, 200, label=f"dense_tf32 {label}")
        plain_ms = device_ms(torch, plain, 3)
        library_ms = device_ms(torch, lambda: [F.linear(x, w, bias)
                                               for x, w, bias in problems], 200)
        route_ms = device_ms(torch, route, 200)
        widths = [n for n, _ in layers]
        plan = kd.dense_tf32_plan(m, k, widths)
        ops = sum(3 * 2 * m * n * k for n in widths)
        nbytes = 4 * (len(xs) * m * k + sum(n * k + n + m * n for n in widths)
                      + (m * widths[0] if res is not None else 0))
        bound_ms, bound_by = bound(nbytes, ops, "tf32")
        log(f"dense_tf32 {label} M={m} (N, K)={layers[0]} x {len(layers)} "
            f"epilogue {epi}: err {err_f64:.3g} vs float64, {err_plain:.3g} vs plain "
            f"(tols {DENSE_TF32_TOL:.3g}, {2 * DENSE_TF32_TOL:.3g}), repeat bitwise | "
            f"kernel_ms={ms:.5f} "
            f"({ops / 3 / ms / 1e9:.2f} f32 TFLOP/s) plain_ms={plain_ms:.5f} "
            f"library_ms={library_ms:.5f} (cuBLAS f32 F.linear; kernel/library "
            f"{ms / library_ms:.4f}) route_ms={route_ms:.5f} | bound_us="
            f"{bound_ms * 1e3:.4f} ({bound_by}) | plan {plan}")
        return dict(m=m, layers=[list(x) for x in layers], epilogue=epi,
                    max_err_f64=err_f64, max_err_plain=err_plain, ms=ms,
                    plain_ms=plain_ms, library_ms=library_ms, route_ms=route_ms,
                    bound_ms=bound_ms, bound_by=bound_by, plan=plan,
                    tflops=ops / 3 / ms / 1e9)

    records, per_forward = {}, {}
    depth = denoiser["depth"]
    for b in ladder:
        for name, rows, layers, epi in cases:
            records[f"{name}_b{b}"] = check_case(f"{name} b={b}", b * rows, layers, epi)
        # a forward as it runs: depth x the kernel's four launches, the
        # logits on cuBLAS; before, cuBLAS and the epilogues' own ops
        sums = {}
        for key in ("ms", "plain_ms", "route_ms", "library_ms", "bound_ms"):
            sums[key] = sum(records[f"{name}_b{b}"][key] * depth
                            for name, *_ in cases if name != "logits")
            lkey = "library_ms" if key in ("ms", "route_ms") else key
            sums[key] += records[f"logits_b{b}"][lkey]
        by = {kind: sum(records[f"{name}_b{b}"]["bound_ms"] for name, *_ in cases
                        if records[f"{name}_b{b}"]["bound_by"] == kind)
              for kind in ("bytes", "operations")}
        sums["bound_by"] = max(by, key=by.get)  # the larger share of the bound
        per_forward[str(b)] = sums
        log(f"dense_tf32: one forward's dense layers at b={b} ({depth} layers on the "
            f"kernel, the logits on cuBLAS): {sums['ms']:.4f} ms, the route before it "
            f"{sums['route_ms']:.4f} ms (cuBLAS alone {sums['library_ms']:.4f}), plain "
            f"{sums['plain_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms")
    for name, m, layers, epi in others:
        records[name] = check_case(name, m, layers, epi)
        torch.cuda.empty_cache()

    # the served forward as a captured graph, and a training step without it
    b = max(ladder)
    torch.manual_seed(3)
    model = VqVideoDiffusionModel(**denoiser, device=dev)
    s, h, w = denoiser["data_shape"]
    tokens = torch.randint(0, denoiser["num_classes"] + 1, (b, s, h, w), device=dev)
    with torch.inference_mode():
        eager = model(tokens)
        cap = capture(lambda: model(tokens), dev)
        cap.graph.replay()
        torch.cuda.synchronize()
        same = torch.equal(cap.outputs, eager)
    want_w = {"dense_tf32": 4 * depth, "local3d_fwd": depth}
    names = dict(cap.kernels or {})
    f32 = sum(n for key, n in names.items() if key.startswith(F32_CLUSTER))
    if (not same or dict(cap.wrappers) != want_w or f32 != depth
            or names.get("dense_tf32_kernel") != 4 * depth or len(names) != 2):
        raise AssertionError(f"dense_tf32: the captured forward (bitwise {same}) noted "
                             f"{dict(cap.wrappers)} / {names}")
    del cap
    train = VqVideoDiffusionModel(**denoiser, device=dev, dtype=torch.bfloat16).train()
    before = _build.LAUNCHES["dense_tf32"]
    logits = train(tokens[:2])
    logits.float().square().mean().backward()
    torch.cuda.synchronize()
    if _build.LAUNCHES["dense_tf32"] != before:
        raise AssertionError("dense_tf32: a bf16 training step launched the kernel")
    log(f"dense_tf32: the f32 forward at b={b} captured {dict(want_w)} launches "
        f"({names}), a replay bitwise the eager forward; a bf16 training step with "
        f"autograd launched none; on {smi}")
    del model, train
    head = per_forward[str(b)]
    return dict(ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                route_ms=head["route_ms"], per=f"one b = {b} served forward's dense layers",
                max_err_f64=max(r["max_err_f64"] for r in records.values()),
                records=records, per_forward=per_forward)


def check_slice_parity(torch, dev, denoiser=DENOISER, tokenizer=TOKENIZER,
                       batch=2, backend="auto"):
    """The denoiser in f32 with attention ``backend`` on the card (kernel
    path) against the same weights on the CPU (plain path), and, unless
    ``tokenizer`` is None, the tokenizer. For another backend than "auto",
    also its bf16 logits on the card against the "auto" model's in bf16
    (BLOCK_BF16_LOGIT_TOL)."""
    from world_modelz_tpu_torch.models import VQAutoEncoder, VqVideoDiffusionModel
    from world_modelz_tpu_torch.ops.vq import codebook_distances

    torch.manual_seed(0)
    cpu = VqVideoDiffusionModel(**denoiser, backend=backend, device="cpu")
    card = VqVideoDiffusionModel(**denoiser, backend=backend, device=dev)
    card.load_state_dict(cpu.state_dict())
    k = denoiser["num_classes"]
    s, h, w = denoiser["data_shape"]
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, k, (batch, s, h, w), generator=gen)
    tokens[:, -1] = k  # the masked generation slot
    with torch.no_grad():
        want = cpu(tokens)
        got = card(tokens.to(dev)).cpu()
    err = float((got - want).abs().max())
    log(f"denoiser ({backend}) f32 logits {tuple(got.shape)}: max_abs_err={err:.3g} "
        f"(tol {LOGIT_TOL}, logits span {float(want.abs().max()):.3g})")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"denoiser ({backend}) logits differ by {err}")
    if backend != "auto":
        low = {}
        for name in ("auto", backend):
            m = VqVideoDiffusionModel(**denoiser, backend=name, device=dev,
                                      dtype=torch.bfloat16)
            m.load_state_dict(cpu.state_dict())
            with torch.no_grad():
                low[name] = m(tokens.to(dev)).float().cpu()
            del m
        span = max(1.0, float(want.abs().max()))
        diff = float((low[backend] - low["auto"]).abs().max())
        log(f"denoiser bf16 logits on the card, {backend} vs auto: max_abs_err="
            f"{diff:.3g} (tol {BLOCK_BF16_LOGIT_TOL} x {span:.3g}); each vs the "
            f"f32 CPU logits: {backend} "
            f"{float((low[backend] - want).abs().max()):.3g}, auto "
            f"{float((low['auto'] - want).abs().max()):.3g}")
        if not diff <= BLOCK_BF16_LOGIT_TOL * span:
            raise AssertionError(f"bf16 logits of {backend} and auto differ by {diff}")
    if tokenizer is None:
        return

    torch.manual_seed(1)
    tcpu = VQAutoEncoder(**tokenizer, device="cpu")
    tcard = VQAutoEncoder(**tokenizer, device=dev)
    tcard.load_state_dict(tcpu.state_dict())
    img = 2 ** tokenizer["downscale_steps"] * h
    frames = torch.rand((batch * s, img, img, tokenizer["in_channels"]),
                        generator=gen)
    want_t = tcpu.encode(frames)
    got_t = tcard.encode(frames.to(dev)).cpu()
    with torch.no_grad():
        latent = tcpu.encoder(frames.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    dist = codebook_distances(
        tcpu.vq.embedding.double(),
        latent.reshape(-1, 1, tokenizer["embedding_dim"]).double())[:, 0]
    top2 = dist.topk(2, dim=-1, largest=False).values
    untied = ((top2[:, 1] - top2[:, 0]) > VQ_GAP).reshape(want_t.shape)
    agree = got_t == want_t
    share = float(agree.float().mean())
    log(f"tokenizer encode {tuple(got_t.shape)}: tokens agree={share:.5f}, "
        f"{int(untied.sum())} of {untied.numel()} rows beyond the tie gap")
    if share < 0.999 or not bool(agree[untied].all()):
        raise AssertionError("tokenizer tokens differ beyond the tie gap")
    tok_in = want_t.clone()
    tok_in.view(-1)[0] = tokenizer["num_embeddings"]  # the mask token decodes
    want_p = tcpu.decode(tok_in)
    got_p = tcard.decode(tok_in.to(dev)).cpu()
    perr = float((got_p - want_p).abs().max())
    scale = max(1.0, float(want_p.abs().max()))
    log(f"tokenizer decode {tuple(got_p.shape)}: max_abs_err={perr:.3g} "
        f"(tol {PIXEL_RTOL} x {scale:.3g})")
    if not perr <= PIXEL_RTOL * scale:
        raise AssertionError(f"decoded pixels differ by {perr}")


def check_train_grads(torch, dev, launches, denoiser=DENOISER, batch=2,
                      backend="auto"):
    """The denoiser's parameter gradients of a cross-entropy loss on the
    card (f32, TF32 off, attention ``backend``, through the backward
    kernels) against the same weights on the CPU (plain versions). Every
    to_q / to_k / to_v (and to_out, where the model has it) weight must get
    a non-zero gradient."""
    import torch.nn.functional as F

    from world_modelz_tpu_torch.models import VqVideoDiffusionModel

    torch.manual_seed(4)
    cpu = VqVideoDiffusionModel(**denoiser, backend=backend, device="cpu").train()
    card = VqVideoDiffusionModel(**denoiser, backend=backend, device=dev).train()
    card.load_state_dict(cpu.state_dict())
    k = denoiser["num_classes"]
    s, h, w = denoiser["data_shape"]
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, k, (batch, s, h, w), generator=gen)
    masked = torch.rand((batch, h, w), generator=gen) < 0.5
    tokens[:, -1] = torch.where(masked, k, tokens[:, -1])
    target = torch.randint(0, k, (batch, h, w), generator=gen)
    before = dict(launches)
    for model, d in ((cpu, "cpu"), (card, dev)):
        logits = model(tokens.to(d)).float()
        F.cross_entropy(logits.reshape(-1, k), target.to(d).reshape(-1)).backward()
    ran = {key: launches[key] - before.get(key, 0) for key in launches}
    depth = denoiser["depth"]
    # the fused forward, then the unfused forward its backward rebuilds
    keys = ("local3d_fwd", "local3d_bwd_dq", "local3d_bwd_dkv") + (
        ("local3d_block",) if backend == "fused" else ())
    for key in keys:
        if dev.type == "cuda" and ran.get(key, 0) != depth:
            raise AssertionError(f"{key} ran {ran.get(key, 0)} times, not {depth}")
    want = dict(cpu.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in want.values())
    # per tensor: (max |CPU grad|, max abs err, limit)
    rows = {}
    for name, p in card.named_parameters():
        if p.grad is None:
            raise AssertionError(f"{name} has no gradient on the card")
        ref = want[name].grad
        mag = float(ref.abs().max())
        rows[name] = (mag, float((p.grad.cpu() - ref).abs().max()),
                      GRAD_TOL * max(mag, GRAD_FLOOR * scale))
        if name.endswith(("to_q.weight", "to_k.weight", "to_v.weight",
                          "to_out.0.weight")) and not bool(p.grad.abs().max() > 0):
            raise AssertionError(f"{name} has an all-zero gradient on the card")
    worst = max(rows, key=lambda n: rows[n][1] / rows[n][2])
    projs = ("to_q", "to_k", "to_v") + (
        ("to_out.0",) if any(n.endswith("to_out.0.weight") for n in rows) else ())
    log(f"denoiser ({backend}) gradients f32 card vs CPU ({len(rows)} tensors, "
        f"{depth} layers of {' + '.join(keys)}; limit {GRAD_TOL} x max(max|its "
        f"grad|, {GRAD_FLOOR} x {scale:.3g})): worst err/limit "
        f"{rows[worst][1] / rows[worst][2]:.3g} in {worst} (err "
        f"{rows[worst][1]:.3g}, max|grad| {rows[worst][0]:.3g}); every "
        f"{'/'.join(projs)} weight has a non-zero gradient")
    for proj in projs:
        names = [n for n in rows if n.endswith(f"{proj}.weight")]
        big = max(names, key=lambda n: rows[n][0])
        small = min(names, key=lambda n: rows[n][0])
        bad = max(names, key=lambda n: rows[n][1] / rows[n][2])
        log(f"  {proj}.weight x {len(names)}: max|grad| {rows[small][0]:.3g} "
            f"to {rows[big][0]:.3g} (largest: {big}, err {rows[big][1]:.3g}); "
            f"worst err/limit {rows[bad][1] / rows[bad][2]:.3g} in {bad} "
            f"(err {rows[bad][1]:.3g}, limit {rows[bad][2]:.3g})")
    if not rows[worst][1] <= rows[worst][2]:
        raise AssertionError(
            f"{worst}: gradient differs by {rows[worst][1]} > {rows[worst][2]}")


def seeded_tokenizer_checkpoint(torch, root, tokenizer=TOKENIZER, train=TRAIN):
    """A seeded tokenizer (random convs) whose codebook is its encoder's own
    latents of seeded MovingMNIST patches (a k-means-style init, so tokens
    vary with the content; a random codebook sends nearly every patch to
    one code and the task is trivial), saved as a port tokenizer checkpoint
    under ``root``; returns its path."""
    import numpy as np

    from world_modelz_tpu_torch.data import MovingMNIST
    from world_modelz_tpu_torch.models import VQAutoEncoder
    from world_modelz_tpu_torch.train import save_checkpoint

    torch.manual_seed(3)
    tok = VQAutoEncoder(**tokenizer, device="cpu")
    clips = MovingMNIST(seq_len=train["n_past"] + 1, image_size=train["image_size"],
                        num_digits=train["num_digits"], digit_size=train["digit_size"],
                        deterministic=False).sample_batch(np.random.default_rng(3), 16)
    with torch.no_grad():
        frames = torch.from_numpy(clips.reshape(-1, *clips.shape[2:]))
        lat = tok.encoder(frames.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        lat = lat.reshape(-1, tokenizer["embedding_dim"])
        pick = torch.randperm(lat.shape[0])[: tokenizer["num_embeddings"]]
        tok.vq.embedding[0] = lat[pick] + 0.01 * torch.randn_like(lat[pick])
    return save_checkpoint(
        os.path.join(root, "tokenizer"), 0, {"tokenizer": tok.state_dict()}, tokenizer)


# the kernel wrappers of the diffusion trainers' steps, and the prefix of
# the kernels each launches once per call, as the profiler names them (the
# VQ wrapper also launches vq_prep_kernel)
STEP_KERNEL_PREFIX = {"local3d_fwd": "local3d_fwd", "local3d_bwd_dq": "local3d_bwd_dq",
                      "local3d_bwd_dkv": "local3d_bwd_dkv",
                      "local3d_block": "local3d_block", "vq_encode": "vq_encode_kernel",
                      "flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq",
                      "flash_bwd_dkv": "flash_bwd_dkv"}
WARMUPS = 2  # eager calls of a step program before its capture (train/dispatch.py)


def graph_kernel_counts(prof, captured, replays):
    """The profile's kernel instances against a step graph's captured
    launches x ``replays``: by wrapper (kernel name prefix), and by kernel
    name where the launch log named every launch of the capture. Returns
    (seen, want)."""
    import re

    seen = dict.fromkeys(captured.wrappers, 0)
    for e in device_kernels(prof):
        m = re.search(r"(\w+)(?:<[^()]*>)?\(", e.key)
        for w in seen:
            if m and m.group(1).startswith(STEP_KERNEL_PREFIX[w]):
                seen[w] += e.count
    want = {w: n * replays for w, n in captured.wrappers.items()}
    if captured.kernels is not None:
        names = kernel_counts(prof, captured.kernels)
        seen.update({f"kernel {k}": n for k, n in names.items()})
        want.update({f"kernel {k}": n * replays for k, n in captured.kernels.items()})
    return seen, want


def profile_steps(torch, label, run, n, wall_s, captured=None) -> dict:
    """``run()`` (``n`` steps) once under torch.profiler, host and device:
    device ms a step, the busy share of ``wall_s`` (the unprofiled wall of
    the same ``n`` steps) and the host's launch calls a step (kernel and
    graph launches, copies, fills). With ``captured`` (a step graph), the
    profiler's kernel counts must equal captured x ``n`` (three tries: the
    profiler drops events now and then)."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        if captured is None:
            break
        seen, want = graph_kernel_counts(prof, captured, n)
        if seen == want:
            break
        log(f"{label}: profile {attempt + 1} counts {seen}, captured x replays {want}; "
            "profiling again")
    else:
        raise AssertionError(f"{label}: the profiler's kernel counts never matched "
                             "captured x replays")
    busy_ms = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3
    calls = collections.Counter()
    for e in prof.key_averages():
        if e.key in HOST_LAUNCH_CALLS:
            calls[e.key] += e.count
    rec = dict(device_ms_per_step=round(busy_ms / n, 4),
               busy=round(busy_ms / 1e3 / wall_s, 4),
               host_calls_per_step=round(sum(calls.values()) / n, 2))
    log(f"{label}: {n} steps, wall {wall_s * 1e3 / n:.3f} ms a step, device "
        f"{busy_ms / n:.3f} ms a step, busy share {rec['busy']:.4f}, host launch calls "
        f"{rec['host_calls_per_step']} a step {dict(calls)}"
        + (f"; the profiler counts {seen} = captured x replays" if captured else ""))
    return rec


def compare_dispatch_runs(torch, label, recs) -> None:
    """Runs of one trainer at several ``--steps_per_dispatch``: the losses
    and every tensor of the final checkpoints must be bitwise equal."""
    from world_modelz_tpu_torch.train import restore_checkpoint

    def bits(tree, out, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                bits(tree[k], out, f"{path}/{k}")
        elif isinstance(tree, torch.Tensor):
            t = tree.contiguous()
            out[path] = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
                t.element_size()]) if t.is_floating_point() else t

    first = recs[0]
    want = {}
    bits(restore_checkpoint(first["checkpoint"])[0], want)
    for rec in recs[1:]:
        got = {}
        bits(restore_checkpoint(rec["checkpoint"])[0], got)
        same = got.keys() == want.keys() and all(
            got[k].shape == want[k].shape and torch.equal(got[k], want[k]) for k in want)
        if rec["losses"] != first["losses"] or not same:
            raise AssertionError(
                f"{label}: k={rec['k']} differs from k={first['k']}: losses equal "
                f"{rec['losses'] == first['losses']}, checkpoint bitwise {same}")
    log(f"{label}: runs at steps_per_dispatch {[r['k'] for r in recs]} (in this order): "
        f"losses and final checkpoints ({len(want)} tensors) bitwise equal; steps/s "
        "over steps 11-60 " + ", ".join(f"k={r['k']} {r['steps_per_s']:.4f}" for r in recs)
        + "; ready-step busy " + ", ".join(f"k={r['k']} {r.get('busy', math.nan)}"
                                          for r in recs)
        + "; host launch calls a step " + ", ".join(
            f"k={r['k']} {r.get('host_calls_per_step', math.nan)}" for r in recs))


def drive_training(torch, dev, launches, smi, train=TRAIN, tokenizer=TOKENIZER,
                   root=os.path.join(HERE, "build", "smoke"), backend="auto",
                   steps_per_dispatch=1, timing_report=False, device_composite=False):
    """The trainer at full width (``cli.video_diffusion.train``) with the
    denoiser's attention ``backend`` and ``steps_per_dispatch``, from a
    seeded tokenizer checkpoint; with ``device_composite`` the batches are
    trajectories, composited inside the step graph. On the card the step is one CUDA graph,
    replayed at every k: its launches must be exactly the step's kernels x
    the steps, with only the capture's warm-up calls and the token-grid
    probe's encode launched outside it. Then (on the card) the ready step
    as the loop runs it, under the profiler (``profile_steps``: busy share,
    host launch calls a step, the kernel counts held to captured x
    replays); ``check_step_program`` profiles the eager step.
    Returns (the launch counts of the run, eager and replayed, and the run's
    record: k, steps/s over steps 11-60, losses, the final checkpoint)."""
    import shutil

    from world_modelz_tpu_torch.cli.video_diffusion import VideoDiffusionConfig
    from world_modelz_tpu_torch.cli.video_diffusion import train as run_train
    from world_modelz_tpu_torch.train import latest_checkpoint

    shutil.rmtree(root, ignore_errors=True)
    tok_path = seeded_tokenizer_checkpoint(torch, root, tokenizer, train)
    cfg = VideoDiffusionConfig(
        **train, decoder_model=tok_path, output_dir=os.path.join(root, "run"),
        platform="" if dev.type == "cuda" else dev.type,
        steps_per_dispatch=steps_per_dispatch, device_composite=device_composite,
        # the timing report's device probes every 20 steps (default 200)
        timing_report=os.path.join(root, "timing.json") if timing_report else "",
        probe_interval=20 if timing_report else 200)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    # the trainer as a user runs it: PyTorch's default TF32 settings (cuDNN
    # convolutions in TF32, matmuls in full f32), not the parity phases' off
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    label = (f"training ({backend}, k={steps_per_dispatch}"
             + (", device_composite" if device_composite else "") + ")")
    rec = {"k": steps_per_dispatch, "data": "composite" if device_composite else "pixels"}
    try:
        launches.clear()
        t0 = time.perf_counter()
        result = run_train(cfg, backend=backend)
        wall = time.perf_counter() - t0
        eager = dict(launches)
        program = result.program
        graph, replays = dict(program.launches), program.replays
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else math.nan
        if on_card:
            rec.update(profile_dispatch(torch, dev, cfg, result, label))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    steps = cfg.max_steps
    losses = [h[1] for h in result.history]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"losses not finite or missing: {losses}")
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    if not last < first:
        raise AssertionError(f"loss did not fall: first 10 {first}, last 10 {last}")
    if result.rejected:
        raise AssertionError(f"{result.rejected} steps rejected")
    ckpt = latest_checkpoint(cfg.output_dir)
    if ckpt != os.path.join(cfg.output_dir, f"step_{steps:07d}"):
        raise AssertionError("the final checkpoint did not land")
    # per step: every layer's forward and both backward passes, one encode
    # (the fused forward's backward reruns the unfused forward); all from
    # the graph. Outside it: the capture's warm-up calls and the token-grid
    # probe's encode before the first step.
    fused = backend == "fused"
    per_step = {"local3d_fwd": cfg.depth, "local3d_bwd_dq": cfg.depth,
                "local3d_bwd_dkv": cfg.depth, "vq_encode": 1,
                "local3d_block": cfg.depth if fused else 0}
    want_graph = {k: n * steps for k, n in per_step.items() if n}
    want_eager = {k: n * WARMUPS + (k == "vq_encode") for k, n in per_step.items() if n}
    if on_card and (graph != want_graph or eager != want_eager or replays != steps):
        raise AssertionError(
            f"{label}: the graph launched {graph} in {replays} replays, expected "
            f"{want_graph}; outside it {eager}, expected {want_eager}")
    counts = {k: eager.get(k, 0) + graph.get(k, 0) for k in set(eager) | set(graph)}
    t = {h[0]: h[4] for h in result.history}
    window = steps - 10  # steps 11..60: the capture and warm-up excluded
    sps = window / (t[steps] - t[10])
    rec.update(steps_per_s=sps, losses=losses, checkpoint=ckpt, graph=graph,
               per_step={k: n for k, n in per_step.items() if n},
               capture_s=program.capture_seconds, peak_gib=peak)
    log(f"{label}: train_step/m3_b64_g8_full, token grid {result.token_shape}, "
        f"{steps} steps in {wall:.3f} s (capture {program.capture_seconds:.3f} s); loss "
        f"first-10 mean {first:.5f} -> last-10 mean {last:.5f}; losses every 10: "
        + " ".join(f"{x:.4f}" for x in losses[::10]))
    log(f"{label}: steps 11-{steps}: {sps:.4f} steps/s = "
        f"{sps * cfg.batch_size:.3f} samples/s ({1e3 / sps:.3f} ms/step); "
        f"peak device memory {peak:.3f} GiB; rejected {result.rejected}; "
        f"launches replayed from the step graph (captured x replays) {graph}, "
        f"outside it {eager} (the capture's {WARMUPS} warm-up steps, the token-grid "
        f"probe's encode); TF32: matmul off, cuDNN on (PyTorch's defaults); on {smi}")
    if timing_report:
        with open(cfg.timing_report) as f:
            report = json.load(f)
        rec["timing"] = {k: report.get(k) for k in (
            "window_steps", "steps_per_sec", "breakdown_pct", "probe", "reconciliation",
            "h2d")}
        rec["data_wait_pct"] = (report.get("breakdown_pct") or {}).get("data")
        log(f"{label}: timing report {cfg.timing_report}: " + json.dumps(rec["timing"]))
    return counts, rec


def training_turns(torch, dev, launches, smi, k, switch_interval=None) -> list:
    """``drive_training`` at ``steps_per_dispatch`` k on pixels and on
    trajectories composited in the step graph, in turns (pixels, composite,
    composite, pixels), each with its timing report; at k = 1 the first
    run's root is ``build/smoke``, whose checkpoint the rollout, evaluation
    and serving phases read. With ``switch_interval`` (seconds) the
    interpreter's thread switch interval (5 ms by default) is set to it for
    these runs, a diagnostic of the prefetch thread's Python holding the GIL
    against the loop's feed and launch (``main`` runs the default).
    Returns each run's (launch counts, record) in run order."""
    old = sys.getswitchinterval()
    if switch_interval:
        sys.setswitchinterval(switch_interval)
    runs = []
    try:
        for i, composite in enumerate((False, True, True, False)):
            first = k == 1 and i == 0 and not switch_interval
            runs.append(drive_training(
                torch, dev, launches, smi, steps_per_dispatch=k, timing_report=True,
                device_composite=composite, root=os.path.join(
                    HERE, "build", "smoke" if first else f"smoke_k{k}_{i}")))
    finally:
        sys.setswitchinterval(old)
    log(f"training at k = {k} in turns (pixels, composite, composite, pixels; thread switch "
        f"interval {sys.getswitchinterval() if not switch_interval else switch_interval} s): "
        + "; ".join(
            f"{r['data']}: {r['steps_per_s']:.4f} steps/s over steps 11-60, ready-step busy "
            f"{r.get('busy')}, {r.get('host_calls_per_step')} host launch calls a step, "
            f"timing report {(r['timing'] or {}).get('breakdown_pct')}, "
            f"{r.get('batch_bytes')} bytes a batch (h2d "
            f"{(r['timing'].get('h2d') or {}).get('mb_per_batch')} MB), launches "
            f"{r['graph']} = captured x 60 replays, device {r.get('device_ms_per_step')} "
            f"ms a step" for _, r in runs) + f"; on {smi}")
    return runs


def profile_dispatch(torch, dev, cfg, result, label, n=20) -> dict:
    """The trained state's step graph run as the trainer's loop runs it
    (each step: its batch and draws into the static inputs, a replay; one
    stats read per dispatch of k), its batches made and shipped beforehand
    as the prefetch thread ships them (the host ms of making one, timed):
    the unprofiled wall of ``n`` steps, then ``profile_steps`` of ``n``
    more."""
    from world_modelz_tpu_torch.cli.video_diffusion import build_clip_fn, draw_step, step_batch
    from world_modelz_tpu_torch.data import batch_to

    program, k = result.program, max(1, cfg.steps_per_dispatch)
    io = program.inputs
    clip_fn, _ = build_clip_fn(cfg, 9)
    t0 = time.perf_counter()
    host = [clip_fn(cfg.batch_size) for _ in range(4)]
    data_ms = (time.perf_counter() - t0) / len(host) * 1e3
    batch_bytes = sum(x.nbytes for x in (host[0].values() if isinstance(host[0], dict)
                                          else [host[0]]))
    data = [step_batch(batch_to(x, dev)) for x in host]
    gen = torch.Generator(device=dev).manual_seed(9)
    n_tok = result.token_shape[1] * result.token_shape[2]
    buckets = result.state.sampler.weights.shape[0]
    k_codes = result.state.model.num_classes

    def run(count):
        done = 0
        while done < count:
            m = min(k, count - done)
            io.start()
            for i in range(m):
                for key, v in data[(done + i) % len(data)].items():
                    io.tensors[key].copy_(v)
                draw_step(gen, cfg.batch_size, n_tok, buckets, k_codes, out=io.draws)
                program()
            io.read(m)
            done += m

    run(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    wall = time.perf_counter() - t0
    log(f"{label}: the data source makes a batch of {cfg.batch_size} clips in "
        f"{data_ms:.3f} ms on the host (alone, the loop idle), {batch_bytes:,} bytes")
    return dict(profile_steps(torch, f"{label}: the ready step from its graph",
                              lambda: run(n), n, wall, program.captured),
                data_ms=round(data_ms, 3), batch_bytes=batch_bytes)


COMPOSITE_ULPS = 1  # composite_clips card vs CPU, f32 units in the last place


def f32_ulps(np, a, b) -> int:
    """The largest distance between two f32 arrays in units in the last
    place (finite values of one sign, as frames in [0, 1] are)."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


def host_batch_ms(fn, n=10) -> float:
    """Median host ms of ``n`` calls of ``fn`` (one warm-up first)."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[n // 2] * 1e3


def check_composite(torch, dev, smi, train=TRAIN) -> dict:
    """On-device compositing (``data/device_composite.py``) at the m3
    production shape (B = 64, two digits of 24, 6 frames, 64 x 64):
    ``composite_clips`` on the card against the CPU for uint8 and float
    sprites, half the clips at random positions that run off every edge of
    the canvas (within COMPOSITE_ULPS); the card's frames of a
    ``sample_batch_traj`` batch equal to the host compositor's clips of the
    same draws quantized to 1/255 wherever no two sprites overlap; its
    device time beside its bytes bound. Then the host data layer on this
    card's host, alone: ms a batch for ``sample_batch_u8`` on the compiled
    and the numpy compositor, and for ``sample_batch_traj``; the compiled
    one must be what the trainers run (``native.backend()``)."""
    import numpy as np

    from world_modelz_tpu_torch.data import MovingMNIST, composite_clips, native

    if native.backend() != "compiled":
        raise AssertionError(f"the host compositor runs its numpy path: {native.failure()}")
    b, img, k = train["batch_size"], train["image_size"], train["digit_size"]
    ds = MovingMNIST(seq_len=train["n_past"] + 1, image_size=img,
                     num_digits=train["num_digits"], digit_size=k, deterministic=False)
    traj = ds.sample_batch_traj(np.random.default_rng(21), b)
    host = ds.sample_batch_u8(np.random.default_rng(21), b).astype(np.float32) / 255.0
    rng = np.random.default_rng(22)
    off = traj["pos"].copy()
    off[: b // 2] = rng.integers(-k - 6, img + 6, off[: b // 2].shape)
    floats = (rng.random(traj["sprites"].shape, dtype=np.float32) * 0.7).astype(np.float32)
    rec = {}
    for name, sprites in (("uint8", traj["sprites"]), ("float32", floats)):
        cpu = composite_clips(torch.from_numpy(sprites), torch.from_numpy(off), img).numpy()
        card = composite_clips(torch.from_numpy(sprites).to(dev), torch.from_numpy(off).to(dev),
                               img).cpu().numpy()
        ulps = f32_ulps(np, card, cpu)
        if card.shape != (b, traj["pos"].shape[2], img, img, 1) or ulps > COMPOSITE_ULPS:
            raise AssertionError(f"composite_clips ({name}): card vs CPU {ulps} ulps "
                                 f"(limit {COMPOSITE_ULPS}), shape {card.shape}")
        rec[f"{name}_ulps"] = ulps
        rec[f"{name}_bitwise"] = bool(np.array_equal(card, cpu))
    sprites, pos = (torch.from_numpy(traj[key]).to(dev) for key in ("sprites", "pos"))
    card = composite_clips(sprites, pos, img).cpu().numpy()[..., 0]
    cover = np.zeros(card.shape, np.int32)
    for i, j, t in np.ndindex(*traj["pos"].shape[:3]):
        y, x = traj["pos"][i, j, t]
        cover[i, t, max(y, 0): y + k, max(x, 0): x + k] += 1
    alone = cover <= 1
    if not np.array_equal(card[alone], host[..., 0][alone]) or \
            np.abs(card - host[..., 0]).max() > 2 / 255:
        raise AssertionError("composite_clips differs from the host clips quantized to 1/255")
    nbytes = sum(traj[key].nbytes for key in traj)
    out_bytes = card.size * 4
    rec.update(device_ms=device_ms(torch, lambda: composite_clips(sprites, pos, img), 20,
                                   label="composite_clips"),
               bound_ms=(nbytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
               traj_bytes=nbytes, pixel_bytes=int(b * card[0].size), overlap_pixels=int(
                   (~alone).sum()))
    gen = np.random.default_rng(23)
    rec["u8_compiled_ms"] = host_batch_ms(lambda: ds.sample_batch_u8(gen, b))
    rec["traj_ms"] = host_batch_ms(lambda: ds.sample_batch_traj(gen, b))
    os.environ["WMZ_DISABLE_NATIVE"] = "1"
    try:
        if native.reload() != "numpy":
            raise AssertionError("WMZ_DISABLE_NATIVE did not select the numpy path")
        rec["u8_numpy_ms"] = host_batch_ms(lambda: ds.sample_batch_u8(gen, b))
    finally:
        del os.environ["WMZ_DISABLE_NATIVE"]
        if native.reload() != "compiled":
            raise AssertionError(f"the compiled compositor did not come back: {native.failure()}")
    log(f"composite_clips at B={b}, 2 digits of {k}, {traj['pos'].shape[2]} frames, "
        f"{img}x{img}: card vs CPU uint8 {rec['uint8_ulps']} ulps (bitwise "
        f"{rec['uint8_bitwise']}), float32 {rec['float32_ulps']} ulps (bitwise "
        f"{rec['float32_bitwise']}), half the clips off the canvas' edges; equal to the host "
        f"clips quantized to 1/255 where no two sprites overlap ({rec['overlap_pixels']} "
        f"overlap pixels within 2/255); device {rec['device_ms'] * 1e3:.3f} us against a "
        f"bytes bound of {rec['bound_ms'] * 1e3:.3f} us; a batch ships {nbytes:,} bytes "
        f"against {rec['pixel_bytes']:,} of uint8 pixels")
    log(f"host data layer (this card's host, the loop idle), ms a batch of {b}: "
        f"sample_batch_u8 compiled {rec['u8_compiled_ms']:.3f}, numpy "
        f"{rec['u8_numpy_ms']:.3f}; sample_batch_traj {rec['traj_ms']:.3f}; "
        f"native.backend() {native.backend()}; on {smi}")
    return rec


def time_sparse_source(torch=None, dev=None, train=SPARSE_TRAIN, n=16) -> dict:
    """The sparse trainer's synthetic source (``sparse_diffusion.build_sampler``'s:
    ``train``'s frame size, 200 frames a trajectory) on this card's host,
    median ms a trajectory over its ``n`` trajectories: ``load_frames``
    whole (the motion loop, then the render), ``render_trajectory`` alone
    on the inputs ``load_frames`` gave it, and the difference (the motion
    loop, the same on both paths), on the compiled compositor and on its
    numpy path, so the compiled render and the motion loop are timed
    apart. In a package without ``data/native.py`` (an earlier tree, under
    ``chip_ab.py --phase time_sparse_source --phase-here``) only the numpy
    path exists, and it alone is timed. Gates nothing."""
    import importlib

    from world_modelz_tpu_torch.data import trajectory

    try:
        native = importlib.import_module("world_modelz_tpu_torch.data.native")
    except ImportError:
        native = None
    frames = max(3 * train["S"] * (train["skip_frames"] + 1), 200)
    src = trajectory.SyntheticTrajectorySource(num_trajectories=n, traj_frames=frames,
                                               frame_size=train["image_size"])
    names = src.trajectory_names()
    render = trajectory.render_trajectory
    inputs = []

    def keep(*args):
        inputs.append(args)
        render(*args)

    trajectory.render_trajectory = keep
    try:
        for name in names:
            for _ in src.load_frames(name):
                pass
    finally:
        trajectory.render_trajectory = render

    def timed(path):
        """Median ms of load_frames, of the render alone, and of their
        difference, over the trajectories."""
        loads, renders = [], []
        for i, name in enumerate(names):
            t0 = time.perf_counter()
            for _ in src.load_frames(name):
                pass
            t1 = time.perf_counter()
            render(*inputs[i])
            loads.append(t1 - t0)
            renders.append(time.perf_counter() - t1)
        for key, xs in (("load", loads), ("render", renders),
                        ("motion", [a - b for a, b in zip(loads, renders)])):
            rec[f"{key}_{path}_ms"] = sorted(xs)[n // 2] * 1e3

    rec = {}
    paths = ["compiled", "numpy"] if native is not None else ["numpy"]
    for path in paths:
        if native is None:
            timed(path)
            continue
        if path == "numpy":
            os.environ["WMZ_DISABLE_NATIVE"] = "1"
        try:
            if native.reload() != path:
                raise AssertionError(f"the compositor runs {native.backend()}, not {path}")
            timed(path)
        finally:
            os.environ.pop("WMZ_DISABLE_NATIVE", None)
            native.reload()
    log(f"sparse source on this card's host, median ms a trajectory of {frames} frames of "
        f"{train['image_size']}x{train['image_size']} over {n}: " + ", ".join(
            f"{path}: load_frames {rec[f'load_{path}_ms']:.4f}, render_trajectory "
            f"{rec[f'render_{path}_ms']:.4f}, the rest (the motion loop) "
            f"{rec[f'motion_{path}_ms']:.4f}" for path in paths)
        + ("" if native is not None else " (a package without data/native.py)"))
    return rec


def sparse_source_turns(torch, dev, launches, smi) -> list:
    """The sparse trainer (``drive_sparse_training`` at k = 1, without its
    evaluation) with its source rendered by the compiled compositor and by
    its numpy path, in turns (compiled, numpy, numpy, compiled): what the
    compiled ``render_trajectory`` moves end to end. Not run by ``main``;
    gates nothing beyond ``drive_sparse_training``'s own. Returns the runs'
    records."""
    from world_modelz_tpu_torch.data import native

    recs = []
    for i, path in enumerate(("compiled", "numpy", "numpy", "compiled")):
        if path == "numpy":
            os.environ["WMZ_DISABLE_NATIVE"] = "1"
        try:
            if native.reload() != path:
                raise AssertionError(f"the compositor runs {native.backend()}, not {path}")
            rec = drive_sparse_training(torch, dev, launches, smi, full=False, root=os.path.join(
                HERE, "build", f"smoke_sparse_source_{i}"))[1]
        finally:
            os.environ.pop("WMZ_DISABLE_NATIVE", None)
            native.reload()
        recs.append(dict(rec, source=path))
    log("sparse training (k=1) in turns (compiled, numpy, numpy, compiled source): " + ", ".join(
        f"{r['source']} {r['steps_per_s']:.4f}" for r in recs) + f" steps/s over steps "
        f"11-60; on {smi}")
    return recs


def state_diffs(torch, a, b):
    """The tensors in which two diffusion trainer states (``TrainState``)
    are not bitwise equal: [(name, max |a - b|)]; empty when equal."""
    def named(st):
        return ([(f"opt.{k}", v) for k, v in st.optimizer.state_tensors().items()]
                + ([("ema", st.ema_flat)] if st.ema_flat is not None else [])
                + [("sampler.weights", st.sampler.weights),
                   ("sampler.counts", st.sampler.counts)]
                + [(f"model.{k}", v) for k, v in st.model.state_dict().items()])

    out = []
    for (name, x), (_, y) in zip(named(a), named(b)):
        if x.is_floating_point():
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
            same = torch.equal(x.contiguous().view(bits), y.contiguous().view(bits))
        else:
            same = torch.equal(x, y)
        if not same:
            out.append((name, float((x.double() - y.double()).abs().max())))
    return out


def check_step_program(torch, dev, smi, kind="video", backend="auto",
                       accumulation_steps=1, parity=3, timed=20,
                       root=os.path.join(HERE, "build", "smoke_step"), train=None,
                       device_composite=False, mesh=None, fsdp=False):
    """A trainer's step function (``step_body``) eagerly against its step
    program (``train.dispatch.StepProgram``: on the card one CUDA graph,
    replayed), at full width (``kind`` "video": train_step/m3_b64_g8_full
    with ``backend``, ``accumulation_steps`` and ``device_composite``
    (trajectory batches, composited inside the step); "sparse":
    train_sparse/s16_n1024_b16), from one seeded state, on the same batches
    and draws: after ``parity`` steps each, the losses, grad norms and
    flags, the parameters, Adam's moments and count (and accumulator), the
    EMA and the sampler must be bitwise equal. Then ``timed`` eager steps
    against ``timed`` replays (A B B A) and once more the two states
    bitwise, then both profiled (busy share, host launch calls a step, the
    graph's kernel counts held to captured x replays). With ``mesh`` (a
    data axis with a process group) the replayed state is on it, so its
    graph holds the step's collectives, while the eager state runs the same
    step without a group; ``fsdp`` shards both optimizers. Returns a
    record."""
    import shutil

    from world_modelz_tpu_torch.cli import sparse_diffusion as sd
    from world_modelz_tpu_torch.cli import video_diffusion as vd
    from world_modelz_tpu_torch.data import batch_to
    from world_modelz_tpu_torch.train.dispatch import step_inputs

    on_card = dev.type == "cuda"
    platform = "" if on_card else dev.type
    shutil.rmtree(root, ignore_errors=True)
    axis = (", a process group of one" if mesh is not None else "") + (", --fsdp" if fsdp else "")
    if kind == "video":
        train = train or TRAIN
        tok_path = seeded_tokenizer_checkpoint(torch, root, train=train)
        cfg = vd.VideoDiffusionConfig(**train, decoder_model=tok_path, platform=platform,
                                      accumulation_steps=accumulation_steps,
                                      device_composite=device_composite, fsdp=fsdp)
        tok, _ = vd.load_tokenizer(tok_path, dev)
        vd.tokenizer_inference_cast(tok)
        clip_fn, _ = vd.build_clip_fn(cfg, 7)
        data = [vd.step_batch(batch_to(clip_fn(cfg.batch_size), dev)) for _ in range(parity)]
        shape = (cfg.n_past + 1, *tok.token_grid_shape((cfg.image_size, cfg.image_size)))
        n_tok, codes = shape[1] * shape[2], tok.num_embeddings

        def new_model():
            return vd.make_model(cfg, shape, codes, dev, backend)

        def draw(gen, out=None):
            return vd.draw_step(gen, cfg.batch_size, n_tok, 100, codes, out=out)

        def body(state, x, draws):
            return vd.step_body(state, tok, x, cfg, draws)

        def empty_draws():
            return vd.StepDraws.empty(cfg.batch_size, n_tok, 100, dev)

        label = (f"step program train_step/m3_b64_g8_full ({backend}"
                 + (f", accumulation_steps {accumulation_steps}" if accumulation_steps > 1
                    else "") + (", device_composite" if device_composite else "") + ")")
    else:
        train = train or SPARSE_TRAIN
        tok_path = sparse_tokenizer_checkpoint(torch, root, train=train)
        cfg = sd.SparseDiffusionConfig(**train, decoder_model=tok_path, platform=platform,
                                       fsdp=fsdp)
        tok, _ = sd.load_tokenizer(tok_path, dev)
        sampler = sd.build_sampler(cfg)
        try:
            data = [{"x": sd.encode_batch(tok, torch.from_numpy(
                sampler.sample_batch(cfg.batch_size)).to(dev), (cfg.S, cfg.H, cfg.W))}
                for _ in range(parity)]
        finally:
            sampler.close()
        volume, codes = cfg.S * cfg.H * cfg.W, tok.num_embeddings

        def new_model():
            return sd.make_model(cfg, codes, dev)

        def draw(gen, out=None):
            return sd.draw_step(gen, cfg.batch_size, cfg.num_context, volume, 100, codes,
                                out=out)

        def body(state, x, draws):
            return sd.step_body(state, x["x"], cfg, draws)

        def empty_draws():
            return sd.StepDraws.empty(cfg.batch_size, cfg.num_context, volume, 100, dev)

        label = "step program train_sparse/s16_n1024_b16" + (
            f", {cfg.moe_experts} experts" if cfg.moe_experts else "")
    label += axis

    def new_state(mesh=None):
        torch.manual_seed(11)
        return vd.init_state(cfg, new_model(), mesh)

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        eager, graphed = new_state(), new_state(mesh)
        io = step_inputs({key: torch.empty_like(v) for key, v in data[0].items()},
                         empty_draws(), max(parity, timed))
        program = vd.step_program(graphed, io, lambda: body(graphed, io.tensors, io.draws))
        g_eager = torch.Generator(device=dev).manual_seed(5)
        g_graph = torch.Generator(device=dev).manual_seed(5)

        def eager_round(n):
            out = [body(eager, data[i % parity], draw(g_eager)) for i in range(n)]
            if on_card:
                torch.cuda.synchronize()
            return out

        def graph_round(n):
            io.start()
            for i in range(n):
                for key, v in data[i % parity].items():
                    io.tensors[key].copy_(v)
                draw(g_graph, io.draws)
                program()
            return io.read(n)

        def states_equal():
            return not state_diffs(torch, eager, graphed)

        want = torch.stack(eager_round(parity)).cpu()
        got_rows = graph_round(parity)
        got = io.stats[:parity].cpu()
        bits_equal = torch.equal(want.view(torch.int32), got.view(torch.int32))
        if not (bits_equal and states_equal()):
            raise AssertionError(
                f"{label}: {parity} replays differ from {parity} eager steps: stats "
                f"{want.tolist()} vs {got.tolist()}, state differs at "
                f"{state_diffs(torch, eager, graphed)}")
        rec = {"parity_steps": parity, "losses": [r[0] for r in got_rows]}
        if on_card:
            cap = program.captured
            rec.update(captured=dict(cap.wrappers), capture_s=round(program.capture_seconds, 4),
                       kernels=dict(cap.kernels) if cap.kernels is not None else None)
        log(f"{label}: {parity} replays == {parity} eager steps bitwise (losses "
            + " ".join(f"{r[0]:.6f}" for r in got_rows) + "; parameters, moments, count, "
            f"EMA, sampler); " + (f"captured {rec.get('captured')} in "
                                  f"{rec.get('capture_s')} s" if on_card else "on the CPU"))
        if timed and on_card:
            walls = {"eager": [], "graph": []}
            for name in ("eager", "graph", "graph", "eager"):
                t0 = time.perf_counter()
                (eager_round if name == "eager" else graph_round)(timed)
                walls[name].append((time.perf_counter() - t0) / timed)
            med = {k: sum(v) / len(v) for k, v in walls.items()}
            if not states_equal():
                raise AssertionError(f"{label}: after the timed rounds the states differ at "
                                     f"{state_diffs(torch, eager, graphed)}")
            log(f"{label}: {timed} eager steps vs {timed} replays, rounds E G G E: "
                f"eager {' '.join(f'{x * 1e3:.3f}' for x in walls['eager'])} ms a step, "
                f"replays {' '.join(f'{x * 1e3:.3f}' for x in walls['graph'])} ms a step "
                f"(replay / eager {med['graph'] / med['eager']:.4f}); the states still "
                f"bitwise equal after {parity + 2 * timed} steps each; on {smi}")
            # profiled last: a profile taken again (dropped events) runs more steps
            n_prof = 5
            rec["eager"] = profile_steps(torch, f"{label}: eager steps",
                                         lambda: eager_round(n_prof), n_prof,
                                         med["eager"] * n_prof)
            rec["graph"] = profile_steps(torch, f"{label}: replays",
                                         lambda: graph_round(n_prof), n_prof,
                                         med["graph"] * n_prof, program.captured)
            rec.update(eager_ms=round(med["eager"] * 1e3, 3),
                       graph_ms=round(med["graph"] * 1e3, 3))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return rec


def check_i3d(torch, dev, smi, root=os.path.join(HERE, "build", "smoke_i3d"),
              clips=(2, 16, 64, 64, 3), timed=(8, 16, 224, 224, 3)):
    """The I3D FVD network (``utils/fvd.py``) on seeded random weights (the
    default init with the BatchNorm statistics, scales and offsets drawn
    from a seed), written under ``root`` in the JAX package's .npz layout
    and read back by ``load_i3d``: the card against the CPU on ``clips``
    (TF32 off inside, features within FEATURE_RTOL x max |f|), the 224
    resize too; the ms of ``i3d_features`` on a ``timed`` batch. Returns
    (the weights' path, a record)."""
    from world_modelz_tpu_torch.utils import fvd

    os.makedirs(root, exist_ok=True)
    torch.manual_seed(21)
    model = fvd.I3D()
    gen = torch.Generator().manual_seed(21)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, fvd._FrozenBatchNorm):
                m.mean.normal_(0.0, 0.1, generator=gen)
                m.var.uniform_(0.5, 1.5, generator=gen)
                m.scale.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    path = os.path.join(root, "i3d_random.npz")
    fvd.save_i3d(model, path)
    cpu, card = fvd.load_i3d(path, "cpu"), fvd.load_i3d(path, dev)
    x = torch.rand(clips, generator=torch.Generator().manual_seed(22)) * 2 - 1
    with torch.no_grad(), fvd.tf32_off():
        want = cpu(x)
        got = card(x.to(dev)).cpu()
    err = float((got - want).abs().max())
    limit = FEATURE_RTOL * max(1.0, float(want.abs().max()))
    small = torch.rand((1, 2, 64, 64, 1), generator=torch.Generator().manual_seed(23))
    rs_err = float((fvd.resize_224(small.to(dev)).cpu() - fvd.resize_224(small)).abs().max())
    if not (err <= limit and rs_err <= 1e-5) or got.shape != (clips[0], 400):
        raise AssertionError(f"i3d: card vs CPU {err} (limit {limit}), resize {rs_err}")
    rec = dict(max_abs_err=err, limit=limit)
    if dev.type == "cuda":
        big = torch.rand(timed, device=dev)
        rec["ms"] = cuda_ms(torch, lambda: fvd.i3d_features(card, big), iters=5, warmup=2)
    log(f"i3d: seeded random weights in the JAX layout ({len(fvd.i3d_param_paths())} "
        f"arrays, {os.path.basename(path)}); I3D on {clips} card vs CPU, TF32 off: max "
        f"|err| {err:.3e} (limit {limit:.3e}); the 224 resize card vs CPU {rs_err:.3e}; "
        f"i3d_features on {timed}: {rec.get('ms', math.nan):.3f} ms; on {smi}")
    return path, rec


def profile_busy(torch, label, fn, wall_s, reps) -> None:
    """``fn`` once more under torch.profiler: device time by kernel, and
    the device's busy share of ``wall_s``, the unprofiled wall of one call
    (mean of ``reps``; kernels run in order on one stream, so their sum is
    the busy time). Only the device is traced: the host's operators are
    not needed for the sum, and recording them slows a profile of tens of
    thousands of launches by tens of seconds."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log(f"profile: {label}: the profiler recorded no device time (not measured)")
        return
    log(f"profile: {label}, device busy {busy_us / 1e3:.3f} ms of "
        f"{wall_s * 1e3:.3f} ms unprofiled wall (mean of {reps}) = "
        f"{busy_us / 1e6 / wall_s:.4f} busy share; "
        f"{sum(e.count for e in kernels)} kernel launches; profiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:7d} x  {e.key[:90]}")


def drive_rollout(torch, dev, launches, smi, train=TRAIN,
                  root=os.path.join(HERE, "build", "smoke"), rollout=ROLLOUT,
                  i3d_weights=None):
    """The rollout CLI (``cli.rollout.run``) on ``drive_training``'s final
    checkpoint and tokenizer under ``root``, then the trainer's ``--eval``
    on it. Three rollouts: the reference preset (30 iterations) with FVD
    over ``fvd_clips`` clips and the gt metrics, once under PyTorch's
    default TF32 settings (cuDNN on) with the tiny extractor and once with
    TF32 off and the tokenizer extractor; then the fast preset (10
    iterations, top-k 25) with the gt metrics, and with ``i3d_weights``
    FVD by the I3D extractor on them. Gates: the files land, each
    GIF decodes to its PNG grids bit for bit, FVD, PSNR and SSIM are finite
    (lo <= fvd <= hi), the exact launch counts, and on the card the launch
    log names the f32 ``local3d_fwd_cluster_kernel`` and the f32 dense
    layers' ``dense_tf32_kernel`` alone. Logs the wall
    and clips/s of a batch, its device time and busy share, the tiny
    features card vs CPU, and the share of tokens the tokenizer's encode
    keeps with cuDNN TF32 on and off, with FVD and PSNR under both. Returns
    the launch counts of the four runs, summed."""
    import dataclasses

    import numpy as np

    from world_modelz_tpu_torch.cli import rollout as ro
    from world_modelz_tpu_torch.cli.video_diffusion import VideoDiffusionConfig
    from world_modelz_tpu_torch.cli.video_diffusion import train as run_train
    from world_modelz_tpu_torch.train import latest_checkpoint
    from world_modelz_tpu_torch.utils.image import read_gif, read_png

    on_card = dev.type == "cuda"
    ckpt = latest_checkpoint(os.path.join(root, "run"))
    tok_path = latest_checkpoint(os.path.join(root, "tokenizer"))
    out = os.path.join(root, "rollout")
    b, frames = rollout["batch_size"], rollout["num_frames"]
    base = ro.RolloutConfig(
        checkpoint=ckpt, platform="" if on_card else dev.type, batch_size=b,
        num_frames=frames, output_dir=out, fvd_clips=rollout["fvd_clips"],
        fvd_batch_size=rollout["fvd_batch_size"])
    runs = {  # name: (config, cuDNN TF32)
        "reference": (dataclasses.replace(
            base, preset="reference", name="reference", fvd=True,
            gt_metrics=True), True),
        "reference_tf32_off": (dataclasses.replace(
            base, preset="reference", name="reference_tf32_off", fvd=True,
            fvd_feature_net="tokenizer", fvd_weights=tok_path,
            gt_metrics=True), False),
        "fast": (dataclasses.replace(
            base, preset="fast", name="fast", gt_metrics=True,
            **(dict(fvd=True, fvd_feature_net="i3d", fvd_weights=i3d_weights)
               if i3d_weights else {})), True),
    }
    results, counts, walls = {}, {}, {}
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    depth = train["depth"]
    try:
        for name, (cfg, cudnn_tf32) in runs.items():
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
            launches.clear()
            t0 = time.perf_counter()
            results[name] = res = ro.run(cfg)
            walls[name] = time.perf_counter() - t0
            counts[name] = dict(launches)
            iters = ro.SAMPLER_PRESETS[cfg.preset]["num_eval_iterations"]
            batches = len(res.batch_seconds)
            # an encode per batch, and the ceiling's encode of the gt clips
            want = {"local3d_fwd": depth * frames * iters * batches,
                    "dense_tf32": 4 * depth * frames * iters * batches,
                    "vq_encode": batches + 1, "local3d_block": 0}
            for key, n in want.items() if on_card else ():
                if counts[name].get(key, 0) != n:
                    raise AssertionError(f"rollout {name}: {key} launched "
                                         f"{counts[name].get(key, 0)} times, expected {n}")
            check_rollout_files(cfg, res)
            log(f"rollout {name} ({cfg.preset}: {iters} iterations, topk "
                f"{ro.SAMPLER_PRESETS[cfg.preset]['topk']}; cuDNN TF32 "
                f"{'on' if cudnn_tf32 else 'off'}): {batches} batches of {b} clips x "
                f"{frames} frames in {walls[name]:.3f} s; batch walls "
                + " ".join(f"{x:.3f}" for x in res.batch_seconds)
                + f" s; launches {counts[name]} (per batch {depth * frames * iters} "
                f"local3d_fwd = {depth} layers x {frames} frames x {iters} "
                f"iterations); FVD {res.fvd}; gt mean PSNR "
                f"{res.gt_metrics['mean_psnr']:.4f} dB, SSIM "
                f"{res.gt_metrics['mean_ssim']:.5f}, per horizon PSNR "
                + " ".join(f"{h['psnr']:.3f}" for h in res.gt_metrics["per_horizon"])
                + ", tokenizer ceiling "
                + " ".join(f"{h['tokenizer_ceiling_psnr']:.3f}"
                           for h in res.gt_metrics["per_horizon"]))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        ref = results["reference"]
        steady = sorted(ref.batch_seconds[1:rollout["fvd_clips"] // b])
        med = steady[len(steady) // 2]
        log(f"rollout reference (f32 denoiser, untrained: {ref.step} steps): one "
            f"batch of {b} clips x {frames} frames, median wall {med:.3f} s of "
            f"{len(steady)} = {b / med:.4f} clips/s, {b * frames / med:.3f} "
            f"frames/s; on {smi}")
        if on_card:
            ro_obj = ref.rollout
            def forward():
                with torch.no_grad():
                    return ro_obj.model(torch.zeros(
                        (b, *ro_obj.token_shape), dtype=torch.long, device=dev))
            names = kernels_run(torch, forward, launches=depth)
            if not names or not all(n.startswith(F32_CLUSTER) or n == "dense_tf32_kernel"
                                    for n in names):
                raise AssertionError(f"the rollout's denoiser launched {names}, not "
                                     f"{F32_CLUSTER} and dense_tf32_kernel alone")
            log(f"rollout: the launch log names {sorted(set(names))} "
                f"({len(names)} launches for one forward of {depth} layers)")
            profile_busy(torch, f"one rollout batch (reference, f32, {b} clips)",
                         ro_obj.generate, med, len(steady))
        compare_rollout_tf32(torch, dev, results, tok_path, base, smi)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # the trainer's --eval on the same checkpoint (the f32 masters; the
    # tokenizer bf16-rounded as the trainer runs it)
    cfg = VideoDiffusionConfig(
        **train, decoder_model=tok_path, output_dir=os.path.join(root, "eval"),
        checkpoint=ckpt, eval=True, platform="" if on_card else dev.type)
    launches.clear()
    t0 = time.perf_counter()
    result = run_train(cfg)
    wall = time.perf_counter() - t0
    counts["eval"] = dict(launches)
    step = result.state.step
    want = {"local3d_fwd": depth * cfg.eval_timesteps * cfg.num_eval_iterations,
            "dense_tf32": 4 * depth * cfg.eval_timesteps * cfg.num_eval_iterations,
            "vq_encode": 2}  # the token-grid probe, then the clips
    for key, n in want.items() if on_card else ():
        if counts["eval"].get(key, 0) != n:
            raise AssertionError(f"--eval: {key} launched "
                                 f"{counts['eval'].get(key, 0)} times, expected {n}")
    png = os.path.join(cfg.output_dir, f"{cfg.name}_eval_{step:07d}_base.png")
    grid = read_png(png)
    rows = read_gif(png[:-4] + ".gif")
    with open(os.path.join(cfg.output_dir, f"{cfg.name}_metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    image = [r for r in records if r.get("image") == "reconstruction_base"]
    if len(image) != 1 or image[0]["step"] != step:
        raise AssertionError(f"--eval: the metric log holds {records}")
    logged = read_png(os.path.join(cfg.output_dir, image[0]["path"]))
    size = grid.shape[0] // rows.shape[0]
    if not (np.array_equal(logged, grid) and rows.shape[0] == cfg.eval_timesteps + 1
            and all(np.array_equal(rows[i, ..., :1],
                                   grid[i * size:(i + 1) * size + 2])
                    for i in range(rows.shape[0]))):
        raise AssertionError("--eval: the GIF's frames or the logged image are not "
                             "the PNG grid's")
    log(f"trainer --eval (step {step}): {cfg.eval_batch_size} clips x "
        f"{cfg.eval_timesteps} frames, {cfg.num_eval_iterations} iterations in "
        f"{wall:.3f} s; {os.path.basename(png)} {grid.shape}, its GIF "
        f"({rows.shape[0]} frames, the grid's rows), "
        f"{sum(n.startswith(f'{cfg.name}_base_frame_') for n in os.listdir(cfg.output_dir))} "
        f"frame PNGs, log_image record {image[0]['path']}; launches {counts['eval']}")
    log(f"rollout and evaluation phase: {time.perf_counter() - t_phase:.1f} s")
    return {key: sum(c.get(key, 0) for c in counts.values())
            for key in set().union(*counts.values())}


def time_rollout_batch(torch, dev, train=TRAIN, rollout=ROLLOUT, reps=5) -> float:
    """One reference-preset rollout batch of the f32 denoiser
    (``rollout_frames``, which ``cli.rollout`` runs between the tokenizer's
    encode and decode) at random weights and seed tokens from a seed: the
    median wall of ``reps`` batches after one that warms up, then its
    device time and busy share (``profile_busy``). Gates nothing (those of
    the rollout are ``drive_rollout``'s); it times one tree against another
    (``chip_ab.py --phase time_rollout_batch --phase-here``). Returns the
    median wall in seconds."""
    from world_modelz_tpu_torch.cli.rollout import SAMPLER_PRESETS
    from world_modelz_tpu_torch.cli.video_diffusion import VideoDiffusionConfig, make_model
    from world_modelz_tpu_torch.diffusion import rollout_frames

    preset = SAMPLER_PRESETS["reference"]
    k = TOKENIZER["num_embeddings"]
    shape = (SEQ, GRID, GRID)
    b, frames = rollout["batch_size"], rollout["num_frames"]
    torch.manual_seed(0)
    model = make_model(VideoDiffusionConfig(**train), shape, k, dev).eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, k, (b, *shape), generator=gen, device=dev)

    def batch():
        with torch.no_grad():
            out = rollout_frames(model, tokens, num_frames=frames, num_classes=k,
                                 mask_token=k, num_iterations=preset["num_eval_iterations"],
                                 sample_topk=preset["topk"], generator=gen)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out

    if tuple(batch().shape) != (b, frames, *shape[1:]):
        raise AssertionError("rollout_frames returned another shape")
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        batch()
        walls.append(time.perf_counter() - t0)
    med = sorted(walls)[len(walls) // 2]
    log(f"rollout batch (reference, f32, random weights): {b} clips x {frames} frames, "
        f"{preset['num_eval_iterations']} iterations, walls "
        + " ".join(f"{x:.4f}" for x in walls) + f" s, median {med:.4f} s")
    if dev.type == "cuda":
        profile_busy(torch, f"one rollout batch (reference, f32, random weights, {b} clips)",
                     batch, med, reps)
    return med


def check_rollout_files(cfg, res) -> None:
    """A rollout's files: one PNG grid per frame, the GIF of those grids
    (decoded bit for bit), the FVD and gt-metric records with finite
    values and lo <= fvd <= hi."""
    import numpy as np

    from world_modelz_tpu_torch.utils.image import read_gif, read_png

    frames, img = res.decoded.shape[1], res.rollout.train_cfg.image_size
    shape = (cfg.batch_size, cfg.num_frames, img, img, res.rollout.tok.in_channels)
    if res.decoded.shape != shape or not np.isfinite(res.decoded).all():
        raise AssertionError(f"rollout {cfg.name}: decoded {res.decoded.shape}, "
                             "or pixels not finite")
    gif = read_gif(os.path.join(cfg.output_dir, f"{cfg.name}.gif"))
    if gif.shape[0] != frames:
        raise AssertionError(f"rollout {cfg.name}: the GIF has {gif.shape[0]} frames")
    for i in range(frames):
        png = read_png(os.path.join(cfg.output_dir, f"{cfg.name}_frame_{i:04d}.png"))
        if not np.array_equal(gif[i], np.broadcast_to(png, gif[i].shape)):
            raise AssertionError(f"rollout {cfg.name}: GIF frame {i} is not its PNG")
    for key, suffix in (("fvd", "_fvd.json"), ("gt_metrics", "_gt_metrics.json")):
        rec = getattr(res, key)
        if not getattr(cfg, key):
            continue
        with open(os.path.join(cfg.output_dir, cfg.name + suffix)) as f:
            if json.load(f) != rec:
                raise AssertionError(f"rollout {cfg.name}: {suffix} is not the record")
    if cfg.fvd:
        fvd, (lo, hi) = res.fvd["fvd"], res.fvd["fvd_ci95"]
        if not (math.isfinite(fvd) and lo <= fvd <= hi) or res.fvd["clips"] != cfg.fvd_clips:
            raise AssertionError(f"rollout {cfg.name}: FVD record {res.fvd}")
    values = [v for h in res.gt_metrics["per_horizon"]
              for v in (h["psnr"], h["ssim"], h["tokenizer_ceiling_psnr"])]
    if len(res.gt_metrics["per_horizon"]) != frames or not all(map(math.isfinite, values)):
        raise AssertionError(f"rollout {cfg.name}: gt metrics {res.gt_metrics}")


def compare_rollout_tf32(torch, dev, results, tok_path, base, smi) -> None:
    """The tiny features on the card against the CPU (gate FEATURE_RTOL),
    and what PyTorch's default TF32 (cuDNN convolutions) changes: the share
    of the real clips' tokens that the f32 tokenizer's encode keeps, and
    both extractors' FVD and the gt PSNR of the rollouts under each
    setting (same seeds, same clips)."""
    import numpy as np

    from world_modelz_tpu_torch.cli.train_vqae import load_tokenizer
    from world_modelz_tpu_torch.utils import fvd as fvd_lib

    t0 = time.perf_counter()
    on, off = results["reference"], results["reference_tf32_off"]
    clips = on.real_videos[: base.fvd_batch_size]
    feats = {d: fvd_lib.tiny_video_features(torch.from_numpy(clips).to(d)).cpu().numpy()
             for d in (dev, torch.device("cpu"))}
    ref = feats[torch.device("cpu")]
    rel = float(np.abs(feats[dev] - ref).max() / np.abs(ref).max())
    log(f"FVD tiny features {ref.shape} of {len(clips)} real clips, {dev.type} vs "
        f"CPU (TF32 off inside): max abs err / max |f| = {rel:.3g} (tol {FEATURE_RTOL})")
    if not rel <= FEATURE_RTOL:
        raise AssertionError(f"tiny features differ by {rel} of their span")
    tok, _ = load_tokenizer(tok_path, dev)
    real = torch.from_numpy(on.real_videos.reshape(-1, *on.real_videos.shape[2:]))
    tokens = {}
    for setting in (True, False):
        torch.backends.cudnn.allow_tf32 = setting
        tokens[setting] = torch.cat([tok.encode(real[i:i + 256].to(dev)).cpu()
                                     for i in range(0, len(real), 256)])
    torch.backends.cudnn.allow_tf32 = True
    share = float((tokens[True] == tokens[False]).float().mean())
    extractors = {"tiny": fvd_lib.make_extractor("tiny", device=dev),
                  "tokenizer": fvd_lib.make_extractor("tokenizer", tok_path, dev)}
    scores = {}  # point estimates (each run's CLI record has its interval)
    for name, res in (("TF32 on", on), ("TF32 off", off)):
        for net, ex in extractors.items():
            real_f = fvd_lib.extract_features(ex, res.real_videos, base.fvd_batch_size)
            gen_f = fvd_lib.extract_features(ex, res.gen_videos, base.fvd_batch_size)
            scores[name, net] = fvd_lib.fvd_from_features(real_f, gen_f)
    log(f"TF32 token agreement ({time.perf_counter() - t0:.1f} s): {share:.6f} of "
        f"{tokens[True].numel()} tokens "
        f"({len(real)} frames of the {len(on.real_videos)} real clips) equal with "
        f"cuDNN TF32 on and off; FVD "
        + "; ".join(f"{name} {net} {score:.6f}" for (name, net), score in scores.items())
        + f"; gt mean PSNR TF32 on {on.gt_metrics['mean_psnr']:.4f} dB, off "
        f"{off.gt_metrics['mean_psnr']:.4f} dB; SSIM on "
        f"{on.gt_metrics['mean_ssim']:.5f}, off {off.gt_metrics['mean_ssim']:.5f}; "
        f"generated pixels differ by up to "
        f"{float(np.abs(on.gen_videos - off.gen_videos).max()):.4g}; on {smi}")


def check_tokenizer_train_step(torch, dev, launches, train=VQAE_TRAIN, batch=8):
    """One f32 tokenizer training step (``cli.train_vqae.train_step``) at
    full width on the card (convolutions with TF32 off, ``vq_train_stats``)
    against the same weights and batch on the CPU (the plain fused
    statistics): loss, BatchNorm running statistics and the new codebook
    against the CPU in f32; parameter gradients against the CPU in float64,
    within GRAD_SPREAD x the CPU's own worst f32 error (TOK_GRAD_TOL).
    Codes that a near-tied row may move between the two are left out of
    the codebook comparison."""
    import copy

    import numpy as np

    from world_modelz_tpu_torch.cli import train_vqae as tv

    cfg = tv.TrainVqaeConfig(**dict(train, batch_size=batch), vq_backend="pallas")
    frames = torch.from_numpy(np.random.default_rng(8).uniform(size=(
        batch, cfg.image_size, cfg.image_size, cfg.in_channels)).astype(np.float32))
    torch.manual_seed(8)
    cpu = tv.init_state(cfg, tv.make_tokenizer(cfg, "cpu"))
    tok = tv.make_tokenizer(cfg, dev)
    tok.load_state_dict(cpu.tok.state_dict())
    card = tv.init_state(cfg, tok)
    f64 = tv.init_state(cfg, copy.deepcopy(cpu.tok).double())
    # the step's latents (batch-statistics BatchNorm) and codebook on the
    # CPU, from copies, for the tie check below
    with torch.no_grad():
        enc = copy.deepcopy(cpu.tok.encoder).train()
        lat = enc(frames.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    old_cb = cpu.tok.vq.embedding[0].clone()
    before = dict(launches)
    m_cpu, ok_cpu, _ = tv.train_step(cpu, frames, cfg)
    m_card, ok_card, _ = tv.train_step(card, frames.to(dev), cfg)
    ran = launches.get("vq_train_stats", 0) - before.get("vq_train_stats", 0)
    if dev.type == "cuda" and ran != 1:
        raise AssertionError(f"vq_train_stats ran {ran} times in the card step")
    tv.train_step(f64, frames.double(), cfg)
    if not (ok_cpu and ok_card):
        raise AssertionError("the parity step was rejected")
    loss_err = abs(m_card["loss"] - m_cpu["loss"])
    if not loss_err <= TOK_STEP_TOL * max(1.0, abs(m_cpu["loss"])):
        raise AssertionError(f"tokenizer step loss differs by {loss_err}")
    want = dict(f64.tok.named_parameters())
    got_cpu = dict(cpu.tok.named_parameters())
    floor = GRAD_FLOOR * max(float(p.grad.abs().max()) for p in want.values())
    rows = {}  # per tensor: (max(max |f64 grad|, floor), card err, CPU f32 err)
    for name, p in card.tok.named_parameters():
        ref = want[name].grad
        rows[name] = (max(float(ref.abs().max()), floor),
                      float((p.grad.cpu().double() - ref).abs().max()),
                      float((got_cpu[name].grad.double() - ref).abs().max()))
    cpu_worst = max(rows, key=lambda n: rows[n][2] / rows[n][0])
    rel_lim = max(TOK_GRAD_TOL, GRAD_SPREAD * rows[cpu_worst][2] / rows[cpu_worst][0])
    worst = max(rows, key=lambda n: rows[n][1] / rows[n][0])
    bn_err = 0.0
    want_b = dict(cpu.tok.named_buffers())
    for name, b in card.tok.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            ref = want_b[name]
            e = float(((b.cpu() - ref).abs() / ref.abs().clamp_min(1.0)).max())
            bn_err = max(bn_err, e)
    # near-tied latent rows (f64 top-2 gap <= VQ_GAP on the CPU latents)
    # may pick another code on the card; their codes are not compared
    x = lat.reshape(-1, cfg.embedding_dim).double()
    e = old_cb.double()
    dist = (x * x).sum(-1)[:, None] + (e * e).sum(-1)[None] - 2.0 * x @ e.T
    top2 = dist.topk(2, dim=-1, largest=False)
    tied = (top2.values[:, 1] - top2.values[:, 0]) <= VQ_GAP
    skip = torch.zeros(cfg.num_embeddings, dtype=torch.bool)
    skip[top2.indices[tied].reshape(-1)] = True
    cb_cpu, cb_card = cpu.tok.vq.embedding[0], card.tok.vq.embedding[0].cpu()
    cb_err = float((cb_card - cb_cpu).abs()[~skip].max())
    cb_lim = TOK_STEP_TOL * max(1.0, float(cb_cpu.abs().max()))
    log(f"tokenizer train step f32 card vs CPU (batch {batch}, uniform noise "
        f"images, full width, TF32 off): loss {m_card['loss']:.6f} vs "
        f"{m_cpu['loss']:.6f} (err {loss_err:.3g}); gradients vs the CPU in "
        f"float64 ({len(rows)} tensors, each relative to max(max|its grad|, "
        f"{floor:.3g})): the CPU's f32 err peaks at "
        f"{rows[cpu_worst][2] / rows[cpu_worst][0]:.3g} in {cpu_worst}, so "
        f"the limit is {rel_lim:.3g}; the card's peaks at "
        f"{rows[worst][1] / rows[worst][0]:.3g} in {worst} (err "
        f"{rows[worst][1]:.3g}; the CPU's there {rows[worst][2]:.3g}); "
        f"BatchNorm running stats rel err "
        f"{bn_err:.3g}; codebook err {cb_err:.3g} (limit {cb_lim:.3g}; "
        f"{int(tied.sum())} near-tied rows, {int(skip.sum())} codes left out)")
    if not rows[worst][1] <= rel_lim * rows[worst][0]:
        raise AssertionError(
            f"{worst}: gradient differs by {rows[worst][1]} > "
            f"{rel_lim} x {rows[worst][0]}")
    if not bn_err <= TOK_STEP_TOL:
        raise AssertionError(f"BatchNorm running statistics differ by {bn_err}")
    if not cb_err <= cb_lim:
        raise AssertionError(f"the new codebook differs by {cb_err}")


def drive_tokenizer_training(torch, dev, launches, smi, train=VQAE_TRAIN,
                             root=os.path.join(HERE, "build", "smoke_vqae")):
    """The tokenizer trainer at full width (``cli.train_vqae.train``) at
    train_vqae/mnist_b96; then the denoiser trainer's ``load_tokenizer``
    reads its final checkpoint and encodes a MovingMNIST batch. Returns the
    launch counts of the training run."""
    import json as json_mod
    import shutil

    import numpy as np

    from world_modelz_tpu_torch.cli.train_vqae import TrainVqaeConfig
    from world_modelz_tpu_torch.cli.train_vqae import train as run_train
    from world_modelz_tpu_torch.cli.video_diffusion import load_tokenizer
    from world_modelz_tpu_torch.data import MovingMNIST
    from world_modelz_tpu_torch.train import latest_checkpoint

    shutil.rmtree(root, ignore_errors=True)
    on_card = dev.type == "cuda"
    cfg = TrainVqaeConfig(**train, output_dir=root,
                          platform="" if on_card else dev.type)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    # the trainer as a user runs it: PyTorch's default TF32 settings (cuDNN
    # convolutions in TF32, matmuls in full f32)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        launches.clear()
        t0 = time.perf_counter()
        result = run_train(cfg)
        wall = time.perf_counter() - t0
        counts = dict(launches)
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else math.nan
        if on_card:
            profile_tokenizer_training(torch, dev, cfg, result)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    steps = cfg.max_steps
    hist = result.history
    r_loss = [h["r_loss"] for h in hist]
    if len(hist) != steps or not all(
            math.isfinite(h[key]) for h in hist for key in ("loss", "r_loss", "perplexity")):
        raise AssertionError(f"losses not finite or missing: {[h['loss'] for h in hist]}")
    first, last = sum(r_loss[:20]) / 20, sum(r_loss[-20:]) / 20
    if not last < first:
        raise AssertionError(f"recon loss did not fall: first 20 {first}, last 20 {last}")
    if result.rejected:
        raise AssertionError(f"{result.rejected} steps rejected")
    if latest_checkpoint(root) != os.path.join(root, f"step_{steps:07d}"):
        raise AssertionError("the final checkpoint did not land")
    pngs = sorted(f for f in os.listdir(root) if f.endswith(".png"))
    if len(pngs) != steps // cfg.checkpoint_interval:
        raise AssertionError(f"reconstruction grids: {pngs}")
    with open(result.metrics_path) as f:
        logged = [json_mod.loads(line) for line in f]
    want_steps = [1] + list(range(cfg.log_interval, steps + 1, cfg.log_interval))
    if [r["step"] for r in logged] != want_steps or not all(
            math.isfinite(r["perplexity"]) for r in logged):
        raise AssertionError(f"log points {[r['step'] for r in logged]}")
    if on_card and counts.get("vq_train_stats", 0) != steps:
        raise AssertionError(
            f"vq_train_stats launched {counts.get('vq_train_stats', 0)} times, "
            f"expected {steps}")
    # the hand-off: the denoiser trainer reads the checkpoint and encodes
    tok, _ = load_tokenizer(result.checkpoint, dev)
    clips = MovingMNIST(seq_len=1, image_size=cfg.image_size, digit_size=24,
                        num_digits=2).sample_batch(np.random.default_rng(9), 16)[:, 0]
    tokens = tok.encode(torch.from_numpy(clips).to(dev))
    k, grid = cfg.num_embeddings, cfg.image_size // 2 ** cfg.downscale_steps
    if tuple(tokens.shape) != (16, grid, grid) or int(tokens.min()) < 0 or int(
            tokens.max()) >= k:
        raise AssertionError(f"hand-off tokens {tuple(tokens.shape)} outside [0, {k})")
    t = {h["step"]: h["t"] for h in hist}
    sps = (steps - 20) / (t[steps] - t[20])  # steps 21..200
    every = max(1, steps // 10)
    log(f"tokenizer training: train_vqae/mnist_b96, {steps} steps in {wall:.3f} s; "
        f"recon loss first-20 mean {first:.5f} -> last-20 mean {last:.5f}; "
        f"recon loss every {every}: " + " ".join(f"{x:.4f}" for x in r_loss[::every])
        + "; perplexity at log points: "
        + " ".join(f"{r['perplexity']:.1f}" for r in logged[::2]))
    log(f"tokenizer training: steps 21-{steps}: {sps:.4f} steps/s = "
        f"{sps * cfg.batch_size:.3f} samples/s ({1e3 / sps:.3f} ms/step); peak "
        f"device memory {peak:.3f} GiB; rejected {result.rejected}; launches "
        f"{counts}; checkpoint {os.path.basename(result.checkpoint)} + "
        f"{len(pngs)} PNG grids; hand-off encode {tuple(tokens.shape)} tokens "
        f"in [{int(tokens.min())}, {int(tokens.max())}], "
        f"{int(torch.unique(tokens).numel())} distinct; TF32: matmul off, "
        f"cuDNN on; on {smi}")
    return counts


def profile_tokenizer_training(torch, dev, cfg, result, n=5) -> None:
    """``n`` more tokenizer train steps on the trained state, unprofiled,
    for the wall per step, then one under torch.profiler
    (``profile_busy``)."""
    from world_modelz_tpu_torch.cli.train_vqae import build_batch_fn, train_step

    batch_fn, _ = build_batch_fn(cfg, 7)
    batches = [torch.from_numpy(batch_fn()).to(dev) for _ in range(n + 2)]
    train_step(result.state, batches[0], cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:-1]:
        train_step(result.state, b, cfg)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    profile_busy(torch, "one tokenizer train step",
                 lambda: train_step(result.state, batches[-1], cfg), step_s, n)


def check_sparse_parity(torch, dev, launches, model=SPARSE_MODEL, batch=2,
                        n_ctx=SPARSE_TRAIN["num_context"]):
    """The sparse denoiser at full width in f32 on the card (the flash
    kernels, TF32 off) against the same weights on the CPU (their plain
    versions): logits, and every parameter's gradient of a cross-entropy
    loss with the per-tensor limits of ``check_train_grads``. Every layer's
    to_qkv must get a non-zero gradient on the card. Then the card's logits
    without autograd (the dense layers on the split-TF32 kernel, 4 a layer
    and the logits) against the CPU's."""
    import torch.nn.functional as F

    from world_modelz_tpu_torch.models import VqSparseDiffusionModel

    torch.manual_seed(11)
    cpu = VqSparseDiffusionModel(**model, device="cpu").train()
    card = VqSparseDiffusionModel(**model, device=dev).train()
    card.load_state_dict(cpu.state_dict())
    k = model["num_classes"]
    s, h, w = model["shape"]
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, k + 1, (batch, n_ctx), generator=gen)
    indices = torch.stack([torch.randperm(s * h * w, generator=gen)[:n_ctx]
                           for _ in range(batch)])
    target = torch.randint(0, k, (batch, n_ctx), generator=gen)
    before = dict(launches)
    logits = {}
    for m, d in ((cpu, "cpu"), (card, dev)):
        out = m(tokens.to(d), indices.to(d)).float()
        F.cross_entropy(out.reshape(-1, k), target.to(d).reshape(-1)).backward()
        logits[d if d == "cpu" else "card"] = out.detach().cpu()
    ran = {key: launches[key] - before.get(key, 0) for key in launches}
    depth = model["depth"]
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if dev.type == "cuda" and ran.get(key, 0) != depth:
            raise AssertionError(f"{key} ran {ran.get(key, 0)} times, not {depth}")
    err = float((logits["card"] - logits["cpu"]).abs().max())
    log(f"sparse model f32 logits {tuple(logits['cpu'].shape)}: max_abs_err="
        f"{err:.3g} (tol {LOGIT_TOL}, logits span "
        f"{float(logits['cpu'].abs().max()):.3g})")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"sparse logits differ by {err}")
    want = dict(cpu.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in want.values())
    rows = {}  # per tensor: (max |CPU grad|, max abs err, limit)
    for name, p in card.named_parameters():
        if p.grad is None:
            raise AssertionError(f"{name} has no gradient on the card")
        ref = want[name].grad
        mag = float(ref.abs().max())
        rows[name] = (mag, float((p.grad.cpu() - ref).abs().max()),
                      GRAD_TOL * max(mag, GRAD_FLOOR * scale))
        if name.endswith("to_qkv.weight") and not bool(p.grad.abs().max() > 0):
            raise AssertionError(f"{name} has an all-zero gradient on the card")
    worst = max(rows, key=lambda n: rows[n][1] / rows[n][2])
    qkv = [n for n in rows if n.endswith("to_qkv.weight")]
    small = min(qkv, key=lambda n: rows[n][0])
    log(f"sparse model gradients f32 card vs CPU ({len(rows)} tensors, {depth} "
        f"layers of flash fwd/dq/dkv; limit {GRAD_TOL} x max(max|its grad|, "
        f"{GRAD_FLOOR} x {scale:.3g})): worst err/limit "
        f"{rows[worst][1] / rows[worst][2]:.3g} in {worst} (err "
        f"{rows[worst][1]:.3g}, max|grad| {rows[worst][0]:.3g}); to_qkv.weight "
        f"x {len(qkv)}, smallest max|grad| {rows[small][0]:.3g} in {small}: "
        f"every layer's to_qkv has a non-zero gradient")
    if not rows[worst][1] <= rows[worst][2]:
        raise AssertionError(
            f"{worst}: gradient differs by {rows[worst][1]} > {rows[worst][2]}")
    # the same forward without autograd, as the evaluation sweep runs it: on
    # the card every dense layer takes the split-TF32 kernel
    before = launches["dense_tf32"]
    with torch.no_grad():
        routed = card(tokens.to(dev), indices.to(dev)).float().cpu()
    n_dense = launches["dense_tf32"] - before
    err = float((routed - logits["cpu"]).abs().max())
    log(f"sparse model f32 logits without autograd (dense_tf32 x {n_dense}): "
        f"max_abs_err={err:.3g} against the CPU (tol {LOGIT_TOL})")
    if dev.type == "cuda" and n_dense != 4 * depth + 1:
        raise AssertionError(f"dense_tf32 ran {n_dense} times, not {4 * depth + 1}")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"sparse logits without autograd differ by {err}")


def sparse_tokenizer_checkpoint(torch, root, tokenizer=SPARSE_TOKENIZER,
                                train=SPARSE_TRAIN):
    """A seeded 3-channel tokenizer whose codebook is its encoder's own
    latents of synthetic trajectory frames (so tokens vary with the
    content), saved as a port tokenizer checkpoint; returns its path."""
    import numpy as np

    from world_modelz_tpu_torch.data import SyntheticTrajectorySource
    from world_modelz_tpu_torch.models import VQAutoEncoder
    from world_modelz_tpu_torch.train import save_checkpoint

    torch.manual_seed(12)
    tok = VQAutoEncoder(**tokenizer, device="cpu")
    src = SyntheticTrajectorySource(num_trajectories=4, traj_frames=24,
                                    frame_size=train["image_size"], seed=12)
    frames = np.concatenate([np.stack(list(src.load_frames(name)))[::6]
                             for name in src.trajectory_names()])
    with torch.no_grad():
        x = torch.from_numpy(frames).float().div(255.0)
        lat = tok.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        lat = lat.reshape(-1, tokenizer["embedding_dim"])
        pick = torch.randperm(lat.shape[0])[: tokenizer["num_embeddings"]]
        tok.vq.embedding[0] = lat[pick] + 0.01 * torch.randn_like(lat[pick])
    return save_checkpoint(os.path.join(root, "tokenizer"), 0,
                           {"tokenizer": tok.state_dict()}, tokenizer)


def drive_sparse_training(torch, dev, launches, smi, train=SPARSE_TRAIN,
                          tokenizer=SPARSE_TOKENIZER,
                          root=os.path.join(HERE, "build", "smoke_sparse"),
                          steps_per_dispatch=1, full=True, label=None):
    """The sparse trainer at full width (``cli.sparse_diffusion.train``) at
    train_sparse/s16_n1024_b16 and ``steps_per_dispatch`` from a seeded
    tokenizer checkpoint. On the card the step is one CUDA graph, replayed
    at every k (the batch's encode every ``change_batch_interval`` steps
    outside it): its launches must be exactly the step's flash kernels x
    the steps. With ``full``: the evaluation (the base and the EMA weights)
    at the last step, then one more evaluation pass alone, counted and
    timed, and the sweep's profile (``profile_sparse``); without, no
    evaluation.
    Then (on the card) the ready step from its graph under the profiler.
    Returns (the launch counts of the training run, eager and replayed, and
    the run's record: k, steps/s over steps 11-60, losses, the final
    checkpoint)."""
    import shutil

    import numpy as np

    from world_modelz_tpu_torch.cli import sparse_diffusion as sd
    from world_modelz_tpu_torch.train import latest_checkpoint

    shutil.rmtree(root, ignore_errors=True)
    tok_path = sparse_tokenizer_checkpoint(torch, root, tokenizer, train)
    on_card = dev.type == "cuda"
    cfg = sd.SparseDiffusionConfig(
        **dict(train, eval_interval=train["eval_interval"] if full else 0),
        decoder_model=tok_path, output_dir=os.path.join(root, "run"),
        platform="" if on_card else dev.type, steps_per_dispatch=steps_per_dispatch)
    label = label or f"sparse training (k={steps_per_dispatch})"
    log(f"{label}: train_sparse/s16_n1024_b16, cut to {cfg.max_steps} "
        f"steps (default 30,000), warmup {cfg.warmup} (500), cosine over "
        f"{cfg.max_steps}, buffer {cfg.buffer_size} frames (75,000), "
        f"checkpoints every {cfg.checkpoint_interval} (2,500), evaluation at "
        f"step {cfg.eval_interval} (every 5,000; 0: none); tokenizer seeded, codebook "
        f"from its encoder's latents of synthetic frames")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    # the trainer as a user runs it: PyTorch's default TF32 settings
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    rec = {"k": steps_per_dispatch}
    try:
        launches.clear()
        t0 = time.perf_counter()
        result = sd.train(cfg)
        wall = time.perf_counter() - t0
        eager = dict(launches)
        program = result.program
        graph, replays = dict(program.launches), program.replays
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else math.nan
        tok, _ = sd.load_tokenizer(tok_path, dev)
        if on_card:
            rec.update(profile_sparse_dispatch(torch, dev, cfg, result, tok, label))
        if full:
            launches.clear()
            t0 = time.perf_counter()
            _, vol, frames = sd.run_eval(result.state.model, None, tok, cfg,
                                         cfg.max_steps + 1, "alone")
            if on_card:
                torch.cuda.synchronize()
            eval_wall = time.perf_counter() - t0
            eval_counts = dict(launches)
            if on_card:
                profile_sparse(torch, cfg, result, tok)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    steps = cfg.max_steps
    losses = [h[1] for h in result.history]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"losses not finite or missing: {losses}")
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    if not last < first:
        raise AssertionError(f"loss did not fall: first 10 {first}, last 10 {last}")
    if result.rejected:
        raise AssertionError(f"{result.rejected} steps rejected")
    for at in range(cfg.checkpoint_interval, steps + 1, cfg.checkpoint_interval):
        if not os.path.isdir(os.path.join(cfg.output_dir, f"step_{at:07d}")):
            raise AssertionError(f"the checkpoint of step {at} did not land")
    ckpt = latest_checkpoint(cfg.output_dir)
    if ckpt != os.path.join(cfg.output_dir, f"step_{steps:07d}"):
        raise AssertionError("the final checkpoint did not land")
    depth = cfg.depth
    chunks = cfg.S * cfg.H * cfg.W // cfg.num_context + 1
    per_eval = cfg.num_eval_iterations * chunks * depth
    # the f32 evaluation's dense layers: 4 a layer and the logits a forward
    dense_eval = cfg.num_eval_iterations * chunks * (4 * depth + 1)
    encodes = len(range(0, steps, cfg.change_batch_interval))
    per_step = {"flash_fwd": depth, "flash_bwd_dq": depth, "flash_bwd_dkv": depth}
    want_graph = {k: n * steps for k, n in per_step.items()}
    want_eager = {"flash_fwd": depth * WARMUPS + (2 * per_eval if full else 0),
                  "flash_bwd_dq": depth * WARMUPS, "flash_bwd_dkv": depth * WARMUPS,
                  "vq_encode": encodes, **({"dense_tf32": 2 * dense_eval} if full else {})}
    if on_card and (graph != want_graph or eager != want_eager or replays != steps):
        raise AssertionError(
            f"{label}: the graph launched {graph} in {replays} replays, expected "
            f"{want_graph}; outside it {eager}, expected {want_eager}")
    counts = {k: eager.get(k, 0) + graph.get(k, 0) for k in set(eager) | set(graph)}
    t = {h[0]: h[4] for h in result.history}
    sps = (steps - 10) / (t[steps] - t[10])  # steps 11..60
    rec.update(steps_per_s=sps, losses=losses, checkpoint=ckpt, graph=graph,
               per_step=per_step, capture_s=program.capture_seconds, peak_gib=peak)
    log(f"{label}: {steps} steps in {wall:.3f} s (evaluation incl.; capture "
        f"{program.capture_seconds:.3f} s); loss first-10 mean {first:.5f} -> last-10 mean "
        f"{last:.5f}; losses every 10: " + " ".join(f"{x:.4f}" for x in losses[::10]))
    log(f"{label}: steps 11-{steps}: {sps:.4f} steps/s = "
        f"{sps * cfg.batch_size:.3f} samples/s ({1e3 / sps:.3f} ms/step); peak "
        f"device memory {peak:.3f} GiB; rejected {result.rejected}; launches replayed "
        f"from the step graph {graph}, outside it {eager} (the capture's {WARMUPS} "
        f"warm-up steps; {encodes} vq_encode at N = {cfg.batch_size * cfg.S * cfg.H * cfg.W}"
        + (f"; {per_eval} flash_fwd per evaluation pass, 2 passes); evaluation walls "
           + ", ".join(f"{e[1]} {e[3]:.3f} s" for e in result.evals) if full else ")")
        + f"; TF32: matmul off, cuDNN on; on {smi}")
    if not full:
        return counts, rec
    if [(e[0], e[1]) for e in result.evals] != [(steps, "base"), (steps, "ema")] or \
            not all(os.path.isfile(e[2]) for e in result.evals):
        raise AssertionError(f"evaluation PNGs: {result.evals}")
    k = tok.num_embeddings
    if int(vol.min()) < 0 or int(vol.max()) >= k:
        raise AssertionError(f"sampled tokens outside [0, {k}): "
                             f"[{int(vol.min())}, {int(vol.max())}]")
    if frames.shape != (cfg.eval_batch_size, cfg.S, cfg.image_size, cfg.image_size, 3) \
            or not np.isfinite(frames).all():
        raise AssertionError(f"decoded frames {frames.shape} not finite")
    if on_card and eval_counts != {"flash_fwd": per_eval, "dense_tf32": dense_eval}:
        raise AssertionError(f"one evaluation pass launched {eval_counts}, "
                             f"expected {per_eval} flash_fwd, {dense_eval} dense_tf32")
    log(f"sparse evaluation alone: {eval_wall:.3f} s for {cfg.num_eval_iterations} "
        f"iterations x {chunks} chunks of B={cfg.eval_batch_size}, N="
        f"{cfg.num_context} (f32), launches {eval_counts}; tokens in "
        f"[{int(vol.min())}, {int(vol.max())}], {int(torch.unique(vol).numel())} "
        f"distinct; frames finite, range [{frames.min():.4g}, {frames.max():.4g}]")
    return counts, rec


def profile_sparse_dispatch(torch, dev, cfg, result, tok, label, n=20) -> dict:
    """The sparse trainer's step graph run as its loop runs it (draws into
    the static inputs, a replay; one stats read per dispatch of k; the
    token batch already encoded): the unprofiled wall of ``n`` steps, then
    ``profile_steps`` of ``n`` more."""
    from world_modelz_tpu_torch.cli import sparse_diffusion as sd

    program, k = result.program, max(1, cfg.steps_per_dispatch)
    io = program.inputs
    gen = torch.Generator(device=dev).manual_seed(9)
    volume = cfg.S * cfg.H * cfg.W
    buckets = result.state.sampler.weights.shape[0]

    def run(count):
        done = 0
        while done < count:
            m = min(k, count - done)
            io.start()
            for _ in range(m):
                sd.draw_step(gen, cfg.batch_size, cfg.num_context, volume, buckets,
                             tok.num_embeddings, out=io.draws)
                program()
            io.read(m)
            done += m

    run(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    wall = time.perf_counter() - t0
    return profile_steps(torch, f"{label}: the ready step from its graph", lambda: run(n),
                         n, wall, program.captured)


def profile_sparse(torch, cfg, result, tok, eval_iters=5) -> None:
    """``eval_iters`` iterations of the evaluation sweep, unprofiled for the
    wall, then under torch.profiler (``profile_busy``); the train step's
    profile is ``check_step_program``'s."""
    import dataclasses

    from world_modelz_tpu_torch.cli import sparse_diffusion as sd

    short = dataclasses.replace(cfg, num_eval_iterations=eval_iters)
    model = result.state.model

    def sweep():
        sd.run_eval(model, None, tok, short, 0, "profile")

    sweep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep()
    torch.cuda.synchronize()
    profile_busy(torch, f"{eval_iters} evaluation iterations (decode and PNG "
                 f"incl.)", sweep, time.perf_counter() - t0, 1)


# serving from an exported artifact (cli.export_rollout, then
# cli.serve_http --exported) on drive_training's step-60 checkpoint:
# serve/m3_g8's batch of 8, 8 frames, 30 iterations, top-k off; ladder
# [1, 2, 4, 8]; the denoiser in f32, as a checkpoint is served
SERVE_HTTP = dict(batch_size=8, num_frames=8, num_iterations=30, topk=-1)
# the runtime calls that put work on the device, counted in a profile's
# host events: each kernel launch, graph launch, copy and fill
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                     "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def kernel_counts(prof, names):
    """Instances of each kernel of ``names`` (``name<args>``) among a
    profile's device events."""
    import re

    seen = dict.fromkeys(names, 0)
    for e in device_kernels(prof):
        m = re.search(r"(\w+(?:<[^()]*>)?)\(", e.key)
        if m and m.group(1) in seen:
            seen[m.group(1)] += e.count
    return seen


def drive_serving_http(torch, dev, launches, smi, train=TRAIN, serve=SERVE_HTTP,
                       root=os.path.join(HERE, "build", "smoke"), img=IMG,
                       rounds=("live", "programs", "programs", "live")):
    """Serving from an exported artifact behind the HTTP front end (A.4), on
    ``drive_training``'s final checkpoint under ``root``:
    ``cli.export_rollout`` writes the artifact (``root/serve_artifact``),
    ``cli.serve_http.build_service(exported=...)`` loads it (on the card:
    each ladder size's programs captured as CUDA graphs, capture times
    logged) and a live ``RolloutService`` restores the same checkpoint.
    Gates: at every ladder size the programs' encode and rollout equal the
    live service's, tokens, context and pixels bitwise, from generators of
    one seed; over HTTP with a bearer token, 8 concurrent generates (shapes,
    finite pixels, coalesced in ``stats``), one session (two generates, the
    DELETE; its tokens in [0, K)), healthz, stats and a 401 without the
    token; on the card, the graphs captured what each program must launch,
    no kernel launched outside a graph, and over one 8-clip batch the
    profiler counts each kernel's instances as captured x replays. Logs one
    8-clip batch of each service in the rounds ``rounds`` (A, B, B, A):
    wall, device time, busy share and the host's launch calls. Runs under
    PyTorch's default TF32 settings (cuDNN on), both services alike.
    Returns (the launch counts of the HTTP traffic, the record of the
    graphs for the kernels line)."""
    import collections
    import shutil
    import threading
    import urllib.error

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from world_modelz_tpu_torch.cli import export_rollout
    from world_modelz_tpu_torch.cli import serve_http as serve_cli
    from world_modelz_tpu_torch.serve import RolloutService
    from world_modelz_tpu_torch.serve_http import (
        HTTPSession,
        RolloutHTTPServer,
        _request,
        http_generate,
    )
    from world_modelz_tpu_torch.train import latest_checkpoint

    on_card = dev.type == "cuda"
    platform = "" if on_card else dev.type
    device = None if on_card else dev
    ckpt = latest_checkpoint(os.path.join(root, "run"))
    out = os.path.join(root, "serve_artifact")
    shutil.rmtree(out, ignore_errors=True)
    depth, b = train["depth"], serve["batch_size"]
    frames, iters = serve["num_frames"], serve["num_iterations"]
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    services, server = [], None
    try:
        meta = export_rollout.run(export_rollout.ExportRolloutConfig(
            checkpoint=ckpt, out=out, platform=platform, num_frames=frames,
            num_iterations=iters, topk=serve["topk"], batch_size=b))
        t0 = time.perf_counter()
        svc, tag = serve_cli.build_service(serve_cli.ServeHTTPConfig(
            exported=out, platform=platform, batch_size=b, manual_seed=0))
        services.append(svc)
        progs = svc._aot
        log(f"serving_http: exported {tag} (sizes {meta['sizes']}, token grid "
            f"{meta['token_hw']}, K {meta['num_embeddings']}); loaded in "
            f"{time.perf_counter() - t0:.3f} s; capture s by size "
            + " ".join(f"{s}: {progs.capture_seconds.get(s, math.nan):.3f}"
                       for s in progs.sizes))
        k = meta["num_embeddings"]
        if on_card:
            dense = 4 * depth  # q | k | v, to_out, up, down a layer (logits: cuBLAS)
            want = {"encode": ({"vq_encode": 1},
                               {"vq_prep_kernel": 1, "vq_encode_kernel<float>": 1}),
                    "step": ({"local3d_fwd": depth, "dense_tf32": dense}, None),
                    "finish": ({}, {})}
            for (name, size), (wrappers, kernels) in sorted(progs.captured.items()):
                want_w, want_k = want[name]
                f32 = sum(n for key, n in kernels.items() if key.startswith(F32_CLUSTER))
                if dict(wrappers) != want_w or (
                        dict(kernels) != want_k if want_k is not None
                        else f32 != depth or kernels.get("dense_tf32_kernel") != dense
                        or len(kernels) != 2):
                    raise AssertionError(
                        f"serving_http: the {name} graph at batch {size} captured "
                        f"{dict(wrappers)} / {dict(kernels)}")
                log(f"serving_http: graph {name} b={size}: {dict(kernels)}")

        tok, model, _, _ = export_rollout.restore_denoiser(ckpt, False, device)
        live = RolloutService(tok, model, num_frames=frames, num_iterations=iters,
                              sample_topk=serve["topk"], batch_size=b,
                              device=device, seed=0)
        services.append(live)
        s = meta["seed_frames"]
        clips = np.random.default_rng(5).uniform(
            size=(b, s, img, img, meta["channels"])).astype(np.float32)
        for size in progs.sizes:
            seeds = clips[:size]
            tokens = live._encode_call(seeds)
            got_tokens = progs.encode(seeds)
            live._generator.manual_seed(100 + size)
            pix, ctx = live._rollout_call(tokens)
            gen = torch.Generator(device=progs.device).manual_seed(100 + size)
            got_pix, got_ctx = progs.rollout(tokens, generator=gen)
            if not (np.array_equal(got_tokens, tokens) and np.array_equal(got_ctx, ctx)
                    and np.array_equal(got_pix, pix)):
                raise AssertionError(
                    f"serving_http: programs differ from the live service at batch "
                    f"{size}: tokens {int((got_tokens != tokens).sum())}, context "
                    f"{int((got_ctx != ctx).sum())} differ; pixels max "
                    f"{float(np.abs(got_pix - pix).max())}")
            if ctx.min() < 0 or ctx.max() >= k or not np.isfinite(pix).all():
                raise AssertionError(f"serving_http: batch {size}: tokens out of "
                                     f"[0, {k}) or pixels not finite")
        log(f"serving_http: programs == live service bitwise (tokens, context, "
            f"pixels) at sizes {progs.sizes}")

        token = "smoke-token"
        server = RolloutHTTPServer(svc, port=0, auth_token=token).start()
        url = f"http://127.0.0.1:{server.port}"
        outs = [None] * b
        before = dict(svc.stats)
        launches.clear()
        progs.launches.clear()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda i: outs.__setitem__(
            i, http_generate(url, clips[i], timeout=600, token=token)), args=(i,))
            for i in range(b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_http = time.perf_counter() - t0
        with HTTPSession(url, clips[0], timeout=600, token=token) as sess:
            seg = [sess.generate(), sess.generate()]
            ctx = np.asarray(server._get_session(sess.session_id)._ctx)
        counts = dict(progs.launches)
        outside = {key: n for key, n in launches.items() if n}
        health = _request(f"{url}/healthz")
        stats = _request(f"{url}/stats", headers={"Authorization": f"Bearer {token}"})
        try:
            _request(f"{url}/stats")
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
        delta = {key: svc.stats[key] - before[key] for key in before}
        for o in outs + seg:
            if o is None or o.shape != (frames, img, img, meta["channels"]) or not (
                    np.isfinite(o).all() and np.abs(o).max() <= 1e4):
                raise AssertionError("serving_http: an output's shape or pixels")
        if ctx.min() < 0 or ctx.max() >= k:
            raise AssertionError(f"serving_http: session tokens outside [0, {k})")
        if (health != {"ok": True} or refused != 401 or stats["open_sessions"] != 0
                or delta["requests"] != b + 2 or delta["session_rows"] != 2
                or not delta["batches"] - 2 < b):
            raise AssertionError(f"serving_http: healthz {health}, no-token status "
                                 f"{refused}, stats {stats}, delta {delta}")
        want = {"local3d_fwd": depth * iters * frames * delta["batches"],
                "dense_tf32": 4 * depth * iters * frames * delta["batches"],
                "vq_encode": delta["encode_calls"]}
        for key, n in want.items() if on_card else ():
            if counts.get(key, 0) != n:
                raise AssertionError(f"serving_http: {key} replayed {counts.get(key, 0)} "
                                     f"launches, expected {n}")
        if on_card and outside:
            raise AssertionError(f"serving_http: kernels launched outside a graph: {outside}")
        log(f"serving_http: {b} concurrent HTTP generates in {t_http:.3f} s, a session "
            f"of 2 generates; stats delta {delta}; healthz {health}; no token: "
            f"{refused}; launches (captured x replays) {counts}, outside a graph "
            f"{outside}; pixel range [{min(o.min() for o in outs):.4g}, "
            f"{max(o.max() for o in outs):.4g}]")

        def one_batch(service):
            futs = [service.submit(c) for c in clips]
            res = [f.result(timeout=600) for f in futs]
            if not all(np.isfinite(r).all() for r in res):
                raise AssertionError("serving_http: pixels not finite")

        record = dict(launches=counts.get("local3d_fwd", 0),
                      capture_s={str(size): round(t, 4)
                                 for size, t in progs.capture_seconds.items()})
        if on_card:
            for attempt in range(3):
                progs.kernel_launches.clear()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    one_batch(svc)
                    torch.cuda.synchronize()
                noted = dict(progs.kernel_launches)
                seen = kernel_counts(prof, noted)
                if seen == noted:
                    break
                log(f"serving_http: profile {attempt + 1} counts {seen}, the graphs "
                    f"noted {noted}; profiling again")
            else:
                raise AssertionError("serving_http: the profiler's kernel counts never "
                                     "matched captured x replays")
            l3d = [key for key in noted if key.startswith(F32_CLUSTER)]
            want_k = {"vq_prep_kernel": 1, "vq_encode_kernel<float>": 1}
            if (len(l3d) != 1 or noted[l3d[0]] != depth * iters * frames
                    or {key: noted.get(key) for key in want_k} != want_k):
                raise AssertionError(f"serving_http: one {b}-clip batch launched {noted}")
            log(f"serving_http: one {b}-clip batch: the profiler counts {seen} = "
                f"captured x replays ({depth} x {iters} x {frames} = "
                f"{depth * iters * frames} {l3d[0]})")
            record.update(kernel=l3d[0], per_batch=noted)

        walls = {"live": [], "programs": []}
        for name in rounds:
            service = live if name == "live" else svc
            t0 = time.perf_counter()
            one_batch(service)
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            walls[name].append(wall)
            if not on_card:
                log(f"serving_http: {name} batch wall {wall:.4f} s (CPU)")
                continue
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                one_batch(service)
                torch.cuda.synchronize()
            busy_ms = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3
            calls = collections.Counter()
            for e in prof.key_averages():
                if e.key in HOST_LAUNCH_CALLS:
                    calls[e.key] += e.count
            log(f"serving_http: {name} batch of {b} clips x {frames} frames: wall "
                f"{wall:.4f} s, device {busy_ms:.3f} ms, busy share "
                f"{busy_ms / 1e3 / wall:.4f}, host launch calls "
                f"{sum(calls.values())} {dict(calls)}; on {smi}")
        med = {name: float(np.median(w)) for name, w in walls.items()}
        log(f"serving_http: ABBA ({' '.join(rounds)}) medians live {med['live']:.4f} s, "
            f"programs {med['programs']:.4f} s (programs / live "
            f"{med['programs'] / med['live']:.4f}); phase "
            f"{time.perf_counter() - t_phase:.1f} s; on {smi}")
        record.update(walls_s={n: [round(x, 4) for x in w] for n, w in walls.items()})
        return counts, record
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        if server is not None:
            server.shutdown()
        for service in services:
            service.close()


def drive_serving(torch, dev, launches, tokenizer=TOKENIZER,
                  denoiser=DENOISER, service=SERVICE, img=IMG, backend="auto"):
    """The serving path at full width with a bf16 denoiser whose attention
    runs ``backend``: 8 concurrent seed clips, then one session with two
    generate() calls. Returns the launch counts of that run."""
    import numpy as np

    from world_modelz_tpu_torch.models import VQAutoEncoder, VqVideoDiffusionModel
    from world_modelz_tpu_torch.serve import RolloutService

    device = None if dev.type == "cuda" else dev  # None: the CUDA default
    torch.manual_seed(2)
    tok = VQAutoEncoder(**tokenizer, device=device)
    model = VqVideoDiffusionModel(**denoiser, backend=backend, device=device,
                                  dtype=torch.bfloat16)
    s = denoiser["data_shape"][0]
    clips = np.random.default_rng(0).uniform(
        size=(service["batch_size"] + 1, s, img, img,
              tokenizer["in_channels"])).astype(np.float32)
    svc = RolloutService(tok, model, device=device, **service)
    try:
        svc.submit(clips[-1]).result(timeout=600)  # warm-up, not counted
        before = dict(svc.stats)
        launches.clear()
        t0 = time.perf_counter()
        futs = [svc.submit(c) for c in clips[: service["batch_size"]]]
        outs = [f.result(timeout=600) for f in futs]
        t_batch = time.perf_counter() - t0
        sess = svc.open_session(clips[0])
        t0 = time.perf_counter()
        seg = [sess.generate(), sess.generate()]
        t_sess = time.perf_counter() - t0
        counts = dict(launches)
        delta = {key: svc.stats[key] - before[key] for key in before}
        ctx = np.asarray(sess._ctx)
        if dev.type == "cuda":
            profile_batch(torch, svc, clips[: service["batch_size"]], t_batch,
                          backend)
    finally:
        svc.close()
    frames = service["num_frames"]
    for out in outs + seg:
        if out.shape != (frames, img, img, tokenizer["in_channels"]):
            raise AssertionError(f"output shape {out.shape}")
        if not np.isfinite(out).all() or np.abs(out).max() > 1e4:
            raise AssertionError("output pixels not finite or out of range")
    k = tokenizer["num_embeddings"]
    if ctx.min() < 0 or ctx.max() >= k:
        raise AssertionError(f"session tokens outside [0, {k})")
    if delta["batches"] != 3 or delta["requests"] != service["batch_size"] + 2:
        raise AssertionError(f"unexpected batching {delta}")
    per_batch = denoiser["depth"] * service["num_iterations"] * frames
    attn = "local3d_block" if backend == "fused" else "local3d_fwd"
    other = "local3d_fwd" if backend == "fused" else "local3d_block"
    want = {attn: per_batch * delta["batches"], other: 0,
            "vq_encode": delta["encode_calls"]}
    if dev.type == "cuda" and min(want[attn], want["vq_encode"]) == 0:
        raise AssertionError(f"no launches expected: {want}")
    for name, n in want.items() if dev.type == "cuda" else ():
        if counts.get(name, 0) != n:
            raise AssertionError(
                f"{name} launched {counts.get(name, 0)} times, expected {n}")
    b = service["batch_size"]
    log(f"serving ({backend}): stats delta {delta}")
    log(f"serving ({backend}): {b} clips x {frames} frames in {t_batch:.3f} s = "
        f"{b / t_batch:.4f} clips/s, {b * frames / t_batch:.3f} frames/s; "
        f"session 2 x {frames} frames in {t_sess:.3f} s = "
        f"{2 * frames / t_sess:.3f} frames/s")
    log(f"serving ({backend}): pixel range [{min(o.min() for o in outs):.4g}, "
        f"{max(o.max() for o in outs):.4g}]; launches {counts} "
        f"({per_batch} {attn} per rollout batch)")
    return counts


def compare_serving(torch, dev, tokenizer=TOKENIZER, denoiser=DENOISER,
                    service=SERVICE, img=IMG, rounds=6) -> None:
    """The unfused ("auto") and the fused attention served side by side in
    one process: a RolloutService for each on the same weights, then
    ``rounds`` rounds of one 8-clip rollout batch on each, in the order
    auto, fused, fused, auto, ..., so that a drift of the host's speed
    falls on both. Logs every batch's wall and each route's median."""
    import numpy as np

    from world_modelz_tpu_torch.models import VQAutoEncoder, VqVideoDiffusionModel
    from world_modelz_tpu_torch.serve import RolloutService

    device = None if dev.type == "cuda" else dev
    torch.manual_seed(2)
    tok = VQAutoEncoder(**tokenizer, device=device)
    models = {b: VqVideoDiffusionModel(**denoiser, backend=b, device=device,
                                       dtype=torch.bfloat16)
              for b in ("auto", "fused")}
    models["fused"].load_state_dict(models["auto"].state_dict())
    s, b = denoiser["data_shape"][0], service["batch_size"]
    clips = np.random.default_rng(0).uniform(
        size=(b, s, img, img, tokenizer["in_channels"])).astype(np.float32)
    services = {name: RolloutService(tok, m, device=device, **service)
                for name, m in models.items()}
    walls = {name: [] for name in services}
    try:
        for svc in services.values():
            svc.submit(clips[0]).result(timeout=600)  # warm-up
        for r in range(rounds):
            for name in (("auto", "fused") if r % 2 == 0 else ("fused", "auto")):
                t0 = time.perf_counter()
                outs = [f.result(timeout=600)
                        for f in [services[name].submit(c) for c in clips]]
                walls[name].append(time.perf_counter() - t0)
                if not all(np.isfinite(o).all() for o in outs):
                    raise AssertionError(f"serving ({name}): pixels not finite")
    finally:
        for svc in services.values():
            svc.close()
    med = {name: float(np.median(w)) for name, w in walls.items()}
    log(f"serving side by side (ABBA, {rounds} rounds of one {b}-clip batch): "
        + "; ".join(f"{name} walls " + " ".join(f"{x:.3f}" for x in w)
                    + f" s, median {med[name]:.3f} s = {b / med[name]:.4f} clips/s"
                    for name, w in walls.items())
        + f"; fused / auto median wall {med['fused'] / med['auto']:.4f}")


def profile_batch(torch, svc, clips, t_batch: float, backend: str) -> None:
    """One more rollout batch under torch.profiler: device time by kernel,
    and the device's busy share of the unprofiled batch time ``t_batch``
    (kernels run in order on one stream, so their sum is the busy time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        [f.result(timeout=600) for f in [svc.submit(c) for c in clips]]
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    log(f"profile: one batch ({backend}), device busy {busy_us / 1e3:.3f} ms of "
        f"{t_batch * 1e3:.3f} ms unprofiled wall = "
        f"{busy_us / 1e6 / t_batch:.4f} busy share "
        f"({wall * 1e3:.3f} ms wall under the profiler); "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:7d} x  {e.key[:90]}")


# -------------------------------------------------------------------- main


# parallel.moe at the sparse trainer's width (SPARSE_MODEL: dim 512,
# mlp_dim 1024; a training batch of 16 x 1,024 tokens) with 8 experts and
# JAX's capacity factor 1.25 (160 slots an expert a row)
MOE = dict(batch=16, tokens=1024, dim=512, hidden=1024, experts=8, capacity_factor=1.25)
MOE_AGREE = {"float32": 0.999, "bfloat16": 0.99}  # routing, card vs CPU


def check_moe(torch, dev, smi, moe=MOE):
    """The mixture-of-experts FFN on the card: the main path
    (``parallel.moe.moe_ffn_indexed``) against the plain einsum form
    (``moe_ffn``), forward, load-balance loss and the gradients of x and the
    five parameters, in f32 and bf16 (f32 outputs within 1e-6 x max(1,
    max |y|), bf16 within 2^-7 x max |y|; gradients within GRAD_TOL x
    max(max |g|, GRAD_FLOOR x the largest), bf16 2^-7); the main path twice,
    bitwise (deterministic); the routing against the CPU's on the same
    inputs (agreement rate, the gate gap of each flipped token); the share
    of tokens dropped; each form's forward + backward device ms and peak
    memory. Returns a record."""
    from world_modelz_tpu_torch.parallel import moe as pm

    b, n, d, hid, e = (moe[k] for k in ("batch", "tokens", "dim", "hidden", "experts"))
    cap = pm.moe_capacity(moe["capacity_factor"], n, e)
    gen = torch.Generator().manual_seed(21)
    p0 = pm.moe_init(d, hid, e, generator=gen)
    p0 = p0._replace(b_in=0.1 * torch.randn(p0.b_in.shape, generator=gen),
                     b_out=0.1 * torch.randn(p0.b_out.shape, generator=gen))
    x0 = torch.randn((b, n, d), generator=gen)
    g0 = torch.randn((b, n, d), generator=gen)
    forms = {"indexed": pm.moe_ffn_indexed, "einsum": pm.moe_ffn}
    rec = {"capacity": cap}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        leaves = [t.to(dev, dtype).requires_grad_(True) for t in list(p0) + [x0]]
        g = g0.to(dev)

        def run(fn):
            y, aux = fn(pm.MoEParams(*leaves[:5]), leaves[5], capacity=cap)
            grads = torch.autograd.grad((y.float() * g).sum() + aux, leaves)
            return y.detach(), aux.detach(), grads

        outs = {name: run(fn) for name, fn in forms.items()}
        again = run(pm.moe_ffn_indexed)
        y_i, aux_i, gr_i = outs["indexed"]
        y_e, aux_e, gr_e = outs["einsum"]
        if not (torch.equal(again[0], y_i) and all(torch.equal(a, c)
                                                   for a, c in zip(again[2], gr_i))):
            raise AssertionError(f"moe {dt}: two runs of the main path differ")
        scale = max(1.0, float(y_e.float().abs().max()))
        y_err = float((y_i.float() - y_e.float()).abs().max())
        y_tol = (1e-6 if dtype == torch.float32 else 2**-7) * scale
        bitwise = float((y_i == y_e).float().mean())
        top = max(float(t.float().abs().max()) for t in gr_e)
        worst = 0.0
        for name, a, c in zip(list(pm.MoEParams._fields) + ["x"], gr_i, gr_e):
            mag = float(c.float().abs().max())
            lim = (GRAD_TOL * max(mag, GRAD_FLOOR * top) if dtype == torch.float32
                   else 2**-7 * max(mag, GRAD_FLOOR * top))
            err = float((a.float() - c.float()).abs().max())
            worst = max(worst, err / lim)
            if not err <= lim:
                raise AssertionError(f"moe {dt}: d{name} differs by {err} > {lim}")
        if not y_err <= y_tol or abs(float(aux_i) - float(aux_e)) > 1e-6:
            raise AssertionError(f"moe {dt}: outputs differ by {y_err} (tol {y_tol}), aux "
                                 f"{float(aux_i)} vs {float(aux_e)}")
        # routing against the CPU (the same dtype's gate product there)
        pc = pm.MoEParams(*(t.to(dtype) for t in p0))
        gate_c, exp_c = pm.route(pc, x0.to(dtype))
        gate_d, exp_d = pm.route(pm.MoEParams(*(t.detach() for t in leaves[:5])),
                                 leaves[5].detach())
        flips = (exp_d.cpu() != exp_c)
        agree = 1.0 - float(flips.float().mean())
        top2 = gate_c.topk(2, dim=-1).values
        gaps = (top2[..., 0] - top2[..., 1])[flips]
        dropped = float((pm._slots(gate_d, exp_d) >= cap).float().mean())
        if agree < MOE_AGREE[dt]:
            raise AssertionError(f"moe {dt}: routing agrees with the CPU on {agree:.6f} of "
                                 f"the tokens (< {MOE_AGREE[dt]})")
        timing = {}
        for name, fn in forms.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run(fn)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            ms = device_ms(torch, lambda fn=fn: run(fn), iters=10)
            timing[name] = dict(ms=round(ms, 4), peak_mib=round(peak, 1))
        rec[dt] = dict(max_abs_err=y_err, bitwise=bitwise, grad_err_over_limit=worst,
                       routing_agree=agree, flips=int(flips.sum()), dropped=dropped,
                       aux=float(aux_i), **{f"{k}_ms": v["ms"] for k, v in timing.items()},
                       **{f"{k}_peak_mib": v["peak_mib"] for k, v in timing.items()})
        log(f"moe {dt} (B={b}, N={n}, D={d}, H={hid}, E={e}, C={cap}): main path (index) vs "
            f"einsum on the card: out max_abs_err {y_err:.3g} (tol {y_tol:.3g}), "
            f"{bitwise * 100:.4f}% bitwise; gradients worst err/limit {worst:.3g}; aux "
            f"{float(aux_i):.6f}; the main path twice bitwise; routing vs the CPU "
            f"{agree * 100:.4f}% ({int(flips.sum())} flips, gate gaps "
            f"{[round(float(v), 8) for v in gaps[:8]]}); dropped {dropped * 100:.3f}% of "
            f"the tokens; forward + backward: index {timing['indexed']['ms']:.4f} ms "
            f"(peak +{timing['indexed']['peak_mib']:.1f} MiB), einsum "
            f"{timing['einsum']['ms']:.4f} ms (+{timing['einsum']['peak_mib']:.1f} MiB); "
            f"on {smi}")
    return rec


def drive_sparse_moe(torch, dev, launches, smi, dense, experts=8, steps=30):
    """The sparse trainer at train_sparse/s16_n1024_b16 with ``experts``
    mixture-of-experts FFNs: its step program bitwise against the eager
    step (``check_step_program``), then ``steps`` steps at k = 1
    (``drive_sparse_training``: the flash kernels' launches exactly
    captured x replays), its steps/s beside the dense run's (``dense``).
    Returns (the launch counts, the run's record, the step check's)."""
    train = dict(SPARSE_TRAIN, moe_experts=experts, max_steps=steps,
                 checkpoint_interval=steps, eval_interval=0)
    step = check_step_program(torch, dev, smi, kind="sparse", train=train, timed=10,
                              root=os.path.join(HERE, "build", "smoke_step_moe"))
    counts, rec = drive_sparse_training(
        torch, dev, launches, smi, train=train, full=False,
        root=os.path.join(HERE, "build", "smoke_sparse_moe"),
        label=f"sparse training, {experts} experts (k=1)")
    log(f"sparse training with {experts} experts: {rec['steps_per_s']:.4f} steps/s over steps "
        f"11-{steps}, against {dense['steps_per_s']:.4f} dense (steps 11-60, same call); "
        f"on {smi}")
    return counts, rec, step


# taming's published Gumbel f8 VQGAN (the Sber variant's tokenizer) as far
# as the minimal build takes its widths: 8,192 codes of 256, z 256, ch 128,
# ch_mult (1, 1, 2, 4): 64 x 64 frames -> 8 x 8 tokens
GUMBEL_F8 = dict(model=dict(target="taming.models.vqgan.GumbelVQ", params=dict(
    kl_weight=1e-8, n_embed=8192, embed_dim=256,
    ddconfig=dict(double_z=False, z_channels=256, resolution=256, in_channels=3, out_ch=3,
                  ch=128, ch_mult=[1, 1, 2, 4], num_res_blocks=2, attn_resolutions=[32],
                  dropout=0.0))))
EXT_AGREE = 0.99  # tokens, card vs CPU (argmax of 8,192 f32 logits)


def check_external_tokenizer(torch, dev, launches, smi,
                             root=os.path.join(HERE, "build", "smoke_external")):
    """``models.external.TamingGumbelVQAdapter`` at GUMBEL_F8 on seeded
    weights (a JSON config, which is yaml): encode of 64 x 64 synthetic
    frames, card vs CPU (tokens agreeing on EXT_AGREE), decode of the same
    tokens (PIXEL_RTOL x max(1, max |pixel|)); then the sparse trainer with
    ``--tokenizer taming:...`` at H = W = 8 (the f8 grid), a few steps and
    one evaluation, its flash launches captured x replays and no
    ``vq_encode``; then ``NativeTokenizer`` over the sparse trainer's seeded
    tokenizer (one ``vq_encode`` a call, the tokenizer's tokens) and the
    trainer with ``--tokenizer native:...``. Returns (the launch counts, a
    record)."""
    import shutil

    import numpy as np

    from world_modelz_tpu_torch.cli import sparse_diffusion as sd
    from world_modelz_tpu_torch.data import SyntheticTrajectorySource
    from world_modelz_tpu_torch.models import _gumbelvq_minimal
    from world_modelz_tpu_torch.models.external import TamingGumbelVQAdapter

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg_path, ckpt = os.path.join(root, "gumbel_f8.yaml"), os.path.join(root, "model.ckpt")
    with open(cfg_path, "w") as f:
        json.dump(GUMBEL_F8, f)
    torch.manual_seed(31)
    model = _gumbelvq_minimal.build(**GUMBEL_F8["model"]["params"])
    torch.save({"state_dict": model.state_dict()}, ckpt)
    n_params = sum(p.numel() for p in model.parameters())
    img = SPARSE_TRAIN["image_size"]
    grid = img // 2 ** (len(GUMBEL_F8["model"]["params"]["ddconfig"]["ch_mult"]) - 1)
    src = SyntheticTrajectorySource(num_trajectories=2, traj_frames=16, frame_size=img, seed=31)
    frames = np.concatenate([np.stack(list(src.load_frames(t)))
                             for t in src.trajectory_names()]).astype(np.float32) / 255.0
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = TamingGumbelVQAdapter(cfg_path, ckpt, device="cpu")
        card = TamingGumbelVQAdapter(cfg_path, ckpt, device=dev)
        want = cpu.encode(frames)
        got = card.encode(frames).cpu()
        agree = float((got == want).float().mean())
        img_cpu = cpu.decode(want)
        img_card = card.decode(want.to(dev)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = float((img_card - img_cpu).abs().max())
    tol = PIXEL_RTOL * max(1.0, float(img_cpu.abs().max()))
    log(f"external tokenizer (taming Gumbel f8 widths, minimal build, {n_params:,} "
        f"parameters, seeded): {frames.shape[0]} frames {img}x{img} -> tokens "
        f"{tuple(got.shape)}; "
        f"card vs CPU tokens {agree * 100:.4f}% equal; decode max_abs_err {err:.3g} (tol "
        f"{tol:.3g}); cuDNN TF32 off")
    if agree < EXT_AGREE or not err <= tol or tuple(got.shape[1:]) != (grid, grid):
        raise AssertionError(f"external tokenizer: tokens agree {agree}, decode err {err}")
    taming = external_sparse_run(
        torch, dev, launches, smi, f"taming:{cfg_path},{ckpt}", grid, os.path.join(root, "run"),
        f"sparse training with the external tokenizer (the f8 grid of {img} x {img} frames)")
    # --tokenizer native: the sparse trainer's own seeded tokenizer behind
    # NativeTokenizer, whose encode runs vq_encode: one launch a call, the
    # same tokens as the tokenizer's
    from world_modelz_tpu_torch.models.external import make_tokenizer

    tok_path = sparse_tokenizer_checkpoint(torch, root)
    native = make_tokenizer(f"native:{tok_path}", dev)
    x = torch.from_numpy(frames).to(dev)
    launches.clear()
    z = native.encode(x)
    one = dict(launches)
    if (dev.type == "cuda" and one != {"vq_encode": 1}) or not torch.equal(
            z, native.tok.encode(x)):
        raise AssertionError(f"NativeTokenizer: launches {one}, tokens differ from the "
                             f"tokenizer's: {not torch.equal(z, native.tok.encode(x))}")
    tgrid = img // 2 ** SPARSE_TOKENIZER["downscale_steps"]
    nat = external_sparse_run(torch, dev, launches, smi, f"native:{tok_path}", tgrid,
                              os.path.join(root, "run_native"),
                              "sparse training with --tokenizer native")
    counts = {k: taming[0].get(k, 0) + nat[0].get(k, 0)
              for k in set(taming[0]) | set(nat[0])}
    return counts, dict(tokens_agree=agree, decode_err=err, losses=taming[1],
                        native_losses=nat[1])


def external_sparse_run(torch, dev, launches, smi, spec, grid, out, label):
    """The sparse trainer at train_sparse/s16_n1024_b16 with ``--tokenizer
    spec`` on an H = W = ``grid`` token grid, 6 steps and one evaluation:
    finite losses, the flash kernels' launches captured x replays, and
    ``vq_encode`` launched once a batch encode for a native tokenizer, never
    for an adapter. Returns (the launch counts, the losses)."""
    from world_modelz_tpu_torch.cli import sparse_diffusion as sd

    # a 16 x 8 x 8 volume is 1,024 tokens: the time-dependent windows need
    # more frames than the context spans, so the context is cut to at most
    # half the volume
    n_ctx = min(SPARSE_TRAIN["num_context"], SPARSE_TRAIN["S"] * grid * grid // 2)
    train = dict(SPARSE_TRAIN, H=grid, W=grid, num_context=n_ctx,
                 max_steps=6, warmup=2, checkpoint_interval=6, eval_interval=6,
                 num_eval_iterations=2, eval_batch_size=2, log_interval=2)
    cfg = sd.SparseDiffusionConfig(**train, tokenizer=spec, output_dir=out,
                                   platform="" if dev.type == "cuda" else dev.type)
    log(f"{label}: train_sparse/s16_n1024_b16 at H = W = {grid} ({cfg.S * grid * grid} tokens "
        f"a volume, {cfg.num_context} in context (1,024)), cut to {cfg.max_steps} steps, one "
        f"evaluation of {cfg.num_eval_iterations} iterations at B={cfg.eval_batch_size}")
    launches.clear()
    t0 = time.perf_counter()
    result = sd.train(cfg)
    wall = time.perf_counter() - t0
    eager, graph = dict(launches), dict(result.program.launches)
    losses = [h[1] for h in result.history]
    want_graph = {k: cfg.depth * cfg.max_steps for k in ("flash_fwd", "flash_bwd_dq",
                                                         "flash_bwd_dkv")}
    encodes = len(range(0, cfg.max_steps, cfg.change_batch_interval))
    want_vq = encodes if spec.startswith("native:") else 0
    on_card = dev.type == "cuda"
    if len(losses) != cfg.max_steps or not all(map(math.isfinite, losses)) \
            or result.rejected or [e[1] for e in result.evals] != ["base", "ema"] \
            or (on_card and (graph != want_graph or eager.get("vq_encode", 0) != want_vq)):
        raise AssertionError(f"{label}: losses {losses}, rejected {result.rejected}, graph "
                             f"{graph} (want {want_graph}), outside it {eager} ({want_vq} "
                             f"vq_encode), evaluations {result.evals}")
    log(f"{label}: {cfg.max_steps} steps in {wall:.3f} s (capture and evaluation incl.), "
        f"{result.state.model.num_classes} classes, losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; launches from the step graph {graph}, outside it {eager} ({want_vq} vq_encode: "
        f"one a batch encode through a native tokenizer, none through an adapter); "
        f"evaluation PNGs " + ", ".join(os.path.basename(e[2]) for e in result.evals)
        + f"; on {smi}")
    counts = {k: eager.get(k, 0) + graph.get(k, 0) for k in set(eager) | set(graph)}
    return counts, losses


# the SOM-DDPM pipeline at the JAX defaults' widths: the autoencoder
# (embedding_dim 64, hidden_planes 128, downscale_steps 3) at batch 96 on
# 64 x 64 frames, a 128 x 128 SOM adapted in chunks of 32 (finetune: 8),
# the UNet (model_channels 128, 3 res blocks, channel_mult (1, 2, 3)) at
# batch 128 on 8 x 8 x 2 latents; the cuts are logged
SOM_AE = dict(embedding_dim=64, hidden_planes=128, downscale_steps=3, batch_size=96,
              image_size=64)
SOM_UNET = dict(model_channels=128, num_res_blocks=3, channel_mult=(1, 2, 3))
SOM_SOM = dict(som_width=128, som_height=128, adapt_batch_size=32)
# the cuts: steps of each stage (defaults 10,000, 10,000, 10,000 and
# 200,000), latents encoded (10,000), the evaluation's timesteps (1,000)
SOM_STEPS = dict(ae=20, som=6, finetune=4, diffusion=20, examples=512, eval_timesteps=20)
SOM_TIES = ((5, 6), (100, 9000), (128, 16383))  # SOM units made equal (lower, higher)
SOM_TIE_RTOL = 1e-5  # a BMU may differ from float64's within this share of |x|^2 + |e|^2


def check_som_bmu(torch, dev, ae, frames):
    """The SOM's BMU search on the card (f32, TF32 off) against float64
    distances computed on the card: every pick is the float64 nearest unit
    or within SOM_TIE_RTOL of it; units made equal (SOM_TIES) and rows equal
    to the higher copy go to the lower. Returns a record."""
    from world_modelz_tpu_torch.ops.som import som_encode

    som = ae.som
    emb = som.embedding.clone()
    for lo, hi in SOM_TIES:
        emb[hi] = emb[lo]
    state = som.replace(embedding=emb)
    with torch.no_grad():
        x = ae.encode_latent(frames).reshape(-1, ae.embedding_dim)
    x = x.clone()
    rows = torch.arange(len(SOM_TIES), device=dev) * 7
    x[rows] = emb[torch.tensor([hi for _, hi in SOM_TIES], device=dev)]
    pick = som_encode(state, x)
    x64, e64 = x.double(), emb.double()
    d64 = (x64 * x64).sum(1, keepdim=True) + (e64 * e64).sum(1) - 2.0 * (x64 @ e64.T)
    best = d64.min(1).values
    gap = d64.gather(1, pick[:, None])[:, 0] - best
    scale = (x64 * x64).sum(1) + (e64 * e64).sum(1).max()
    off = gap > 0
    worst = float((gap / scale).max())
    tied_ok = bool((pick[rows].cpu() == torch.tensor([lo for lo, _ in SOM_TIES])).all())
    log(f"SOM BMU search ({x.shape[0]} latents x {emb.shape[0]} units of "
        f"{emb.shape[1]}): {int(off.sum())} picks differ from float64's nearest, worst gap "
        f"{worst:.3g} of |x|^2 + |e|^2 (tie margin {SOM_TIE_RTOL}); {len(SOM_TIES)} equal "
        f"units: rows equal to the higher copy took the lower: {tied_ok}")
    if worst > SOM_TIE_RTOL or not tied_ok:
        raise AssertionError(f"SOM BMU: worst gap {worst}, ties to the lower {tied_ok}")
    return dict(rows=int(x.shape[0]), off_float64=int(off.sum()), worst_gap=worst)


def check_unet_parity(torch, dev, unet=SOM_UNET, batch=4, grid=8):
    """The UNet at SOM_UNET on the card against the same weights on the CPU
    (every parameter perturbed, so the zero-initialized convs count), both
    fed the CPU's timestep embedding: outputs within PIXEL_RTOL x max(1,
    max |eps|), then one ``ddpm_step`` each (MSE, AdamW) on the same batch,
    times and noise: the loss within 1e-5 x max(1, loss) and every
    gradient within GRAD_TOL x max(max |g|, GRAD_FLOOR x the largest). The
    card's own embedding against the CPU's: within two f32 ulps of the
    largest frequency's phase. Returns a record."""
    from world_modelz_tpu_torch.cli import som_pipeline as sp
    from world_modelz_tpu_torch.cli.video_diffusion import init_state
    from world_modelz_tpu_torch.models import unet as unet_mod

    cfg = sp.TrainDiffusionConfig(**unet, warmup=2, max_steps=10)
    torch.manual_seed(41)
    cpu = sp.make_unet(cfg, "cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.02 * torch.randn_like(p))
    card = sp.make_unet(cfg, dev)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(42)
    x = torch.rand((batch, grid, grid, 2), generator=gen) * 2 - 1
    t = torch.rand((batch, 1), generator=gen)
    eps = torch.randn((batch, grid, grid, 2), generator=gen)
    emb_cpu = unet_mod.timestep_embedding(t, unet["model_channels"])
    emb_card = unet_mod.timestep_embedding(t.to(dev), unet["model_channels"]).cpu()
    emb_err = float((emb_card - emb_cpu).abs().max())
    emb_tol = 2 * 5000.0 * 2.0**-23
    own = unet_mod.timestep_embedding
    unet_mod.timestep_embedding = lambda tt, dim, **kw: emb_cpu.to(tt.device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            cpu.eval(), card.eval()
            want = cpu(x, t)
            got = card(x.to(dev), t.to(dev)).cpu()
            cpu.train(), card.train()
        out_err = float((got - want).abs().max())
        out_tol = PIXEL_RTOL * max(1.0, float(want.abs().max()))
        losses, grads = {}, {}
        for name, m, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
            state = init_state(cfg, m)
            stats = sp.ddpm_step(state, x.to(d), t.to(d), eps.to(d), cfg,
                                 sp._recon_loss("MSE"))
            losses[name] = float(stats[0])
            grads[name] = {k: p.grad.cpu() for k, p in m.named_parameters()}
    finally:
        unet_mod.timestep_embedding = own
        torch.backends.cudnn.allow_tf32 = tf32
    top = max(float(g.abs().max()) for g in grads["cpu"].values())
    worst, worst_name = 0.0, ""
    for k, g in grads["cpu"].items():
        lim = GRAD_TOL * max(float(g.abs().max()), GRAD_FLOOR * top)
        r = float((grads["card"][k] - g).abs().max()) / lim
        if r > worst:
            worst, worst_name = r, k
    loss_err = abs(losses["card"] - losses["cpu"])
    log(f"UNet (model_channels {unet['model_channels']}, {unet['num_res_blocks']} res blocks, "
        f"channel_mult {unet['channel_mult']}) on {tuple(x.shape)} card vs CPU, cuDNN TF32 "
        f"off, "
        f"the CPU's timestep embedding: eps max_abs_err {out_err:.3g} (tol {out_tol:.3g}); one "
        f"train step: loss {losses['cpu']:.6f} vs {losses['card']:.6f}, gradients worst "
        f"err/limit {worst:.3g} in {worst_name}; the card's own embedding within "
        f"{emb_err:.3g} of the CPU's (tol {emb_tol:.3g})")
    if not (out_err <= out_tol and loss_err <= 1e-5 * max(1.0, losses["cpu"])
            and worst <= 1.0 and emb_err <= emb_tol):
        raise AssertionError(f"UNet card vs CPU: eps err {out_err}, loss err {loss_err}, "
                             f"gradient err/limit {worst} in {worst_name}, embedding {emb_err}")
    return dict(eps_err=out_err, grad_err_over_limit=worst, embedding_err=emb_err)


def profile_som_loops(torch, dev, ae, frames, unet, dd_cfg, latent_shape) -> dict:
    """The two Python loops of the pipeline, timed alone and profiled:
    one ``som_adapt`` call on ``frames``' latents (the chunked update,
    train_som's chunk) and one evaluation sample (``sample_latents``: a
    UNet call a timestep). Returns their walls."""
    from world_modelz_tpu_torch.cli import som_pipeline as sp
    from world_modelz_tpu_torch.ops.som import som_adapt

    with torch.no_grad():
        h = ae.encode_latent(frames)
    chunk = SOM_SOM["adapt_batch_size"]
    chunks = -(-h[..., 0].numel() // chunk)

    def adapt():
        som_adapt(ae.som, h, 0.1, 4.0, adapt_batch_size=chunk)

    def sample():
        sp.sample_latents(unet, None, dd_cfg, latent_shape, 0)

    out = {}
    for name, fn, per in (("som_adapt", adapt, chunks),
                          ("sample", sample, dd_cfg.eval_timesteps)):
        fn()
        torch.cuda.synchronize() if dev.type == "cuda" else None
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize() if dev.type == "cuda" else None
        wall = time.perf_counter() - t0
        out[f"{name}_ms"] = wall * 1e3
        log(f"{name}: {wall * 1e3:.3f} ms alone, {wall * 1e6 / per:.2f} us a "
            f"{'chunk' if name == 'som_adapt' else 'timestep'} ({per})")
        if dev.type == "cuda":
            profile_busy(torch, f"one {name} ({per} "
                         f"{'chunks of ' + str(chunk) if name == 'som_adapt' else 'timesteps'})",
                         fn, wall, 1)
    return out


def drive_som_pipeline(torch, dev, smi, root=os.path.join(HERE, "build", "smoke_som")):
    """The five stages of ``cli.som_pipeline`` at the JAX defaults' widths
    on synthetic frames, each reading the previous stage's checkpoint, a
    few steps each (cuts logged): ``train_ae``, ``train_som`` (the SOM
    adapt's us a chunk), ``check_som_bmu``, ``finetune_ae``,
    ``create_diffusion_dataset``, ``check_unet_parity``, ``train_diffusion``
    with one evaluation sample at cut timesteps. Returns a record."""
    import shutil

    import numpy as np

    from world_modelz_tpu_torch.cli import som_pipeline as sp

    shutil.rmtree(root, ignore_errors=True)
    rec = {}
    n = SOM_STEPS
    b, img = SOM_AE["batch_size"], SOM_AE["image_size"]
    grid = img // 2 ** SOM_AE["downscale_steps"]
    platform = "" if dev.type == "cuda" else dev.type
    # the trainers as a user runs them: PyTorch's default TF32 settings
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        ae_cfg = sp.TrainAeConfig(**SOM_AE, platform=platform, max_steps=n["ae"],
                                  checkpoint_interval=0, log_interval=10,
                                  output_dir=os.path.join(root, "ae"))
        r1 = sp.train_ae(ae_cfg)
        som_cfg = sp.TrainSomConfig(ae_checkpoint=r1.path, batch_size=b, image_size=img,
                                    platform=platform, **SOM_SOM, max_steps=n["som"],
                                    checkpoint_interval=0, log_interval=3,
                                    output_dir=os.path.join(root, "som"))
        chunks = -(-b * grid * grid // som_cfg.adapt_batch_size)
        r2 = sp.train_som(som_cfg)
        frames = torch.from_numpy(sp.image_batch_fn("synthetic", "", "", "", b, img, 5)())
        rec["bmu"] = check_som_bmu(torch, dev, r2.model, frames.to(dev))
        ft_cfg = sp.FinetuneAeConfig(som_checkpoint=r2.path, batch_size=b, image_size=img,
                                     platform=platform, max_steps=n["finetune"],
                                     checkpoint_interval=0, log_interval=2,
                                     output_dir=os.path.join(root, "finetune"))
        r3 = sp.finetune_ae(ft_cfg)
        fine_chunks = -(-b * grid * grid // ft_cfg.som_adapt_batch)
        lat = os.path.join(root, "latents.npz")
        t0 = time.perf_counter()
        data = sp.create_diffusion_dataset(sp.CreateDatasetConfig(
            checkpoint=r3.path, batch_size=b, image_size=img, max_examples=n["examples"],
            dataset_fn=lat, platform=platform))
        create_s = time.perf_counter() - t0
        rec["unet"] = check_unet_parity(torch, dev, unet=SOM_UNET, grid=grid)
        dd_cfg = sp.TrainDiffusionConfig(
            input_dataset=lat, decoder_model=r3.path, batch_size=128, **SOM_UNET,
            platform=platform, max_steps=n["diffusion"], warmup=5,
            eval_interval=n["diffusion"], eval_timesteps=n["eval_timesteps"],
            eval_batch_size=8, eval_trace_steps=4, checkpoint_interval=n["diffusion"],
            log_interval=10, output_dir=os.path.join(root, "diffusion"))
        t0 = time.perf_counter()
        r5 = sp.train_diffusion(dd_cfg)
        diffusion_s = time.perf_counter() - t0
        rec.update(profile_som_loops(torch, dev, r2.model, frames.to(dev), r5.model, dd_cfg,
                                     (grid, grid, 2)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    ae, _ = sp.load_som_ae(r3.path, device=dev)
    problems = []
    for name, r in (("train_ae", r1), ("train_som", r2), ("finetune_ae", r3),
                    ("train_diffusion", r5)):
        vals = [v for h in r.history for k, v in h.items() if k in ("loss", "som_error")]
        if not r.path or not os.path.isdir(r.path) or not all(map(math.isfinite, vals)) \
                or not all(h["ok"] for h in r.history):
            problems.append(f"{name}: {r.path} {r.history}")
    if data.shape != (n["examples"], grid, grid, 2) or not np.abs(data).max() <= 1.0:
        problems.append(f"latents {data.shape}")
    if (ae.som_width, ae.som_height) != (SOM_SOM["som_width"], SOM_SOM["som_height"]):
        problems.append(f"the finetuned SOM is {ae.som_width} x {ae.som_height}")
    pngs = [f for f in os.listdir(dd_cfg.output_dir) if f.endswith(".png")]
    if sorted(pngs) != [f"diffusion_sampling_{n['diffusion']:07d}_{tag}.png"
                        for tag in ("base", "ema")]:
        problems.append(f"evaluation PNGs {pngs}")
    if problems:
        raise AssertionError("SOM-DDPM pipeline: " + "; ".join(problems))
    rec.update(ae_steps_per_s=r1.steps_per_sec, som_steps_per_s=r2.steps_per_sec,
               som_us_per_chunk=1e6 / (r2.steps_per_sec * chunks),
               finetune_steps_per_s=r3.steps_per_sec,
               finetune_us_per_chunk=1e6 / (r3.steps_per_sec * fine_chunks),
               create_s=create_s, diffusion_steps_per_s=r5.steps_per_sec,
               diffusion_s=diffusion_s)
    log(f"SOM-DDPM pipeline (each stage from the last's checkpoint, synthetic {img} x {img} "
        f"frames): train_ae {SOM_AE} cut to {ae_cfg.max_steps} steps (default 10,000): "
        f"{r1.steps_per_sec:.4f} steps/s; train_som {SOM_SOM} ({chunks} "
        f"chunks a step), cut to {som_cfg.max_steps} steps (10,000): "
        f"{r2.steps_per_sec:.4f} steps/s = {rec['som_us_per_chunk']:.2f} us a chunk; "
        f"finetune_ae adapt batch {ft_cfg.som_adapt_batch} ({fine_chunks} chunks a step), "
        f"cut to {ft_cfg.max_steps} steps (10,000): {r3.steps_per_sec:.4f} steps/s = "
        f"{rec['finetune_us_per_chunk']:.2f} us a chunk; create_diffusion_dataset "
        f"{n['examples']} examples (10,000) in {create_s:.3f} s; train_diffusion {SOM_UNET} "
        f"at batch 128, "
        f"cut to {dd_cfg.max_steps} steps (200,000): {r5.steps_per_sec:.4f} steps/s, with one "
        f"evaluation (base and EMA) of {dd_cfg.eval_timesteps} timesteps (1,000), trace "
        f"{dd_cfg.eval_trace_steps}, in {diffusion_s:.3f} s; losses: ae "
        f"{r1.history[-1]['loss']:.5f}, som_error {r2.history[-1]['som_error']:.5f}, "
        f"finetune {r3.history[-1]['loss']:.5f}, ddpm {r5.history[-1]['loss']:.5f}; TF32: "
        f"matmul off, cuDNN on; on {smi}")
    return rec


# masked-denoise at the CLI's defaults (cli/masked_denoise.py): level 5 at
# 64 x 64, so 2 x 2 patches (D = 12), 1,024 tokens a grid, 256 codes, gMLP
# width 512 and depth 5, batch 14; cut to 20 fitting and 30 training steps
MASKED_DENOISE = dict(batch_size=14, d_model=512, depth=5, level=5, image_size=64,
                      codebook_size=256, vq_steps=20, max_steps=30, eval_interval=30,
                      checkpoint_interval=30, log_interval=10)


def check_masked_denoise(torch, dev, launches, smi, md=MASKED_DENOISE,
                         root=os.path.join(HERE, "build", "smoke_md"), gmlp_batch=2):
    """The masked-denoise slice at the CLI's width: the VQ kernels against
    their plain versions at the patch quantizer's widths (``vq_encode``
    at D = 12 and 48, N = a step's 14,336 patch vectors, with ties;
    ``vq_train_stats`` at D = 12); the gMLP's f32 logits on the card
    against the CPU (TF32 off, LOGIT_TOL); then ``train`` (the patch VQ fit
    through ``vq_train_stats``, the steps from their CUDA graph, whose
    encode is ``vq_encode``, one evaluation PNG and a checkpoint), its step
    graph replayed against the same step run eagerly from the same state
    (bitwise), and the replayed step timed (the wall with its host batch
    and draws; the device's, back to back, by CUDA events). Returns (the
    launch counts of the run, the kernels' records by case)."""
    import collections
    import copy
    import shutil

    import numpy as np

    from world_modelz_tpu_torch.cli import masked_denoise as mdm
    from world_modelz_tpu_torch.models.gmlp import GMLP

    on_card = dev.type == "cuda"
    shutil.rmtree(root, ignore_errors=True)
    patch = md["image_size"] // 2 ** md["level"]
    n_tok, k, d = (md["image_size"] // patch) ** 2, md["codebook_size"], 3 * patch * patch
    rows = md["batch_size"] * n_tok
    recs = {}
    if on_card:
        gen = torch.Generator(device=dev).manual_seed(21)
        cb = {dd: torch.randn((k, dd), generator=gen, device=dev) for dd in (d, 48)}
        check_vq(torch, dev, cases=[(f"masked_denoise_d{dd}", rows, torch.float32, cb[dd])
                                    for dd in (d, 48)],
                 ties=[(rows, k, dd) for dd in (d, 48)], records=recs)
        check_vq_train(torch, dev, cases=[(f"masked_denoise_d{d}_train", rows, cb[d])],
                       ties=[(rows, k, d)], records=recs)
    torch.manual_seed(5)
    cpu = GMLP(k + 1, k, md["d_model"], md["depth"], n_tok, vq_embedding_dim=d, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, k + 1, (gmlp_batch, n_tok), generator=g)
    emb = torch.randn((gmlp_batch, n_tok, d), generator=g)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = cpu(tokens, emb)
            got = card(tokens.to(dev), emb.to(dev)).cpu()
        err = float((got - want).abs().max())
        log(f"masked_denoise gMLP f32 logits {tuple(got.shape)} (d_model {md['d_model']}, "
            f"depth {md['depth']}, {n_tok} tokens): card vs CPU max_abs_err={err:.3g} "
            f"(tol {LOGIT_TOL}, logits span {float(want.abs().max()):.3g})")
        if not err <= LOGIT_TOL:
            raise AssertionError(f"masked_denoise gMLP logits differ by {err}")
        del cpu, card
        cfg = mdm.MaskedDenoiseConfig(**md, output_dir=root,
                                      platform="" if on_card else dev.type)
        launches.clear()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = mdm.train(cfg)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else math.nan
        counts = dict(collections.Counter(launches) + res.program.launches)
        losses = res.losses
        if len(losses) != cfg.max_steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"masked_denoise losses: {losses}")
        png = os.path.join(root, f"{cfg.name}_eval_{cfg.max_steps:07d}.png")
        if res.evals != [png] or not os.path.getsize(png):
            raise AssertionError(f"masked_denoise evaluation PNG: {res.evals}")
        if not os.path.isfile(os.path.join(root, f"step_{cfg.max_steps:07d}", "state.pt")):
            raise AssertionError("masked_denoise checkpoint did not land")
        if on_card and (counts.get("vq_train_stats") != cfg.vq_steps or counts.get(
                "vq_encode") != cfg.max_steps + WARMUPS):
            raise AssertionError(
                f"masked_denoise launches {counts}: expected {cfg.vq_steps} vq_train_stats "
                f"(the fit) and {cfg.max_steps} + {WARMUPS} vq_encode (replays + the "
                "capture's warm-ups)")
        # the step graph against the same step eagerly, from one state
        task, program, io = res.task, res.program, res.program.inputs
        eager_model = mdm.make_model(cfg, task, dev).train()
        eager_model.load_state_dict(res.model.state_dict())
        eager_opt = mdm.make_denoise_optimizer(cfg, eager_model)
        eager_opt.load_state_dict(res.optimizer.state_dict())
        batch_fn = mdm._batch_fn(cfg, 9)
        g_e = torch.Generator(device=dev).manual_seed(9)
        g_g = torch.Generator(device=dev).manual_seed(9)
        for i in range(3):
            images = torch.from_numpy(batch_fn()).to(dev)
            e = mdm.step_body(eager_model, eager_opt, task, images,
                              mdm.draw_step(g_e, cfg.batch_size, n_tok, k), cfg)
            io.tensors["images"].copy_(images)
            mdm.draw_step(g_g, cfg.batch_size, n_tok, k, out=io.draws)
            io.start()
            program()
            same = torch.equal(e.view(torch.int32), io.stats[0].view(torch.int32)) and all(
                torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                            b.view(torch.int32) if b.is_floating_point() else b)
                for a, b in zip(eager_opt.state_tensors().values(),
                                res.optimizer.state_tensors().values()))
            if not same:
                raise AssertionError(f"masked_denoise: replay {i + 1} differs from the "
                                     f"eager step ({e.tolist()} vs {io.stats[0].tolist()})")
        rec = dict(wall_s=round(wall, 3), losses=[round(x, 5) for x in losses[::10]],
                   peak_gib=round(peak, 3), launches=counts)
        if on_card:
            n = 20

            def replays():
                for _ in range(n):
                    io.tensors["images"].copy_(torch.from_numpy(batch_fn()))
                    mdm.draw_step(g_g, cfg.batch_size, n_tok, k, out=io.draws)
                    io.start()
                    program()
                torch.cuda.synchronize()

            replays()
            t0 = time.perf_counter()
            replays()
            step_s = (time.perf_counter() - t0) / n
            # the profile of the same replays: device ms, busy share, and its
            # kernel counts held to captured x replays; the graph's own step
            # count, advanced on the device, says how many replays ran
            count0 = int(res.optimizer.count_t)
            rec.update(profile_steps(torch, "masked_denoise replayed steps", replays, n,
                                     step_s * n, captured=program.captured))
            ran = int(res.optimizer.count_t) - count0
            if ran % n:
                raise AssertionError(f"masked_denoise: the graph counted {ran} steps in "
                                     f"profiles of {n} replays")
            # the graph alone, back to back between CUDA events
            rec.update(steps_per_s=round(1 / step_s, 4),
                       events_ms_per_step=round(cuda_ms(torch, program, n), 4),
                       capture_s=round(program.capture_seconds, 4),
                       captured=dict(program.captured.wrappers))
            rec["md_vq"] = {name: r for name, r in recs.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log(f"masked_denoise: {', '.join(f'{k} {v}' for k, v in md.items())}; fit {cfg.vq_steps} + {cfg.max_steps} steps in "
        f"{wall:.3f} s, losses every 10 {rec['losses']}; 3 replays == 3 eager steps "
        f"bitwise (stats, parameters, moments, count); {rec.get('steps_per_s')} steps/s "
        f"replayed with the host batch and draws, {rec.get('device_ms_per_step')} ms of "
        f"kernels a step by the profiler (busy share {rec.get('busy')}), the graph alone "
        f"{rec.get('events_ms_per_step')} ms a step by CUDA events; peak {rec['peak_gib']} GiB; launches "
        f"{counts}; on {smi}")
    return counts, rec


def check_data_parallel(torch, dev, smi, root=os.path.join(HERE, "build", "smoke_dp"),
                        runs=os.path.join(HERE, "build", "smoke")):
    """The data axis on the card with a world of one under NCCL: the video
    trainer's step at train_step/m3_b64_g8_full and the sparse step at
    train_sparse/s16_n1024_b16, with and without --fsdp, captured with the
    step's collectives (all-reduces, or reduce-scatter and all-gathers,
    and the sampler's all-gather) and replayed, each bitwise equal to the
    same step run eagerly without a process group (``check_step_program``;
    the replicated video step timed too); then the rollout CLI's
    --shard_batch on one rank against the unsharded rollout, bitwise, on
    the newest checkpoint under ``runs``. Destroys the group at the end.
    Returns the records."""
    import dataclasses
    import socket

    import numpy as np
    import torch.distributed as dist

    from world_modelz_tpu_torch.cli import rollout as ro
    from world_modelz_tpu_torch.parallel.mesh import make_mesh
    from world_modelz_tpu_torch.train import latest_checkpoint

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    out = {}
    try:
        mesh = make_mesh()
        if mesh.group is None or mesh.world != 1:
            raise AssertionError(f"expected a process group of one, got {mesh}")
        for kind in ("video", "sparse"):
            for fsdp in (False, True):
                timed = 20 if (kind, fsdp) == ("video", False) else 0
                out[f"{kind}{'_fsdp' if fsdp else ''}"] = check_step_program(
                    torch, dev, smi, kind=kind, mesh=mesh, fsdp=fsdp, timed=timed,
                    root=os.path.join(root, f"{kind}{'_fsdp' if fsdp else ''}"))
        ckpt = latest_checkpoint(os.path.join(runs, "run"))  # the training phase's
        base = ro.RolloutConfig(checkpoint=ckpt, batch_size=8, num_frames=2,
                                num_eval_iterations=4, output_dir=os.path.join(root, "ro"),
                                platform="" if dev.type == "cuda" else dev.type)
        plain = ro.run(base).decoded
        sharded = ro.run(dataclasses.replace(
            base, shard_batch=True, output_dir=os.path.join(root, "ro_sharded"))).decoded
        if not np.array_equal(plain, sharded):
            raise AssertionError(
                f"--shard_batch on one rank differs from the unsharded rollout by "
                f"{float(np.abs(plain - sharded).max())}")
        log(f"data parallel: --shard_batch on a {backend} world of one == the unsharded "
            f"rollout bitwise ({plain.shape} pixels, {os.path.basename(ckpt)})")
    finally:
        dist.destroy_process_group()
    return out


class PlainLocal3d:
    """The local-3D Function's plain versions as an autograd Function on
    the card (``models.attention``'s forward and split backward pair, at
    the rounding points ``route`` fixes), so a halo-padded shard runs
    through them as through the kernels."""

    @staticmethod
    def apply(q, k, v, extents, heads, route):
        import torch

        from world_modelz_tpu_torch.models import attention as pa

        class _Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v):
                ctx.save_for_backward(q, k, v)
                return pa.local3d_attention_rounded(q, k, v, extents, heads, route[0])

            @staticmethod
            def backward(ctx, g):
                q, k, v = ctx.saved_tensors
                g = g.to(q.dtype).contiguous()
                dq, lse, delta = pa.local3d_attention_bwd_dq(q, k, v, g, extents, heads)
                dk, dv = pa._local3d_bwd_dkv(q, k, v, g, lse, delta, extents, heads, route[1])
                return dq, dk, dv

        return _Fn.apply(q, k, v)


@contextlib.contextmanager
def row_parallel_parts():
    """``models.attention``'s ``reduce_from`` (the model axis's all-reduce)
    replaced by one that keeps each group-less rank's part and passes it on
    unsummed; yields the list of parts, which the caller sums."""
    from world_modelz_tpu_torch.models import attention as pa

    kept, real = [], pa.reduce_from

    def keep(x, axis):
        kept.append(x.detach())
        return x

    pa.reduce_from = keep
    try:
        yield kept
    finally:
        pa.reduce_from = real


def seq_stitched(torch, arrays, extents, heads, n, attention=None):
    """The clip's frames in ``n`` shards through
    ``parallel.sequence.local3d_attention_seq`` (each shard's halos cut
    from the whole K and V), stitched: (out, dq, dk, dv) of sum(out * g)."""
    from world_modelz_tpu_torch.parallel.sequence import local3d_attention_seq

    q, k, v = (t.detach().clone().requires_grad_(True) for t in arrays[:3])
    es, s_loc = extents[0], q.shape[1] // n
    outs = []
    for i in range(n):
        lo, hi = i * s_loc, (i + 1) * s_loc
        left = (k[:, lo - es:lo], v[:, lo - es:lo]) if i > 0 else None
        right = (k[:, hi:hi + es], v[:, hi:hi + es]) if i < n - 1 else None
        outs.append(local3d_attention_seq(q[:, lo:hi], k[:, lo:hi], v[:, lo:hi], extents,
                                          heads, left, right, attention=attention))
    out = torch.cat(outs, 1)
    (out.float() * arrays[3].float()).sum().backward()
    return out.detach(), q.grad, k.grad, v.grad


def check_model_axes(torch, dev, launches, smi="", seq=((64, 6, 8, 8), 1, 128, (3, 1, 1)),
                     sparse=(16, 1024, 512, 8, 64, 1024),
                     block=((8, SEQ, GRID, GRID), 384, 2, 64, (1, 2, 1))):
    """The model axes' shards on the card's kernels (no process group: each
    shard of one card's computation, the collectives' sums taken here):

    - sequence: m3's training shape (B=64, S=6 in 2 shards of 3 frames,
      8 x 8, one head of 128, e_s 3), in f32 and bf16, each shard padded
      with its halo through the local-3D Function (forward and the split
      backward pair, at the sequence path's rounding points); the stitched
      output and dQ/dK/dV against the same shards through the plain
      versions: bf16 within FWD_BF16_TOL / LOCAL3D_BWD_BF16_TOL x max |x|,
      f32 within F32_TOL / BWD_F32_TOL x max(1, max |x|);
    - tensor parallelism: one layer of train_sparse/s16_n1024_b16 (dim 512,
      8 heads of 64, mlp 1024, N = 1,024, B = 16, bf16) split into two head
      halves by ``parallel.mesh.shard_params`` (each half on the flash
      kernels, its part of ``to_out`` and of the FFN): the halves' outputs
      summed against the whole layer's within FWD_BF16_TOL x max |y|, and
      each half's weight gradients (the whole's, cut) within
      FLASH_BWD_BF16_TOL x max |x|, the input's and the replicated
      parameters' upstream of the split (the norms), whose two halves' bf16
      gradients are added, within twice that;
    - the fused block on a rank's share (the multi-head block shape, two
      heads split in two, bf16): each rank's operands through the block
      kernel against its plain version (FWD_BF16_TOL, >= FWD_BF16_EQUAL
      bitwise), and the two shares summed against the whole block.

    Every case must launch its kernels (on the card; ``seq``, ``sparse``
    and ``block`` give the shapes, smaller for a rehearsal on the CPU, where
    the plain versions run and nothing is timed). Returns the records."""
    import copy

    from world_modelz_tpu_torch.kernels import local3d_block_fwd, local3d_block_reference
    from world_modelz_tpu_torch.models.attention import (
        DenseTransformer,
        Local3dAttentionTransformer,
    )
    from world_modelz_tpu_torch.parallel.mesh import Mesh, shard_params

    gen = torch.Generator(device=dev).manual_seed(18)
    out = {}

    def err_of(got, want):
        got, want = got.detach().float(), want.detach().float()
        return float((got - want).abs().max()), float(want.abs().max())

    # sequence parallelism: halo-padded shards through the local-3D kernels
    cuda = dev.type == "cuda"
    (b, s, h, w), heads, dh, ext = seq
    n = 2
    for dtype in (torch.float32, torch.bfloat16):
        arrays = [torch.randn((b, s, h, w, heads * dh), generator=gen, device=dev).to(dtype)
                  for _ in range(4)]
        before = {k: launches[k] for k in ("local3d_fwd", "local3d_bwd_dq", "local3d_bwd_dkv")}
        t0 = time.perf_counter()
        got = seq_stitched(torch, arrays, ext, heads, n)
        ran = {k: launches[k] - v for k, v in before.items()}
        if cuda and any(v != n for v in ran.values()):
            raise AssertionError(f"model axes: the halo shards launched {ran}, not {n} each")
        want = seq_stitched(torch, arrays, ext, heads, n, attention=PlainLocal3d.apply)
        tname = str(dtype).replace("torch.", "")
        rec = {}
        for label, g, p in zip(("out", "dq", "dk", "dv"), got, want):
            err, peak = err_of(g, p)
            if dtype == torch.bfloat16:
                lim = (FWD_BF16_TOL if label == "out" else LOCAL3D_BWD_BF16_TOL) * peak
            else:
                lim = (F32_TOL if label == "out" else BWD_F32_TOL) * max(1.0, peak)
            if not err <= lim:
                raise AssertionError(
                    f"model axes: seq halo {tname} {label}: max abs err {err} > {lim}")
            rec[label] = dict(max_abs_err=err, tol=lim,
                              bitwise_equal=float((g == p).float().mean()))
        shard = [a[:, :s // n + ext[0]].contiguous().requires_grad_(True) for a in arrays[:3]]

        def shard_step():  # one border shard, padded by its halo, fwd + bwd
            from world_modelz_tpu_torch.kernels.local3d import local3d_attention

            o = local3d_attention(*shard, ext, heads, (False, 0))
            o.backward(arrays[3][:, :o.shape[1]])

        def whole_step():
            from world_modelz_tpu_torch.kernels.local3d import local3d_attention

            o = local3d_attention(*[a.detach().requires_grad_(True) for a in arrays[:3]],
                                  ext, heads)
            o.backward(arrays[3])

        rec["padded_shard_ms"] = cuda_ms(torch, shard_step, 10) if cuda else 0.0
        rec["whole_clip_ms"] = cuda_ms(torch, whole_step, 10) if cuda else 0.0
        rec["seconds"] = time.perf_counter() - t0
        out[f"seq_{tname}"] = rec
        log(f"model axes: seq halo m3 (B, S, H, W)={(b, s, h, w)} in {n} shards of "
            f"{s // n} frames + e_s {ext[0]} halo, {tname}: "
            + ", ".join(f"{k} err {v['max_abs_err']:.3g} (tol {v['tol']:.3g}, bitwise "
                        f"{v['bitwise_equal']:.5f})" for k, v in rec.items()
                        if isinstance(v, dict))
            + f"; a padded border shard fwd+bwd {rec['padded_shard_ms']:.4f} ms against the "
            f"whole clip's {rec['whole_clip_ms']:.4f} ms")
        del arrays, got, want, shard


    # tensor parallelism: a sparse layer in two head halves on the flash
    # kernels. Without a group the row-parallel sum is taken here: each
    # half's part (f32) as the all-reduce would add it, then rounded and the
    # bias added, as the layer does after its all-reduce
    bsz, ntok, dim, heads, dh, mlp = sparse
    torch.manual_seed(18)
    whole = DenseTransformer(dim, 1, heads=heads, dim_head=dh, mlp_dim=mlp,
                             attn_backend="flash").to(dev, torch.bfloat16).train()
    parts = []
    for r in range(2):
        part = copy.deepcopy(whole)
        plan = shard_params(part, Mesh(model=r, n_model=2))
        if len(plan.splits) != 4:
            raise AssertionError(f"model axes: the sparse layer split {plan.splits}")
        parts.append((part, plan))
    x = torch.randn((bsz, ntok, dim), generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((bsz, ntok, dim), generator=gen, device=dev).to(torch.bfloat16)
    rec = {}
    before = launches["flash_fwd"], launches["flash_bwd_dq"], launches["flash_bwd_dkv"]
    for i, (sub, bias) in enumerate((("attention", "0.fn.to_out.0.bias"),
                                     ("ffn", "1.fn.net.3.bias"))):
        xw = x.clone().requires_grad_(True)
        yw = whole.layers[0][i](xw)
        yw.backward(g)
        dx = 0.0
        with row_parallel_parts() as kept:
            for part, _ in parts:
                xr = x.clone().requires_grad_(True)
                part.layers[0][i](xr).backward(g)
                dx = dx + xr.grad.float()
        y_sum = ((kept[0] + kept[1]).to(torch.bfloat16)
                 + dict(whole.named_parameters())[f"layers.0.{bias}"])
        # dx: the two halves' bf16 gradients added (the all-reduce), two
        # roundings more than the whole's
        for label, got, want, tol in (("y", y_sum, yw, FWD_BF16_TOL),
                                      ("dx", dx, xw.grad, 2 * FLASH_BWD_BF16_TOL)):
            e, pk = err_of(got, want)
            if not e <= tol * pk:
                raise AssertionError(f"model axes: sparse {sub} halves' {label}: err {e} > "
                                     f"{tol * pk}")
            rec[f"{sub}_{label}"] = dict(max_abs_err=e, tol=tol * pk)
    ran = [launches[k] - v for k, v in zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                                           before)]
    if cuda and ran != [3, 3, 3]:  # the whole and the two halves
        raise AssertionError(f"model axes: the sparse attention launched {ran} flash kernels")
    worst = 0.0
    for name, p in whole.named_parameters():
        grads = [dict(part.named_parameters())[name].grad.float() for part, _ in parts]
        tol = FLASH_BWD_BF16_TOL
        if name in parts[0][1].splits or name.endswith(("to_out.0.bias", "net.3.bias")):
            # a rank's shard, or a bias added after the sum: each half's own
            pairs = [(gr, plan.shard(name, p.grad)) for gr, (_, plan) in zip(grads, parts)]
        else:  # upstream of the split (the norms, a column bias): the two
            # halves' bf16 sums added, two roundings more than the whole's
            pairs, tol = [(grads[0] + grads[1], p.grad)], 2 * FLASH_BWD_BF16_TOL
        for gr, want in pairs:
            e, pk = err_of(gr, want)
            if not e <= tol * pk:
                raise AssertionError(f"model axes: {name} grad err {e} > {tol * pk}")
            worst = max(worst, e / max(pk, 1e-30))
    rec["weight_grads_worst_rel"] = worst
    out["tp_sparse_layer"] = rec
    log(f"model axes: sparse layer (dim {dim}, {heads} heads of {dh}, mlp {mlp}, B {bsz}, "
        f"N {ntok}, bf16) in 2 head halves (flash kernels on {heads // 2} heads each): "
        + ", ".join(f"{k} err {v['max_abs_err']:.3g} (tol {v['tol']:.3g})"
                    for k, v in rec.items() if isinstance(v, dict))
        + f"; weight gradients, each half's against the whole's cut, worst {worst:.3g} x "
        "max |g|")
    del whole, parts, x, g

    # the fused block on a rank's share
    torch.manual_seed(19)
    (b, s, h, w), dim, heads, dh, ext = block
    tr = Local3dAttentionTransformer((s, h, w), dim, 16, ext, 1, heads, dh, dim,
                                     backend="fused").to(dev, torch.bfloat16).train()
    xq = torch.randn((b, s, h, w, dim), generator=gen, device=dev).to(torch.bfloat16)
    attn = tr.layers[0][0]
    y_whole = attn(xq, q=xq).detach()
    shares, rec = [], {}
    before = launches["local3d_block"]
    for r in range(2):
        part = copy.deepcopy(tr)
        shard_params(part, Mesh(model=r, n_model=2))
        layer = part.layers[0][0]
        *ops, hr = layer.fn._fused_operands(layer.norm(xq), xq, torch.bfloat16)
        ops = [t.detach().contiguous() for t in ops]
        got = local3d_block_fwd(*ops, ext, hr)
        plain = local3d_block_reference(*ops, ext, hr)
        e, pk = err_of(got, plain)
        lim = FWD_BF16_TOL * pk
        equal = float((got == plain).float().mean())
        if not (e <= lim and equal >= FWD_BF16_EQUAL):
            raise AssertionError(f"model axes: fused block share {r}: err {e} (tol {lim}), "
                                 f"{equal:.5f} bitwise")
        rec[f"share{r}"] = dict(max_abs_err=e, tol=lim, bitwise_equal=equal, heads=hr)
        with row_parallel_parts() as kept:
            layer(xq, q=xq)
        shares += kept
    if cuda and launches["local3d_block"] - before < 4:
        raise AssertionError("model axes: the shares did not run the block kernel")
    e, pk = err_of((shares[0] + shares[1]).to(torch.bfloat16), y_whole)
    lim = FWD_BF16_TOL * pk
    if not e <= lim:
        raise AssertionError(f"model axes: fused shares summed: err {e} > {lim}")
    rec["summed"] = dict(max_abs_err=e, tol=lim)
    out["fused_share"] = rec
    log(f"model axes: fused block {(b, s, h, w)} dim {dim} {heads} heads of {dh} in two "
        f"shares of one head: kernel vs plain {rec['share0']['max_abs_err']:.3g}, "
        f"{rec['share1']['max_abs_err']:.3g} (bitwise {rec['share0']['bitwise_equal']:.5f}, "
        f"{rec['share1']['bitwise_equal']:.5f}); shares summed vs the whole block {e:.3g} "
        f"(tol {lim:.3g})")
    return out


# SDAR's block-diffusion cell: (B, query heads, KV heads, L, block) of the
# attention, (tokens a call, top k, experts, held, hidden, expert width) of
# the expert layer (a step runs 4 calls a layer)
SDAR_ATTN = (8, 32, 4, 4096, 4)
SDAR_EXPERTS = (16384, 8, 128, 16, 2048, 768)
# a row's error over its norm (``row_errors``): the GEMMs sum the same bf16
# products in another order and round once (a step is 2^-8 of a value); the
# attention kernels also round P and dS at other points than the plain
# versions (tests/test_torch_port_sdar_card.py)
SDAR_ROW_TOL = {"attention": 2 ** -6, "gemm": 2 ** -7}
# the block-diffusion and expert kernels by wrapper (the ``LAUNCHES`` names),
# their source files and the names of their comparisons with the plain
# versions (``compare_sdar_kernels``)
SDAR_KERNELS = (
    ("bdflash_fwd", "flash_fwd.cu", ("bdflash_fwd", "bdflash_fwd_lse")),
    ("bdflash_bwd_dq", "flash_bwd.cu", ("bdflash_bwd_dq", "bdflash_bwd_delta")),
    ("bdflash_bwd_dkv", "flash_bwd.cu", ("bdflash_bwd_dk", "bdflash_bwd_dv")),
    ("expert_gemm_swiglu", "expert_gemm.cu", ("expert_gemm_swiglu", "expert_gemm_swiglu_act")),
    ("expert_gemm_nt", "expert_gemm.cu", ("expert_gemm_nt",)),
    ("expert_gemm_swiglu_bwd", "expert_gemm.cu", ("expert_gemm_swiglu_bwd",)),
    ("expert_gemm_nn", "expert_gemm.cu", ("expert_gemm_nn",)),
    ("expert_gemm_wgrad", "expert_gemm.cu", ("expert_gemm_wgrad_gu", "expert_gemm_wgrad_down")),
    ("expert_rows_gather", "expert_rows.cu", ("expert_rows_gather",)),
    ("expert_rows_combine", "expert_rows.cu", ("expert_rows_combine",)),
    ("expert_rows_scatter_bwd", "expert_rows.cu",
     ("expert_rows_scatter_bwd", "expert_rows_scatter_bwd_dw")))


def row_errors(torch, got, want):
    """The relative error of each row of two (..., cols) tensors, flattened:
    ||got - want|| / ||want||, a row's norm floored at a thousandth of the
    rows' rms norm (so a row of zeros compares absolutely)."""
    a = got.float().reshape(-1, got.shape[-1])
    b = want.float().reshape(-1, want.shape[-1]).to(a.device)
    norm = torch.linalg.vector_norm(b, dim=1)
    floor = 1e-3 * norm.square().mean().sqrt().clamp_min(1e-30)
    return torch.linalg.vector_norm(a - b, dim=1) / norm.clamp_min(floor)


def row_rel(torch, got, want) -> float:
    """The largest of ``row_errors``."""
    return float(row_errors(torch, got, want).max())


def compare_sdar_kernels(torch, dev) -> dict:
    """Each block-diffusion and expert kernel against its plain version on
    the same inputs, at the cell's shapes. Attention: the kernels on the
    whole batch, compared one sequence (the first and the last) and one KV
    head's group of query heads at a time with the plain functions on the
    card, each plain pass fed the kernels' inputs (the backward passes the
    forward kernel's out and lse, dk and dv the dq pass's delta). The
    grouped GEMMs and the row moves: each kernel
    on the rows the routing placed, against the wrapper on CPU copies of its
    inputs (the plain version, a loop over the experts); only the rows in
    use are compared. Each number is the largest per-row relative error
    (``row_rel``; lse: the largest absolute difference); raises past
    ``SDAR_ROW_TOL`` (lse past 2^-10)."""
    from world_modelz_tpu_torch.kernels import dense_attention as da
    from world_modelz_tpu_torch.kernels import expert_gemm as eg
    from world_modelz_tpu_torch.parallel import moe

    bf16 = torch.bfloat16
    b, hq, hkv, L, bs = SDAR_ATTN
    n, dh = 2 * L, da.BD_HEAD_SIZE
    scale, group = dh ** -0.5, hq // hkv
    gen = torch.Generator(device=dev).manual_seed(29)

    def heads(h):
        return torch.randn(b, n, h, dh, generator=gen, device=dev).to(bf16).transpose(1, 2)

    q, k, v, g = heads(hq), heads(hkv), heads(hkv), heads(hq)
    o, lse = da.bd_attention_fwd(q, k, v, bs, scale)
    dq, delta = da.bd_bwd_dq(q, k, v, o, g, lse, bs, scale)
    dk, dv = da.bd_bwd_dkv(q, k, v, g, lse, delta, bs, scale)
    err = {name: 0.0 for name in ("bdflash_fwd", "bdflash_fwd_lse", "bdflash_bwd_dq",
                                  "bdflash_bwd_delta", "bdflash_bwd_dk", "bdflash_bwd_dv")}
    for s in sorted({0, b - 1}):
        for j in range(hkv):
            hs, ks = slice(j * group, (j + 1) * group), slice(j, j + 1)
            qj, gj = q[s:s + 1, hs], g[s:s + 1, hs]
            kj, vj = k[s:s + 1, ks], v[s:s + 1, ks]
            oj, lj, dj = o[s:s + 1, hs], lse[s:s + 1, hs], delta[s:s + 1, hs]
            po, plse = da.bd_attention_fwd_plain(qj, kj, vj, bs, scale)
            pdq, pdelta = da.bd_bwd_dq_plain(qj, kj, vj, oj, gj, lj, bs, scale)
            pdk, pdv = da.bd_bwd_dkv_plain(qj, kj, vj, gj, lj, dj, bs, scale)
            for name, got, want in (("bdflash_fwd", o[s:s + 1, hs], po),
                                    ("bdflash_bwd_dq", dq[s:s + 1, hs], pdq),
                                    ("bdflash_bwd_dk", dk[s:s + 1, ks], pdk),
                                    ("bdflash_bwd_dv", dv[s:s + 1, ks], pdv)):
                rows = row_errors(torch, got, want)
                err[name] = max(err[name], float(rows.max()))
                over = rows > SDAR_ROW_TOL["attention"]
                if over.any():  # where: (head of the group, position), the row norms
                    at = torch.nonzero(over).flatten()[:8].tolist()
                    norms = torch.linalg.vector_norm(want.float().reshape(-1, dh), dim=1)
                    log(f"sdar kernels: {name} sequence {s} KV head {j}: {int(over.sum())} rows "
                        f"past the tolerance, e.g. {[divmod(r, n) for r in at]}, errors "
                        f"{rows[at].tolist()}, norms {norms[at].tolist()} (median "
                        f"{float(norms.median())})")
            err["bdflash_fwd_lse"] = max(err["bdflash_fwd_lse"], float((lj - plse).abs().max()))
            err["bdflash_bwd_delta"] = max(err["bdflash_bwd_delta"], row_rel(
                torch, dj[..., None], pdelta[..., None]))
            del oj, lj, dj, po, plse, pdq, pdelta, pdk, pdv
    del q, k, v, g, o, lse, dq, delta, dk, dv

    t, top, e, held_n, d, inter = SDAR_EXPERTS
    x = torch.randn(t, d, generator=gen, device=dev).to(bf16)
    index, weights = moe.route_topk(torch.randn(t, e, generator=gen, device=dev), top)
    plan = moe.held_plan(index, moe.held_experts(e, 0, e // held_n), e)
    used = int(plan.offsets[-1])
    w_gu = (torch.randn(held_n, 2 * inter, d, generator=gen, device=dev) * d ** -0.5).to(bf16)
    w_d = (torch.randn(held_n, d, inter, generator=gen, device=dev) * inter ** -0.5).to(bf16)
    dout = torch.randn(t, d, generator=gen, device=dev).to(bf16)
    row_of = torch.full((t * top + 1,), -1, dtype=torch.long, device=dev)
    row_of.scatter_(0, plan.assign, torch.arange(plan.assign.shape[0], device=dev))
    row_of = row_of[:-1].view(t, top)
    w_row = torch.cat([weights.reshape(-1), weights.new_zeros(1)])[plan.assign]
    xp = eg.gather_rows(x, plan.token, plan.offsets)
    gu, act = eg.swiglu_fwd(xp, w_gu, plan.offsets)
    y = eg.rows_nt(act, w_d, plan.offsets)
    dy, dw = eg.scatter_rows_bwd(dout, y, plan.token, w_row, plan.offsets)
    dgu = eg.swiglu_bwd(dy, w_d, gu, plan.offsets)
    card = {"expert_rows_gather": xp, "expert_gemm_swiglu": gu,
            "expert_gemm_swiglu_act": act, "expert_gemm_nt": y,
            "expert_rows_combine": eg.combine_rows(y, row_of, weights),
            "expert_rows_scatter_bwd": dy, "expert_rows_scatter_bwd_dw": dw,
            "expert_gemm_swiglu_bwd": dgu, "expert_gemm_nn": eg.rows_nn(dgu, w_gu, plan.offsets),
            "expert_gemm_wgrad_gu": eg.wgrad(dgu, xp, plan.offsets),
            "expert_gemm_wgrad_down": eg.wgrad(dy, act, plan.offsets)}
    c = {name: tensor.cpu() for name, tensor in dict(
        x=x, xp=xp, gu=gu, act=act, y=y, dy=dy, dgu=dgu, w_gu=w_gu, w_d=w_d, dout=dout,
        token=plan.token, off=plan.offsets, row_of=row_of, weights=weights,
        w_row=w_row).items()}
    pdy, pdw = eg.scatter_rows_bwd(c["dout"], c["y"], c["token"], c["w_row"], c["off"])
    pgu, pact = eg.swiglu_fwd(c["xp"], c["w_gu"], c["off"])
    plain = {"expert_rows_gather": eg.gather_rows(c["x"], c["token"], c["off"]),
             "expert_gemm_swiglu": pgu, "expert_gemm_swiglu_act": pact,
             "expert_gemm_nt": eg.rows_nt(c["act"], c["w_d"], c["off"]),
             "expert_rows_combine": eg.combine_rows(c["y"], c["row_of"], c["weights"]),
             "expert_rows_scatter_bwd": pdy, "expert_rows_scatter_bwd_dw": pdw,
             "expert_gemm_swiglu_bwd": eg.swiglu_bwd(c["dy"], c["w_d"], c["gu"], c["off"]),
             "expert_gemm_nn": eg.rows_nn(c["dgu"], c["w_gu"], c["off"]),
             "expert_gemm_wgrad_gu": eg.wgrad(c["dgu"], c["xp"], c["off"]),
             "expert_gemm_wgrad_down": eg.wgrad(c["dy"], c["act"], c["off"])}
    for name, got in card.items():
        want = plain[name]
        if name.startswith("expert_gemm_wgrad") or name == "expert_rows_combine":
            got = got.cpu()  # per expert (E, M, N) or per token (T, D): every row
        else:
            got, want = got[:used].cpu(), want[:used]
        err[name] = row_rel(torch, got[:, None] if got.dim() == 1 else got,
                            want[:, None] if want.dim() == 1 else want)
    out = {"errors": err, "assignments_held": int(plan.counts.sum()), "rows_used": used,
           "tolerance": SDAR_ROW_TOL}
    log(f"sdar kernels vs plain: {json.dumps(out)}")
    bad = {name: e for name, e in err.items() if e > (
        2 ** -10 if name == "bdflash_fwd_lse" else
        SDAR_ROW_TOL["attention" if name.startswith("bdflash") else "gemm"])}
    if bad:
        raise AssertionError(f"sdar kernels past their tolerance: {bad}")
    return out


def drive_block_diffusion(torch, dev, launches, smi, depth=2, batch=1, steps=6, k=2) -> dict:
    """The block-diffusion trainer (``cli.block_diffusion.train``) at SDAR's
    widths with ``depth`` layers and ``batch`` sequences of 4,096 tokens,
    ``steps`` steps ``k`` a dispatch, its counters on. On the card the step
    is one CUDA graph: its launches must be the step's kernels x the steps,
    the capture's warm-up steps outside it; every loss finite, every step
    kept, ``moe.dropped`` 0. Returns the launches (eager and replayed) and
    the run's record."""
    import math

    from world_modelz_tpu_torch.cli import block_diffusion as bdc
    from world_modelz_tpu_torch.models.sdar import MOE_CHUNK_TOKENS
    from world_modelz_tpu_torch.utils import tracing

    cfg = bdc.BlockDiffusionConfig(
        batch_size=batch, depth=depth, max_steps=steps, steps_per_dispatch=k, log_interval=k,
        output_dir=os.path.join(HERE, "build", "smoke_sdar"),
        platform="" if dev.type == "cuda" else dev.type)
    on_card = dev.type == "cuda"
    tracing.clear()
    tracing.enable()
    launches.clear()
    try:
        t0 = time.perf_counter()
        _, history, program = bdc.train(cfg)
        wall = time.perf_counter() - t0
    finally:
        tracing.disable()
    counters = tracing.collect().counters
    eager = dict(launches)
    graph, replays = dict(program.launches), program.replays
    losses = [h[1] for h in history]
    if len(losses) != steps or not all(map(math.isfinite, losses)) or not all(
            h[3] for h in history):
        raise AssertionError(f"block diffusion: losses not finite, missing or rejected: "
                             f"{history}")
    if counters.get("moe.dropped", -1) != 0 or counters.get("moe.steps") != steps:
        raise AssertionError(f"block diffusion: counters {counters}")
    # per layer: the attention's forward and two backward passes; per chunk
    # of the expert layer, the forward's gather, SwiGLU, down and combine,
    # the backward's recomputed three and its six
    c = depth * -(-batch * 2 * cfg.seq_len // MOE_CHUNK_TOKENS)
    per_step = {"bdflash_fwd": depth, "bdflash_bwd_dq": depth, "bdflash_bwd_dkv": depth,
                "expert_rows_gather": 2 * c, "expert_gemm_swiglu": 2 * c,
                "expert_gemm_nt": 2 * c, "expert_rows_combine": 2 * c,
                "expert_rows_scatter_bwd": c, "expert_gemm_swiglu_bwd": c,
                "expert_gemm_wgrad": 2 * c, "expert_gemm_nn": c}
    want_graph = {name: m * steps for name, m in per_step.items()}
    want_eager = {name: m * WARMUPS for name, m in per_step.items()}
    if on_card and (graph != want_graph or eager != want_eager or replays != steps):
        raise AssertionError(
            f"block diffusion: the graph launched {graph} in {replays} replays, expected "
            f"{want_graph}; outside it {eager}, expected {want_eager}")
    counts = {name: eager.get(name, 0) + graph.get(name, 0) for name in set(eager) | set(graph)}
    rec = {"depth": depth, "batch": batch, "steps": steps, "k": k, "wall_s": wall,
           "capture_s": program.capture_seconds, "losses": losses, "per_step": per_step,
           "counters": counters}
    log(f"block diffusion: {steps} steps, {depth} layers, batch {batch} x {cfg.seq_len}, "
        f"{wall:.2f} s (capture {program.capture_seconds:.2f} s); losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; launches from the step graph {graph}, outside it {eager}; counters {counters}; "
        f"on {smi}")
    return {"launches": counts, "record": rec}


def sdar_phase(torch, dev, launches, smi) -> dict:
    """SDAR's kernels against their plain versions (``compare_sdar_kernels``),
    timed (``check_sdar_kernels``), then the trainer driven
    (``drive_block_diffusion``)."""
    out = {"compare": compare_sdar_kernels(torch, dev)}
    torch.cuda.empty_cache()
    out["timing"] = check_sdar_kernels(torch, dev, launches, smi)
    torch.cuda.empty_cache()
    out.update(drive_block_diffusion(torch, dev, launches, smi))
    return out


def check_sdar_kernels(torch, dev, launches, smi) -> dict:
    """The block-diffusion GQA kernels and the grouped expert GEMMs at the
    SDAR cell's shapes: device time (CUDA events) beside the bound (bytes at
    3.35 TB/s or the products the mask or the routing needs at the bf16
    peak), the plain version and one library route: SDPA with the boolean
    mask (KV heads repeated) and a per-expert loop of cuBLAS products
    (``torch.matmul``), or ``torch._grouped_mm`` where this torch has it.
    The plain attention and SDPA run one sequence (the scores of eight do
    not fit) and are scaled by 8."""
    import torch.nn.functional as F

    from world_modelz_tpu_torch.kernels import dense_attention as da
    from world_modelz_tpu_torch.kernels import expert_gemm as eg
    from world_modelz_tpu_torch.parallel import moe

    bf16, peak, hbm = torch.bfloat16, 989e12, 3.35e12
    out = {"device": smi}
    b, hq, hkv, L, bs = SDAR_ATTN
    n, dh, scale = 2 * L, 128, 128 ** -0.5
    gen = torch.Generator(device=dev).manual_seed(23)

    def heads(h, rows=b):
        return torch.randn(rows, n, h, dh, generator=gen, device=dev).to(bf16).transpose(1, 2)

    q, k, v, g = heads(hq), heads(hkv), heads(hkv), heads(hq)
    pairs = b * hq * (L * bs + L * L)
    elems_q, elems_kv = b * n * hq * dh * 2, b * n * hkv * dh * 2
    o, lse = da.bd_attention_fwd(q, k, v, bs, scale)
    dq, delta = da.bd_bwd_dq(q, k, v, o, g, lse, bs, scale)
    rec = {
        "bdflash_fwd": (lambda: da.bd_attention_fwd(q, k, v, bs, scale),
                        2 * elems_q + 2 * elems_kv, 4 * pairs * dh),
        "bdflash_bwd_dq": (lambda: da.bd_bwd_dq(q, k, v, o, g, lse, bs, scale),
                           4 * elems_q + 2 * elems_kv, 3 * 2 * pairs * dh),
        "bdflash_bwd_dkv": (lambda: da.bd_bwd_dkv(q, k, v, g, lse, delta, bs, scale),
                            2 * elems_q + 4 * elems_kv, 4 * 2 * pairs * dh),
    }
    for name, (fn, nbytes, flops) in rec.items():
        ms = cuda_ms(torch, fn, 5)
        out[name] = {"ms": ms, "bound_ms": max(nbytes / hbm, flops / peak) * 1e3,
                     "tflops": flops / ms / 1e9}
    q1, k1, v1, g1 = (t[:1] for t in (q, k, v, g))
    mask = da.bd_mask(n, bs, dev)
    out["bdflash_fwd"]["plain_ms"] = 8 * cuda_ms(
        torch, lambda: da.bd_attention_fwd_plain(q1, k1, v1, bs, scale), 2, 1)
    kr, vr = (t.repeat_interleave(hq // hkv, 1) for t in (k1, v1))
    out["bdflash_fwd"]["library_ms"] = 8 * cuda_ms(
        torch, lambda: F.scaled_dot_product_attention(q1, kr, vr, attn_mask=mask), 3)
    leaves = [t.detach().requires_grad_() for t in (q1, kr, vr)]

    def sdpa_step():
        F.scaled_dot_product_attention(*leaves, attn_mask=mask).backward(g1)

    out["bdflash_bwd"] = {"library_fwd_bwd_ms": 8 * cuda_ms(torch, sdpa_step, 3)}
    log(f"sdar attention: {json.dumps(out)}")
    del q, k, v, g, o, dq, leaves

    t, top, e, held_n, d, inter = SDAR_EXPERTS
    x = torch.randn(t, d, generator=gen, device=dev).to(bf16)
    index, weights = moe.route_topk(torch.randn(t, e, generator=gen, device=dev), top)
    held = moe.held_experts(e, 0, e // held_n)
    plan = moe.held_plan(index, held, e)
    xp = torch.cat([x, x.new_zeros(1, d)])[plan.token]
    w_gu = (torch.randn(held_n, 2 * inter, d, generator=gen, device=dev) * d ** -0.5).to(bf16)
    w_d = (torch.randn(held_n, d, inter, generator=gen, device=dev) * inter ** -0.5).to(bf16)
    gu, act = eg.swiglu_fwd(xp, w_gu, plan.offsets)
    y = eg.rows_nt(act, w_d, plan.offsets)
    dgu = eg.swiglu_bwd(y, w_d, gu, plan.offsets)
    a = float(plan.counts.sum())
    counts = plan.counts.tolist()
    off = plan.offsets.tolist()
    gemms = {
        "expert_gemm_swiglu": (lambda: eg.swiglu_fwd(xp, w_gu, plan.offsets), 4 * a * d * inter,
                               lambda r, i: xp[r] @ w_gu[i].t()),
        "expert_gemm_nt": (lambda: eg.rows_nt(act, w_d, plan.offsets), 2 * a * d * inter,
                           lambda r, i: act[r] @ w_d[i].t()),
        "expert_gemm_swiglu_bwd": (lambda: eg.swiglu_bwd(y, w_d, gu, plan.offsets),
                                   2 * a * d * inter, lambda r, i: y[r] @ w_d[i]),
        "expert_gemm_nn": (lambda: eg.rows_nn(dgu, w_gu, plan.offsets), 4 * a * d * inter,
                           lambda r, i: dgu[r] @ w_gu[i]),
        "expert_gemm_wgrad_gu": (lambda: eg.wgrad(dgu, xp, plan.offsets), 4 * a * d * inter,
                                 lambda r, i: dgu[r].t() @ xp[r]),
        "expert_gemm_wgrad_down": (lambda: eg.wgrad(y, act, plan.offsets), 2 * a * d * inter,
                                   lambda r, i: y[r].t() @ act[r]),
    }
    for name, (fn, flops, one) in gemms.items():
        ms = cuda_ms(torch, fn, 10)
        spans = [slice(off[i], off[i] + c) for i, c in enumerate(counts)]
        lib = cuda_ms(torch, lambda: [one(r, i) for i, r in enumerate(spans)], 10)
        out[name] = {"ms": ms, "bound_ms": flops / peak * 1e3, "tflops": flops / ms / 1e9,
                     "library_ms": lib, "assignments": a}
    grouped = getattr(torch, "_grouped_mm", None)
    if grouped is not None:
        ends = torch.tensor([off[i] + c for i, c in enumerate(counts)], dtype=torch.int32,
                            device=dev)
        try:
            out["expert_gemm_nt"]["grouped_mm_ms"] = cuda_ms(
                torch, lambda: grouped(act, w_d.transpose(1, 2), offs=ends), 10)
        except Exception as err:  # noqa: BLE001 - a library route this torch lacks
            out["expert_gemm_nt"]["grouped_mm_error"] = str(err)[:200]
    out["routing_plan_ms"] = cuda_ms(torch, lambda: moe.held_plan(index, held, e), 10)
    # the row moves: bytes of the rows in use read and written once
    row_of = torch.full((t * top + 1,), -1, dtype=torch.long, device=dev)
    row_of.scatter_(0, plan.assign, torch.arange(plan.assign.shape[0], device=dev))
    row_of = row_of[:-1].view(t, top)
    w_row = torch.cat([weights.reshape(-1), weights.new_zeros(1)])[plan.assign]
    dout = torch.randn(t, d, generator=gen, device=dev).to(bf16)
    row_bytes = a * d * 2
    moves = {
        "expert_rows_gather": (lambda: eg.gather_rows(x, plan.token, plan.offsets),
                               2 * row_bytes,
                               lambda: torch.cat([x, x.new_zeros(1, d)])[plan.token]),
        "expert_rows_combine": (lambda: eg.combine_rows(y, row_of, weights),
                                row_bytes + t * d * 2,
                                lambda: torch.zeros(t + 1, d, device=dev).index_add_(
                                    0, plan.token, y.float() * w_row[:, None])),
        "expert_rows_scatter_bwd": (
            lambda: eg.scatter_rows_bwd(dout, y, plan.token, w_row, plan.offsets),
            3 * row_bytes, None),
    }
    for name, (fn, nbytes, lib_fn) in moves.items():
        ms = cuda_ms(torch, fn, 10)
        out[name] = {"ms": ms, "bound_ms": nbytes / hbm * 1e3}
        if lib_fn is not None:  # the plain index calls over the whole static buffer
            out[name]["library_ms"] = cuda_ms(torch, lib_fn, 10)
    log(f"sdar experts: {json.dumps(out)}")
    return out


def in_child_process(phase: str):
    """``phase`` (a name of CHILD_PHASES) run by this script in a child
    process on the same card, the kernel library already built; returns
    what the phase returned. The masked-denoise phase runs so because late
    in one long process torch.profiler loses kernel records: in the same
    run, profiles of 100 eager vq_encode calls recorded 159 of their 200
    kernels while CUDA events timed all of them, and every profile of 20
    masked-denoise replays counted 19 vq_encode launches while the graph
    ran 20 (PERF.md); in a fresh process the same profile counts them
    all."""
    out = os.path.join(HERE, "build", f"phase_{phase}.json")
    if os.path.exists(out):
        os.remove(out)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--phase", phase, out],
                   check=True, timeout=900)
    with open(out) as f:
        return json.load(f)


def run_child_phase(torch, phase: str, out: str) -> int:
    """The child's side of ``in_child_process``."""
    from world_modelz_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    result = CHILD_PHASES[phase](torch, torch.device("cuda"), _build.LAUNCHES, nvidia_smi())
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


CHILD_PHASES = {"masked_denoise": check_masked_denoise, "model_axes": check_model_axes,
                "dense_tf32": check_dense_tf32, "sdar_kernels": sdar_phase}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "world_modelz_tpu_torch", "csrc")):
        print("chip_smoke: the world_modelz_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import world_modelz_tpu_torch
    from world_modelz_tpu_torch.kernels import _build

    pkg = os.path.dirname(os.path.abspath(world_modelz_tpu_torch.__file__))
    if pkg != os.path.join(HERE, "world_modelz_tpu_torch"):
        raise RuntimeError(f"imported the port from {pkg}, not from {HERE}")
    if sys.argv[1:2] == ["--phase"]:
        return run_child_phase(torch, *sys.argv[2:4])

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {name} x {torch.cuda.device_count()}")
    log(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    _build.load_library()
    info = _build.BUILD_INFO
    log(f"build: {info['seconds']:.2f} s (built={info['built']}) {info['path']}")
    for line in ptxas_summary(str(info["log"])):
        log(f"  ptxas: {line}")

    a, a_f32 = check_local3d(torch, dev)
    b = check_vq(torch, dev)
    bwd = check_local3d_bwd(torch, dev)
    c = check_vq_train(torch, dev)
    flash = check_flash(torch, dev)
    block = check_local3d_block(torch, dev)
    dense = check_dense_tf32(torch, dev, _build.LAUNCHES, smi)
    t_axes = time.perf_counter()
    model_axes = check_model_axes(torch, dev, _build.LAUNCHES, smi)
    model_axes["seconds"] = time.perf_counter() - t_axes
    log(f"model axes: {model_axes['seconds']:.1f} s on {smi}")
    check_slice_parity(torch, dev)
    check_slice_parity(torch, dev, tokenizer=None, backend="fused")
    check_train_grads(torch, dev, _build.LAUNCHES)
    check_train_grads(torch, dev, _build.LAUNCHES, backend="fused")
    check_tokenizer_train_step(torch, dev, _build.LAUNCHES)
    check_sparse_parity(torch, dev, _build.LAUNCHES)
    serving = drive_serving(torch, dev, _build.LAUNCHES)
    log(f"serving: measured on {smi}")
    serving_fused = drive_serving(torch, dev, _build.LAUNCHES, backend="fused")
    log(f"serving (fused): measured on {smi}")
    compare_serving(torch, dev)
    # the trainers' step programs (CUDA graphs) against their eager steps
    steps = {"auto": check_step_program(torch, dev, smi),
             "fused": check_step_program(torch, dev, smi, backend="fused"),
             "accumulation": check_step_program(torch, dev, smi, accumulation_steps=2,
                                                parity=8, timed=0),
             "composite": check_step_program(torch, dev, smi, device_composite=True,
                                             timed=0),
             "sparse": check_step_program(torch, dev, smi, kind="sparse")}
    i3d_path, i3d = check_i3d(torch, dev, smi)
    composite = check_composite(torch, dev, smi)
    composite["sparse_source"] = time_sparse_source(torch, dev)
    # the trainer at k = 1 (the first run's checkpoint feeds the rollout,
    # evaluation and serving phases), then at k = 10, each on pixels and on
    # trajectories composited in the step graph in turns (A B B A)
    k1 = training_turns(torch, dev, _build.LAUNCHES, smi, 1)
    training, train_a = k1[0]
    dispatch_runs = [rec for _, rec in k1 + training_turns(
        torch, dev, _build.LAUNCHES, smi, 10)]
    compare_dispatch_runs(torch, "training", [dispatch_runs[i] for i in (0, 3, 4, 7)])
    compare_dispatch_runs(torch, "training (device_composite)",
                          [dispatch_runs[i] for i in (1, 2, 5, 6)])
    rollout = drive_rollout(torch, dev, _build.LAUNCHES, smi, i3d_weights=i3d_path)
    serving_http, graphs = drive_serving_http(torch, dev, _build.LAUNCHES, smi)
    training_fused, train_fused = drive_training(
        torch, dev, _build.LAUNCHES, smi, backend="fused",
        root=os.path.join(HERE, "build", "smoke_fused"))
    tokenizer = drive_tokenizer_training(torch, dev, _build.LAUNCHES, smi)
    sparse, sparse_a = drive_sparse_training(torch, dev, _build.LAUNCHES, smi)
    _, sparse_b = drive_sparse_training(
        torch, dev, _build.LAUNCHES, smi, steps_per_dispatch=4, full=False,
        root=os.path.join(HERE, "build", "smoke_sparse_k4"))
    compare_dispatch_runs(torch, "sparse training", [sparse_a, sparse_b])
    # sparse diffusion's rest (mixture of experts, the external tokenizer)
    # and the SOM-DDPM pipeline
    moe = check_moe(torch, dev, smi)
    sparse_moe, moe_a, moe_step = drive_sparse_moe(torch, dev, _build.LAUNCHES, smi, sparse_a)
    sparse_ext, ext = check_external_tokenizer(torch, dev, _build.LAUNCHES, smi)
    som = drive_som_pipeline(torch, dev, smi)
    # masked-denoise (its VQ kernels at the patch widths, the gMLP, the
    # trainer's step graph; in a fresh process, whose profiler keeps every
    # kernel record), then the data axis under NCCL (a world of one; the
    # group is gone after it)
    masked_denoise, md = in_child_process("masked_denoise")
    # SDAR's block-diffusion and expert kernels against their plain
    # versions and timed at the cell's shapes, then its trainer (a fresh
    # process: the cell's shapes want the card's memory)
    sdar = in_child_process("sdar_kernels")
    data_parallel = check_data_parallel(torch, dev, smi)
    from world_modelz_tpu_torch.data import native

    log(f"sparse training: {sparse_a['steps_per_s']:.4f} (k=1), {sparse_b['steps_per_s']:.4f} "
        f"(k=4) steps/s over steps 11-60, frames rendered by the host compositor's "
        f"{native.backend()} path (render_trajectory)")
    # launches of the ten main paths, each counted in its own runs (the
    # graphs' as captured x replays)
    paths = (serving, serving_fused, training, rollout, serving_http,
             training_fused, tokenizer, sparse, sparse_moe, sparse_ext, masked_denoise)
    counts = {key: sum(p.get(key, 0) for p in paths)
              for key in set().union(*paths)}
    log(f"launches: serving {serving}, fused serving {serving_fused}, training "
        f"{training}, rollout and evaluation {rollout}, exported programs over "
        f"HTTP {serving_http}, fused training "
        f"{training_fused}, tokenizer training {tokenizer}, sparse training {sparse}, "
        f"sparse training with experts {sparse_moe}, sparse training with the external "
        f"tokenizer {sparse_ext}, masked-denoise {masked_denoise}")

    kernels = [
        dict(name="local3d_fwd", route="cuda",
             source="world_modelz_tpu_torch/csrc/local3d_fwd.cu",
             replaces="world_modelz_tpu/kernels/local3d.py:1493",
             launches=counts["local3d_fwd"], **a),
        dict(name="vq_encode", route="cuda",
             source="world_modelz_tpu_torch/csrc/vq_encode.cu",
             replaces="world_modelz_tpu/kernels/vq_kernels.py:34",
             launches=counts["vq_encode"], **b),
        dict(name="local3d_bwd_dq", route="cuda",
             source="world_modelz_tpu_torch/csrc/local3d_bwd.cu",
             replaces="world_modelz_tpu/kernels/local3d.py:1183",
             launches=counts["local3d_bwd_dq"], **bwd["local3d_bwd_dq"]),
        dict(name="local3d_bwd_dkv", route="cuda",
             source="world_modelz_tpu_torch/csrc/local3d_bwd.cu",
             replaces="world_modelz_tpu/kernels/local3d.py:1261",
             launches=counts["local3d_bwd_dkv"], **bwd["local3d_bwd_dkv"]),
        dict(name="vq_train_stats", route="cuda",
             source="world_modelz_tpu_torch/csrc/vq_train.cu",
             replaces="world_modelz_tpu/kernels/vq_kernels.py:146",
             launches=counts["vq_train_stats"], **c),
        dict(name="local3d_block", route="cuda",
             source="world_modelz_tpu_torch/csrc/local3d_block.cu",
             replaces="world_modelz_tpu/kernels/local3d_block.py:122",
             launches=counts["local3d_block"], **block),
        dict(name="dense_tf32", route="cuda",
             source="world_modelz_tpu_torch/csrc/dense_tf32.cu",
             replaces="none: the JAX package leaves dense layers to XLA",
             launches=counts.get("dense_tf32", 0), **dense),
    ] + [
        dict(name=name, route="cuda",
             source=f"world_modelz_tpu_torch/csrc/{src}",
             replaces=f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
             launches=counts[name], **flash[name])
        for name, src, line in (("flash_fwd", "flash_fwd.cu", 331),
                                ("flash_bwd_dq", "flash_bwd.cu", 1146),
                                ("flash_bwd_dkv", "flash_bwd.cu", 796))
    ]
    timing, errors = sdar["timing"], sdar["compare"]["errors"]
    timing["expert_gemm_wgrad"] = {"gate_up": timing["expert_gemm_wgrad_gu"],
                                   "down": timing["expert_gemm_wgrad_down"]}
    kernels += [
        dict(name=name, route="cuda", source=f"world_modelz_tpu_torch/csrc/{src}",
             replaces="none: the JAX package has no block-diffusion or grouped expert layer",
             launches=sdar["launches"].get(name, 0),
             vs_plain={e: errors[e] for e in compared}, **timing[name])
        for name, src, compared in SDAR_KERNELS]
    # the f32 forward of the evaluation sweep, beside the bf16 training record
    next(k for k in kernels if k["name"] == "flash_fwd")["eval_f32"] = flash["flash_fwd_eval"]
    # the f32 local-3D forward the rollout CLI runs, beside the bf16 serving
    # record (its launches: the rollout phase's, all f32)
    next(k for k in kernels if k["name"] == "local3d_fwd")["rollout_f32"] = dict(
        a_f32, launches=rollout["local3d_fwd"])
    # the exported programs' launches, replayed from CUDA graphs (in the
    # totals above), with the f32 kernel the graphs captured
    next(k for k in kernels if k["name"] == "local3d_fwd")["serving_graphs"] = graphs
    next(k for k in kernels if k["name"] == "vq_encode")["serving_graphs"] = dict(
        launches=serving_http["vq_encode"],
        kernels=["vq_prep_kernel", "vq_encode_kernel<float>"])
    # the trainers' step graphs: the launches their replays made in the main
    # training runs (in the totals above), and a step's captured launches
    runs = {"train_step/m3_b64_g8_full": train_a, "fused": train_fused,
            "train_sparse/s16_n1024_b16": sparse_a,
            "train_sparse/s16_n1024_b16 moe_experts 8": moe_a}
    for k in kernels:
        per_step = {run: rec["per_step"][k["name"]] for run, rec in runs.items()
                    if rec["per_step"].get(k["name"])}
        if per_step:
            k["training_graphs"] = dict(
                launches=sum(rec["graph"].get(k["name"], 0) for rec in runs.values()),
                per_step=per_step)
    steps["sparse_moe"] = moe_step
    # masked-denoise's VQ kernels at the patch widths (D = 12, 48), with its
    # launches (in the totals above)
    md_vq = md.pop("md_vq")
    next(k for k in kernels if k["name"] == "vq_encode")["masked_denoise"] = dict(
        launches=masked_denoise.get("vq_encode", 0),
        d12=md_vq["masked_denoise_d12"], d48=md_vq["masked_denoise_d48"])
    next(k for k in kernels if k["name"] == "vq_train_stats")["masked_denoise"] = dict(
        launches=masked_denoise.get("vq_train_stats", 0), d12=md_vq["masked_denoise_d12_train"])
    log(json.dumps({"masked_denoise": md, "data_parallel": data_parallel,
                    "model_axes": model_axes}))
    log(json.dumps({"moe": moe, "external_tokenizer": ext, "som_ddpm": som,
                    "block_diffusion": sdar["record"]}))
    log(json.dumps({"step_programs": steps, "i3d": i3d, "composite": composite, "dispatch": [
        {key: r.get(key) for key in ("k", "data", "steps_per_s", "busy", "device_ms_per_step",
                                     "host_calls_per_step", "capture_s", "peak_gib",
                                     "data_ms", "batch_bytes", "data_wait_pct")}
        for r in dispatch_runs + [sparse_a, sparse_b, moe_a]]}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
