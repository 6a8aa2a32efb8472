#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's hand-written CUDA kernels from ``world_modelz_tpu_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on
the card, checks the full-width denoiser and the tokenizer on the card
against the same modules on the CPU, and drives the serving path
(``RolloutService``: encode -> 30-iteration unmask rollout -> decode) at the
``serve/m3_g8`` configuration with random seeded weights.

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

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: HBM rate, and the peak rate for each
# operand type (bf16 tensor cores, f32 CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

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

F32_TOL = 1e-4  # f32 kernel vs plain: the same sums in another order
BF16_TOL = 2e-2  # bf16 output rounding (2^-8 relative) of O(1) values
LOGIT_TOL = 1e-3  # 20 f32 layers, cuBLAS vs CPU BLAS summation order
PIXEL_RTOL = 1e-4  # f32 convolutions, cuDNN vs CPU, relative to max |pixel|
VQ_GAP = 1e-3  # rows whose two nearest codes differ by more must agree


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters: int, warmup: int = 3, label: str = "") -> float:
    """Mean device time per call of ``fn`` in ms: the kernels and copies it
    issues, as torch.profiler (CUPTI) traces them, without the host's gaps
    between launches. With ``label``, logs the split by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in events)
    if label:
        for e in events:
            log(f"  {label}: {e.self_device_time_total / 1e3 / iters:.5f} ms "
                f"per call in {e.key[:70]}")
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / 1e3 / iters


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


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases


def check_local3d(torch, dev):
    """Kernel A against its plain version at the serving, training and a
    multi-head asymmetric shape, in f32 and bf16. Returns the serving-shape
    bf16 record."""
    import torch.nn.functional as F

    from world_modelz_tpu_torch.kernels import local3d_attention_fwd
    from world_modelz_tpu_torch.models.attention import local3d_attention

    cases = [  # name, (B, S, H, W), heads, dh, extents
        ("serving", (8, 6, 8, 8), 1, 128, (3, 1, 1)),
        ("training", (8, 6, 16, 16), 1, 128, (3, 1, 1)),
        ("multihead", (8, 6, 8, 8), 2, 64, (1, 2, 1)),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    serving = None
    for name, (b, s, h, w), heads, dh, ext in cases:
        for dtype in (torch.float32, torch.bfloat16):
            shape = (b, s, h, w, heads * dh)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            out = local3d_attention_fwd(q, k, v, ext, heads)
            plain = local3d_attention(q.float(), k.float(), v.float(), ext, heads)
            torch.cuda.synchronize()
            err = float((out.float() - plain).abs().max())
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            if not err <= tol:
                raise AssertionError(
                    f"local3d {name} {dtype}: max abs err {err} > {tol}")
            kernel = lambda: local3d_attention_fwd(q, k, v, ext, heads)  # noqa: E731
            ms = device_ms(torch, kernel, 100)
            launch_ms = cuda_ms(torch, kernel, 200)
            plain_ms = device_ms(
                torch, lambda: local3d_attention(q, k, v, ext, heads), 10)
            # library yardstick: SDPA over all S*H*W tokens with a dense
            # boolean window mask
            n = s * h * w
            qs, ks, vs = (t.reshape(b, n, heads, dh).transpose(1, 2) for t in (q, k, v))
            pos = torch.stack(torch.meshgrid(
                torch.arange(s), torch.arange(h), torch.arange(w),
                indexing="ij"), -1).reshape(n, 3).to(dev)
            mask = ((pos[:, None, :] - pos[None, :, :]).abs()
                    <= torch.tensor(ext, device=dev)).all(-1)
            lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask), 20)
            isz = torch.tensor([], dtype=dtype).element_size()
            nbytes = 4 * q.numel() * isz
            ops = 4 * dh * heads * b * window_pairs(s, h, w, ext)
            tname = str(dtype).replace("torch.", "")
            bound_ms, bound_by = bound(nbytes, ops, tname)
            log(f"local3d_fwd {name} {tname} {shape} extents={ext}: "
                f"max_abs_err={err:.3g} (tol {tol}) kernel_ms={ms:.5f} "
                f"back_to_back_ms={launch_ms:.5f} plain_ms={plain_ms:.5f} "
                f"library_ms={lib_ms:.5f} "
                f"bound_us={bound_ms * 1e3:.4f} ({bound_by})")
            if name == "serving" and dtype == torch.bfloat16:
                serving = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=lib_ms)
    return serving


def check_vq(torch, dev):
    """Kernel B against its plain version at the serving encode batch (f32,
    as the tokenizer feeds it, and bf16) and at the tokenize-benchmark
    batch. Returns the serving f32 record."""
    from world_modelz_tpu_torch.kernels import vq_encode_nearest
    from world_modelz_tpu_torch.ops.vq import vq_encode

    k, d = TOKENIZER["num_embeddings"], TOKENIZER["embedding_dim"]
    gen = torch.Generator(device=dev).manual_seed(1)
    codebook = torch.randn((k, d), generator=gen, device=dev)
    serving = None
    cases = [("serving", 8 * SEQ * GRID * GRID, torch.float32),
             ("serving", 8 * SEQ * GRID * GRID, torch.bfloat16),
             ("bench", 256 * GRID * GRID, torch.float32)]
    for name, n, dtype in cases:
        x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        got = vq_encode_nearest(x, codebook).long()
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
        nbytes = n * d * x.element_size() + k * d * 4 + n * 4
        ops = 2 * n * k * d + 2 * k * d + 2 * n * k
        bound_ms, bound_by = bound(nbytes, ops, "float32")  # f32 FMAs
        tname = str(dtype).replace("torch.", "")
        log(f"vq_encode {name} {tname} N={n} K={k} D={d}: agree={share:.5f} "
            f"max_abs_err={regret:.3g} (distance) kernel_ms={ms:.5f} "
            f"back_to_back_ms={launch_ms:.5f} plain_ms={plain_ms:.5f} "
            f"library_ms=null "
            f"bound_us={bound_ms * 1e3:.4f} ({bound_by})")
        if name == "serving" and dtype == torch.float32:
            serving = dict(max_abs_err=regret, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None)
    return serving


def check_slice_parity(torch, dev, denoiser=DENOISER, tokenizer=TOKENIZER,
                       batch=2):
    """The denoiser in f32 and the tokenizer on the card (kernel path)
    against the same weights on the CPU (plain path)."""
    from world_modelz_tpu_torch.models import VQAutoEncoder, VqVideoDiffusionModel
    from world_modelz_tpu_torch.ops.vq import codebook_distances

    torch.manual_seed(0)
    cpu = VqVideoDiffusionModel(**denoiser, device="cpu")
    card = VqVideoDiffusionModel(**denoiser, device=dev)
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
    log(f"denoiser f32 logits {tuple(got.shape)}: max_abs_err={err:.3g} "
        f"(tol {LOGIT_TOL}, logits span {float(want.abs().max()):.3g})")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"denoiser logits differ by {err}")

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


def drive_serving(torch, dev, launches, tokenizer=TOKENIZER,
                  denoiser=DENOISER, service=SERVICE, img=IMG):
    """The serving path at full width with a bf16 denoiser: 8 concurrent
    seed clips, then one session with two generate() calls. Returns the
    launch counts of that run."""
    import numpy as np

    from world_modelz_tpu_torch.models import VQAutoEncoder, VqVideoDiffusionModel
    from world_modelz_tpu_torch.serve import RolloutService

    device = None if dev.type == "cuda" else dev  # None: the CUDA default
    torch.manual_seed(2)
    tok = VQAutoEncoder(**tokenizer, device=device)
    model = VqVideoDiffusionModel(**denoiser, device=device,
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
            profile_batch(torch, svc, clips[: service["batch_size"]], t_batch)
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
    want = {"local3d_fwd": per_batch * delta["batches"],
            "vq_encode": delta["encode_calls"]}
    for name, n in want.items():
        if counts.get(name, 0) != n or n == 0:
            raise AssertionError(
                f"{name} launched {counts.get(name, 0)} times, expected {n}")
    b = service["batch_size"]
    log(f"serving: stats delta {delta}")
    log(f"serving: {b} clips x {frames} frames in {t_batch:.3f} s = "
        f"{b / t_batch:.4f} clips/s, {b * frames / t_batch:.3f} frames/s; "
        f"session 2 x {frames} frames in {t_sess:.3f} s = "
        f"{2 * frames / t_sess:.3f} frames/s")
    log(f"serving: pixel range [{min(o.min() for o in outs):.4g}, "
        f"{max(o.max() for o in outs):.4g}]; launches {counts} "
        f"({per_batch} local3d_fwd per rollout batch)")
    return counts


def profile_batch(torch, svc, clips, t_batch: float) -> None:
    """One more rollout batch under torch.profiler: device time by kernel,
    and the device's busy share of the unprofiled batch time ``t_batch``
    (kernels run in order on one stream, so their sum is the busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        [f.result(timeout=600) for f in [svc.submit(c) for c in clips]]
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    log(f"profile: one batch, device busy {busy_us / 1e3:.3f} ms of "
        f"{t_batch * 1e3:.3f} ms unprofiled wall = "
        f"{busy_us / 1e6 / t_batch:.4f} busy share "
        f"({wall * 1e3:.3f} ms wall under the profiler); "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:7d} x  {e.key[:90]}")


# -------------------------------------------------------------------- main


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
    for line in str(info["log"]).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")

    a = check_local3d(torch, dev)
    b = check_vq(torch, dev)
    check_slice_parity(torch, dev)
    counts = drive_serving(torch, dev, _build.LAUNCHES)
    log(f"serving: measured on {smi}")

    kernels = [
        dict(name="local3d_fwd", route="cuda",
             source="world_modelz_tpu_torch/csrc/local3d_fwd.cu",
             replaces="world_modelz_tpu/kernels/local3d.py:1493",
             launches=counts["local3d_fwd"], **a),
        dict(name="vq_encode", route="cuda",
             source="world_modelz_tpu_torch/csrc/vq_encode.cu",
             replaces="world_modelz_tpu/kernels/vq_kernels.py:34",
             launches=counts["vq_encode"], **b),
    ]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
