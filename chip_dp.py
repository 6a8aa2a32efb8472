#!/usr/bin/env python3
"""Time the trainers' mesh axes on N GPUs: the video trainer's data axis
(replicated data parallelism against ``--fsdp``, in turns), or with
``--legs`` the model axes.

    python3 chip_dp.py [--gpus 4] [--steps 40] [--per_rank_batch 64]
    python3 chip_dp.py --legs tp,ep,seq,pipe,tp_fsdp [--steps 30]
    python3 chip_dp.py --cpu [--legs ...]   # the same runs, tiny, on gloo

One process per GPU (spawned here; NCCL over tcp://127.0.0.1) runs
``cli.video_diffusion.train`` at the width of chip_smoke.py's
train_step/m3_b64_g8_full (``chip_smoke.TRAIN``) with a global batch of
``per_rank_batch`` x N, in the order dp, fsdp, fsdp, dp: replicated
(gradients all-reduced, every rank holding the whole optimizer state and
EMA) and ``--fsdp`` (gradients reduce-scattered, each rank holding 1 / N of
Adam's moments, of the f32 parameters it updates and of the EMA; the
model's parameters and gradients stay whole on every rank). For each run:
steps/s over steps 11..``steps`` by rank 0's host clock, each rank's peak
device memory (``torch.cuda.max_memory_allocated``), the MiB of f32
parameters, Adam's moments and EMA each rank holds, the last loss, and whether every
rank ends with the same parameters. Then this process runs the same
trainer alone (no process group) at ``per_rank_batch``: the scaling
reference. Prints one JSON line of the runs, then the card's name and
power limit as nvidia-smi gives them. Exits non-zero if a run fails, the
ranks disagree, or there is no GPU (without ``--cpu``).

``--legs`` (``LEGS``, the JAX package's multi-chip dry run's legs), in
turn in one world of four processes, one process a GPU, under the same
fail-fast parent:
- ``tp``: the sparse trainer at train_sparse/s16_n1024_b16's width,
  data=2 x model=2;
- ``ep``: the same with 8 experts, model=4 (two experts a rank);
- ``seq``: the video trainer at m3's width with 16-frame clips
  (n_past=15), data=1 x seq=4 (4 frames a rank, e_s 3);
- ``pipe``: the sparse trainer, pipe=2 x data=2, n_micro=4;
- ``tp_fsdp``: the video trainer at m3's width, data=2 x model=2 with
  ``--fsdp`` (one head of 128: q, k and v gathered).
For each leg: the first step in f32 on the global batch of seeded tokens
(the video trainer's frames carry their tokens, so no tokenizer runs):
its loss and the whole gradient (reduced over the data and seq axes,
gathered over the model or pipe axis) against this process's one-card step
on the same batch, within 1e-6 x max(1, max |g|); whether a CUDA graph
captures the seq or pipe axis's ppermute (``all_to_all_single``) and
replays it right; then the trainer itself (bf16 as
configured, its step a CUDA graph) for ``--steps`` steps: steps/s over
steps 11 on by rank 0's host clock, each rank's peak memory, and whether
every rank ends with the same whole parameters. Rank 0 prints each
leg's record as it ends; a leg that fails is recorded with its ranks'
error output, and ends the world (the legs after it are recorded as not
run).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import socket
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "build", "dp_bench")
# --cpu: a denoiser small enough for four CPU processes
TINY = dict(dim=32, depth=1, dim_head=16, heads=2, mlp_dim=24, image_size=16,
            digit_size=6, n_past=2, bf16=False, tok_bf16=False)
TINY_TOKENIZER = dict(embedding_dim=8, num_embeddings=16, downscale_steps=2,
                      hidden_planes=8, in_channels=1)


def _config(args, tok_path, batch, out, fsdp):
    import chip_smoke
    from world_modelz_tpu_torch.cli.video_diffusion import VideoDiffusionConfig

    train = dict(chip_smoke.TRAIN, **(TINY if args.cpu else {}))
    train.update(batch_size=batch, max_steps=args.steps, checkpoint_interval=0,
                 log_interval=args.steps)
    return VideoDiffusionConfig(**train, decoder_model=tok_path, output_dir=out,
                                platform="cpu" if args.cpu else "", fsdp=fsdp)


def _run(args, tok_path, batch, name, fsdp, mesh_rank=0):
    """One trainer run; returns its record (and the final flat parameters)."""
    import torch

    from world_modelz_tpu_torch.cli.video_diffusion import train

    on_card = not args.cpu
    gc.collect()  # the last run's graph and buffers
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = _config(args, tok_path, batch, os.path.join(ROOT, f"{name}_r{mesh_rank}"), fsdp)
    res = train(cfg)
    opt = res.state.optimizer
    held = [opt.flat, opt.mu, opt.nu, *opt.extra_tensors()]
    if res.state.ema_flat is not None:
        held.append(res.state.ema_flat)
    t = {h[0]: h[4] for h in res.history}
    rec = dict(
        run=name, fsdp=fsdp, global_batch=cfg.batch_size,
        steps_per_s=(args.steps - 10) / (t[args.steps] - t[10]),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
        held_mib=sum(x.numel() * x.element_size() for x in held) / 2**20,
        last_loss=res.history[-1][1], rejected=res.rejected)
    return rec, res.state.optimizer.gather_full(opt.flat)


def _worker(rank, world, port, args, tok_path, out_path):
    import torch

    from world_modelz_tpu_torch.parallel import distributed as pdist
    from world_modelz_tpu_torch.parallel.mesh import make_mesh

    recs = []
    try:
        dev = torch.device("cpu" if args.cpu else "cuda", rank if not args.cpu else None)
        if not args.cpu:
            os.environ["LOCAL_RANK"] = str(rank)
        pdist.initialize_distributed(f"127.0.0.1:{port}", world, rank, device=dev)
        mesh = make_mesh()
        for name in ("dp", "fsdp", "fsdp", "dp"):
            rec, flat = _run(args, tok_path, args.per_rank_batch * world,
                             f"{name}{len(recs)}", name == "fsdp", rank)
            every = pdist.all_gather_rows(flat[None], mesh)
            rec["ranks_equal"] = all(torch.equal(r, every[0]) for r in every)
            rec["peak_gib_by_rank"] = pdist.all_gather_rows(
                torch.tensor([rec["peak_gib"] or 0.0], device=flat.device), mesh).tolist()
            recs.append(rec)
    except BaseException:
        # said at once, and the process gone, so that no rank waits on it
        print(f"chip_dp: rank {rank} failed:\n{traceback.format_exc()}", file=sys.stderr,
              flush=True)
        os._exit(1)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(recs, f)
    torch.distributed.destroy_process_group()


# leg -> (trainer, mesh axes, config fields)
LEGS = {
    "tp": ("sparse", dict(n_model=2), {}),
    "ep": ("sparse", dict(n_model=4), dict(moe_experts=8)),
    "seq": ("video", dict(n_seq=4), dict(n_past=15)),
    "pipe": ("sparse", dict(n_pipe=2), dict(n_micro=4)),
    "tp_fsdp": ("video", dict(n_model=2), dict(fsdp=True)),
}
# --cpu: the legs' trainers small enough for four CPU processes
TINY_VIDEO = dict(TINY, heads=1, batch_size=4)
TINY_SPARSE = dict(image_size=16, S=4, H=4, W=4, num_context=24, dim=32, heads=2, depth=2,
                   mlp_dim=24, batch_size=4, buffer_size=200, bf16=False)


class _TokenFrames:
    """A stand-in tokenizer for the first-step check: the frames carry
    their tokens (channel 0), so every layout sees the same tokens and no
    convolution's summation order can move a code."""

    def __init__(self, num_embeddings):
        self.num_embeddings = num_embeddings

    def encode(self, x):
        return x[..., 0].long()


def _leg_config(args, leg, paths, f32=False):
    import chip_smoke
    from world_modelz_tpu_torch.cli.sparse_diffusion import SparseDiffusionConfig
    from world_modelz_tpu_torch.cli.video_diffusion import VideoDiffusionConfig

    kind, axes, fields = LEGS[leg]
    base = (dict(chip_smoke.TRAIN, **(TINY_VIDEO if args.cpu else {})) if kind == "video"
            else dict(chip_smoke.SPARSE_TRAIN, **(TINY_SPARSE if args.cpu else {})))
    base.update(fields, **axes, max_steps=args.steps, log_interval=args.steps,
                checkpoint_interval=0, eval_interval=0, decoder_model=paths[kind],
                output_dir=os.path.join(ROOT, leg), platform="cpu" if args.cpu else "")
    if f32:
        base.update(bf16=False)
    return (VideoDiffusionConfig if kind == "video" else SparseDiffusionConfig)(**base)


def _first_step(args, leg, mesh, paths, device):
    """The leg's first step in f32 on a global batch of seeded tokens:
    (its loss, the whole gradient as one flat vector on the CPU)."""
    import numpy as np
    import torch

    from world_modelz_tpu_torch.cli import sparse_diffusion as sd
    from world_modelz_tpu_torch.cli import video_diffusion as vd
    from world_modelz_tpu_torch.parallel.distributed import shard_host_batch

    import chip_smoke

    cfg = _leg_config(args, leg, paths, f32=True)
    tok_cfg = TINY_TOKENIZER if args.cpu else chip_smoke.TOKENIZER
    if LEGS[leg][0] == "sparse":
        tok_cfg = dict(TINY_TOKENIZER, in_channels=3) if args.cpu else chip_smoke.SPARSE_TOKENIZER
    k = tok_cfg["num_embeddings"]
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=device).manual_seed(2)
    torch.manual_seed(0)
    b = cfg.batch_size
    if LEGS[leg][0] == "video":
        grid = cfg.image_size // 2 ** tok_cfg["downscale_steps"]
        shape = (cfg.n_past + 1, grid, grid)
        state = vd.init_state(cfg, vd.make_model(cfg, shape, k, device), mesh)
        tokens = torch.from_numpy(rng.integers(0, k, (b, *shape, 1)).astype(np.float32))
        draws = vd.draw_step(gen, b, grid * grid, state.sampler.weights.shape[0], k)
        row = vd.step_body(state, _TokenFrames(k),
                           {"frames": shard_host_batch(tokens, mesh).to(device)}, cfg, draws)
    else:
        state = sd.init_state(cfg, sd.make_model(cfg, k, device), mesh)
        batch_z = torch.from_numpy(rng.integers(0, k, (b, cfg.S, cfg.H, cfg.W)))
        volume = cfg.S * cfg.H * cfg.W
        draws = sd.draw_step(gen, b, cfg.num_context, volume, state.sampler.weights.shape[0], k)
        row = sd.step_body(state, shard_host_batch(batch_z, mesh).to(device), cfg, draws)
    opt = state.optimizer
    g = state.plan.gather_flat(opt.gather_full(opt.reduced_grad()))
    return float(row[0]), g.cpu()


def _probe_ppermute(mesh, device):
    """Capture a ppermute over the seq or pipe axis in a CUDA graph and
    replay it; raises if it does not capture or gives the wrong values."""
    import torch

    from world_modelz_tpu_torch.parallel import distributed as pdist

    axis = mesh.axis("seq" if mesh.n_seq > 1 else "pipe")
    perm = [(i, i + 1) for i in range(axis.size - 1)]
    x = torch.full((4, 1024), float(axis.index + 1), device=device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pdist.ppermute(x, axis, perm)  # warm-up: communicators made
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = pdist.ppermute(x, axis, perm)
    graph.replay()
    torch.cuda.synchronize()
    want = float(axis.index) if axis.index > 0 else 0.0
    if float(y[0, 0]) != want:
        raise AssertionError(f"replayed ppermute gave {float(y[0, 0])}, not {want}")
    return "captured"


def _run_leg(args, leg, rank, world, paths, dev) -> dict:
    """One leg in the running world: its record (rank 0 also saves the
    first step's whole gradient for the one-card comparison)."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from world_modelz_tpu_torch.cli import sparse_diffusion as sd
    from world_modelz_tpu_torch.cli import video_diffusion as vd
    from world_modelz_tpu_torch.parallel import distributed as pdist
    from world_modelz_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(**LEGS[leg][1])
    rec = dict(leg=leg, layout=dict(mesh.shape), ppermute=None)
    if not args.cpu and (mesh.n_seq > 1 or mesh.n_pipe > 1):
        rec["ppermute"] = _probe_ppermute(mesh, dev)
    rec["first_loss"], grad = _first_step(args, leg, mesh, paths, dev)
    if rank == 0:
        np.save(os.path.join(ROOT, f"{leg}_grad.npy"), grad.numpy())
    if not args.cpu:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = _leg_config(args, leg, paths)
    res = (vd.train if LEGS[leg][0] == "video" else sd.train)(cfg)
    opt = res.state.optimizer
    whole = res.state.plan.gather_flat(opt.gather_full(opt.flat)).contiguous()
    every = whole.new_empty((world * whole.numel(),))
    pdist._all_gather(every, whole)
    every = every.view(world, -1)
    t = {h[0]: h[4] for h in res.history}
    peaks = torch.zeros(world, device=whole.device)
    peaks[rank] = torch.cuda.max_memory_allocated() / 2**30 if not args.cpu else 0.0
    dist.all_reduce(peaks)
    rec.update(global_batch=cfg.batch_size, steps=args.steps,
               steps_per_s=(args.steps - 10) / (t[args.steps] - t[10]),
               peak_gib_by_rank=peaks.tolist(), last_loss=res.history[-1][1],
               rejected=res.rejected,
               ranks_equal=all(torch.equal(r, every[0]) for r in every),
               params=int(whole.numel()), world_s=time.perf_counter() - t0)
    del res, opt, whole, every
    gc.collect()
    return rec


def _legs_worker(rank, world, port, args, paths):
    """Every leg in one world: rank 0 writes each leg's record as it ends
    (and prints it), so a later leg's failure keeps the earlier ones."""
    import torch

    from world_modelz_tpu_torch.parallel import distributed as pdist

    leg = None
    try:
        dev = torch.device("cpu" if args.cpu else "cuda", None if args.cpu else rank)
        if not args.cpu:
            os.environ["LOCAL_RANK"] = str(rank)
        pdist.initialize_distributed(f"127.0.0.1:{port}", world, rank, device=dev)
        dev = pdist.process_device(dev)
        for leg in args.legs:
            rec = _run_leg(args, leg, rank, world, paths, dev)
            if rank == 0:
                with open(os.path.join(ROOT, f"{leg}.json"), "w") as f:
                    json.dump(rec, f)
                print(json.dumps({"leg_done": rec}), flush=True)
    except BaseException:
        err = f"chip_dp: leg {leg} rank {rank} failed:\n{traceback.format_exc()}"
        print(err, file=sys.stderr, flush=True)
        with open(os.path.join(ROOT, f"{leg}.rank{rank}.err"), "w") as f:
            f.write(err)
        os._exit(1)
    # out without tearing the groups down: a rank that ends first takes the
    # store with it, and the others would wait on it in the teardown
    sys.stdout.flush()
    os._exit(0)


def _spawn(target, args, extra, timeout):
    """Run ``target(rank, world, port, args, *extra)`` in ``args.gpus``
    spawned processes; one that fails, or the timeout, ends the others.
    Returns the exit codes."""
    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, args.gpus, port, args, *extra))
             for r in range(args.gpus)]
    for proc in procs:
        proc.start()
    # the ranks end together; one that fails ends the others (a collective
    # would wait on it until NCCL's timeout)
    deadline = time.monotonic() + timeout
    while any(proc.is_alive() for proc in procs):
        if (time.monotonic() > deadline
                or any(proc.exitcode not in (None, 0) for proc in procs)):
            break
        time.sleep(1.0)
    for proc in procs:
        if proc.is_alive():
            proc.kill()
        proc.join()
    return [proc.exitcode for proc in procs]


def run_legs(args) -> int:
    """Every leg of ``args.legs`` in one world, then the one-card first
    steps in this process; prints the JSON line."""
    import numpy as np
    import torch

    import chip_smoke

    paths = {
        "video": chip_smoke.seeded_tokenizer_checkpoint(
            torch, os.path.join(ROOT, "video_tok"),
            TINY_TOKENIZER if args.cpu else chip_smoke.TOKENIZER,
            dict(chip_smoke.TRAIN, **(TINY_VIDEO if args.cpu else {}))),
        "sparse": chip_smoke.sparse_tokenizer_checkpoint(
            torch, os.path.join(ROOT, "sparse_tok"),
            dict(TINY_TOKENIZER, in_channels=3) if args.cpu else chip_smoke.SPARSE_TOKENIZER,
            dict(chip_smoke.SPARSE_TRAIN, **(TINY_SPARSE if args.cpu else {}))),
    }
    for leg in args.legs:
        for name in [f"{leg}.json"] + [f"{leg}.rank{r}.err" for r in range(args.gpus)]:
            if os.path.exists(os.path.join(ROOT, name)):
                os.remove(os.path.join(ROOT, name))
    codes = _spawn(_legs_worker, args, (paths,), args.timeout)
    recs, ok = [], codes == [0] * args.gpus
    for leg in args.legs:
        out_path = os.path.join(ROOT, f"{leg}.json")
        if os.path.exists(out_path):
            with open(out_path) as f:
                recs.append(json.load(f))
            continue
        errs = [os.path.join(ROOT, f"{leg}.rank{r}.err") for r in range(args.gpus)]
        recs.append(dict(leg=leg, failed=True, exit_codes=codes,
                         errors=[open(p).read()[-3000:] for p in errs if os.path.exists(p)]))
        ok = False
    from world_modelz_tpu_torch.parallel.mesh import Mesh

    dev = torch.device("cpu" if args.cpu else "cuda")
    for rec in recs:
        if rec.get("failed"):
            continue
        leg = rec["leg"]
        loss, want = _first_step(args, leg, Mesh(), paths, dev)
        got = np.load(os.path.join(ROOT, f"{leg}_grad.npy"))
        want = want.numpy()
        err = float(np.abs(got - want).max())
        scale = max(1.0, float(np.abs(want).max()))
        first = rec.pop("first_loss")
        rec["first_step"] = dict(
            loss=first, one_card_loss=loss, loss_err=abs(first - loss), grad_max_abs_err=err,
            grad_max=float(np.abs(want).max()), grad_tol=1e-6 * scale,
            ok=bool(err <= 1e-6 * scale and abs(first - loss) <= 1e-6 * max(1.0, loss)))
        ok = ok and rec["first_step"]["ok"] and rec["ranks_equal"] and not rec["rejected"]
        if not args.cpu:
            torch.cuda.empty_cache()
    print(json.dumps({"legs": recs}))
    print(chip_smoke.nvidia_smi() if not args.cpu else "cpu (gloo)")
    if not ok:
        print("chip_dp: a leg failed, a first step disagreed with one card, or the ranks "
              "disagree", file=sys.stderr)
        return 1
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gpus", type=int, default=4)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--per_rank_batch", type=int, default=64)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--legs", default="",
                   help=f"comma-separated model-axis legs of {sorted(LEGS)}")
    p.add_argument("--timeout", type=float, default=420.0,
                   help="seconds before the ranks still running are ended")
    args = p.parse_args()
    args.legs = [leg for leg in args.legs.split(",") if leg]
    if any(leg not in LEGS for leg in args.legs):
        p.error(f"--legs takes {sorted(LEGS)}")
    if args.cpu:
        args.per_rank_batch = min(args.per_rank_batch, 2)
        args.steps = min(args.steps, 12)
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke

    if not args.cpu:
        if not torch.cuda.is_available() or torch.cuda.device_count() < args.gpus:
            print(f"chip_dp: needs {args.gpus} CUDA devices", file=sys.stderr)
            return 1
        from world_modelz_tpu_torch.kernels import _build
        _build.load_library()  # built once here; the ranks load it
    os.makedirs(ROOT, exist_ok=True)
    if args.legs:
        return run_legs(args)
    tok_path = chip_smoke.seeded_tokenizer_checkpoint(
        torch, ROOT, TINY_TOKENIZER if args.cpu else chip_smoke.TOKENIZER,
        dict(chip_smoke.TRAIN, **(TINY if args.cpu else {})))
    out_path = os.path.join(ROOT, "world.json")
    t0 = time.perf_counter()
    codes = _spawn(_worker, args, (tok_path, out_path), args.timeout)
    if codes != [0] * args.gpus:
        print(f"chip_dp: rank exit codes {codes}", file=sys.stderr)
        return 1
    with open(out_path) as f:
        recs = json.load(f)
    world_s = time.perf_counter() - t0
    alone, _ = _run(args, tok_path, args.per_rank_batch, "alone", False)
    alone.update(world=1)
    for rec in recs:
        rec.update(world=args.gpus,
                   scaling=rec["steps_per_s"] * rec["global_batch"]
                   / (alone["steps_per_s"] * alone["global_batch"] * args.gpus))
    print(json.dumps({"runs": recs + [alone], "world_s": world_s}))
    if not all(r["ranks_equal"] and not r["rejected"] for r in recs):
        print("chip_dp: the ranks disagree or a step was rejected", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi() if not args.cpu else "cpu (gloo)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
