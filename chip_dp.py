#!/usr/bin/env python3
"""Time the video trainer's data axis on N GPUs: replicated data
parallelism against ``--fsdp``, in turns.

    python3 chip_dp.py [--gpus 4] [--steps 40] [--per_rank_batch 64]
    python3 chip_dp.py --cpu        # the same runs, tiny, on gloo

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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gpus", type=int, default=4)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--per_rank_batch", type=int, default=64)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--timeout", type=float, default=420.0,
                   help="seconds before the ranks still running are ended")
    args = p.parse_args()
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
    tok_path = chip_smoke.seeded_tokenizer_checkpoint(
        torch, ROOT, TINY_TOKENIZER if args.cpu else chip_smoke.TOKENIZER,
        dict(chip_smoke.TRAIN, **(TINY if args.cpu else {})))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_path = os.path.join(ROOT, "world.json")
    ctx = torch.multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_worker, args=(r, args.gpus, port, args, tok_path, out_path))
             for r in range(args.gpus)]
    for proc in procs:
        proc.start()
    # the ranks end together; one that fails ends the others (a collective
    # would wait on it until NCCL's timeout)
    deadline = time.monotonic() + args.timeout
    while any(proc.is_alive() for proc in procs):
        if (time.monotonic() > deadline
                or any(proc.exitcode not in (None, 0) for proc in procs)):
            break
        time.sleep(1.0)
    for proc in procs:
        if proc.is_alive():
            proc.kill()
        proc.join()
    if [proc.exitcode for proc in procs] != [0] * args.gpus:
        print(f"chip_dp: rank exit codes {[proc.exitcode for proc in procs]}", file=sys.stderr)
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
