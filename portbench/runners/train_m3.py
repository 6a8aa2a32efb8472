"""The m3 video-diffusion trainer (``world_modelz_tpu_torch.cli.
video_diffusion``) on one card: its own functions in the order ``_train``
calls them (``make_model``, ``init_state``, the ``step_body`` inside
``StepProgram``, ``run_dispatch`` over the prefetched MovingMNIST
trajectories composited on the device), with the loop between them copied
without its logging, checkpoints and evaluations.

Set-up: the tokenizer and the denoiser get weights made on the card from
the seed; the step program is captured at its first dispatch, which runs
the first of the three checked steps; the next dispatch runs the other two;
then a few full dispatches warm the loop. The window runs dispatches of
``steps_per_dispatch`` steps. After it, the reference (``portbench.
reference.m3``) runs the three checked steps from the same weights and
inputs.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List

import torch

from portbench.reference import m3 as ref_m3
from portbench.reference import tokenizer as ref_tok
from portbench.reference.precision import Precision
from portbench.reference.train import AdamW, LossAwareSampler, run_steps
from portbench import trace as tracing
from portbench.runners import training
from portbench.weights import make_weights
from world_modelz_tpu_torch.cli import video_diffusion as vd
from world_modelz_tpu_torch.data import PrefetchIterator
from world_modelz_tpu_torch.models import VQAutoEncoder, tokenizer_inference_cast
from world_modelz_tpu_torch.train.dispatch import run_dispatch, step_inputs
from world_modelz_tpu_torch.train.timing import TrainTiming

CHECKED_STEPS = 3
DRAWS = ("gumbel", "jitter", "mask_uniform", "resample_uniform", "uniform_classes")


def trainer_config(cfg: Dict, traffic: Dict, seed: int, device) -> vd.VideoDiffusionConfig:
    fields = {f.name for f in dataclasses.fields(vd.VideoDiffusionConfig)}
    values = {k: v for k, v in {**cfg, **traffic}.items() if k in fields}
    values["extents"] = tuple(values["extents"])
    return vd.VideoDiffusionConfig(**values, manual_seed=seed,
                                   platform="" if device.type == "cuda" else "cpu",
                                   eval_interval=0, checkpoint_interval=0,
                                   histogram_interval=0)


def weights(cfg: Dict, seed: int, device):
    """(tokenizer, denoiser) weights from the seed."""
    return (make_weights(ref_tok.param_spec(cfg["tokenizer"]), seed, device),
            make_weights(ref_m3.param_spec(cfg), seed + 1, device))


def load_tokenizer(cfg: Dict, tok_w, device) -> VQAutoEncoder:
    tok = VQAutoEncoder(**cfg["tokenizer"], device=device)
    missing, unexpected = tok.load_state_dict(tok_w, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise RuntimeError(f"tokenizer weights: missing {missing}, unexpected {unexpected}")
    return tok


def train(cell: Dict, cfg: Dict, seed: int, seconds: float, trace: bool, t0: float,
          device) -> Dict:
    """Set up, check three steps and run the window on the card. Returns the
    program's checked numbers, the checked steps' inputs, the window's steps
    and wall, set-up seconds, the slice, failed steps and the trainer's
    config."""
    traffic = cell["traffic"]
    tcfg = trainer_config(cfg, traffic, seed, device)
    torch.manual_seed(seed)
    tok_w, den_w = weights(cfg, seed, device)
    tok = load_tokenizer(cfg, tok_w, device)
    if tcfg.tok_bf16:
        tokenizer_inference_cast(tok)
    clip_fn, _ = vd.build_clip_fn(tcfg, seed)
    grid = tcfg.image_size // 2 ** cfg["tokenizer"]["downscale_steps"]
    token_shape = (tcfg.n_past + 1, grid, grid)
    k = tok.num_embeddings
    model = vd.make_model(tcfg, token_shape, k, device)
    model.load_state_dict(den_w, strict=True)
    del tok_w, den_w  # remade from the seed for the reference
    layout = [(n, p.numel()) for n, p in model.named_parameters()]
    state = vd.init_state(tcfg, model, None)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_tokens = grid * grid
    n_buckets = state.sampler.weights.shape[0]
    kdisp = max(1, tcfg.steps_per_dispatch)
    batches = PrefetchIterator(lambda: clip_fn(tcfg.batch_size), depth=max(2, kdisp + 1),
                               device=device)
    tm = TrainTiming(probe_interval=0)
    io, program = None, None
    seen = set()
    counters = {"step": 0, "failed": 0}
    kept: List[Dict] = []

    def feed(batch, keep=False):
        with torch.profiler.record_function("portbench.feed"):
            for key, v in vd.step_batch(batch).items():
                io.tensors[key].copy_(v)
            vd.draw_step(gen, tcfg.batch_size, n_tokens, n_buckets, k, out=io.draws)
        if keep:
            kept.append({**{key: v.clone() for key, v in io.tensors.items()},
                         **{d: getattr(io.draws, d).clone() for d in DRAWS}})

    def dispatch(n: int, keep: bool = False):
        nonlocal io, program
        with torch.profiler.record_function("portbench.data_wait"):
            frame_list = [next(batches) for _ in range(n)]
        if program is None:
            io = step_inputs({key: torch.empty_like(v)
                              for key, v in vd.step_batch(frame_list[0]).items()},
                             vd.StepDraws.empty(tcfg.batch_size, n_tokens, n_buckets, device),
                             kdisp)
            program = vd.step_program(state, io, lambda: vd.step_body(
                state, tok, io.tensors, tcfg, io.draws))
        rows = run_dispatch(program, io, tm, counters["step"], [
            functools.partial(feed, f, keep) for f in frame_list], frame_list[-1], seen)
        counters["step"] += n
        counters["failed"] += sum(not ok for _, _, ok in rows)
        return rows

    if trace and device.type == "cuda":
        tracing.prime()
    try:
        opt = state.optimizer
        flat0 = opt.flat.detach().clone()
        rows = dispatch(1, keep=True)
        mu1 = opt.mu.detach().clone()
        rows += dispatch(CHECKED_STEPS - 1, keep=True)
        flat3 = opt.flat.detach().clone()
        prog = {"loss": [r[0] for r in rows], "ok": [r[2] for r in rows],
                "grad1": training.leaf_norms(mu1, layout, 1.0 / (1.0 - training.ADAM_B1)),
                "change": training.leaf_norms(flat3 - flat0, layout)}
        del flat0, mu1, flat3
        warm = float(traffic.get("warmup_seconds", 2.0))
        training.measure(lambda: len(dispatch(kdisp)), warm, False, 0.0)
        setup_s = time.perf_counter() - t0
        failed0 = counters["failed"]
        steps, wall, sl = training.measure(lambda: len(dispatch(kdisp)), seconds, trace,
                                           float(traffic.get("trace_seconds", 2.0)))
        failed = counters["failed"] - failed0
    finally:
        batches.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del program, io, state, model, tok, batches
    training.free_cuda()
    return {"prog": prog, "kept": kept, "steps": steps, "wall": wall, "setup_s": setup_s,
            "sl": sl, "failed": failed, "peak": peak, "tcfg": tcfg}


def run(cell: Dict, cfg: Dict, *, seed: int, seconds: float, trace: bool, t0: float,
        device=None, variants: Dict = None) -> Dict:
    device = torch.device(device or "cuda")
    r = train(cell, cfg, seed, seconds, trace, t0, device)
    tcfg, kept = r["tcfg"], r["kept"]
    numbers = reference_numbers(cfg, tcfg, seed, device, kept)
    res = training.result(cell, cfg, device, r["prog"], numbers, r["steps"], r["failed"],
                          r["wall"], r["setup_s"], r["peak"], r["sl"], tcfg.batch_size)
    res["variants"] = {  # the reference in the program's place: control, faults
        name: training.compare(reference_numbers(
            cfg, tcfg, seed, device, training.variant_steps(kept, v), v.get("precision")),
            numbers)
        for name, v in (variants or {}).items()}
    training.free_cuda()
    return res


def reference_numbers(cfg: Dict, tcfg, seed: int, device, kept: List[Dict],
                      precision: str = None) -> Dict:
    """The reference's three steps from the seed's weights on the kept
    inputs, in ``precision`` (default: the configuration's)."""
    training.reference_precision()
    tok_w, den_w = weights(cfg, seed, device)
    prec = Precision(precision or ("bf16" if tcfg.bf16 else "f32"))
    step = ref_m3.TrainStep({**cfg, "tok_bf16": tcfg.tok_bf16,
                             "p_max_uniform": tcfg.p_max_uniform}, tok_w, prec, device)
    opt = AdamW(den_w, tcfg.lr, tcfg.warmup, tcfg.max_steps, tcfg.weight_decay)
    return run_steps(den_w, kept, step, opt, LossAwareSampler(device))
