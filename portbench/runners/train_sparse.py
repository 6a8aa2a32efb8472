"""The sparse space-time trainer (``world_modelz_tpu_torch.cli.
sparse_diffusion``) on one card: its own functions in the order ``train``
calls them (``make_model``, ``init_state``, ``build_sampler`` and the
prefetch, ``encode_batch`` of a fresh volume batch every
``change_batch_interval`` steps, the ``step_body`` inside ``StepProgram``,
``run_dispatch``), with the loop between them copied without its logging,
checkpoints and evaluations.

Set-up: weights made on the card from the seed; the trajectory buffer
filled at its published size; the step program captured at its first
dispatch, which runs the first of the three checked steps on the first
volume batch; the next dispatch runs the other two; a few dispatches warm
the loop. After the window the reference (``portbench.reference.sparse``)
encodes the same frames and runs the three steps from the same weights
and draws.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from portbench.reference import sparse as ref_sparse
from portbench.reference import tokenizer as ref_tok
from portbench.reference.precision import Precision
from portbench.reference.train import AdamW, LossAwareSampler, run_steps
from portbench import trace as tracing
from portbench.runners import training
from portbench.runners.train_m3 import load_tokenizer
from portbench.weights import make_weights
from world_modelz_tpu_torch.cli import sparse_diffusion as sd
from world_modelz_tpu_torch.cli import video_diffusion as vd
from world_modelz_tpu_torch.data import PrefetchIterator
from world_modelz_tpu_torch.train.dispatch import dispatch_len, run_dispatch, step_inputs
from world_modelz_tpu_torch.train.timing import TrainTiming

CHECKED_STEPS = 3
DRAWS = ("gumbel", "jitter", "offset_uniform", "position_uniform", "mask_uniform",
         "resample_uniform", "uniform_classes")


def trainer_config(cfg: Dict, traffic: Dict, seed: int, device) -> sd.SparseDiffusionConfig:
    fields = {f.name for f in dataclasses.fields(sd.SparseDiffusionConfig)}
    values = {k: v for k, v in {**cfg, **traffic}.items() if k in fields}
    return sd.SparseDiffusionConfig(**values, manual_seed=seed,
                                    platform="" if device.type == "cuda" else "cpu",
                                    eval_interval=0, checkpoint_interval=0,
                                    histogram_interval=0)


def weights(cfg: Dict, seed: int, device):
    return (make_weights(ref_tok.param_spec(cfg["tokenizer"]), seed, device),
            make_weights(ref_sparse.param_spec(cfg), seed + 1, device))


def run(cell: Dict, cfg: Dict, *, seed: int, seconds: float, trace: bool, t0: float,
        device=None, variants: Dict = None) -> Dict:
    device = torch.device(device or "cuda")
    traffic = cell["traffic"]
    scfg = trainer_config(cfg, traffic, seed, device)
    torch.manual_seed(seed)
    tok_w, den_w = weights(cfg, seed, device)
    tok = load_tokenizer(cfg, tok_w, device)
    k = tok.num_embeddings
    shape = (scfg.S, scfg.H, scfg.W)
    volume = scfg.S * scfg.H * scfg.W
    model = sd.make_model(scfg, k, device)
    model.load_state_dict(den_w, strict=True)
    del tok_w, den_w  # remade from the seed for the reference
    layout = [(n, p.numel()) for n, p in model.named_parameters()]
    state = vd.init_state(scfg, model)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_buckets = state.sampler.weights.shape[0]
    kdisp = max(1, scfg.steps_per_dispatch)
    b = scfg.batch_size
    sampler = sd.build_sampler(scfg, seed)
    batches = PrefetchIterator(lambda: sampler.sample_batch(b), depth=2, device=device)
    tm = TrainTiming(probe_interval=0)
    io = step_inputs({"batch_z": torch.zeros((b, *shape), dtype=torch.long, device=device)},
                     sd.StepDraws.empty(b, scfg.num_context, volume, n_buckets, device), kdisp)
    program = vd.step_program(state, io, lambda: sd.step_body(
        state, io.tensors["batch_z"], scfg, io.draws))
    seen = set()
    counters = {"step": 0, "failed": 0}
    kept: List[Dict] = []
    frames0 = []

    def feed(keep=False):
        with torch.profiler.record_function("portbench.feed"):
            sd.draw_step(gen, b, scfg.num_context, volume, n_buckets, k, out=io.draws)
        if keep:
            kept.append({d: getattr(io.draws, d).clone() for d in DRAWS})

    def dispatch(limit: int, keep: bool = False):
        step = counters["step"]
        if step % scfg.change_batch_interval == 0:  # a fresh volume batch
            with torch.profiler.record_function("portbench.encode"):
                frames = next(batches)
                if step == 0:
                    frames0.append(frames.clone())
                io.tensors["batch_z"].copy_(sd.encode_batch(tok, frames, shape))
        n = dispatch_len(step, limit, 1 << 62, 0, [scfg.change_batch_interval])
        rows = run_dispatch(program, io, tm, step, [lambda: feed(keep)] * n,
                            io.tensors["batch_z"], seen)
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
        warm_until = time.perf_counter() + float(traffic.get("warmup_seconds", 2.0))
        while time.perf_counter() < warm_until:
            dispatch(kdisp)
        setup_s = time.perf_counter() - t0
        failed0 = counters["failed"]
        steps, wall, sl = training.measure(lambda: len(dispatch(kdisp)), seconds, trace,
                                           float(traffic.get("trace_seconds", 2.0)))
        failed = counters["failed"] - failed0
    finally:
        batches.close()
        sampler.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del program, io, state, model, tok, batches, sampler
    training.free_cuda()

    numbers = reference_numbers(cfg, scfg, seed, device, frames0[0], kept)
    res = training.result(cell, cfg, device, prog, numbers, steps, failed, wall, setup_s,
                           peak, sl, b)
    res["variants"] = {  # the reference in the program's place: control, faults
        name: training.compare(reference_numbers(
            cfg, scfg, seed, device, frames0[0], training.variant_steps(kept, v),
            v.get("precision")), numbers)
        for name, v in (variants or {}).items()}
    training.free_cuda()
    return res


def reference_numbers(cfg: Dict, scfg, seed: int, device, frames, kept: List[Dict],
                      precision: str = None) -> Dict:
    """The reference's three steps on the first volume batch, from the
    seed's weights and the kept draws, in ``precision`` (default: the
    configuration's)."""
    training.reference_precision()
    tok_w, den_w = weights(cfg, seed, device)
    tokens = ref_sparse.encode_volume(tok_w, frames, cfg["tokenizer"]["downscale_steps"])
    prec = Precision(precision or ("bf16" if scfg.bf16 else "f32"))
    step = ref_sparse.TrainStep({**cfg, "p_max_uniform": scfg.p_max_uniform}, prec)
    opt = AdamW(den_w, scfg.lr, scfg.warmup, scfg.max_steps, scfg.weight_decay)
    return run_steps(den_w, [{**d, "tokens": tokens[: d["gumbel"].shape[0]]} for d in kept],
                     step, opt, LossAwareSampler(device))
