"""SDAR's block-diffusion trainer (``world_modelz_tpu_torch.cli.
block_diffusion``) on one card's share of an 8-way expert-parallel layer:
its own functions in the order ``train`` calls them (``make_model``,
``init_state``, the document stream and the prefetch, ``step_inputs``, the
``step_body`` inside ``StepProgram``, ``run_dispatch``), with the loop
between them copied without its logging.

Set-up: weights made on the card from the seed; the step program captured
at its first dispatch, which runs the first of the three checked steps;
the next dispatch runs the other two; a few dispatches warm the loop.
After the window the reference (``portbench.reference.sdar``) runs the
three steps from the same weights, documents and draws.

With ``variants`` (the readings a cell's limits are set from,
``portbench/controls.py``) the reference also runs in the program's place
once for each of them and for each of ``FAULTS``: the faults of an expert
layer and of the mask that the limits must catch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from portbench import trace as tracing
from portbench.reference import sdar as ref_sdar
from portbench.reference.precision import Precision
from portbench.reference.train import AdamW, run_steps
from portbench.runners import training
from portbench.weights import make_weights
from world_modelz_tpu_torch.cli import block_diffusion as bdc
from world_modelz_tpu_torch.cli.video_diffusion import init_state
from world_modelz_tpu_torch.data import PrefetchIterator
from world_modelz_tpu_torch.train.dispatch import run_dispatch
from world_modelz_tpu_torch.train.timing import TrainTiming

CHECKED_STEPS = 3
FAULTS = {"top7": {"drop_last": True}, "capacity_1": {"capacity": 1.0},
          "noisy_bidirectional": {"noisy_bidirectional": True}}

# the configuration's keys -> the trainer's
KEYS = {"vocab_size": "vocab", "hidden_size": "dim", "num_hidden_layers": "depth",
        "num_attention_heads": "heads", "num_key_value_heads": "kv_heads",
        "head_dim": "head_dim", "moe_intermediate_size": "expert_dim",
        "router_experts": "num_experts", "num_experts_per_tok": "top_k",
        "norm_topk_prob": "norm_topk_prob", "num_experts": "held_experts",
        "expert_rank": "expert_rank", "rope_theta": "rope_theta", "rms_norm_eps": "rms_eps",
        "block": "block", "lr": "lr", "weight_decay": "weight_decay", "warmup": "warmup",
        "max_steps": "max_steps", "ema_decay": "ema_decay", "bf16": "bf16",
        "doc_median": "doc_median", "doc_sigma": "doc_sigma", "doc_max": "doc_max",
        "zipf": "zipf"}


def trainer_config(cfg: Dict, traffic: Dict, seed: int, device) -> bdc.BlockDiffusionConfig:
    fields = {f.name for f in dataclasses.fields(bdc.BlockDiffusionConfig)}
    values = {KEYS[k]: v for k, v in cfg.items() if k in KEYS}
    values.update({k: v for k, v in traffic.items() if k in fields})
    return bdc.BlockDiffusionConfig(**values, manual_seed=seed,
                                    platform="" if device.type == "cuda" else "cpu")


def weights(cfg: Dict, seed: int, device):
    """``portbench/weights.py``'s draw, but for two rules of the
    configuration's ``assumed``: the embedding table N(0, 1) (``nn.
    Embedding``'s own), and the residual branches' output projections
    (``o_proj``, the experts' ``down``) scaled by 1 / sqrt(2 x the published
    depth) (Megatron's scaled initialisation). With the fan-in rule alone a
    direction shared by every token outgrows the 0.02-wide embeddings after
    the first layer and the router sends nearly every token to one expert,
    as no trained router does (PERF.md, PR 23)."""
    w = make_weights(ref_sdar.param_spec(cfg), seed, device)
    residual = (2 * cfg["published"]["num_hidden_layers"]) ** -0.5
    w["model.embed_tokens.weight"] *= cfg["hidden_size"] ** 0.5
    for name, t in w.items():
        if name.endswith("o_proj.weight") or name.endswith("experts.down"):
            t *= residual
    return w


def run(cell: Dict, cfg: Dict, *, seed: int, seconds: float, trace: bool, t0: float,
        device=None, variants: Dict = None) -> Dict:
    device = torch.device(device or "cuda")
    traffic = cell["traffic"]
    bcfg = trainer_config(cfg, traffic, seed, device)
    torch.manual_seed(seed)
    model = bdc.make_model(bcfg, device)
    model.load_state_dict(weights(cfg, seed, device), strict=True)
    layout = [(n, p.numel()) for n, p in model.named_parameters()]
    state = init_state(bcfg, model)
    gen = torch.Generator(device=device).manual_seed(seed)
    kdisp = max(1, bcfg.steps_per_dispatch)
    b = bcfg.batch_size
    docs = bdc.documents(bcfg, seed)
    batches = PrefetchIterator(lambda: docs.sample_batch(b), depth=kdisp + 1, device=device)
    tm = TrainTiming(probe_interval=0)
    io = bdc.step_inputs(bcfg, kdisp, device)
    program = bdc.step_program(state, io, bcfg)
    seen = set()
    counters = {"step": 0, "failed": 0}
    kept: List[Dict] = []

    def feed(batch, keep=False):
        with torch.profiler.record_function("portbench.feed"):
            io.tensors["x0"].copy_(batch)
            bdc.draw_step(gen, io.draws)
        if keep:
            kept.append({"x0": io.tensors["x0"].clone(),
                         "block_uniform": io.draws.block_uniform.clone(),
                         "token_uniform": io.draws.token_uniform.clone()})

    def dispatch(n: int, keep: bool = False):
        docs_in = [next(batches) for _ in range(n)]
        rows = run_dispatch(program, io, tm, counters["step"],
                            [lambda d=d: feed(d, keep) for d in docs_in], docs_in[-1], seen)
        counters["step"] += n
        counters["failed"] += sum(not ok for _, _, ok in rows)
        return rows

    if trace and device.type == "cuda":
        tracing.prime()
    try:
        opt = state.optimizer
        # the checked states wait in host memory: the card's is the step's
        flat0 = opt.flat.detach().to("cpu", copy=True)
        rows = dispatch(1, keep=True)
        mu1 = opt.mu.detach().to("cpu", copy=True)
        rows += dispatch(CHECKED_STEPS - 1, keep=True)
        flat3 = opt.flat.detach().to("cpu", copy=True)
        prog = {"loss": [r[0] for r in rows], "ok": [r[2] for r in rows],
                "grad1": training.leaf_norms(mu1, layout, 1.0 / (1.0 - training.ADAM_B1)),
                "change": training.leaf_norms(flat3 - flat0, layout)}
        del flat0, mu1, flat3
        training.measure(lambda: len(dispatch(kdisp)), float(traffic.get("warmup_seconds", 2.0)),
                         False, 0.0)
        setup_s = time.perf_counter() - t0
        failed0 = counters["failed"]
        steps, wall, sl = training.measure(lambda: len(dispatch(kdisp)), seconds, trace,
                                           float(traffic.get("trace_seconds", 2.0)))
        failed = counters["failed"] - failed0
    finally:
        batches.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del program, io, state, model, batches, opt
    training.free_cuda()

    numbers = reference_numbers(cfg, bcfg, seed, device, kept)
    res = training.result(cell, cfg, device, prog, numbers, steps, failed, wall, setup_s,
                          peak, sl, b)
    res["variants"] = {  # the reference in the program's place: control, faults
        name: training.compare(reference_numbers(
            cfg, bcfg, seed, device, training.variant_steps(kept, v), v.get("precision"), v),
            numbers)
        for name, v in ({**variants, **FAULTS} if variants is not None else {}).items()}
    training.free_cuda()
    return res


def reference_numbers(cfg: Dict, bcfg, seed: int, device, kept: List[Dict],
                      precision: str = None, variant: Dict = None) -> Dict:
    """The reference's three steps from the seed's weights on the kept
    documents and draws, in ``precision`` (default: the configuration's),
    with ``variant``'s fault planted (``reference.sdar``)."""
    training.reference_precision()
    params = weights(cfg, seed, device)
    prec = Precision(precision or ("bf16" if bcfg.bf16 else "f32"))
    step = ref_sdar.TrainStep(cfg, prec, variant)
    opt = AdamW(params, bcfg.lr, bcfg.warmup, bcfg.max_steps, bcfg.weight_decay)
    out = run_steps(params, kept, step, opt, ref_sdar.NoSampler())
    del params, opt
    training.free_cuda()
    return out
