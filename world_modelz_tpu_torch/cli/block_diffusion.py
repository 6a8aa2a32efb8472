"""Block-diffusion training of SDAR's MoE decoder (``models/sdar.py``) on
one card's share of an expert-parallel layer.

    python -m world_modelz_tpu_torch.cli.block_diffusion [--batch_size 8]
        [--seq_len 4096] [--block 4] [--depth 8] [--held_experts 16] ...

The step (``step_body``): a batch of packed documents x_0 (B, L) from the
prefetch thread (``data/documents.py``, span ``data.pack``), the BD3-LM
corruption into x_t from the step's draws (``diffusion/block.py``), the
model on [x_t ; x_0] in bf16 on the f32 masters, the 1 / t weighted loss,
the backward and the update (``cli.video_diffusion.update_state``: AdamW,
the guard), with no host read: ``StepProgram`` captures it as a CUDA graph
on the card, and ``run_dispatch`` runs ``--steps_per_dispatch`` steps
between reads of their stats. A step's stats row also carries the expert
layers' held assignments, the most loaded held expert's count over their
mean and the assignments left unplaced (0: the layer drops nothing); the
dispatch's read adds them to the counters ``moe.assignments_held``,
``moe.load_max_milli`` (a thousandth a step), ``moe.dropped`` and
``moe.steps`` (``utils/tracing.py``).

The vocabulary is the card's slice: ids 0 .. vocab - 3 are tokens, vocab -
2 ends a document, vocab - 1 is the mask. The experts held are rank
``expert_rank``'s ``held_experts`` of ``num_experts`` (``parallel.moe.
held_experts``); the router routes over all of them.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Tuple

import torch

from world_modelz_tpu_torch._device import platform_device
from world_modelz_tpu_torch.cli.video_diffusion import init_state, update_state
from world_modelz_tpu_torch.data import PrefetchIterator
from world_modelz_tpu_torch.data.documents import PackedDocuments
from world_modelz_tpu_torch.diffusion import block as bd
from world_modelz_tpu_torch.models.sdar import SdarModel
from world_modelz_tpu_torch.parallel.moe import held_experts
from world_modelz_tpu_torch.train.dispatch import (
    Row,
    StepInputs,
    StepProgram,
    as_row,
    dispatch_len,
    run_dispatch,
)
from world_modelz_tpu_torch.train.timing import TrainTiming
from world_modelz_tpu_torch.utils import tracing
from world_modelz_tpu_torch.utils.config import config_to_dict, dataclass_cli
from world_modelz_tpu_torch.utils.logging import MetricLogger


@dataclasses.dataclass
class BlockDiffusionConfig:
    manual_seed: int = 42
    platform: str = ""  # "" = the GPU (raises without one), "cpu"
    lr: float = 1e-5
    warmup: int = 0
    max_steps: int = 100_000
    weight_decay: float = 0.01
    optimizer: str = "AdamW"
    ema_decay: float = 0.0
    nan_guard: bool = True
    bf16: bool = True
    batch_size: int = 8
    seq_len: int = 4096  # L: the model sees 2 L positions
    block: int = 4
    # the model (SDAR-30B-A3B's widths; depth and experts held: one card's
    # share, vocab: an eighth of 151,936)
    vocab: int = 18992
    dim: int = 2048
    depth: int = 8
    heads: int = 32
    kv_heads: int = 4
    head_dim: int = 128
    expert_dim: int = 768
    num_experts: int = 128
    top_k: int = 8
    norm_topk_prob: bool = True
    held_experts: int = 16
    expert_rank: int = 0
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    # the synthetic documents
    doc_median: float = 1024.0
    doc_sigma: float = 1.0
    doc_max: int = 4096
    zipf: float = 1.1
    steps_per_dispatch: int = 1
    log_interval: int = 10
    output_dir: str = "outputs/block_diffusion"
    name: str = "block_diffusion"


STATS = ("loss", "grad_norm", "ok", "assignments_held", "load_max", "dropped")


def make_model(cfg: BlockDiffusionConfig, device=None) -> SdarModel:
    held = held_experts(cfg.num_experts, cfg.expert_rank, cfg.num_experts // cfg.held_experts)
    return SdarModel(cfg, held, device=device)


def documents(cfg: BlockDiffusionConfig, seed: int) -> PackedDocuments:
    return PackedDocuments(cfg.seq_len, cfg.vocab - 2, seed, cfg.doc_median, cfg.doc_sigma,
                           cfg.doc_max, cfg.zipf)


@dataclasses.dataclass
class StepDraws:
    block_uniform: torch.Tensor  # (B, L / block) each block's mask rate draw
    token_uniform: torch.Tensor  # (B, L) each token's mask draw

    @classmethod
    def empty(cls, b: int, seq_len: int, block: int, device) -> "StepDraws":
        return cls(torch.zeros((b, seq_len // block), device=device),
                   torch.zeros((b, seq_len), device=device))


def draw_step(generator: torch.Generator, draws: StepDraws) -> StepDraws:
    torch.rand(draws.block_uniform.shape, generator=generator, out=draws.block_uniform)
    torch.rand(draws.token_uniform.shape, generator=generator, out=draws.token_uniform)
    return draws


class BlockStepInputs(StepInputs):
    """``StepInputs`` whose stats rows hold ``STATS``: the read gives the
    (loss, grad norm, ok) rows and adds the expert counters."""

    def read(self, n: int) -> List[Row]:
        rows = self.stats[:n].tolist()
        tracing.count("moe.steps", n)
        tracing.count("moe.assignments_held", int(sum(r[3] for r in rows)))
        tracing.count("moe.load_max_milli", int(round(1000 * sum(r[4] for r in rows))))
        tracing.count("moe.dropped", int(sum(r[5] for r in rows)))
        return [as_row(r[:3]) for r in rows]


def step_inputs(cfg: BlockDiffusionConfig, k: int, device) -> BlockStepInputs:
    b = cfg.batch_size
    return BlockStepInputs(
        {"x0": torch.zeros((b, cfg.seq_len), dtype=torch.long, device=device)},
        StepDraws.empty(b, cfg.seq_len, cfg.block, device),
        torch.zeros((max(1, k), len(STATS)), device=device),
        torch.zeros((1,), dtype=torch.long, device=device))


def step_body(state, x0: torch.Tensor, cfg: BlockDiffusionConfig, draws: StepDraws
              ) -> torch.Tensor:
    """One optimizer step on the (B, L) documents ``x0``, on the device with
    no host read: updates ``state`` in place and returns the packed
    ``STATS`` float32 (6,) tensor."""
    model = state.model
    state.optimizer.zero_grad()
    xt, masked, t = bd.corrupt(x0, draws.block_uniform, draws.token_uniform, cfg.block,
                               cfg.vocab - 1)
    inputs = (bd.layout(xt, x0), cfg.block)
    if cfg.bf16:
        low = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
               for n, p in model.named_parameters()}
        logits, stats = torch.func.functional_call(model, low, inputs)
    else:
        logits, stats = model(*inputs)
    loss = bd.loss(logits, x0, masked, t)
    loss.backward()
    del logits
    packed = update_state(state, loss, cfg)
    state.optimizer.zero_grad()  # no gradient outlives the step
    return torch.cat([packed, stats.detach().float()])


def step_program(state, io: BlockStepInputs, cfg: BlockDiffusionConfig) -> StepProgram:
    return StepProgram(lambda: io.record(step_body(state, io.tensors["x0"], cfg, io.draws)),
                       state.model.device,
                       keep=lambda: state.tensors() + [io.stats, io.row], inputs=io)


def train(cfg: BlockDiffusionConfig
          ) -> Tuple[object, List[Tuple[int, float, float, bool]], StepProgram]:
    """Train for ``max_steps``; returns the state, each step's (step, loss,
    grad norm, ok) and the step program (its graph's launches on the
    GPU)."""
    device = platform_device(cfg.platform)
    if cfg.seq_len % cfg.block:
        raise ValueError(f"seq_len {cfg.seq_len} is not a whole number of blocks of {cfg.block}")
    torch.manual_seed(cfg.manual_seed)
    os.makedirs(cfg.output_dir, exist_ok=True)
    model = make_model(cfg, device)
    print(f"parameters: {sum(p.numel() for p in model.parameters()):,}")
    state = init_state(cfg, model)
    gen = torch.Generator(device=device).manual_seed(cfg.manual_seed)
    kdisp = max(1, cfg.steps_per_dispatch)
    docs = documents(cfg, cfg.manual_seed)
    batches = PrefetchIterator(lambda: docs.sample_batch(cfg.batch_size), depth=kdisp + 1,
                               device=device)
    logger = MetricLogger(cfg.output_dir, cfg.name, config=config_to_dict(cfg))
    tm = TrainTiming(probe_interval=0)
    io = step_inputs(cfg, kdisp, device)
    program = step_program(state, io, cfg)
    seen: set = set()
    history: List[Tuple[int, float, float, bool]] = []

    def feed(batch):
        io.tensors["x0"].copy_(batch)
        draw_step(gen, io.draws)

    t0, logged = time.time(), 0
    try:
        while state.step < cfg.max_steps:
            step = state.step
            n = dispatch_len(step, kdisp, cfg.max_steps, 1, [cfg.log_interval])
            frames = [next(batches) for _ in range(n)]
            rows = run_dispatch(program, io, tm, step, [lambda f=f: feed(f) for f in frames],
                                frames[-1], seen)
            history += [(step + i + 1, *row) for i, row in enumerate(rows)]
            state.step = step + n
            if state.step % cfg.log_interval == 0 or step == 0:
                loss, gn, _ = rows[-1]
                dt, t0 = time.time() - t0, time.time()
                logger.log(state.step, loss=loss, grad_norm=gn,
                           steps_per_sec=(state.step - logged) / max(dt, 1e-9))
                logged = state.step
                print(f"{state.step}: loss {loss:.4e} grad_norm {gn:.3e}")
    finally:
        batches.close()
        logger.close()
    return state, history, program


def main(argv=None):
    cfg = dataclass_cli(BlockDiffusionConfig, argv)
    print("Config:", cfg)
    train(cfg)


if __name__ == "__main__":
    main()
