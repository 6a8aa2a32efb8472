"""The work the SDAR block-diffusion cell's metrics divide by: the allowed
pairs of the block-diffusion mask, the held experts' assignments, the
step's model FLOPs and each new kernel's needed bytes and products. Kept
with the benchmark, apart from ``counts.py`` (frozen for the cells it
serves); the peaks and ``bound_seconds`` are ``counts.py``'s.

The model sees [x_t ; x_0], N = 2 L positions cut into blocks of ``block``.
A noisy query sees its own block and the clean blocks before it, a clean
query the clean blocks up to its own: L block + L^2 allowed pairs a
sequence and head, (L + block) / 2 keys a query on average. The held
experts' work is counted from the assignments they received, as the
program counts them (``traced_held_assignments``: the traced steps' counter
``moe.assignments_held``); with routing spread evenly they would receive
T k held / E of the T k assignments of T positions, but the cell's routing
is not even. A matmul of M outputs over K-long dot products
counts 2 M K FLOPs; elementwise work, the softmax and the router's top-k are
not counted; the backward counts twice the forward's products (three
forwards a step), none recomputed.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from portbench.metrics import counts


def allowed_pairs(seq_len: int, block: int) -> int:
    """Query-key pairs the mask allows in one sequence and head."""
    return seq_len * block + seq_len * seq_len


def traced_held_assignments() -> Optional[float]:
    """The held experts' assignments of one step, summed over the layers,
    averaged over the steps whose statistics the traced slice read (the
    program's counters ``moe.assignments_held`` and ``moe.steps``); None
    where the program counts none."""
    try:
        from world_modelz_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    found = tracing.collect().counters
    if not found.get("moe.steps") or "moe.assignments_held" not in found:
        return None
    return found["moe.assignments_held"] / found["moe.steps"]


def forward_flops(cfg: Dict, batch: int, seq_len: int, held: float) -> float:
    """Model FLOPs of one forward over [x_t ; x_0] (the head on the noisy
    half) whose held experts received ``held`` assignments over the
    layers."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    hq, hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    t = batch * 2 * seq_len
    proj = 2 * t * d * (hq * dh + 2 * hkv * dh) + 2 * t * hq * dh * d
    attn = 4 * batch * hq * dh * allowed_pairs(seq_len, cfg["block"])
    router = 2 * t * d * cfg["router_experts"]
    experts = held * 6 * d * cfg["moe_intermediate_size"]
    head = 2 * batch * seq_len * d * v
    return cfg["num_hidden_layers"] * (proj + attn + router) + experts + head


def step_flops(cfg: Dict, batch: int, seq_len: int, held: float) -> float:
    return 3 * forward_flops(cfg, batch, seq_len, held)


def attention_work(cfg: Dict, batch: int, seq_len: int) -> Dict[str, Tuple[float, float]]:
    """(bytes, FLOPs) the masked GQA attention of one layer needs, bf16.
    Forward: q, k, v read, out and lse written; QK^T and PV over the
    allowed pairs. Backward: q, k, v, out, its gradient, lse read, dq, dk,
    dv written; dV, dP, dQ, dK over the pairs."""
    n = 2 * seq_len
    hq, hkv, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    q = batch * n * hq * dh * 2
    kv = batch * n * hkv * dh * 2
    stats = batch * hq * n * 4
    pairs = batch * hq * allowed_pairs(seq_len, cfg["block"])
    return {"fwd": (2 * q + 2 * kv + stats, 4.0 * pairs * dh),
            "bwd": (4 * q + 4 * kv + 2 * stats, 8.0 * pairs * dh)}


def expert_work(cfg: Dict, a: float) -> Dict[str, Tuple[float, float]]:
    """(bytes, FLOPs) the held experts' grouped GEMMs of a layer whose held
    experts received ``a`` assignments need, bf16. Forward: the rows read, G | U and act written, act read, the
    outputs written, the weights read; 6 A D I. Backward: the outputs'
    gradient, act, G | U and the rows read, dG | dU and the rows' gradient
    written, the weights read and their gradients written; 12 A D I."""
    d, i = cfg["hidden_size"], cfg["moe_intermediate_size"]
    w = cfg["num_experts"] * 3 * d * i * 2
    fwd_bytes = a * (d + 3 * i + i + d) * 2 + w
    bwd_bytes = a * (d + i + 2 * i + d + 2 * i + d) * 2 + 2 * w
    return {"fwd": (fwd_bytes, 6.0 * a * d * i), "bwd": (bwd_bytes, 12.0 * a * d * i)}


def bound_seconds(work: Dict[str, Tuple[float, float]], kind: str) -> float:
    """The least time of a layer's forward and backward, bf16."""
    return sum(counts.bound_seconds(b, f, kind, "bf16") for b, f in work.values())
