"""Loss-aware diffusion-time importance sampling as explicit state, and the
uniform null sampler.

Port of ``world_modelz_tpu.train.importance`` (reference:
minecraft/importance_sampling.py:5-67): a 100-bucket histogram of
per-sample losses over diffusion time r in [0, 1); sampling draws buckets
in proportion to the EMA'd losses (mixed with a uniform floor) once every
bucket has seen more than ``warmup`` samples.

The state lives on the device and both ``loss_aware_sample`` and
``loss_aware_update`` are tensor code with no host sync. Randomness is
explicit: ``jax.random.categorical`` is argmax(log w + Gumbel), so
``loss_aware_sample`` takes a Gumbel tensor and jitter uniforms (drawn from
a ``torch.Generator`` when not given).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class LossAwareSamplerState:
    weights: torch.Tensor  # (num_buckets,) float32 EMA of per-bucket loss
    counts: torch.Tensor  # (num_buckets,) int32 samples seen per bucket
    uniform_p: torch.Tensor  # float32 scalar: uniform mixture floor
    alpha: torch.Tensor  # float32 scalar: EMA decay
    warmup: torch.Tensor  # int32 scalar: per-bucket warmup count

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    @classmethod
    def from_state_dict(
        cls, sd: Dict[str, torch.Tensor], device=None
    ) -> "LossAwareSamplerState":
        return cls(**{k: v.to(device) for k, v in sd.items()})


def loss_aware_init(
    num_buckets: int = 100,
    uniform_p: float = 0.01,
    alpha: float = 0.9,
    warmup: int = 10,
    device=None,
) -> LossAwareSamplerState:
    return LossAwareSamplerState(
        weights=torch.ones((num_buckets,), dtype=torch.float32, device=device),
        counts=torch.zeros((num_buckets,), dtype=torch.int32, device=device),
        uniform_p=torch.tensor(uniform_p, dtype=torch.float32, device=device),
        alpha=torch.tensor(alpha, dtype=torch.float32, device=device),
        warmup=torch.tensor(warmup, dtype=torch.int32, device=device),
    )


def loss_aware_warmed_up(state: LossAwareSamplerState) -> torch.Tensor:
    """True once every bucket has seen more than ``warmup`` samples
    (importance_sampling.py:43-44)."""
    return (state.counts > state.warmup).all()


def loss_aware_weights(state: LossAwareSamplerState) -> torch.Tensor:
    """Normalized sampling weights with the uniform floor
    (importance_sampling.py:17-23); uniform until warmed up."""
    n = state.weights.shape[0]
    w = state.weights / state.weights.sum()
    w = (1.0 - state.uniform_p) * w + state.uniform_p / n
    uniform = torch.full_like(w, 1.0 / n)
    return torch.where(loss_aware_warmed_up(state), w, uniform)


def loss_aware_sample(
    state: LossAwareSamplerState,
    batch_size: int,
    *,
    gumbel: Optional[torch.Tensor] = None,
    jitter: Optional[torch.Tensor] = None,
    use_jitter: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Draw diffusion times r in [0, 1) (importance_sampling.py:25-32).

    Args:
      gumbel: (batch_size, num_buckets) standard Gumbel noise; bucket b_i =
        argmax(log(w + 1e-20) + gumbel_i).
      jitter: (batch_size,) uniforms in [0, 1); r_i = (b_i + jitter_i) / n.
      use_jitter: False gives r_i = b_i / (n - 1) (the JAX ``jitter``
        flag).
      generator: source of the draws not given.
    """
    n = state.weights.shape[0]
    dev = state.weights.device
    if gumbel is None:
        u = torch.rand((batch_size, n), generator=generator, device=dev)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    w = loss_aware_weights(state)
    buckets = (torch.log(w + 1e-20) + gumbel).argmax(-1).to(torch.float32)
    if not use_jitter:
        return buckets / (n - 1)
    if jitter is None:
        jitter = torch.rand((batch_size,), generator=generator, device=dev)
    return (buckets + jitter) / n


def loss_aware_update(
    state: LossAwareSamplerState,
    ts: torch.Tensor,
    losses: torch.Tensor,
) -> LossAwareSamplerState:
    """EMA the histogram with this batch's per-sample losses.

    Reproduces the sequential per-sample EMA of importance_sampling.py:34-41:
    several hits to one bucket in a batch apply the EMA repeatedly, in
    batch order. A scatter (``index_put_``) would keep only one of them, so
    the batch is folded in closed form: a bucket hit by samples i_1 < ... <
    i_m ends at w * a^m + (1 - a) * sum_r loss_{i_r} * a^(m - r), summed in
    float64 and rounded once to float32. Deterministic (no atomics).
    """
    n = state.weights.shape[0]
    ts = ts.reshape(-1)
    losses = losses.reshape(-1)
    indices = (ts * n).to(torch.int64).clamp(0, n - 1)
    hits = torch.nn.functional.one_hot(indices, n)  # (B, n) int64
    per_bucket = hits.sum(0)  # (n,)
    later = per_bucket[indices] - hits.cumsum(0).gather(1, indices[:, None])[:, 0]
    a = state.alpha.double()
    contrib = (1.0 - a) * losses.double() * a ** later.double()  # (B,)
    weights = state.weights.double() * a ** per_bucket.double() + (
        hits.double() * contrib[:, None]
    ).sum(0)
    return dataclasses.replace(
        state,
        weights=weights.to(torch.float32),
        counts=state.counts + per_bucket.to(torch.int32),
    )


def uniform_sample(
    batch_size: int,
    *,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Null-object sampler (importance_sampling.py:50-57): diffusion times
    r ~ U[0, 1), ``uniforms`` when given, else drawn from ``generator``."""
    if uniforms is not None:
        return uniforms.reshape(batch_size)
    return torch.rand((batch_size,), generator=generator, device=device)
