"""A 2-D self-organizing map as functions of an explicit state.

Port of ``world_modelz_tpu.ops.som`` (reference: ``SomLayer``,
som-diffusion/som.py:8-159): best-matching-unit (BMU) search by squared L2,
index <-> normalized [-1, 1]^2 coordinate codecs (channels last), the
straight-through forward, Gaussian-neighbourhood ``adapt`` updates in
sequential chunks, and activation counts.

The BMU distances are |x|^2 + |e|^2 - 2 x.e in f32 with TF32 off for the
product (``utils.fvd.tf32_off``), the first of equal minima winning, as
JAX's ``argmin``. ``som_adapt`` runs JAX's ``lax.scan`` as a loop over the
chunks: each chunk's BMUs are searched against the embeddings the previous
chunk moved; the ragged tail is zero-padded and masked out of the update,
the error and the counts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from world_modelz_tpu_torch.utils.fvd import tf32_off


@dataclasses.dataclass
class SomState:
    embedding: torch.Tensor  # (width * height, embedding_dim) f32
    activation_count: torch.Tensor  # (width * height,) int32
    width: int
    height: int

    @property
    def embedding_dim(self) -> int:
        return self.embedding.shape[1]

    def replace(self, **changes) -> "SomState":
        return dataclasses.replace(self, **changes)


def som_init(width: int, height: int, embedding_dim: int, *,
             generator: Optional[torch.Generator] = None, device=None) -> SomState:
    """Uniform(-0.1, 0.1) map (som.py:21), zero counts."""
    emb = torch.rand((width * height, embedding_dim), generator=generator, device=device)
    return SomState(embedding=emb * 0.2 - 0.1,
                    activation_count=torch.zeros(width * height, dtype=torch.int32,
                                                 device=emb.device),
                    width=width, height=height)


def _pos_map(state: SomState) -> torch.Tensor:
    """(K, 2) f32 (x, y) map coordinates of every unit (som.py:23-25)."""
    idx = torch.arange(state.width * state.height, device=state.embedding.device)
    return torch.stack([idx % state.width, idx // state.width], dim=-1).float()


def som_distances(embedding: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """(N, K) squared L2 distances of the (N, D) rows to the (K, D) map, in
    f32 with TF32 off."""
    with tf32_off():
        cross = flat @ embedding.T
    return (torch.sum(flat * flat, dim=1, keepdim=True) + torch.sum(embedding * embedding, dim=1)
            - 2.0 * cross)


def som_encode(state: SomState, x: torch.Tensor) -> torch.Tensor:
    """BMU indices (int64), shape ``x.shape[:-1]`` (som.py:84-99)."""
    flat = x.reshape(-1, state.embedding_dim).float()
    return torch.argmin(som_distances(state.embedding, flat), dim=1).reshape(x.shape[:-1])


def som_decode(state: SomState, indices: torch.Tensor) -> torch.Tensor:
    """Map lookup, indices clipped into the map (som.py:102-104)."""
    k = state.embedding.shape[0]
    return state.embedding[indices.long().clamp(0, k - 1)]


def encode_indices_2d(state: SomState, indices: torch.Tensor) -> torch.Tensor:
    """BMU index -> normalized (x, y) in [-1, 1]^2 at the unit centres
    (som.py:30-51); output (..., 2)."""
    w, h = state.width, state.height
    x = (indices % w).float()
    y = torch.div(indices, w, rounding_mode="floor").float()
    x = (x - (w / 2 - 0.5)) / (w / 2)
    y = (y - (h / 2 - 0.5)) / (h / 2)
    return torch.stack([x, y], dim=-1)


def decode_indices_2d(state: SomState, pos: torch.Tensor) -> torch.Tensor:
    """Normalized (x, y) (..., 2) -> BMU index (som.py:53-71)."""
    eps = 1e-6
    w, h = state.width, state.height
    pos = torch.clamp(pos, -1 + eps, 1 - eps)
    x = torch.floor(pos[..., 0] * (w / 2) + w / 2)
    y = torch.floor(pos[..., 1] * (h / 2) + h / 2)
    return (y * w + x).long()


def som_encode_2d(state: SomState, x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., 2) normalized coordinates (som.py:73-76)."""
    return encode_indices_2d(state, som_encode(state, x))


def som_decode_2d(state: SomState, pos: torch.Tensor) -> torch.Tensor:
    """(..., 2) coordinates -> (..., D) map vectors (som.py:78-81)."""
    return som_decode(state, decode_indices_2d(state, pos))


def som_forward(state: SomState, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Straight-through quantization and the mean squared difference
    (som.py:106-111): (x + (q - x) with no gradient, mean((q - x)^2)
    whose gradient reaches x only)."""
    q = som_decode(state, som_encode(state, x)).to(x.dtype)
    return x + (q - x).detach(), torch.mean((q.detach() - x) ** 2)


@torch.no_grad()
def som_adapt(
    state: SomState,
    x: torch.Tensor,
    alpha: float,
    sigma: float,
    adapt_batch_size: int = 256,
    stats: bool = True,
) -> Tuple[SomState, torch.Tensor]:
    """Gaussian-neighbourhood SOM update (som.py:122-159), JAX's chunk for
    chunk: each chunk of ``adapt_batch_size`` rows finds its BMUs against
    the embeddings as the previous chunk left them, then moves every unit
    by alpha * mean over the chunk of exp(-d((x, y), bmu)^2 / sigma^2) *
    (row - unit). Returns (the new state, the mean squared quantization
    error per element, an f32 scalar tensor); ``state`` is not changed."""
    dev = state.embedding.device
    alpha = torch.tensor(max(alpha, 0.0), dtype=torch.float32, device=dev)
    sigma = torch.tensor(max(sigma, 1e-6), dtype=torch.float32, device=dev)
    d = state.embedding_dim
    flat = x.reshape(-1, d).float()
    n = flat.shape[0]
    c = min(adapt_batch_size, n)
    num_chunks = -(-n // c)
    padded = torch.zeros((num_chunks * c, d), device=dev)
    padded[:n] = flat
    valid = (torch.arange(num_chunks * c, device=dev) < n).float()
    pos_map = _pos_map(state)
    emb, act = state.embedding, state.activation_count
    errs = []
    for i in range(num_chunks):
        xc, w = padded[i * c:(i + 1) * c], valid[i * c:(i + 1) * c]
        bmu = torch.argmin(som_distances(emb, xc), dim=1)
        q = emb[bmu]
        errs.append(torch.sum(w * torch.sum((xc - q) ** 2, dim=-1)))
        if stats:
            act = act.index_add(0, bmu, w.to(torch.int32))
        bmu_pos = torch.stack([bmu % state.width,
                               torch.div(bmu, state.width, rounding_mode="floor")],
                              dim=-1).float()
        d2 = torch.sum((pos_map[None, :, :] - bmu_pos[:, None, :]) ** 2, dim=-1)  # (C, K)
        nbhd = torch.exp(-d2 / (sigma * sigma)) * w[:, None]
        with tf32_off():
            pulled = torch.einsum("ck,cd->kd", nbhd, xc)
        delta = (pulled - torch.sum(nbhd, dim=0)[:, None] * emb) / torch.clamp(w.sum(), min=1.0)
        emb = emb + alpha * delta
    error = torch.sum(torch.stack(errs)) / (n * d)
    return state.replace(embedding=emb, activation_count=act), error


def som_reset_stats(state: SomState) -> SomState:
    return state.replace(activation_count=torch.zeros_like(state.activation_count))
