"""Multi-latent EMA vector quantizer (port of ``world_modelz_tpu.ops.vq``).

The codebook is a plain ``(L, K, D)`` tensor (L latents, K codes of width
D), the layout of the JAX ``VQState.codebook`` and of the reference
``vq.embedding`` buffer. The state of a quantizer in training is a
:class:`VQState` of four tensors, and the functions here map ``(state, x)``
to ``(VQOutput, new state)`` as the JAX functions do; the tokenizer keeps
the state in its buffers (``models/tokenizer.py``).

Plain versions of the CUDA kernels live here: ``vq_encode`` (the
nearest-code kernel) and ``vq_train_stats_reference`` (the fused search +
statistics kernel). The CPU path and the tests use them; the CUDA path
never does. ``vq_apply`` is the plain training forward for any L (JAX's
``vq_backend="xla"``); ``vq_apply_fused`` takes its statistics from the
kernel wrapper (``kernels/vq_kernels.vq_train_stats``) for L = 1.

Both training forwards take a ``mesh``: under data parallelism the batch's
per-code statistics (counts, errors, input sums) are sums over the ranks'
rows, all-reduced before the EMA update, so every rank's codebook is the
global batch's (JAX's global view; the kernel's statistics are sums, so
the kernel stays on the path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from world_modelz_tpu_torch.parallel.distributed import all_reduce_sum
from world_modelz_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class VQState:
    """State of a multi-latent EMA vector quantizer (JAX ``VQState``).

    Attributes:
      codebook: (L, K, D) code vectors.
      cluster_size: (L, K) EMA of per-code assignment counts.
      activation_count: (L, K) assignments since the last reset.
      accumulated_error: (L, K) summed squared quantization error per code
        since the last reset.
    """

    codebook: torch.Tensor
    cluster_size: torch.Tensor
    activation_count: torch.Tensor
    accumulated_error: torch.Tensor

    def replace(self, **kw) -> "VQState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class VQOutput:
    """Result of a quantization forward pass.

    Attributes:
      quantized: same shape as the input; straight-through estimator applied.
      indices: (N, L) int32 codebook indices of the flattened input.
      commitment_loss: scalar mean squared error between the input and its
        (detached) quantization.
      perplexity: scalar codebook-usage perplexity.
    """

    quantized: torch.Tensor
    indices: torch.Tensor
    commitment_loss: torch.Tensor
    perplexity: torch.Tensor


def vq_init(
    num_latents: int,
    num_embeddings: int,
    embedding_dim: int,
    *,
    generator: torch.Generator = None,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> VQState:
    """Random-normal codebook, unit cluster sizes, zero statistics."""
    shape = (num_latents, num_embeddings)
    return VQState(
        codebook=torch.randn(
            (*shape, embedding_dim), generator=generator, device=device,
            dtype=dtype),
        cluster_size=torch.ones(shape, device=device, dtype=dtype),
        activation_count=torch.zeros(shape, device=device, dtype=dtype),
        accumulated_error=torch.zeros(shape, device=device, dtype=dtype),
    )


def codebook_distances(codebook: torch.Tensor, flat_x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (N, L, K) in f32 via |x|^2 + |e|^2 - 2 x.e.

    flat_x: (N, L, D); codebook: (L, K, D).
    """
    x = flat_x.float()
    e = codebook.float()
    x_sq = (x * x).sum(-1, keepdim=True)  # (N, L, 1)
    e_sq = (e * e).sum(-1)  # (L, K)
    cross = torch.einsum("nld,lkd->nlk", x, e)
    return x_sq + e_sq[None] - 2.0 * cross


def vq_encode(codebook: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices (int32), shape ``x.shape[:-1]``.

    The last dimension of ``x`` is the embedding width D; the one before it
    is read (through the flatten) as the latent index, as in the JAX
    ``vq_encode``. Ties go to the lowest code index (``argmin``).
    """
    num_latents, _, dim = codebook.shape
    flat_x = x.reshape(-1, num_latents, dim)
    distances = codebook_distances(codebook, flat_x)
    return distances.argmin(-1).to(torch.int32).reshape(x.shape[:-1])


def vq_decode(codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Codebook lookup; output gains a trailing D axis.

    ``indices`` has any leading shape whose flattened trailing layout is
    (N, L). Indices are read as JAX's ``take_along_axis(mode="clip")``
    reads them: a negative index counts from the end, then out-of-range
    indices are clamped into [0, K). The mask token K reaches decode and
    must stay finite.
    """
    num_latents, num_codes, dim = codebook.shape
    flat = indices.reshape(-1, num_latents).long()
    flat = torch.where(flat < 0, flat + num_codes, flat).clamp(0, num_codes - 1)
    latent = torch.arange(num_latents, device=codebook.device)
    quantized = codebook[latent[None, :], flat]  # (N, L, D)
    return quantized.reshape(*indices.shape, dim)


def vq_decode_masked(
    codebook: torch.Tensor, indices: torch.Tensor, mask_token: int
) -> torch.Tensor:
    """Decode with a virtual all-zeros embedding for ``mask_token``: the
    codebook stays untouched and masked positions are zeroed after the
    lookup."""
    decoded = vq_decode(codebook, indices)
    return torch.where((indices == mask_token)[..., None],
                       torch.zeros((), dtype=decoded.dtype, device=decoded.device),
                       decoded)


@torch.no_grad()
def vq_train_stats_reference(
    x: torch.Tensor, codebook: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused search + statistics kernel
    (``_vq_train_kernel``): for x (N, D) and a (K, D) codebook, returns

      idx (N,) int32: argmin_k |e_k|^2 - 2 x.e_k (|x|^2 dropped), ties to
        the lowest k;
      q (N, D) f32: the selected codes of the given (old) codebook;
      cnt (K,) f32: rows per code;
      err (K,) f32: per code, the sum of max(min dist + |x|^2, 0);
      dw (K, D) f32: per code, the sum of its rows of x.
    """
    x = x.float()
    e = codebook.float()
    num_codes = e.shape[0]
    e_sq = (e * e).sum(-1)
    dist = e_sq[None, :] - 2.0 * (x @ e.T)  # (N, K)
    idx = dist.argmin(-1)
    min_d = dist.gather(1, idx[:, None])[:, 0]
    err_row = (min_d + (x * x).sum(-1)).clamp_min(0.0)
    cnt = torch.bincount(idx, minlength=num_codes).to(torch.float32)
    err = torch.zeros(num_codes, device=x.device).index_add_(0, idx, err_row)
    dw = torch.zeros_like(e).index_add_(0, idx, x)
    return idx.to(torch.int32), e[idx], cnt, err, dw


def _ema_codebook(
    state: VQState, counts: torch.Tensor, dw: torch.Tensor, decay: float,
    eps: float, laplace_smoothing: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EMA cluster sizes (Laplace-smoothed) and the blended codebook from a
    batch's per-code counts (L, K) and raw input sums dw (L, K, D)."""
    num_codes = state.codebook.shape[1]
    cluster_size = state.cluster_size * decay + counts * (1.0 - decay)
    if laplace_smoothing:
        total = cluster_size.sum(-1, keepdim=True)
        smoothed = (cluster_size + eps) / (total + num_codes * eps) * total
    else:
        smoothed = cluster_size
    dw = dw / smoothed[:, :, None]
    codebook = state.codebook * decay + dw.to(state.codebook.dtype) * (1.0 - decay)
    return cluster_size, codebook


def _perplexity(counts: torch.Tensor, n: int) -> torch.Tensor:
    avg_probs = counts / max(n, 1)  # (L, K)
    num_latents = counts.shape[0]
    return torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum() / num_latents)


def vq_apply(
    state: VQState,
    x: torch.Tensor,
    *,
    train: bool,
    decay: float = 0.99,
    eps: float = 1e-5,
    laplace_smoothing: bool = True,
    mesh: Optional[Mesh] = None,
) -> Tuple[VQOutput, VQState]:
    """Quantize ``x`` (last dim D; the flatten reads (N, L, D)); when
    ``train``, also EMA-update the codebook with the batch's assignments to
    the old codebook. Activation and error statistics accumulate in both
    modes. Gradients reach ``x`` only through the commitment loss and the
    straight-through output; the state is computed without a graph. With a
    ``mesh`` the statistics and the perplexity are the global batch's."""
    mesh = mesh or Mesh()
    num_latents, num_codes, dim = state.codebook.shape
    flat_x = x.reshape(-1, num_latents, dim)
    n = flat_x.shape[0] * mesh.world
    with torch.no_grad():
        fx = flat_x.detach().float()
        indices = codebook_distances(state.codebook, fx).argmin(-1).to(torch.int32)
        quantized = vq_decode(state.codebook, indices)  # (N, L, D)
        onehot = torch.nn.functional.one_hot(
            indices.long(), num_codes).to(torch.float32)  # (N, L, K)
        counts = all_reduce_sum(onehot.sum(0), mesh)  # (L, K)
        sq_err = ((quantized.float() - fx) ** 2).sum(-1)  # (N, L)
        err_sum = all_reduce_sum(torch.einsum("nl,nlk->lk", sq_err, onehot), mesh)
        new_state = state.replace(
            activation_count=state.activation_count + counts,
            accumulated_error=state.accumulated_error + err_sum,
        )
        if train:
            dw = all_reduce_sum(torch.einsum("nlk,nld->lkd", onehot, fx), mesh)
            cluster_size, codebook = _ema_codebook(
                state, counts, dw, decay, eps, laplace_smoothing)
            new_state = new_state.replace(
                codebook=codebook, cluster_size=cluster_size)
        perplexity = _perplexity(counts, n)
    q = quantized.reshape(x.shape).to(x.dtype)
    out = VQOutput(
        quantized=x + (q - x).detach(),  # straight-through estimator
        indices=indices,
        commitment_loss=((q - x) ** 2).mean(),  # q carries no graph
        perplexity=perplexity,
    )
    return out, new_state


def vq_apply_fused(
    state: VQState,
    x: torch.Tensor,
    *,
    train: bool,
    decay: float = 0.99,
    eps: float = 1e-5,
    laplace_smoothing: bool = True,
    mesh: Optional[Mesh] = None,
) -> Tuple[VQOutput, VQState]:
    """``vq_apply`` for a single-latent codebook with the search and the
    per-code statistics from ``kernels.vq_kernels.vq_train_stats``: the
    CUDA kernel for a CUDA tensor, its plain version for a CPU tensor.
    The per-code error is the kernel's max(min dist + |x|^2, 0), as in the
    JAX ``vq_apply_fused``. L != 1 raises (use ``vq_apply``)."""
    from world_modelz_tpu_torch.kernels.vq_kernels import vq_train_stats

    num_latents, _, dim = state.codebook.shape
    if num_latents != 1:
        raise NotImplementedError(
            f"vq_apply_fused takes a single-latent codebook, got L="
            f"{num_latents}; use vq_apply")
    mesh = mesh or Mesh()
    flat_x = x.reshape(-1, dim)
    n = flat_x.shape[0] * mesh.world
    with torch.no_grad():
        idx, q, cnt, err, dw = vq_train_stats(
            flat_x.detach().float().contiguous(), state.codebook[0].contiguous())
        cnt, err, dw = (all_reduce_sum(t, mesh) for t in (cnt, err, dw))
        counts = cnt[None]  # (L, K)
        new_state = state.replace(
            activation_count=state.activation_count + counts,
            accumulated_error=state.accumulated_error + err[None],
        )
        if train:
            cluster_size, codebook = _ema_codebook(
                state, counts, dw[None], decay, eps, laplace_smoothing)
            new_state = new_state.replace(
                codebook=codebook, cluster_size=cluster_size)
        perplexity = _perplexity(counts, n)
    q = q.reshape(x.shape).to(x.dtype)
    out = VQOutput(
        quantized=x + (q - x).detach(),
        indices=idx[:, None],
        commitment_loss=((q - x) ** 2).mean(),
        perplexity=perplexity,
    )
    return out, new_state


def vq_reuse_inactive(state: VQState) -> Tuple[VQState, torch.Tensor]:
    """Move codes with zero activity toward the most active codes.

    The i-th dead code of a latent (in index order) takes 0.1 x itself +
    0.9 x the i-th most active code; the activity order is a stable sort
    (ties keep index order), as JAX's ``argsort``. Returns the new state
    and the number of reused codes (a scalar tensor)."""
    counts = state.activation_count
    num_codes = counts.shape[-1]
    dead = counts == 0  # (L, K)
    donor_order = torch.argsort(-counts, dim=-1, stable=True)
    rank = (dead.to(torch.int64).cumsum(-1) - 1).clamp(0, num_codes - 1)
    donor_idx = donor_order.gather(-1, rank)  # (L, K)
    dim = state.codebook.shape[-1]
    donors = state.codebook.gather(1, donor_idx[:, :, None].expand(-1, -1, dim))
    codebook = torch.where(
        dead[:, :, None], state.codebook * 0.1 + donors * 0.9, state.codebook)
    return state.replace(codebook=codebook), dead.sum().to(torch.int32)


def vq_reset_stats(state: VQState) -> VQState:
    """Zero the activation and error statistics."""
    return state.replace(
        activation_count=torch.zeros_like(state.activation_count),
        accumulated_error=torch.zeros_like(state.accumulated_error),
    )


@dataclasses.dataclass
class VQ1State:
    """State of the classic single-codebook EMA quantizer (JAX ``VQ1State``,
    vq-video-diffusion/vq.py:114-174), which tracks the EMA of the weighted
    input sum (``ema_w``) apart and divides by the EMA cluster size each
    step.

    Attributes:
      codebook: (K, D) code vectors.
      ema_cluster_size: (K,) EMA of per-code assignment counts.
      ema_w: (K, D) EMA of the inputs summed per code.
    """

    codebook: torch.Tensor
    ema_cluster_size: torch.Tensor
    ema_w: torch.Tensor


def vq1_init(
    *,
    num_embeddings: int,
    embedding_dim: int,
    generator: torch.Generator = None,
    device=None,
) -> VQ1State:
    """Random-normal codebook and ``ema_w``, zero cluster sizes."""
    shape = (num_embeddings, embedding_dim)
    return VQ1State(
        codebook=torch.randn(shape, generator=generator, device=device),
        ema_cluster_size=torch.zeros((num_embeddings,), device=device),
        ema_w=torch.randn(shape, generator=generator, device=device),
    )


def vq1_apply(
    state: VQ1State,
    x: torch.Tensor,
    *,
    train: bool,
    decay: float = 0.99,
    eps: float = 1e-5,
) -> Tuple[VQOutput, VQ1State]:
    """Single-codebook EMA quantization (JAX ``vq1_apply``,
    vq-video-diffusion/vq.py:131-174): nearest codes by |x|^2 + |e|^2 -
    2 x.e in f32; when ``train``, the cluster sizes and ``ema_w`` are
    EMA-updated with the batch's assignments (Laplace-smoothed sizes) and
    the codebook is ``ema_w / size``, and the output is quantized with that
    new codebook. Indices are (N,) int32 over the flattened input;
    gradients reach ``x`` through the commitment loss and the
    straight-through output only."""
    num_codes, dim = state.codebook.shape
    flat_x = x.reshape(-1, dim)
    with torch.no_grad():
        fx = flat_x.detach().float()
        e = state.codebook.float()
        distances = ((fx * fx).sum(1, keepdim=True) + (e * e).sum(1)
                     - 2.0 * fx @ e.T)
        indices = distances.argmin(-1).to(torch.int32)
        onehot = torch.nn.functional.one_hot(indices.long(), num_codes).to(torch.float32)
        new_state = state
        if train:
            cluster = state.ema_cluster_size * decay + onehot.sum(0) * (1.0 - decay)
            n = cluster.sum()
            cluster = (cluster + eps) / (n + num_codes * eps) * n
            ema_w = state.ema_w * decay + (onehot.T @ fx) * (1.0 - decay)
            new_state = VQ1State(codebook=ema_w / cluster[:, None],
                                 ema_cluster_size=cluster, ema_w=ema_w)
        q = new_state.codebook[indices.long()].reshape(x.shape).to(x.dtype)
        avg_probs = onehot.mean(0)
        perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())
    out = VQOutput(
        quantized=x + (q - x).detach(),  # straight-through estimator
        indices=indices,
        commitment_loss=((q - x) ** 2).mean(),  # q carries no graph
        perplexity=perplexity,
    )
    return out, new_state
