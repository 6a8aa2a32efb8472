"""Sequence-parallel local 3D attention via halo exchange (port of
``world_modelz_tpu.parallel.sequence``).

Local 3D attention sees only ``e_s`` frames either side, so with the frame
axis S sharded over the mesh's ``seq`` axis a shard needs just an
``e_s``-deep halo of K and V from each neighbour (``_halo_exchange``, one
``ppermute`` each way), and none at the global borders.

The port runs the attention through the hand-written local-3D kernels
(``kernels.local3d.local3d_attention``: the forward and the split backward
pair) without changing them. A shard's queries are padded with zero frames
to the length of its halo-extended K and V, the Function runs on the
padded shard, and only the middle S_loc output frames are kept. The padded
query rows get a zero output gradient, so their dS is 0 and they add
nothing to dK and dV: the stitched dQ, dK and dV are exact. The halo
frames' dK and dV go back to their owner through the ``ppermute``'s
inverse. The first and last shard pad only toward the neighbour that
exists, so the kernels' own border mask is the clip's (JAX's global frame
masking, sequence.py:114-123). The price is 2 e_s / S_loc more work a
shard.

The JAX sequence path is a plain einsum that normalises P and then rounds
it to the value dtype, and sums dK and dV once in f32; the kernels here are
held to those rounding points (``ROUTE``), whatever route the padded
shape would take.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from world_modelz_tpu_torch.kernels import local3d as local3d_kernels
from world_modelz_tpu_torch.parallel.distributed import _ppermute
from world_modelz_tpu_torch.parallel.mesh import Axis, Mesh

# (divide_after, partial_rows): P normalised, then rounded; dK, dV one sum
ROUTE = (False, 0)

Halo = Optional[Tuple[torch.Tensor, torch.Tensor]]


class _HaloExchange(torch.autograd.Function):
    """Both halos of one tensor in one autograd node: a border rank uses
    one of them, so its graph still holds the node, and its backward (the
    two ``ppermute``s' inverses, which its neighbour joins) runs on every
    rank in the same order."""

    @staticmethod
    def forward(ctx, t, es, axis):
        ctx.es, ctx.axis = es, axis
        n = axis.size
        left = _ppermute(t[:, -es:], axis, tuple((i, i + 1) for i in range(n - 1)))
        right = _ppermute(t[:, :es], axis, tuple((i, i - 1) for i in range(1, n)))
        ctx.shape = t.shape
        return left, right

    @staticmethod
    def backward(ctx, g_left, g_right):
        n, es = ctx.axis.size, ctx.es
        # the inverse pairs: a left halo's gradient goes back to the left
        # neighbour's last frames, a right halo's to the right's first
        back_last = _ppermute(g_left.contiguous(), ctx.axis,
                              tuple((i + 1, i) for i in range(n - 1)))
        back_first = _ppermute(g_right.contiguous(), ctx.axis,
                               tuple((i - 1, i) for i in range(1, n)))
        dt = back_last.new_zeros(ctx.shape)
        dt[:, -es:] += back_last
        dt[:, :es] += back_first
        return dt, None, None


def _halo_exchange(t: torch.Tensor, es: int, axis: Axis
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Exchange ``es`` boundary frames with both neighbours along ``axis``.

    t: (B, S_loc, ...) local shard. Returns (left halo, right halo), each
    (B, es, ...): the left neighbour's last ``es`` frames and the right
    neighbour's first ``es``; None at the global borders (where JAX's ring
    wrap-around values are zeroed and masked)."""
    left, right = _HaloExchange.apply(t, es, axis)
    return (left if axis.index > 0 else None), (right if axis.index < axis.size - 1 else None)


def _check_extent(es: int, s_loc: int) -> None:
    if es > s_loc:
        raise ValueError(
            f"extent {es} exceeds the local shard length {s_loc}; "
            "use fewer sequence shards")


def local3d_attention_seq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    extents: Tuple[int, int, int],
    heads: int,
    left: Halo = None,
    right: Halo = None,
    attention=None,
) -> torch.Tensor:
    """Windowed space-time attention of one frame shard, given its halos.

    Args:
      q, k, v: (B, S_loc, H, W, heads * dim_head), the local frame shard.
      left, right: (K, V) halos of ``e_s`` frames from the neighbours, or
        None at a global border.
      attention: the differentiable attention run on the padded shard,
        ``f(q, k, v, extents, heads, route)``; default the kernels'
        Function (``kernels.local3d.local3d_attention``).

    Requires e_s <= S_loc (one-hop halos). Returns the local output shard
    (the kernels on CUDA, their plain versions on the CPU)."""
    es = extents[0]
    s_loc = q.shape[1]
    _check_extent(es, s_loc)
    ks, vs, lo = [k], [v], 0
    if left is not None:
        ks.insert(0, left[0])
        vs.insert(0, left[1])
        lo = left[0].shape[1]
    if right is not None:
        ks.append(right[0])
        vs.append(right[1])
    k_ext, v_ext = torch.cat(ks, 1), torch.cat(vs, 1)
    pad = k_ext.shape[1] - s_loc
    q_ext = q
    if pad:
        z = q.new_zeros((q.shape[0], 1, *q.shape[2:]))
        q_ext = torch.cat([z.expand(-1, lo, -1, -1, -1), q,
                           z.expand(-1, pad - lo, -1, -1, -1)], 1)
    attention = attention or local3d_kernels.local3d_attention
    out = attention(q_ext, k_ext, v_ext, extents, heads, ROUTE)
    return out[:, lo: lo + s_loc]


def seq_sharded_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    extents: Tuple[int, int, int],
    heads: int,
    axis: Axis,
) -> torch.Tensor:
    """Drop-in for ``models.attention.local3d_attention`` with the frame
    axis sharded over ``axis`` (a ``Mesh.axis("seq")``): the halos
    exchanged, then ``local3d_attention_seq``. Differentiable: the halo
    ``ppermute``s send the halo frames' dK and dV back in the backward
    pass, so it sits inside a training step."""
    es = extents[0]
    _check_extent(es, q.shape[1])
    left = right = None
    if es > 0 and axis.size > 1:
        kl, kr = _halo_exchange(k, es, axis)
        vl, vr = _halo_exchange(v, es, axis)
        left = None if kl is None else (kl, vl)
        right = None if kr is None else (kr, vr)
    return local3d_attention_seq(q, k, v, extents, heads, left, right)


def frame_range(s_loc: int, mesh: Mesh) -> Tuple[int, int]:
    """[lo, hi) of this seq rank's frames of the clip."""
    return mesh.seq * s_loc, (mesh.seq + 1) * s_loc


def check_seq(clip_len: int, es: int, n_seq: int) -> None:
    """The JAX video trainer's refusals (cli/video_diffusion.py:395-407)."""
    if clip_len % n_seq != 0:
        raise ValueError(
            f"n_past+1 ({clip_len} frames) must be divisible by "
            f"n_seq ({n_seq})")
    if clip_len // n_seq < es:
        raise ValueError(
            f"sequence shards of {clip_len // n_seq} frames are "
            f"shorter than the temporal extent {es}; "
            "use fewer sequence shards")


def attach_seq(model, mesh: Mesh):
    """Shard ``model``'s frame axis over ``mesh``'s seq axis: every
    submodule with a ``seq`` attribute (the local-3D transformer's position
    offset, each ``Local3dAttention``) takes the axis."""
    axis = mesh.axis("seq")
    for m in model.modules():
        if hasattr(m, "seq"):
            m.seq = axis if axis.size > 1 else None
    return model
