"""Grouped expert GEMMs: the CUDA kernels ``csrc/expert_gemm.cu``
(``expert_gemm_rows_kernel``, ``expert_gemm_wgrad_kernel``) and the row
moves around them, ``csrc/expert_rows.cu`` (``expert_rows_*``), their
wrappers and their plain versions.

The rows routed to the held experts lie in one (rows_max, K) buffer,
grouped by expert, each expert's group padded with zero rows to a multiple
of ``ROW_TILE`` (``offsets``: E + 1 int32 on the device, offsets[0] = 0,
offsets[E] the rows in use). Nothing reads the offsets on the host, so a
step that uses the kernels captures in a CUDA graph. A CUDA tensor
launches a kernel; a CPU tensor takes the plain version (which reads the
offsets, and loops over the experts).

The products (bf16 operands, f32 sums, bf16 outputs):

- ``swiglu_fwd``: G | U = X W_gu,e^T and act = silu(G) U, W_gu,e (2 I, K)
  gate rows then up rows (the kernel's mode 1);
- ``rows_nt``: Y = A W_e^T, W_e (N, K) (mode 0: the down projection);
- ``rows_nn``: C = A W_e, W_e (K, N) (mode 2: dX = dGU W_gu,e);
- ``swiglu_bwd``: dA = dY W_d,e, then dG | dU from G | U (mode 3);
- ``wgrad``: dW_e = A_e^T B_e over the expert's rows.

The row moves (only the rows in use, ``offsets[E]``, are touched):

- ``gather_rows``: each row's token's input (zeros for a padding row);
- ``combine_rows``: each token's sum of its rows (weighted), in f32 in slot
  order, rounded to the rows' dtype;
- ``scatter_rows_bwd``: each row's share of its token's gradient (times its
  weight, rounded) and the weight's gradient (the dot product, f32).

The SwiGLU epilogues round where PyTorch's bf16 operations do: G, U,
silu(G) and act; dA, dU, dA U and dG.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from world_modelz_tpu_torch.kernels._build import LAUNCHES, check, load_library, on_cpu, stream

ROW_TILE = 128  # rows of a kernel tile: each expert's group is padded to it


def _spans(offsets: torch.Tensor) -> List[Tuple[int, int]]:
    off = offsets.tolist()
    return list(zip(off[:-1], off[1:]))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b with f32 sums, rounded to a's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _silu_bwd(ds: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """PyTorch's silu backward: ds sigmoid(g) (1 + g (1 - sigmoid(g))),
    in f32, rounded."""
    gf = g.float()
    sig = torch.sigmoid(gf)
    return (ds.float() * (sig * (1.0 + gf * (1.0 - sig)))).to(g.dtype)


def _check(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> None:
    if a.dim() != 2 or w.dim() != 3 or offsets.dim() != 1 or offsets.shape[0] != w.shape[0] + 1:
        raise ValueError(f"expected a (rows, K), w (E, ., .) and E + 1 offsets; got "
                         f"{tuple(a.shape)}, {tuple(w.shape)}, {tuple(offsets.shape)}")
    if a.shape[0] % ROW_TILE:
        raise ValueError(f"rows_max {a.shape[0]} is not a multiple of {ROW_TILE}")


def _launch(a, w, c, aux, offsets, n, k, inter, mode, what):
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes bfloat16 operands, got {a.dtype}, {w.dtype}")
    if offsets.dtype != torch.int32 or not all(
            t.is_contiguous() for t in (a, w, offsets) + ((aux,) if aux is not None else ())):
        raise ValueError(f"{what} takes contiguous operands and int32 offsets")
    LAUNCHES[what] += 1
    status = load_library().wmz_expert_gemm(
        a.data_ptr(), w.data_ptr(), c.data_ptr(), 0 if aux is None else aux.data_ptr(),
        offsets.data_ptr(), w.shape[0], a.shape[0], n, k, w.stride(0), inter, mode, stream(a))
    check(status, what)


def swiglu_fwd(x: torch.Tensor, w_gu: torch.Tensor, offsets: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G | U (rows, 2 I), act = silu(G) U (rows, I)) of every expert's rows."""
    _check(x, w_gu, offsets)
    rows, inter = x.shape[0], w_gu.shape[1] // 2
    if on_cpu("expert_gemm", x, w_gu, offsets):
        gu = torch.zeros((rows, 2 * inter), dtype=x.dtype)
        for e, (r0, r1) in enumerate(_spans(offsets)):
            gu[r0:r1] = _mm(x[r0:r1], w_gu[e].t())
        act = F.silu(gu[:, :inter]) * gu[:, inter:]
        return gu, act
    gu = torch.empty((rows, 2 * inter), dtype=x.dtype, device=x.device)
    act = torch.empty((rows, inter), dtype=x.dtype, device=x.device)
    _launch(x, w_gu, gu, act, offsets, 2 * inter, x.shape[1], inter, 1, "expert_gemm_swiglu")
    return gu, act


def rows_nt(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """A W_e^T (rows, N) for every expert's rows, W (E, N, K)."""
    _check(a, w, offsets)
    n = w.shape[1]
    if on_cpu("expert_gemm", a, w, offsets):
        out = torch.zeros((a.shape[0], n), dtype=a.dtype)
        for e, (r0, r1) in enumerate(_spans(offsets)):
            out[r0:r1] = _mm(a[r0:r1], w[e].t())
        return out
    out = torch.empty((a.shape[0], n), dtype=a.dtype, device=a.device)
    _launch(a, w, out, None, offsets, n, a.shape[1], 0, 0, "expert_gemm_nt")
    return out


def rows_nn(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """A W_e (rows, N) for every expert's rows, W (E, K, N)."""
    _check(a, w, offsets)
    n = w.shape[2]
    if on_cpu("expert_gemm", a, w, offsets):
        out = torch.zeros((a.shape[0], n), dtype=a.dtype)
        for e, (r0, r1) in enumerate(_spans(offsets)):
            out[r0:r1] = _mm(a[r0:r1], w[e])
        return out
    out = torch.empty((a.shape[0], n), dtype=a.dtype, device=a.device)
    _launch(a, w, out, None, offsets, n, a.shape[1], 0, 2, "expert_gemm_nn")
    return out


def swiglu_bwd(dy: torch.Tensor, w_down: torch.Tensor, gu: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """dG | dU (rows, 2 I) from dY (rows, K) through the down weights W_d
    (E, K, I) and the forward's G | U."""
    _check(dy, w_down, offsets)
    inter = w_down.shape[2]
    if on_cpu("expert_gemm", dy, w_down, gu, offsets):
        da = rows_nn(dy, w_down, offsets)
        g, u = gu[:, :inter], gu[:, inter:]
        du = da * F.silu(g)
        dg = _silu_bwd(da * u, g)
        return torch.cat([dg, du], dim=1)
    dgu = torch.empty((dy.shape[0], 2 * inter), dtype=dy.dtype, device=dy.device)
    _launch(dy, w_down, dgu, gu, offsets, inter, dy.shape[1], inter, 3,
            "expert_gemm_swiglu_bwd")
    return dgu


def wgrad(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """dW_e = A_e^T B_e (E, M, N) over each expert's rows: A (rows, M), B
    (rows, N)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"wgrad takes (rows, M) and (rows, N), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    e = offsets.shape[0] - 1
    m, n = a.shape[1], b.shape[1]
    if on_cpu("expert_gemm", a, b, offsets):
        out = torch.zeros((e, m, n), dtype=a.dtype)
        for i, (r0, r1) in enumerate(_spans(offsets)):
            out[i] = _mm(a[r0:r1].t(), b[r0:r1])
        return out
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or offsets.dtype != torch.int32:
        raise TypeError("expert_gemm_wgrad takes bfloat16 operands and int32 offsets")
    out = torch.empty((e, m, n), dtype=a.dtype, device=a.device)
    LAUNCHES["expert_gemm_wgrad"] += 1
    status = load_library().wmz_expert_gemm_wgrad(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), offsets.data_ptr(), e, m, n, stream(a))
    check(status, "expert_gemm_wgrad")
    return out


def _rows_launch(a, y, b, w, offsets, out, dw, e, t, k, mode, what):
    if a.dtype != torch.bfloat16 or a.shape[-1] % 8 or not a.is_contiguous():
        raise ValueError(f"{what} takes contiguous bfloat16 rows of a multiple of 8 values")
    LAUNCHES[what] += 1
    ptr = (lambda z: 0 if z is None else z.data_ptr())
    status = load_library().wmz_expert_rows(
        a.data_ptr(), ptr(y), b.data_ptr(), ptr(w), ptr(offsets), out.data_ptr(), ptr(dw),
        e, t, k, a.shape[-1], mode, stream(a))
    check(status, what)


def gather_rows(x: torch.Tensor, token: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(rows_max, D): row r the input of its token ``token[r]`` (T: a
    padding row, zeros) for the rows in use; the rest is not written."""
    t, d = x.shape
    if on_cpu("expert_rows", x, token, offsets):
        return torch.cat([x, x.new_zeros(1, d)])[token]
    out = torch.empty((token.shape[0], d), dtype=x.dtype, device=x.device)
    _rows_launch(x, None, token, None, offsets, out, None, offsets.shape[0] - 1, t, 0, 0,
                 "expert_rows_gather")
    return out


def combine_rows(y: torch.Tensor, row_of: torch.Tensor, w=None) -> torch.Tensor:
    """(T, D): each token's sum over its k slots of w[t, s] y[row_of[t, s]]
    (slots with row -1 skipped; w None: 1), f32 in slot order, rounded to
    y's dtype."""
    t, k = row_of.shape
    if on_cpu("expert_rows", y, row_of):
        acc = torch.zeros((t, y.shape[1]), dtype=torch.float32)
        for s in range(k):
            r = row_of[:, s]
            part = y[r.clamp(min=0)].float()
            if w is not None:
                part = part * w[:, s, None]
            acc += torch.where((r >= 0)[:, None], part, 0.0)
        return acc.to(y.dtype)
    out = torch.empty((t, y.shape[1]), dtype=y.dtype, device=y.device)
    _rows_launch(y, None, row_of, w, None, out, None, 0, t, k, 1, "expert_rows_combine")
    return out


def scatter_rows_bwd(dout: torch.Tensor, y: torch.Tensor, token: torch.Tensor,
                     w_row: torch.Tensor, offsets: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy, dw_row) for the rows in use: dy[r] = dout[token[r]] w_row[r]
    rounded to y's dtype, dw_row[r] = dout[token[r]] . y[r] in f32 (zeros
    for a padding row)."""
    t, d = dout.shape
    if on_cpu("expert_rows", dout, y, token, w_row, offsets):
        g = torch.cat([dout, dout.new_zeros(1, d)])[token].float()
        return (g * w_row[:, None]).to(y.dtype), (g * y.float()).sum(-1)
    dy = torch.empty_like(y)
    dw = torch.empty(token.shape[0], dtype=torch.float32, device=y.device)
    _rows_launch(dout, y, token, w_row, offsets, dy, dw, offsets.shape[0] - 1, t, 0, 2,
                 "expert_rows_scatter_bwd")
    return dy, dw
