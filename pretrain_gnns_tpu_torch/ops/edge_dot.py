"""Blocked pair-dot scoring head (K3): the scores of the edge-prediction
objective's positive and negative pairs, forward and backward.

Replaces ``pretrain_gnns_tpu/ops/pallas_spmm.py::blocked_edge_dot`` (the
Pallas TPU kernels ``_edot_fwd_kernel``/``_edot_bwd_kernel``). On the
block-diagonal batch, for ``P = n_blocks * pairs_per_block`` pairs whose
endpoints lie in the pair's block::

    score[p] = w[p] * <x[a_idx[p]], x[b_idx[p]]>

``w`` is the f32 pair weight with the mask folded in (0 on padded pairs,
whose indices are 0). The backward returns ``dx`` and a zero gradient for
``w``, as the JAX custom VJP does; padded node rows of ``dx`` come out 0.

On a CUDA tensor :func:`blocked_edge_dot` launches the hand-written
kernels of ``csrc/edge_dot.cu`` (see the note there for what bounds them
on the card and how they are built) or raises; on a CPU tensor it runs the
plain PyTorch version :func:`edge_dot_plain`. ``launches`` counts the
kernel launches by direction: ``blocked_edge_dot_fwd``,
``blocked_edge_dot_bwd``.

``compute_dtype`` is the Pallas kernel's: at ``torch.bfloat16`` K3 rounds
the rows to bfloat16 before their products (the scores' sums in float32)
and, in the backward, each side's ``c * x_other`` before the sum. ``x``
may be float32 or bfloat16: the scores come out float32, ``dx`` in ``x``'s
dtype. The plain version at a compute dtype is :class:`_EdgeDotPlain`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from pretrain_gnns_tpu_torch.ops import _build
from pretrain_gnns_tpu_torch.ops import segment as seg

launches: Dict[str, int] = {"blocked_edge_dot_fwd": 0,
                            "blocked_edge_dot_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_F32, _I32, _BF16 = torch.float32, torch.int32, torch.bfloat16


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("edge_dot")
    lib.pgt_edot_fwd.argtypes = [_P] * 5 + [_I] * 7 + [_P]
    lib.pgt_edot_fwd.restype = _I
    lib.pgt_edot_bwd.argtypes = [_P] * 6 + [_I] * 7 + [_P]
    lib.pgt_edot_bwd.restype = _I
    lib.pgt_edot_bwd_smem.argtypes = [_I]
    lib.pgt_edot_bwd_smem.restype = _I
    lib.pgt_edot_max_smem.restype = _I
    return lib


def _check(x, a_idx, b_idx, w, block_nodes: int, pairs_per_block: int,
           extra=()) -> None:
    """Raise on what the kernels do not take; ``extra`` lists further
    ``(tensor, name, shape, dtype)`` entries."""
    if x.device.type != "cuda":
        raise ValueError("the blocked_edge_dot kernels take CUDA tensors")
    if block_nodes <= 0 or pairs_per_block <= 0:
        raise ValueError("the blocked_edge_dot kernels need the block-"
                         "diagonal layout (block_nodes, pairs_per_block > 0)")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, F], got {tuple(x.shape)}")
    (N, F), P = x.shape, a_idx.shape[0]
    if N % block_nodes or P != (N // block_nodes) * pairs_per_block:
        raise ValueError(f"N={N}, P={P} do not form blocks of "
                         f"({block_nodes}, {pairs_per_block})")
    tensors = [(x, "x", (N, F), _build.row_dtype(x, "x")),
               (a_idx, "a_idx", (P,), _I32),
               (b_idx, "b_idx", (P,), _I32), (w, "w", (P,), _F32), *extra]
    _build.check_tensors(x.device, [t + (True,) for t in tensors])


def edot_fwd(x, a_idx, b_idx, w, block_nodes: int, pairs_per_block: int,
             compute_dtype: torch.dtype = _F32) -> torch.Tensor:
    """Launch K3's forward; returns ``score [P]`` (float32)."""
    _check(x, a_idx, b_idx, w, block_nodes, pairs_per_block)
    bf = _build.check_compute_dtype(compute_dtype)
    (N, F), P = x.shape, a_idx.shape[0]
    out = torch.empty((P,), dtype=_F32, device=x.device)
    err = _lib().pgt_edot_fwd(
        x.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(), w.data_ptr(),
        out.data_ptr(), N, F, P, block_nodes, pairs_per_block,
        int(x.dtype == _BF16), int(bf), _build.stream(x))
    if err:
        raise RuntimeError(
            f"blocked_edge_dot forward launch failed (CUDA error {err})")
    launches["blocked_edge_dot_fwd"] += 1
    return out


def edot_bwd(g, x, a_idx, b_idx, w, block_nodes: int, pairs_per_block: int,
             compute_dtype: torch.dtype = _F32) -> torch.Tensor:
    """Launch K3's backward from the cotangent ``g [P]`` (float32); returns
    ``dx [N, F]`` in ``x``'s dtype, every row written."""
    P = a_idx.shape[0]
    _check(x, a_idx, b_idx, w, block_nodes, pairs_per_block,
           extra=[(g, "g", (P,), _F32)])
    bf = _build.check_compute_dtype(compute_dtype)
    lib = _lib()
    smem = lib.pgt_edot_bwd_smem(block_nodes)
    if smem > lib.pgt_edot_max_smem():
        raise ValueError(f"block_nodes={block_nodes} needs {smem} bytes of "
                         f"shared memory, more than "
                         f"{lib.pgt_edot_max_smem()}")
    N, F = x.shape
    dx = torch.empty((N, F), dtype=x.dtype, device=x.device)
    err = lib.pgt_edot_bwd(
        x.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(), w.data_ptr(),
        g.data_ptr(), dx.data_ptr(), N, F, P, block_nodes, pairs_per_block,
        int(x.dtype == _BF16), int(bf), _build.stream(x))
    if err:
        raise RuntimeError(
            f"blocked_edge_dot backward launch failed (CUDA error {err})")
    launches["blocked_edge_dot_bwd"] += 1
    return dx


class _BlockedEdgeDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a_idx, b_idx, w, block_nodes, pairs_per_block,
                compute_dtype):
        out = edot_fwd(x, a_idx, b_idx, w, block_nodes, pairs_per_block,
                       compute_dtype)
        ctx.save_for_backward(x, a_idx, b_idx, w)
        ctx.cfg = (block_nodes, pairs_per_block, compute_dtype)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, a_idx, b_idx, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = (edot_bwd(g.contiguous(), x, a_idx, b_idx, w, *ctx.cfg)
              if need[0] else None)
        dw = torch.zeros_like(w) if need[3] else None  # as the JAX VJP
        return dx, None, None, dw, None, None, None


class _EdgeDotPlain(torch.autograd.Function):
    """K3's plain version at a compute dtype: the Pallas kernel's bodies
    (``_edot_fwd_kernel``, ``_edot_bwd_kernel``) in torch, rounding where
    they round at bfloat16 and nowhere at float32; ``dw`` is zeros, as the
    JAX VJP's."""

    @staticmethod
    def forward(ctx, x, a_idx, b_idx, w, compute_dtype):
        r = _rounding(compute_dtype)
        xr = r(x.float())
        a, b = a_idx.long(), b_idx.long()
        ctx.save_for_backward(xr, a_idx, b_idx, w)
        ctx.x_dtype, ctx.r = x.dtype, r
        return (xr[a] * xr[b]).sum(dim=1) * w.float()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        r = ctx.r
        xr, a_idx, b_idx, w = ctx.saved_tensors
        a, b = a_idx.long(), b_idx.long()
        gw = (g.float() * w.float())[:, None]
        zero = torch.zeros_like(xr)
        dx = (seg.scatter_add_rows(zero, a, r(xr[b] * gw))
              + seg.scatter_add_rows(zero, b, r(xr[a] * gw)))
        need = ctx.needs_input_grad
        return (dx.to(ctx.x_dtype), None, None,
                torch.zeros_like(w) if need[3] else None, None)


def _rounding(compute_dtype: torch.dtype):
    """The Pallas kernels' ``astype(compute_dtype)`` of an operand held in
    float32: ``round_bf16`` at bfloat16, nothing at float32."""
    if _build.check_compute_dtype(compute_dtype):
        return _build.round_bf16
    return lambda t: t


def edge_dot_plain(x, a_idx, b_idx, w, block_nodes: int = 0,
                   pairs_per_block: int = 0,
                   compute_dtype: torch.dtype = None) -> torch.Tensor:
    """The plain PyTorch version of K3 (any layout). Without
    ``compute_dtype`` it is the JAX package's XLA form, which the CPU
    dispatch takes: two row gathers, a product, a sum over features, times
    ``w``, in ``x``'s dtype (autograd gives the backward). With it, it is
    the Pallas kernel's form, :class:`_EdgeDotPlain`: rows widened to
    float32 (and rounded at bfloat16), scores float32, ``dx`` in ``x``'s
    dtype."""
    if compute_dtype is not None:
        return _EdgeDotPlain.apply(x, a_idx, b_idx, w, compute_dtype)
    xa = x.index_select(0, a_idx.long())
    xb = x.index_select(0, b_idx.long())
    return (xa * xb).sum(dim=1) * w.to(x.dtype)


def blocked_edge_dot(x, a_idx, b_idx, w, block_nodes: int,
                     pairs_per_block: int,
                     compute_dtype: torch.dtype = _F32) -> torch.Tensor:
    """K3 on CUDA tensors (kernel forward and backward), the plain version
    at ``compute_dtype`` on CPU tensors."""
    if x.is_cuda:
        return _BlockedEdgeDot.apply(x, a_idx, b_idx, w, block_nodes,
                                     pairs_per_block, compute_dtype)
    return edge_dot_plain(x, a_idx, b_idx, w, block_nodes, pairs_per_block,
                          compute_dtype)
