"""Fused GIN conv (K1): one GIN layer per call, forward and backward.

Replaces ``pretrain_gnns_tpu/ops/pallas_gin.py::fused_gin_conv`` (the
Pallas TPU kernels ``_fwd_kernel``/``_bwd_kernel``). On the block-diagonal
batch it computes::

    msg_e  = w_e * (x[snd_e] + ein_e @ We)
    aggr_i = sum_{rcv_e = i} msg_e + (x_i + e_self) * nmask_i
    out    = relu(aggr @ W1 + b1) @ W2 + b2

with ``W1`` [F, 2F] and ``W2`` [2F, F] in the JAX (input-major) layout;
any strides are accepted, so ``linear.weight.t()`` views pass without a
copy. The forward saves ``aggr`` and ``z = relu(aggr @ W1 + b1)``; the
backward returns ``dx, dWe, de_self, dW1, db1, dW2, db2`` and zero
gradients for ``ein`` and ``w``.

On a CUDA tensor :func:`fused_gin_conv` launches the hand-written kernels
of ``csrc/gin_conv.cu`` (see the note there for what bounds them on the
card and how they are built) or raises; on a CPU tensor it runs the plain
PyTorch version :func:`fused_gin_conv_plain`. ``launches`` counts the
kernel launches of each direction and those of :func:`gemm`, the GEMM of
K1's (and K4's) products called alone.

:func:`set_fused` is the counterpart of the JAX package's
``pallas_gin.set_fused``: ``"on"`` (the default) routes the chem trunks'
``GINConv`` here, ``"off"`` to the unfused composition of the JAX
package's ``GINConv``: ``spmm.gather_scatter`` with the bond one-hots (the
fused edge-transform SpMM K2, its ``x + ein`` variant, on CUDA), the self
term and the two ``nn.Linear`` of the MLP.

Padded node rows get ``relu(b1) @ W2 + b2``, not zero, exactly as the JAX
kernel; the trunk masks them after the batch norm.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from pretrain_gnns_tpu_torch.ops import _build, spmm

launches: Dict[str, int] = {"gin_conv_fwd": 0, "gin_conv_bwd": 0, "gemm": 0}

_fused = True


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def set_fused(mode: str) -> None:
    """``"on"``: ``GINConv`` runs as one fused GIN conv call (K1);
    ``"off"``: as ``gather_scatter`` (K2), the self term and the MLP."""
    global _fused
    if mode not in ("on", "off"):
        raise ValueError(f"set_fused takes 'on' or 'off', got {mode!r}")
    _fused = mode == "on"


def fused_enabled() -> bool:
    return _fused


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = [_P] * 5 + [_L, _L, _P, _P, _L, _L] + [_P] * 8 + [_I] * 6 + [_P]
_BWD_ARGS = [_P] * 5 + [_L, _L, _P, _L, _L] + [_P] * 12 + [_I] * 6 + [_P]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gin_conv")
    lib.pgt_gin_conv_fwd.argtypes = _FWD_ARGS
    lib.pgt_gin_conv_fwd.restype = _I
    lib.pgt_gin_conv_bwd.argtypes = _BWD_ARGS
    lib.pgt_gin_conv_bwd.restype = _I
    lib.pgt_gin_conv_bwd_workspace.argtypes = [_I] * 5
    lib.pgt_gin_conv_bwd_workspace.restype = _L
    lib.pgt_gin_conv_max_block_nodes.restype = _I
    lib.pgt_gin_conv_max_k.restype = _I
    lib.pgt_gemm.argtypes = [_P, _L, _L, _P, _L, _L, _P] + [_I] * 4 + [_P] * 3 \
        + [_I, _P]
    lib.pgt_gemm.restype = _I
    lib.pgt_gemm_workspace.argtypes = [_I] * 4
    lib.pgt_gemm_workspace.restype = _L
    lib.pgt_gemm_wgrad_splits.argtypes = [_I] * 3
    lib.pgt_gemm_wgrad_splits.restype = _I
    return lib


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError("the gin_conv kernels take CUDA tensors")


def _check(lib, dev, block_nodes: int, block_edges: int, N: int, K: int,
           E: int, tensors) -> None:
    """Raise on what the kernels do not take: ``tensors`` lists
    ``(tensor, name, shape, dtype, must_be_contiguous)``."""
    if block_nodes <= 0 or block_edges <= 0:
        raise ValueError("the gin_conv kernels need the block-diagonal "
                         "layout (block_nodes, block_edges > 0)")
    if block_nodes > lib.pgt_gin_conv_max_block_nodes():
        raise ValueError(f"block_nodes={block_nodes} exceeds "
                         f"{lib.pgt_gin_conv_max_block_nodes()}")
    if K > lib.pgt_gin_conv_max_k():
        raise ValueError(f"K={K} exceeds {lib.pgt_gin_conv_max_k()}")
    if N % block_nodes or E != (N // block_nodes) * block_edges:
        raise ValueError(f"N={N}, E={E} do not form blocks of "
                         f"({block_nodes}, {block_edges})")
    _build.check_tensors(dev, tensors)


_F32, _I32 = torch.float32, torch.int32


def _edge_tensors(E, K, ein, senders, receivers, w):
    return [(ein, "ein", (E, K), _F32, True),
            (senders, "senders", (E,), _I32, True),
            (receivers, "receivers", (E,), _I32, True),
            (w, "w", (E,), _F32, True)]


def gin_conv_fwd(x, ein, We, e_self, W1, b1, W2, b2, senders, receivers, w,
                 nmask, block_nodes: int, block_edges: int):
    """Launch K1's forward; returns ``(out, aggr, z)``. ``nmask`` is f32."""
    _require_cuda(x)
    lib = _lib()
    N, F = x.shape
    K, F2, E = We.shape[0], W1.shape[1], senders.shape[0]
    _check(lib, x.device, block_nodes, block_edges, N, K, E, [
        (x, "x", (N, F), _F32, True),
        (We, "We", (K, F), _F32, True),
        (e_self, "e_self", (F,), _F32, True),
        (W1, "W1", (F, F2), _F32, False),
        (b1, "b1", (F2,), _F32, True),
        (W2, "W2", (F2, F), _F32, False),
        (b2, "b2", (F,), _F32, True),
        (nmask, "nmask", (N,), _F32, True),
    ] + _edge_tensors(E, K, ein, senders, receivers, w))
    out = torch.empty((N, F), dtype=_F32, device=x.device)
    aggr = torch.empty((N, F), dtype=_F32, device=x.device)
    z = torch.empty((N, F2), dtype=_F32, device=x.device)
    err = lib.pgt_gin_conv_fwd(
        x.data_ptr(), ein.data_ptr(), We.data_ptr(), e_self.data_ptr(),
        W1.data_ptr(), W1.stride(0), W1.stride(1), b1.data_ptr(),
        W2.data_ptr(), W2.stride(0), W2.stride(1), b2.data_ptr(),
        senders.data_ptr(), receivers.data_ptr(), w.data_ptr(),
        nmask.data_ptr(), out.data_ptr(), aggr.data_ptr(), z.data_ptr(),
        N, F, F2, K, block_nodes, block_edges, _build.stream(x),
    )
    if err:
        raise RuntimeError(
            f"gin_conv forward launch failed (CUDA error {err})")
    launches["gin_conv_fwd"] += 1
    return out, aggr, z


def gin_conv_bwd(g, aggr, z, ein, W1, W2, senders, receivers, w, nmask,
                 block_nodes: int, block_edges: int):
    """Launch K1's backward from the saved ``aggr`` and ``z``; returns
    ``(dx, dWe, de_self, dW1, db1, dW2, db2)``. ``nmask`` is f32."""
    _require_cuda(g)
    lib = _lib()
    N, F = g.shape
    K, F2, E = ein.shape[1], z.shape[1], senders.shape[0]
    _check(lib, g.device, block_nodes, block_edges, N, K, E, [
        (g, "g", (N, F), _F32, True),
        (aggr, "aggr", (N, F), _F32, True),
        (z, "z", (N, F2), _F32, True),
        (W1, "W1", (F, F2), _F32, False),
        (W2, "W2", (F2, F), _F32, False),
        (nmask, "nmask", (N,), _F32, True),
    ] + _edge_tensors(E, K, ein, senders, receivers, w))
    new = lambda *shape: torch.empty(shape, dtype=_F32, device=g.device)
    dx, dWe, des = new(N, F), new(K, F), new(F)
    dW1, db1, dW2, db2 = new(F, F2), new(F2), new(F2, F), new(F)
    work = new(lib.pgt_gin_conv_bwd_workspace(N, F, F2, K, N // block_nodes))
    err = lib.pgt_gin_conv_bwd(
        g.data_ptr(), aggr.data_ptr(), z.data_ptr(), ein.data_ptr(),
        W1.data_ptr(), W1.stride(0), W1.stride(1),
        W2.data_ptr(), W2.stride(0), W2.stride(1),
        senders.data_ptr(), receivers.data_ptr(), w.data_ptr(),
        nmask.data_ptr(), dx.data_ptr(), dWe.data_ptr(), des.data_ptr(),
        dW1.data_ptr(), db1.data_ptr(), dW2.data_ptr(), db2.data_ptr(),
        work.data_ptr(), N, F, F2, K, block_nodes, block_edges,
        _build.stream(g),
    )
    if err:
        raise RuntimeError(
            f"gin_conv backward launch failed (CUDA error {err})")
    launches["gin_conv_bwd"] += 1
    return dx, dWe, des, dW1, db1, dW2, db2


def gemm_plain(a, b, bias=None, pos_mask=None, relu: bool = False):
    """The plain PyTorch version of :func:`gemm`."""
    out = a @ b
    if bias is not None:
        out = out + bias
    if relu:
        out = torch.relu(out)
    if pos_mask is not None:
        out = torch.where(pos_mask > 0, out, 0.0)
    return out


def gemm(a, b, bias=None, pos_mask=None, relu: bool = False,
         splits: int = 1):
    """``epilogue(a @ b)``: the GEMM of ``csrc/gemm.cuh`` that carries K1's
    and K4's products, alone (tests and timing; the trunks reach it only
    through K1 and K4). ``a`` [M, K] and ``b`` [K, N] are float32 with any
    strides; the epilogue adds ``bias`` [N], applies ReLU and keeps the
    entries where ``pos_mask`` [M, N] > 0, in that order. ``splits`` > 1
    splits K into partial products summed in a fixed order, as the weight
    gradients do. The plain version on a CPU tensor."""
    if not a.is_cuda:
        return gemm_plain(a, b, bias, pos_mask, relu)
    lib = _lib()
    (M, K), N = a.shape, b.shape[1]
    _build.check_tensors(a.device, [(a, "a", (M, K), _F32, False),
                                    (b, "b", (K, N), _F32, False)] + [
        (t, name, shape, _F32, True) for t, name, shape in
        ((bias, "bias", (N,)), (pos_mask, "pos_mask", (M, N)))
        if t is not None])
    out = torch.empty((M, N), dtype=_F32, device=a.device)
    part = torch.empty(lib.pgt_gemm_workspace(M, N, K, splits), dtype=_F32,
                       device=a.device)
    ptr = lambda t: None if t is None or not t.numel() else t.data_ptr()
    err = lib.pgt_gemm(a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(),
                       b.stride(0), b.stride(1), out.data_ptr(), M, N, K,
                       splits, ptr(part), ptr(bias), ptr(pos_mask), int(relu),
                       _build.stream(a))
    if err:
        raise RuntimeError(f"gemm launch failed (CUDA error {err})")
    launches["gemm"] += 1
    return out


def wgrad_splits(M: int, N: int, K: int) -> int:
    """The splits of K that K1's backward gives a weight gradient [M, N]
    contracted over K rows (``gemm``'s ``splits``)."""
    return _lib().pgt_gemm_wgrad_splits(M, N, K)


class _FusedGinConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ein, We, e_self, W1, b1, W2, b2, senders, receivers,
                w, nmask, block_nodes, block_edges):
        nm = nmask.to(torch.float32)
        out, aggr, z = gin_conv_fwd(x, ein, We, e_self, W1, b1, W2, b2,
                                    senders, receivers, w, nm, block_nodes,
                                    block_edges)
        ctx.save_for_backward(ein, W1, W2, senders, receivers, w, nm, aggr, z)
        ctx.blocks = (block_nodes, block_edges)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ein, W1, W2, senders, receivers, w, nm, aggr, z = ctx.saved_tensors
        dx, dWe, des, dW1, db1, dW2, db2 = gin_conv_bwd(
            g.contiguous(), aggr, z, ein, W1, W2, senders, receivers, w, nm,
            *ctx.blocks,
        )

        def zero(i, t):
            return torch.zeros_like(t) if ctx.needs_input_grad[i] else None

        return (dx, zero(1, ein), dWe, des, dW1, db1, dW2, db2, None, None,
                zero(10, w), None, None, None)


def fused_gin_conv_plain(x, ein, We, e_self, W1, b1, W2, b2, senders,
                         receivers, w, nmask, block_nodes: int = 0,
                         block_edges: int = 0,
                         return_residuals: bool = False):
    """The plain PyTorch version of K1 (any layout; autograd gives the
    backward). With ``return_residuals`` returns ``(out, aggr, z)``."""
    aggr = spmm.gather_scatter_plain(x, senders, receivers, w, x.shape[0],
                                     edge_in=ein, edge_kernel=We)
    aggr = aggr + (x + e_self) * nmask.to(x.dtype)[:, None]
    z = torch.relu(aggr @ W1 + b1)
    out = z @ W2 + b2
    return (out, aggr, z) if return_residuals else out


def fused_gin_conv(x, ein, We, e_self, W1, b1, W2, b2, senders, receivers,
                   w, nmask, block_nodes: int, block_edges: int):
    """K1 on CUDA tensors (kernel forward and backward), the plain version
    on CPU tensors. ``w`` is the f32 edge weight with the mask folded in;
    ``nmask`` may be bool or f32."""
    if x.is_cuda:
        return _FusedGinConv.apply(x, ein, We, e_self, W1, b1, W2, b2,
                                   senders, receivers, w, nmask, block_nodes,
                                   block_edges)
    return fused_gin_conv_plain(x, ein, We, e_self, W1, b1, W2, b2, senders,
                                receivers, w, nmask, block_nodes, block_edges)
