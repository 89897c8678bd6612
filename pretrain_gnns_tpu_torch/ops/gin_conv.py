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
K1's (and K4's) float32 products called alone, and of :func:`gemm_bf16`,
the tensor-core GEMM of K1's bfloat16 products called alone.

:func:`set_fused` is the counterpart of the JAX package's
``pallas_gin.set_fused``: ``"on"`` (the default) routes the chem trunks'
``GINConv`` here, ``"off"`` to the unfused composition of the JAX
package's ``GINConv``: ``spmm.gather_scatter`` with the bond one-hots (the
fused edge-transform SpMM K2, its ``x + ein`` variant, on CUDA), the self
term and the two ``nn.Linear`` of the MLP.

Padded node rows get ``relu(b1) @ W2 + b2``, not zero, exactly as the JAX
kernel; the trunk masks them after the batch norm.

``compute_dtype`` is the Pallas kernel's: at ``torch.bfloat16`` the layer
rounds its operands to bfloat16 where the Pallas body does (the edge
weight, ``x``, ``w * ein`` and ``We``; each message before the receiver
sum; ``aggr``, ``z``, ``g``, ``dzr`` and the weights before each product;
``da`` before the aggregation's backward), with every product and sum in
float32. ``x`` may be float32 or bfloat16; ``out`` and ``dx`` come out in
``x``'s dtype, the residuals ``aggr`` and ``z`` in the compute dtype, the
weight gradients in float32. The plain version at bfloat16 is
:class:`_GinConvPlainBf16`, the Pallas body written out in torch. It stays
apart from the float32 plain version (autograd over
``gather_scatter_plain`` and the MLP): with its rounding taken out it
associates the message as ``w x[snd] + (w ein) @ We``, not
``w (x[snd] + ein @ We)``, which moves the last bits of ``out`` and of
three gradients, and the float32 plain
version keeps the bits the float32 tests and ``return_residuals`` were
written on.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from pretrain_gnns_tpu_torch.ops import _build, spmm
from pretrain_gnns_tpu_torch.ops import segment as seg

launches: Dict[str, int] = {"gin_conv_fwd": 0, "gin_conv_bwd": 0, "gemm": 0,
                            "gemm_bf16": 0}

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
_FWD_ARGS = [_P] * 5 + [_L, _L, _P, _P, _L, _L] + [_P] * 9 + [_I] * 8 + [_P]
_BWD_ARGS = [_P] * 5 + [_L, _L, _P, _L, _L] + [_P] * 12 + [_I] * 8 + [_P]


def configure(lib):
    """Set the argument and result types of K1's library ``lib`` (this
    tree's interface); returns ``lib``."""
    lib.pgt_gin_conv_fwd.argtypes = _FWD_ARGS
    lib.pgt_gin_conv_fwd.restype = _I
    lib.pgt_gin_conv_bwd.argtypes = _BWD_ARGS
    lib.pgt_gin_conv_bwd.restype = _I
    lib.pgt_gin_conv_fwd_workspace.argtypes = [_I] * 3
    lib.pgt_gin_conv_fwd_workspace.restype = _L
    lib.pgt_gin_conv_bwd_workspace.argtypes = [_I] * 7
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
    lib.pgt_gemm_bf16.argtypes = [_P, _L, _L, _P, _L, _L, _P] + [_I] * 5 \
        + [_P] * 3 + [_I, _I, _P]
    lib.pgt_gemm_bf16.restype = _I
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return configure(_build.load("gin_conv"))


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


_F32, _I32, _BF16 = torch.float32, torch.int32, torch.bfloat16


def _edge_tensors(E, K, ein, senders, receivers, w):
    return [(ein, "ein", (E, K), _F32, True),
            (senders, "senders", (E,), _I32, True),
            (receivers, "receivers", (E,), _I32, True),
            (w, "w", (E,), _F32, True)]


def gin_conv_fwd(x, ein, We, e_self, W1, b1, W2, b2, senders, receivers, w,
                 nmask, block_nodes: int, block_edges: int,
                 compute_dtype: torch.dtype = _F32):
    """Launch K1's forward; returns ``(out, aggr, z)``: ``out`` in ``x``'s
    dtype (float32 or bfloat16), ``aggr`` and ``z`` in ``compute_dtype``.
    ``nmask`` is f32."""
    _require_cuda(x)
    lib = _lib()
    N, F = x.shape
    K, F2, E = We.shape[0], W1.shape[1], senders.shape[0]
    rows = _build.row_dtype(x, "x")
    bf = _build.check_compute_dtype(compute_dtype)
    _check(lib, x.device, block_nodes, block_edges, N, K, E, [
        (x, "x", (N, F), rows, True),
        (We, "We", (K, F), _F32, True),
        (e_self, "e_self", (F,), _F32, True),
        (W1, "W1", (F, F2), _F32, False),
        (b1, "b1", (F2,), _F32, True),
        (W2, "W2", (F2, F), _F32, False),
        (b2, "b2", (F,), _F32, True),
        (nmask, "nmask", (N,), _F32, True),
    ] + _edge_tensors(E, K, ein, senders, receivers, w))
    out = torch.empty((N, F), dtype=rows, device=x.device)
    aggr = torch.empty((N, F), dtype=compute_dtype, device=x.device)
    z = torch.empty((N, F2), dtype=compute_dtype, device=x.device)
    flags = (int(rows == _BF16), int(bf))
    work = torch.empty(lib.pgt_gin_conv_fwd_workspace(F, F2, int(bf)),
                       dtype=_F32, device=x.device)
    err = lib.pgt_gin_conv_fwd(
        x.data_ptr(), ein.data_ptr(), We.data_ptr(), e_self.data_ptr(),
        W1.data_ptr(), W1.stride(0), W1.stride(1), b1.data_ptr(),
        W2.data_ptr(), W2.stride(0), W2.stride(1), b2.data_ptr(),
        senders.data_ptr(), receivers.data_ptr(), w.data_ptr(),
        nmask.data_ptr(), out.data_ptr(), aggr.data_ptr(), z.data_ptr(),
        work.data_ptr() if work.numel() else None, N, F, F2, K, block_nodes,
        block_edges, *flags, _build.stream(x),
    )
    if err:
        raise RuntimeError(
            f"gin_conv forward launch failed (CUDA error {err})")
    launches["gin_conv_fwd"] += 1
    return out, aggr, z


def gin_conv_bwd(g, aggr, z, ein, W1, W2, senders, receivers, w, nmask,
                 block_nodes: int, block_edges: int,
                 compute_dtype: torch.dtype = _F32):
    """Launch K1's backward from the saved ``aggr`` and ``z`` (in
    ``compute_dtype``); returns ``(dx, dWe, de_self, dW1, db1, dW2, db2)``,
    ``dx`` in ``g``'s dtype (the rows'), the rest float32. ``nmask`` is
    f32."""
    _require_cuda(g)
    lib = _lib()
    N, F = g.shape
    K, F2, E = ein.shape[1], z.shape[1], senders.shape[0]
    rows = _build.row_dtype(g, "g")
    bf = _build.check_compute_dtype(compute_dtype)
    _check(lib, g.device, block_nodes, block_edges, N, K, E, [
        (g, "g", (N, F), rows, True),
        (aggr, "aggr", (N, F), compute_dtype, True),
        (z, "z", (N, F2), compute_dtype, True),
        (W1, "W1", (F, F2), _F32, False),
        (W2, "W2", (F2, F), _F32, False),
        (nmask, "nmask", (N,), _F32, True),
    ] + _edge_tensors(E, K, ein, senders, receivers, w))
    new = lambda *shape: torch.empty(shape, dtype=_F32, device=g.device)
    dx = torch.empty((N, F), dtype=rows, device=g.device)
    dWe, des = new(K, F), new(F)
    dW1, db1, dW2, db2 = new(F, F2), new(F2), new(F2, F), new(F)
    flags = (int(rows == _BF16), int(bf))
    work = new(lib.pgt_gin_conv_bwd_workspace(N, F, F2, K, N // block_nodes,
                                              *flags))
    err = lib.pgt_gin_conv_bwd(
        g.data_ptr(), aggr.data_ptr(), z.data_ptr(), ein.data_ptr(),
        W1.data_ptr(), W1.stride(0), W1.stride(1),
        W2.data_ptr(), W2.stride(0), W2.stride(1),
        senders.data_ptr(), receivers.data_ptr(), w.data_ptr(),
        nmask.data_ptr(), dx.data_ptr(), dWe.data_ptr(), des.data_ptr(),
        dW1.data_ptr(), db1.data_ptr(), dW2.data_ptr(), db2.data_ptr(),
        work.data_ptr(), N, F, F2, K, block_nodes, block_edges, *flags,
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


def gemm_bf16_plain(a, b, bias=None, pos_mask=None, relu: bool = False,
                    out_dtype: torch.dtype = _F32):
    """The plain PyTorch version of :func:`gemm_bf16`: the float32 product
    of the bfloat16 operands (each product exact in float32), the epilogue
    in float32, the result in ``out_dtype``."""
    pm = None if pos_mask is None else pos_mask.float()
    return gemm_plain(a.float(), b.float(), bias, pm, relu).to(out_dtype)


def gemm_bf16(a, b, bias=None, pos_mask=None, relu: bool = False,
              splits: int = 1, out_dtype: torch.dtype = _F32,
              ordered_ties: bool = True):
    """``epilogue(a @ b)`` for bfloat16 ``a`` [M, K] and ``b`` [K, N] on the
    tensor cores with float32 sums: the GEMM of ``csrc/gemm.cuh`` that
    carries K1's products at compute_dtype bfloat16, alone (tests and
    timing). Each operand needs one stride of 1 (a row-major matrix or a
    transposed view of one); the epilogue is :func:`gemm`'s, with
    ``bias`` float32 [N] and ``pos_mask`` bfloat16 [M, N]; the result is
    float32 or, with ``out_dtype=torch.bfloat16``, rounded to bfloat16.
    ``splits`` > 1 (a weight gradient) takes no mask and a float32 result.
    With ``ordered_ties`` an unsplit result near a bfloat16 rounding
    midpoint is the k-ordered float32 FMA chain's (see ``csrc/gemm.cuh``).
    The plain version on a CPU tensor."""
    if not a.is_cuda:
        return gemm_bf16_plain(a, b, bias, pos_mask, relu, out_dtype)
    lib = _lib()
    (M, K), N = a.shape, b.shape[1]
    _build.check_tensors(a.device, [(a, "a", (M, K), _BF16, False),
                                    (b, "b", (K, N), _BF16, False)] + [
        (t, name, shape, dtype, True) for t, name, shape, dtype in
        ((bias, "bias", (N,), _F32), (pos_mask, "pos_mask", (M, N), _BF16))
        if t is not None])
    if 1 not in a.stride() or 1 not in b.stride():
        raise ValueError("gemm_bf16 needs a unit stride in each operand")
    if out_dtype not in _build.ROW_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    if splits > 1 and (pos_mask is not None or out_dtype == _BF16):
        raise ValueError("a split gemm_bf16 takes no pos_mask and writes "
                         "float32")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    part = torch.empty(lib.pgt_gemm_workspace(M, N, K, splits), dtype=_F32,
                       device=a.device)
    ptr = lambda t: None if t is None or not t.numel() else t.data_ptr()
    err = lib.pgt_gemm_bf16(a.data_ptr(), a.stride(0), a.stride(1),
                            b.data_ptr(), b.stride(0), b.stride(1),
                            out.data_ptr(), int(out_dtype == _BF16), M, N, K,
                            splits, ptr(part), ptr(bias), ptr(pos_mask),
                            int(relu), int(ordered_ties), _build.stream(a))
    if err:
        raise RuntimeError(f"gemm_bf16 launch failed (CUDA error {err})")
    launches["gemm_bf16"] += 1
    return out


def wgrad_splits(M: int, N: int, K: int) -> int:
    """The splits of K that K1's backward gives a weight gradient [M, N]
    contracted over K rows (``gemm``'s ``splits``)."""
    return _lib().pgt_gemm_wgrad_splits(M, N, K)


class _FusedGinConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ein, We, e_self, W1, b1, W2, b2, senders, receivers,
                w, nmask, block_nodes, block_edges, compute_dtype):
        nm = nmask.to(torch.float32)
        out, aggr, z = gin_conv_fwd(x, ein, We, e_self, W1, b1, W2, b2,
                                    senders, receivers, w, nm, block_nodes,
                                    block_edges, compute_dtype)
        ctx.save_for_backward(ein, W1, W2, senders, receivers, w, nm, aggr, z)
        ctx.blocks = (block_nodes, block_edges)
        ctx.compute_dtype = compute_dtype
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ein, W1, W2, senders, receivers, w, nm, aggr, z = ctx.saved_tensors
        dx, dWe, des, dW1, db1, dW2, db2 = gin_conv_bwd(
            g.contiguous(), aggr, z, ein, W1, W2, senders, receivers, w, nm,
            *ctx.blocks, ctx.compute_dtype,
        )

        def zero(i, t):
            return torch.zeros_like(t) if ctx.needs_input_grad[i] else None

        return (dx, zero(1, ein), dWe, des, dW1, db1, dW2, db2, None, None,
                zero(10, w), None, None, None, None)


class _GinConvPlainBf16(torch.autograd.Function):
    """K1's plain version at compute dtype bfloat16: the Pallas kernel's
    forward and backward bodies in torch, rounding where they round
    (``_fwd_kernel``, ``_bwd_kernel`` of ``pallas_gin.py``). Sums of rows
    go through ``segment.scatter_add_rows``."""

    @staticmethod
    def forward(ctx, x, ein, We, e_self, W1, b1, W2, b2, senders, receivers,
                w, nmask):
        r = _build.round_bf16
        snd, rcv = senders.long(), receivers.long()
        wf, nm = w.float(), nmask.float()
        N, F = x.shape
        ein_w = r(ein.float() * wf[:, None])
        msg = r(wf)[:, None] * r(x.float())[snd] + ein_w @ r(We)
        aggr = seg.scatter_add_rows(x.new_zeros((N, F), dtype=_F32), rcv,
                                    r(msg))
        aggr_c = r(aggr + (x.float() + e_self) * nm[:, None])
        z_c = r(torch.relu(aggr_c @ r(W1) + b1))
        out = z_c @ r(W2) + b2
        ctx.save_for_backward(ein_w, W1, W2, senders, receivers, w, nm,
                              aggr_c, z_c)
        ctx.x_dtype = x.dtype
        return out.to(x.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        r = _build.round_bf16
        ein_w, W1, W2, senders, receivers, w, nm, aggr_c, z_c = \
            ctx.saved_tensors
        snd, rcv = senders.long(), receivers.long()
        g_all = r(g.float())
        dz = g_all @ r(W2).t()
        dW2 = z_c.t() @ g_all
        db2 = g_all.sum(0)
        dzr = torch.where(z_c > 0, dz, 0.0)
        dW1 = aggr_c.t() @ r(dzr)
        db1 = dzr.sum(0)
        da = r(dzr) @ r(W1).t()
        da_nm = da * nm[:, None]
        dmsg = r(da)[rcv]
        dx = seg.scatter_add_rows(torch.zeros_like(da), snd,
                                  r(w.float())[:, None] * dmsg) + da_nm
        need = ctx.needs_input_grad
        return (dx.to(ctx.x_dtype),
                torch.zeros_like(ein_w) if need[1] else None,
                ein_w.t() @ dmsg, da_nm.sum(0), dW1, db1, dW2, db2, None,
                None, torch.zeros_like(w) if need[10] else None, None)


def fused_gin_conv_plain(x, ein, We, e_self, W1, b1, W2, b2, senders,
                         receivers, w, nmask, block_nodes: int = 0,
                         block_edges: int = 0,
                         return_residuals: bool = False,
                         compute_dtype: torch.dtype = _F32):
    """The plain PyTorch version of K1 (any layout). At float32 autograd
    gives the backward, ``x`` is widened to float32 and ``out`` returned in
    ``x``'s dtype; with ``return_residuals`` returns ``(out, aggr, z)``. At
    bfloat16 it is :class:`_GinConvPlainBf16` (no residuals)."""
    if _build.check_compute_dtype(compute_dtype):
        if return_residuals:
            raise ValueError("return_residuals is float32 only")
        return _GinConvPlainBf16.apply(x, ein, We, e_self, W1, b1, W2, b2,
                                       senders, receivers, w, nmask)
    xf = seg.at_least_f32(x)
    aggr = spmm.gather_scatter_plain(xf, senders, receivers, w, x.shape[0],
                                     edge_in=ein, edge_kernel=We)
    aggr = aggr + (xf + e_self) * nmask.to(xf.dtype)[:, None]
    z = torch.relu(aggr @ W1 + b1)
    out = (z @ W2 + b2).to(x.dtype)
    return (out, aggr, z) if return_residuals else out


def fused_gin_conv(x, ein, We, e_self, W1, b1, W2, b2, senders, receivers,
                   w, nmask, block_nodes: int, block_edges: int,
                   compute_dtype: torch.dtype = _F32):
    """K1 on CUDA tensors (kernel forward and backward), the plain version
    on CPU tensors. ``w`` is the f32 edge weight with the mask folded in;
    ``nmask`` may be bool or f32; ``compute_dtype`` is float32 or
    bfloat16."""
    if x.is_cuda:
        return _FusedGinConv.apply(x, ein, We, e_self, W1, b1, W2, b2,
                                   senders, receivers, w, nmask, block_nodes,
                                   block_edges, compute_dtype)
    return fused_gin_conv_plain(x, ein, We, e_self, W1, b1, W2, b2, senders,
                                receivers, w, nmask, block_nodes, block_edges,
                                compute_dtype=compute_dtype)
