"""Whole-layer fused GAT conv (K4): one GATConv per call, forward and
backward.

Replaces ``pretrain_gnns_tpu/ops/pallas_gat_conv.py::fused_gat_conv`` (the
Pallas TPU kernels ``_fwd_kernel``/``_bwd_kernel``). On the block-diagonal
batch it computes, for each head ``h`` of ``H``::

    x_h   = h @ Wl_h + bl_h                    (saved for the backward)
    e_h   = ein @ We_h                         (never formed as [E, H, D])
    out_h = the GAT attention of ops/attention.py on x_h, e_h, e_self_h
    out   = mean_h out_h + bias

with ``Wl`` [Din, H*D] and ``We`` [K, H*D] in the JAX (input-major)
layout; ``Wl`` may have any strides, so ``linear.weight.t()`` passes
without a copy. The backward returns ``dh, dWl, dbl, dWe, de_self, da_i,
da_j, dbias`` and zero gradients for ``ein`` and ``w``.

On a CUDA tensor :func:`fused_gat_conv` launches the hand-written kernels
of ``csrc/gat.cu`` (see the note there for what bounds them on the card
and how they are built) or raises; on a CPU tensor it runs the plain
PyTorch version :func:`fused_gat_conv_plain`. ``launches`` counts the
kernel launches of each direction.

:func:`set_fused` is the counterpart of the JAX package's
``pallas_gin.set_fused``: ``"on"`` (the default) routes the trunks'
``GATConv`` here, ``"off"`` to the unfused composition whose attention is
the blocked GAT attention (K5).

Padded node rows get ``mean_h (bl_h + e_self_h) + bias``, not zero,
exactly as the JAX kernel; the trunk masks them afterwards.
"""

from __future__ import annotations

from typing import Dict

import torch

from pretrain_gnns_tpu_torch.ops import _build, attention

launches: Dict[str, int] = {"gat_conv_fwd": 0, "gat_conv_bwd": 0}

_fused = True


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def set_fused(mode: str) -> None:
    """``"on"``: ``GATConv`` runs as one fused GAT conv call (K4);
    ``"off"``: as ``weight_linear``, the edge embedding and the GAT
    attention (K5)."""
    global _fused
    if mode not in ("on", "off"):
        raise ValueError(f"set_fused takes 'on' or 'off', got {mode!r}")
    _fused = mode == "on"


def fused_enabled() -> bool:
    return _fused


_F32 = torch.float32


def _conv_tensors(h, Wl, ein, We, e_self, a_i, a_j, senders, receivers, w):
    (N, Din), (H, D), (E, K) = h.shape, e_self.shape, ein.shape
    dims = (N, E, Din, H, D, K)
    return dims, [
        (h, "h", (N, Din), _F32, True), (Wl, "Wl", (Din, H * D), _F32, False),
        (ein, "ein", (E, K), _F32, True), (We, "We", (K, H * D), _F32, True),
        (e_self, "e_self", (H, D), _F32, True),
        (a_i, "a_i", (H, D), _F32, True), (a_j, "a_j", (H, D), _F32, True),
    ] + attention.graph_tensors(E, senders, receivers, w)


def _check(h, dims, block_nodes: int, block_edges: int, tensors) -> None:
    N, E, _, _, _, K = dims
    attention.check_layout(h, N, E, block_nodes, block_edges)
    if K > attention.lib().pgt_gat_max_k():
        raise ValueError(f"K={K} exceeds {attention.lib().pgt_gat_max_k()}")
    _build.check_tensors(h.device, tensors)


def gat_conv_fwd(h, Wl, bl, ein, We, e_self, a_i, a_j, bias, senders,
                 receivers, w, block_nodes: int, block_edges: int,
                 slope: float = 0.2):
    """Launch K4's forward; returns ``(out [N, D], x [N, H*D], saved)`` with
    ``saved = (alpha [E, H], aself [N, H], dlr [E, H], dls [N, H])``."""
    dims, tensors = _conv_tensors(h, Wl, ein, We, e_self, a_i, a_j, senders,
                                  receivers, w)
    N, E, Din, H, D, K = dims
    _check(h, dims, block_nodes, block_edges, tensors + [
        (bl, "bl", (H * D,), _F32, True), (bias, "bias", (D,), _F32, True)])
    so = attention.lib()
    new = lambda *shape: torch.empty(shape, dtype=_F32, device=h.device)
    out, x = new(N, D), new(N, H * D)
    saved = (new(E, H), new(N, H), new(E, H), new(N, H))
    work = new(so.pgt_gat_conv_fwd_workspace(N, H))
    err = so.pgt_gat_conv_fwd(
        h.data_ptr(), Wl.data_ptr(), Wl.stride(0), Wl.stride(1),
        bl.data_ptr(), ein.data_ptr(), We.data_ptr(), e_self.data_ptr(),
        a_i.data_ptr(), a_j.data_ptr(), bias.data_ptr(), senders.data_ptr(),
        receivers.data_ptr(), w.data_ptr(), out.data_ptr(), x.data_ptr(),
        *(t.data_ptr() for t in saved), work.data_ptr(), N, E, Din, H, D, K,
        block_nodes, block_edges, slope, _build.stream(h))
    if err:
        raise RuntimeError(
            f"gat_conv forward launch failed (CUDA error {err})")
    launches["gat_conv_fwd"] += 1
    return out, x, saved


def gat_conv_bwd(g, h, Wl, x, ein, We, e_self, a_i, a_j, senders, receivers,
                 w, saved, block_nodes: int, block_edges: int,
                 slope: float = 0.2):
    """Launch K4's backward from the cotangent ``g [N, D]``, the saved
    ``x`` and the forward's ``saved``; returns ``(dh, dWl, dbl, dWe,
    de_self, da_i, da_j, dbias)``."""
    dims, tensors = _conv_tensors(h, Wl, ein, We, e_self, a_i, a_j, senders,
                                  receivers, w)
    N, E, Din, H, D, K = dims
    _check(h, dims, block_nodes, block_edges,
           tensors + attention.softmax_tensors(N, E, H, saved) + [
               (g, "g", (N, D), _F32, True),
               (x, "x", (N, H * D), _F32, True)])
    so = attention.lib()
    new = lambda *shape: torch.empty(shape, dtype=_F32, device=h.device)
    dh, dWl, dbl, dWe = new(N, Din), new(Din, H * D), new(H * D), new(K, H * D)
    dpar, dbias = new(3, H, D), new(D)
    work = new(so.pgt_gat_conv_bwd_workspace(N, E, Din, H, D, K, block_nodes))
    err = so.pgt_gat_conv_bwd(
        g.data_ptr(), h.data_ptr(), Wl.data_ptr(), Wl.stride(0),
        Wl.stride(1), x.data_ptr(), ein.data_ptr(), We.data_ptr(),
        e_self.data_ptr(), a_i.data_ptr(), a_j.data_ptr(),
        senders.data_ptr(), receivers.data_ptr(), w.data_ptr(),
        *(t.data_ptr() for t in saved), dh.data_ptr(), dWl.data_ptr(),
        dbl.data_ptr(), dWe.data_ptr(), dpar.data_ptr(), dbias.data_ptr(),
        work.data_ptr(), N, E, Din, H, D, K, block_nodes, block_edges, slope,
        _build.stream(h))
    if err:
        raise RuntimeError(
            f"gat_conv backward launch failed (CUDA error {err})")
    launches["gat_conv_bwd"] += 1
    return dh, dWl, dbl, dWe, dpar[0], dpar[1], dpar[2], dbias


class _FusedGatConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, Wl, bl, ein, We, e_self, a_i, a_j, bias, senders,
                receivers, w, block_nodes, block_edges, slope):
        out, x, saved = gat_conv_fwd(h, Wl, bl, ein, We, e_self, a_i, a_j,
                                     bias, senders, receivers, w, block_nodes,
                                     block_edges, slope)
        ctx.save_for_backward(h, Wl, x, ein, We, e_self, a_i, a_j, senders,
                              receivers, w, *saved)
        ctx.cfg = (block_nodes, block_edges, slope)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *args, alpha, aself, dlr, dls = ctx.saved_tensors
        dh, dWl, dbl, dWe, des, dai, daj, dbias = gat_conv_bwd(
            g.contiguous(), *args, (alpha, aself, dlr, dls), *ctx.cfg)

        def zero(i, t):
            return torch.zeros_like(t) if ctx.needs_input_grad[i] else None

        return (dh, dWl, dbl, zero(3, args[3]), dWe, des, dai, daj, dbias,
                None, None, zero(11, args[10]), None, None, None)


def fused_gat_conv_plain(h, Wl, bl, ein, We, e_self, a_i, a_j, bias, senders,
                         receivers, w, heads: int, block_nodes: int = 0,
                         block_edges: int = 0, slope: float = 0.2,
                         return_residuals: bool = False):
    """The plain PyTorch version of K4 (any layout; autograd gives the
    backward). With ``return_residuals`` returns ``(out, x)``."""
    D = e_self.shape[1]
    x = h @ Wl + bl
    e = (ein @ We).reshape(-1, heads, D)
    out = attention.blocked_gat_attention_plain(
        x.reshape(-1, heads, D), e, e_self, a_i, a_j, senders, receivers, w,
        slope)
    out = out.mean(dim=1) + bias
    return (out, x) if return_residuals else out


def fused_gat_conv(h, Wl, bl, ein, We, e_self, a_i, a_j, bias, senders,
                   receivers, w, heads: int, block_nodes: int,
                   block_edges: int, slope: float = 0.2) -> torch.Tensor:
    """K4 on CUDA tensors (kernel forward and backward), the plain version
    on CPU tensors. ``e_self``, ``a_i`` and ``a_j`` are ``[H, D]`` (slices
    of one ``att`` parameter pass: they are made contiguous here and
    autograd joins their gradients); ``w`` is the f32 edge weight with the
    mask folded in."""
    if e_self.shape[0] != heads:
        raise ValueError(f"e_self is {tuple(e_self.shape)}, heads={heads}")
    if h.is_cuda:
        return _FusedGatConv.apply(
            h.contiguous(), Wl, bl, ein, We.contiguous(),
            e_self.contiguous(), a_i.contiguous(), a_j.contiguous(), bias,
            senders, receivers, w, block_nodes, block_edges, float(slope))
    return fused_gat_conv_plain(h, Wl, bl, ein, We, e_self, a_i, a_j, bias,
                                senders, receivers, w, heads, block_nodes,
                                block_edges, slope)
