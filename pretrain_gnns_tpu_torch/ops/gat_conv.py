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

``compute_dtype`` is the Pallas kernel's. At ``torch.bfloat16`` K4
computes the Pallas bodies' function at that dtype: ``x = bf(h) @ bf(Wl) +
bl`` and ``e = bf(ein) @ bf(We)`` with float32 sums; the logits and the
self term from the float32 ``x``; each message ``p (bf(x)[snd] + e)``
rounded before the receiver sum; the saved residual is ``bf(x)``, bfloat16,
and the backward's softmax is the one the Pallas backward recomputes from
it, which the kernel's forward computes beside its own and saves (with
the rounded ``h`` and ``Wl``); in the backward
``g / H`` is rounded where it is gathered, each ``alpha g_r`` before
the sender sum and ``de`` per edge before ``dWe = bf(ein)^T bf(de)``;
``dWl = bf(h)^T bf(dx)`` and ``dh = bf(dx) @ bf(Wl)^T``; ``dbl``,
``de_self``, ``da_i`` and ``da_j`` are float32 sums of unrounded values.
Its products run on the tensor cores (``csrc/gemm.cuh``'s ``gemm_bf16``).
The plain version at bfloat16 is :class:`_GatConvPlainBf16`, the bodies
written out in torch. ``h`` is read as float32 (the trunks pass it so, as
the JAX trunks do).
"""

from __future__ import annotations

from typing import Dict

import torch

from pretrain_gnns_tpu_torch.ops import _build, attention
from pretrain_gnns_tpu_torch.ops import segment as seg

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
                 slope: float = 0.2, compute_dtype: torch.dtype = _F32):
    """Launch K4's forward at ``compute_dtype``; returns ``(out [N, D], x
    [N, H*D], saved)``: ``x`` in ``compute_dtype`` (at bfloat16 the
    residual ``bf(x)``) and ``saved = (alpha [E, H], aself [N, H], dlr
    [E, H], dls [N, H])``, at bfloat16 the softmax of the residual (as the
    Pallas backward recomputes it) and a fifth entry, the rounded ``h`` and
    ``Wl`` (bfloat16, ``pgt_gat_conv_r16_elems`` values)."""
    dims, tensors = _conv_tensors(h, Wl, ein, We, e_self, a_i, a_j, senders,
                                  receivers, w)
    N, E, Din, H, D, K = dims
    _check(h, dims, block_nodes, block_edges, tensors + [
        (bl, "bl", (H * D,), _F32, True), (bias, "bias", (D,), _F32, True)])
    bf = _build.check_compute_dtype(compute_dtype)
    so = attention.lib()
    new = lambda *shape: torch.empty(shape, dtype=_F32, device=h.device)
    out = new(N, D)
    x = torch.empty((N, H * D), dtype=compute_dtype, device=h.device)
    saved = (new(E, H), new(N, H), new(E, H), new(N, H))
    if bf:
        saved += (torch.empty(so.pgt_gat_conv_r16_elems(N, Din, H, D, 1),
                              dtype=torch.bfloat16, device=h.device),)
    ptrs = [t.data_ptr() for t in saved] + [None] * (5 - len(saved))
    work = new(so.pgt_gat_conv_fwd_workspace(N, Din, H, D, int(bf)))
    err = so.pgt_gat_conv_fwd(
        h.data_ptr(), Wl.data_ptr(), Wl.stride(0), Wl.stride(1),
        bl.data_ptr(), ein.data_ptr(), We.data_ptr(), e_self.data_ptr(),
        a_i.data_ptr(), a_j.data_ptr(), bias.data_ptr(), senders.data_ptr(),
        receivers.data_ptr(), w.data_ptr(), out.data_ptr(), x.data_ptr(),
        *ptrs, work.data_ptr(), N, E, Din, H, D, K, block_nodes, block_edges,
        slope, int(bf), _build.stream(h))
    if err:
        raise RuntimeError(
            f"gat_conv forward launch failed (CUDA error {err})")
    launches["gat_conv_fwd"] += 1
    return out, x, saved


def gat_conv_bwd(g, h, Wl, x, ein, We, e_self, a_i, a_j, senders, receivers,
                 w, saved, block_nodes: int, block_edges: int,
                 slope: float = 0.2, compute_dtype: torch.dtype = _F32):
    """Launch K4's backward at ``compute_dtype`` from the cotangent ``g [N,
    D]``, the saved ``x`` and the forward's ``saved``; returns ``(dh, dWl,
    dbl, dWe, de_self, da_i, da_j, dbias)``."""
    dims, tensors = _conv_tensors(h, Wl, ein, We, e_self, a_i, a_j, senders,
                                  receivers, w)
    N, E, Din, H, D, K = dims
    bf = _build.check_compute_dtype(compute_dtype)
    so = attention.lib()
    if len(saved) != 4 + bf:
        raise ValueError(f"saved holds {len(saved)} tensors, expected "
                         f"{4 + bf}")
    r16 = [(saved[4], "r16",
            (so.pgt_gat_conv_r16_elems(N, Din, H, D, 1),), torch.bfloat16,
            True)] if bf else []
    _check(h, dims, block_nodes, block_edges,
           tensors + attention.softmax_tensors(N, E, H, saved[:4]) + r16 + [
               (g, "g", (N, D), _F32, True),
               (x, "x", (N, H * D), compute_dtype, True)])
    new = lambda *shape: torch.empty(shape, dtype=_F32, device=h.device)
    dh, dWl, dbl, dWe = new(N, Din), new(Din, H * D), new(H * D), new(K, H * D)
    dpar, dbias = new(3, H, D), new(D)
    work = new(so.pgt_gat_conv_bwd_workspace(N, E, Din, H, D, K, block_nodes,
                                             int(bf)))
    ptrs = [t.data_ptr() for t in saved] + [None] * (5 - len(saved))
    err = so.pgt_gat_conv_bwd(
        g.data_ptr(), h.data_ptr(), Wl.data_ptr(), Wl.stride(0),
        Wl.stride(1), x.data_ptr(), ein.data_ptr(), We.data_ptr(),
        e_self.data_ptr(), a_i.data_ptr(), a_j.data_ptr(),
        senders.data_ptr(), receivers.data_ptr(), w.data_ptr(),
        *ptrs, dh.data_ptr(), dWl.data_ptr(),
        dbl.data_ptr(), dWe.data_ptr(), dpar.data_ptr(), dbias.data_ptr(),
        work.data_ptr(), N, E, Din, H, D, K, block_nodes, block_edges, slope,
        int(bf), _build.stream(h))
    if err:
        raise RuntimeError(
            f"gat_conv backward launch failed (CUDA error {err})")
    launches["gat_conv_bwd"] += 1
    return dh, dWl, dbl, dWe, dpar[0], dpar[1], dpar[2], dbias


class _FusedGatConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, Wl, bl, ein, We, e_self, a_i, a_j, bias, senders,
                receivers, w, block_nodes, block_edges, slope, compute_dtype):
        ctx.h_dtype = h.dtype
        h = seg.at_least_f32(h)
        out, x, saved = gat_conv_fwd(h, Wl, bl, ein, We, e_self, a_i, a_j,
                                     bias, senders, receivers, w, block_nodes,
                                     block_edges, slope, compute_dtype)
        ctx.save_for_backward(h, Wl, x, ein, We, e_self, a_i, a_j, senders,
                              receivers, w, *saved)
        ctx.cfg = (block_nodes, block_edges, slope, compute_dtype)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        args, saved = ctx.saved_tensors[:11], ctx.saved_tensors[11:]
        dh, dWl, dbl, dWe, des, dai, daj, dbias = gat_conv_bwd(
            g.contiguous(), *args, saved, *ctx.cfg)

        def zero(i, t):
            return torch.zeros_like(t) if ctx.needs_input_grad[i] else None

        return (dh.to(ctx.h_dtype), dWl, dbl, zero(3, args[3]), dWe, des,
                dai, daj, dbias, None, None, zero(11, args[10]), None, None,
                None, None)


def _k4_pieces(x, e, e_self, a_i, a_j, senders, receivers, w, slope):
    """``_softmax_pieces`` of ``pallas_gat_conv.py`` on ``[N, H, D]`` x and
    ``[E, H, D]`` e: ``(x_self, raw, sraw, p, p_self, den)``."""
    x_self = x + e_self
    ps = (x * a_i).sum(-1)
    sraw = ps + (x_self * a_j).sum(-1)
    raw, p, p_self, den = attention.softmax_pieces_bf16(
        ps, (x * a_j).sum(-1), (e * a_j).sum(-1), sraw, senders, receivers, w,
        slope)
    return x_self, raw, sraw, p, p_self, den


class _GatConvPlainBf16(torch.autograd.Function):
    """K4's plain version at compute dtype bfloat16: the Pallas bodies
    (``_fwd_kernel``, ``_bwd_kernel`` of ``pallas_gat_conv.py``) in torch,
    rounding where they round. Returns ``(out, x)``, ``x`` the bfloat16
    residual; ``ein`` and ``w`` get zero gradients, as the JAX VJP's."""

    @staticmethod
    def forward(ctx, h, Wl, bl, ein, We, e_self, a_i, a_j, bias, senders,
                receivers, w, heads, slope):
        r = _build.round_bf16
        (N, _), (H, D) = h.shape, e_self.shape
        x = r(h.float()) @ r(Wl) + bl
        e = (r(ein.float()) @ r(We)).reshape(-1, H, D)
        x3 = x.reshape(N, H, D)
        x_self, _, _, p, p_self, den = _k4_pieces(
            x3, e, e_self, a_i, a_j, senders, receivers, w, slope)
        msg = r(x3)[senders.long()] + e
        numer = seg.scatter_add_rows(torch.zeros_like(x3), receivers.long(),
                                     r(p[..., None] * msg))
        o = (numer + p_self[..., None] * x_self) / den[..., None]
        x_res = x.to(torch.bfloat16)
        ctx.save_for_backward(h, Wl, ein, We, e_self, a_i, a_j, x_res,
                              senders, receivers, w)
        ctx.cfg = (heads, slope)
        ctx.mark_non_differentiable(x_res)
        return o.sum(1) / H + bias, x_res

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _):
        (h, Wl, ein, We, e_self, a_i, a_j, x_res, senders, receivers,
         w) = ctx.saved_tensors
        grads = gat_conv_bwd_plain(g, h, Wl, x_res, ein, We, e_self, a_i,
                                   a_j, senders, receivers, w, *ctx.cfg)
        need = ctx.needs_input_grad
        return (grads[:3] + (torch.zeros_like(ein) if need[3] else None,)
                + grads[3:] + (None, None,
                               torch.zeros_like(w) if need[11] else None,
                               None, None))


def gat_conv_bwd_plain(g, h, Wl, x, ein, We, e_self, a_i, a_j, senders,
                       receivers, w, heads: int, slope: float = 0.2):
    """The plain version of :func:`gat_conv_bwd` at compute dtype
    bfloat16: the Pallas ``_bwd_kernel`` in torch, from the cotangent ``g``
    and the bfloat16 residual ``x``, rounding where it rounds; returns
    ``(dh, dWl, dbl, dWe, de_self, da_i, da_j, dbias)``."""
    H = heads
    r = _build.round_bf16
    snd, rcv = senders.long(), receivers.long()
    N, D = g.shape
    g = g.float()
    gH = (g / H)[:, None, :]
    x = x.float().reshape(N, H, D)
    eb = r(ein.float())
    e = (eb @ r(We)).reshape(-1, H, D)
    x_self, raw, sraw, p, p_self, den = _k4_pieces(
        x, e, e_self, a_i, a_j, senders, receivers, w, slope)
    alpha = p / torch.clamp(den[rcv], min=1e-30)
    aself = p_self / den
    g_r = r(gH)[rcv]
    d_alpha = (g_r * (x[snd] + e)).sum(-1)
    d_aself = (gH * x_self).sum(-1)
    zeros = torch.zeros_like(aself)
    c = seg.scatter_add_rows(zeros, rcv, alpha * d_alpha) + aself * d_aself
    dz = alpha * (d_alpha - c[rcv]) * attention.leaky_slope(raw, slope)
    dzs = aself * (d_aself - c) * attention.leaky_slope(sraw, slope)
    dmsg = alpha[..., None] * g_r
    dz_r = seg.scatter_add_rows(zeros, rcv, dz)
    dz_s = seg.scatter_add_rows(zeros, snd, dz)
    dx = (seg.scatter_add_rows(torch.zeros_like(x), snd, r(dmsg))
          + aself[..., None] * gH + (dz_r + dzs)[..., None] * a_i
          + (dz_s + dzs)[..., None] * a_j)
    de = dmsg + dz[..., None] * a_j
    dx2, dxb = dx.reshape(N, H * D), r(dx.reshape(N, H * D))
    dWl = r(h.float()).t() @ dxb
    dWe = eb.t() @ r(de.reshape(-1, H * D))
    dh = dxb @ r(Wl).t()
    des = (aself[..., None] * gH + dzs[..., None] * a_j).sum(0)
    dai = (x * (dz_r + dzs)[..., None]).sum(0)
    daj = ((x * (dz_s + dzs)[..., None] + dzs[..., None] * e_self).sum(0)
           + (e * dz[..., None]).sum(0))
    return (dh.to(h.dtype), dWl, dx2.sum(0), dWe, des, dai, daj, g.sum(0))


def fused_gat_conv_plain(h, Wl, bl, ein, We, e_self, a_i, a_j, bias, senders,
                         receivers, w, heads: int, block_nodes: int = 0,
                         block_edges: int = 0, slope: float = 0.2,
                         return_residuals: bool = False,
                         compute_dtype: torch.dtype = _F32):
    """The plain PyTorch version of K4 (any layout). At float32 autograd
    gives the backward; at bfloat16 it is :class:`_GatConvPlainBf16`. With
    ``return_residuals`` returns ``(out, x)``, ``x`` the saved projection
    (bfloat16 at bfloat16)."""
    if _build.check_compute_dtype(compute_dtype):
        out, x = _GatConvPlainBf16.apply(
            h, Wl, bl, ein, We, e_self, a_i, a_j, bias, senders, receivers,
            w.detach(), heads, float(slope))
        return (out, x) if return_residuals else out
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
                   block_edges: int, slope: float = 0.2,
                   compute_dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """K4 on CUDA tensors (kernel forward and backward), the plain version
    on CPU tensors. ``e_self``, ``a_i`` and ``a_j`` are ``[H, D]`` (slices
    of one ``att`` parameter pass: they are made contiguous here and
    autograd joins their gradients); ``w`` is the f32 edge weight with the
    mask folded in; ``compute_dtype`` is float32 or bfloat16."""
    if e_self.shape[0] != heads:
        raise ValueError(f"e_self is {tuple(e_self.shape)}, heads={heads}")
    if h.is_cuda:
        return _FusedGatConv.apply(
            h.contiguous(), Wl, bl, ein, We.contiguous(),
            e_self.contiguous(), a_i.contiguous(), a_j.contiguous(), bias,
            senders, receivers, w, block_nodes, block_edges, float(slope),
            compute_dtype)
    return fused_gat_conv_plain(h, Wl, bl, ein, We, e_self, a_i, a_j, bias,
                                senders, receivers, w, heads, block_nodes,
                                block_edges, slope,
                                compute_dtype=compute_dtype)
