"""GAT attention: the plain path for any layout, the blocked GAT attention
kernel (K5) and the dispatch between them (port of
``pretrain_gnns_tpu.ops.attention`` and of
``pretrain_gnns_tpu/ops/pallas_attention.py::blocked_gat_forward`` /
``blocked_gat_backward``, the Pallas TPU kernels ``_fwd_kernel`` /
``_bwd_kernel`` there).

Per head, with the self loop as one more logit per node::

    out[n] = sum_{e -> n} alpha[e] (x[snd[e]] + e[e])
           + alpha_self[n] (x[n] + e_self)

where ``alpha`` is the masked segment softmax over the receivers of the
LeakyReLU logits ``x[rcv]·a_i + (x[snd] + e)·a_j`` (self loop:
``x·a_i + (x + e_self)·a_j``). ``x`` is ``[N, H, D]``, ``e`` ``[E, H, D]``,
the result ``[N, H, D]`` (before the head mean).

On a CUDA tensor :func:`blocked_gat_attention` launches the hand-written
kernels of ``csrc/gat.cu`` (see the note there for what bounds them on the
card and how they are built) or raises; on a CPU tensor it runs the plain
PyTorch version :func:`blocked_gat_attention_plain`. ``launches`` counts
the kernel launches by direction. The forward saves ``alpha``,
``alpha_self`` and the two LeakyReLU slopes (``[E, H]`` and ``[N, H]``
scalars) for the backward, which returns ``dx, de, de_self, da_i, da_j``
and a zero gradient for ``w``.

LeakyReLU's slope at exactly 0 is 1 (``raw >= 0``), in the kernels and in
the plain versions alike, as in the TPU kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from pretrain_gnns_tpu_torch.ops import _build
from pretrain_gnns_tpu_torch.ops import segment as seg

launches: Dict[str, int] = {"blocked_gat_attention_fwd": 0,
                            "blocked_gat_attention_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_F32, _I32 = torch.float32, torch.int32


@functools.cache
def lib() -> ctypes.CDLL:
    """The library of ``csrc/gat.cu`` (K4 and K5), built at first use."""
    so = _build.load("gat")
    so.pgt_gat_attn_fwd.argtypes = [_P] * 14 + [_I] * 6 + [_F, _P]
    so.pgt_gat_attn_bwd.argtypes = [_P] * 17 + [_I] * 6 + [_F, _P]
    so.pgt_gat_conv_fwd.argtypes = ([_P, _P, _L, _L] + [_P] * 17 + [_I] * 8
                                    + [_F, _P])
    so.pgt_gat_conv_bwd.argtypes = ([_P, _P, _P, _L, _L] + [_P] * 20
                                    + [_I] * 8 + [_F, _P])
    for fn in (so.pgt_gat_attn_fwd, so.pgt_gat_attn_bwd, so.pgt_gat_conv_fwd,
               so.pgt_gat_conv_bwd, so.pgt_gat_max_k, so.pgt_gat_max_smem,
               so.pgt_gat_smem):
        fn.restype = _I
    so.pgt_gat_smem.argtypes = [_I, _I]
    so.pgt_gat_attn_fwd_workspace.argtypes = [_I] * 3
    so.pgt_gat_attn_bwd_workspace.argtypes = [_I] * 5
    so.pgt_gat_conv_fwd_workspace.argtypes = [_I] * 2
    so.pgt_gat_conv_bwd_workspace.argtypes = [_I] * 7
    for fn in (so.pgt_gat_attn_fwd_workspace, so.pgt_gat_attn_bwd_workspace,
               so.pgt_gat_conv_fwd_workspace, so.pgt_gat_conv_bwd_workspace):
        fn.restype = _L
    return so


def check_layout(t: torch.Tensor, N: int, E: int, block_nodes: int,
                 block_edges: int) -> None:
    """Raise on a device or layout the ``gat`` kernels do not take."""
    if t.device.type != "cuda":
        raise ValueError("the gat kernels take CUDA tensors")
    if block_nodes <= 0 or block_edges <= 0:
        raise ValueError("the gat kernels need the block-diagonal layout "
                         "(block_nodes, block_edges > 0)")
    if N % block_nodes or E != (N // block_nodes) * block_edges:
        raise ValueError(f"N={N}, E={E} do not form blocks of "
                         f"({block_nodes}, {block_edges})")
    so = lib()
    smem = so.pgt_gat_smem(block_nodes, block_edges)
    if smem > so.pgt_gat_max_smem():
        raise ValueError(f"blocks of ({block_nodes}, {block_edges}) need "
                         f"{smem} bytes of shared memory, more than "
                         f"{so.pgt_gat_max_smem()}")


def graph_tensors(E: int, senders, receivers, w):
    return [(senders, "senders", (E,), _I32, True),
            (receivers, "receivers", (E,), _I32, True),
            (w, "w", (E,), _F32, True)]


def softmax_tensors(N: int, E: int, H: int, saved):
    """The forward's residuals ``(alpha, aself, dlr, dls)``."""
    shapes = ((E, H), (N, H), (E, H), (N, H))
    return [(t, name, s, _F32, True) for t, name, s in
            zip(saved, ("alpha", "aself", "dlr", "dls"), shapes)]


def _attn_tensors(x, e, e_self, a_i, a_j, senders, receivers, w):
    (N, H, D), E = x.shape, senders.shape[0]
    return N, H, D, E, [
        (x, "x", (N, H, D), _F32, True), (e, "e", (E, H, D), _F32, True),
        (e_self, "e_self", (H, D), _F32, True),
        (a_i, "a_i", (H, D), _F32, True), (a_j, "a_j", (H, D), _F32, True),
    ] + graph_tensors(E, senders, receivers, w)


def gat_attn_fwd(x, e, e_self, a_i, a_j, senders, receivers, w, slope: float,
                 block_nodes: int, block_edges: int):
    """Launch K5's forward; returns ``(out [N, H, D], saved)`` with
    ``saved = (alpha [E, H], aself [N, H], dlr [E, H], dls [N, H])``."""
    if x.dim() != 3:
        raise ValueError(f"x must be [N, H, D], got {tuple(x.shape)}")
    N, H, D, E, tensors = _attn_tensors(x, e, e_self, a_i, a_j, senders,
                                        receivers, w)
    check_layout(x, N, E, block_nodes, block_edges)
    _build.check_tensors(x.device, tensors)
    so = lib()
    new = lambda *shape: torch.empty(shape, dtype=_F32, device=x.device)
    out = new(N, H, D)
    saved = (new(E, H), new(N, H), new(E, H), new(N, H))
    work = new(so.pgt_gat_attn_fwd_workspace(N, E, H))
    err = so.pgt_gat_attn_fwd(
        x.data_ptr(), e.data_ptr(), e_self.data_ptr(), a_i.data_ptr(),
        a_j.data_ptr(), senders.data_ptr(), receivers.data_ptr(),
        w.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in saved),
        work.data_ptr(), N, E, H, D, block_nodes, block_edges, slope,
        _build.stream(x))
    if err:
        raise RuntimeError(
            f"blocked_gat_attention forward launch failed (CUDA error {err})")
    launches["blocked_gat_attention_fwd"] += 1
    return out, saved


def gat_attn_bwd(g, x, e, e_self, a_i, a_j, senders, receivers, w, saved,
                 slope: float, block_nodes: int, block_edges: int):
    """Launch K5's backward from the cotangent ``g [N, H, D]`` and the
    forward's ``saved``; returns ``(dx, de, de_self, da_i, da_j)``."""
    N, H, D, E, tensors = _attn_tensors(x, e, e_self, a_i, a_j, senders,
                                        receivers, w)
    check_layout(x, N, E, block_nodes, block_edges)
    _build.check_tensors(x.device, tensors + softmax_tensors(N, E, H, saved)
                         + [(g, "g", (N, H, D), _F32, True)])
    so = lib()
    new = lambda *shape: torch.empty(shape, dtype=_F32, device=x.device)
    dx, de, dpar = new(N, H, D), new(E, H, D), new(3, H, D)
    work = new(so.pgt_gat_attn_bwd_workspace(N, E, H, D, block_nodes))
    err = so.pgt_gat_attn_bwd(
        g.data_ptr(), x.data_ptr(), e.data_ptr(), e_self.data_ptr(),
        a_i.data_ptr(), a_j.data_ptr(), senders.data_ptr(),
        receivers.data_ptr(), w.data_ptr(),
        *(t.data_ptr() for t in saved), dx.data_ptr(), de.data_ptr(),
        dpar.data_ptr(), work.data_ptr(), N, E, H, D, block_nodes,
        block_edges, slope, _build.stream(x))
    if err:
        raise RuntimeError(
            f"blocked_gat_attention backward launch failed (CUDA error {err})")
    launches["blocked_gat_attention_bwd"] += 1
    return dx, de, dpar[0], dpar[1], dpar[2]


class _BlockedGatAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, e, e_self, a_i, a_j, senders, receivers, w, slope,
                block_nodes, block_edges):
        out, saved = gat_attn_fwd(x, e, e_self, a_i, a_j, senders, receivers,
                                  w, slope, block_nodes, block_edges)
        ctx.save_for_backward(x, e, e_self, a_i, a_j, senders, receivers, w,
                              *saved)
        ctx.cfg = (slope, block_nodes, block_edges)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *args, alpha, aself, dlr, dls = ctx.saved_tensors
        grads = gat_attn_bwd(g.contiguous(), *args, (alpha, aself, dlr, dls),
                             *ctx.cfg)
        dw = torch.zeros_like(args[7]) if ctx.needs_input_grad[7] else None
        return (*grads, None, None, dw, None, None, None)


def leaky_relu(t: torch.Tensor, slope: float) -> torch.Tensor:
    """LeakyReLU whose slope at exactly 0 is 1, forward and backward
    (``F.leaky_relu``'s backward takes the negative slope there)."""
    return torch.where(t >= 0, t, slope * t)


def _attention_plain(x, e, e_self, a_i, a_j, senders, receivers, edge_mask,
                     slope: float, log_w=None) -> torch.Tensor:
    """The one plain implementation behind both plain versions: gathers,
    the masked segment softmax of ``ops/segment.py`` with the self loop as
    the extra logit, and a segment sum. ``log_w`` ``[E]`` is added to the
    edge logits before the softmax, which multiplies an edge's unnormalised
    probability by its weight."""
    N = x.shape[0]
    snd, rcv = senders.long(), receivers.long()
    x_j = x.index_select(0, snd) + e
    logits = leaky_relu((x.index_select(0, rcv) * a_i + x_j * a_j).sum(-1),
                        slope)  # [E, H]
    if log_w is not None:
        logits = logits + log_w[:, None]
    x_self = x + e_self
    self_logits = leaky_relu((x * a_i + x_self * a_j).sum(-1), slope)
    p, p_self = seg.segment_softmax(logits, receivers, N, mask=edge_mask,
                                    extra_logit=self_logits)
    out = seg.segment_sum(p[..., None] * x_j, receivers, N, mask=edge_mask)
    return out + p_self[..., None] * x_self


def blocked_gat_attention_plain(x, e, e_self, a_i, a_j, senders, receivers,
                                w, slope: float = 0.2, block_nodes: int = 0,
                                block_edges: int = 0) -> torch.Tensor:
    """The plain PyTorch version of K5 (any layout; autograd gives the
    backward). ``a_i``, ``a_j`` and ``e_self`` are ``[H, D]``; ``w`` is the
    f32 edge weight with the mask folded in: a slot with ``w <= 0`` is out
    of the softmax, and any other weight multiplies the slot's unnormalised
    probability, as in the kernels. With weights of 0 and 1 this is
    :func:`gat_attention_plain` bit for bit (``log 1 = 0``); fractional
    weights are the one case the two differ in. No gradient reaches ``w``
    (the kernels return zero for it)."""
    w = w.detach()
    return _attention_plain(x, e, e_self, a_i, a_j, senders, receivers,
                            w > 0, slope,
                            log_w=torch.log(torch.clamp(w, min=1e-30)))


def blocked_gat_attention(x, e, e_self, a_i, a_j, senders, receivers, w,
                          slope: float, block_nodes: int, block_edges: int
                          ) -> torch.Tensor:
    """K5 on CUDA tensors (kernel forward and backward), the plain version
    on CPU tensors. Returns ``[N, H, D]``."""
    if x.is_cuda:
        return _BlockedGatAttention.apply(
            x.contiguous(), e.contiguous(), e_self.contiguous(),
            a_i.contiguous(), a_j.contiguous(), senders, receivers, w,
            float(slope), block_nodes, block_edges)
    return blocked_gat_attention_plain(x, e, e_self, a_i, a_j, senders,
                                       receivers, w, slope)


def gat_attention_plain(x, e, e_self, a_i, a_j, senders, receivers,
                        edge_mask, num_nodes: int, slope: float
                        ) -> torch.Tensor:
    """The reference path for any layout and device (port of
    ``gat_attention_xla``): gathers, the masked segment softmax of
    ``ops/segment.py`` and a segment sum. ``a_i``, ``a_j`` are
    ``[1, H, D]``, ``edge_mask`` is bool, ``num_nodes`` is ``x.shape[0]``.
    Returns ``[N, H, D]``."""
    if num_nodes != x.shape[0]:
        raise ValueError(f"num_nodes={num_nodes}, x has {x.shape[0]} rows")
    return _attention_plain(x, e, e_self, a_i, a_j, senders, receivers,
                            edge_mask, slope)


def gat_attention(x, e, e_self, a_i, a_j, senders, receivers, edge_mask,
                  num_nodes: int, slope: float = 0.2, block_nodes: int = 0,
                  block_edges: int = 0) -> torch.Tensor:
    """GAT attention ``[N, H, D]`` with the argument order of the JAX
    ``gat_attention`` (``a_i``, ``a_j`` are ``[1, H, D]``). Dispatch: a CPU
    tensor takes :func:`gat_attention_plain`, whatever the layout; a CUDA
    tensor on a block-diagonal batch goes to the blocked GAT attention
    kernel (K5); a CUDA tensor on any other batch raises ``ValueError``,
    as ``gather_scatter`` and ``edge_dot`` do."""
    if not x.is_cuda:
        return gat_attention_plain(x, e, e_self, a_i, a_j, senders,
                                   receivers, edge_mask, num_nodes, slope)
    if not (block_nodes > 0 and block_edges > 0):
        raise ValueError(
            "gat_attention on CUDA needs a block-diagonal batch "
            "(packing='blocked' or 'auto')"
        )
    H, D = x.shape[1:]
    return blocked_gat_attention(
        x, e, e_self, a_i.reshape(H, D), a_j.reshape(H, D), senders,
        receivers, edge_mask.to(torch.float32), slope, block_nodes,
        block_edges)
