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

``compute_dtype`` is the Pallas kernel's. At ``torch.bfloat16`` K5
computes the Pallas bodies' function at that dtype: the logit scalars from
the unrounded ``x`` and ``e``, the feature tiles ``x``, ``e``, the self
message ``x + e_self`` and ``g`` rounded to bfloat16, each message
``p (x[snd] + e)`` rounded before the receiver sum and each ``alpha g[rcv]``
before the sender sum, every sum in float32; ``de_self``, ``da_i`` and
``da_j`` take the unrounded ``g``, ``x`` and ``e``. Its plain version is
:class:`_AttentionPlainBf16`, the bodies written out in torch. ``x`` and
``e`` may be float32 or bfloat16 (the kernels read them widened, which is
exact; the gradients come back in their dtypes).
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
    """The library of ``csrc/gat.cu`` and ``csrc/gat_bf16.cu`` (K4 and K5),
    built at first use."""
    so = _build.load("gat")
    so.pgt_gat_attn_fwd.argtypes = [_P] * 14 + [_I] * 6 + [_F, _I, _P]
    so.pgt_gat_attn_bwd.argtypes = [_P] * 17 + [_I] * 6 + [_F, _I, _P]
    so.pgt_gat_conv_fwd.argtypes = ([_P, _P, _L, _L] + [_P] * 18 + [_I] * 8
                                    + [_F, _I, _P])
    so.pgt_gat_conv_bwd.argtypes = ([_P, _P, _P, _L, _L] + [_P] * 21
                                    + [_I] * 8 + [_F, _I, _P])
    for fn in (so.pgt_gat_attn_fwd, so.pgt_gat_attn_bwd, so.pgt_gat_conv_fwd,
               so.pgt_gat_conv_bwd, so.pgt_gat_max_k, so.pgt_gat_max_smem,
               so.pgt_gat_smem):
        fn.restype = _I
    so.pgt_gat_smem.argtypes = [_I, _I]
    so.pgt_gat_attn_fwd_workspace.argtypes = [_I] * 3
    so.pgt_gat_attn_bwd_workspace.argtypes = [_I] * 5
    so.pgt_gat_conv_fwd_workspace.argtypes = [_I] * 5
    so.pgt_gat_conv_bwd_workspace.argtypes = [_I] * 8
    so.pgt_gat_conv_r16_elems.argtypes = [_I] * 5
    for fn in (so.pgt_gat_attn_fwd_workspace, so.pgt_gat_attn_bwd_workspace,
               so.pgt_gat_conv_fwd_workspace, so.pgt_gat_conv_bwd_workspace,
               so.pgt_gat_conv_r16_elems):
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
                 block_nodes: int, block_edges: int,
                 compute_dtype: torch.dtype = _F32):
    """Launch K5's forward at ``compute_dtype`` (float32 rows); returns
    ``(out [N, H, D], saved)`` with ``saved = (alpha [E, H], aself [N, H],
    dlr [E, H], dls [N, H])``."""
    if x.dim() != 3:
        raise ValueError(f"x must be [N, H, D], got {tuple(x.shape)}")
    N, H, D, E, tensors = _attn_tensors(x, e, e_self, a_i, a_j, senders,
                                        receivers, w)
    check_layout(x, N, E, block_nodes, block_edges)
    _build.check_tensors(x.device, tensors)
    bf = _build.check_compute_dtype(compute_dtype)
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
        int(bf), _build.stream(x))
    if err:
        raise RuntimeError(
            f"blocked_gat_attention forward launch failed (CUDA error {err})")
    launches["blocked_gat_attention_fwd"] += 1
    return out, saved


def gat_attn_bwd(g, x, e, e_self, a_i, a_j, senders, receivers, w, saved,
                 slope: float, block_nodes: int, block_edges: int,
                 compute_dtype: torch.dtype = _F32):
    """Launch K5's backward at ``compute_dtype`` from the cotangent ``g [N,
    H, D]`` and the forward's ``saved``; returns ``(dx, de, de_self, da_i,
    da_j)``."""
    N, H, D, E, tensors = _attn_tensors(x, e, e_self, a_i, a_j, senders,
                                        receivers, w)
    check_layout(x, N, E, block_nodes, block_edges)
    _build.check_tensors(x.device, tensors + softmax_tensors(N, E, H, saved)
                         + [(g, "g", (N, H, D), _F32, True)])
    bf = _build.check_compute_dtype(compute_dtype)
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
        block_edges, slope, int(bf), _build.stream(x))
    if err:
        raise RuntimeError(
            f"blocked_gat_attention backward launch failed (CUDA error {err})")
    launches["blocked_gat_attention_bwd"] += 1
    return dx, de, dpar[0], dpar[1], dpar[2]


class _BlockedGatAttention(torch.autograd.Function):
    """K5's kernels; ``x`` and ``e`` in bfloat16 are read widened (exact)
    and their gradients returned in their dtypes."""

    @staticmethod
    def forward(ctx, x, e, e_self, a_i, a_j, senders, receivers, w, slope,
                block_nodes, block_edges, compute_dtype):
        ctx.dtypes = (x.dtype, e.dtype)
        x, e = seg.at_least_f32(x), seg.at_least_f32(e)
        out, saved = gat_attn_fwd(x, e, e_self, a_i, a_j, senders, receivers,
                                  w, slope, block_nodes, block_edges,
                                  compute_dtype)
        ctx.save_for_backward(x, e, e_self, a_i, a_j, senders, receivers, w,
                              *saved)
        ctx.cfg = (slope, block_nodes, block_edges, compute_dtype)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *args, alpha, aself, dlr, dls = ctx.saved_tensors
        dx, de, *dpar = gat_attn_bwd(g.contiguous(), *args,
                                     (alpha, aself, dlr, dls), *ctx.cfg)
        dw = torch.zeros_like(args[7]) if ctx.needs_input_grad[7] else None
        return (dx.to(ctx.dtypes[0]), de.to(ctx.dtypes[1]), *dpar, None, None,
                dw, None, None, None, None)


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


def softmax_pieces_bf16(ps, pd, pe, sraw, senders, receivers, w,
                        slope: float):
    """The Pallas bodies' masked segment softmax from their logit scalars
    (``ps``, ``pd``, ``sraw`` ``[N, H]``, ``pe`` ``[E, H]``): ``(raw, p,
    p_self, den)`` with ``raw = ps[rcv] + pd[snd] + pe``, ``p = exp(logit -
    m[rcv]) w`` (0 where ``w <= 0``), ``p_self = exp(sl - m)`` and ``den``
    their sum per receiver, ``m`` the receiver's largest logit, its self
    loop's included. Shared by K4's and K5's plain versions at bfloat16."""
    snd, rcv = senders.long(), receivers.long()
    raw = ps[rcv] + pd[snd] + pe
    sl = leaky_relu(sraw, slope)
    logit = torch.where((w > 0)[:, None], leaky_relu(raw, slope),
                        seg._NEG_INF)
    m = torch.maximum(seg._segment_amax(logit, rcv, ps.shape[0]), sl)
    p = torch.exp(logit - m[rcv]) * w[:, None]
    p_self = torch.exp(sl - m)
    den = seg.scatter_add_rows(torch.zeros_like(ps), rcv, p) + p_self
    return raw, p, p_self, den


def leaky_slope(t: torch.Tensor, slope: float) -> torch.Tensor:
    """LeakyReLU's derivative: 1 where ``t >= 0``, else ``slope``."""
    return torch.where(t >= 0, 1.0, slope)


class _AttentionPlainBf16(torch.autograd.Function):
    """K5's plain version at compute dtype bfloat16: the Pallas bodies
    (``_fwd_kernel``, ``_bwd_kernel`` of ``pallas_attention.py``, and the
    projection outer products that ``blocked_gat_backward`` leaves to XLA)
    in torch, rounding where they round; no gradient reaches ``w``."""

    @staticmethod
    def forward(ctx, x, e, e_self, a_i, a_j, senders, receivers, w, slope):
        ctx.dtypes = (x.dtype, e.dtype)
        x, e = x.float(), e.float()
        ps, pd, pe, sraw = _scalars(x, e, e_self, a_i, a_j)
        _, p, p_self, den = softmax_pieces_bf16(ps, pd, pe, sraw, senders,
                                                receivers, w, slope)
        r = _build.round_bf16
        msg = r(x)[senders.long()] + r(e)
        numer = seg.scatter_add_rows(torch.zeros_like(x), receivers.long(),
                                     r(p[..., None] * msg))
        numer = numer + p_self[..., None] * r(x + e_self)
        ctx.save_for_backward(x, e, e_self, a_i, a_j, senders, receivers, w)
        ctx.slope = slope
        return numer / den[..., None]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, e, e_self, a_i, a_j, senders, receivers, w = ctx.saved_tensors
        slope, r = ctx.slope, _build.round_bf16
        snd, rcv = senders.long(), receivers.long()
        ps, pd, pe, sraw = _scalars(x, e, e_self, a_i, a_j)
        raw, p, p_self, den = softmax_pieces_bf16(ps, pd, pe, sraw, senders,
                                                  receivers, w, slope)
        alpha = p / torch.clamp(den[rcv], min=1e-30)
        aself = p_self / den
        g = g.float()
        gb = r(g)
        g_r = gb[rcv]
        d_alpha = (g_r * (r(x)[snd] + r(e))).sum(-1)
        d_aself = (gb * r(x + e_self)).sum(-1)
        c = seg.scatter_add_rows(torch.zeros_like(ps), rcv,
                                 alpha * d_alpha) + aself * d_aself
        dz = alpha * (d_alpha - c[rcv]) * leaky_slope(raw, slope)
        dzs = aself * (d_aself - c) * leaky_slope(sraw, slope)
        dmsg = alpha[..., None] * g_r
        dps = seg.scatter_add_rows(torch.zeros_like(ps), rcv, dz)
        dpd = seg.scatter_add_rows(torch.zeros_like(ps), snd, dz)
        dx = (seg.scatter_add_rows(torch.zeros_like(x), snd, r(dmsg))
              + aself[..., None] * gb
              + (dps + dzs)[..., None] * a_i + (dpd + dzs)[..., None] * a_j)
        de = dmsg + dz[..., None] * a_j
        de_self = (torch.einsum("nh,nhd->hd", aself, g)
                   + dzs.sum(0)[:, None] * a_j)
        da_i = torch.einsum("nhd,nh->hd", x, dps + dzs)
        da_j = (torch.einsum("nhd,nh->hd", x, dpd + dzs)
                + torch.einsum("ehd,eh->hd", e, dz)
                + dzs.sum(0)[:, None] * e_self)
        return (dx.to(ctx.dtypes[0]), de.to(ctx.dtypes[1]), de_self, da_i,
                da_j, None, None, None, None)


def _scalars(x, e, e_self, a_i, a_j):
    """K5's logit scalars as ``blocked_gat_forward`` forms them outside its
    body: ``x·a_i``, ``x·a_j``, ``e·a_j`` and the self loop's raw logit
    ``x·a_i + x·a_j + e_self·a_j``."""
    ps = (x * a_i).sum(-1)
    pd = (x * a_j).sum(-1)
    return ps, pd, (e * a_j).sum(-1), ps + pd + (e_self * a_j).sum(-1)


def blocked_gat_attention_plain(x, e, e_self, a_i, a_j, senders, receivers,
                                w, slope: float = 0.2, block_nodes: int = 0,
                                block_edges: int = 0,
                                compute_dtype: torch.dtype = _F32
                                ) -> torch.Tensor:
    """The plain PyTorch version of K5 (any layout). ``a_i``, ``a_j`` and
    ``e_self`` are ``[H, D]``; ``w`` is the f32 edge weight with the mask
    folded in: a slot with ``w <= 0`` is out of the softmax, and any other
    weight multiplies the slot's unnormalised probability, as in the
    kernels. At float32 autograd gives the backward; with weights of 0 and
    1 this is :func:`gat_attention_plain` bit for bit (``log 1 = 0``);
    fractional weights are the one case the two differ in. At bfloat16 it
    is :class:`_AttentionPlainBf16`. No gradient reaches ``w`` (the kernels
    return zero for it)."""
    w = w.detach()
    if _build.check_compute_dtype(compute_dtype):
        return _AttentionPlainBf16.apply(x, e, e_self, a_i, a_j, senders,
                                         receivers, w, slope)
    return _attention_plain(x, e, e_self, a_i, a_j, senders, receivers,
                            w > 0, slope,
                            log_w=torch.log(torch.clamp(w, min=1e-30)))


def blocked_gat_attention(x, e, e_self, a_i, a_j, senders, receivers, w,
                          slope: float, block_nodes: int, block_edges: int,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """K5 on CUDA tensors (kernel forward and backward), the plain version
    on CPU tensors, at ``compute_dtype`` (float32 or bfloat16). Returns
    ``[N, H, D]``, float32."""
    if x.is_cuda:
        return _BlockedGatAttention.apply(
            x.contiguous(), e.contiguous(), e_self.contiguous(),
            a_i.contiguous(), a_j.contiguous(), senders, receivers, w,
            float(slope), block_nodes, block_edges, compute_dtype)
    return blocked_gat_attention_plain(x, e, e_self, a_i, a_j, senders,
                                       receivers, w, slope,
                                       compute_dtype=compute_dtype)


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
                  block_edges: int = 0,
                  compute_dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
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
        block_edges, compute_dtype)
