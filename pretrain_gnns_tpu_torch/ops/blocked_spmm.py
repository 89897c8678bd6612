"""Fused edge-transform SpMM (K2): the aggregation of every conv that is
not a fused GIN or GAT layer, forward and backward; and the blocked SpMM
on a precomputed edge embedding (K6, :func:`blocked_spmm`, below).

Replaces ``pretrain_gnns_tpu/ops/pallas_spmm.py::blocked_spmm_fused``
(the Pallas TPU kernels ``_fused_fwd_kernel``/``_fused_bwd_kernel``). On
the block-diagonal batch it computes::

    out[r] = sum_{rcv_e = r} w_e * (x[snd_e] [has_x] + (ein @ W)_e [has_ein])

``has_x=False`` drops the gather term (``x`` then gives only the number of
rows), ``has_ein=False`` the edge term; not both. The backward returns
``dx`` (zeros when ``has_x`` is false), ``dW`` (float32) and zero
gradients for ``ein`` and ``w``, as the JAX custom VJP does. Padded node
rows come out 0.

On a CUDA tensor :func:`blocked_spmm_fused` launches the hand-written
kernels of ``csrc/spmm.cu`` and, at ``compute_dtype=torch.bfloat16``,
``csrc/spmm_bf16.cu`` (see the notes there for what bounds them on the
card and how they are built) or raises; on a CPU tensor it runs the
plain PyTorch version :func:`blocked_spmm_fused_plain`. ``launches``
counts the kernel launches by direction and variant, e.g.
``blocked_spmm_fwd[x]``, ``blocked_spmm_bwd[x+ein]``.

``compute_dtype`` is the Pallas kernel's: at ``torch.bfloat16`` K2 rounds
the edge weight, the gathered rows, ``w * ein`` and ``W`` to bfloat16 and
each message before the receiver sum, and in the backward
``dmsg = bf(bf(w) bf(g))`` and ``ein`` before their products, every sum in
float32. ``x`` may be float32 or bfloat16: ``out`` and ``dx`` come out in
``x``'s dtype, ``dW`` in float32. The plain version at bfloat16 is
:class:`_SpmmPlainBf16`. It stays apart from the float32 plain version
(autograd over ``w * (x[snd] + ein @ W)``): with its rounding taken out it
computes ``w x[snd] + (w ein) @ W``, the Pallas body's association, which
moves the last bits of ``out``, and the
float32 plain version keeps the bits the float32 tests were written on.

K6 replaces ``pretrain_gnns_tpu/ops/pallas_spmm.py::blocked_spmm`` (the
Pallas TPU kernels ``_fwd_kernel``/``_bwd_kernel``)::

    out[r] = sum_{rcv_e = r} w_e * (x[snd_e] + edge_emb_e [if given])

Its backward forms ``dmsg_e = w_e * g[rcv_e]`` for every edge slot (exact
zeros on padded slots and on slots with an endpoint outside their block)
and returns ``dx`` (``dmsg`` scattered onto the senders), ``dee = dmsg``
when an edge embedding was given, and a zero gradient for ``w``, as the
JAX custom VJP does; each of ``dx`` and ``dee`` is computed only when
autograd asks for it. On a CUDA tensor :func:`blocked_spmm` launches the
kernels of ``csrc/spmm_ee.cu`` or raises; on a CPU tensor it runs
:func:`blocked_spmm_plain`. Its counters are
``blocked_spmm_ee_{fwd,bwd}[x+ee]`` and ``blocked_spmm_ee_{fwd,bwd}[x]``.
At ``compute_dtype=torch.bfloat16`` K6 computes the Pallas bodies' function
at that dtype: ``out[r] = sum bf(w_e (bf(x[snd_e]) + ee_e))`` (``ee``
unrounded), ``dmsg_e = w_e bf(g[rcv_e])`` in ``g``'s dtype and ``dx =
sum bf(dmsg_e)``, every sum in float32; its plain version is
:class:`_SpmmEePlainBf16`. ``x`` and ``edge_emb`` may be float32 or
bfloat16: ``out`` comes out in ``x``'s dtype, ``dx`` and ``dmsg`` in the
cotangent's; where the two differ, the kernels read both widened (exact)
and ``out`` is rounded to ``x``'s dtype after.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from pretrain_gnns_tpu_torch.ops import _build
from pretrain_gnns_tpu_torch.ops import segment as seg

_VARIANTS = {(True, False): "x", (False, True): "ein", (True, True): "x+ein"}
launches: Dict[str, int] = {
    **{f"blocked_spmm_{d}[{v}]": 0 for d in ("fwd", "bwd")
       for v in _VARIANTS.values()},
    **{f"blocked_spmm_ee_{d}[{v}]": 0 for d in ("fwd", "bwd")
       for v in ("x+ee", "x")},
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def variant(has_x: bool, has_ein: bool) -> str:
    """The launch-counter suffix of a flag combination."""
    try:
        return _VARIANTS[(bool(has_x), bool(has_ein))]
    except KeyError:
        raise ValueError("has_x and has_ein cannot both be false") from None


_P, _I = ctypes.c_void_p, ctypes.c_int
_F32, _I32, _BF16 = torch.float32, torch.int32, torch.bfloat16


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm")
    lib.pgt_spmm_fwd.argtypes = [_P] * 7 + [_I] * 9 + [_P]
    lib.pgt_spmm_fwd.restype = _I
    lib.pgt_spmm_bwd.argtypes = [_P] * 8 + [_I] * 9 + [_P]
    lib.pgt_spmm_bwd.restype = _I
    lib.pgt_spmm_fwd_smem.argtypes = [_I] * 3
    lib.pgt_spmm_fwd_smem.restype = _I
    lib.pgt_spmm_bwd_smem.argtypes = [_I] * 3
    lib.pgt_spmm_bwd_smem.restype = _I
    lib.pgt_spmm_max_smem.restype = _I
    lib.pgt_spmm_max_k.restype = _I
    return lib


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError("the blocked_spmm kernels take CUDA tensors")


def _check(lib, dev, block_nodes: int, block_edges: int, N: int, K: int,
           E: int, smem: int, tensors) -> None:
    """Raise on what the kernels do not take: ``tensors`` lists
    ``(tensor, name, shape, dtype)``, each to be contiguous."""
    if block_nodes <= 0 or block_edges <= 0:
        raise ValueError("the blocked_spmm kernels need the block-diagonal "
                         "layout (block_nodes, block_edges > 0)")
    if smem > lib.pgt_spmm_max_smem():
        raise ValueError(f"block_nodes={block_nodes} needs {smem} bytes of "
                         f"shared memory, more than "
                         f"{lib.pgt_spmm_max_smem()}")
    if K > lib.pgt_spmm_max_k():
        raise ValueError(f"K={K} exceeds {lib.pgt_spmm_max_k()}")
    if N % block_nodes or E != (N // block_nodes) * block_edges:
        raise ValueError(f"N={N}, E={E} do not form blocks of "
                         f"({block_nodes}, {block_edges})")
    _build.check_tensors(dev, [t + (True,) for t in tensors])


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def spmm_fwd(x, ein, W, senders, receivers, w, block_nodes: int,
             block_edges: int, has_x: bool = True, has_ein: bool = True,
             compute_dtype: torch.dtype = _F32) -> torch.Tensor:
    """Launch K2's forward; returns ``out [N, F]`` in ``x``'s dtype. ``x``
    gives N, the device and the rows' dtype even when ``has_x`` is
    false."""
    name = variant(has_x, has_ein)
    _require_cuda(x)
    lib = _lib()
    N, E = x.shape[0], senders.shape[0]
    F = W.shape[1] if has_ein else x.shape[1]
    K = W.shape[0] if has_ein else 0
    rows = _build.row_dtype(x, "x")
    bf = _build.check_compute_dtype(compute_dtype)
    tensors = [(senders, "senders", (E,), _I32),
               (receivers, "receivers", (E,), _I32), (w, "w", (E,), _F32)]
    if has_x:
        tensors.append((x, "x", (N, F), rows))
    if has_ein:
        tensors += [(ein, "ein", (E, K), _F32), (W, "W", (K, F), _F32)]
    _check(lib, x.device, block_nodes, block_edges, N, K, E,
           lib.pgt_spmm_fwd_smem(block_nodes, K, int(has_ein)), tensors)
    out = torch.empty((N, F), dtype=rows, device=x.device)
    err = lib.pgt_spmm_fwd(
        x.data_ptr() if has_x else None, _ptr(ein) if has_ein else None,
        _ptr(W) if has_ein else None, senders.data_ptr(),
        receivers.data_ptr(), w.data_ptr(), out.data_ptr(), N, F, K,
        block_nodes, block_edges, int(has_x), int(has_ein),
        int(rows == _BF16), int(bf), _build.stream(x),
    )
    if err:
        raise RuntimeError(
            f"blocked_spmm forward launch failed (CUDA error {err})")
    launches[f"blocked_spmm_fwd[{name}]"] += 1
    return out


def spmm_bwd(g, ein, senders, receivers, w, K: int, block_nodes: int,
             block_edges: int, has_x: bool = True, has_ein: bool = True,
             compute_dtype: torch.dtype = _F32
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch K2's backward from ``g [N, F]``; returns ``(dx, dW)``, each
    None where its flag is false: ``dx`` in ``g``'s dtype, ``dW`` float32."""
    name = variant(has_x, has_ein)
    _require_cuda(g)
    lib = _lib()
    (N, F), E = g.shape, senders.shape[0]
    K = K if has_ein else 0
    rows = _build.row_dtype(g, "g")
    bf = _build.check_compute_dtype(compute_dtype)
    tensors = [(g, "g", (N, F), rows), (senders, "senders", (E,), _I32),
               (receivers, "receivers", (E,), _I32), (w, "w", (E,), _F32)]
    if has_ein:
        tensors.append((ein, "ein", (E, K), _F32))
    _check(lib, g.device, block_nodes, block_edges, N, K, E,
           lib.pgt_spmm_bwd_smem(block_nodes, int(has_x), int(has_ein)),
           tensors)
    new = lambda *shape: torch.empty(shape, dtype=_F32, device=g.device)
    dx = (torch.empty((N, F), dtype=rows, device=g.device) if has_x
          else None)
    dW = new(K, F) if has_ein else None
    part = new(N // block_nodes, K, F) if has_ein else None
    err = lib.pgt_spmm_bwd(
        g.data_ptr(), _ptr(ein) if has_ein else None, senders.data_ptr(),
        receivers.data_ptr(), w.data_ptr(), _ptr(dx), _ptr(dW), _ptr(part),
        N, F, K, block_nodes, block_edges, int(has_x), int(has_ein),
        int(rows == _BF16), int(bf), _build.stream(g),
    )
    if err:
        raise RuntimeError(
            f"blocked_spmm backward launch failed (CUDA error {err})")
    launches[f"blocked_spmm_bwd[{name}]"] += 1
    return dx, dW


class _BlockedSpmmFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ein, W, senders, receivers, w, block_nodes,
                block_edges, has_x, has_ein, compute_dtype):
        out = spmm_fwd(x, ein, W, senders, receivers, w, block_nodes,
                       block_edges, has_x, has_ein, compute_dtype)
        ctx.save_for_backward(ein, senders, receivers, w)
        ctx.cfg = (W.shape[0] if has_ein else 0, block_nodes, block_edges,
                   has_x, has_ein, compute_dtype)
        ctx.x_like = (x.shape, x.dtype, x.device)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ein, senders, receivers, w = ctx.saved_tensors
        K, bn, be, has_x, has_ein, cdt = ctx.cfg
        dx, dW = spmm_bwd(g.contiguous(), ein, senders, receivers, w, K, bn,
                          be, has_x, has_ein, cdt)
        need = ctx.needs_input_grad
        if need[0] and dx is None:
            shape, dtype, dev = ctx.x_like
            dx = torch.zeros(shape, dtype=dtype, device=dev)
        dein = torch.zeros_like(ein) if need[1] else None  # as the JAX VJP
        dw = torch.zeros_like(w) if need[5] else None
        return (dx if need[0] else None, dein, dW if need[2] else None,
                None, None, dw, None, None, None, None, None)


class _SpmmPlainBf16(torch.autograd.Function):
    """K2's plain version at compute dtype bfloat16: the Pallas kernel's
    bodies (``_fused_fwd_kernel``, ``_fused_bwd_kernel`` of
    ``pallas_spmm.py``) in torch, rounding where they round; ``dein`` and
    ``dw`` are zeros, as the JAX VJP's."""

    @staticmethod
    def forward(ctx, x, ein, W, senders, receivers, w, has_x, has_ein):
        r = _build.round_bf16
        snd, rcv = senders.long(), receivers.long()
        wf = w.float()
        msg = r(ein.float() * wf[:, None]) @ r(W) if has_ein else 0
        if has_x:
            msg = msg + r(wf)[:, None] * r(x.float())[snd]
        N, F = x.shape[0], msg.shape[1]
        out = seg.scatter_add_rows(x.new_zeros((N, F), dtype=_F32), rcv,
                                   r(msg))
        ctx.save_for_backward(ein, senders, receivers, w)
        ctx.cfg = (has_x, has_ein, x.shape, x.dtype)
        return out.to(x.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        r = _build.round_bf16
        ein, senders, receivers, w = ctx.saved_tensors
        has_x, has_ein, x_shape, x_dtype = ctx.cfg
        need = ctx.needs_input_grad
        dmsg = r(r(w.float())[:, None] * r(g.float())[receivers.long()])
        dx = dW = None
        if need[0]:
            dx = (seg.scatter_add_rows(g.new_zeros(x_shape, dtype=_F32),
                                       senders.long(), dmsg)
                  if has_x else g.new_zeros(x_shape, dtype=_F32))
            dx = dx.to(x_dtype)
        if has_ein and need[2]:
            dW = r(ein.float()).t() @ dmsg
        return (dx, torch.zeros_like(ein) if has_ein and need[1] else None,
                dW, None, None, torch.zeros_like(w) if need[5] else None,
                None, None)


def blocked_spmm_fused_plain(x, ein, W, senders, receivers, w,
                             block_nodes: int = 0, block_edges: int = 0,
                             has_x: bool = True, has_ein: bool = True,
                             compute_dtype: torch.dtype = _F32
                             ) -> torch.Tensor:
    """The plain PyTorch version of K2 (any layout). At float32 autograd
    gives the backward: a gather of ``x`` widened to float32, the edge
    product, a weighted segment sum, returned in ``x``'s dtype. At
    bfloat16 it is :class:`_SpmmPlainBf16`."""
    variant(has_x, has_ein)
    if _build.check_compute_dtype(compute_dtype):
        return _SpmmPlainBf16.apply(x, ein, W, senders, receivers, w, has_x,
                                    has_ein)
    msg = (seg.at_least_f32(x).index_select(0, senders.long()) if has_x
           else 0)
    if has_ein:
        msg = msg + ein @ W
    return seg.segment_sum(msg, receivers, x.shape[0], mask=w).to(x.dtype)


def blocked_spmm_fused(x, ein, W, senders, receivers, w, block_nodes: int,
                       block_edges: int, has_x: bool = True,
                       has_ein: bool = True,
                       compute_dtype: torch.dtype = _F32) -> torch.Tensor:
    """K2 on CUDA tensors (kernel forward and backward), the plain version
    on CPU tensors. ``w`` is the f32 edge weight with the mask folded in
    (0 on padded slots); ``compute_dtype`` is float32 or bfloat16."""
    if x.is_cuda:
        return _BlockedSpmmFused.apply(x, ein, W, senders, receivers, w,
                                       block_nodes, block_edges, has_x,
                                       has_ein, compute_dtype)
    return blocked_spmm_fused_plain(x, ein, W, senders, receivers, w,
                                    block_nodes, block_edges, has_x, has_ein,
                                    compute_dtype)


# --- K6: the edge embedding precomputed, [E, F] ---------------------------


@functools.cache
def _ee_lib() -> ctypes.CDLL:
    lib = _build.load("spmm_ee")
    lib.pgt_spmm_ee_fwd.argtypes = [_P] * 6 + [_I] * 7 + [_P]
    lib.pgt_spmm_ee_fwd.restype = _I
    lib.pgt_spmm_ee_bwd.argtypes = [_P] * 6 + [_I] * 8 + [_P]
    lib.pgt_spmm_ee_bwd.restype = _I
    lib.pgt_spmm_sorted_fwd.argtypes = [_P] * 6 + [_I] * 7 + [_P]
    lib.pgt_spmm_sorted_fwd.restype = _I
    lib.pgt_spmm_ee_smem.argtypes = [_I]
    lib.pgt_spmm_ee_smem.restype = _I
    lib.pgt_spmm_sorted_smem.argtypes = [_I, _I]
    lib.pgt_spmm_sorted_smem.restype = _I
    lib.pgt_spmm_ee_max_smem.restype = _I
    return lib


def ee_variant(has_ee: bool) -> str:
    """The launch-counter suffix of K6 with or without an edge embedding."""
    return "x+ee" if has_ee else "x"


def check_ee_layout(dev, block_nodes: int, block_edges: int, N: int, E: int,
                    smem_of, tensors) -> ctypes.CDLL:
    """Raise on what the kernels of ``csrc/spmm_ee.cu`` do not take
    (``tensors`` lists ``(tensor, name, shape, dtype)``, each to be
    contiguous; ``smem_of(lib)`` gives the launch's shared memory in
    bytes); returns the library."""
    if dev.type != "cuda":
        raise ValueError("the blocked_spmm kernels take CUDA tensors")
    if block_nodes <= 0 or block_edges <= 0:
        raise ValueError("the blocked_spmm kernels need the block-diagonal "
                         "layout (block_nodes, block_edges > 0)")
    if N % block_nodes or E != (N // block_nodes) * block_edges:
        raise ValueError(f"N={N}, E={E} do not form blocks of "
                         f"({block_nodes}, {block_edges})")
    _build.check_tensors(dev, [t + (True,) for t in tensors])
    lib = _ee_lib()
    smem = smem_of(lib)
    if smem > lib.pgt_spmm_ee_max_smem():
        raise ValueError(f"blocks of ({block_nodes}, {block_edges}) need "
                         f"{smem} bytes of shared memory, more than "
                         f"{lib.pgt_spmm_ee_max_smem()}")
    return lib


def ee_fwd_tensors(x, ee, senders, receivers, w):
    """The ``(tensor, name, shape, dtype)`` list of a K6 or K7 forward: x
    and ee in one dtype, float32 or bfloat16."""
    if x.dim() != 2:
        raise ValueError(f"x must be [N, F], got {tuple(x.shape)}")
    (N, F), E = x.shape, senders.shape[0]
    rows = _build.row_dtype(x, "x")
    tensors = [(x, "x", (N, F), rows), (senders, "senders", (E,), _I32),
               (receivers, "receivers", (E,), _I32), (w, "w", (E,), _F32)]
    if ee is not None:
        tensors.append((ee, "edge_emb", (E, F), rows))
    return tensors


def spmm_ee_fwd(x, ee, senders, receivers, w, block_nodes: int,
                block_edges: int, compute_dtype: torch.dtype = _F32
                ) -> torch.Tensor:
    """Launch K6's forward at ``compute_dtype``; returns ``out [N, F]`` in
    the rows' dtype (``x`` and ``ee``, which may be None, share it)."""
    tensors = ee_fwd_tensors(x, ee, senders, receivers, w)
    (N, F), E = x.shape, senders.shape[0]
    bf = _build.check_compute_dtype(compute_dtype)
    lib = check_ee_layout(x.device, block_nodes, block_edges, N, E,
                          lambda lib: lib.pgt_spmm_ee_smem(block_nodes),
                          tensors)
    out = torch.empty((N, F), dtype=x.dtype, device=x.device)
    err = lib.pgt_spmm_ee_fwd(
        x.data_ptr(), _ptr(ee), senders.data_ptr(), receivers.data_ptr(),
        w.data_ptr(), out.data_ptr(), N, F, block_nodes, block_edges,
        int(ee is not None), int(x.dtype == _BF16), int(bf),
        _build.stream(x))
    if err:
        raise RuntimeError(
            f"blocked_spmm (edge_emb) forward launch failed (CUDA error "
            f"{err})")
    launches[f"blocked_spmm_ee_fwd[{ee_variant(ee is not None)}]"] += 1
    return out


def spmm_ee_bwd(g, senders, receivers, w, block_nodes: int, block_edges: int,
                has_ee: bool, need_dx: bool = True, need_dmsg: bool = True,
                compute_dtype: torch.dtype = _F32
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch K6's backward at ``compute_dtype`` from ``g [N, F]``; returns
    ``(dx [N, F], dmsg [E, F])`` in ``g``'s dtype, every row written, each
    None where not needed. ``has_ee`` only names the counter."""
    if not (need_dx or need_dmsg):
        raise ValueError("need_dx and need_dmsg cannot both be false")
    if g.dim() != 2:
        raise ValueError(f"g must be [N, F], got {tuple(g.shape)}")
    (N, F), E = g.shape, senders.shape[0]
    rows = _build.row_dtype(g, "g")
    bf = _build.check_compute_dtype(compute_dtype)
    tensors = [(g, "g", (N, F), rows), (senders, "senders", (E,), _I32),
               (receivers, "receivers", (E,), _I32), (w, "w", (E,), _F32)]
    lib = check_ee_layout(
        g.device, block_nodes, block_edges, N, E,
        lambda lib: lib.pgt_spmm_ee_smem(block_nodes) if need_dx else 0,
        tensors)
    dx = (torch.empty((N, F), dtype=rows, device=g.device)
          if need_dx else None)
    dmsg = (torch.empty((E, F), dtype=rows, device=g.device)
            if need_dmsg else None)
    err = lib.pgt_spmm_ee_bwd(
        g.data_ptr(), senders.data_ptr(), receivers.data_ptr(), w.data_ptr(),
        _ptr(dx), _ptr(dmsg), N, F, block_nodes, block_edges, int(need_dx),
        int(need_dmsg), int(rows == _BF16), int(bf), _build.stream(g))
    if err:
        raise RuntimeError(
            f"blocked_spmm (edge_emb) backward launch failed (CUDA error "
            f"{err})")
    launches[f"blocked_spmm_ee_bwd[{ee_variant(has_ee)}]"] += 1
    return dx, dmsg


def common_rows(x, ee):
    """``x`` and ``ee`` (or None) in one dtype for K6's and K7's kernels:
    as given where they share it, else both widened to float32 (exact)."""
    if ee is None or ee.dtype == x.dtype:
        return x, ee
    return seg.at_least_f32(x), seg.at_least_f32(ee)


class _BlockedSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ee, senders, receivers, w, block_nodes, block_edges,
                compute_dtype):
        xk, eek = common_rows(x, ee)
        out = spmm_ee_fwd(xk, eek, senders, receivers, w, block_nodes,
                          block_edges, compute_dtype).to(x.dtype)
        ctx.save_for_backward(senders, receivers, w)
        ctx.cfg = (block_nodes, block_edges, ee is not None, compute_dtype)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        senders, receivers, w = ctx.saved_tensors
        bn, be, has_ee, cdt = ctx.cfg
        need = ctx.needs_input_grad
        need_dx, need_dee = need[0], has_ee and need[1]
        dx = dee = None
        if need_dx or need_dee:
            dx, dee = spmm_ee_bwd(g.contiguous(), senders, receivers, w, bn,
                                  be, has_ee, need_dx, need_dee, cdt)
        dw = torch.zeros_like(w) if need[4] else None  # as the JAX VJP
        return dx, dee, None, None, dw, None, None, None


class _SpmmEePlainBf16(torch.autograd.Function):
    """K6's plain version at compute dtype bfloat16: the Pallas bodies
    (``_fwd_kernel``, ``_bwd_kernel`` of ``pallas_spmm.py``) in torch,
    rounding where they round; ``w`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, ee, senders, receivers, w):
        r = _build.round_bf16
        msg = r(x.float())[senders.long()]
        if ee is not None:
            msg = msg + ee.float()
        msg = r(msg * w.float()[:, None])
        out = seg.scatter_add_rows(x.new_zeros(x.shape, dtype=_F32),
                                   receivers.long(), msg)
        ctx.save_for_backward(senders, receivers, w)
        ctx.x_like = (x.shape, ee is not None)
        return out.to(x.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        r = _build.round_bf16
        senders, receivers, w = ctx.saved_tensors
        dmsg = r(g.float())[receivers.long()] * w.float()[:, None]
        x_shape, has_ee = ctx.x_like
        dx = seg.scatter_add_rows(g.new_zeros(x_shape, dtype=_F32),
                                  senders.long(), r(dmsg)).to(g.dtype)
        return (dx, dmsg.to(g.dtype) if has_ee else None, None, None, None)


def blocked_spmm_plain(x, edge_emb, senders, receivers, edge_weight,
                       block_nodes: int = 0, block_edges: int = 0,
                       compute_dtype: torch.dtype = _F32) -> torch.Tensor:
    """The plain PyTorch version of K6 (any layout). At float32 autograd
    gives the backward: a gather, the sum with the edge embedding, a
    weighted segment sum (in float32, returned in ``x``'s dtype); at
    bfloat16 it is :class:`_SpmmEePlainBf16`.
    ``edge_weight`` counts as data: it gets no gradient."""
    if _build.check_compute_dtype(compute_dtype):
        return _SpmmEePlainBf16.apply(x, edge_emb, senders, receivers,
                                      edge_weight.detach())
    # bfloat16 rows are widened, summed in float32 and the sum rounded to
    # x's dtype, as the Pallas body at float32 (float32 rows: unchanged)
    msg = seg.at_least_f32(x).index_select(0, senders.long())
    if edge_emb is not None:
        msg = msg + seg.at_least_f32(edge_emb)
    return seg.segment_sum(msg, receivers, x.shape[0],
                           mask=edge_weight.detach()).to(x.dtype)


def blocked_spmm(x, edge_emb, senders, receivers, edge_weight,
                 block_nodes: int, block_edges: int,
                 compute_dtype: torch.dtype = _F32) -> torch.Tensor:
    """K6 on CUDA tensors (kernel forward and backward), the plain version
    on CPU tensors, at ``compute_dtype`` (float32 or bfloat16).
    ``edge_emb`` is ``[E, F]`` or None; ``edge_weight`` is the f32 edge
    weight with the mask folded in (0 on padded slots)."""
    if x.is_cuda:
        return _BlockedSpmm.apply(x, edge_emb, senders, receivers,
                                  edge_weight, block_nodes, block_edges,
                                  compute_dtype)
    return blocked_spmm_plain(x, edge_emb, senders, receivers, edge_weight,
                              block_nodes, block_edges, compute_dtype)
