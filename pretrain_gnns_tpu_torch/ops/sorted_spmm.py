"""Receiver-sorted blocked SpMM (K7), forward only, and the per-block sort
that prepares its input (port of
``pretrain_gnns_tpu/ops/pallas_spmm_sorted.py``).

The same forward as the blocked SpMM on a precomputed edge embedding (K6,
``ops/blocked_spmm.blocked_spmm``)::

    out[r] = sum_{rcv_e = r} w_e * (x[snd_e] + edge_emb_e [if given])

under the contract that ``receivers`` ascend within each block of
``block_edges`` slots, which :func:`sort_block_edges` establishes (a stable
sort, so equal receivers keep their slot order and the arrays equal the
JAX function's element for element). Padded slots (global index 0,
``w = 0``) sort to the front of their block and add nothing.

On a CUDA tensor :func:`sorted_blocked_spmm` launches the hand-written
kernel of ``csrc/spmm_ee.cu`` (a segmented reduction: the runs of
receivers are found in one pass, each node's run is summed in slot order in
a register and written once; see the note there) or raises; on a CPU tensor it runs
:func:`sorted_blocked_spmm_plain`, after checking the contract. The card
path does not check it: the check would synchronise the device. Like the
JAX function it has no backward: differentiating through it raises.
``launches`` counts the kernel launches: ``sorted_blocked_spmm_fwd``.

At ``compute_dtype=torch.bfloat16`` K7 computes the Pallas body's function
at that dtype: the gathered ``x`` rows rounded to bfloat16, each message
``w_e (bf(x[snd_e]) + ee_e)`` summed unrounded in float32 (the body's
prefix sums). Rows as K6's: ``out`` in ``x``'s dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from pretrain_gnns_tpu_torch.ops import _build
from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs
from pretrain_gnns_tpu_torch.ops import segment as seg

launches: Dict[str, int] = {"sorted_blocked_spmm_fwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def sort_block_edges(senders, receivers, edge_weight, edge_emb,
                     n_blocks: int, block_edges: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    """Per-block stable sort of the edge slots by receiver; returns the
    sorted ``(senders, receivers, edge_weight, edge_emb)`` (``edge_emb``
    None when None was given)."""
    r2 = receivers.reshape(n_blocks, block_edges)
    order = torch.argsort(r2, dim=1, stable=True)
    take = lambda a: torch.take_along_dim(
        a.reshape(n_blocks, block_edges), order, dim=1).reshape(-1)
    ee = None
    if edge_emb is not None:
        ee = torch.take_along_dim(
            edge_emb.reshape(n_blocks, block_edges, -1), order[..., None],
            dim=1).reshape(-1, edge_emb.shape[-1])
    return take(senders), take(receivers), take(edge_weight), ee


def sorted_spmm_fwd(x, ee, senders, receivers, w, block_nodes: int,
                    block_edges: int,
                    compute_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Launch K7's forward at ``compute_dtype``; returns ``out [N, F]`` in
    the rows' dtype (``x`` and ``ee``, which may be None, share it)."""
    tensors = bs.ee_fwd_tensors(x, ee, senders, receivers, w)
    (N, F), E = x.shape, senders.shape[0]
    bf = _build.check_compute_dtype(compute_dtype)
    lib = bs.check_ee_layout(
        x.device, block_nodes, block_edges, N, E,
        lambda lib: lib.pgt_spmm_sorted_smem(block_nodes, block_edges),
        tensors)
    out = torch.empty((N, F), dtype=x.dtype, device=x.device)
    err = lib.pgt_spmm_sorted_fwd(
        x.data_ptr(), None if ee is None else ee.data_ptr(),
        senders.data_ptr(), receivers.data_ptr(), w.data_ptr(),
        out.data_ptr(), N, F, block_nodes, block_edges, int(ee is not None),
        int(x.dtype == torch.bfloat16), int(bf), _build.stream(x))
    if err:
        raise RuntimeError(
            f"sorted_blocked_spmm forward launch failed (CUDA error {err})")
    launches["sorted_blocked_spmm_fwd"] += 1
    return out


class _SortedBlockedSpmm(torch.autograd.Function):
    """The kernel on CUDA tensors, the plain version on CPU tensors;
    either way differentiating through the result raises."""

    @staticmethod
    def forward(ctx, x, ee, senders, receivers, w, block_nodes, block_edges,
                compute_dtype):
        if not x.is_cuda:
            return sorted_blocked_spmm_plain(x, ee, senders, receivers, w,
                                             block_nodes, block_edges,
                                             compute_dtype)
        xk, eek = bs.common_rows(x, ee)
        return sorted_spmm_fwd(xk, eek, senders, receivers, w, block_nodes,
                               block_edges, compute_dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "sorted_blocked_spmm is forward only (the JAX function it "
            "ports has no VJP); train through blocked_spmm")


def sorted_blocked_spmm_plain(x, edge_emb, senders, receivers, edge_weight,
                              block_nodes: int = 0, block_edges: int = 0,
                              compute_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """The plain PyTorch version of K7, cut from the autograd graph: at
    float32 K6's plain version (the function does not depend on the slots'
    order); at bfloat16 the Pallas body's, ``sum w_e (bf(x[snd_e]) +
    ee_e)`` in float32, returned in ``x``'s dtype."""
    with torch.no_grad():
        if not _build.check_compute_dtype(compute_dtype):
            return bs.blocked_spmm_plain(x, edge_emb, senders, receivers,
                                         edge_weight, block_nodes,
                                         block_edges)
        msg = _build.round_bf16(x.float())[senders.long()]
        if edge_emb is not None:
            msg = msg + edge_emb.float()
        out = seg.scatter_add_rows(
            x.new_zeros(x.shape, dtype=torch.float32), receivers.long(),
            msg * edge_weight.float()[:, None])
        return out.to(x.dtype)


def _check_sorted(receivers, block_edges: int) -> None:
    if block_edges <= 0 or receivers.shape[0] % block_edges:
        raise ValueError("sorted_blocked_spmm needs the block-diagonal "
                         "layout (block_edges > 0)")
    r2 = receivers.reshape(-1, block_edges)
    if bool((r2[:, 1:] < r2[:, :-1]).any()):
        raise ValueError("sorted_blocked_spmm needs receivers that ascend "
                         "within each block (see sort_block_edges)")


def sorted_blocked_spmm(x, edge_emb, senders, receivers, edge_weight,
                        block_nodes: int, block_edges: int,
                        compute_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """K7 on CUDA tensors, the plain version on CPU tensors (where the
    sortedness of ``receivers`` is checked first), at ``compute_dtype``
    (float32 or bfloat16). Forward only: calling ``backward`` through the
    result raises ``NotImplementedError``."""
    if not x.is_cuda:
        _check_sorted(receivers, block_edges)
    return _SortedBlockedSpmm.apply(x, edge_emb, senders, receivers,
                                    edge_weight, block_nodes, block_edges,
                                    compute_dtype)
