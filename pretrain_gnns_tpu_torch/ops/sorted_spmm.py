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
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from pretrain_gnns_tpu_torch.ops import _build
from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs

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
                    block_edges: int) -> torch.Tensor:
    """Launch K7's forward; returns ``out [N, F]``. ``ee`` may be None."""
    tensors = bs.ee_fwd_tensors(x, ee, senders, receivers, w)
    (N, F), E = x.shape, senders.shape[0]
    lib = bs.check_ee_layout(
        x.device, block_nodes, block_edges, N, E,
        lambda lib: lib.pgt_spmm_sorted_smem(block_nodes, block_edges),
        tensors)
    out = torch.empty((N, F), dtype=torch.float32, device=x.device)
    err = lib.pgt_spmm_sorted_fwd(
        x.data_ptr(), None if ee is None else ee.data_ptr(),
        senders.data_ptr(), receivers.data_ptr(), w.data_ptr(),
        out.data_ptr(), N, F, block_nodes, block_edges, int(ee is not None),
        _build.stream(x))
    if err:
        raise RuntimeError(
            f"sorted_blocked_spmm forward launch failed (CUDA error {err})")
    launches["sorted_blocked_spmm_fwd"] += 1
    return out


class _SortedBlockedSpmm(torch.autograd.Function):
    """The kernel on CUDA tensors, the plain version on CPU tensors;
    either way differentiating through the result raises."""

    @staticmethod
    def forward(ctx, x, ee, senders, receivers, w, block_nodes, block_edges):
        fn = sorted_spmm_fwd if x.is_cuda else sorted_blocked_spmm_plain
        return fn(x, ee, senders, receivers, w, block_nodes, block_edges)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "sorted_blocked_spmm is forward only (the JAX function it "
            "ports has no VJP); train through blocked_spmm")


def sorted_blocked_spmm_plain(x, edge_emb, senders, receivers, edge_weight,
                              block_nodes: int = 0, block_edges: int = 0
                              ) -> torch.Tensor:
    """The plain PyTorch version of K7: K6's plain version (the function
    does not depend on the slots' order), cut from the autograd graph."""
    with torch.no_grad():
        return bs.blocked_spmm_plain(x, edge_emb, senders, receivers,
                                     edge_weight, block_nodes, block_edges)


def _check_sorted(receivers, block_edges: int) -> None:
    if block_edges <= 0 or receivers.shape[0] % block_edges:
        raise ValueError("sorted_blocked_spmm needs the block-diagonal "
                         "layout (block_edges > 0)")
    r2 = receivers.reshape(-1, block_edges)
    if bool((r2[:, 1:] < r2[:, :-1]).any()):
        raise ValueError("sorted_blocked_spmm needs receivers that ascend "
                         "within each block (see sort_block_edges)")


def sorted_blocked_spmm(x, edge_emb, senders, receivers, edge_weight,
                        block_nodes: int, block_edges: int) -> torch.Tensor:
    """K7 on CUDA tensors, the plain version on CPU tensors (where the
    sortedness of ``receivers`` is checked first). Forward only: calling
    ``backward`` through the result raises ``NotImplementedError``."""
    if not x.is_cuda:
        _check_sorted(receivers, block_edges)
    return _SortedBlockedSpmm.apply(x, edge_emb, senders, receivers,
                                    edge_weight, block_nodes, block_edges)
