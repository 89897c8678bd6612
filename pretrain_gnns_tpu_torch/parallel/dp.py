"""Graph-data-parallel training (port of ``pretrain_gnns_tpu.parallel.dp``).

Each rank owns one device and trains on its own local batch (its column
of each group of ``world`` consecutive batches); the JAX package's
``shard_map`` over the mesh's ``data`` axis is here the process group.
A data-parallel step computes on every rank what the JAX ``per_device``
computes on every device:

- **gradients**: summed over the world and divided by the world size (the
  JAX ``psum`` / ``n_dev``);
- **loss and metrics**: the world's means (``pmean``);
- **batch norm**: each ``MaskedBatchNorm``'s ``running_mean`` and
  ``running_var`` are the world's means of the ranks' updated statistics
  (``pmean(mutated["batch_stats"])``), while the forward normalises over
  the local batch, as the JAX step does: not ``torch.nn.SyncBatchNorm``,
  which normalises across ranks. ``num_batches_tracked`` stays the
  rank's own count. The optimizer never reads the statistics, so they
  ride the gradients' all-reduce and are written back before the
  optimizer step, which is what averaging them after it gives;
- **random streams**: each rank draws its own dropout masks and ``mask``
  stream draws (:func:`seed_rank_streams`), as ``fold_in(rng,
  axis_index)`` gives each device its own, and rank 0 keeps the
  single-process seeds, so that a world of one equals the run without
  data parallelism bit for bit.

All of a step's sums travel in one all-reduce of one flat buffer per
dtype (:class:`WorldMean`), allocated at the first step and kept: a CUDA
graph that captures the step (``train/graphed.ScanStep``) captures the
all-reduce with it, on the buffer's fixed address. The gradients are
copied into the buffer and back inside the step, so they may live
anywhere (in the graph's pool under capture).

``stack_local_batches`` and ``shard_global_batch`` have no counterpart:
a rank never holds another rank's batch."""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, Iterator, List, Tuple

import torch
import torch.distributed as dist
from torch import nn

from pretrain_gnns_tpu_torch.models.chem import TrunkDropout
from pretrain_gnns_tpu_torch.models.norm import MaskedBatchNorm
from pretrain_gnns_tpu_torch.objectives import losses
from pretrain_gnns_tpu_torch.parallel import multihost
from pretrain_gnns_tpu_torch.train.state import TrainState

# rank r's dropout and mask streams start from the single-process seeds
# plus r times this (above the objectives' MASK_SEED_OFFSET, 1 << 20)
RANK_SEED_STRIDE = 1 << 21


def world_and_rank(group=None) -> Tuple[int, int]:
    """(world size, rank) of ``group`` (default: the default group);
    (1, 0) without a process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def seed_rank_streams(model: nn.Module, rank: int) -> None:
    """Move every random stream of ``model`` (the trunks' dropout
    generators and an objective's ``mask`` stream, each a
    ``TrunkDropout``) to rank ``rank``'s seed: its own seed plus ``rank *
    RANK_SEED_STRIDE``. Rank 0 keeps its streams as they are. Call it
    before the first draw."""
    if rank == 0:
        return
    for m in model.modules():
        if isinstance(m, TrunkDropout):
            m.seed_dropout(m._dropout_seed + rank * RANK_SEED_STRIDE)


def broadcast_state(model: nn.Module, src: int = 0, group=None) -> None:
    """Rank ``src``'s parameters and buffers onto every rank, in place:
    the replicated state the JAX package puts on every device
    (``put_replicated``)."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=src, group=group)


class WorldMean:
    """The all-reduce of one data-parallel step of ``model``: after the
    backward, ``__call__(loss, metrics)`` replaces every parameter's
    gradient and every ``MaskedBatchNorm``'s running statistics by their
    means over the world and returns the world's mean loss and metrics
    (fresh tensors, in their own dtypes). One flat buffer a dtype, made at
    the first call with a view of it for each tensor and kept (a fixed
    address), holds all of them for one ``all_reduce`` (sum) and one
    division by the world size: the tensors go in and come back by one
    multi-tensor copy each. A gradient that is None adds zeros and stays
    None. ``calls`` counts the collectives launched from Python (a replay
    of a captured step launches its own and counts nothing)."""

    def __init__(self, model: nn.Module, group=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.stats = [t for m in model.modules()
                      if isinstance(m, MaskedBatchNorm)
                      for t in (m.running_mean, m.running_var)]
        # per dtype: (buffer, the indices of its tensors, their views)
        self.plan: List[Tuple[torch.Tensor, List[int], List[torch.Tensor]]]
        self.plan = []
        self.calls = 0

    @property
    def buffers(self) -> List[torch.Tensor]:
        return [buf for buf, _, _ in self.plan]

    def _make_plan(self, parts: List[torch.Tensor]) -> None:
        groups: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(parts):
            groups.setdefault(t.dtype, []).append(i)
        for dtype, idx in groups.items():
            n = sum(parts[i].numel() for i in idx)
            buf = torch.empty(n, dtype=dtype, device=parts[idx[0]].device)
            views, off = [], 0
            for i in idx:
                views.append(buf[off:off + parts[i].numel()].view_as(
                    parts[i]))
                off += parts[i].numel()
            self.plan.append((buf, idx, views))

    def __call__(self, loss: torch.Tensor,
                 metrics: Dict[str, torch.Tensor]):
        values = [loss, *metrics.values()]
        grads = [p.grad for p in self.params]
        parts = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, self.params)]
        parts += self.stats
        parts += [v.reshape(1).to(torch.float32) for v in values]
        if not self.plan:
            self._make_plan(parts)
        out: List[torch.Tensor] = [None] * len(parts)
        with torch.no_grad():
            for buf, idx, views in self.plan:
                torch._foreach_copy_(views, [parts[i] for i in idx])
                dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
                buf.div_(self.world)
                self.calls += 1
                for i, v in zip(idx, views):
                    out[i] = v
            n = len(self.params) + len(self.stats)
            keep = [i for i, g in enumerate(grads) if g is not None]
            keep += range(len(self.params), n)
            torch._foreach_copy_([parts[i] for i in keep],
                                 [out[i] for i in keep])
            means = [out[n + j].clone().reshape(v.shape).to(v.dtype)
                     for j, v in enumerate(values)]
        return means[0], dict(zip(metrics, means[1:]))


def make_dp_pretrain_step(model: nn.Module,
                          optimizer: torch.optim.Optimizer, group=None):
    """``step(batch) -> (loss, metrics)``: one data-parallel step of the
    objective ``model`` on this rank's local batch (a ``PackedGraphs`` or
    ``PackedPair`` on the model's device), the world's mean loss and
    metrics returned (the JAX ``make_dp_pretrain_step``): the port's
    ``train.pretrain.step_body`` with the :class:`WorldMean` ``step.sync``
    between its backward and its optimizer step."""
    from pretrain_gnns_tpu_torch.train.pretrain import step_body

    state = TrainState(model, optimizer)
    sync = WorldMean(model, group)

    def step(batch):
        out = step_body(state, batch, sync)
        state.step += 1
        return out

    step.sync = sync
    return step


def make_dp_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                       loss_of: Callable = losses.masked_task_bce,
                       group=None):
    """``step(batch) -> loss``: one data-parallel step of a graph-level
    model (``GNNGraphPred``): ``loss_of(model(batch), batch.y,
    batch.graph_mask)`` on this rank's batch, gradients and statistics
    averaged over the world, the world's mean loss returned (the JAX
    ``make_dp_train_step``)."""
    sync = WorldMean(model, group)

    def step(batch):
        model.train()
        loss = loss_of(model(batch, train=True), batch.y, batch.graph_mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss, _ = sync(loss.detach(), {})
        optimizer.step()
        return loss

    step.sync = sync
    return step


def make_dp_eval_step(model: nn.Module, group=None):
    """``logits(batch) -> [world, ...]``: the eval-mode forward of every
    rank's local batch, gathered in rank order (the JAX
    ``make_dp_eval_step``'s ``out_specs=P(axis)`` stack)."""
    world = dist.get_world_size(group)

    def logits(batch):
        model.eval()
        with torch.no_grad():
            out = model(batch, train=False)
            parts = [torch.empty_like(out) for _ in range(world)]
            dist.all_gather(parts, out.contiguous(), group=group)
        return torch.stack(parts)

    return logits


def own_column(items: Iterable, world: int, rank: int) -> Iterator:
    """``(batch, counts)`` items of consecutive batches (``counts`` a dict
    of ``ThroughputMeter.counts_of``) -> this rank's ``(batch, counts)``
    of each full group of ``world``: batch ``g * world + rank``, with the
    counts summed over the group's ``world`` batches (a data-parallel
    step trains on all of them). A short last group is dropped, as the
    JAX ``grouped`` drops it. Every batch is made, the other ranks' too:
    the host loaders draw their transforms from one generator an epoch,
    in batch order."""
    group = []
    for item in items:
        group.append(item)
        if len(group) == world:
            counts = functools.reduce(
                lambda a, b: {k: a[k] + b[k] for k in a},
                (c for _, c in group))
            yield group[rank][0], counts
            group = []


class RankCheckpoints:
    """A ``train.checkpoints.CheckpointManager`` for a data-parallel run:
    rank 0 writes, then every rank waits at a barrier; every rank
    restores. The ranks' states are equal but for their random streams,
    so a checkpoint also holds every rank's dropout and mask generator
    states (``rank_dropout``), and rank ``r`` resumes its own."""

    def __init__(self, mgr, group=None):
        self.mgr, self.group = mgr, group
        self.world, self.rank = world_and_rank(group)

    def latest_step(self):
        return self.mgr.latest_step()

    def save(self, step: int, state) -> None:
        streams = [None] * self.world
        dist.all_gather_object(streams, state.dropout_states(),
                               group=self.group)
        if self.rank == 0:
            self.mgr.save(step, state, extra={"rank_dropout": streams})
        multihost.sync("checkpoint")

    def restore(self, state, step=None):
        return self.mgr.restore(state, step, rank=self.rank)

    def close(self) -> None:
        self.mgr.close()
