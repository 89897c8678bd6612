"""Pretraining entry (port of ``pretrain_gnns_tpu.train.pretrain`` for
attribute masking, chem ``MaskingObjective`` and bio
``BioMaskEdgeObjective``, for edge prediction, ``EdgePredObjective`` on
either trunk, for Deep Graph Infomax, ``InfomaxObjective`` on either
trunk, and for supervised pretraining, ``SupervisedObjective`` with the
domain's graph-level head).

The loop follows the reference's {chem,bio}/pretrain_{masking,edgepred,
deepgraphinfomax}.py: a seeded model, one Adam over every parameter,
shuffled batches of ``batch_size`` graphs with the objective's transform
(masking or negative sampling; none for infomax and the supervised
objective, whose batches carry the labels ``y``) applied per batch, the
trunk saved at the end. The loader is ``data.packing.make_loader``'s: the
flat dataset and the C++ packer (``data.flat.FlatLoader``) when the graphs
flatten. Packing and the transform run in a prefetch thread while the GPU
runs the previous step; the loss is read back once per epoch."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import Graph
from pretrain_gnns_tpu_torch.data.batch_transforms import (
    BatchMaskAtom, BatchMaskEdge, BatchNegativeEdge, NativeNegativeEdge,
)
from pretrain_gnns_tpu_torch.data.packing import (
    buffer_sizes, choose_blocks, make_loader,
)
from pretrain_gnns_tpu_torch.data.prefetch import prefetch
from pretrain_gnns_tpu_torch.device import resolve_device
from pretrain_gnns_tpu_torch.models import bio as bio_models
from pretrain_gnns_tpu_torch.models.inits import init_parameters
from pretrain_gnns_tpu_torch.objectives.edgepred import EdgePredObjective
from pretrain_gnns_tpu_torch.objectives.infomax import InfomaxObjective
from pretrain_gnns_tpu_torch.objectives.masking import (
    BioMaskEdgeObjective, MaskingObjective,
)
from pretrain_gnns_tpu_torch.objectives.supervised import SupervisedObjective
from pretrain_gnns_tpu_torch.train import optim
from pretrain_gnns_tpu_torch.train.state import TrainState
from pretrain_gnns_tpu_torch.train.telemetry import ThroughputMeter


@dataclasses.dataclass
class PretrainConfig:
    """The masking, edge-prediction, infomax and supervised subset of the
    JAX package's ``PretrainConfig``."""

    objective: str = "masking"
    domain: str = "chem"
    num_layer: int = 5
    emb_dim: int = 300
    jk: str = "last"
    dropout_ratio: float = 0.0
    gnn_type: str = "gin"
    lr: float = 1e-3
    decay: float = 0.0
    batch_size: int = 256
    epochs: int = 100
    seed: int = 0
    mask_rate: float = 0.15
    mask_edge: bool = True
    num_atom_type: int = 119
    num_edge_type: int = 5
    # supervised: the width of the labels y and the head's readout
    num_tasks: int = 1
    graph_pooling: str = "mean"
    # batch layout: auto = block-diagonal (what the kernels take) on CUDA
    packing: str = "auto"  # auto | standard | blocked


PORTED_OBJECTIVES = ("masking", "edgepred", "infomax", "supervised")


def _check_ported(cfg: PretrainConfig) -> None:
    if (cfg.objective not in PORTED_OBJECTIVES
            or cfg.domain not in ("chem", "bio")):
        raise NotImplementedError(
            f"objective={cfg.objective!r} domain={cfg.domain!r} is not "
            "ported; this port runs masking, edgepred, infomax and "
            "supervised in the chem and bio domains"
        )


def build_objective(cfg: PretrainConfig) -> nn.Module:
    """The objective module, its weights drawn from ``cfg.seed`` on the
    CPU (so the seed fixes them whatever the device) and its trunk's
    dropout masks seeded from it too."""
    _check_ported(cfg)
    common = dict(num_layer=cfg.num_layer, emb_dim=cfg.emb_dim, jk=cfg.jk,
                  drop_ratio=cfg.dropout_ratio, gnn_type=cfg.gnn_type)
    if cfg.objective == "supervised":
        model = SupervisedObjective(
            num_tasks=cfg.num_tasks, graph_pooling=cfg.graph_pooling,
            domain=cfg.domain, **common)
    elif cfg.objective in ("edgepred", "infomax"):
        cls = (EdgePredObjective if cfg.objective == "edgepred"
               else InfomaxObjective)
        model = (cls(**common, trunk=bio_models.GNN) if cfg.domain == "bio"
                 else cls(**common))
    elif cfg.domain == "bio":
        model = BioMaskEdgeObjective(**common)
    else:
        model = MaskingObjective(mask_edge=cfg.mask_edge, **common)
    gen = torch.Generator().manual_seed(cfg.seed)
    init_parameters(model, gen)
    if cfg.objective == "infomax":
        model.reset_discriminator(gen)  # after the trunk's draws
    model.gnn.seed_dropout(cfg.seed)
    return model


def build_loader(cfg: PretrainConfig, graphs: Sequence[Graph],
                 device: torch.device, drop_last: bool = True):
    """``data.packing.make_loader``'s loader (a ``FlatLoader`` when the
    graphs flatten, else a ``PackedLoader``) with the objective's
    vectorized pass applied to each batch: masking (``BatchMaskAtom`` for
    chem, ``BatchMaskEdge`` for bio) or negative sampling for edge
    prediction, where the batch's layout picks the sampler: a blocked
    batch gets the C++ sampler's block-aligned pairs
    (``NativeNegativeEdge``), which the pair-dot kernel takes, a standard
    one the compact ``BatchNegativeEdge``. Infomax and the supervised
    objective have no transform; supervised batches carry the graphs'
    labels ``y [G, T]`` (see :func:`supervised_graphs` for bio)."""
    _check_ported(cfg)
    mn, me = buffer_sizes(graphs, cfg.batch_size)
    blocks = choose_blocks(graphs, cfg.batch_size, cfg.packing, device)
    if blocks is not None:
        n_blocks, bn, be = blocks
        mn, me = n_blocks * bn, n_blocks * be
    # bio graphs carry a per-graph center_node_idx (a node index)
    extra_pad = ({"center_node_idx": cfg.batch_size}
                 if cfg.domain == "bio" else None)
    if cfg.objective in ("infomax", "supervised"):
        post = None
    elif cfg.objective == "edgepred":
        post = (NativeNegativeEdge() if blocks is not None
                else BatchNegativeEdge(edge_budget=me // 2))
    elif cfg.domain == "bio":
        post = BatchMaskEdge(
            cfg.mask_rate,
            budget=int(me // 2 * cfg.mask_rate) + cfg.batch_size + 8)
    else:
        post = BatchMaskAtom(
            num_atom_type=cfg.num_atom_type,
            num_edge_type=cfg.num_edge_type, mask_rate=cfg.mask_rate,
            mask_edge=cfg.mask_edge,
            node_budget=int(mn * cfg.mask_rate) + cfg.batch_size + 8,
            edge_budget=me // 2,
        )
    return make_loader(graphs, cfg.batch_size, mn, me, seed=cfg.seed,
                       extra_pad=extra_pad, blocks=blocks,
                       drop_last=drop_last, post_transform=post)


def supervised_graphs(graphs: Sequence[Graph], domain: str):
    """The graphs of the supervised objective and the width of their
    labels. Chem graphs carry their {-1, 0, +1} task labels in ``y``
    already. A bio graph's ``y`` is the downstream target: the pretraining
    labels are its ``go_target_pretrain`` extra, which moves into ``y``,
    and of the extras only ``center_node_idx`` stays, which the head
    reads."""
    if domain == "bio":
        graphs = [
            dataclasses.replace(
                g, y=np.asarray(g.extras["go_target_pretrain"][0],
                                np.float32),
                extras={"center_node_idx": g.extras["center_node_idx"]})
            for g in graphs
        ]
    return graphs, int(np.asarray(graphs[0].y).shape[0])


def train_step(state: TrainState, batch):
    """One forward, backward and optimizer step; returns the detached loss
    and metrics (no host synchronisation)."""
    loss, metrics = state.model(batch, train=True)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def run_pretrain(
    cfg: PretrainConfig,
    graphs: Sequence[Graph],
    log: Optional[Callable[[str], None]] = print,
    epochs: Optional[int] = None,
    device=None,
) -> Dict[str, Any]:
    """Train ``cfg.objective`` in ``cfg.domain``. ``device`` defaults
    to ``"cuda"``; without CUDA that raises ``RuntimeError`` unless
    ``device="cpu"``.
    History rows: ``epoch``, ``loss`` and the metrics (means over the
    epoch's steps), ``edges`` (valid edges, each directed edge once per
    step) and ``steps``."""
    dev = resolve_device(device)
    model = build_objective(cfg).to(dev)
    loader = build_loader(cfg, graphs, dev)
    state = TrainState(model, optim.adam(model.parameters(), cfg.lr,
                                         cfg.decay))
    meter = ThroughputMeter()

    pin = dev.type == "cuda"

    def batches():  # runs on the prefetch thread
        for b in loader:
            # page-locked leaves make the copy to the card asynchronous:
            # the host goes on launching while the previous step runs
            yield (b.pin_memory() if pin else b,
                   ThroughputMeter.counts_of(b))

    history = []
    for epoch in range(1, (epochs or cfg.epochs) + 1):
        meter.reset()
        losses, agg = [], {}
        for batch, counts in prefetch(batches(), depth=2):
            loss, metrics = train_step(state, batch.to(dev, non_blocking=pin))
            losses.append(loss)
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
            meter.tick(**counts)
        nb = max(len(losses), 1)
        row = {"epoch": epoch,
               "loss": float(torch.stack(losses).sum()) / nb if losses
               else 0.0}
        row.update({k: float(torch.stack(v).sum()) / nb
                    for k, v in agg.items()})
        row["edges"] = meter.edges
        row["steps"] = meter.steps
        history.append(row)
        if log:
            if epoch == 1:
                st = loader.last_epoch_stats
                log(f"loader: {type(loader).__name__}, {st['batches']} "
                    "batches, "
                    f"{st['graphs_per_batch']:.1f} graphs/batch "
                    f"(batch_size={cfg.batch_size}, blocks={loader.blocks})")
            log(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                         f"{k}={v}" for k, v in row.items())
                + f" edges/s={meter.edges_per_sec():.1f}")
    return {"state": state, "model": model, "history": history,
            "loader": loader}
