"""Pretraining entry (port of ``pretrain_gnns_tpu.train.pretrain`` for
attribute masking, chem ``MaskingObjective`` and bio
``BioMaskEdgeObjective``, for edge prediction, ``EdgePredObjective`` on
either trunk, for Deep Graph Infomax, ``InfomaxObjective`` on either
trunk, for supervised pretraining, ``SupervisedObjective`` with the
domain's graph-level head, and for context prediction,
``ContextPredObjective``'s two trunks on ``PackedPair`` batches of
presampled pairs, ``data.context_loader``).

The loop follows the reference's {chem,bio}/pretrain_{masking,edgepred,
deepgraphinfomax}.py: a seeded model, one Adam over every parameter,
shuffled batches of ``batch_size`` graphs with the objective's transform
(masking or negative sampling; none for infomax and the supervised
objective, whose batches carry the labels ``y``) applied per batch, the
trunk saved at the end (and, with ``pretrained_trunk``, a trunk loaded
at the start: :func:`graft_trunk` at :func:`trunk_path`). The loader is
``data.packing.make_loader``'s: the flat dataset and the C++ packer
(``data.flat.FlatLoader``) when the graphs flatten. Packing and the
transform run in a prefetch thread, one for the run, while the GPU runs
the previous steps; the loss is read back once per epoch. With
``scan_steps`` K > 1 (the default on CUDA, 16) each group of K consecutive
batches of an epoch is one CUDA-graph replay of K train steps
(``train/graphed.py``), as the JAX package's ``make_scan_pretrain_step``
runs K steps in one ``lax.scan`` dispatch."""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import Graph
from pretrain_gnns_tpu_torch.data import transforms
from pretrain_gnns_tpu_torch.data.batch_transforms import (
    BatchMaskAtom, BatchMaskEdge, BatchNegativeEdge, NativeNegativeEdge,
)
from pretrain_gnns_tpu_torch.data.context_loader import (
    ContextPairs, PresampledContextLoader,
)
from pretrain_gnns_tpu_torch.data.packing import (
    buffer_sizes, choose_blocks, make_loader,
)
from pretrain_gnns_tpu_torch.data.prefetch import chunked, prefetch
from pretrain_gnns_tpu_torch.device import resolve_device
from pretrain_gnns_tpu_torch.models import bio as bio_models
from pretrain_gnns_tpu_torch.models.inits import init_parameters
from pretrain_gnns_tpu_torch.objectives.contextpred import (
    ContextPredObjective,
)
from pretrain_gnns_tpu_torch.objectives.edgepred import EdgePredObjective
from pretrain_gnns_tpu_torch.objectives.infomax import InfomaxObjective
from pretrain_gnns_tpu_torch.objectives.masking import (
    BioMaskEdgeObjective, MaskingObjective,
)
from pretrain_gnns_tpu_torch.objectives import supervised
from pretrain_gnns_tpu_torch.objectives.supervised import SupervisedObjective
from pretrain_gnns_tpu_torch.train import checkpoints, graphed, optim
from pretrain_gnns_tpu_torch.train.state import TrainState
from pretrain_gnns_tpu_torch.train.telemetry import ThroughputMeter


@dataclasses.dataclass
class PretrainConfig:
    """The masking, edge-prediction, infomax, supervised and
    context-prediction subset of the JAX package's ``PretrainConfig``."""

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
    # contextpred: the context trunk's depth (chem; bio's is 3), cbow or
    # skipgram, negatives a positive, the pooling of cbow's overlap rows
    csize: int = 3
    mode: str = "cbow"
    neg_samples: int = 1
    context_pooling: str = "mean"
    # bio contextpred: the context lies outside the l1-hop ball around the
    # centre node (a random node without center)
    l1: int = 1
    center: bool = True
    # presampled (root, context) draws a graph, cycled by epoch
    # (data/context_loader.ContextPairs)
    context_variants: int = 8
    # batch layout: auto = block-diagonal (what the kernels take) on CUDA
    packing: str = "auto"  # auto | standard | blocked
    # train steps a dispatch: one CUDA-graph replay runs this many steps
    # (0 = auto: 16 on CUDA, 1 on the CPU; see resolve_scan_steps)
    scan_steps: int = 0


PORTED_OBJECTIVES = ("masking", "edgepred", "infomax", "supervised",
                     "contextpred")


def _check_ported(cfg: PretrainConfig) -> None:
    if (cfg.objective not in PORTED_OBJECTIVES
            or cfg.domain not in ("chem", "bio")):
        raise NotImplementedError(
            f"objective={cfg.objective!r} domain={cfg.domain!r} is not "
            "ported; this port runs masking, edgepred, infomax, "
            "supervised and contextpred in the chem and bio domains"
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
    elif cfg.objective == "contextpred":
        # bio's context trunk has 3 layers (bio/pretrain_contextpred.py)
        model = ContextPredObjective(
            csize=3 if cfg.domain == "bio" else cfg.csize, mode=cfg.mode,
            neg_samples=cfg.neg_samples,
            context_pooling=cfg.context_pooling, **common,
            **({"trunk": bio_models.GNN} if cfg.domain == "bio" else {}))
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
    if cfg.objective == "contextpred":
        model.gnn_substruct.seed_dropout(cfg.seed)
        model.gnn_context.seed_dropout(cfg.seed + 1)
    else:
        model.gnn.seed_dropout(cfg.seed)
    return model


def context_transform(cfg: PretrainConfig):
    """The domain's context extraction: chem's substructure is the
    ``num_layer``-hop ball and its context the ring between ``num_layer -
    1`` and ``num_layer - 1 + csize`` hops; bio's substructure is the whole
    ego-network and its context lies outside the ``l1``-hop ball."""
    if cfg.domain == "bio":
        return transforms.BioExtractSubstructureContextPair(cfg.l1,
                                                            cfg.center)
    l1 = cfg.num_layer - 1
    return transforms.ExtractSubstructureContextPair(cfg.num_layer, l1,
                                                     l1 + cfg.csize)


def presample_context(cfg: PretrainConfig,
                      graphs: Sequence[Graph]) -> ContextPairs:
    """The presampled context pairs of ``graphs`` under ``cfg`` (its
    transform, seed and ``context_variants``): what :func:`build_loader`
    and :func:`run_pretrain` take in place of the graphs, so that several
    runs share one presampling."""
    return ContextPairs(graphs, context_transform(cfg), cfg.seed,
                        cfg.context_variants)


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
    labels ``y [G, T]`` (see :func:`supervised_graphs` for bio).

    Context prediction gets a ``PresampledContextLoader`` of ``PackedPair``
    batches: ``graphs`` may be the graphs or their
    :func:`presample_context`. Where ``choose_blocks`` would block, each
    stream gets its own block geometry and the joint first-fit walk
    (``native.plan_pair_epoch``); else both streams take the standard
    layout's buffers."""
    _check_ported(cfg)
    if cfg.objective == "contextpred":
        pairs = (graphs if isinstance(graphs, ContextPairs)
                 else presample_context(cfg, graphs))
        mn, me = buffer_sizes(pairs.graphs, cfg.batch_size)
        blocked = choose_blocks(pairs.graphs, cfg.batch_size, cfg.packing,
                                device) is not None
        return PresampledContextLoader(
            pairs, cfg.batch_size, context_transform(cfg), mn, me,
            seed=cfg.seed, drop_last=drop_last,
            variants=cfg.context_variants, blocked=blocked)
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


def step_body(state: TrainState, batch):
    """One forward, backward and optimizer step, not counted in
    ``state.step``, on a ``PackedGraphs`` or, for context prediction, a
    ``PackedPair``; returns the detached loss and metrics (no host
    synchronisation). What a CUDA graph captures K times."""
    loss, metrics = state.model(batch, train=True)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def train_step(state: TrainState, batch):
    """One train step (:func:`step_body`), counted in ``state.step``."""
    out = step_body(state, batch)
    state.step += 1
    return out


def resolve_scan_steps(scan_steps: int, device) -> int:
    """Train steps a dispatch: a positive ``scan_steps`` stands; 0 means 16
    on CUDA and 1 on the CPU, as the JAX package's ``resolve_scan_steps``
    means 16 on an accelerator and 1 on the CPU."""
    if scan_steps < 0:
        raise ValueError(f"scan_steps must be >= 0, got {scan_steps}")
    if scan_steps > 0:
        return scan_steps
    return 16 if torch.device(device).type == "cuda" else 1


def make_scan_pretrain_step(state: TrainState, example_batch,
                            k: int) -> graphed.ScanStep:
    """K train steps a call on K batches with ``example_batch``'s leaf
    shapes and dtypes (a ``graphed.ScanStep`` on the parameters' device):
    on CUDA one replay of a graph that captures the K steps at the first
    call, after at least one eager ``.step(batch)``; on the CPU the K steps
    in turn. A call returns the losses ``[K]`` and metrics ``{name: [K]}``;
    a batch of another signature raises ``ValueError``."""
    dev = next(state.model.parameters()).device
    return graphed.ScanStep(state, example_batch, k, step_body, dev)


def _run_batches(loader, epochs: int, k: int, pin: bool):
    """The run's batches, made on the prefetch thread, one for the whole
    run (an epoch's end does not drain the queue), each with its counts
    and, for the card, pinned: ``("group", [k items])`` for one call of
    the ``ScanStep``, ``("step", item)`` for one eager step (the run's
    first ``graphed.WARMUP_STEPS`` batches and each epoch's short tail,
    every batch when ``k`` is 1), and ``("end", stats)`` after each epoch,
    with the loader's statistics of that epoch. A batch is a
    ``PackedGraphs`` or, for context prediction, a ``PackedPair``: both
    pin and count alike (both streams' edges)."""
    warm = graphed.WARMUP_STEPS if k > 1 else 0
    for _ in range(epochs):
        items = ((b.pin_memory() if pin else b,
                  ThroughputMeter.counts_of(b)) for b in loader)
        for item in itertools.islice(items, warm):
            warm -= 1
            yield "step", item
        for group in chunked(items, k):
            if k > 1 and len(group) == k:
                yield "group", group
            else:
                for item in group:
                    yield "step", item
        yield "end", dict(loader.last_epoch_stats)


def run_pretrain(
    cfg: PretrainConfig,
    graphs: Sequence[Graph],
    log: Optional[Callable[[str], None]] = print,
    epochs: Optional[int] = None,
    device=None,
    pretrained_trunk: Optional[Mapping[str, torch.Tensor]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
) -> Dict[str, Any]:
    """Train ``cfg.objective`` in ``cfg.domain``. ``device`` defaults
    to ``"cuda"``; without CUDA that raises ``RuntimeError`` unless
    ``device="cpu"``. For context prediction ``graphs`` may be the
    graphs' :func:`presample_context`. ``pretrained_trunk``, a reference
    trunk's state dict (``train.checkpoints.load_trunk_any``), replaces
    the seeded trunk at :func:`trunk_path` before the first step, the
    heads keeping their seeded draws: the reference's two stages,
    self-supervised then supervised (chem/pretrain_supervised.py:132-133).
    With ``checkpoint_dir``, the whole train state is saved there
    (``train.checkpoints.CheckpointManager``) every ``checkpoint_every``
    epochs (0: none but the last) and at the end, and a run resumes from
    the latest checkpoint there, restored before the first step: it logs
    ``resumed from step S (epoch E)`` and trains epochs ``E..epochs``. The
    loader then starts at pass E - 1, so that the resumed epochs see the
    order, the transforms' draws and the context variants of an
    uninterrupted run (which the JAX package's resume does not), and the
    run equals the uninterrupted one bit for bit wherever its steps repeat.
    History rows: ``epoch``, ``loss`` and the metrics (means over the
    epoch's steps), ``edges`` (valid edges, each directed edge once per
    step) and ``steps``, one for each epoch this call trained. The result
    also names ``scan_steps`` (the resolved K), the run's ``replays``, its
    ``eager_steps`` and ``start_epoch``."""
    dev = resolve_device(device)
    k = resolve_scan_steps(cfg.scan_steps, dev)
    model = build_objective(cfg)
    if pretrained_trunk is not None:
        graft_trunk(model, pretrained_trunk, trunk_path(cfg))
    model = model.to(dev)
    loader = build_loader(cfg, graphs, dev)
    state = TrainState(model, optim.adam(model.parameters(), cfg.lr,
                                         cfg.decay))
    # restore before the first step: a capture holds the optimizer's state
    # tensors by address
    mgr, start = None, 1
    if checkpoint_dir:
        mgr = checkpoints.CheckpointManager(checkpoint_dir)
        latest = mgr.latest_step()
        if latest is not None:
            mgr.restore(state, latest)
            start = state.epoch + 1
            if log:
                log(f"resumed from step {latest} (epoch {start})")
    loader.set_epoch(start - 1)
    first_step = state.step
    meter = ThroughputMeter()
    pin = dev.type == "cuda"
    n_epochs = epochs or cfg.epochs
    batches = prefetch(_run_batches(loader, max(n_epochs - start + 1, 0), k,
                                    pin), depth=2)
    scan = None

    history = []
    for epoch in range(start, n_epochs + 1):
        meter.reset()
        parts, agg = [], {}
        replays = eager = 0
        for kind, item in batches:
            if kind == "end":
                stats = item
                break
            if k > 1 and scan is None:
                first = item[0][0] if kind == "group" else item[0]
                scan = make_scan_pretrain_step(state, first, k)
            if kind == "group":
                loss, metrics = scan([b for b, _ in item])
                replays += 1
            else:
                batch, counts = item
                item = [item]
                loss, metrics = (
                    scan.step(batch) if scan is not None
                    else train_step(state, batch.to(dev, non_blocking=pin)))
                eager += 1
            # each step's loss and metrics in order: the epoch's mean sums
            # one vector, whatever the grouping
            parts.append(loss.reshape(-1))
            for key, v in metrics.items():
                agg.setdefault(key, []).append(v.reshape(-1))
            for _, counts in item:
                meter.tick(**counts)
        nb = max(meter.steps, 1)
        row = {"epoch": epoch,
               "loss": float(torch.cat(parts).sum()) / nb if parts
               else 0.0}
        row.update({key: float(torch.cat(v).sum()) / nb
                    for key, v in agg.items()})
        row["edges"] = meter.edges
        row["steps"] = meter.steps
        history.append(row)
        if log:
            if epoch == start:
                log(f"loader: {type(loader).__name__}, {stats['batches']} "
                    "batches, "
                    f"{stats['graphs_per_batch']:.1f} graphs/batch "
                    f"(batch_size={cfg.batch_size}, blocks={loader.blocks}); "
                    f"{k} steps/dispatch "
                    + ("(CUDA-graph replays)" if k > 1 and pin else
                       "(steps in turn)" if k > 1 else "(eager steps)"))
            log(" ".join(f"{key}={v:.4f}" if isinstance(v, float) else
                         f"{key}={v}" for key, v in row.items())
                + f" edges/s={meter.edges_per_sec():.1f}"
                f" replays={replays} eager_steps={eager}")
        state.epoch = epoch
        if mgr and checkpoint_every and epoch % checkpoint_every == 0:
            mgr.save(state.step, state)
    if mgr:
        if mgr.latest_step() != state.step:
            mgr.save(state.step, state)
        mgr.close()
    return {"state": state, "model": model, "history": history,
            "loader": loader, "scan_steps": k,
            "replays": scan.replays if scan else 0,
            "eager_steps": (scan.eager_steps if scan
                            else state.step - first_step),
            "start_epoch": start}


def trunk_path(cfg: PretrainConfig) -> Tuple[str, ...]:
    """Where the objective keeps its trunk: ``pred.gnn`` (supervised),
    ``gnn_substruct`` (context prediction) or ``gnn``."""
    if cfg.objective == "supervised":
        return supervised.TRUNK_PATH
    if cfg.objective == "contextpred":
        return ("gnn_substruct",)
    return ("gnn",)


def trunk_module(model: nn.Module, path: Sequence[str]) -> nn.Module:
    """The submodule of ``model`` at ``path``."""
    return functools.reduce(getattr, path, model)


def graft_trunk(model: nn.Module, trunk: Mapping[str, torch.Tensor],
                path: Sequence[str]) -> nn.Module:
    """Load the reference trunk state dict ``trunk`` into ``model``'s
    submodule at ``path`` (``load_state_dict(strict=True)``, a missing
    ``num_batches_tracked`` read as 0); every other parameter keeps its
    value: the reference's checkpoint contract, heads freshly drawn.
    Returns ``model``."""
    checkpoints.graft(trunk_module(model, path), trunk)
    return model
