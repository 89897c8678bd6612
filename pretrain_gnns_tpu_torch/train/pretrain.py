"""Pretraining entry (port of ``pretrain_gnns_tpu.train.pretrain`` for
attribute masking, chem ``MaskingObjective`` and bio
``BioMaskEdgeObjective``, for edge prediction, ``EdgePredObjective`` on
either trunk, for Deep Graph Infomax, ``InfomaxObjective`` on either
trunk, for supervised pretraining, ``SupervisedObjective`` with the
domain's graph-level head, and for context prediction,
``ContextPredObjective``'s two trunks on ``PackedPair`` batches of
presampled pairs, ``data.context_loader``), with the device-resident
dataset (``device_dataset``, ``data.device_pack``) and its epoch trainer
(:func:`run_epoch_mode`).

The loop follows the reference's {chem,bio}/pretrain_{masking,edgepred,
deepgraphinfomax}.py: a seeded model, one Adam over every parameter,
shuffled batches of ``batch_size`` graphs with the objective's transform
(masking or negative sampling; none for infomax and the supervised
objective, whose batches carry the labels ``y``) applied per batch, the
trunk saved at the end (and, with ``pretrained_trunk``, a trunk loaded
at the start: :func:`graft_trunk` at :func:`trunk_path`). The loader is
``data.packing.make_loader``'s: the flat dataset and the C++ packer
(``data.flat.FlatLoader``) when the graphs flatten; under
``transform_device="host"`` the reference's per-graph transforms run in a
``PackedLoader`` instead (:func:`build_loader`). Packing and the
transform run in a prefetch thread, one for the run, while the GPU runs
the previous steps; the loss is read back once per epoch. With
``scan_steps`` K > 1 (the default on CUDA, 16) each group of K consecutive
batches of an epoch is one CUDA-graph replay of K train steps
(``train/graphed.py``), as the JAX package's ``make_scan_pretrain_step``
runs K steps in one ``lax.scan`` dispatch.

With the device-resident dataset (:func:`use_device_dataset`) the loader
yields descriptors of a few kilobytes, and each step builds its batch on
the device from one first (``loader.prepare``), in an eager step and in a
captured group of K steps alike. With K > 1 such a run takes the epoch
trainer (:func:`run_epoch_mode`, the JAX ``_run_epoch_mode``): a group of
epochs' descriptors stacked on the prefetch thread, one copy to the
device, the group's steps run from slices of it."""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import Graph
from pretrain_gnns_tpu_torch.data import transforms
from pretrain_gnns_tpu_torch.data.batch_transforms import (
    BatchMaskAtom, BatchMaskEdge, BatchNegativeEdge, BlockAlignNegatives,
    NativeNegativeEdge,
)
from pretrain_gnns_tpu_torch.data.context_loader import (
    ContextPairLoader, ContextPairs, DeviceContextLoader,
    PresampledContextLoader,
)
from pretrain_gnns_tpu_torch.data.device_pack import (
    DeviceBatchLoader, Descriptor, EpochStackMixin,
)
from pretrain_gnns_tpu_torch.data.flat import FlatGraphs
from pretrain_gnns_tpu_torch.data.packing import (
    PackedLoader, buffer_sizes, choose_blocks, make_loader,
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
    BioMaskEdgeObjective, FusedMaskingObjective, MaskingObjective,
)
from pretrain_gnns_tpu_torch.objectives import supervised
from pretrain_gnns_tpu_torch.objectives.supervised import SupervisedObjective
from pretrain_gnns_tpu_torch.train import checkpoints, graphed, optim
from pretrain_gnns_tpu_torch.train.state import TrainState
from pretrain_gnns_tpu_torch.train.telemetry import (
    Mark, ThroughputMeter, seconds_between,
)


@dataclasses.dataclass
class PretrainConfig:
    """The masking, edge-prediction, infomax, supervised and
    context-prediction subset of the JAX package's ``PretrainConfig``,
    with ``transform_device`` (where the transforms run; see
    :func:`build_loader`)."""

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
    # where the SSL transforms run (the JAX package's choices):
    #   "host"   per graph in the loader, the reference's placement
    #            (MaskAtom, MaskEdge, NegativeEdge, ContextPairLoader)
    #   "batch"  one vectorized pass over each packed batch
    #            (data/batch_transforms.py); for context prediction the
    #            presampled pairs
    #   "device" inside the step: chem masking (FusedMaskingObjective)
    #            and, on the device-resident dataset, edge prediction's
    #            negatives (objectives/edgepred.sample_negative_edges);
    #            elsewhere read as "batch"
    #   "auto"   "batch" for chem masking; see masking_mode
    transform_device: str = "auto"
    # the whole dataset resident on the device, each batch built there from
    # a descriptor (data/device_pack.py): "on", "off", or "auto"
    # (use_device_dataset)
    device_dataset: str = "auto"
    # epochs a group of the epoch trainer (one copy of their descriptors);
    # 0 = auto (resolve_epoch_group)
    epoch_group: int = 0


PORTED_OBJECTIVES = ("masking", "edgepred", "infomax", "supervised",
                     "contextpred")
TRANSFORM_DEVICES = ("auto", "host", "batch", "device")
DEVICE_DATASETS = ("auto", "on", "off")
# the objectives the device-resident loaders cover, by domain (the JAX
# use_device_dataset's)
DEVICE_DATASET_OBJECTIVES = {
    "chem": ("masking", "infomax", "edgepred", "contextpred", "supervised"),
    "bio": ("masking", "edgepred", "infomax", "contextpred", "supervised"),
}


def masking_mode(cfg: PretrainConfig) -> str:
    """The chem masking transform's placement, as the JAX package's
    ``masking_mode`` resolves it: ``transform_device`` with "auto" read as
    "batch"; every other objective and domain reads "host" here, and
    :func:`build_loader` tests ``transform_device == "host"`` itself
    there, as the JAX ``build_loader`` does."""
    if cfg.objective != "masking" or cfg.domain != "chem":
        return "host"
    mode = cfg.transform_device
    return "batch" if mode == "auto" else mode


def use_device_dataset(cfg: PretrainConfig, device) -> bool:
    """Whether the run keeps its dataset on the device (the JAX
    ``use_device_dataset``; its data-parallel branch waits for the port's
    data parallelism): never with "off" or under ``transform_device=
    "host"``, whose transforms run per graph in the loader; for the
    objectives the device-resident loaders cover, with "on", and with
    "auto" on CUDA: chem and bio masking GIN at full width ran at least
    as fast with it as without on the H100, in float32 and at the knobs'
    defaults (PERF.md, scripts/torch_port_objective_bench.py with
    DEVICE_DATASET="off on"). "auto" stays off on the CPU, as the JAX
    package's does."""
    if cfg.device_dataset == "off" or cfg.transform_device == "host":
        return False
    if cfg.objective not in DEVICE_DATASET_OBJECTIVES.get(cfg.domain, ()):
        return False
    if cfg.device_dataset == "on":
        return True
    return torch.device(device).type == "cuda"


def _check_ported(cfg: PretrainConfig) -> None:
    if (cfg.objective not in PORTED_OBJECTIVES
            or cfg.domain not in ("chem", "bio")):
        raise NotImplementedError(
            f"objective={cfg.objective!r} domain={cfg.domain!r} is not "
            "ported; this port runs masking, edgepred, infomax, "
            "supervised and contextpred in the chem and bio domains"
        )
    if cfg.transform_device not in TRANSFORM_DEVICES:
        raise ValueError(f"transform_device={cfg.transform_device!r}: "
                         f"one of {TRANSFORM_DEVICES}")
    if cfg.device_dataset not in DEVICE_DATASETS:
        raise ValueError(f"device_dataset={cfg.device_dataset!r}: "
                         f"one of {DEVICE_DATASETS}")


# the objective's mask stream (models.chem.MaskStream) starts from the
# run's seed plus this, apart from the trunks' dropout streams
MASK_SEED_OFFSET = 1 << 20


def build_objective(cfg: PretrainConfig) -> nn.Module:
    """The objective module, its weights drawn from ``cfg.seed`` on the
    CPU (so the seed fixes them whatever the device) and its trunk's
    dropout masks and its ``mask`` stream (the draws of
    ``transform_device="device"``) seeded from it too. Chem masking under
    "device" is ``FusedMaskingObjective``, as the JAX ``build_objective``
    builds it."""
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
    elif masking_mode(cfg) == "device":
        model = FusedMaskingObjective(
            mask_edge=cfg.mask_edge, mask_rate=cfg.mask_rate,
            mask_atom_token=cfg.num_atom_type,
            mask_bond_token=cfg.num_edge_type, **common)
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
    if hasattr(model, "seed_masks"):
        model.seed_masks(cfg.seed + MASK_SEED_OFFSET)
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


def _try_device_loader(cfg, graphs, device, blocks, mn, me, drop_last,
                       **specs):
    """A ``DeviceBatchLoader`` of ``graphs`` on ``device`` when the dataset
    flattens with integral features; None, after printing why, where it
    does not (the caller then builds the host loader: nothing falls back
    without saying so)."""
    try:
        if torch.device(device).type == "cuda" and blocks is None:
            raise ValueError("the kernels take blocked batches only")
        return DeviceBatchLoader(
            FlatGraphs.from_graphs(list(graphs)), cfg.batch_size, mn, me,
            seed=cfg.seed, blocks=blocks, drop_last=drop_last,
            device=device, **specs)
    except (ValueError, IndexError) as e:
        print(f"[pretrain] device-resident dataset unavailable ({e}); "
              "using the host packing pipeline", flush=True)
        return None


def build_loader(cfg: PretrainConfig, graphs: Sequence[Graph],
                 device: torch.device, drop_last: bool = True):
    """The objective's loader, as the JAX ``build_loader`` builds it. Where
    ``choose_blocks`` would block (on CUDA), every batch is blocked, the
    layout the kernels take.

    Where :func:`use_device_dataset` holds, a device-resident loader
    (``data.device_pack``) on ``device``, whose descriptors carry the
    host's draws: chem masking's ``mask_spec`` under "batch" (none under
    "device": ``FusedMaskingObjective`` masks in the step), bio masking's
    ``bio_mask_spec``, edge prediction's ``neg_spec`` (none under "device":
    the objective draws them in the step), bio supervised's
    ``center_spec``; context prediction a ``DeviceContextLoader``. A
    dataset that does not flatten falls back to the loaders below, saying
    why.

    Under ``transform_device`` "batch" ("auto"; "device" but for chem
    masking): ``data.packing.make_loader``'s loader (a ``FlatLoader`` when
    the graphs flatten, else a ``PackedLoader``) with the objective's
    vectorized pass applied to each batch: masking (``BatchMaskAtom`` for
    chem, ``BatchMaskEdge`` for bio) or negative sampling for edge
    prediction, where the batch's layout picks the sampler: a blocked
    batch gets the C++ sampler's block-aligned pairs
    (``NativeNegativeEdge``), which the pair-dot kernel takes, a standard
    one the compact ``BatchNegativeEdge``. Chem masking under "device"
    gets clean batches. Context prediction gets a
    ``PresampledContextLoader`` of ``PackedPair`` batches: ``graphs`` may
    be the graphs or their :func:`presample_context`; blocked, each
    stream gets its own block geometry and the joint first-fit walk
    (``native.plan_pair_epoch``).

    Under "host" the reference's per-graph transforms run in the loader,
    a ``PackedLoader(transform=...)``, with the JAX package's budgets:
    ``MaskAtom`` (chem masking), ``MaskEdge`` (bio masking) and
    ``NegativeEdge`` (edge prediction; on a blocked batch
    ``BlockAlignNegatives`` then moves its flat pairs into the
    block-aligned layout, drawing nothing, since the pair-dot kernel takes
    no flat list); context prediction gets a ``ContextPairLoader``, every
    pair drawn anew each epoch, blocked on the graphs' own geometry.

    Infomax and the supervised objective have no transform; supervised
    batches carry the graphs' labels ``y [G, T]`` (see
    :func:`supervised_graphs` for bio)."""
    _check_ported(cfg)
    host = cfg.transform_device == "host"
    on_device = use_device_dataset(cfg, device)
    if cfg.objective == "contextpred":
        pairs = (graphs if isinstance(graphs, ContextPairs) else None)
        graphs = pairs.graphs if pairs is not None else graphs
        mn, me = buffer_sizes(graphs, cfg.batch_size)
        blocks = choose_blocks(graphs, cfg.batch_size, cfg.packing, device)
        if host:
            return ContextPairLoader(
                graphs, cfg.batch_size, context_transform(cfg), mn, me,
                seed=cfg.seed, drop_last=drop_last, blocks=blocks)
        cls, kw = PresampledContextLoader, {}
        if on_device:
            cls, kw = DeviceContextLoader, {"device": device}
        return cls(
            pairs if pairs is not None else presample_context(cfg, graphs),
            cfg.batch_size,
            context_transform(cfg), mn, me, seed=cfg.seed,
            drop_last=drop_last, variants=cfg.context_variants,
            blocked=blocks is not None, **kw)
    mn, me = buffer_sizes(graphs, cfg.batch_size)
    blocks = choose_blocks(graphs, cfg.batch_size, cfg.packing, device)
    if blocks is not None:
        n_blocks, bn, be = blocks
        mn, me = n_blocks * bn, n_blocks * be
    # bio graphs carry a per-graph center_node_idx (a node index)
    base_pad = ({"center_node_idx": cfg.batch_size}
                if cfg.domain == "bio" else {})
    per_graph = dict(seed=cfg.seed, blocks=blocks, drop_last=drop_last)

    def resident(**specs):
        if not on_device:
            return None
        return _try_device_loader(cfg, graphs, device, blocks, mn, me,
                                  drop_last, **specs)

    if cfg.objective in ("infomax", "supervised"):
        dl = resident(center_spec=(cfg.domain == "bio"
                                   and cfg.objective == "supervised"))
        if dl is not None:
            return dl
        post = None
    elif cfg.objective == "edgepred":
        if host:
            return PackedLoader(
                graphs, cfg.batch_size, mn, me,
                transform=transforms.NegativeEdge(),
                extra_pad={"negative_edges": me // 2, **base_pad},
                post_transform=(BlockAlignNegatives() if blocks is not None
                                else None), **per_graph)
        dl = resident(neg_spec=(None if cfg.transform_device == "device"
                                else {"budget": me // 2}))
        if dl is not None:
            return dl
        post = (NativeNegativeEdge() if blocks is not None
                else BatchNegativeEdge(edge_budget=me // 2))
    elif cfg.domain == "bio":
        n_masked = int(me // 2 * cfg.mask_rate) + cfg.batch_size + 8
        if host:
            return PackedLoader(
                graphs, cfg.batch_size, mn, me,
                transform=transforms.MaskEdge(cfg.mask_rate),
                extra_pad={"masked_edge_idx": n_masked,
                           "mask_edge_label": n_masked, **base_pad},
                **per_graph)
        dl = resident(bio_mask_spec={"rate": cfg.mask_rate,
                                     "budget": n_masked})
        if dl is not None:
            return dl
        post = BatchMaskEdge(cfg.mask_rate, budget=n_masked)
    else:
        n_masked = int(mn * cfg.mask_rate) + cfg.batch_size + 8
        mode = masking_mode(cfg)
        if mode == "host":
            return PackedLoader(
                graphs, cfg.batch_size, mn, me,
                transform=transforms.MaskAtom(
                    cfg.num_atom_type, cfg.num_edge_type, cfg.mask_rate,
                    cfg.mask_edge),
                extra_pad={"masked_atom_indices": n_masked,
                           "mask_node_label": n_masked,
                           "connected_edge_indices": me // 2,
                           "mask_edge_label": me // 2},
                **per_graph)
        dl = resident(mask_spec=(
            {"rate": cfg.mask_rate, "mask_edge": cfg.mask_edge,
             "node_budget": n_masked, "edge_budget": me // 2,
             "atom_token": cfg.num_atom_type,
             "bond_token": cfg.num_edge_type}
            if mode == "batch" else None))
        if dl is not None:
            return dl
        post = None if mode == "device" else BatchMaskAtom(
            num_atom_type=cfg.num_atom_type,
            num_edge_type=cfg.num_edge_type, mask_rate=cfg.mask_rate,
            mask_edge=cfg.mask_edge, node_budget=n_masked,
            edge_budget=me // 2,
        )
    return make_loader(graphs, cfg.batch_size, mn, me, seed=cfg.seed,
                       extra_pad=base_pad or None, blocks=blocks,
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
                            k: int, prepare=None) -> graphed.ScanStep:
    """K train steps a call on K batches with ``example_batch``'s leaf
    shapes and dtypes (a ``graphed.ScanStep`` on the parameters' device):
    on CUDA one replay of a graph that captures the K steps at the first
    call, after at least one eager ``.step(batch)``; on the CPU the K steps
    in turn. A call returns the losses ``[K]`` and metrics ``{name: [K]}``;
    a batch of another signature raises ``ValueError``. With ``prepare``
    (a device-resident loader's) the batches are descriptors, and each
    step builds its batch from one first, inside the capture too."""
    dev = next(state.model.parameters()).device
    body = step_body if prepare is None else (
        lambda st, desc: step_body(st, prepare(desc)))
    return graphed.ScanStep(state, example_batch, k, body, dev)


def resolve_epoch_group(epoch_group: int, steps_cap: int, device) -> int:
    """Epochs a group of the epoch trainer: a positive ``epoch_group``
    stands; 0 means 1 on the CPU and on CUDA ``min(8, 256 // steps_cap)``,
    at least 1 (the JAX ``resolve_epoch_group``'s 256 steps a dispatch)."""
    if epoch_group > 0:
        return epoch_group
    if torch.device(device).type != "cuda":
        return 1
    return max(1, min(8, 256 // max(steps_cap, 1)))


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


def _epoch_groups(loader, first: int, last: int, steps_cap: int,
                  group_e: int, pin: bool):
    """The epoch trainer's groups, made on the prefetch thread: for each
    group of ``group_e`` epochs (fewer at the run's end or before an epoch
    without a batch), ``[(epoch, pack)]`` (``epoch_stack``'s pack, with
    ``counts``, each valid step's and each overflow descriptor's, and the
    overflow descriptors as ``Descriptor``s) and its copies to the device:
    ``[(stack, packs)]``, one stack of the group's descriptors padded to
    ``group_e * steps_cap`` steps, or one an epoch where an epoch overflows
    its ``steps_cap`` (the JAX trainer's per-epoch dispatch). An epoch
    without a batch comes alone as ``[(epoch, None)], []``. With ``pin``
    the host arrays are page-locked."""
    def host(d):
        d = Descriptor(d)
        return d.pin_memory() if pin else d

    def emit(group):
        packs = [p for _, p in group]
        for p in packs:
            st = p["stacked"]
            p["counts"] = [Descriptor({k: v[i] for k, v in st.items()})
                           .counts() for i in range(p["n_steps"])]
            p["counts"] += [Descriptor(o).counts() for o in p["overflow"]]
            p["overflow"] = [host(o) for o in p["overflow"]]
        if group_e > 1 and any(p["overflow"] for p in packs):
            return group, [(host(p["stacked"]), [p]) for p in packs]
        stacked = {}
        for key in packs[0]["stacked"]:
            parts = [p["stacked"][key] for p in packs]
            pad = (group_e - len(packs)) * steps_cap
            if pad:  # every group's copy has one shape
                parts.append(np.zeros((pad,) + parts[0].shape[1:],
                                      parts[0].dtype))
            stacked[key] = np.concatenate(parts)
        return group, [(host(stacked), packs)]

    group = []
    for ep in range(first, last + 1):
        pack = loader.epoch_stack(steps_cap=steps_cap)
        if pack is None:
            if group:
                yield emit(group)
                group = []
            yield [(ep, None)], []
            continue
        group.append((ep, pack))
        if len(group) == group_e:
            yield emit(group)
            group = []
    if group:
        yield emit(group)


def run_epoch_mode(state: TrainState, loader, k: int, dev: torch.device,
                   first: int, last: int, group_e: int,
                   log: Optional[Callable[[str], None]] = None,
                   mgr=None, checkpoint_every: int = 0):
    """The epoch trainer (the JAX ``_run_epoch_mode``) over epochs
    ``first..last`` of a device-resident ``loader``, K = ``k`` steps a
    replay: for each group of ``group_e`` epochs (``run_pretrain``'s
    :func:`resolve_epoch_group`, at most ``checkpoint_every``), the
    prefetch thread stacks the epochs'
    descriptors (``loader.epoch_stack`` at ``steps_cap = len(loader)``)
    and one copy, pinned on CUDA, puts them on the device; the group's
    steps then run in order from slices of that buffer, each epoch's
    overflow right after its own steps: the run's first
    ``graphed.WARMUP_STEPS`` steps and each group's short tail eagerly, the
    rest as ``ScanStep`` calls of K (one CUDA-graph replay each on the
    card). Padded steps (``valid`` False) are not launched, which is the
    JAX trainer's masked no-op. A group's per-epoch sums go to the host by
    one copy that is read only after the next group's steps are queued,
    so the card does not drain between groups; a group's ``Mark`` follows
    that copy, and its epochs log edges/s from the previous group's mark
    to its own. Checkpoints fall at group ends.
    The steps are the per-step run's, in its order, so the two runs are
    equal bit for bit where the steps repeat. Returns the history rows (as
    ``run_pretrain``'s), the ``ScanStep`` and the groups' marks."""
    pin = dev.type == "cuda"
    steps_cap = max(len(loader), 1)
    scan = None
    warm = graphed.WARMUP_STEPS
    history, marks, pending = [], [], None
    t0 = time.perf_counter()

    def finalize(group):
        if not group:
            return
        rows, keys, sums, mark = group
        if mark.event is not None:
            mark.event.synchronize()
        i = marks.index(mark)
        took = (seconds_between(marks[i - 1], mark) if i
                else time.perf_counter() - t0)
        rate = sum(r[0]["edges"] for r in rows) / max(took, 1e-9)
        j = 0
        for row, stats, counts in rows:
            nb = max(row["steps"], 1)
            out = {"epoch": row["epoch"], "loss": 0.0}
            if row["steps"]:
                out["loss"] = float(sums[j]) / nb
                out.update({key: float(sums[j + 1 + m]) / nb
                            for m, key in enumerate(keys)})
                j += 1 + len(keys)
            out["edges"], out["steps"] = row["edges"], row["steps"]
            history.append(out)
            if not log:
                continue
            if out["epoch"] == first and stats:
                log(f"loader: {type(loader).__name__}, {stats['batches']} "
                    f"batches, {stats['graphs_per_batch']:.1f} graphs/batch "
                    f"(batch_size={loader.batch_size}, "
                    f"blocks={loader.blocks}); epoch trainer: {steps_cap} "
                    f"steps/epoch, {group_e} epochs/group, {k} "
                    "steps/dispatch " + ("(CUDA-graph replays)" if pin
                                         else "(steps in turn)"))
            log(" ".join(f"{key}={v:.4f}" if isinstance(v, float) else
                         f"{key}={v}" for key, v in out.items())
                + f" edges/s={rate:.1f} replays={counts[0]} "
                f"eager_steps={counts[1]}")

    for epochs, copies in prefetch(
            _epoch_groups(loader, first, last, steps_cap, group_e, pin),
            depth=2):
        seq = []  # (index of the epoch in the group, descriptor, counts)
        e = 0
        for stack, packs in copies:
            buf = stack.to(dev, non_blocking=pin)  # one copy
            for i, pack in enumerate(packs):
                n = pack["n_steps"]
                views = [Descriptor({key: v[i * steps_cap + j]
                                     for key, v in buf.items()})
                         for j in range(n)]
                views += [o.to(dev, non_blocking=pin)
                          for o in pack["overflow"]]
                seq += [(e, d, c) for d, c in zip(views, pack["counts"])]
                e += 1
        parts, agg = [], {}
        tally = [[0, 0] for _ in epochs]  # (replays, eager) an epoch
        i = 0
        while i < len(seq):
            if scan is None:
                scan = make_scan_pretrain_step(state, seq[0][1], k,
                                               loader.prepare)
            if warm > 0 or len(seq) - i < k:
                loss, metrics = scan.step(seq[i][1])
                warm = max(warm - 1, 0)
                tally[seq[i][0]][1] += 1
                n = 1
            else:
                loss, metrics = scan([d for _, d, _ in seq[i:i + k]])
                tally[seq[i][0]][0] += 1
                n = k
            parts.append(loss.reshape(-1))
            for key, v in metrics.items():
                agg.setdefault(key, []).append(v.reshape(-1))
            i += n
        losses = torch.cat(parts) if parts else None
        metrics = {key: torch.cat(v) for key, v in agg.items()}
        rows, sums, start = [], [], 0
        for e, (ep, pack) in enumerate(epochs):
            counts = pack["counts"] if pack is not None else []
            sl = slice(start, start + len(counts))
            start = sl.stop
            if counts:
                # the sums over each epoch's steps' losses and metrics,
                # copied out in order: the vectors the per-step loop sums
                sums += [v[sl].clone().sum()
                         for v in (losses, *metrics.values())]
            rows.append(({"epoch": ep,
                          "edges": sum(c["edges"] for c in counts),
                          "steps": len(counts)},
                         pack["stats"] if pack is not None else None,
                         tally[e]))
        # one copy of the group's sums to the host, queued now and awaited
        # by its mark's event: a read queued at the readback would wait for
        # the next group's steps, which the stream holds by then
        if sums:
            sums = torch.stack(sums).to("cpu", non_blocking=pin)
        marks.append(Mark.record(epochs[-1][0], scan.replays if scan else 0,
                                 dev))
        finalize(pending)
        pending = (rows, list(metrics), sums, marks[-1])
        state.epoch = epochs[-1][0]
        if mgr and checkpoint_every and any(
                ep % checkpoint_every == 0 for ep, _ in epochs):
            mgr.save(state.step, state)
    finalize(pending)
    return history, scan, marks


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
    ``eager_steps``, ``start_epoch``, ``epoch_group`` (the epoch trainer's
    epochs a group, else None) and ``marks``: a ``telemetry.Mark`` after
    each epoch's steps, or after each group's in the epoch trainer, the
    points between which a caller times the run
    (``telemetry.seconds_between``). A device-resident loader
    (:func:`use_device_dataset`) at K > 1 trains through
    :func:`run_epoch_mode`."""
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
    n_epochs = epochs or cfg.epochs
    prepare = getattr(loader, "prepare", None)
    group = None
    if isinstance(loader, EpochStackMixin) and k > 1:
        group = resolve_epoch_group(cfg.epoch_group, max(len(loader), 1),
                                    dev)
        if checkpoint_every:
            group = min(group, checkpoint_every)
        history, scan, marks = run_epoch_mode(
            state, loader, k, dev, start, n_epochs, group, log, mgr,
            checkpoint_every)
    else:
        history, scan, marks = _run_per_step(
            state, loader, k, dev, start, n_epochs, prepare, cfg, log, mgr,
            checkpoint_every)
    if mgr:
        if mgr.latest_step() != state.step:
            mgr.save(state.step, state)
        mgr.close()
    return {"state": state, "model": model, "history": history,
            "loader": loader, "scan_steps": k,
            "replays": scan.replays if scan else 0,
            "eager_steps": (scan.eager_steps if scan
                            else state.step - first_step),
            "start_epoch": start, "epoch_group": group, "marks": marks}


def _run_per_step(state, loader, k, dev, start, n_epochs, prepare, cfg, log,
                  mgr, checkpoint_every):
    """``run_pretrain``'s loop over whole batches (or, for a
    device-resident loader at K = 1, descriptors, each built into its
    batch first): epochs ``start..n_epochs``; returns the history rows and
    the ``ScanStep`` (None at K = 1) and the epochs' marks."""
    meter = ThroughputMeter()
    pin = dev.type == "cuda"
    batches = prefetch(_run_batches(loader, max(n_epochs - start + 1, 0), k,
                                    pin), depth=2)
    scan = None
    history, marks = [], []
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
                scan = make_scan_pretrain_step(state, first, k, prepare)
            if kind == "group":
                loss, metrics = scan([b for b, _ in item])
                replays += 1
            else:
                batch, counts = item
                item = [item]
                if scan is not None:
                    loss, metrics = scan.step(batch)
                else:
                    batch = batch.to(dev, non_blocking=pin)
                    loss, metrics = train_step(
                        state, batch if prepare is None else prepare(batch))
                eager += 1
            # each step's loss and metrics in order: the epoch's mean sums
            # one vector, whatever the grouping
            parts.append(loss.reshape(-1))
            for key, v in metrics.items():
                agg.setdefault(key, []).append(v.reshape(-1))
            for _, counts in item:
                meter.tick(**counts)
        nb = max(meter.steps, 1)
        sums = {key: torch.cat(v).sum() for key, v in agg.items()}
        loss = torch.cat(parts).sum() if parts else None
        marks.append(Mark.record(epoch, scan.replays if scan else 0, dev))
        row = {"epoch": epoch,
               "loss": float(loss) / nb if parts else 0.0}
        row.update({key: float(v) / nb for key, v in sums.items()})
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
    return history, scan, marks


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
