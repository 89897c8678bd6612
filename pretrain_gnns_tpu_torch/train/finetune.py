"""Downstream fine-tuning (port of ``pretrain_gnns_tpu.train.finetune``, the
reference's chem/finetune.py and bio/finetune.py as a library).

The pipeline: a split dataset, loaders of ``batch_size`` graphs (the train
loader shuffled from ``runseed``, the eval loaders in the graphs' order
with their last, partly empty batch), a ``GNNGraphPred`` of the domain
whose trunk may come from a pretrained file, the domain's BCE (masked for
chem's {-1, 0, +1} labels, plain for bio's {0, 1}), Adam with the head at
``lr * lr_scale``, and each epoch the train loss, the validation and test
ROC-AUC (bio: the mean of the per-task AUCs). The protocol's number is the
test AUC at the epoch of the best validation AUC (chem/parse_result.py:
7-20).

On CUDA the batches take the block-diagonal layout (``choose_blocks``),
eval batches too, so that every conv runs on the port's kernels: K1 for the
chem GIN, K2 for the bio GIN and the chem GCN and GraphSAGE, K4 for GAT, in
their training form in a train step and forward only under
``torch.no_grad()`` in an eval pass. Steps run eagerly, one a batch, and
the loss is read back once an epoch, as the JAX ``run_finetune`` does.
``make_scan_train_step`` runs K train steps a call (a ``graphed.ScanStep``,
one CUDA-graph replay on the card) and ``stack_batches`` stacks K batches'
leaves, as the JAX package's do; like the JAX ``run_finetune``,
``run_finetune`` calls neither. The halo execution (``make_halo_steps``)
is not ported yet."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import Graph, PackedGraphs
from pretrain_gnns_tpu_torch.data import splitters
from pretrain_gnns_tpu_torch.data.packing import choose_blocks, make_loader
from pretrain_gnns_tpu_torch.data.prefetch import prefetch
from pretrain_gnns_tpu_torch.device import resolve_device
from pretrain_gnns_tpu_torch.models import bio as bio_models
from pretrain_gnns_tpu_torch.models import chem as chem_models
from pretrain_gnns_tpu_torch.models.inits import init_parameters
from pretrain_gnns_tpu_torch.objectives import losses
from pretrain_gnns_tpu_torch.train import checkpoints, graphed, metrics, optim
from pretrain_gnns_tpu_torch.train.state import TrainState

# the reference's task counts (chem/finetune.py:125-144)
NUM_TASKS = {
    "tox21": 12, "hiv": 1, "pcba": 128, "muv": 17, "bace": 1, "bbbp": 1,
    "toxcast": 617, "sider": 27, "clintox": 2, "mutag": 1, "ptc_mr": 1,
}

LOSSES = {"chem": losses.masked_task_bce, "bio": losses.plain_bce}


@dataclasses.dataclass
class FinetuneConfig:
    """The flags of chem/finetune.py:83-115 and bio/finetune.py:70-106
    (``domain`` picks the model family), as the JAX ``FinetuneConfig``
    without ``halo_devices``."""

    domain: str = "chem"  # chem | bio
    num_tasks: int = 1
    num_layer: int = 5
    emb_dim: int = 300
    dropout_ratio: float = 0.5
    graph_pooling: str = "mean"
    jk: str = "last"
    gnn_type: str = "gin"
    lr: float = 1e-3
    lr_scale: float = 1.0
    decay: float = 0.0
    batch_size: int = 32
    epochs: int = 100
    seed: int = 0  # the split's seed
    runseed: int = 0  # the weights', the dropout's and the shuffle's seed
    packing: str = "auto"  # auto (blocked on CUDA) | standard | blocked
    loss_kind: Optional[str] = None  # default: chem masked BCE, bio plain
    # also evaluate (and report) the train split each epoch (the
    # reference's --eval_train, chem/finetune.py:205-210)
    eval_train: bool = False

    def __post_init__(self):
        if self.loss_kind is None:
            self.loss_kind = "bio" if self.domain == "bio" else "chem"


def build_model(cfg: FinetuneConfig) -> nn.Module:
    """The domain's ``GNNGraphPred`` (its draws come from
    :func:`init_state`)."""
    cls = (bio_models.GNNGraphPred if cfg.domain == "bio"
           else chem_models.GNNGraphPred)
    return cls(num_layer=cfg.num_layer, emb_dim=cfg.emb_dim,
               num_tasks=cfg.num_tasks, jk=cfg.jk,
               drop_ratio=cfg.dropout_ratio,
               graph_pooling=cfg.graph_pooling, gnn_type=cfg.gnn_type)


def make_train_step(loss_kind: str = "chem"):
    """``step(state, batch)``: one train-mode forward (batch norm from the
    batch, dropout on), the ``loss_kind`` BCE over the valid graph slots,
    backward and optimizer step, counted in ``state.step``; returns the
    detached loss (no host synchronisation)."""
    body = _train_body(loss_kind)

    def step(state: TrainState, batch: PackedGraphs) -> torch.Tensor:
        loss, _ = body(state, batch)
        state.step += 1
        return loss

    return step


def _train_body(loss_kind: str):
    """One train step, not counted in ``state.step``: the detached loss
    and no metrics."""
    loss_of = LOSSES[loss_kind]

    def body(state: TrainState, batch: PackedGraphs):
        model = state.model
        model.train()
        loss = loss_of(model(batch, train=True), batch.y, batch.graph_mask)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        return loss.detach(), {}

    return body


def make_scan_train_step(state: TrainState, example_batch: PackedGraphs,
                         k: int, loss_kind: str = "chem") -> graphed.ScanStep:
    """K train steps of :func:`make_train_step`'s a call (the JAX
    ``make_scan_train_step``), on K batches of ``example_batch``'s
    signature: a ``graphed.ScanStep`` on the parameters' device, one
    replay of a captured graph on CUDA (after an eager ``.step(batch)``),
    the K steps in turn on the CPU. A call returns the losses ``[K]``."""
    dev = next(state.model.parameters()).device
    return graphed.ScanStep(state, example_batch, k, _train_body(loss_kind),
                            dev)


def stack_batches(batches: Sequence[PackedGraphs]) -> PackedGraphs:
    """[K] batches of one layout -> one ``PackedGraphs`` whose leaves are
    theirs stacked on a new first axis (numpy)."""
    leaves = [b.leaves() for b in batches]
    stacked = {name: np.stack([np.asarray(lv[name]) for lv in leaves])
               for name in leaves[0]}
    first = batches[0]
    return dataclasses.replace(
        first, **{f: stacked[f] for f in stacked if "/" not in f},
        extras={k: stacked[f"extras/{k}"] for k in first.extras})


def make_eval_step():
    """``logits(state, batch)``: the eval-mode forward (batch norm from its
    running statistics, no dropout) under ``torch.no_grad()``, ``[G,
    num_tasks]`` for every graph slot."""

    def logits(state: TrainState, batch: PackedGraphs) -> torch.Tensor:
        model = state.model
        model.eval()
        with torch.no_grad():
            return model(batch, train=False)

    return logits


def device_batches(loader: Iterable[PackedGraphs], device: torch.device):
    """``(host batch, batch on device)`` for each batch of ``loader``,
    packed on a prefetch thread; for the card pinned there and copied
    without waiting for the card."""
    pin = device.type == "cuda"
    for batch in prefetch((b.pin_memory() if pin else b) for b in loader):
        yield batch, batch.to(device, non_blocking=pin)


def evaluate(eval_step, state: TrainState, loader, metric: str = "chem_auc",
             return_tasks: bool = False):
    """The protocol's metric over ``loader``'s valid graph slots (by
    ``graph_mask``): ``chem_auc`` (the mean of the tasks' AUCs),
    ``bio_auc`` (the nan-mean of the per-task AUCs) or ``accuracy`` (of
    the first task's signs). The logits come back to the host once, after
    the last batch. ``return_tasks`` adds the per-task AUC array (bio;
    None otherwise)."""
    dev = next(state.model.parameters()).device
    outs, ys, masks = [], [], []
    for host, batch in device_batches(loader, dev):
        outs.append(eval_step(state, batch))
        ys.append(np.asarray(host.y))
        masks.append(np.asarray(host.graph_mask))
    m = np.concatenate(masks)
    s = torch.cat(outs).float().cpu().numpy()[m]
    y = np.concatenate(ys)[m]
    tasks = None
    if metric == "chem_auc":
        out = metrics.chem_mean_auc(y, s)
    elif metric == "bio_auc":
        tasks = metrics.bio_auc_array(y, s)
        out = float(np.nanmean(tasks))
    elif metric == "accuracy":
        out = metrics.accuracy_from_scores(y[:, 0], s[:, 0])
    else:
        raise ValueError(metric)
    return (out, tasks) if return_tasks else out


def init_state(cfg: FinetuneConfig, model: nn.Module,
               pretrained_trunk: Optional[Mapping[str, torch.Tensor]] = None,
               device=None) -> TrainState:
    """The model's weights drawn on the CPU from a ``torch.Generator``
    seeded by ``runseed`` (and its dropout seeded by it), then, with
    ``pretrained_trunk``, the trunk ``model.gnn`` loaded from that
    reference state dict (strict; the pool and head keep their draws), all
    moved to ``device``; Adam with the head at ``lr * lr_scale``."""
    init_parameters(model, torch.Generator().manual_seed(cfg.runseed))
    model.gnn.seed_dropout(cfg.runseed)
    if pretrained_trunk is not None:
        checkpoints.graft(model.gnn, pretrained_trunk)
    model = model.to(resolve_device(device))
    return TrainState(model, optim.finetune_adam(model, cfg.lr, cfg.lr_scale,
                                                 cfg.decay))


def build_loaders(cfg: FinetuneConfig, train_graphs: Sequence[Graph],
                  valid_graphs: Sequence[Graph],
                  test_graphs: Sequence[Graph],
                  extra_test: Optional[Dict[str, Sequence[Graph]]] = None,
                  device=None):
    """``(train loader, {name: eval loader})`` of a run on ``device``: the
    block layout of every split's graphs where ``choose_blocks`` picks it
    (CUDA), the train loader shuffled from ``runseed``, and the eval
    loaders (``val``, ``test``, each non-empty ``extra_test`` set and,
    under ``eval_train``, ``train``) with the train loader's buffers, the
    graphs' order and their last, partly empty batch."""
    extra_pad = ({"center_node_idx": cfg.batch_size} if cfg.domain == "bio"
                 else None)
    all_graphs = list(train_graphs) + list(valid_graphs) + list(test_graphs)
    blocks = choose_blocks(all_graphs, cfg.batch_size, cfg.packing,
                           resolve_device(device))
    train_loader = make_loader(train_graphs, cfg.batch_size, shuffle=True,
                               seed=cfg.runseed, extra_pad=extra_pad,
                               blocks=blocks)
    kw = dict(max_nodes=train_loader.max_nodes,
              max_edges=train_loader.max_edges, shuffle=False,
              extra_pad=extra_pad, blocks=blocks)
    sets = {"val": valid_graphs, "test": test_graphs}
    sets.update((name, gs) for name, gs in (extra_test or {}).items() if gs)
    if cfg.eval_train:
        sets["train"] = train_graphs
    return train_loader, {name: make_loader(gs, cfg.batch_size, **kw)
                          for name, gs in sets.items()}


def run_finetune(
    cfg: FinetuneConfig,
    train_graphs: Sequence[Graph],
    valid_graphs: Sequence[Graph],
    test_graphs: Sequence[Graph],
    pretrained_trunk: Optional[Mapping[str, torch.Tensor]] = None,
    metric: Optional[str] = None,
    log: Optional[Callable[[str], None]] = print,
    extra_test: Optional[Dict[str, Sequence[Graph]]] = None,
    device=None,
) -> Dict[str, Any]:
    """A whole fine-tuning run. ``device`` defaults to ``"cuda"``; without
    CUDA that raises ``RuntimeError`` unless ``device="cpu"``. Returns the
    per-epoch ``curves`` (``train_loss``, ``val``, ``test`` and one for
    each ``extra_test`` set and, under ``eval_train``, ``train``), the
    ``best_epoch`` (1-based, the argmax of ``val``), its ``val_auc`` and
    ``test_auc``, for the bio metric ``task_auc`` (each test set's
    per-task AUCs at that epoch), the final ``state``, and ``history``:
    per epoch the train steps, their valid directed edges and seconds (to
    the loss's readback), and the eval passes' batches, graphs and
    seconds."""
    dev = resolve_device(device)
    metric = metric or ("chem_auc" if cfg.loss_kind == "chem" else "bio_auc")
    train_loader, eval_sets = build_loaders(cfg, train_graphs, valid_graphs,
                                            test_graphs, extra_test, dev)
    state = init_state(cfg, build_model(cfg), pretrained_trunk, dev)
    train_step = make_train_step(cfg.loss_kind)
    eval_step = make_eval_step()
    track_tasks = metric == "bio_auc"
    curves: Dict[str, list] = {"train_loss": [], "val": [], "test": []}
    curves.update((name, []) for name in eval_sets if name not in curves)
    curves_tasks: Dict[str, list] = {}
    history = []
    for epoch in range(1, cfg.epochs + 1):
        t0 = time.perf_counter()
        step_losses = [train_step(state, batch)
                       for _, batch in device_batches(train_loader, dev)]
        # one readback an epoch keeps the steps asynchronous
        tot = float(torch.stack(step_losses).sum()) if step_losses else 0.0
        t1 = time.perf_counter()
        curves["train_loss"].append(tot / max(len(step_losses), 1))
        for name, loader in eval_sets.items():
            auc, tasks = evaluate(eval_step, state, loader, metric,
                                  return_tasks=True)
            curves[name].append(auc)
            if track_tasks and name != "val":
                curves_tasks.setdefault(name, []).append(tasks)
        t2 = time.perf_counter()
        stats = train_loader.last_epoch_stats
        history.append({
            "epoch": epoch, "steps": len(step_losses),
            "edges": stats["edges"], "train_seconds": t1 - t0,
            "eval_batches": sum(ld.last_epoch_stats["batches"]
                                for ld in eval_sets.values()),
            "eval_graphs": sum(ld.last_epoch_stats["graphs"]
                               for ld in eval_sets.values()),
            "eval_seconds": t2 - t1})
        if log:
            if epoch == 1:
                log(f"loader: {type(train_loader).__name__}, "
                    f"{stats['batches']} batches, "
                    f"{stats['graphs_per_batch']:.1f} graphs/batch "
                    f"(batch_size={cfg.batch_size}, "
                    f"blocks={train_loader.blocks})")
            h = history[-1]
            log(f"epoch {epoch}: loss {curves['train_loss'][-1]:.4f} "
                f"val {curves['val'][-1]:.4f} test {curves['test'][-1]:.4f} "
                f"({h['steps']} steps, "
                f"{h['edges'] / h['train_seconds']:.1f} valid edges/s; "
                f"eval {h['eval_graphs'] / h['eval_seconds']:.1f} "
                "graphs/s)")

    best_epoch = int(np.argmax(curves["val"]))
    out = {
        "curves": curves,
        "best_epoch": best_epoch + 1,
        "val_auc": curves["val"][best_epoch],
        "test_auc": curves["test"][best_epoch],
        "state": state,
        "history": history,
    }
    if curves_tasks:
        # the per-task AUCs at the selected epoch (the data behind
        # bio/result_analysis.py:84-139's pairwise scatter plots)
        out["task_auc"] = {name: arrs[best_epoch]
                           for name, arrs in curves_tasks.items()}
    return out


def run_finetune_cv(
    cfg: FinetuneConfig,
    graphs: Sequence[Graph],
    fold_idx: int = 0,
    n_splits: int = 10,
    pretrained_trunk: Optional[Mapping[str, torch.Tensor]] = None,
    log: Optional[Callable[[str], None]] = print,
    device=None,
) -> Dict[str, Any]:
    """The 10-fold protocol of mutag and ptc_mr
    (chem/finetune_mutag_ptc.py): fold ``fold_idx`` of the stratified
    split of the first task's labels (``splitters.cv_random_split``,
    ``cfg.seed``) validates, the rest trains; the metric is the accuracy
    of the scores' signs (:65-78), and the validation fold is the test set
    as well."""
    labels = [float(np.asarray(g.y).reshape(-1)[0]) for g in graphs]
    tr_idx, va_idx = splitters.cv_random_split(
        labels, fold_idx=fold_idx, n_splits=n_splits, seed=cfg.seed)
    train_g = [graphs[i] for i in tr_idx]
    val_g = [graphs[i] for i in va_idx]
    res = run_finetune(cfg, train_g, val_g, val_g,
                       pretrained_trunk=pretrained_trunk, metric="accuracy",
                       log=log, device=device)
    res["fold_idx"] = fold_idx
    return res
