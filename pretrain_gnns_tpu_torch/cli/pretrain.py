"""Pretraining CLI of the port: attribute masking, edge prediction, Deep
Graph Infomax, supervised pretraining and context prediction in the chem
and bio domains, on a GIN, GCN, GAT or GraphSAGE trunk, with the flag
names of the JAX package's CLI plus ``--device``.

Examples:
  python -m pretrain_gnns_tpu_torch.cli.pretrain --dataset synthetic \
      --epochs 5 --output_model_file trunk
  python -m pretrain_gnns_tpu_torch.cli.pretrain --domain bio \
      --dataset synthetic --epochs 5 --output_model_file bio_trunk
  python -m pretrain_gnns_tpu_torch.cli.pretrain --objective edgepred \
      --gnn_type gcn --epochs 5 --output_model_file edgepred_trunk
  python -m pretrain_gnns_tpu_torch.cli.pretrain --objective infomax \
      --domain bio --epochs 5 --output_model_file infomax_trunk
  python -m pretrain_gnns_tpu_torch.cli.pretrain --gnn_type gat \
      --domain bio --epochs 5 --output_model_file gat_trunk
  python -m pretrain_gnns_tpu_torch.cli.pretrain --objective supervised \
      --graph_pooling attention --epochs 5 --output_model_file sup_trunk
  python -m pretrain_gnns_tpu_torch.cli.pretrain --objective contextpred \
      --mode skipgram --epochs 5 --output_model_file cp_trunk

``--dataset`` names a processed dataset under ``--data_root``
(``<data_root>/<dataset>/processed_tpu``, written by ``cli.featurize`` of
either package, ``data.datasets.load_dataset``) or a synthetic stand-in:
with ``synthetic`` chem trains on ``n_synthetic`` molecules and bio (where
``synthetic`` means ``synthetic_bio``) on ``max(n_synthetic // 4, 64)``
ego-networks, as the JAX CLI.
The supervised objective trains the domain's graph-level head
(``--graph_pooling sum|mean|max|attention|set2setN``, the last for chem
only) on the dataset's labels: the molecules' two synthetic tasks, as the
JAX package's ``synthetic`` dataset has them, or the ego-networks'
``go_target_pretrain`` extra. In the bio domain it trains on the
pretrain set of ``--split`` (:func:`bio_supervised_pretrain_indices`):
``species`` (the default) keeps the seven train/valid species and the easy
half of the human graphs, ``random`` the train and valid parts of a seeded
random split, as the JAX CLI.

``--input_model_file T.pth`` loads a reference trunk (the reference's, the
JAX package's or this CLI's export) in place of the seeded trunk before
the first step: the reference's two stages, self-supervised pretraining
then ``--objective supervised`` from its trunk. The JAX CLI loads it for
the supervised objective; this CLI for every objective, at the
objective's trunk (``train.pretrain.trunk_path``).

Context prediction (``--objective contextpred``) takes the JAX CLI's
flags: ``--csize`` (the chem context trunk's depth and ring width; bio's
trunk has 3 layers), ``--mode cbow|skipgram``, ``--neg_samples``,
``--context_pooling mean|sum``, and for bio ``--l1`` and ``--center``;
each graph's contexts are presampled (8 draws, cycled by epoch) before the
first epoch, and the saved trunk is the substructure trunk,
``gnn_substruct``.

``--scan_steps K`` runs K train steps a dispatch, as the JAX CLI's flag:
on CUDA one CUDA-graph replay of K captured steps a group of K batches (0,
the default, means 16 there), on the CPU the K steps of a group in turn (0
means 1 there).

``--transform_device host`` runs the reference's per-graph transforms in
the loader (``MaskAtom``, ``MaskEdge``, ``NegativeEdge``, and every
context pair drawn anew each epoch) in place of the one vectorized pass a
batch (``batch``, what the default ``auto`` means) and the presampled
contexts; ``device`` masks chem atoms inside the step
(``FusedMaskingObjective``) and, on the device-resident dataset, draws
edge prediction's negatives inside the step; elsewhere it reads as
``batch``.

``--device_dataset on`` keeps the whole dataset on the device and builds
each batch there from a small descriptor (``data/device_pack.py``; with K >
1 the epoch trainer); ``auto``, the default, means on with CUDA (where
chem and bio masking GIN ran at least as fast with it on the H100:
``train.pretrain.use_device_dataset``) and off on the CPU; ``off`` never.

``--checkpoint_dir D`` saves the whole train state (model, Adam's moments,
step, epoch, the dropout generators) to ``D`` every ``--checkpoint_every``
epochs (0: at the end only) and at the end, the newest three kept; a run
started again with the same ``D`` resumes from the latest one (``resumed
from step S (epoch E)``) and trains epochs ``E..--epochs``, bit for bit as
the uninterrupted run (``train.checkpoints.CheckpointManager``):

  python -m pretrain_gnns_tpu_torch.cli.pretrain --dataset zinc_standard_agent \
      --data_root dataset --checkpoint_dir ck --checkpoint_every 1 \
      --epochs 100 --output_model_file trunk

Saves the trunk ``state_dict`` (reference key layout) to
``<output_model_file>.pth`` in torch's legacy (pre-zip) format, which the
reference's torch 1.0.1 reads, as the JAX package's CLI writes it
(``train.checkpoints.save_trunk_reference_format``).
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--objective", default="masking",
                   choices=["masking", "edgepred", "infomax", "contextpred",
                            "supervised"])
    p.add_argument("--domain", default="chem", choices=["chem", "bio"])
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data_root", default="dataset")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--decay", type=float, default=0.0)
    p.add_argument("--num_layer", type=int, default=5)
    p.add_argument("--emb_dim", type=int, default=300)
    p.add_argument("--dropout_ratio", type=float, default=None,
                   help="default: 0.2 for supervised, else 0.0")
    p.add_argument("--graph_pooling", default="mean",
                   help="supervised: sum | mean | max | attention | set2setN")
    p.add_argument("--input_model_file", default="",
                   help="reference .pth trunk to start from")
    p.add_argument("--split", default="species",
                   choices=["species", "random"],
                   help="bio supervised pretrain-set construction "
                        "(bio/pretrain_supervised.py:83-101)")
    p.add_argument("--JK", dest="jk", default="last",
                   choices=["last", "concat", "max", "sum"])
    p.add_argument("--gnn_type", default="gin")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--packing", default="auto",
                   choices=["auto", "standard", "blocked"],
                   help="batch layout: auto = block-diagonal on CUDA")
    p.add_argument("--num_workers", type=int, default=0,
                   help="accepted for reference-CLI parity (unused)")
    p.add_argument("--scan_steps", type=int, default=0,
                   help="train steps fused per device dispatch "
                        "(0 = auto: 16 on accelerators)")
    p.add_argument("--transform_device", default="auto",
                   choices=["auto", "host", "batch", "device"],
                   help="SSL transform placement: per graph in the loader "
                        "(host, the reference's), one vectorized pass per "
                        "batch (batch, what auto means), or inside the "
                        "step (device)")
    p.add_argument("--device_dataset", default="auto",
                   choices=["auto", "on", "off"],
                   help="keep the whole flat dataset on the device and "
                        "build batches there (auto: see "
                        "train.pretrain.use_device_dataset)")
    p.add_argument("--mask_rate", type=float, default=0.15)
    p.add_argument("--mask_edge", type=int, default=0)
    p.add_argument("--csize", type=int, default=3)
    p.add_argument("--mode", default="cbow", choices=["cbow", "skipgram"])
    p.add_argument("--neg_samples", type=int, default=1)
    p.add_argument("--context_pooling", default="mean",
                   help="contextpred cbow: mean | sum")
    p.add_argument("--l1", type=int, default=1)
    p.add_argument("--center", type=int, default=1)
    p.add_argument("--output_model_file", default="")
    p.add_argument("--checkpoint_dir", default="")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="step checkpoint every N epochs (0 = end only)")
    p.add_argument("--n_synthetic", type=int, default=2000)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda or cpu)")
    return p


def resolve_dropout(args) -> float:
    """The reference's defaults: 0.2 for supervised pretraining, 0.0 for
    every self-supervised objective."""
    if args.dropout_ratio is not None:
        return args.dropout_ratio
    return 0.2 if args.objective == "supervised" else 0.0


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.dropout_ratio = resolve_dropout(args)
    if args.gnn_type not in ("gin", "gcn", "gat", "graphsage"):
        raise SystemExit(f"--gnn_type {args.gnn_type} is not ported yet")

    from pretrain_gnns_tpu_torch.data import datasets
    from pretrain_gnns_tpu_torch.train import pretrain
    from pretrain_gnns_tpu_torch.train.checkpoints import (
        load_trunk_any, save_trunk_reference_format,
    )

    if args.domain == "bio" and args.dataset == "synthetic":
        args.dataset = "synthetic_bio"
    graphs, _, _ = datasets.load_dataset(args.dataset, args.data_root,
                                         args.n_synthetic, seed=args.seed)
    num_tasks = 1
    if args.objective == "supervised":
        if args.domain == "bio":
            species = np.array(
                [g.extras["species_id"][0][0] for g in graphs])
            keep = bio_supervised_pretrain_indices(species, args.split,
                                                   args.seed)
            graphs = [graphs[i] for i in keep]
        graphs, num_tasks = pretrain.supervised_graphs(graphs, args.domain)
    cfg = pretrain.PretrainConfig(
        objective=args.objective, domain=args.domain,
        num_layer=args.num_layer, emb_dim=args.emb_dim,
        jk=args.jk, dropout_ratio=args.dropout_ratio, gnn_type=args.gnn_type,
        lr=args.lr, decay=args.decay, batch_size=args.batch_size,
        epochs=args.epochs, seed=args.seed, mask_rate=args.mask_rate,
        mask_edge=bool(args.mask_edge), num_tasks=num_tasks,
        csize=args.csize, mode=args.mode, neg_samples=args.neg_samples,
        context_pooling=args.context_pooling, l1=args.l1,
        center=bool(args.center),
        graph_pooling=args.graph_pooling, packing=args.packing,
        scan_steps=args.scan_steps, transform_device=args.transform_device,
        device_dataset=args.device_dataset,
    )
    trunk = (load_trunk_any(args.input_model_file)
             if args.input_model_file else None)
    res = pretrain.run_pretrain(
        cfg, graphs, log=lambda s: print(s, flush=True), device=args.device,
        pretrained_trunk=trunk, checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every)
    if args.output_model_file:
        path = args.output_model_file + ".pth"
        save_trunk_reference_format(
            pretrain.trunk_module(res["model"], pretrain.trunk_path(cfg)),
            path)
        print(f"saved trunk -> {path}")
    return res["history"]


def bio_supervised_pretrain_indices(species: np.ndarray, split: str,
                                    seed: int) -> List[int]:
    """The reference's supervised pretrain set
    (bio/pretrain_supervised.py:83-101): under ``species`` the seven
    train/valid species plus the easy half of the human test set (the
    seeded ``random_split`` that fine-tuning later calls "test_easy");
    under ``random`` the train and valid parts of a seeded random split."""
    from pretrain_gnns_tpu_torch.data import splitters

    n = len(species)
    if split == "random":
        tr, va, _ = splitters.random_split(n, seed=seed)
        return list(tr) + list(va)
    if split != "species":
        raise ValueError(f"Unknown split name. ({split})")
    tv, te = splitters.species_split(np.asarray(species))
    easy_idx, _, _ = splitters.random_split(
        len(te), frac_train=0.5, frac_valid=0.5, frac_test=0.0, seed=seed)
    return list(tv) + [te[i] for i in easy_idx]


if __name__ == "__main__":
    main()
