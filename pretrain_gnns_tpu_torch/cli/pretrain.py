"""Pretraining CLI of the port: attribute masking, edge prediction, Deep
Graph Infomax and supervised pretraining in the chem and bio domains, on a
GIN, GCN, GAT or GraphSAGE trunk, with the flag names of the JAX package's
CLI plus ``--device``.

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

With ``--dataset synthetic``, chem trains on ``n_synthetic`` molecules
and bio on ``max(n_synthetic // 4, 64)`` ego-networks, as the JAX CLI.
The supervised objective trains the domain's graph-level head
(``--graph_pooling sum|mean|max|attention|set2setN``, the last for chem
only) on the dataset's labels: the molecules' two synthetic tasks, as the
JAX package's ``synthetic`` dataset has them, or the ego-networks'
``go_target_pretrain`` extra. On the synthetic
bio dataset it trains on every graph: the species split of the JAX CLI
(``--split``) is not ported, nor is ``--input_model_file``.

``--scan_steps K`` runs K train steps a dispatch, as the JAX CLI's flag:
on CUDA one CUDA-graph replay of K captured steps a group of K batches (0,
the default, means 16 there), on the CPU the K steps of a group in turn (0
means 1 there).

Saves the trunk ``state_dict`` (reference key layout) to
``<output_model_file>.pth`` in torch's legacy (pre-zip) format, which the
reference's torch 1.0.1 reads, as the JAX package's CLI writes it.
"""

from __future__ import annotations

import argparse

import torch
from torch import nn


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--objective", default="masking",
                   choices=["masking", "edgepred", "infomax", "contextpred",
                            "supervised"])
    p.add_argument("--domain", default="chem", choices=["chem", "bio"])
    p.add_argument("--dataset", default="synthetic")
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
                   help="not ported yet")
    p.add_argument("--split", default="",
                   help="not ported yet (bio supervised species split)")
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
    p.add_argument("--mask_rate", type=float, default=0.15)
    p.add_argument("--mask_edge", type=int, default=0)
    p.add_argument("--output_model_file", default="")
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
    if args.objective == "contextpred":
        raise SystemExit(
            f"--objective {args.objective} is not ported yet; this CLI runs "
            "--objective masking, edgepred, infomax or supervised"
        )
    if args.gnn_type not in ("gin", "gcn", "gat", "graphsage"):
        raise SystemExit(f"--gnn_type {args.gnn_type} is not ported yet")
    for flag in ("input_model_file", "split"):
        if getattr(args, flag):
            raise SystemExit(f"--{flag} is not ported yet")
    if args.dataset != "synthetic":
        raise SystemExit(
            f"--dataset {args.dataset} is not ported yet; use synthetic"
        )

    from pretrain_gnns_tpu_torch.data import synthetic
    from pretrain_gnns_tpu_torch.train import pretrain

    if args.domain == "bio":
        graphs = synthetic.bio_dataset(max(args.n_synthetic // 4, 64),
                                       seed=args.seed)
    else:
        graphs, _ = synthetic.molecule_dataset(args.n_synthetic, num_tasks=2,
                                               seed=args.seed)
    num_tasks = 1
    if args.objective == "supervised":
        graphs, num_tasks = pretrain.supervised_graphs(graphs, args.domain)
    cfg = pretrain.PretrainConfig(
        objective=args.objective, domain=args.domain,
        num_layer=args.num_layer, emb_dim=args.emb_dim,
        jk=args.jk, dropout_ratio=args.dropout_ratio, gnn_type=args.gnn_type,
        lr=args.lr, decay=args.decay, batch_size=args.batch_size,
        epochs=args.epochs, seed=args.seed, mask_rate=args.mask_rate,
        mask_edge=bool(args.mask_edge), num_tasks=num_tasks,
        graph_pooling=args.graph_pooling, packing=args.packing,
        scan_steps=args.scan_steps,
    )
    res = pretrain.run_pretrain(
        cfg, graphs, log=lambda s: print(s, flush=True), device=args.device)
    if args.output_model_file:
        path = args.output_model_file + ".pth"
        save_trunk(res["model"].gnn, path)
        print(f"saved trunk -> {path}")
    return res["history"]


def save_trunk(trunk: nn.Module, path: str) -> None:
    """``trunk.state_dict()`` on the CPU, written in the legacy non-zip
    format that torch 1.0.1's ``torch.load`` reads."""
    state = {k: v.detach().cpu() for k, v in trunk.state_dict().items()}
    torch.save(state, path, _use_new_zipfile_serialization=False)


if __name__ == "__main__":
    main()
