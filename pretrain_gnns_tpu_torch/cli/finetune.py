"""Fine-tuning CLI of the port: the reference's chem/finetune.py and
bio/finetune.py (argparse surfaces at chem/finetune.py:83-115 and
bio/finetune.py:70-106), with the flag names and defaults of the JAX
package's CLI plus ``--device``.

Examples:
  python -m pretrain_gnns_tpu_torch.cli.pretrain --output_model_file trunk
  python -m pretrain_gnns_tpu_torch.cli.finetune --input_model_file trunk.pth
  python -m pretrain_gnns_tpu_torch.cli.finetune --domain bio \
      --dataset synthetic_bio --n_synthetic 16384 --epochs 50
  python -m pretrain_gnns_tpu_torch.cli.finetune --device cpu \
      --num_layer 2 --emb_dim 16 --epochs 2

``--dataset`` names a processed dataset under ``--data_root``
(``<data_root>/<dataset>/processed_tpu``, written by ``cli.featurize`` of
either package; its task count from its ``meta.json``, else the
reference's; the scaffold splits read its ``scaffolds.txt``), or
``synthetic`` (``n_synthetic`` molecules with two tasks and
pseudo-scaffolds) and ``synthetic_bio`` (``max(n_synthetic // 4, 64)``
ego-networks, 40 tasks), generated from ``--seed`` as the JAX package's
(``data.datasets.load_dataset``):

  python -m pretrain_gnns_tpu_torch.cli.finetune --dataset tox21 \
      --data_root dataset --input_model_file trunk.pth

``--split`` is the JAX CLI's (bio's default is ``species``:
the seven species train and validate, 85/15, and the human graphs make the
easy ``test`` and the hard ``test_hard`` halves). ``--cv_fold F`` runs
fold F of the 10-fold accuracy protocol of mutag and ptc_mr instead.

Writes ``<run_dir>/<dataset>_seed<runseed>[_<filename>]/result.json``
(per-epoch curves, the epoch of the best validation AUC and its test AUC;
the keys of the JAX CLI's file) and, with ``--tensorboard 1``, the
reference's scalars through ``tensorboardX``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--domain", default="chem", choices=["chem", "bio"])
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data_root", default="dataset")
    p.add_argument("--batch_size", type=int, default=0,
                   help="0 = protocol default: 32 (chem/finetune.py:87), "
                        "8 under --cv_fold (finetune_mutag_ptc.py:87); "
                        "finetune_tune.sh's second block sweeps 8 and 64")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_scale", type=float, default=1.0)
    p.add_argument("--decay", type=float, default=0.0)
    p.add_argument("--num_layer", type=int, default=5)
    p.add_argument("--emb_dim", type=int, default=300)
    p.add_argument("--dropout_ratio", type=float, default=0.5)
    p.add_argument("--graph_pooling", default="mean")
    p.add_argument("--JK", dest="jk", default="last")
    p.add_argument("--gnn_type", default="gin")
    p.add_argument("--input_model_file", default="")
    p.add_argument("--seed", type=int, default=42,
                   help="split seed (bio random split)")
    p.add_argument("--runseed", type=int, default=0,
                   help="init/minibatch seed")
    p.add_argument("--packing", default="auto",
                   choices=["auto", "standard", "blocked"],
                   help="batch layout: auto = block-diagonal on CUDA")
    p.add_argument("--split", default="scaffold",
                   choices=["scaffold", "random", "random_scaffold",
                            "species"])
    p.add_argument("--eval_train", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=0,
                   help="accepted for reference-CLI parity (unused)")
    p.add_argument("--run_dir", default="runs/finetune")
    p.add_argument("--filename", default="", help="result tag")
    p.add_argument("--tensorboard", type=int, default=0)
    p.add_argument("--n_synthetic", type=int, default=800)
    p.add_argument("--cv_fold", type=int, default=-1,
                   help=">=0: 10-fold CV protocol (mutag/ptc_mr)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda or cpu)")
    return p


def split_dataset(args, graphs, scaffolds):
    """``(train, valid, test, extra test sets or None)`` under
    ``args.split``; ``species`` is the bio protocol (bio/finetune.py:
    116-119): 15% of the seven species' graphs validate, and the human
    graphs split 50/50 into the easy ``test`` (which overlaps the
    supervised pretraining set) and the hard ``test_hard``."""
    from pretrain_gnns_tpu_torch.data import splitters

    def pick(idx):
        return [graphs[i] for i in idx]

    if args.split == "scaffold":
        tr, va, te = splitters.scaffold_split(scaffolds)
    elif args.split == "random":
        tr, va, te = splitters.random_split(len(graphs), seed=args.seed)
    elif args.split == "random_scaffold":
        tr, va, te = splitters.random_scaffold_split(scaffolds,
                                                     seed=args.seed)
    else:
        species = np.array([g.extras["species_id"][0][0] for g in graphs])
        tv, te = splitters.species_split(species)
        tr_idx, va_idx, _ = splitters.random_split(
            len(tv), frac_train=0.85, frac_valid=0.15, frac_test=0.0,
            seed=args.seed)
        easy_idx, hard_idx, _ = splitters.random_split(
            len(te), frac_train=0.5, frac_valid=0.5, frac_test=0.0,
            seed=args.seed)
        return (pick([tv[i] for i in tr_idx]), pick([tv[i] for i in va_idx]),
                pick([te[i] for i in easy_idx]),
                {"test_hard": pick([te[i] for i in hard_idx])})
    return pick(tr), pick(va), pick(te), None


def main(argv=None):
    args = build_parser().parse_args(argv)

    from pretrain_gnns_tpu_torch.device import resolve_device
    from pretrain_gnns_tpu_torch.parallel import multihost

    resolve_device(args.device)  # no CUDA: raise before any work
    # the multi-process bootstrap: a no-op unless the PGT_* variables are
    # set (fine-tuning itself runs on each rank alone); a group made here
    # is left at the end
    joined = multihost.initialize(device=args.device)
    try:
        return _main(args)
    finally:
        if joined:
            multihost.shutdown()


def _main(args):
    from pretrain_gnns_tpu_torch.data import datasets
    from pretrain_gnns_tpu_torch.train import finetune
    from pretrain_gnns_tpu_torch.train.checkpoints import load_trunk_any

    graphs, scaffolds, meta = datasets.load_dataset(
        args.dataset, args.data_root, args.n_synthetic, seed=args.seed)
    num_tasks = meta.get("num_tasks") or finetune.NUM_TASKS.get(
        args.dataset, 1)
    if args.domain == "bio" and args.split == "scaffold":
        args.split = "species"
    train_g, val_g, test_g, extra_test = split_dataset(args, graphs,
                                                       scaffolds)

    cfg = finetune.FinetuneConfig(
        domain=args.domain, num_tasks=num_tasks, num_layer=args.num_layer,
        emb_dim=args.emb_dim, dropout_ratio=args.dropout_ratio,
        graph_pooling=args.graph_pooling, jk=args.jk,
        gnn_type=args.gnn_type, lr=args.lr, lr_scale=args.lr_scale,
        decay=args.decay,
        batch_size=args.batch_size or (8 if args.cv_fold >= 0 else 32),
        epochs=args.epochs, seed=args.seed, runseed=args.runseed,
        packing=args.packing, eval_train=bool(args.eval_train),
    )
    trunk = (load_trunk_any(args.input_model_file)
             if args.input_model_file else None)
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.cv_fold >= 0:
        res = finetune.run_finetune_cv(
            cfg, graphs, fold_idx=args.cv_fold, pretrained_trunk=trunk,
            log=log, device=args.device)
        out = {"dataset": args.dataset, "fold": args.cv_fold,
               "val_acc": res["val_auc"], "acc": res["test_auc"],
               "best_epoch": res["best_epoch"]}
        # a whole result.json, so that the mutag/ptc block aggregates by
        # fold as the main block does by seed
        tag = (f"{args.dataset}_drop{args.dropout_ratio:g}"
               f"_bsize{cfg.batch_size}")
        run_dir = os.path.join(
            args.run_dir, f"{tag}_fold{args.cv_fold}"
            + (f"_{args.filename}" if args.filename else ""))
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "result.json"), "w") as f:
            json.dump({"dataset": tag, "fold": args.cv_fold,
                       "config": dict(vars(args)),
                       "val": res["curves"]["val"],
                       "test": res["curves"]["test"],
                       "metric": "accuracy",
                       "best_epoch": res["best_epoch"]}, f)
        print(json.dumps(out))
        return out

    run_dir = os.path.join(
        args.run_dir, f"{args.dataset}_seed{args.runseed}"
        + (f"_{args.filename}" if args.filename else ""))
    os.makedirs(run_dir, exist_ok=True)
    writer = None
    if args.tensorboard:
        from tensorboardX import SummaryWriter

        writer = SummaryWriter(run_dir)

    res = finetune.run_finetune(cfg, train_g, val_g, test_g,
                                pretrained_trunk=trunk, log=log,
                                extra_test=extra_test, device=args.device)
    curves = res["curves"]
    if writer is not None:
        for i, (v, t) in enumerate(zip(curves["val"], curves["test"]), 1):
            writer.add_scalar("data/val auc", v, i)
            writer.add_scalar("data/test auc", t, i)
        # the reference logs the train AUC only under --eval_train
        # (chem/finetune.py:205-210, 222)
        for i, tr in enumerate(curves.get("train", []), 1):
            writer.add_scalar("data/train auc", tr, i)
        writer.close()

    out = {
        "dataset": args.dataset,
        "config": dict(vars(args)),
        "val": curves["val"],
        "test": curves["test"],
        "train_loss": curves["train_loss"],
        "best_epoch": res["best_epoch"],
        "val_auc": res["val_auc"],
        "test_auc": res["test_auc"],
    }
    for name in extra_test or {}:
        out[name] = curves[name]
        out[f"{name}_auc"] = curves[name][res["best_epoch"] - 1]
    if "train" in curves:
        out["train"] = curves["train"]
    for name, arr in (res.get("task_auc") or {}).items():
        # the per-task AUCs at the selected epoch, NaN as null
        out[f"{name}_task_auc"] = [
            None if not np.isfinite(v) else float(v) for v in arr]
    with open(os.path.join(run_dir, "result.json"), "w") as f:
        json.dump(out, f)
    print(json.dumps({"val_auc": res["val_auc"], "test_auc": res["test_auc"],
                      "best_epoch": res["best_epoch"], "run_dir": run_dir}))
    return out


if __name__ == "__main__":
    main()
