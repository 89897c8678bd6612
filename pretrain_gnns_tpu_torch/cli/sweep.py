"""Sweep runner (port of ``pretrain_gnns_tpu.cli.sweep``): the
reference's finetune_tune.sh reproduction protocol (chem/finetune_tune.sh:
1-35, bio/finetune_tune.sh): seeds x datasets x pretrain configs, each a
run of the port's ``cli.finetune`` that writes a ``result.json``, then,
with ``--cv_block 1``, the script's second block, the mutag/ptc grid of
batch sizes x dropouts x datasets x configs, one 10-fold CV run a fold.
``--other_gnns`` adds each architecture's {nopretrain,
<arch>_supervised_contextpred} (bio: ``_supervised_masking``) runs. A
config's trunk is ``<model_dir>/<config>.pth`` (a missing one runs from
scratch). The flags and defaults are the JAX CLI's, plus ``--device``
(default ``cuda``), passed to every run. The runs' rows go to
``<result_dir>/sweep_summary.json``; aggregate with ``python -m
pretrain_gnns_tpu_torch.cli.aggregate``.

Example (synthetic smoke of the full protocol shape):
  python -m pretrain_gnns_tpu_torch.cli.sweep --datasets synthetic \
      --seeds 0 1 2 --configs nopretrain masking --epochs 5
"""

from __future__ import annotations

import argparse
import json
import os

CHEM_DATASETS = ["bace", "bbbp", "clintox", "hiv", "muv", "sider", "tox21",
                 "toxcast"]
# the 10 GIN configs of finetune_tune.sh:5-8
GIN_CONFIGS = ["nopretrain", "infomax", "edgepred", "masking",
               "contextpred", "supervised", "supervised_infomax",
               "supervised_edgepred", "supervised_masking",
               "supervised_contextpred"]
# finetune_tune.sh's SECOND block (the mutag/ptc CV sweep): batch {8,64}
# x dropout {0,0.2,0.5} x {ptc_mr,mutag} x 10 configs, one 10-fold CV run
# each, fold passed per invocation ($1 = fold_idx)
CV_DATASETS = ["ptc_mr", "mutag"]
CV_BATCH_SIZES = [8, 64]
CV_DROPOUTS = [0.0, 0.2, 0.5]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--domain", default="chem", choices=["chem", "bio"])
    p.add_argument("--datasets", nargs="+", default=["synthetic"])
    p.add_argument("--seeds", type=int, nargs="+",
                   default=list(range(10)))
    p.add_argument("--configs", nargs="+", default=["nopretrain"])
    p.add_argument("--gnn_type", default="gin")
    p.add_argument("--other_gnns", nargs="*", default=[],
                   help="additionally run these architectures over "
                        "{nopretrain, <arch>_supervised_contextpred} — "
                        "the finetune_tune.sh other-GNN block "
                        "(chem/finetune_tune.sh:24-33)")
    p.add_argument("--model_dir", default="models",
                   help="directory holding <config>.pth trunks")
    p.add_argument("--result_dir", default="runs/sweep")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--dropout_ratio", type=float, default=0.5)
    p.add_argument("--split", default=None)
    p.add_argument("--n_synthetic", type=int, default=800)
    # --- the mutag/ptc CV block (finetune_tune.sh second half) ---
    p.add_argument("--cv_block", type=int, default=0,
                   help="also run the mutag/ptc 10-fold CV sweep "
                        "(batch {8,64} x dropout {0,0.2,0.5})")
    p.add_argument("--cv_datasets", nargs="+", default=CV_DATASETS)
    p.add_argument("--cv_batch_sizes", type=int, nargs="+",
                   default=CV_BATCH_SIZES)
    p.add_argument("--cv_dropouts", type=float, nargs="+",
                   default=CV_DROPOUTS)
    p.add_argument("--cv_folds", type=int, nargs="+",
                   default=list(range(10)))
    p.add_argument("--device", default="cuda",
                   help="torch device of every run (cuda or cpu)")
    args = p.parse_args(argv)

    from pretrain_gnns_tpu_torch.cli import finetune as ft_cli

    split = args.split or ("species" if args.domain == "bio" else "scaffold")
    results = []
    # (gnn_type, config) work list: the main block plus, per
    # finetune_tune.sh:24-33, each extra architecture x {nopretrain,
    # <arch>_supervised_contextpred} (bio: <arch>_supervised_masking)
    jobs = [(args.gnn_type, c, c) for c in args.configs]
    extra_cfg = ("supervised_masking" if args.domain == "bio"
                 else "supervised_contextpred")
    for arch in args.other_gnns:
        jobs += [
            (arch, "nopretrain", f"{arch}_nopretrain"),
            (arch, f"{arch}_{extra_cfg}", f"{arch}_{extra_cfg}"),
        ]
    for dataset in args.datasets:
        for gnn_type, config, label in jobs:
            model_file = ""
            if config != "nopretrain":
                cand = os.path.join(args.model_dir, f"{config}.pth")
                if os.path.exists(cand):
                    model_file = cand
                else:
                    print(f"[sweep] missing trunk {cand}; running "
                          f"{config} from scratch")
            for seed in args.seeds:
                run_dir = os.path.join(
                    args.result_dir, dataset, label
                )
                argv_ft = [
                    "--domain", args.domain,
                    "--dataset", dataset,
                    "--runseed", str(seed),
                    "--split", split,
                    "--gnn_type", gnn_type,
                    "--epochs", str(args.epochs),
                    "--batch_size", str(args.batch_size),
                    "--dropout_ratio", str(args.dropout_ratio),
                    "--run_dir", run_dir,
                    "--filename", label,
                    "--n_synthetic", str(args.n_synthetic),
                    "--device", args.device,
                ]
                if model_file:
                    argv_ft += ["--input_model_file", model_file]
                out = ft_cli.main(argv_ft)
                results.append(
                    {"dataset": dataset, "config": label, "seed": seed,
                     "test_auc": out["test_auc"],
                     "val_auc": out["val_auc"]}
                )
    if args.cv_block:
        # finetune_tune.sh's second half: hyperparameter grid x 10-fold
        # CV on the small TU datasets, accuracy metric
        for bs in args.cv_batch_sizes:
            for drop in args.cv_dropouts:
                for dataset in args.cv_datasets:
                    for config in args.configs:
                        model_file = ""
                        if config != "nopretrain":
                            cand = os.path.join(args.model_dir,
                                                f"{config}.pth")
                            if os.path.exists(cand):
                                model_file = cand
                        for fold in args.cv_folds:
                            argv_cv = [
                                "--dataset", dataset,
                                "--cv_fold", str(fold),
                                "--batch_size", str(bs),
                                "--dropout_ratio", str(drop),
                                "--gnn_type", args.gnn_type,
                                "--epochs", str(args.epochs),
                                "--run_dir", os.path.join(
                                    args.result_dir, "cv"
                                ),
                                "--filename", config,
                                "--n_synthetic", str(args.n_synthetic),
                                "--device", args.device,
                            ]
                            if model_file:
                                argv_cv += ["--input_model_file",
                                            model_file]
                            out = ft_cli.main(argv_cv)
                            results.append({
                                "dataset": (f"{dataset}_drop{drop:g}"
                                            f"_bsize{bs}"),
                                "config": config, "fold": fold,
                                "acc": out["acc"],
                                "val_acc": out["val_acc"],
                            })
    os.makedirs(args.result_dir, exist_ok=True)
    with open(os.path.join(args.result_dir, "sweep_summary.json"),
              "w") as f:
        json.dump(results, f)
    print(f"[sweep] {len(results)} runs -> {args.result_dir}")


if __name__ == "__main__":
    main()
