"""Result aggregation of fine-tuning studies (port of
``pretrain_gnns_tpu.cli.aggregate``: the reference's chem/parse_result.py
and bio/result_analysis.py over the ``result.json`` files that
``cli.finetune`` of either package writes).

Model selection rule (chem/parse_result.py:7-20): for each run, report the
test AUC at the epoch with the highest validation AUC; aggregate mean ± std
over seeds per (dataset, config). Bio runs carry extra test splits
(test_easy/test_hard via the species protocol, bio/finetune.py:116-119);
any ``test_*`` curve in a result is reported at the same best-val epoch.
The mutag/ptc CV runs of ``cli.sweep`` carry their fold, which takes the
seed's place.

Negative-transfer analysis (bio/result_analysis.py:84-139): for every
config, per-seed comparison against the ``nopretrain`` runs of the same
dataset: mean gain and the number of seeds where pre-training *hurt*;
``pairwise_points`` gives the data of the reference's scatter plots,
``make_plots`` draws them (matplotlib, imported only there, as
``tensorboard`` is only in ``collect_tensorboard``).

  python -m pretrain_gnns_tpu_torch.cli.aggregate --result_dir runs/sweep
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

import numpy as np

_META_KEYS = {"dataset", "config", "val", "test"}


def collect(result_dir: str):
    rows = []
    for path in glob.glob(
        os.path.join(result_dir, "**", "result.json"), recursive=True
    ):
        with open(path) as f:
            r = json.load(f)
        val = np.asarray(r["val"])
        test = np.asarray(r["test"])
        best = int(np.argmax(val))  # argmax-val-epoch selection
        row = {
            "dataset": r["dataset"],
            "config": r["config"].get("filename") or "default",
            # mutag/ptc CV runs: the fold plays the seed's role
            # (finetune_tune.sh second block, fold_idx = $1)
            "seed": r.get("fold", r["config"].get("runseed", 0)),
            "best_epoch": best + 1,
            "val_auc": float(val[best]),
            "test_auc": float(test[best]),
        }
        for k, v in r.items():
            if k.endswith("_task_auc") and isinstance(v, list):
                # bio per-task AUCs at the selected epoch (nullable)
                row[k] = [np.nan if x is None else float(x) for x in v]
            elif k.startswith("test_") and isinstance(v, list) and v:
                row[f"{k}_auc"] = float(np.asarray(v)[best])
        rows.append(row)
    return rows


def collect_tensorboard(run_root: str):
    """Rows from TensorBoard event files — the reference's own result
    format. chem/finetune.py:222-224 writes 'data/val auc'/'data/test auc'
    (tensorboardX stores them as data/val_auc, data/test_auc) under
    runs/finetune_cls_runseed{seed}/{dataset}/{config}/events* and
    chem/parse_result.py:7-20,52 selects test at the argmax-val epoch.
    This reader consumes runs produced by the unmodified reference or by
    ``cli.finetune --tensorboard 1`` interchangeably."""
    from tensorboard.backend.event_processing import event_accumulator

    rows = []
    for dirpath, _dirs, files in sorted(os.walk(run_root)):
        if not any(f.startswith("events") for f in files):
            continue
        ea = event_accumulator.EventAccumulator(
            dirpath, size_guidance={event_accumulator.SCALARS: 0}
        )
        ea.Reload()
        tags = set(ea.Tags()["scalars"])

        # size every curve to the run's common max epoch (like the
        # reference's fixed np.zeros(100), chem/parse_result.py:10-14):
        # an interrupted run that logged val but not test for its final
        # epoch must not index past the shorter array, and step<1 points
        # (malformed writers) are skipped instead of writing arr[-1]
        n_epochs = 0
        for tag in tags:
            pts = ea.Scalars(tag)
            if pts:
                n_epochs = max(n_epochs, max(p.step for p in pts))
        if n_epochs < 1:
            continue

        def curve(tag):
            if tag not in tags:
                return None
            arr = np.zeros(n_epochs)
            for p in ea.Scalars(tag):  # 1-based epochs (finetune.py:222)
                if 1 <= p.step <= n_epochs:
                    arr[p.step - 1] = p.value
            return arr

        val, test = curve("data/val_auc"), curve("data/test_auc")
        if val is None or test is None:
            continue
        best = int(np.argmax(val))
        parts = os.path.normpath(dirpath).split(os.sep)
        seed = 0
        for p in parts:
            if "runseed" in p:
                try:
                    seed = int(p.split("runseed")[-1])
                except ValueError:
                    pass
        row = {
            "dataset": parts[-2] if len(parts) >= 2 else "?",
            "config": parts[-1],
            "seed": seed,
            "best_epoch": best + 1,
            "val_auc": float(val[best]),
            "test_auc": float(test[best]),
        }
        for tag in sorted(tags):  # extra splits (bio easy/hard)
            name = tag.split("/")[-1]
            if name.startswith("test_") and name != "test_auc":
                extra = curve(tag)
                if extra is not None and best < len(extra):
                    key = name if name.endswith("_auc") else f"{name}_auc"
                    row[key] = float(extra[best])
        rows.append(row)
    return rows


def summarize(rows):
    by = defaultdict(list)
    for r in rows:
        by[(r["dataset"], r["config"])].append(r)
    table = []
    for (dataset, config), rs in sorted(by.items()):
        entry = {
            "dataset": dataset,
            "config": config,
            "n_seeds": len(rs),
            "mean_test_auc": float(np.mean([r["test_auc"] for r in rs])),
            "std_test_auc": float(np.std([r["test_auc"] for r in rs])),
        }
        extra_keys = sorted(
            {k for r in rs for k in r if k.endswith("_auc")
             and not k.endswith("_task_auc")
             and k not in ("val_auc", "test_auc")}
        )
        for k in extra_keys:
            vals = [r[k] for r in rs if k in r]
            entry[f"mean_{k}"] = float(np.mean(vals))
            entry[f"std_{k}"] = float(np.std(vals))
        table.append(entry)
    return table


def negative_transfer(rows, baseline: str = "nopretrain"):
    """Per-seed gain of each config over the baseline config on the same
    dataset (bio/result_analysis.py:84-139). Returns one entry per
    (dataset, config != baseline) with mean gain and the count of seeds
    where the pretrained run scored BELOW the baseline."""
    base = {
        (r["dataset"], r["seed"]): r["test_auc"]
        for r in rows if r["config"] == baseline
    }
    by = defaultdict(list)
    for r in rows:
        if r["config"] == baseline:
            continue
        b = base.get((r["dataset"], r["seed"]))
        if b is not None:
            by[(r["dataset"], r["config"])].append(r["test_auc"] - b)
    out = []
    for (dataset, config), deltas in sorted(by.items()):
        out.append({
            "dataset": dataset,
            "config": config,
            "n_pairs": len(deltas),
            "mean_gain": float(np.mean(deltas)),
            "negative_transfer_seeds": int(sum(d < 0 for d in deltas)),
        })
    return out


def pairwise_points(rows, baseline: str = "nopretrain"):
    """The raw data behind the reference's pairwise scatter plots
    (bio/result_analysis.py:84-139), at two granularities:

    - per-TASK (bio): configs whose rows carry ``*_task_auc`` arrays are
      compared task-by-task after averaging each task over seeds —
      exactly the reference's ``mean_task_result_dict`` scatter; the
      reference's negative-transfer count ``sum(x > y + 0.001)`` rides
      along.
    - per-(dataset, seed) otherwise (chem has a scalar protocol metric).
    """
    out = []
    task_keys = sorted({
        k for r in rows for k in r if k.endswith("_task_auc")
    })
    by_cfg = defaultdict(list)
    for r in rows:
        by_cfg[(r["dataset"], r["config"])].append(r)

    def task_means(rs, key):
        arrs = [np.asarray(r[key], float) for r in rs if key in r]
        if not arrs:
            return None
        return np.nanmean(np.stack(arrs), axis=0)

    for key in task_keys:
        for (dataset, config), rs in sorted(by_cfg.items()):
            if config == baseline:
                continue
            base_rs = by_cfg.get((dataset, baseline))
            if not base_rs:
                continue
            y = task_means(rs, key)
            x = task_means(base_rs, key)
            if y is None or x is None:
                continue
            m = np.isfinite(x) & np.isfinite(y)
            out.append({
                "kind": f"per_task:{key[:-9]}",
                "dataset": dataset, "config": config,
                "baseline": baseline,
                "x": x[m].tolist(), "y": y[m].tolist(),
                # bio/result_analysis.py:139
                "negative_transfer_tasks": int(np.sum(x[m] > y[m] + 1e-3)),
            })

    base = {
        (r["dataset"], r["seed"]): r["test_auc"]
        for r in rows if r["config"] == baseline
    }
    pts = defaultdict(list)
    for r in rows:
        if r["config"] == baseline:
            continue
        b = base.get((r["dataset"], r["seed"]))
        if b is not None:
            pts[(r["dataset"], r["config"])].append((b, r["test_auc"]))
    for (dataset, config), xy in sorted(pts.items()):
        x, y = zip(*xy)
        out.append({
            "kind": "per_seed", "dataset": dataset, "config": config,
            "baseline": baseline, "x": list(x), "y": list(y),
        })
    return out


def make_plots(pair_data, plots_dir: str):
    """Scatter plots matching bio/result_analysis.py:86-135 (y = config,
    x = baseline, red y=x diagonal, unit square). Skipped gracefully when
    matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover
        print("[aggregate] matplotlib unavailable; pairwise data only")
        return []
    os.makedirs(plots_dir, exist_ok=True)
    written = []
    for d in pair_data:
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(d["x"], d["y"], s=12)
        ax.plot([0, 1], [0, 1], "red", linewidth=1)
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.set_xlabel(d["baseline"])
        ax.set_ylabel(d["config"])
        kind = d["kind"].replace(":", "_").replace("/", "_")
        name = (f"pairwise_{d['dataset']}_{d['config']}"
                f"_vs_{d['baseline']}_{kind}.png")
        fig.savefig(os.path.join(plots_dir, name), dpi=120)
        plt.close(fig)
        written.append(name)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--result_dir", default="runs/sweep")
    p.add_argument("--out", default="")
    p.add_argument("--baseline", default="nopretrain",
                   help="config name used for negative-transfer pairing")
    p.add_argument("--plots_dir", default="",
                   help="emit pairwise scatter plots (matplotlib) here "
                        "(bio/result_analysis.py:84-139 analogue)")
    p.add_argument("--from_tensorboard", type=int, default=0,
                   help="read TensorBoard event files (the reference's "
                        "result format) instead of result.json files")
    args = p.parse_args(argv)
    rows = (collect_tensorboard(args.result_dir) if args.from_tensorboard
            else collect(args.result_dir))
    table = summarize(rows)
    for t in table:
        extras = " ".join(
            f"{k[5:]}={t[k]:.4f}" for k in t
            if k.startswith("mean_test_") and k != "mean_test_auc"
        )
        print(
            f"{t['dataset']:>12} {t['config']:>24} "
            f"{t['mean_test_auc']:.4f} ± {t['std_test_auc']:.4f} "
            f"({t['n_seeds']} seeds) {extras}"
        )
    nt = negative_transfer(rows, args.baseline)
    for t in nt:
        print(
            f"  vs {args.baseline}: {t['dataset']:>12} {t['config']:>24} "
            f"gain {t['mean_gain']:+.4f}, negative transfer in "
            f"{t['negative_transfer_seeds']}/{t['n_pairs']} seeds"
        )
    pairs = pairwise_points(rows, args.baseline)
    for d in pairs:
        if d["kind"].startswith("per_task"):
            print(
                f"  per-task {d['dataset']:>12} {d['config']:>24} "
                f"({len(d['x'])} tasks) negative transfer in "
                f"{d['negative_transfer_tasks']} tasks"
            )
    if args.plots_dir:
        written = make_plots(pairs, args.plots_dir)
        print(f"[aggregate] {len(written)} scatter plots -> "
              f"{args.plots_dir}")
    if args.out:
        rows_out = [
            {k: v for k, v in r.items() if not k.endswith("_task_auc")}
            for r in rows
        ]
        with open(args.out, "w") as f:
            json.dump(
                {"runs": rows_out, "summary": table,
                 "negative_transfer": nt, "pairwise": pairs},
                f,
            )
    return table


if __name__ == "__main__":
    main()
