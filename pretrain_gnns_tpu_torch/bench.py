"""Throughput benchmark of the port: attribute-masking pretraining in valid
edges per second on one GPU.

Run from the repository root:

    python -m pretrain_gnns_tpu_torch.bench

Cells (float32, seed 0 for the data and the weights):
  - chem, the headline: the workload of the JAX package's ``bench.py``:
    16,384 molecules of ``molecule_dataset(..., num_tasks=1, mean_atoms=23)``,
    batch 256, GIN 5 x 300, masking with ``mask_edge`` off;
  - bio: bio masking GIN on ``bio_dataset(4,096)`` with the reference's
    ``bio/pretrain_masking.py`` defaults (batch 256, 5 x 300, mask rate
    0.15).
Each cell runs ``run_pretrain(..., device="cuda")`` with its default
pipeline (``build_loader``: the flat dataset and the C++ packer, the
masking pass on the prefetch thread) and ``--scan_steps`` train steps a
dispatch (0, the default, resolves to 16 on CUDA: one CUDA-graph replay a
group of 16 batches; 1 runs every step eagerly). Epochs 1 and 2 warm up
(the first eager steps and the capture, which falls in epoch 1 or 2 at the
cells' 64 and 16 steps an epoch; both sides of a comparison warm up alike);
then ``--windows``
windows of ``--window_epochs`` whole epochs each are timed in the same
run: the wall time between the epoch log stamps (``run_pretrain`` reads the
loss back at each epoch's end, so a stamp follows the card's work) and
the valid edges of exactly those epochs, each directed edge once a step.
A cell reports the median window and the spread, (max - min) / median.

Prints exactly one JSON line: each cell under its metric name (its value,
windows, spread and loader), the dtype, and the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them. Without CUDA it exits non-zero unless
``--device cpu`` is given; the options shrink the workload for such a run.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--graphs", type=int, default=16384,
                   help="molecules of the chem cell")
    p.add_argument("--bio_graphs", type=int, default=4096,
                   help="ego-networks of the bio cell")
    p.add_argument("--num_layer", type=int, default=5)
    p.add_argument("--emb_dim", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--windows", type=int, default=5)
    p.add_argument("--window_epochs", type=int, default=4,
                   help="whole epochs in one timed window")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scan_steps", type=int, default=0,
                   help="train steps a dispatch (0 = auto: 16 on CUDA, 1 "
                        "on the CPU)")
    return p


WARMUP_EPOCHS = 2


def run_cell(cfg, graphs, args):
    """``run_pretrain`` for WARMUP_EPOCHS + windows * window_epochs epochs;
    the timed windows' rates and the run's facts."""
    import torch

    from pretrain_gnns_tpu_torch.train import pretrain

    k = args.window_epochs
    stamps = []

    def log(msg):
        if msg.startswith("epoch="):
            stamps.append(time.perf_counter())

    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = pretrain.run_pretrain(cfg, graphs, log=log,
                                epochs=WARMUP_EPOCHS + args.windows * k,
                                device=args.device)
    hist = res["history"]
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise RuntimeError(f"non-finite loss: {hist}")
    windows = []
    for w in range(args.windows):
        # stamps[i] closes epoch i + 1; window w is the k epochs after
        # epoch WARMUP_EPOCHS + w * k
        a = WARMUP_EPOCHS + w * k
        edges = sum(h["edges"] for h in hist[a: a + k])
        windows.append(edges / (stamps[a + k - 1] - stamps[a - 1]))
    med = statistics.median(windows)
    out = {
        "value": med, "unit": "valid edges/s", "windows": windows,
        "spread": (max(windows) - min(windows)) / med,
        "epochs_per_window": k, "steps_per_epoch": hist[-1]["steps"],
        "edges_per_epoch": hist[-1]["edges"],
        "warmup_epochs": WARMUP_EPOCHS,
        "warmup_s": stamps[WARMUP_EPOCHS - 1] - t0,
        "epoch_s": [b - a for a, b in zip(stamps, stamps[1:])],
        "final_loss": hist[-1]["loss"],
        "loader": type(res["loader"]).__name__,
        "replays": res["replays"], "eager_steps": res["eager_steps"],
        "blocks": res["loader"].blocks,
    }
    if args.device == "cuda":
        out["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return out


def cells(args):
    """``(metric, config, make_graphs)`` of the chem cell, then the bio
    cell, at the sizes ``args`` give."""
    from pretrain_gnns_tpu_torch.data.synthetic import (
        bio_dataset, molecule_dataset,
    )
    from pretrain_gnns_tpu_torch.train.pretrain import PretrainConfig

    L, D = args.num_layer, args.emb_dim
    per = "per_gpu" if args.device == "cuda" else "per_cpu"
    common = dict(objective="masking", num_layer=L, emb_dim=D,
                  batch_size=args.batch_size, seed=args.seed,
                  scan_steps=args.scan_steps)
    metric = f"masking_pretrain_gin{L}_{D}_e2e_edges_per_sec_{per}"
    return [
        (metric, PretrainConfig(mask_edge=False, **common),
         lambda: molecule_dataset(args.graphs, num_tasks=1, seed=args.seed,
                                  mean_atoms=23)[0]),
        ("bio_" + metric, PretrainConfig(domain="bio", **common),
         lambda: bio_dataset(args.bio_graphs, seed=args.seed)),
    ]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from pretrain_gnns_tpu_torch.train.pretrain import resolve_scan_steps

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device; pass --device cpu to run on the CPU "
              "(no GPU metric then)", file=sys.stderr)
        return 1
    result = {}
    for metric, cfg, make_graphs in cells(args):
        t = time.perf_counter()
        graphs = make_graphs()
        setup = time.perf_counter() - t
        cell = run_cell(cfg, graphs, args)
        cell["dataset_s"], cell["graphs"] = setup, len(graphs)
        if not result:  # the chem cell is the headline
            result.update(metric=metric, value=cell["value"],
                          unit=cell["unit"])
        result[metric] = cell
    result.update(
        dtype="float32", device=args.device,
        card=card_line() if args.device == "cuda" else None,
        kind=(torch.cuda.get_device_name(0) if args.device == "cuda"
              else "cpu"),
        batch_size=args.batch_size, seed=args.seed,
        scan_steps=resolve_scan_steps(args.scan_steps, args.device))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
