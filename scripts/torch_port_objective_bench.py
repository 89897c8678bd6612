"""Per-objective end-to-end pretraining throughput of the port (valid
edges/s on one GPU): every self-supervised and supervised objective,
chem and bio, through ``run_pretrain``'s pipeline on the data of the JAX
package's ``scripts/objective_bench.py``, one JSON line each. It is the
per-objective companion of ``python -m pretrain_gnns_tpu_torch.bench``
(which times chem and bio masking only), a timing script, not a bench
cell.

Usage, from the repository root:

    [OBJS="masking edgepred_gcn bio_contextpred"] [DTYPE=bfloat16_act]
    [TRANSFORM=batch|host] [DEVICE_DATASET="off on"] [PAIRS=1]
    [EPOCHS=24] python3 scripts/torch_port_objective_bench.py

``OBJS`` names the rows (the JAX script's roster by default: masking,
infomax, edgepred, contextpred, supervised and their ``bio_`` twins; a
``_gat``, ``_gcn`` or ``_graphsage`` suffix picks the trunk). ``DTYPE``
sets both precision knobs as the bench's ``--dtype``: ``bfloat16_act``
(the JAX script's default), ``default`` (the knobs' own defaults) or
``float32``. ``TRANSFORM`` is ``PretrainConfig.transform_device``:
``batch`` (the vectorized pass a batch and the presampled contexts, what
``auto`` means) or ``host`` (the reference's per-graph transforms in the
loader); a space-separated list runs each row under each, side by side.
``DEVICE_DATASET`` is ``PretrainConfig.device_dataset`` (``auto`` by
default, which is on with CUDA; ``on`` keeps the dataset on the card and
trains through the epoch trainer at its default group, 8 epochs at these
rows' 32 steps an epoch), also a list; ``PAIRS`` repeats the whole list
that many times, so that settings alternate within one call.
Each group of 16 batches is one CUDA-graph replay (``scan_steps`` 16).
The run's first group of epochs, or its first SKIP epochs where each
epoch is a group of its own, warms up (the eager steps and the capture);
the rest is timed between the run's marks on the card's clock
(``run_pretrain``'s ``marks``, ``telemetry.seconds_between``: from the
end of the warm-up's steps to the end of the last epoch's, the idle gaps
included), over the valid edges of exactly those epochs. Each line also
carries the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``) and the seconds the
row took, set-up included.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pretrain_gnns_tpu_torch.data.synthetic import (  # noqa: E402
    bio_dataset, molecule_dataset,
)
from pretrain_gnns_tpu_torch.models import inits  # noqa: E402
from pretrain_gnns_tpu_torch.ops import spmm  # noqa: E402
from pretrain_gnns_tpu_torch.train import pretrain  # noqa: E402
from pretrain_gnns_tpu_torch.train.telemetry import (  # noqa: E402
    seconds_between,
)

N_GRAPHS = 8192  # chem; bio 2,048 at batch 64: 32 steps an epoch either way
SKIP = 2  # warm-up epochs: the eager steps, then the capture
ROSTER = ("masking infomax edgepred contextpred supervised bio_masking "
          "bio_edgepred bio_infomax bio_contextpred bio_supervised")
# DTYPE: (models.inits knob, ops.spmm knob), as the bench's --dtype
DTYPES = {"float32": ("float32", "float32"),
          "default": ("float32", "bfloat16"),
          "bfloat16_act": ("bfloat16_act", "bfloat16")}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def config(row: str, transform: str, device_dataset: str = "auto"):
    """The row's data and ``PretrainConfig`` (the JAX script's)."""
    objective, gnn_type = row, "gin"
    for arch in ("gat", "gcn", "graphsage"):
        if objective.endswith("_" + arch):
            objective, gnn_type = objective[: -len(arch) - 1], arch
    common = dict(num_layer=5, emb_dim=300, seed=0, scan_steps=16,
                  packing="auto", gnn_type=gnn_type,
                  transform_device=transform, device_dataset=device_dataset)
    if objective.startswith("bio_"):
        graphs = bio_dataset(2048, num_downstream=3, seed=0, mean_nodes=60)
        for g in graphs:
            g.extras = {"center_node_idx": g.extras["center_node_idx"]}
        objective = objective[4:]
        return graphs, pretrain.PretrainConfig(
            objective=objective, domain="bio", batch_size=64,
            num_tasks=graphs[0].y.shape[-1],
            dropout_ratio=0.2 if objective == "supervised" else 0.0,
            **common)
    graphs, _ = molecule_dataset(N_GRAPHS, num_tasks=12, seed=0,
                                 mean_atoms=23)
    return graphs, pretrain.PretrainConfig(
        objective=objective, batch_size=256, mask_edge=False, num_tasks=12,
        dropout_ratio=0.2 if objective == "supervised" else 0.0, **common)


def run(row: str, transform: str, epochs: int, card: str,
        device_dataset: str = "auto") -> dict:
    t0 = time.perf_counter()
    graphs, cfg = config(row, transform, device_dataset)
    res = pretrain.run_pretrain(cfg, graphs, log=None, epochs=epochs,
                                device="cuda")
    marks = res["marks"]
    start = next((m for m in marks if m.epoch >= SKIP), None)
    if start is None or start is marks[-1]:
        raise SystemExit(f"{row}: EPOCHS={epochs} leaves no epoch to time "
                         f"after the warm-up (epoch group "
                         f"{res['epoch_group']})")
    edges = sum(h["edges"] for h in res["history"]
                if h["epoch"] > start.epoch)
    return {"objective": row, "transform": transform,
            "device_dataset": device_dataset,
            "epoch_group": res["epoch_group"],
            "dtype": os.environ.get("DTYPE", "bfloat16_act"),
            "edges_per_sec": round(
                edges / seconds_between(start, marks[-1]), 1),
            "timed_epochs": marks[-1].epoch - start.epoch,
            "steps_per_epoch": res["history"][-1]["steps"],
            "replays": res["replays"], "eager_steps": res["eager_steps"],
            "loader": type(res["loader"]).__name__,
            "seconds": round(time.perf_counter() - t0, 1), "card": card}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_port_objective_bench: no CUDA device", file=sys.stderr)
        return 1
    dtype = os.environ.get("DTYPE", "bfloat16_act")
    inits.set_compute_dtype(DTYPES[dtype][0])
    spmm.set_compute_dtype(DTYPES[dtype][1])
    epochs = int(os.environ.get("EPOCHS", "24"))
    if epochs <= SKIP:
        raise SystemExit(f"EPOCHS must exceed the {SKIP} warm-up epochs")
    card = card_line()
    for _ in range(int(os.environ.get("PAIRS", "1"))):
        for row in (os.environ.get("OBJS") or ROSTER).split():
            for transform in os.environ.get("TRANSFORM", "batch").split():
                for dd in os.environ.get("DEVICE_DATASET", "auto").split():
                    print(json.dumps(run(row, transform, epochs, card, dd)),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
