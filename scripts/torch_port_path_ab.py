#!/usr/bin/env python3
"""Edges/s of one masking pretraining path with this tree's kernel library
against another checkout's, in one process on one GPU.

Run from the repository root, with the other checkout's ``csrc`` directory
(for example a ``git archive`` of the parent commit unpacked under
``_archive/``):

    python3 scripts/torch_port_path_ab.py --ref_csrc _archive/parent/pretrain_gnns_tpu_torch/csrc [--gnn_type gat|gin] [--dtype bfloat16_act|default|float32] [--pairs 3]

The path is the bench's chem cell (``python -m pretrain_gnns_tpu_torch.bench``:
16,384 molecules of ``molecule_dataset(..., mean_atoms=23)``, batch 256, 5 x
300, masking with ``mask_edge`` off) with the trunk ``--gnn_type`` (GAT: the
fused GAT conv, K4; GIN: the fused GIN conv, K1) at the bench's ``--dtype``
knobs (default ``bfloat16_act``, the JAX bench's recipe). The library that
runs the trunk's kernel (``gat`` or ``gin_conv``) is built from the other
checkout's sources with this tree's flags (``torch_port_k1_k4_ab.build``)
and swapped in for the reference's runs; everything else is this tree's.
Each run is the bench's ``run_cell`` (2 warm-up epochs, then 3 windows of 2
epochs, the median window; CUDA-graph replays of 16 steps), in the order
reference, this tree, this tree, reference, ``--pairs`` times. It prints
each run's edges/s and the ratio of the medians, beside the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pretrain_gnns_tpu_torch import bench  # noqa: E402
from pretrain_gnns_tpu_torch.data.synthetic import (  # noqa: E402
    molecule_dataset,
)
from pretrain_gnns_tpu_torch.models import inits  # noqa: E402
from pretrain_gnns_tpu_torch.ops import spmm  # noqa: E402
from pretrain_gnns_tpu_torch.train import pretrain  # noqa: E402
from scripts.torch_port_k1_k4_ab import build, use  # noqa: E402

LIBRARY = {"gat": "gat", "gin": "gin_conv"}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ref_csrc", required=True,
                   help="the other checkout's pretrain_gnns_tpu_torch/csrc")
    p.add_argument("--gnn_type", default="gat", choices=sorted(LIBRARY))
    p.add_argument("--dtype", default="bfloat16_act",
                   choices=sorted(bench.DTYPES))
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--graphs", type=int, default=16384)
    args = p.parse_args()
    card = bench.card_line()
    graphs = molecule_dataset(args.graphs, num_tasks=1, seed=0,
                              mean_atoms=23)[0]
    cfg = pretrain.PretrainConfig(mask_edge=False, gnn_type=args.gnn_type,
                                  num_layer=5, emb_dim=300, batch_size=256,
                                  seed=0)
    cell = argparse.Namespace(window_epochs=2, windows=3, device="cuda")
    rates = {"ref": [], "tree": []}
    knobs = inits.get_compute_dtype(), spmm.get_compute_dtype()
    inits.set_compute_dtype(bench.DTYPES[args.dtype][0])
    spmm.set_compute_dtype(bench.DTYPES[args.dtype][1])
    try:
        with tempfile.TemporaryDirectory() as tmp:
            name = LIBRARY[args.gnn_type]
            ref = {name: build(args.ref_csrc, name, tmp)}
            for _ in range(args.pairs):
                for tag in ("ref", "tree", "tree", "ref"):
                    use(ref if tag == "ref" else {})
                    rate = bench.run_cell(cfg, graphs, cell)["value"]
                    rates[tag].append(rate)
                    print(f"  {tag}: {rate:.1f} valid edges/s", flush=True)
            use({})
    finally:
        inits.set_compute_dtype(knobs[0])
        spmm.set_compute_dtype(knobs[1])
    r, t = statistics.median(rates["ref"]), statistics.median(rates["tree"])
    print(f"card: {card}; chem masking {args.gnn_type} at --dtype "
          f"{args.dtype}, valid edges/s (median of {len(rates['tree'])} "
          f"runs): reference {args.ref_csrc} {r:.1f}, this tree {t:.1f}: "
          f"{t / r:.3f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
