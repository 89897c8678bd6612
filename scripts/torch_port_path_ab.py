#!/usr/bin/env python3
"""Edges/s of one masking pretraining path with this tree's kernel library
against another checkout's, or at another precision, in one process on one
GPU.

Run from the repository root, with the other checkout's ``csrc`` directory
(for example a ``git archive`` of the parent commit unpacked under
``_archive/``):

    python3 scripts/torch_port_path_ab.py --ref_csrc _archive/parent/pretrain_gnns_tpu_torch/csrc [--domain chem|bio] [--gnn_type gat|gin] [--gin_fused on|off] [--dtype bfloat16_act|default|float32] [--pairs 3]
    python3 scripts/torch_port_path_ab.py --vs_dtype float32 --domain bio --dtype default [--pairs 10]

The path is one of the bench's cells (``python -m pretrain_gnns_tpu_torch.bench``)
at its trunk ``--gnn_type``: chem, 16,384 molecules of
``molecule_dataset(..., mean_atoms=23)``, masking with ``mask_edge`` off
(GAT: the fused GAT conv, K4; GIN: the fused GIN conv, K1, or with
``--gin_fused off`` the unfused one on K2 ``[x+ein]``); bio,
``bio_dataset(4,096)``, masking GIN on K2 ``[x]`` and ``[ein]``; batch 256,
5 x 300, at the bench's ``--dtype`` knobs (default ``bfloat16_act``, the
JAX bench's recipe). The library that runs the trunk's kernel (``gat``,
``gin_conv`` or ``spmm``) is built from the other checkout's sources with
this tree's flags (``torch_port_k1_k4_ab.build``) and swapped in for the
reference's runs; everything else is this tree's. With ``--vs_dtype`` the
reference's runs are this tree's at the bench's knobs of that name
instead. Each run is the bench's ``run_cell`` (2 warm-up epochs, then 3
windows of 2 epochs, the median window; CUDA-graph replays of 16 steps),
in the order reference, this tree, this tree, reference, ``--pairs``
times. It prints each run's edges/s and the ratio of the medians, beside
the card's name and power limit.
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
    bio_dataset, molecule_dataset,
)
from pretrain_gnns_tpu_torch.models import inits  # noqa: E402
from pretrain_gnns_tpu_torch.ops import gin_conv, spmm  # noqa: E402
from pretrain_gnns_tpu_torch.train import pretrain  # noqa: E402
from scripts.torch_port_k1_k4_ab import build, use  # noqa: E402

def library(args) -> str:
    """The library that runs the path's trunk kernel."""
    if args.gnn_type == "gat":
        return "gat"
    return "spmm" if args.domain == "bio" or args.gin_fused == "off" \
        else "gin_conv"


def set_knobs(dtype: str) -> None:
    inits.set_compute_dtype(bench.DTYPES[dtype][0])
    spmm.set_compute_dtype(bench.DTYPES[dtype][1])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ref_csrc",
                   help="the other checkout's pretrain_gnns_tpu_torch/csrc")
    p.add_argument("--vs_dtype", choices=sorted(bench.DTYPES),
                   help="instead: this tree at these knobs as the reference")
    p.add_argument("--domain", default="chem", choices=["chem", "bio"])
    p.add_argument("--gnn_type", default="gat", choices=["gat", "gin"])
    p.add_argument("--gin_fused", default="on", choices=["on", "off"])
    p.add_argument("--dtype", default="bfloat16_act",
                   choices=sorted(bench.DTYPES))
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--graphs", type=int, default=16384)
    args = p.parse_args()
    if (args.ref_csrc is None) == (args.vs_dtype is None):
        p.error("give one of --ref_csrc and --vs_dtype")
    card = bench.card_line()
    if args.domain == "bio":
        graphs = bio_dataset(4096, seed=0)
    else:
        graphs = molecule_dataset(args.graphs, num_tasks=1, seed=0,
                                  mean_atoms=23)[0]
    # the bench's cells: chem with mask_edge off, bio at the default
    cfg = pretrain.PretrainConfig(
        device_dataset="off",
        domain=args.domain, gnn_type=args.gnn_type, num_layer=5, emb_dim=300,
        batch_size=256, seed=0,
        **({} if args.domain == "bio" else {"mask_edge": False}))
    cell = argparse.Namespace(window_epochs=2, windows=3, device="cuda")
    rates = {"ref": [], "tree": []}
    knobs = inits.get_compute_dtype(), spmm.get_compute_dtype()
    fused = gin_conv.fused_enabled()
    gin_conv.set_fused(args.gin_fused)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            name = library(args)
            ref = {} if args.vs_dtype else {
                name: build(args.ref_csrc, name, tmp)}
            for _ in range(args.pairs):
                for tag in ("ref", "tree", "tree", "ref"):
                    use(ref if tag == "ref" else {})
                    set_knobs(args.vs_dtype if tag == "ref" and args.vs_dtype
                              else args.dtype)
                    rate = bench.run_cell(cfg, graphs, cell)["value"]
                    rates[tag].append(rate)
                    print(f"  {tag}: {rate:.1f} valid edges/s", flush=True)
            use({})
    finally:
        inits.set_compute_dtype(knobs[0])
        spmm.set_compute_dtype(knobs[1])
        gin_conv.set_fused("on" if fused else "off")
    r, t = statistics.median(rates["ref"]), statistics.median(rates["tree"])
    ref = (f"this tree at --dtype {args.vs_dtype}" if args.vs_dtype
           else f"reference {args.ref_csrc}")
    print(f"card: {card}; {args.domain} masking {args.gnn_type}"
          f"{' unfused' if args.gin_fused == 'off' else ''} at --dtype "
          f"{args.dtype}, valid edges/s (median of {len(rates['tree'])} "
          f"runs): {ref} {r:.1f}, this tree {t:.1f}: {t / r:.3f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
