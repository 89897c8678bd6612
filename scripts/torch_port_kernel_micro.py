#!/usr/bin/env python3
"""Time the PyTorch port's aggregation kernels alone, on one GPU: the
counterpart of ``scripts/kernel_micro.py`` (which times the JAX package's
Pallas kernels) on the same workload.

Run from the repository root:

    python3 scripts/torch_port_kernel_micro.py [--block_nodes 128]
        [--block_edges 384] [--trials 20] [--reps 10]

Workload: the first batch of ``molecule_dataset(256, num_tasks=1, seed=0,
mean_atoms=23)`` in blocks of 128 nodes / 384 edge slots, F = 300, float32,
random features from a numpy seed. After the card's name and power limit
it prints one line a row, with microseconds a call and millions of valid
edges a second:
  - the fused edge-transform SpMM (K2, ``[x+ein]``, K = 9): forward, and
    forward + backward (the two kernels' entry points back to back, the
    cotangent fixed: through autograd the host's time between launches
    would be what the events read);
  - the blocked SpMM on a precomputed edge embedding (K6): forward;
  - the receiver-sorted blocked SpMM (K7): forward on edges sorted
    beforehand, and with ``sort_block_edges`` inside the timed region;
  - the blocked GAT attention (K5, 2 heads): forward + backward.
Times are device time a call: one CUDA event pair around ``--reps``
back-to-back calls after a 2 ms spin of the card (so that the host has
enqueued them all before the first starts), the median over ``--trials``.
It needs a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pretrain_gnns_tpu_torch.data.packing import (  # noqa: E402
    PackedLoader, block_layout,
)
from pretrain_gnns_tpu_torch.data.synthetic import (  # noqa: E402
    molecule_dataset,
)
from pretrain_gnns_tpu_torch.device import resolve_device  # noqa: E402
from pretrain_gnns_tpu_torch.ops import (  # noqa: E402
    attention, blocked_spmm, sorted_spmm,
)

GRAPHS, F, K, HEADS, SLOPE = 256, 300, 9, 2, 0.2
WARMUP = 5
SPIN_CYCLES = 3_500_000  # about 2 ms of the card's clock


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_us(fn, trials: int, reps: int) -> float:
    """Device microseconds a call (see the module docstring)."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps * 1e3)
    return statistics.median(times)


def main(argv=None):
    """Prints the table; returns its rows as ``{"name", "us",
    "medges_per_s"}`` dicts."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--block_nodes", type=int, default=128)
    p.add_argument("--block_edges", type=int, default=384)
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    bn, be = args.block_nodes, args.block_edges

    graphs, _ = molecule_dataset(GRAPHS, num_tasks=1, seed=0, mean_atoms=23)
    blocks = block_layout(graphs, GRAPHS, block_nodes=bn, block_edges=be)
    b = next(iter(PackedLoader(graphs, GRAPHS, shuffle=False, drop_last=True,
                               blocks=blocks))).to(dev)
    n_blocks, bn, be = blocks
    N, E = b.max_nodes, b.max_edges
    valid = int(b.edge_mask.sum())
    print(card_line())
    print(f"N={N} E={E} blocks={n_blocks} x ({bn}, {be}) "
          f"valid_edges={valid} F={F} float32")

    rng = np.random.default_rng(0)
    f32 = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32)).to(dev)
    x, ein, W = f32(N, F), f32(E, K), f32(K, F)
    w = b.edge_mask.to(torch.float32)
    snd, rcv = b.senders, b.receivers
    edges = (snd, rcv, w, bn, be)

    g = f32(N, F)

    def fused_fwd_bwd():  # the kernels' entry points, no autograd
        blocked_spmm.spmm_fwd(x, ein, W, *edges)
        blocked_spmm.spmm_bwd(g, ein, snd, rcv, w, K, bn, be)

    ee = f32(E, F)
    s2, r2, w2, ee2 = sorted_spmm.sort_block_edges(snd, rcv, w, ee, n_blocks,
                                                   be)

    def sorted_with_sort():
        ss, rr, ww, eee = sorted_spmm.sort_block_edges(snd, rcv, w, ee,
                                                       n_blocks, be)
        return sorted_spmm.sorted_blocked_spmm(x, eee, ss, rr, ww, bn, be)

    xh, gh = f32(N, HEADS, F), f32(N, HEADS, F)
    eh = f32(E, HEADS, F, scale=0.3)
    esh = f32(HEADS, F, scale=0.3)
    aih, ajh = f32(HEADS, F, scale=0.2), f32(HEADS, F, scale=0.2)

    def gat_fwd_bwd():
        _, saved = attention.gat_attn_fwd(xh, eh, esh, aih, ajh, snd, rcv, w,
                                          SLOPE, bn, be)
        attention.gat_attn_bwd(gh, xh, eh, esh, aih, ajh, snd, rcv, w, saved,
                               SLOPE, bn, be)

    with torch.no_grad():
        # the sorted kernel and the unsorted one compute the same function
        ref = blocked_spmm.blocked_spmm(x, ee, *edges)
        for got in (sorted_spmm.sorted_blocked_spmm(x, ee2, s2, r2, w2, bn,
                                                    be), sorted_with_sort()):
            err = float((got - ref).abs().max()) / max(
                1.0, float(ref.abs().max()))
            if not err <= 1e-5:
                raise AssertionError(
                    f"sorted and unsorted SpMM disagree: {err}")

    rows = [
        ("K2 fused [x+ein] fwd", lambda: blocked_spmm.blocked_spmm_fused(
            x, ein, W, *edges)),
        ("K2 fused [x+ein] fwd+bwd", fused_fwd_bwd),
        ("K6 blocked_spmm [x+ee] fwd",
         lambda: blocked_spmm.blocked_spmm(x, ee, *edges)),
        ("K7 sorted fwd", lambda: sorted_spmm.sorted_blocked_spmm(
            x, ee2, s2, r2, w2, bn, be)),
        ("K7 sorted + sort fwd", sorted_with_sort),
        ("K5 gat attention fwd+bwd", gat_fwd_bwd),
    ]
    results = []
    for name, fn in rows:
        with torch.no_grad():
            us = time_us(fn, args.trials, args.reps)
        results.append({"name": name, "us": us,
                        "medges_per_s": valid / us})
        print(f"{name:28s} {us:9.1f} us  {valid / us:9.1f} Medges/s")
    return results


if __name__ == "__main__":
    main()
