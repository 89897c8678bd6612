#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one GPU.

Run from the repository root:

    python3 scripts/torch_port_profile.py [--domain chem|bio]
        [--objective masking|edgepred|supervised]
        [--gnn_type gin|gcn|gat|graphsage]
        [--gat_fused on|off] [--gin_fused on|off]

Configurations (float32, 5 x 300, batch 256), the workloads of
chip_smoke.py's main paths:
  - chem (default): synthetic molecules (23 atoms on average); masking
    runs with mask_edge off;
  - bio: synthetic ego-networks (``bio_dataset(4096, seed=0)``, about 60
    nodes on average);
  - masking (default), edge prediction, whose batches carry the C++
    sampler's block-aligned negative pairs, or supervised pretraining
    (mean pooling, dropout 0.2; chem on 1,310 synthetic tasks, bio on
    5,000 ``go_target_pretrain`` labels, the reference's label widths;
    its loader has no transform);
  - with ``--gnn_type gat``, ``--gat_fused off`` takes the unfused GATConv
    (the blocked GAT attention K5) instead of the fused GAT conv K4; with
    ``--gnn_type gin`` (chem), ``--gin_fused off`` takes the unfused
    GINConv (K2 ``[x+ein]`` and cuBLAS for the MLP) instead of the fused
    GIN conv K1.
It prints, for the card named on its first line:
  - host: ms to pack one batch and apply its transform (masking or
    negative sampling; the loader, on one thread), and the transform's
    share alone;
  - device-only step: ms per train step over batches already on the card,
    and the host's time to enqueue one step on an idle card;
  - the main path: ``run_pretrain`` for EPOCHS epochs, its ms per step and
    valid edges/s over epochs 2 onward, from the epoch log lines;
  - ``run_pretrain`` once more with torch.profiler on over epochs 2 onward
    (started and stopped by the epoch log hook): device time per kernel
    name and per step, the share of the port's own kernels among it, and
    the device's busy share against the unprofiled run's step time (the
    profiler slows the host);
and one JSON line with those numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from pretrain_gnns_tpu_torch.data.synthetic import (  # noqa: E402
    bio_dataset, molecule_dataset,
)
from pretrain_gnns_tpu_torch.device import resolve_device  # noqa: E402
from pretrain_gnns_tpu_torch.ops import gat_conv, gin_conv  # noqa: E402
from pretrain_gnns_tpu_torch.train import optim, pretrain  # noqa: E402
from pretrain_gnns_tpu_torch.train.state import TrainState  # noqa: E402

STEPS = 20
EPOCHS = 3  # epoch 1 warms up; epochs 2-3 are measured


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def run_main_path(cfg, graphs, prof=None):
    """``run_pretrain`` on the card; returns (seconds, steps, valid edges)
    over epochs 2 to EPOCHS, with ``prof`` running over just those."""
    stamps = []

    def log(msg):
        if not msg.startswith("epoch="):
            return
        stamps.append(time.perf_counter())
        if prof is not None and len(stamps) == 1:
            prof.start()
        elif prof is not None and len(stamps) == EPOCHS:
            prof.stop()  # the epoch's loss readback has synchronised

    res = pretrain.run_pretrain(cfg, graphs, log=log, epochs=EPOCHS,
                                device="cuda")
    hist = res["history"][1:]
    return (stamps[-1] - stamps[0], sum(h["steps"] for h in hist),
            sum(h["edges"] for h in hist))


# name fragments of the port's own kernels (csrc/*.cu); K1 and K4 share
# the GEMM and the column sums of gemm.cuh, K1 and K2 the aggregation of
# edge_aggr.cuh (K1's instantiation has the self term, <..., true, VEC>),
# and K1, K2 and K4 sum their per-block partials with a kernel of the same
# name
OWN_KERNELS = {"K1 aggregation": tuple(f"edge_aggr_{d}_kernel<true, true, true,"
                                       for d in ("fwd", "bwd")),
               "GEMM and column sums (K1, K4)": ("::gemm_kernel",
                                                 "colsum_partial_"),
               "K2": tuple(f"edge_aggr_{d}_kernel<{v}, false,"
                           for d in ("fwd", "bwd")
                           for v in ("true, false", "false, true",
                                     "true, true")),
               "K3": ("edot_",), "K4/K5 attention": ("gat_",),
               "partial sums (K1, K2, K4)": ("sum_partials_",)}


def workload(domain: str, objective: str, gnn_type: str):
    """(graphs, config) of chip_smoke.py's path of that name."""
    supervised = objective == "supervised"
    if domain == "bio":
        graphs = bio_dataset(4096, seed=0,
                             **({"num_pretrain": 5000} if supervised else {}))
    else:
        graphs, _ = molecule_dataset(4096, num_tasks=1310 if supervised else 1,
                                     seed=0, mean_atoms=23)
    extra = {}
    if supervised:
        graphs, tasks = pretrain.supervised_graphs(graphs, domain)
        extra = dict(num_tasks=tasks, graph_pooling="mean",
                     dropout_ratio=0.2)
    return graphs, pretrain.PretrainConfig(
        objective=objective, domain=domain, gnn_type=gnn_type, num_layer=5,
        emb_dim=300, batch_size=256, mask_edge=False, seed=0, **extra)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--domain", default="chem", choices=["chem", "bio"])
    p.add_argument("--objective", default="masking",
                   choices=["masking", "edgepred", "supervised"])
    p.add_argument("--gnn_type", default="gin",
                   choices=["gin", "gcn", "gat", "graphsage"])
    p.add_argument("--gat_fused", default="on", choices=["on", "off"])
    p.add_argument("--gin_fused", default="on", choices=["on", "off"])
    args = p.parse_args()
    gat_conv.set_fused(args.gat_fused)
    gin_conv.set_fused(args.gin_fused)
    dev = resolve_device("cuda")
    graphs, cfg = workload(args.domain, args.objective, args.gnn_type)
    path = (f"{args.domain} {args.objective} {args.gnn_type}"
            + " unfused" * ("off" in (args.gat_fused, args.gin_fused)))
    loader = pretrain.build_loader(cfg, graphs, dev)

    # host: pack + transform, one thread; then the transform alone
    it = iter(loader)
    host_ms, transform_ms = [], []
    for _ in range(8):
        t = time.perf_counter()
        host_batch = next(it)
        host_ms.append((time.perf_counter() - t) * 1e3)
    rng = np.random.default_rng(0)
    for _ in range(8):
        t = time.perf_counter()
        if loader.post_transform is not None:  # supervised has none
            loader.post_transform(host_batch, rng)
        transform_ms.append((time.perf_counter() - t) * 1e3)
    batches = [b.to(dev) for b in list(loader)[:4]]

    # device-only step: train_step over batches already on the card
    model = pretrain.build_objective(cfg).to(dev)
    state = TrainState(model, optim.adam(model.parameters(), cfg.lr))
    for b in batches:  # warm up
        pretrain.train_step(state, b)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(STEPS):
        pretrain.train_step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    device_step_ms = (time.perf_counter() - t) / STEPS * 1e3
    enqueue_ms = []
    for i in range(5):  # host time to launch one step on an idle card
        torch.cuda.synchronize()
        t = time.perf_counter()
        pretrain.train_step(state, batches[i % len(batches)])
        enqueue_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()

    # the main path, then the main path under the profiler
    secs, steps, edges = run_main_path(cfg, graphs)
    step_ms = secs / steps * 1e3
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    p_secs, p_steps, _ = run_main_path(cfg, graphs, prof)
    events = prof.key_averages()
    # ranges annotated on the host (autograd nodes, Optimizer.step) are
    # mirrored on the device timeline over the kernels they launch: count
    # only the kernels, copies and memsets themselves
    host_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [(e.key, _device_us(e) / 1e3, e.count) for e in events
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0
               and e.key not in host_keys]
    kernels.sort(key=lambda r: -r[1])
    busy_step_ms = sum(r[1] for r in kernels) / p_steps
    own = {k: sum(ms for n, ms, _ in kernels
                  if any(f in n for f in frags)) / p_steps
           for k, frags in OWN_KERNELS.items()}
    card = torch.cuda.get_device_name(0)
    print(f"card: {card}; {path}")
    print(f"host pack+transform: median {statistics.median(host_ms):.3f} ms "
          f"per batch ({int(host_batch.edge_mask.sum())} valid edges), the "
          f"transform alone {statistics.median(transform_ms):.3f} ms")
    print(f"device-only step: {device_step_ms:.3f} ms; host enqueue of one "
          f"step: median {statistics.median(enqueue_ms):.3f} ms")
    print(f"run_pretrain: {step_ms:.3f} ms/step, {edges / secs:.1f} valid "
          f"edges/s over {steps} steps (epochs 2-{EPOCHS})")
    print(f"run_pretrain profiled: {p_secs / p_steps * 1e3:.3f} ms/step; "
          f"device busy {busy_step_ms:.3f} ms/step = "
          f"{100 * busy_step_ms / step_ms:.1f}% of the unprofiled step; "
          "of it the port's kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in own.items()))
    print(f"device time by kernel (ms over {p_steps} steps, launches):")
    for name, ms, count in kernels[:25]:
        print(f"  {ms:9.3f}  {count:6d}  {name[:110]}")
    print(json.dumps({
        "card": card, "path": path,
        "host_pack_transform_ms": statistics.median(host_ms),
        "host_transform_ms": statistics.median(transform_ms),
        "own_kernels_ms_per_step": own,
        "device_step_ms": device_step_ms,
        "enqueue_ms": statistics.median(enqueue_ms),
        "main_path_step_ms": step_ms,
        "main_path_edges_per_s": edges / secs,
        "profiled_step_ms": p_secs / p_steps * 1e3,
        "device_busy_ms_per_step": busy_step_ms,
        "device_busy_share": busy_step_ms / step_ms,
        "top_kernels_ms_per_step": {n[:80]: ms / p_steps
                                    for n, ms, _ in kernels[:10]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
