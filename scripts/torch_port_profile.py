#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one GPU.

Run from the repository root:

    python3 scripts/torch_port_profile.py [--domain chem|bio]
        [--objective masking|edgepred|infomax|supervised]
        [--gnn_type gin|gcn|gat|graphsage]
        [--gat_fused on|off] [--gin_fused on|off] [--scan_steps K]

One path a process: each row of PERF.md section 5 is measured in a
process of its own, so that no measurement follows another path's in the
same process (the profiler's and the caching allocator's state would
carry over).

Configurations (float32, both precision knobs pinned whatever
``PGT_SPMM_DTYPE`` says; 5 x 300, batch 256), the workloads of
chip_smoke.py's main paths:
  - chem (default): synthetic molecules (23 atoms on average); masking
    runs with mask_edge off;
  - bio: synthetic ego-networks (``bio_dataset(4096, seed=0)``, about 60
    nodes on average);
  - masking (default), edge prediction, whose batches carry the C++
    sampler's block-aligned negative pairs, Deep Graph Infomax (no
    transform) or supervised pretraining (mean pooling, dropout 0.2; chem
    on 1,310 synthetic tasks, bio on 5,000 ``go_target_pretrain`` labels,
    the reference's label widths; its loader has no transform);
  - with ``--gnn_type gat``, ``--gat_fused off`` takes the unfused GATConv
    (the blocked GAT attention K5) instead of the fused GAT conv K4; with
    ``--gnn_type gin`` (chem), ``--gin_fused off`` takes the unfused
    GINConv (K2 ``[x+ein]`` and cuBLAS for the MLP) instead of the fused
    GIN conv K1.
``--scan_steps`` is ``run_pretrain``'s (0, the default, resolves to 16:
one CUDA-graph replay a group of 16 batches; 1 runs every step eagerly).
It prints, for the card named on its first line (name and power limit,
as ``nvidia-smi --query-gpu=name,power.limit`` reads them):
  - host: ms to pack one batch and apply its transform (masking or
    negative sampling; ``build_loader``'s loader, named, on one thread),
    and the transform's share alone;
  - device-only step: ms per train step over batches already on the card,
    and the host's time to enqueue one eager step on an idle card, split
    into the forward (module Python: the objective, the trunk and the
    loss), autograd's backward engine, the launch calls (the port's ctypes
    calls, timed around each call, and the CUDA runtime's launch, copy and
    memset calls that torch makes, summed from the profiler's CPU-side
    trace, which inflates them) and Adam (its own launches included);
  - with K > 1, a captured group: the host's ms a step of one call of the
    ``ScanStep`` (the K batches' copies to its slots and one replay) on an
    idle card, and the call's wall ms a step until the card is done;
  - the main path: ``run_pretrain`` for EPOCHS epochs, its ms per step and
    valid edges/s over epochs 3 onward (epochs 1 and 2 hold the first
    eager steps and the capture), from the epoch log lines;
  - ``run_pretrain`` once more with torch.profiler on over epochs 3 onward
    (started and stopped by the epoch log hook): device time per kernel
    name and per step, the share of the port's own kernels among it, and
    the device's busy share against the unprofiled run's step time (the
    profiler slows the host), the launches a step on the card and the
    ``aten::_to_copy`` calls a step (dtype casts and the batch's copies
    to the card);
and one JSON line with those numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import (  # noqa: E402
    ProfilerActivity, profile, record_function,
)

from pretrain_gnns_tpu_torch.data.synthetic import (  # noqa: E402
    bio_dataset, molecule_dataset,
)
from pretrain_gnns_tpu_torch.device import resolve_device  # noqa: E402
from pretrain_gnns_tpu_torch.models import inits  # noqa: E402
from pretrain_gnns_tpu_torch.ops import gat_conv, gin_conv, spmm  # noqa: E402,E501
from pretrain_gnns_tpu_torch.train import graphed, optim, pretrain  # noqa: E402,E501
from pretrain_gnns_tpu_torch.train.state import TrainState  # noqa: E402

STEPS = 20
# the CUDA runtime's calls that launch work, as the profiler names them
LAUNCH_API = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
              "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
              "cudaGraphLaunch")
EPOCHS = 4  # epochs 1-2 warm up (and capture); epochs 3-4 are measured


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def run_main_path(cfg, graphs, prof=None):
    """``run_pretrain`` on the card; returns (seconds, steps, valid edges)
    over epochs 3 to EPOCHS, with ``prof`` running over just those."""
    stamps = []

    def log(msg):
        if not msg.startswith("epoch="):
            return
        stamps.append(time.perf_counter())
        if prof is not None and len(stamps) == 2:
            prof.start()
        elif prof is not None and len(stamps) == EPOCHS:
            prof.stop()  # the epoch's loss readback has synchronised

    res = pretrain.run_pretrain(cfg, graphs, log=log, epochs=EPOCHS,
                                device="cuda")
    hist = res["history"][2:]
    return (stamps[-1] - stamps[1], sum(h["steps"] for h in hist),
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


class CtypesTimer:
    """Times every call of the loaded kernel libraries' ``pgt_*``
    functions (each inside a ``pgt::ctypes`` profiler range) while
    installed."""

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self._orig = []

    def __enter__(self):
        from pretrain_gnns_tpu_torch.ops import _build

        for lib in _build._libs.values():
            for name, fn in list(vars(lib).items()):
                if name.startswith("pgt_"):
                    self._orig.append((lib, name, fn))
                    setattr(lib, name, self._timed(fn))
        return self

    def __exit__(self, *exc):
        for lib, name, fn in self._orig:
            setattr(lib, name, fn)
        self._orig = []

    def _timed(self, fn):
        def call(*args):
            with record_function("pgt::ctypes"):
                t = time.perf_counter()
                out = fn(*args)
                self.seconds += time.perf_counter() - t
            self.calls += 1
            return out
        return call


PHASES = ("forward", "backward", "adam")


def _phased_step(state, batch, timer, out):
    """One eager train step in its three phases, each in a ``pgt::<phase>``
    profiler range; adds each phase's host ms and ctypes ms to ``out``."""
    for phase in PHASES:
        t, c = time.perf_counter(), timer.seconds
        with record_function(f"pgt::{phase}"):
            if phase == "forward":
                loss, _ = state.model(batch, train=True)
            elif phase == "backward":
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            else:
                state.optimizer.step()
        out[phase].append((time.perf_counter() - t) * 1e3)
        out[f"{phase} ctypes"].append((timer.seconds - c) * 1e3)


def enqueue_split(state, batches, steps=10):
    """The host's ms of one eager step on an idle card, by phase (medians
    over ``steps`` steps), with the ctypes calls timed inside them; then
    the same steps under the profiler (CPU side): the runtime's launch
    calls a step in each phase outside the ctypes calls, their count, and
    those inside (where the profiler sees the libraries' own launches)."""
    times = {k: [] for p in PHASES for k in (p, f"{p} ctypes")}
    with CtypesTimer() as timer:
        for i in range(steps):
            torch.cuda.synchronize()
            _phased_step(state, batches[i % len(batches)], timer, times)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            scratch = {k: [] for k in times}
            for i in range(steps):
                torch.cuda.synchronize()
                _phased_step(state, batches[i % len(batches)], timer,
                             scratch)
            torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = {name: [(e.time_range.start, e.time_range.end) for e in events
                    if e.name == name]
             for name in [f"pgt::{p}" for p in PHASES] + ["pgt::ctypes"]}

    def inside(e, name):
        return any(a <= e.time_range.start <= b for a, b in spans[name])

    api = [e for e in events if e.name in LAUNCH_API]
    out = {k: statistics.median(v) for k, v in times.items()}
    for p in PHASES:
        mine = [e for e in api if inside(e, f"pgt::{p}")]
        torch_calls = [e for e in mine if not inside(e, "pgt::ctypes")]
        out[f"{p} launch API"] = sum(
            e.time_range.elapsed_us() for e in torch_calls) / 1e3 / steps
        out[f"{p} launch API calls"] = len(torch_calls) / steps
        out[f"{p} launch API calls in ctypes"] = (
            len(mine) - len(torch_calls)) / steps
    return out


def split_parts(split):
    """The four parts of an eager step's enqueue: module Python (the
    forward and the loss, less their launch calls), autograd's backward
    engine (the backward less its launch calls), the launch calls (ctypes
    and torch's runtime calls, forward and backward) and Adam."""
    calls = {p: split[f"{p} ctypes"] + split[f"{p} launch API"]
             for p in ("forward", "backward")}
    return {"module Python": split["forward"] - calls["forward"],
            "autograd's backward engine": split["backward"]
            - calls["backward"],
            "launch calls": calls["forward"] + calls["backward"],
            "of them ctypes": split["forward ctypes"]
            + split["backward ctypes"],
            "Adam": split["adam"]}


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
        device_dataset="off",
        objective=objective, domain=domain, gnn_type=gnn_type, num_layer=5,
        emb_dim=300, batch_size=256, mask_edge=False, seed=0, **extra)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--domain", default="chem", choices=["chem", "bio"])
    p.add_argument("--objective", default="masking",
                   choices=["masking", "edgepred", "infomax", "supervised"])
    p.add_argument("--gnn_type", default="gin",
                   choices=["gin", "gcn", "gat", "graphsage"])
    p.add_argument("--gat_fused", default="on", choices=["on", "off"])
    p.add_argument("--gin_fused", default="on", choices=["on", "off"])
    p.add_argument("--scan_steps", type=int, default=0,
                   help="train steps a dispatch (0 = auto: 16 on CUDA)")
    args = p.parse_args()
    inits.set_compute_dtype("float32")
    spmm.set_compute_dtype("float32")
    gat_conv.set_fused(args.gat_fused)
    gin_conv.set_fused(args.gin_fused)
    dev = resolve_device("cuda")
    graphs, cfg = workload(args.domain, args.objective, args.gnn_type)
    cfg.scan_steps = args.scan_steps
    k = pretrain.resolve_scan_steps(cfg.scan_steps, dev)
    path = (f"{args.domain} {args.objective} {args.gnn_type}"
            + " unfused" * ("off" in (args.gat_fused, args.gin_fused))
            + f", scan_steps {k}")
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
        if loader.post_transform is not None:  # infomax, supervised: none
            loader.post_transform(host_batch, rng)
        transform_ms.append((time.perf_counter() - t) * 1e3)
    host_batches = [b.pin_memory() for b in list(loader)[:4]]
    batches = [b.to(dev) for b in host_batches]

    def fresh_state():
        model = pretrain.build_objective(cfg).to(dev)
        return TrainState(model, optim.adam(model.parameters(), cfg.lr))

    # device-only step: train_step over batches already on the card
    state = fresh_state()
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
    split = enqueue_split(state, batches)

    # a captured group: host ms of one ScanStep call, wall ms until done
    group = {}
    if k > 1:
        scan = pretrain.make_scan_pretrain_step(fresh_state(),
                                                host_batches[0], k)
        for b in host_batches[:graphed.WARMUP_STEPS]:
            scan.step(b)
        ks = [host_batches[i % len(host_batches)] for i in range(k)]
        scan(ks)  # the capture
        host_ms, wall_ms = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            scan(ks)
            host_ms.append((time.perf_counter() - t) * 1e3 / k)
            torch.cuda.synchronize()
            wall_ms.append((time.perf_counter() - t) * 1e3 / k)
        group = {"host_ms_per_step": statistics.median(host_ms),
                 "wall_ms_per_step": statistics.median(wall_ms)}

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
    launches_per_step = sum(r[2] for r in kernels) / p_steps
    # every dtype cast and every host-to-card copy of a batch's leaves
    to_copy_per_step = sum(e.count for e in events
                           if e.key == "aten::_to_copy"
                           and e.device_type == DeviceType.CPU) / p_steps
    busy_step_ms = sum(r[1] for r in kernels) / p_steps
    own = {k: sum(ms for n, ms, _ in kernels
                  if any(f in n for f in frags)) / p_steps
           for k, frags in OWN_KERNELS.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; {path}")
    print(f"host pack+transform ({type(loader).__name__}): median "
          f"{statistics.median(host_ms):.3f} ms per batch "
          f"({int(host_batch.edge_mask.sum())} valid edges), the transform "
          f"alone {statistics.median(transform_ms):.3f} ms")
    print(f"device-only step: {device_step_ms:.3f} ms; host enqueue of one "
          f"step: median {statistics.median(enqueue_ms):.3f} ms")
    parts = split_parts(split)
    print("host enqueue of one eager step, split (ms, medians of the "
          "phases; the runtime's calls profiled): "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; torch's runtime launch calls a step: forward "
          f"{split['forward launch API calls']:.0f}, backward "
          f"{split['backward launch API calls']:.0f}, Adam "
          f"{split['adam launch API calls']:.0f}; the profiler saw "
          f"{split['forward launch API calls in ctypes'] + split['backward launch API calls in ctypes']:.0f} "  # noqa: E501
          "inside the ctypes calls")
    if group:
        print(f"captured group of {k}: host {group['host_ms_per_step']:.3f} "
              f"ms a step (copies and one replay), wall until the card is "
              f"done {group['wall_ms_per_step']:.3f} ms a step")
    print(f"run_pretrain: {step_ms:.3f} ms/step, {edges / secs:.1f} valid "
          f"edges/s over {steps} steps (epochs 3-{EPOCHS})")
    print(f"run_pretrain profiled: {p_secs / p_steps * 1e3:.3f} ms/step; "
          f"device busy {busy_step_ms:.3f} ms/step = "
          f"{100 * busy_step_ms / step_ms:.1f}% of the unprofiled step; "
          "of it the port's kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in own.items()))
    print(f"launches a step: {launches_per_step:.1f} kernels, copies and "
          f"memsets; aten::_to_copy {to_copy_per_step:.1f}")
    print(f"device time by kernel (ms over {p_steps} steps, launches):")
    for name, ms, count in kernels[:25]:
        print(f"  {ms:9.3f}  {count:6d}  {name[:110]}")
    print(json.dumps({
        "card": card, "path": path, "loader": type(loader).__name__,
        "host_pack_transform_ms": statistics.median(host_ms),
        "host_transform_ms": statistics.median(transform_ms),
        "own_kernels_ms_per_step": own,
        "device_step_ms": device_step_ms,
        "enqueue_ms": statistics.median(enqueue_ms),
        "enqueue_split_ms": split, "enqueue_parts_ms": parts,
        "scan_steps": k, "captured_group": group,
        "main_path_step_ms": step_ms,
        "main_path_edges_per_s": edges / secs,
        "profiled_step_ms": p_secs / p_steps * 1e3,
        "device_busy_ms_per_step": busy_step_ms,
        "device_busy_share": busy_step_ms / step_ms,
        "launches_per_step": launches_per_step,
        "to_copy_per_step": to_copy_per_step,
        "top_kernels_ms_per_step": {n[:80]: ms / p_steps
                                    for n, ms, _ in kernels[:10]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
