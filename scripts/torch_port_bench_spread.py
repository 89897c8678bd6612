#!/usr/bin/env python3
"""Where the spread of the port's bench comes from: one bench cell, epoch
by epoch, with the host's clocks beside the wall clock.

Run from the repository root:

    python3 scripts/torch_port_bench_spread.py --cell chem|bio
        [--epochs N] [--gc on|off] [--threads N] [the bench's options]

It runs the cell of ``python -m pretrain_gnns_tpu_torch.bench`` (its
options set the sizes; the defaults are the bench's workload) through
``run_pretrain`` for 1 + N epochs, and records for each epoch after the
first:
  - wall s between the epoch log stamps, and the valid edges;
  - CPU s of the launching (main) thread and of the whole process;
  - s inside the garbage collector (any thread) and its full collections;
  - s the launching thread waited on the prefetch queue, and the gap from
    the previous stamp to the epoch's first step (its loader's start);
  - the drain: from the last step's launch to the stamp (the card
    finishing, and the loss read back);
  - the median, 90th percentile and largest step-to-step interval, ms;
  - the machine's CPU s in user, system and steal (``/proc/stat``, all
    cores) over the epoch.
``--gc off`` collects once after the dataset is made, freezes what is
left and disables the collector for the run; ``--threads N`` sets
torch's intra-op threads (``torch.set_num_threads``) first.

From the same epochs it forms the bench's windows for k = 1, 2, 4 and 8
epochs a window (consecutive, not overlapping): each k's spread, (max -
min) / median, over its first 3 and first 5 windows, and the coefficient
of variation over all of them. It prints the card (name and power limit,
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them), a table, and one JSON line last.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pretrain_gnns_tpu_torch import bench  # noqa: E402
from pretrain_gnns_tpu_torch.train import pretrain  # noqa: E402


def _proc_stat():
    """(user, system, steal) CPU seconds of all cores, or zeros where the
    file is not there."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
    except OSError:
        return (0.0, 0.0, 0.0)
    hz = os.sysconf("SC_CLK_TCK")
    steal = v[7] if len(v) > 7 else 0
    return ((v[0] + v[1]) / hz, v[2] / hz, steal / hz)


def _windows(walls, edges, k):
    """Rates of consecutive windows of ``k`` epochs."""
    return [sum(edges[i:i + k]) / sum(walls[i:i + k])
            for i in range(0, len(walls) - k + 1, k)]


def _spread(rates):
    return (max(rates) - min(rates)) / statistics.median(rates)


def main() -> int:
    p = bench.build_parser()
    p.description = __doc__.splitlines()[0]
    p.add_argument("--cell", default="chem", choices=["chem", "bio"])
    p.add_argument("--epochs", type=int, default=24,
                   help="epochs after the warm-up epoch")
    p.add_argument("--gc", default="on", choices=["on", "off"])
    p.add_argument("--threads", type=int, default=0,
                   help="torch.set_num_threads(N) first (0: torch's own "
                        "count)")
    args = p.parse_args()
    import torch

    if args.threads:
        torch.set_num_threads(args.threads)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    metric, cfg, make_graphs = bench.cells(args)[args.cell == "bio"]
    graphs = make_graphs()
    if args.gc == "off":
        gc.collect()
        gc.freeze()
        gc.disable()

    in_gc = [0.0, 0, 0.0]  # seconds, full collections, start of the open one

    def on_gc(phase, info):
        if phase == "start":
            in_gc[2] = time.perf_counter()
        else:
            in_gc[0] += time.perf_counter() - in_gc[2]
            in_gc[1] += info["generation"] == 2

    steps, waits = [], []
    train_step, prefetch = pretrain.train_step, pretrain.prefetch

    def timed_step(state, batch):
        steps.append(time.perf_counter())
        return train_step(state, batch)

    def timed_prefetch(iterable, depth):
        it = prefetch(iterable, depth=depth)
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            waits.append((t, time.perf_counter() - t))
            yield item

    marks = []  # at each epoch stamp

    def log(msg):
        if msg.startswith("epoch="):
            marks.append(dict(t=time.perf_counter(), thread=time.thread_time(),
                              proc=time.process_time(), gc=in_gc[0],
                              gc_full=in_gc[1], stat=_proc_stat()))

    pretrain.train_step, pretrain.prefetch = timed_step, timed_prefetch
    gc.callbacks.append(on_gc)
    try:
        res = pretrain.run_pretrain(cfg, graphs, log=log,
                                    epochs=1 + args.epochs,
                                    device=args.device)
    finally:
        gc.callbacks.remove(on_gc)
        pretrain.train_step, pretrain.prefetch = train_step, prefetch
    hist = res["history"]
    rows = []
    for i in range(1, len(marks)):
        a, b = marks[i - 1], marks[i]
        st = [s for s in steps if a["t"] < s <= b["t"]]
        gaps = sorted(1e3 * (y - x) for x, y in zip(st, st[1:]))
        d = [y - x for x, y in zip(a["stat"], b["stat"])]
        rows.append(dict(
            wall_s=b["t"] - a["t"], edges=hist[i]["edges"],
            thread_cpu_s=b["thread"] - a["thread"],
            proc_cpu_s=b["proc"] - a["proc"],
            gc_s=b["gc"] - a["gc"], gc_full=b["gc_full"] - a["gc_full"],
            queue_wait_s=sum(w for t, w in waits if a["t"] < t <= b["t"]),
            first_step_gap_ms=1e3 * (st[0] - a["t"]),
            drain_ms=1e3 * (b["t"] - st[-1]),
            step_ms_median=statistics.median(gaps),
            step_ms_p90=gaps[int(0.9 * (len(gaps) - 1))],
            step_ms_max=gaps[-1],
            machine_user_s=d[0], machine_sys_s=d[1], machine_steal_s=d[2]))
    walls = [r["wall_s"] for r in rows]
    edges = [r["edges"] for r in rows]
    windows = {}
    for k in (1, 2, 4, 8):
        rates = _windows(walls, edges, k)
        if len(rates) < 3:
            continue
        windows[k] = dict(
            n=len(rates), median_first5=statistics.median(rates[:5]),
            spread_first3=_spread(rates[:3]), spread_first5=_spread(rates[:5]),
            cv=statistics.pstdev(rates) / statistics.fmean(rates))
    card = bench.card_line() if args.device == "cuda" else None
    print(f"card: {card}; cell {args.cell} ({metric}), gc {args.gc}, "
          f"{torch.get_num_threads()} torch threads, "
          f"{hist[-1]['steps']} steps an epoch")
    keys = list(rows[0])
    print(" ".join(f"{k:>12s}" for k in keys))
    for r in rows:
        print(" ".join(f"{r[k]:12.4f}" if isinstance(r[k], float)
                       else f"{r[k]:12d}" for k in keys))
    for k, w in windows.items():
        print(f"windows of {k} epochs: {w}")
    print(json.dumps({"card": card, "cell": args.cell, "metric": metric,
                      "gc": args.gc, "device": args.device,
                      "torch_threads": torch.get_num_threads(),
                      "cpu_count": os.cpu_count(),
                      "affinity": len(os.sched_getaffinity(0)),
                      "epochs": rows, "windows": windows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
