#!/usr/bin/env python3
"""The mean pool's three ways of summing rows into graph slots, on the
paths that pool, on one GPU.

Run from the repository root:

    python3 scripts/torch_port_pool_ab.py

The supervised (mean pooling, dropout 0.2) and Deep Graph Infomax paths
of ``chip_smoke.py``, chem and bio, GIN 5 x 300, batch 256, float32, each
with ``models.pools.mean_pool`` as:
  - ``index_add``: ``index_add`` of the masked rows and of the mask (the
    port up to PR 11; CUDA sums it with atomics);
  - ``index_put``: the same sums by ``index_put(..., accumulate=True)``,
    which sorts the indices and walks each slot's rows in turn;
  - ``one-hot``: the product ``membership @ h`` over the ``[G, N]``
    one-hot of the valid rows' slots (``models.pools``, the port's own).
For each path the three run in the order ABCCBA, each from the same
seeded state: ``graphed.WARMUP_STEPS`` eager steps, one capture of K = 16
steps, then REPLAYS replays timed by CUDA events around each call; it
prints ms a step (the median over the replays) and valid edges/s, and the
pool alone (forward and backward of one call on the path's first batch,
median of TRIALS). The card's name and power limit (``nvidia-smi``) come
first, one JSON line with every number last.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from pretrain_gnns_tpu_torch.models import pools  # noqa: E402
from pretrain_gnns_tpu_torch.ops import spmm  # noqa: E402
from pretrain_gnns_tpu_torch.train import graphed, optim, pretrain  # noqa: E402,E501
from pretrain_gnns_tpu_torch.train.state import TrainState  # noqa: E402
from scripts.torch_port_profile import workload  # noqa: E402

K = 16
REPLAYS = 4
TRIALS = 20


def _sums(h, g, add):
    m = g.node_mask.to(h.dtype)
    ids = g.node_graph.long()
    s = add(h.new_zeros((g.max_graphs, h.shape[1])), ids, h * m[:, None])
    n = add(m.new_zeros(g.max_graphs), ids, m)
    return s / torch.clamp(n, min=1.0)[:, None]


VARIANTS = {
    "index_add": lambda h, g: _sums(
        h, g, lambda out, ids, x: out.index_add(0, ids, x)),
    "index_put": lambda h, g: _sums(
        h, g, lambda out, ids, x: out.index_put((ids,), x,
                                                accumulate=True)),
    "one-hot": pools.mean_pool,
}


def _events_ms(fn):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def run_path(cfg, host, variant, dev):
    """ms a step of each replay and the pool's ms alone, with
    ``mean_pool`` as ``variant``."""
    pools.mean_pool = VARIANTS[variant]
    torch.manual_seed(cfg.seed)
    model = pretrain.build_objective(cfg).to(dev)
    state = TrainState(model, optim.adam(model.parameters(), cfg.lr,
                                         cfg.decay))
    scan = pretrain.make_scan_pretrain_step(state, host[0], K)
    w = graphed.WARMUP_STEPS
    for b in host[:w]:
        scan.step(b)
    groups = [host[w + i * K: w + (i + 1) * K] for i in range(REPLAYS + 1)]
    scan(groups[0])  # the capture and its first replay
    step_ms = [_events_ms(lambda grp=grp: scan(grp)) / K
               for grp in groups[1:]]
    g = host[0].to(dev)
    h = torch.randn(g.node_feat.shape[0], cfg.emb_dim, device=dev,
                    requires_grad=True)
    up = torch.randn(g.max_graphs, cfg.emb_dim, device=dev)

    def pool():
        torch.autograd.grad(pools.mean_pool(h, g), h, up)

    pool()
    pool_ms = statistics.median(_events_ms(pool) for _ in range(TRIALS))
    del scan, state, model
    torch.cuda.empty_cache()
    return step_ms, pool_ms


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}; torch {torch.__version__}", flush=True)
    # the float32 paths, whatever PGT_SPMM_DTYPE says
    spmm.set_compute_dtype("float32")
    out = {}
    for domain, objective in itertools.product(("chem", "bio"),
                                               ("supervised", "infomax")):
        graphs, cfg = workload(domain, objective, "gin")
        n = graphed.WARMUP_STEPS + K * (REPLAYS + 1)
        dev = torch.device("cuda")
        loader = pretrain.build_loader(cfg, graphs, dev)
        host = [b.pin_memory() for b in itertools.islice(
            itertools.chain.from_iterable(itertools.repeat(loader)), n)]
        edges = statistics.mean(float(b.edge_mask.sum()) for b in host)
        path = f"{domain} {objective} GIN"
        res = {v: [] for v in VARIANTS}
        for v in list(VARIANTS) + list(reversed(VARIANTS)):
            step_ms, pool_ms = run_path(cfg, host, v, dev)
            ms = statistics.median(step_ms)
            res[v].append({"step_ms": ms, "edges_per_s": edges / ms * 1e3,
                           "pool_ms": pool_ms})
            print(f"[{path}] {v}: {ms:.3f} ms a step "
                  f"({edges / ms * 1e3:,.0f} valid edges/s; replays "
                  f"{[round(t, 3) for t in step_ms]}), the pool forward and "
                  f"backward {pool_ms:.4f} ms", flush=True)
        out[path] = res
    pools.mean_pool = VARIANTS["one-hot"]
    print(json.dumps({"card": card, "K": K, "replays": REPLAYS,
                      "paths": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
