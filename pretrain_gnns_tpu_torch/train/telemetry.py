"""Throughput meter (port of ``pretrain_gnns_tpu.train.telemetry``): valid
edges, nodes and graphs per wall-second across train steps.

    meter = ThroughputMeter()
    for batch in loader:
        counts = meter.counts_of(batch)   # host-side, before the copy
        ...train step...
        meter.tick(**counts)
    print(meter.edges_per_sec())

The wall clock only measures the device's work when the caller has waited
for it (for example by reading the loss back) before reading ``seconds``.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np


class ThroughputMeter:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.edges = 0
        self.nodes = 0
        self.graphs = 0
        self.steps = 0
        self._t0 = time.perf_counter()

    @staticmethod
    def counts_of(batch) -> Dict[str, int]:
        return {
            "edges": int(np.asarray(batch.edge_mask).sum()),
            "nodes": int(np.asarray(batch.node_mask).sum()),
            "graphs": int(np.asarray(batch.graph_mask).sum()),
        }

    def tick(self, edges: int = 0, nodes: int = 0, graphs: int = 0) -> None:
        self.edges += edges
        self.nodes += nodes
        self.graphs += graphs
        self.steps += 1

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self._t0

    def edges_per_sec(self) -> float:
        return self.edges / max(self.seconds, 1e-9)
