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

``Mark`` is where a trainer's queued work reaches the end of an epoch or
of a group of epochs; ``seconds_between`` two marks is the time the device
took from the one to the other, its idle gaps included, whenever the host
read its results back.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

import torch

from pretrain_gnns_tpu_torch.core.graphs import PackedPair


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
        """A batch's valid edges and nodes and its valid graph slots. A
        context-prediction ``PackedPair`` counts the edges and nodes of
        both streams and its graphs once: the JAX loader's
        ``last_epoch_stats["edges"]``. A descriptor of the device-resident
        dataset (``data.device_pack.Descriptor``) counts its own masks."""
        if hasattr(batch, "counts"):  # a device-resident descriptor
            return batch.counts()
        if isinstance(batch, PackedPair):
            sub, ctx = (ThroughputMeter.counts_of(g)
                        for g in (batch.substruct, batch.context))
            return {"edges": sub["edges"] + ctx["edges"],
                    "nodes": sub["nodes"] + ctx["nodes"],
                    "graphs": sub["graphs"]}
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


@dataclass
class Mark:
    """The end of the steps a trainer queued up to ``epoch`` (the last
    epoch of a group), after ``replays`` CUDA-graph replays (the captures
    included). On CUDA ``event`` is a timing event recorded on the current
    stream, which the card reaches once that work is done; on the CPU it
    is None and the steps ran before ``at``, the host's ``perf_counter``
    when the mark was made."""
    epoch: int
    replays: int
    at: float
    event: Any = None

    @classmethod
    def record(cls, epoch: int, replays: int, device) -> "Mark":
        event = None
        if torch.device(device).type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        return cls(epoch, replays, time.perf_counter(), event)


def seconds_between(a: Mark, b: Mark) -> float:
    """The seconds from mark ``a`` to the later mark ``b``: on CUDA the
    card's own clock between the two events (it waits for ``b``), on the
    CPU the host's between the two marks."""
    if a.event is None:
        return b.at - a.at
    b.event.synchronize()
    return a.event.elapsed_time(b.event) / 1e3
