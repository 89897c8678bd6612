"""Many train steps per dispatch: the port's counterpart of the JAX
package's ``make_scan_pretrain_step``, where one ``lax.scan`` dispatch runs
K train steps. Here one CUDA-graph replay runs K whole train steps
(forward, backward, Adam and the batch-norm statistics) on K batches.

A :class:`ScanStep` holds K static input slots, each a device copy of a
batch with the layout's fixed shapes: a ``PackedGraphs``, or context
prediction's ``PackedPair`` of two streams, each with its own block
layout. A call copies K batches into the slots and runs the K steps on
them:

- on CUDA, by one replay of a graph that captured the K steps. The graph is
  captured at the first call, after at least one eager step (:meth:`step`)
  has made every lazily created thing: the optimizer's moments, the kernel
  libraries (their build and the probe synchronise), cuBLAS's workspace,
  the trunks' dropout generators. Eager steps before the capture, the
  copies, the capture and the replays all run on the object's own stream,
  as torch's whole-network capture recipe asks. The capture raises if it
  fails; nothing falls back to eager steps;
- on the CPU, by the K steps one after another on the slots, through the
  same copies and the same ``[K]`` outputs.

Captured steps compute what eager steps compute, bit for bit where the
eager steps are repeatable: the same kernels on the same addresses'
contents, the optimizer ``capturable`` on both sides (``train/optim.adam``
makes it so for CUDA parameters), and the dropout generators and the
objective's ``mask`` stream (``models.chem.MaskStream``: the atoms masked
and the negative pairs drawn inside the step) registered with the graph,
so that each replay draws what eager steps would draw next.

The capture runs with ``capture_error_mode="thread_local"``: the prefetch
thread pins host memory (``cudaHostAlloc``) while the launching thread
captures, which the default global mode would count against the capture.

The wrappers' launch counters count Python calls, so the capture counts
each of its K steps once and a replay counts nothing."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs, PackedPair
from pretrain_gnns_tpu_torch.models.chem import TrunkDropout

# eager steps before the capture: the run's first batches (torch's recipe
# warms up on the capture stream for a few steps)
WARMUP_STEPS = 3

StepFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
# one stream, or context prediction's two
Batch = Union[PackedGraphs, PackedPair]


def as_tensors(batch: Batch) -> Batch:
    """``batch`` with every leaf a torch tensor (numpy leaves are wrapped,
    not copied)."""
    return batch._map(lambda t: t)


def signature(batch: Batch) -> tuple:
    """What a capture fixes of a batch of tensors: the block layout of
    each stream and each leaf's name, shape and dtype."""
    return batch.layout + tuple(
        (name, tuple(v.shape), v.dtype)
        for name, v in batch.leaves().items())


class ScanStep:
    """K train steps a call on K batches of one signature (see the module
    docstring). ``step_fn(state, batch)`` runs one step on a batch on the
    device and returns its detached loss and metrics; ``state.step``
    counts here."""

    def __init__(self, state, example_batch: Batch, k: int,
                 step_fn: StepFn, device: torch.device):
        if k < 1:
            raise ValueError(f"k must be positive, got {k}")
        example = as_tensors(example_batch)
        self.state, self.k, self.step_fn = state, k, step_fn
        self.device = torch.device(device)
        self.signature = signature(example)
        self.slots = [example._map(
            lambda t: torch.empty_like(t, device=self.device))
            for _ in range(k)]
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.graph = None
        self.replays = 0  # calls; on the CPU, groups run in turn
        self.eager_steps = 0

    def _checked(self, batch: Batch) -> Batch:
        batch = as_tensors(batch)
        sig = signature(batch)
        if sig != self.signature:
            diff = sorted(set(sig) ^ set(self.signature), key=str)
            raise ValueError(
                "the batch's layout, leaves, shapes or dtypes differ from "
                f"the signature the steps were made for: {diff}")
        return batch

    @contextlib.contextmanager
    def _on_stream(self):
        """On CUDA, the object's stream, ordered after the caller's stream
        on entry and before it on exit."""
        if not self.cuda:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            yield
        caller.wait_stream(self.stream)

    def step(self, batch: Batch):
        """One eager step on ``batch`` (the run's first steps, which warm
        the capture up, and the epochs' short tails)."""
        batch = self._checked(batch)
        with self._on_stream():
            out = self.step_fn(self.state,
                               batch.to(self.device, non_blocking=self.cuda))
        self.state.step += 1
        self.eager_steps += 1
        return out

    def __call__(self, batches: Sequence[Batch]):
        """K steps on ``batches``, in order; their losses ``[K]`` and
        metrics ``{name: [K]}``, fresh tensors on the device."""
        if len(batches) != self.k:
            raise ValueError(f"{len(batches)} batches, expected {self.k}")
        batches = [self._checked(b) for b in batches]
        with self._on_stream():
            for slot, batch in zip(self.slots, batches):
                src = batch.leaves()
                for name, dst in slot.leaves().items():
                    dst.copy_(src[name], non_blocking=self.cuda)
            if self.cuda:
                if self.graph is None:
                    self._capture()
                self.graph.replay()
                losses = self._losses.clone()
                metrics = {k: v.clone() for k, v in self._metrics.items()}
            else:
                losses, metrics = self._run_slots()
        self.replays += 1
        self.state.step += self.k
        return losses, metrics

    def _run_slots(self):
        out = [self.step_fn(self.state, slot) for slot in self.slots]
        return (torch.stack([loss for loss, _ in out]),
                {k: torch.stack([m[k] for _, m in out]) for k in out[0][1]})

    def _generators(self) -> List[torch.Generator]:
        dev = next(self.state.model.parameters()).device
        return [m.dropout_generator(dev)
                for m in self.state.model.modules()
                if isinstance(m, TrunkDropout) and m.draws()]

    def _capture(self) -> None:
        if not self.eager_steps:
            raise RuntimeError("capture before any eager step: the first "
                               "steps make what the capture must find")
        graph = torch.cuda.CUDAGraph()
        gens = self._generators()
        if gens and not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} cannot register the dropout "
                "and mask generators with a CUDA graph; run with "
                "scan_steps=1")
        for gen in gens:
            graph.register_generator_state(gen)
        # the captured backward allocates the gradients in the graph's pool
        self.state.optimizer.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            self._losses, self._metrics = self._run_slots()
        self.graph = graph

