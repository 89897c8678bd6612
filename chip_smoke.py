#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pretrain_gnns_tpu_torch``) on
one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Every path below (a "main path" phase) runs ``run_pretrain`` for 3 epochs
of 16 steps at the resolved default ``scan_steps`` K = 16: epoch 1 eager
(3 warm-up steps on the capture stream, 13 tail steps), epoch 2 captures
16 steps into one CUDA graph and replays it, epoch 3 replays it (its
edges/s are printed). The launch counters count the wrappers' calls, so
a path's count must be its launches a step times (eager steps + K): the
eager steps' and the capture's; the replays launch the captured graph and
count nothing, and their number is reported beside the count. Each path
is followed by its capture phase: on the path's first batches,
3 eager steps and 2 replays of 4 captured steps against as many eager
steps from the same seeded state, run twice: the two eager runs and the
captured run must be bit-equal in the parameters, the batch-norm
statistics, Adam's moments and the per-step losses (the port's kernels
have no atomics, its embeddings and row sums sum in a fixed order); one
more replay runs under ``torch.profiler`` and must show the path's
kernels by name (their device activities are printed, counted by name).

Phases, in order (any failure exits non-zero):
  1. the card's name and power limit; the kernels built from ``csrc/``
     (one ``nvcc`` per source, all started together);
  2. chem kernel phase: on the chem path's first batch (256 molecules,
     blocks of 128 nodes / 384 edge slots, F = 300, K = 9, float32) the
     fused GIN conv K1 is held against its plain PyTorch version (forward
     ``out``, ``aggr``, ``z`` and all seven gradients), every output equal
     bit for bit between two runs, and timed with CUDA events beside the
     plain version, the unfused GIN layer (K2 ``[x+ein]``, the self term,
     two ``nn.Linear`` and the ReLU; its output held against K1's), its
     bound and its products alone: through its own GEMM (``gemm.cuh``) and
     through ``torch.matmul``, each in TFLOP/s;
  3. chem agreement: one train-mode masking step at full width on the card
     (kernels) and on the CPU (plain version) from the same weights:
     loss, every gradient and the batch-norm running stats;
  4. chem main path: ``run_pretrain`` on ``cuda`` at full width (GIN
     5 x 300, batch 256, mask_edge off) for 48 steps, with every
     launch count checked: K1 at 5 x steps in each direction, K2 at 0;
     then, under ``gin_conv.set_fused("off")``, the chem agreement step and
     48 steps of the same path on the unfused GIN route: K2's
     ``fwd[x+ein]`` and ``bwd[x+ein]`` at 5 a step, K1 at 0;
  5. bio kernel phase: on the bio path's first batch (256 ego-networks,
     blocks of 128 nodes / 384 edge slots, F = 300, K = 10, float32) each
     variant of the fused edge-transform SpMM K2 (has_x, has_ein, both) is
     held against its plain version (forward ``out``; ``dx`` and/or
     ``dW``) and timed beside the plain version, ``torch.sparse.mm`` with a
     CSR adjacency where one call computes the same function, and its
     bound;
  6. bio agreement: one train-mode bio masking step at full width, card
     vs CPU, as in phase 3;
  7. bio main path: ``run_pretrain(domain="bio")`` on ``cuda`` at full
     width (GIN 5 x 300, batch 256) for 48 steps, with K2's
     ``fwd[x]``, ``fwd[ein]``, ``bwd[x]`` and ``bwd[ein]`` at 5 x steps and
     every other count at 0;
  8. pair-dot kernel phase: on the first batch of the chem and of the bio
     edge-prediction path (blocks of 128 nodes, F = 300, float32) the
     blocked pair-dot head K3 is held against its plain version for both
     scoring heads (positives: every edge slot, 384 a block; negatives:
     the C++ sampler's block-aligned pairs, 192 a block): scores and
     ``dx``, padded pairs and untouched rows exactly 0, scores and ``dx``
     each equal bit for bit between two runs; timed beside the plain
     version and its bound (no single PyTorch call computes it);
  9. GCN kernel phase: K2's ``has_x`` + ``has_ein`` variant again, at the
     shapes the chem GCN trunk gives it (first batch of the chem
     edge-prediction path, K = 9, edge weights ``deg^-1/2[r] *
     deg^-1/2[s]``), against its plain version, timed, with its bound;
  10. edge-prediction agreement, for each trunk that a path below drives
     (chem GIN, chem GCN, bio GIN, bio GraphSAGE): one train-mode step at
     full width (the bio trunks at BIO_REFEREE_LAYERS layers) on the
     card, on the CPU in float32 and on the CPU in float64; the card's
     gradients must lie no further from the float64 ones than REFEREE_K
     times the float32 noise measured on the CPU (the median of three
     steps on the card, 1 + NOISE_SAMPLES on the CPU);
  11. edge-prediction main path: ``run_pretrain(objective="edgepred")`` on
     ``cuda`` at full width (chem GIN 5 x 300, batch 256) for 48 steps:
     K1 at 5 a step and K3 at 2 a step in each direction, every other
     count 0;
  12. three more paths of 48 steps at full width: chem edge prediction
     on a GCN trunk (K2's ``fwd[x+ein]`` and ``bwd[x+ein]`` at 5 a step,
     K3 at 2, K1 at 0), bio edge prediction on GIN (K2's ``[x]`` and
     ``[ein]`` at 5 a step, K3 at 2) and bio edge prediction on GraphSAGE
     (K2's ``[x+ein]`` at 5 a step, K3 at 2);
  13. GAT kernel phase: on the first batch of the chem and of the bio GAT
     masking path (H = 2, D = 300, K = 9 or 10, float32) the fused GAT conv
     K4 (``out``, the saved ``x`` and all eight gradients) and the blocked
     GAT attention K5 on ``x`` and ``e`` as the unfused conv forms them
     (``out`` and its five gradients) are held against their plain
     versions: padded edge slots exactly 0 in ``alpha`` and ``de``, every
     output equal bit for bit between two runs; timed beside the plain
     version, ``torch.matmul`` for K4's products and the bound (no single
     PyTorch call computes either);
  14. GAT agreement: one train-mode masking step at full width, card vs
     CPU, for chem GAT fused, bio GAT fused and chem GAT unfused, at the
     masking steps' limits;
  15. GAT main path: ``run_pretrain(gnn_type="gat")`` on ``cuda`` at full
     width (chem masking, GAT 5 x 300, 2 heads, batch 256, mask_edge off)
     for 48 steps: K4 at 5 a step in each direction, every other count 0;
  16. two more GAT paths of 48 steps at full width: bio masking (K4 at
     K = 10, 160 blocks) and chem edge prediction with
     ``gat_conv.set_fused("off")`` (K5 at 5 a step in each direction, K3
     at 2, K4 at 0);
  17. probe phase (run right after phase 2): the build-and-launch probe P
     must have been launched exactly once by then, by the first kernel
     library that was loaded; its kernel is held against ``2 * x`` on
     ``[8, 300]`` exactly and timed;
  18. precomputed-edge-embedding phase: on the chem and the bio masking
     first batch (F = 300, float32, fractional and negative edge weights)
     the blocked SpMM K6 (forward with and without ``ee``; backward ``dx``
     and ``dee``, each also alone) and its receiver-sorted variant K7
     (after ``sort_block_edges``) are held against their plain versions
     and K7 against K6 on the unsorted edges: padded rows and slots
     exactly 0, every output equal bit for bit between two runs; timed (K7
     with and without the sort) beside the plain version, one
     ``torch.sparse.mm`` each way (a CSR adjacency of the edge weights,
     with ``ee`` stacked beside it: ``[A | A_ee]`` on ``[x; ee]`` forward,
     its transpose on ``g`` for ``dx`` over ``dmsg``; held against the
     kernel) and the bound, and K7's time printed beside K6's forward
     ``[x+ee]`` on the same batch;
  19. the op-level path of K6: ``ops.spmm.gather_scatter(..., edge_emb=
     ...)`` in its add and concat forms and ``blocked_spmm`` without an
     edge embedding, forward and backward on the card, against the plain
     path, with every launch count checked (add: K6 ``[x+ee]`` once each
     way; concat: K2 ``[x]`` and K6 ``[x+ee]`` once each way);
  20. the kernel micro-benchmark ``scripts/torch_port_kernel_micro.py``
     (K7's path), run at a reduced number of trials, with K7's, K6's,
     K2's and K5's counts read after it;
  21. supervised agreement: one train-mode step (dropout 0) at full width,
     card vs CPU, for chem (1,310 tasks) and bio (5,000 tasks), mean
     pooling, at the masking steps' limits;
  22. supervised main path: ``run_pretrain(objective="supervised")`` on
     ``cuda`` at full width (chem GIN 5 x 300, batch 256, mean pooling,
     dropout 0.2, 1,310 tasks) for 48 steps: K1 at 5 a step in each
     direction, the probe once (the libraries are loaded anew for this
     run), every other count 0; then 48 steps of the bio supervised path
     (5,000 tasks; K2's ``[x]`` and ``[ein]`` at 5 a step);
  23. loader phase, on the host, for each path's configuration (chem and
     bio masking, edge prediction, supervised and infomax): the first
     epoch of ``build_loader`` (the flat dataset and the C++ packer) is a
     ``FlatLoader`` and equals ``PackedLoader``'s with the same transform
     and seed batch for batch, every field and extra; printed: host ms a
     batch of each (pack and transform, one thread) and the ms of planning
     the epoch with ``native.plan_epoch`` and with the Python walk;
  24. infomax agreement and paths: one train-mode Deep Graph Infomax step
     at full width (bio at BIO_REFEREE_LAYERS layers), card vs CPU, chem
     and bio, refereed by a float64 CPU step as edge prediction's (the float32 CPU step alone can lie
     further from float64 than the masking steps' gradient limit); then
     48 steps each of ``run_pretrain(objective="infomax")``:
     chem K1 at 5 a step each way, bio K2's ``[x]`` and ``[ein]`` at 5 a
     step, every other count 0;
  25. context prediction (``objective="contextpred"``: two trunks, the
     substructure's 5 layers and the context's 3, on two blocked streams,
     each its own block geometry), chem (cbow, csize 3, on
     ``molecule_dataset(4400, ...)``: 6% of the molecules have no context,
     and 4,096 pairs make 16 batches) and bio (l1 1, center): the
     presampling's host time and each stream's geometry, the blocked
     first batch's loss on the CPU against the standard layout's on the
     same pairs, each trunk's launches counted apart, the float32
     agreement step refereed by a float64 CPU step (chem also in
     skipgram; bio at BIO_REFEREE_LAYERS layers of the substructure
     trunk), 48 steps with K1 (chem) or K2 ``[x]`` and ``[ein]`` (bio)
     at 5 + 3 a step each way, the capture phase, then at the knobs'
     defaults the bfloat16 agreement step, 48 steps and the capture
     phase, the rate printed beside float32's;
  26. mixed precision, under the JAX bench's recipe (``models.inits`` at
     ``bfloat16_act``, ``ops.spmm`` at ``bfloat16``, the JAX package's
     default; every phase before runs with both knobs pinned at float32
     but phase 25's runs at the knobs' defaults,
     and ``precision`` restores them after the block): K1 on the chem
     masking first batch, K2 ``[x]`` and ``[ein]`` on the bio masking
     first batch, K2 ``[x+ein]`` on the chem masking first batch (the
     unfused GIN path's shape; each K2 case also with fractional edge
     weights) and K3's positive head on the chem edge-prediction first
     batch, each with bfloat16 and with float32 rows at
     compute_dtype=bfloat16; K4 (float32 h) and K5 (float32 x, e in
     float32 and in bfloat16) on the chem and bio GAT masking first
     batches; K6 ``[x+ee]`` and ``[x]`` and K7 (sorted slots) on the chem
     and bio masking first batches, bfloat16 and float32 rows, fractional
     and negative weights: each against its plain version at that dtype
     and beside the control, the same wrapper at float32
     (BF16_KERNEL_TOL, BF16_KERNEL_MEAN_TOL), bit-equal between two runs, timed beside the plain version (K2's also
     beside the float32 K2 on float32 rows at the same batch), the library
     (``torch.matmul`` in bfloat16 on K1's and K4's products,
     ``torch.sparse.mm`` in bfloat16 for K2 ``[x]``, K6 and K7) and the
     bound (the stored widths' bytes, products at the bfloat16 tensor
     peak); K1's six products alone through its tensor-core GEMM
     (``gin_conv.gemm_bf16``) at their shapes, layouts and splits, against
     ``torch.matmul`` on float32 copies of the bfloat16 operands
     (BF16_GEMM_TOL, with a control that leaves one operand unrounded and
     must break it), timed beside ``torch.matmul`` in bfloat16; K6's
     op-level path (phase 19) and the kernel micro-benchmark (phase 20,
     K7's path) at compute_dtype=bfloat16; then chem masking GIN, its
     unfused route (K2 ``[x+ein]``), bio masking GIN, chem edge-prediction
     GIN, chem masking GAT (K4) and chem edge-prediction GAT unfused (K5,
     K3) under the recipe: a train step on the card against the CPU's
     plain versions at the same compute dtype (``plain_as_on_card``),
     within limits set by noisy CPU steps, which the control (the kernels'
     knob at float32) must break (BF16_REFEREE_K), the 48-step path with
     its launch counts and its edges/s beside its float32 twin's from
     earlier in the run, and its capture phase (the bfloat16
     instantiations of K1's to K5's kernels, K1's and K4's tensor-core
     ``gemm_bf16_kernel``, K4's ``gat_proj16_kernel``,
     ``gat_conv_fwd16_kernel`` and ``gat_dwe16_kernel`` among the replay's
     kernels, the float ``gemm_kernel`` absent from K1's and K4's paths
     and no K4 walk that recomputes the softmax, and the card's busy share
     of the replay); last, the bio masking GAT step under the recipe (K4
     at K = 10);
  27. the knobs' own defaults (``models.inits`` at float32, ``ops.spmm``
     at ``bfloat16``: float32 rows through the bfloat16 kernels, what a
     run that sets no knob launches): the chem masking GIN path (K1) and
     the bio masking GIN path (K2 ``[x]`` and ``[ein]``), each its
     agreement step (as phase 26's), its 48 steps with their launch
     counts and edges/s beside the same path's float32 and bfloat16_act
     rates from earlier in the run, and its capture phase;
  28. fine-tuning from a pretrained trunk (``cli.finetune``): the chem and
     bio masking GIN paths of phases 4 and 7 wrote their trained trunks
     through the port's writer; in float32 at dropout 0 one fine-tune
     train step (loss, gradients, batch-norm statistics) and one eval pass
     over the partly empty last validation batch (its valid slots'
     logits), card against CPU, for chem GIN and bio GIN from those trunks
     and chem GAT (K4) from seeded weights, each launch counted; then
     ``cli.finetune.main`` from each trunk at full width (GIN 5 x 300,
     batch 32, dropout 0.5, 3 epochs, the knobs' defaults): chem on 4,000
     synthetic molecules, bio on 4,096 ego-networks (species split), the
     grafted trunk checked equal to the file before the first step, K1 or
     K2 ``[x]`` and ``[ein]`` at 5 a train step each way and 5 forwards an
     eval batch (eager steps, eval under ``torch.no_grad()``), the curves
     finite; printed: valid edges/s of epochs 2-3, eval graphs/s, the
     per-epoch AUCs, and the card's busy share of profiled train steps and
     of a validation pass; then the study tools at the knobs' defaults:
     ``cli.sweep`` cut to 1 seed x 2 configs (``nopretrain`` and
     ``masking`` from the chem masking trunk) x 1 epoch on the synthetic
     molecules at full width, its launches counted, and ``cli.aggregate``
     on its results (one row a config, the test AUCs in [0, 1]);
  29. step checkpoints with resume, on the dataset store: the chem
     masking path's 4,096 molecules (with their scaffolds) and the bio
     masking path's 4,096 ego-networks (with their extras) written to a
     temporary ``--data_root`` by the port's ``save_graphs`` and read back
     equal (``load_graphs`` timed); then ``cli.pretrain.main --dataset
     <name> --data_root <root>`` at full width and the knobs' defaults,
     K = 16 (chem masking GIN on K1, bio masking GIN on K2 ``[x]`` and
     ``[ein]``): uninterrupted (chem 3 epochs, bio 2) with a checkpoint
     each epoch, then one epoch less in another directory and a fresh
     call to the full count there, which must log ``resumed from step S
     (epoch E)``; each call's launches counted; the resumed run's
     parameters, batch-norm statistics, Adam's moments and steps, dropout
     generators, history and written trunk equal the uninterrupted run's
     bit for bit; printed: checkpoint bytes, save and restore ms, the
     resumed epoch's edges/s beside the uninterrupted one's; last,
     ``cli.finetune.main`` on the stored chem dataset from the resumed
     trunk (1 epoch at phase 28's settings, the scaffold split of the
     stored scaffolds.txt, K1 at 5 a train step each way and 5 forwards
     an eval batch);
  30. the reference's per-graph transforms in the loader
     (``transform_device="host"``: ``MaskAtom``, ``NegativeEdge`` with its
     pairs moved into the block slots, ``ContextPairLoader`` drawing every
     pair anew each epoch on the graphs' block geometry), float32 at full
     width, K = 16: chem masking GIN (K1), bio edge prediction GIN (K2
     ``[x]``, ``[ein]`` and K3) and chem context prediction GIN (K1, both
     trunks), each the host loader's first epoch on one thread (ms a
     batch, one layout, the negatives in the block slots only), the
     float32 agreement step on its first batch (edge and context
     prediction refereed as in phase 25), the 48-step path with
     every launch count checked, and its edges/s beside the same path
     under "batch" from earlier in the run, with the card's busy share of
     the timed epoch and its ms a replayed step (``torch.profiler`` over
     the epoch) beside the loader's ms a batch (at 16 batches an epoch the
     prefetch queue's two groups, made during epochs 1 and 2, feed the
     timed epoch; the loader's ms a batch against the card's ms a step
     bounds a longer run);
  31. the device-resident dataset (``device_dataset="on"``: the dataset
     on the card in 8-row chunks, each batch built there from a
     descriptor of a few kilobytes inside the step, the epoch trainer at
     K = 16), float32 at full width: chem masking
     GIN (K1), the device loader's first epoch (descriptor ms a batch) and
     its first descriptor's batch built on the card equal to
     ``materialize`` on the CPU bit for bit, float32 agreement steps on
     its first two descriptors' batches, the path with the dataset on
     (384 steps, the epoch trainer at its default group of 8 epochs) and
     off (160) in float32 and at the knobs' defaults (launches, edges/s
     and the card's busy share over 128 timed steps on the card's clock,
     side by side); the mask
     stream under ``transform_device="device"`` (at lr 0, two replays of
     one captured group on the same descriptors draw different masks, and
     a rerun from the seed repeats them bit for bit); bio edge prediction
     GIN with its negatives drawn in the step and laid out in the block
     slots (the sampler's properties on the card on the first batch, then
     the path: K2 ``[x]``, ``[ein]`` and K3 counted) and chem context
     prediction GIN through ``DeviceContextLoader`` (K1 on both trunks),
     both at one epoch a group;
  32. data parallelism at a world of one (``parallel``; ``dp_section``):
     an NCCL group of one rank from a ``file://`` store, chem masking GIN
     at full width, each path alone and in the group, bit for bit equal:
     the per-step path (48 eager steps, each all-reduce eager; float32;
     run alone, twice in the group and alone again, its edges/s pooled)
     and the epoch trainer (384 steps at K = 16, each step's all-reduce
     issued under the capture and replayed) in float32 and at the knobs'
     defaults, with launches, edges/s and the card's busy share beside
     the runs alone; a step's all-reduce (``WorldMean``) and the bare
     ``all_reduce`` of its flat buffer timed; the group left after;
  33. the port's benchmark, ``pretrain_gnns_tpu_torch.bench`` at its
     defaults (chem masking GIN on 16,384 molecules and bio masking GIN,
     8 warm-up epochs) but BENCH_WINDOWS windows of 8 epochs, at
     ``--scan_steps 1`` (every step eager), then at its default (K =
     16, CUDA-graph replays), at ``--dtype default`` and at ``--dtype
     bfloat16_act``, each its JSON line.
Then one ``{"kernels": [...]}`` line (each kernel's ``launches``, the
wrapper calls counted on the path that runs it at the entry's ``shape``,
``launches_per_step``, those calls over the steps that made them,
``replays``, the CUDA-graph replays of the run, ``launches_counted``:
how the count was read, ``finetune``: the fine-tune runs' calls, their
train steps and eval batches, ``sweep``: the sweep's calls,
``host_paths``: each host path's calls, ``device_paths``: each
device-resident path's calls, and ``dp_paths``: each data-parallel path's
calls at a world of one), the card
line and, last, the result line
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

BATCH = 256
EMB = 300
LAYERS = 5
MEAN_ATOMS = 23
MAIN_GRAPHS = 4096  # 16 steps per epoch at batch 256, both domains
MAIN_EPOCHS = 3  # epoch 1 eager; the capture in epoch 2; epoch 3 is timed
# launches per step of each path, by counter; every other count stays 0
K1 = {"gin_conv_fwd": LAYERS, "gin_conv_bwd": LAYERS}
BIO_K2 = {"blocked_spmm_fwd[x]": LAYERS, "blocked_spmm_fwd[ein]": LAYERS,
          "blocked_spmm_bwd[x]": LAYERS, "blocked_spmm_bwd[ein]": LAYERS}
GCN_K2 = {"blocked_spmm_fwd[x+ein]": LAYERS,
          "blocked_spmm_bwd[x+ein]": LAYERS}
K3 = {"blocked_edge_dot_fwd": 2, "blocked_edge_dot_bwd": 2}  # both heads
K4 = {"gat_conv_fwd": LAYERS, "gat_conv_bwd": LAYERS}
K5 = {"blocked_gat_attention_fwd": LAYERS,
      "blocked_gat_attention_bwd": LAYERS}
CHEM_TASKS = 1310  # the reference's ChEMBL task count
BIO_TASKS = 5000  # the reference's coarse GO terms
WARMUP, TRIALS, REPS = 5, 20, 10
T0 = time.perf_counter()  # the run's start, for the phases' stamps
SPIN_CYCLES = 3_500_000  # about 2 ms of the card's clock, see time_ms

# NVIDIA H100 SXM data sheet: float32 on the CUDA cores (dense), HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# ... and the dense bfloat16 tensor-core peak: the bound of a bfloat16
# variant's products (its bytes count the rows at their stored widths)
PEAK_BF16_FLOPS = 989e12

# Tolerances, as max |kernel - plain| / max(1, max |plain|). Both sides
# are full float32 (no TF32); they differ only in summation order (tiled
# FMA GEMMs vs cuBLAS, rows summed in slot order with the edge term
# reassociated vs index_add_ atomics, per-block partials summed in block
# order, a warp's shuffle tree vs a row reduction, a segment softmax
# walked in slot order vs scatter_reduce and index_add_). The same for K1
# to K7; every output of K6 and K7 is held to FWD_TOL (their sums have a
# few terms, and dmsg is one product).
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
# One full-width train step, card (kernels) vs CPU (plain version): five
# layers of batch norm amplify the summation-order differences. The same
# for chem and bio.
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 2e-3
# The edge-prediction step is worse conditioned at its random start: the
# scores are 300-term dot products of batch-norm outputs, so the loss
# starts near 64 with dL/dscore = +-1 on half the pairs, and a rounding
# error that flips one ReLU gate with a large cotangent moves a weight
# gradient by 3e-3 of its largest entry. Such flips are rare and come and
# go with the last bits of the inputs: the card's kernels sum in their own
# fixed order, which is not the CPU's, so no constant limit and no single
# float32 step says what float32 may do there. A float64 step on the CPU
# referees, and the float32 noise is measured: the largest distance from
# the float64 gradients of 1 + NOISE_SAMPLES float32 steps on the CPU, the
# samples from parameters scaled by 1 + NOISE_EPS * N(0, 1), one float32
# rounding each. The card's gradients may lie REFEREE_K times that far
# from the float64 ones, or STEP_GRAD_TOL if that is more (all by rel_err,
# the maximum over the parameters). The card takes the step three times,
# twice from parameters scaled in the same way, and the median distance
# is held: one rare flip on the card while no noise sample caught one
# must not fail a right kernel, and a wrong one is wrong in all three.
# Loss and batch-norm statistics keep the limits above.
REFEREE_K = 4.0
NOISE_SAMPLES = 16
NOISE_EPS = 1e-7
# The bio edge-prediction, infomax and context-prediction float32 agreement
# steps, refereed so, take BIO_REFEREE_LAYERS layers of the path's trunk:
# at 5 their float64 and float32 CPU steps on the bio first batch took
# 77-86 s (17 float32 steps) and 40 s (5); the paths themselves run all 5
# layers on the card after them.
BIO_REFEREE_LAYERS = 2
# bfloat16 (the JAX bench's recipe: the model's knob at bfloat16_act, the
# kernels' at bfloat16). A bfloat16 variant against its plain version at
# compute_dtype=bfloat16, read twice an output (``bf16_readings``): both
# round at the same points and multiply exactly, but a float32 sum taken
# in another order can move a later rounding (a message, aggr, z, a
# bfloat16 output) by one bfloat16 step, 2^-8 of the value.
# BF16_KERNEL_TOL bounds the largest such step and BF16_KERNEL_MEAN_TOL
# their share. The control, the same wrapper at compute_dtype=float32 on
# the same inputs, must read a mean over BF16_KERNEL_MEAN_TOL in some case
# of each kernel and rows. Measured on an H100: the largest readings at
# most 4.3e-7 here and 2.2e-3 in the card tests (a flipped rounding), the
# means at most 2.5e-7 and 2.8e-6; the control's means 1.5e-3 to 4.8e-2
# wherever a rounding acts. K4-K7's: the means at most 1.2e-5
# (K4's gradients, with the tie fixup on its residual), the controls'
# at least 1.4e-3; on bfloat16 rows K7's one rounding (of x) is a no-op,
# so both compute dtypes give one function there and no control is asked.
BF16_KERNEL_TOL = 5e-3
BF16_KERNEL_MEAN_TOL = 2e-5
# K1's tensor-core GEMM alone against torch.matmul on float32 copies of its
# bfloat16 operands, as rel_err: each product of two bfloat16 values is
# exact in float32, so only the order of the float32 sums differs (as
# FWD_TOL); the control, the same reference with one operand left
# unrounded, must read over the limit.
BF16_GEMM_TOL = 1e-5
# A full-width train step under the recipe, card (kernels) against the CPU
# (the plain versions at compute_dtype=bfloat16, through the same
# dispatch). Five layers of bfloat16 activations and batch norm turn a
# one-step difference into flips downstream (ReLU gates, later roundings),
# so the step's noise is measured as for REFEREE_K: BF16_NOISE_SAMPLES CPU
# steps from parameters scaled by 1 + NOISE_EPS * N(0, 1). The card's
# largest gradient error (rel_err, the maximum over the parameters) and
# its L1 share (sum |card - CPU| / sum |CPU| over every gradient) may each
# be BF16_REFEREE_K times the farthest sample's; the control, the card's
# step with the kernels' knob at float32, must come out over one of the
# two. Measured on an H100: the card at 0.42-0.69 of these limits, the
# control at 1.08-1.69 (the bio step's nearest: 1.08 and 1.19). Loss and
# batch-norm statistics cannot tell the control from the card (it reads
# within the noise), so their limits are fixed over the readings: the
# loss at most 7.5e-5 (the noise samples 1.4e-4), the statistics 6.5e-5
# (the noise 1.1e-4, the control 2.7e-4).
BF16_REFEREE_K = 1.25
BF16_NOISE_SAMPLES = 3
BF16_STEP_LOSS_TOL = 2e-4
BF16_STEP_STAT_TOL = 3e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def time_ms(fn, torch) -> float:
    """Device ms per call: after WARMUP calls, the median over TRIALS of
    one CUDA event pair around REPS back-to-back calls, divided by REPS.
    The card first spins for about 2 ms, so that the host has enqueued
    the calls before the first one starts: its time between launches
    (checks, allocation, argument marshalling, dispatch; 20-30 us a call)
    then does not count, which it would for a kernel shorter than that."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(TRIALS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS):
    t_ops = flops / peak_flops
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rows_nbytes(t, n: int) -> int:
    """Bytes of the first ``n`` rows (entries, for a vector) of ``t``."""
    return n * (t.numel() // t.shape[0]) * t.element_size()


def kernel_phase(torch, batch, model):
    """K1 against its plain version on the main path's first batch."""
    from pretrain_gnns_tpu_torch.ops import gin_conv

    dev = batch.node_mask.device
    conv = model.gnn.gnns[0]
    gen = torch.Generator().manual_seed(1)
    N = batch.max_nodes
    nm = batch.node_mask.to(torch.float32)
    x = (torch.randn(N, EMB, generator=gen).to(dev) * nm[:, None])
    args = conv.conv_inputs(x, batch)
    (_, ein, We, e_self, W1, b1, W2, b2, snd, rcv, w, _, bn, be) = args
    args = args[:11] + (nm,) + args[12:]
    g = torch.randn(N, EMB, generator=gen).to(dev)
    F, F2, K, E = EMB, W1.shape[1], ein.shape[1], snd.shape[0]
    e_valid = int(batch.edge_mask.sum())

    with torch.no_grad():
        out, aggr, z = gin_conv.gin_conv_fwd(*args)
        grads_k = gin_conv.gin_conv_bwd(g, aggr, z, ein, W1, W2, snd, rcv,
                                        w, nm, bn, be)
    torch.cuda.synchronize()
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, We, e_self, W1, b1, W2, b2)]
    lx, lWe, les, lW1, lb1, lW2, lb2 = leaves
    out_p, aggr_p, z_p = gin_conv.fused_gin_conv_plain(
        lx, ein, lWe, les, lW1, lb1, lW2, lb2, snd, rcv, w, nm, bn, be,
        return_residuals=True)
    grads_p = torch.autograd.grad(out_p, leaves, g, retain_graph=True)
    fwd_errs = {n: rel_err(a, b.detach()) for n, a, b in
                (("out", out, out_p), ("aggr", aggr, aggr_p), ("z", z, z_p))}
    names = ("dx", "dWe", "de_self", "dW1", "db1", "dW2", "db2")
    grad_errs = {n: rel_err(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    fwd_abs = max(float((a - b.detach()).abs().max()) for a, b in
                  ((out, out_p), (aggr, aggr_p), (z, z_p)))
    bwd_abs = max(float((a - b).abs().max())
                  for a, b in zip(grads_k, grads_p))
    print(f"[kernels] K1 forward rel err {fwd_errs}", flush=True)
    print(f"[kernels] K1 backward rel err {grad_errs}", flush=True)
    bad = {**{k: v for k, v in fwd_errs.items() if not v <= FWD_TOL},
           **{k: v for k, v in grad_errs.items() if not v <= GRAD_TOL}}
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad}")
    if not (gin_conv.launches["gin_conv_fwd"] > 0
            and gin_conv.launches["gin_conv_bwd"] > 0):
        raise AssertionError(f"K1 launch counter did not move: "
                             f"{gin_conv.launches}")
    # no atomics: a second run gives the same bits
    with torch.no_grad():
        again = gin_conv.gin_conv_fwd(*args)
        again += gin_conv.gin_conv_bwd(g, again[1], again[2], ein, W1, W2,
                                       snd, rcv, w, nm, bn, be)
    torch.cuda.synchronize()
    differ = [n for n, a, b in zip(("out", "aggr", "z") + names,
                                   (out, aggr, z) + tuple(grads_k), again)
              if not torch.equal(a, b)]
    print(f"[kernels] K1 run to run: "
          f"{f'differs in {differ}' if differ else 'out, aggr, z and all seven gradients equal bit for bit'}",
          flush=True)
    if differ:
        raise AssertionError(f"K1 is not repeatable: {differ}")

    # timings (device ms per call, see time_ms)
    def plain_fwd():
        gin_conv.fused_gin_conv_plain(*args)

    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
        out_p, leaves, g, retain_graph=True), torch)
    with torch.no_grad():
        kern_fwd_ms = time_ms(lambda: gin_conv.gin_conv_fwd(*args), torch)
        kern_bwd_ms = time_ms(lambda: gin_conv.gin_conv_bwd(
            g, aggr, z, ein, W1, W2, snd, rcv, w, nm, bn, be), torch)
        plain_fwd_ms = time_ms(plain_fwd, torch)
        dzr = z.clone()
        mm_fwd_ms = time_ms(lambda: (torch.matmul(aggr, W1),
                                     torch.matmul(z, W2)), torch)
        mm_bwd_ms = time_ms(lambda: (torch.matmul(g, W2.t()),
                                     torch.matmul(z.t(), g),
                                     torch.matmul(aggr.t(), dzr),
                                     torch.matmul(dzr, W1.t())), torch)
        # the same products through K1's own GEMM (gemm.cuh), with the
        # epilogues and the split K that K1 gives them
        s2 = gin_conv.wgrad_splits(F2, F, N)
        s1 = gin_conv.wgrad_splits(F, F2, N)
        gemm_fwd_ms = time_ms(lambda: (gin_conv.gemm(aggr, W1, b1, relu=True),
                                       gin_conv.gemm(z, W2, b2)), torch)
        gemm_bwd_ms = time_ms(lambda: (gin_conv.gemm(g, W2.t(), pos_mask=z),
                                       gin_conv.gemm(z.t(), g, splits=s2),
                                       gin_conv.gemm(aggr.t(), dzr, splits=s1),
                                       gin_conv.gemm(dzr, W1.t())), torch)
    unfused_fwd_ms, unfused_bwd_ms = unfused_layer_ms(torch, conv, x, batch,
                                                      g, out)

    # The bound counts the work this batch needs. Padded rows are one
    # constant row: in the forward aggr = 0 there, so z = relu(b1) and out
    # is the same for all of them; in the backward they add nothing to dx
    # or dW1, and to dW2, db1 and db2 only through the sum of their g rows
    # (one row through each product). So every product counts the V valid
    # rows plus one; the aggregation counts the valid edge slots.
    V = int(nm.sum())
    row_ops = 2 * F * F2  # one row through one product
    fwd_ops = 2 * (V + 1) * row_ops + e_valid * F * (2 * K + 3) + 3 * V * F
    bwd_ops = ((4 * V + 2) * row_ops + e_valid * F * (2 * K + 2)
               + 2 * V * F + N * F + 2 * (V + 1) * F2)
    edge_bytes = sum(rows_nbytes(t, e_valid) for t in (ein, snd, rcv, w))
    fwd_b, fwd_by = bound(
        fwd_ops,
        rows_nbytes(x, V) + edge_bytes
        + nbytes(We, e_self, W1, b1, W2, b2, nm, out, aggr, z))
    bwd_b, bwd_by = bound(
        bwd_ops,
        rows_nbytes(aggr, V) + rows_nbytes(z, V + 1) + edge_bytes
        + nbytes(g, W1, W2, nm, *grads_k))
    src = "pretrain_gnns_tpu_torch/csrc/gin_conv.cu"
    common = dict(route="cuda", source=src, library_ms=None,
                  shape="chem masking first batch")
    gemm_flops = 2 * N * F * F2  # one product over all N rows
    tflops = lambda n, ms: n * gemm_flops / ms / 1e9
    fwd = dict(name="gin_conv_fwd",
               replaces="pretrain_gnns_tpu/ops/pallas_gin.py:47",
               tpu_counterpart="ops/pallas_gin.py::_fwd_kernel via _call_fwd",
               max_abs_err=fwd_abs, ms=kern_fwd_ms, plain_ms=plain_fwd_ms,
               bound_ms=fwd_b, bound_by=fwd_by, matmul_ms=mm_fwd_ms,
               gemm_ms=gemm_fwd_ms, gemm_tflops=tflops(2, gemm_fwd_ms),
               matmul_tflops=tflops(2, mm_fwd_ms),
               unfused_ms=unfused_fwd_ms, **common)
    bwd = dict(name="gin_conv_bwd",
               replaces="pretrain_gnns_tpu/ops/pallas_gin.py:114",
               tpu_counterpart="ops/pallas_gin.py::_bwd_kernel via _call_bwd",
               max_abs_err=bwd_abs, ms=kern_bwd_ms, plain_ms=plain_bwd_ms,
               bound_ms=bwd_b, bound_by=bwd_by, matmul_ms=mm_bwd_ms,
               gemm_ms=gemm_bwd_ms, gemm_tflops=tflops(4, gemm_bwd_ms),
               matmul_tflops=tflops(4, mm_bwd_ms),
               unfused_ms=unfused_bwd_ms, **common)
    print(f"[kernels] shapes N={N} F={F} F2={F2} K={K} E={E} "
          f"valid_nodes={V} valid_edges={e_valid}; bound operations "
          f"fwd {fwd_ops:.4e} bwd {bwd_ops:.4e}", flush=True)
    for k in (fwd, bwd):
        print(f"[kernels] {k['name']}: kernel {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, unfused route (K2 [x+ein], two "
              f"nn.Linear, ReLU, self term) {k['unfused_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}); its products: "
              f"gemm.cuh {k['gemm_ms']:.4f} ms = {k['gemm_tflops']:.1f} "
              f"TFLOP/s, torch.matmul {k['matmul_ms']:.4f} ms = "
              f"{k['matmul_tflops']:.1f} TFLOP/s ("
              f"{100 * k['gemm_tflops'] / k['matmul_tflops']:.0f}% of "
              "torch.matmul's rate)", flush=True)
    return [fwd, bwd]


def unfused_layer_ms(torch, conv, x, batch, g, k1_out):
    """Device ms of one GIN layer on the unfused route
    (``gin_conv.set_fused("off")``: K2 ``[x+ein]``, the self term, the two
    ``nn.Linear`` and the ReLU), forward and backward, on K1's inputs; its
    output is held against K1's."""
    with fused_as("off"):
        with torch.no_grad():
            fwd_ms = time_ms(lambda: conv(x, batch), torch)
        xl = x.detach().clone().requires_grad_(True)
        out = conv(xl, batch)
        leaves = [xl] + list(conv.parameters())
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            out, leaves, g, retain_graph=True), torch)
    err = rel_err(out.detach(), k1_out)
    print(f"[kernels] unfused GIN layer: forward rel err from K1 {err:.3e}",
          flush=True)
    if not err <= FWD_TOL:
        raise AssertionError(f"the unfused GIN layer disagrees with K1: {err}")
    return fwd_ms, bwd_ms


def host_config(**kw):
    """A ``PretrainConfig`` of the host-packed pipeline (``device_dataset``
    "off" unless given), which every phase but the device-resident
    section drives: on CUDA "auto" now keeps the dataset on the card, and
    that section runs it on and off itself."""
    from pretrain_gnns_tpu_torch.train import pretrain

    return pretrain.PretrainConfig(**{"device_dataset": "off", **kw})


def path_name(cfg, fused="on") -> str:
    unfused = " unfused" * (fused == "off")
    mode = f" {cfg.mode}" * (cfg.objective == "contextpred")
    host = " host" * (cfg.transform_device == "host")
    drawn = " in-step draws" * (cfg.transform_device == "device")
    resident = " resident" * (cfg.device_dataset == "on")
    return (f"{cfg.domain} {cfg.objective} {cfg.gnn_type}{mode}{unfused}"
            f"{host}{drawn}{resident}")


@contextlib.contextmanager
def fused_as(mode):
    """``set_fused(mode)`` of the GAT conv (K4) and the GIN conv (K1) for
    the block, "on" again after it."""
    from pretrain_gnns_tpu_torch.ops import gat_conv, gin_conv

    gat_conv.set_fused(mode)
    gin_conv.set_fused(mode)
    try:
        yield
    finally:
        gat_conv.set_fused("on")
        gin_conv.set_fused("on")


def agreement_phase(torch, batch, cfg, referee=False, fused="on",
                    noise_samples=NOISE_SAMPLES):
    """One train-mode step of ``cfg``'s objective on the card and on the
    CPU. With ``referee``, a float64 step on the CPU and the measured
    float32 noise (1 + ``noise_samples`` CPU steps) set the gradients'
    limit (see REFEREE_K)."""
    with fused_as(fused):
        _agreement(torch, batch, cfg, referee, path_name(cfg, fused),
                   noise_samples)


def _agreement(torch, batch, cfg, referee, name, noise_samples):
    tag = f"[{name} agreement]"
    from pretrain_gnns_tpu_torch.models import inits
    from pretrain_gnns_tpu_torch.train.pretrain import build_objective

    def step(dev, dtype=torch.float32, noise_seed=None):
        model = build_objective(cfg)  # same seed, same weights
        if noise_seed is not None:
            gen = torch.Generator().manual_seed(noise_seed)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + NOISE_EPS * torch.randn(p.shape,
                                                       generator=gen))
        model = model.to(dev, dtype)
        was = inits.activation_dtype
        inits.activation_dtype = lambda: dtype
        try:
            loss, _ = model(batch.to(dev), train=True)
        finally:
            inits.activation_dtype = was
        loss.backward()
        grads = {n: p.grad.detach().cpu()
                 for n, p in model.named_parameters()}
        stats = {n: b.detach().cpu() for n, b in model.named_buffers()}
        if not all(t.dtype == dtype for t in (loss, *grads.values())):
            raise AssertionError(f"{tag} step did not run in {dtype}")
        return float(loss.detach()), grads, stats

    def grad_err(got, want):
        return max(rel_err(got[n].to(want[n].dtype), want[n]) for n in want)

    (lc, gc, bc), (lp, gp, bp) = step("cuda"), step("cpu")
    loss_err = abs(lc - lp) / max(1.0, abs(lp))
    stat_err = max((rel_err(bc[n].float(), bp[n].float()) for n in bp),
                   default=0.0)  # a GraphSAGE bio trunk has no batch norm
    if referee:
        l64, g64, _ = step("cpu", torch.float64)
        card = [grad_err(gc, g64)] + [
            grad_err(step("cuda", noise_seed=1000 + i)[1], g64)
            for i in range(2)]
        card_err = statistics.median(card)
        noise = [grad_err(gp, g64)] + [
            grad_err(step("cpu", noise_seed=i)[1], g64)
            for i in range(noise_samples)]
        limit = max(STEP_GRAD_TOL, REFEREE_K * max(noise))
        fmt = lambda errs: " ".join(f"{e:.3e}" for e in errs)
        print(f"{tag} float64 referee on the CPU: loss {l64:.9f}; max grad "
              f"rel err from it: card {fmt(card[:1])} and, parameters "
              f"scaled by 1 + {NOISE_EPS:.0e} * N(0, 1), {fmt(card[1:])}; "
              f"CPU float32 {fmt(noise[:1])} and, scaled, {fmt(noise[1:])}; "
              f"card vs CPU float32 {grad_err(gc, gp):.3e}", flush=True)
    else:
        card_err, limit = grad_err(gc, gp), STEP_GRAD_TOL
    print(f"{tag} loss cuda={lc:.6f} cpu={lp:.6f} rel err "
          f"{loss_err:.3e}; max grad rel err{' (median)' * referee} "
          f"{card_err:.3e} (limit "
          f"{limit:.3e}); max BN stat rel err {stat_err:.3e} "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)
    if not (loss_err <= STEP_LOSS_TOL and card_err <= limit
            and stat_err <= STEP_GRAD_TOL and math.isfinite(lc)):
        raise AssertionError(f"{name} step on the card disagrees with "
                             "the CPU reference")


def referee_depth(cfg):
    """``cfg`` with BIO_REFEREE_LAYERS layers in the bio domain, as it is
    in chem."""
    import dataclasses

    if cfg.domain != "bio":
        return cfg
    return dataclasses.replace(cfg, num_layer=BIO_REFEREE_LAYERS)


def counted_modules():
    """Every module of the port that holds a ``launches`` dict."""
    from pretrain_gnns_tpu_torch.ops import (
        _build, attention, blocked_spmm, edge_dot, gat_conv, gin_conv,
        sorted_spmm,
    )

    return (gin_conv, blocked_spmm, edge_dot, gat_conv, attention,
            sorted_spmm, _build)


def read_counts(modules):
    return {k: v for m in modules for k, v in m.launches.items()}


def main_path_phase(torch, graphs, cfg, card, per_step,
                    epochs=MAIN_EPOCHS, fused="on", reprobe=False,
                    precision="float32", profile=False, profile_from=None):
    """``run_pretrain`` on the card at the resolved default ``scan_steps``
    K (16): after the run's first eager steps each group of K batches is
    one CUDA-graph replay. Every launch count is set to 0 just before and
    read just after. The counters count Python calls: the eager steps' and,
    once, the K steps of the capture; a replay launches the captured graph
    and counts nothing. So ``per_step`` (the launches a step of each
    counter that must move; every other count must stay 0) times (eager
    steps + K) must be the count. With ``reprobe`` the probe's answer and
    the GIN library's handle are forgotten first, so the run's first kernel
    launch must load the library anew and launch the probe: exactly once in
    the run. Returns (the counts, the steps that made them, how each count
    was read, the run's replays, its edges/s over the timed window, the
    trained objective, with ``profile`` the card's busy share of that
    window and its busy ms a step, else None, None, and the history).
    ``precision`` names
    the knobs' setting in the printed line.

    The timed window runs between two of the run's marks
    (``run_pretrain``'s ``marks``: one after each epoch's steps, or after
    each group's in the epoch trainer) on the card's clock
    (``telemetry.seconds_between``, the idle gaps included), over the
    valid edges of the epochs between them; it ends at the run's last
    mark. Without ``profile`` it starts at the first mark after a replay
    (so after the capture). With ``profile``, at the log line of epoch
    ``profile_from`` (default: the epoch before the last) the card is
    synchronized and ``torch.profiler`` starts; it records every launch
    from there to the run's end, and the window starts at the last mark
    made before it. The epoch trainer logs a group's epochs after it has
    queued the next group, so there the window is the groups after
    that one. The busy share is the union of the recorded device
    activities' intervals over the window's time; the window must not
    hold the capture."""
    from pretrain_gnns_tpu_torch.ops import _build, gin_conv
    from pretrain_gnns_tpu_torch.train import pretrain

    name = path_name(cfg, fused)
    tag = f"[{name}{' ' + precision if precision != 'float32' else ''} path]"
    from pretrain_gnns_tpu_torch.train.telemetry import seconds_between

    logged, prof = [], []
    if profile_from is None:
        profile_from = epochs - 1

    def log(msg):
        print(f"{tag} {msg}", flush=True)
        if msg.startswith("epoch="):
            logged.append(msg)
            if profile and len(logged) == profile_from:
                torch.cuda.synchronize()  # nothing queued is left unrecorded
                prof.append(torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]))
                prof[0].__enter__()
                prof.append(time.perf_counter())

    modules = counted_modules()
    torch.cuda.reset_peak_memory_stats()
    if reprobe:
        _build.probe.cache_clear()
        gin_conv._lib.cache_clear()
    with fused_as(fused):
        for m in modules:
            m.reset_launches()
        t_run = time.perf_counter()
        res = pretrain.run_pretrain(cfg, graphs, log=log, epochs=epochs,
                                    device="cuda")
        counts = read_counts(modules)
        t_run = time.perf_counter() - t_run
        if prof:
            t = time.perf_counter()
            prof[0].__exit__(None, None, None)
            prof.append(time.perf_counter() - t)
    hist = res["history"]
    steps = sum(h["steps"] for h in hist)
    k, replays, eager = res["scan_steps"], res["replays"], res["eager_steps"]
    if k != pretrain.resolve_scan_steps(0, "cuda") or not replays or (
            eager + k * replays != steps):
        raise AssertionError(f"{name} path: K {k}, {replays} replays and "
                             f"{eager} eager steps for {steps} steps")
    counted = eager + k
    want = {key: per_step.get(key, 0) * counted for key in counts}
    want["probe_scale2"] = int(reprobe)
    if counts != want or set(per_step) - set(counts):
        raise AssertionError(f"{name} path launches {counts} != "
                             f"{want} ({per_step} x ({eager} eager steps + "
                             f"{k} captured))")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss: {hist}")
    how = {key: f"{counts[key]} wrapper calls counted in Python over "
                f"{eager} eager steps and the {k} steps of one capture; "
                f"the run replayed that capture {replays} times as one "
                f"CUDA graph, which counts nothing" for key in per_step}
    marks = res["marks"]
    if profile:
        if len(prof) != 3:
            raise AssertionError(f"{name} path: no log line of epoch "
                                 f"{profile_from} to profile from")
        start = [m for m in marks if m.at < prof[1]][-1]
    else:
        start = next((m for m in marks if m.replays), None)
    if start is None or start is marks[-1] or not start.replays:
        raise AssertionError(f"{name} path: no epoch to time after the "
                             f"capture's (marks after epochs "
                             f"{[m.epoch for m in marks]})")
    timed = [h for h in hist if h["epoch"] > start.epoch]
    seconds = seconds_between(start, marks[-1])
    rate = sum(h["edges"] for h in timed) / seconds
    timed_steps = sum(h["steps"] for h in timed)
    busy = step_ms = None
    if profile:
        t = time.perf_counter()
        step_ms = busy_ms(prof[0]) / timed_steps
        busy = step_ms * timed_steps / 1e3 / seconds
        prof[2] += time.perf_counter() - t
    print(f"{tag} K = {k}: {replays} replays and {eager} eager steps, "
          f"{steps} steps in {t_run:.1f} s; launches counted "
          f"{ {key: v for key, v in counts.items() if v} }; "
          f"{rate:.1f} valid edges/s "
          f"over epochs {start.epoch + 1}-{marks[-1].epoch} "
          f"({timed_steps} steps, {precision}, "
          + (f"{res['epoch_group']} epochs a group"
             if res["epoch_group"] else "one epoch at a time")
          + f") on {card}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
          + (f"; the card busy {100 * busy:.1f}% of those epochs' time on "
             f"its clock, {step_ms:.3f} ms a step (profiled; the profile "
             f"read in {prof[2]:.1f} s)" if profile else "")
          + f" [{time.perf_counter() - T0:.0f} s]", flush=True)
    return (counts, counted, how, replays, rate, res["model"], busy,
            step_ms, hist)


def record_launches(entries, launched, names=None):
    """Writes a path's launches into the entries of the kernels it ran:
    the wrapper calls counted in the run, from them the calls a step, the
    run's replays, and how they were counted."""
    counts, steps = launched[:2]
    how = launched[2] if len(launched) > 2 else {}
    for k in entries:
        key = k.get("counter", k["name"])  # a bfloat16 variant's counter
        if names is None or key in names:
            k["launches"] = counts[key]
            k["launches_counted"] = how.get(
                key, "eager calls, counted in Python")
            if steps:
                k["launches_per_step"] = counts[key] // steps
            if len(launched) > 3:
                k["replays"] = launched[3]


# the capture phase: CAPTURE_GROUPS replays of CAPTURE_K steps after the
# run's warm-up steps, against as many eager steps from the same state
CAPTURE_K = 4
CAPTURE_GROUPS = 2
# a fragment of the device kernel's name for each counter: a replay must
# show every one of its path
KERNEL_NAMES = {
    "gin_conv_fwd": ("edge_aggr_fwd_kernel<true, true, true,",
                     "gemm_kernel"),
    "gin_conv_bwd": ("edge_aggr_bwd_kernel<true, true, true,",
                     "gemm_kernel"),
    **{f"blocked_spmm_{d}[{v}]": (f"edge_aggr_{d}_kernel<{args}, false,",)
       for d in ("fwd", "bwd")
       for v, args in (("x", "true, false"), ("ein", "false, true"),
                       ("x+ein", "true, true"))},
    "blocked_edge_dot_fwd": ("edot_fwd_kernel",),
    "blocked_edge_dot_bwd": ("edot_bwd_kernel",),
    # the GAT walks' float32 instantiations (BF, the fourth argument,
    # false)
    "gat_conv_fwd": (r"gat_fwd_kernel<true, [^>]*, false, float>",
                     "gemm_kernel"),
    "gat_conv_bwd": (r"gat_bwd_rcv_kernel<true, [^>]*, false, float>",
                     r"gat_bwd_snd_kernel<true, [^>]*, false, float>",
                     "gat_dwe_kernel"),
    "blocked_gat_attention_fwd": (r"gat_fwd_kernel<false, [^>]*, false, "
                                  r"float>",),
    "blocked_gat_attention_bwd": (
        r"gat_bwd_rcv_kernel<false, [^>]*, false, float>",
        r"gat_bwd_snd_kernel<false, [^>]*, false, float>"),
}


def _snapshot(state, losses):
    """What the steps changed: the parameters, the batch-norm statistics,
    Adam's moments and the per-step losses."""
    import torch

    model, opt = state.model, state.optimizer
    return {
        "parameters": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
        "BN statistics": {n: b.clone() for n, b in model.named_buffers()},
        "Adam moments": {f"{n}.{key}": v.clone()
                         for n, p in model.named_parameters()
                         for key, v in opt.state.get(p, {}).items()},
        "losses": {"": torch.cat([v.reshape(-1) for v in losses])},
    }


def _max_diff(a, b):
    """Each group's largest absolute difference between two snapshots (0
    for a group without tensors: a trunk without batch norm)."""
    return {group: max((float((t.double() - b[group][key].double())
                              .abs().max()) for key, t in a[group].items()),
                       default=0.0)
            for group in a}


def busy_ms(prof) -> float:
    """The card's busy ms in a ``torch.profiler`` run: the union of its
    device activities' intervals, read from the profiler's raw records
    (building its event list takes seconds for a few hundred steps)."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy_ns, reach = 0, float("-inf")
    for start, end in spans:  # the union of the intervals
        busy_ns += max(0, end - max(start, reach))
        reach = max(reach, end)
    return busy_ns / 1e6


def capture_phase(torch, graphs, cfg, per_step, fused="on",
                  kernel_names=None, absent_names=None):
    """Captured steps against eager steps on the path's first batches at
    full width, from the same seeded state: ``graphed.WARMUP_STEPS`` eager
    steps and CAPTURE_GROUPS replays of CAPTURE_K steps through
    ``make_scan_pretrain_step``, against as many eager ``train_step``s,
    run twice. The two eager runs must be bit-equal (the port's kernels
    have no atomics, and its embeddings and row sums sum in a fixed order:
    ``models/chem.lookup``, ``ops/segment``), and the captured run bit-equal
    to them. One more replay runs under ``torch.profiler``: every kernel of
    ``per_step``'s counters must show among its device activities by
    name (KERNEL_NAMES' patterns, ``kernel_names``' in their place), and
    none of ``absent_names``' patterns for those counters. Its busy share
    is the union of its device activities' intervals over the call's wall
    time (the K batches' copies and the replay, until the card is done)."""
    import itertools

    from torch.autograd import DeviceType

    from pretrain_gnns_tpu_torch.train import graphed, optim, pretrain
    from pretrain_gnns_tpu_torch.train.state import TrainState

    tag = f"[{path_name(cfg, fused)} capture]"
    if kernel_names:
        tag = tag[:-1] + " bfloat16]"
    dev = torch.device("cuda")
    W, K = graphed.WARMUP_STEPS, CAPTURE_K
    n = W + K * CAPTURE_GROUPS
    loader = pretrain.build_loader(cfg, graphs, dev)
    host = [b.pin_memory() for b in itertools.islice(
        (b for _ in range(2) for b in loader), n + K)]

    def fresh():
        model = pretrain.build_objective(cfg).to(dev)
        return TrainState(model, optim.adam(model.parameters(), cfg.lr,
                                            cfg.decay))

    def eager():
        st = fresh()
        losses = [pretrain.train_step(st, b.to(dev, non_blocking=True))[0]
                  for b in host[:n]]
        return _snapshot(st, losses)

    with fused_as(fused):
        runs = [eager(), eager()]
        st = fresh()
        scan = pretrain.make_scan_pretrain_step(st, host[0], K)
        losses = [scan.step(b)[0] for b in host[:W]]
        losses += [scan(host[W + g * K: W + (g + 1) * K])[0]
                   for g in range(CAPTURE_GROUPS)]
        captured = _snapshot(st, losses)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t_call = time.perf_counter()
            scan(host[n:n + K])
            torch.cuda.synchronize()
            t_call = time.perf_counter() - t_call
    ee, ce = _max_diff(runs[1], runs[0]), _max_diff(captured, runs[0])
    ran = collections.Counter(e.name for e in prof.events()
                              if e.device_type == DeviceType.CUDA)
    names = {**KERNEL_NAMES, **(kernel_names or {})}
    missing = sorted({frag for key in per_step for frag in names[key]
                      if not any(re.search(frag, nm) for nm in ran)})
    present = sorted({nm[:80] for key in per_step
                      for frag in (absent_names or {}).get(key, ())
                      for nm in ran if re.search(frag, nm)})
    busy_us = busy_ms(prof) * 1e3
    own = collections.Counter()
    for nm, times in ran.items():
        if any(re.search(frag, nm) for frags in names.values()
               for frag in frags):
            own[nm[:80]] += times
    print(f"{tag} {W} eager steps and {CAPTURE_GROUPS} replays of {K} "
          f"against {n} eager steps; max |captured - eager|: "
          + ", ".join(f"{g} {v:.3g}" for g, v in ce.items())
          + "; max |eager - eager|: "
          + ", ".join(f"{g} {v:.3g}" for g, v in ee.items())
          + f"; a profiled replay of {K} steps ran {sum(ran.values())} "
          f"device activities of {len(ran)} names, the port's kernels "
          f"(launches by name) "
          f"{dict(sorted(own.items()))}; the card busy "
          f"{busy_us / 1e3:.3f} ms of the call's {t_call * 1e3:.3f} ms "
          f"({100 * busy_us / 1e6 / t_call:.1f}%, profiled) "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)
    if any(ee.values()) or any(ce.values()):
        raise AssertionError(f"{tag} the steps are not bit-equal")
    if missing:
        raise AssertionError(f"{tag} a replay ran no kernel named {missing}")
    if present:
        raise AssertionError(f"{tag} a replay ran {present}")


def k2_phase(torch, batch, ein, W, w, variants, shape):
    """K2 against its plain version on a path's first batch, for each
    ``(has_x, has_ein)`` of ``variants``, with the edge inputs ``ein``
    [E, K], the edge kernel ``W`` [K, F] and the edge weights ``w`` [E]
    that the path's trunk gives it in its first layer."""
    from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs

    dev = batch.node_mask.device
    gen = torch.Generator().manual_seed(2)
    N, E = batch.max_nodes, batch.max_edges
    nm = batch.node_mask.to(torch.float32)
    x = torch.randn(N, EMB, generator=gen).to(dev) * nm[:, None]
    g = torch.randn(N, EMB, generator=gen).to(dev)
    W = W.detach().contiguous()
    snd, rcv = batch.senders, batch.receivers
    bn, be, K, F = batch.block_nodes, batch.block_edges, W.shape[0], EMB
    valid = batch.edge_mask
    e_valid = int(valid.sum())
    n_snd = int(torch.unique(snd[valid]).numel())  # x rows the sum reads
    n_rcv = int(torch.unique(rcv[valid]).numel())  # g rows dmsg reads
    csr = {}
    if any(not has_ein for _, has_ein in variants):
        # the library's yardstick for the has_x variant: out = A x and
        # dx = A^T g with A[r, s] = w over the valid edges, built untimed
        pairs = torch.stack([rcv[valid].long(), snd[valid].long()])
        csr = {name: torch.sparse_coo_tensor(idx, w[valid], (N, N))
               .coalesce().to_sparse_csr()
               for name, idx in (("A", pairs), ("At", pairs.flip(0)))}
        lib_err = rel_err(torch.sparse.mm(csr["A"], x),
                          bs.blocked_spmm_fused_plain(x, None, None, snd, rcv,
                                                      w, bn, be, True, False))
        if not lib_err <= FWD_TOL:
            raise AssertionError("torch.sparse.mm yardstick disagrees: "
                                 f"{lib_err}")
    src = "pretrain_gnns_tpu_torch/csrc/spmm.cu"
    entries = []
    for has_x, has_ein in variants:
        v = bs.variant(has_x, has_ein)
        fwd_args = (x, ein, W, snd, rcv, w, bn, be, has_x, has_ein)
        bwd_args = (g, ein, snd, rcv, w, K, bn, be, has_x, has_ein)
        with torch.no_grad():
            runs = [(bs.spmm_fwd(*fwd_args),) + bs.spmm_bwd(*bwd_args)
                    for _ in range(2)]
        torch.cuda.synchronize()
        out, dx, dW = runs[0]
        # no atomics: a second run gives the same bits
        bit_equal = all(a is None or torch.equal(a, c)
                        for a, c in zip(*runs))
        if not bit_equal:
            raise AssertionError(f"K2[{v}] differs between two runs on the "
                                 "same inputs")
        xl = x.detach().clone().requires_grad_(True)
        Wl = W.detach().clone().requires_grad_(True)
        out_p = bs.blocked_spmm_fused_plain(xl, ein, Wl, snd, rcv, w, bn, be,
                                            has_x, has_ein)
        leaves = [t for t, f in ((xl, has_x), (Wl, has_ein)) if f]
        grads_k = [t for t, f in ((dx, has_x), (dW, has_ein)) if f]
        grads_p = torch.autograd.grad(out_p, leaves, g, retain_graph=True)
        gnames = [n for n, f in (("dx", has_x), ("dW", has_ein)) if f]
        fwd_err = rel_err(out, out_p.detach())
        grad_errs = {n: rel_err(a, b)
                     for n, a, b in zip(gnames, grads_k, grads_p)}
        print(f"[kernels] K2[{v}] forward rel err {fwd_err:.3e}, backward "
              f"rel err {grad_errs}; padded rows max "
              f"{float(out[~batch.node_mask].abs().max()):.1e}; two runs "
              f"bit-equal", flush=True)
        if not (fwd_err <= FWD_TOL and all(e <= GRAD_TOL
                                            for e in grad_errs.values())
                and not out[~batch.node_mask].any()):
            raise AssertionError(f"K2[{v}] disagrees with its plain version")
        fwd_abs = float((out - out_p.detach()).abs().max())
        bwd_abs = max(float((a - b).abs().max())
                      for a, b in zip(grads_k, grads_p))

        # timings (device ms per call, see time_ms)
        plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
            out_p, leaves, g, retain_graph=True), torch)
        with torch.no_grad():
            kern_fwd_ms = time_ms(lambda: bs.spmm_fwd(*fwd_args), torch)
            kern_bwd_ms = time_ms(lambda: bs.spmm_bwd(*bwd_args), torch)
            plain_fwd_ms = time_ms(
                lambda: bs.blocked_spmm_fused_plain(*fwd_args), torch)
            lib_fwd_ms = lib_bwd_ms = None
            if not has_ein:
                lib_fwd_ms = time_ms(
                    lambda: torch.sparse.mm(csr["A"], x), torch)
                lib_bwd_ms = time_ms(
                    lambda: torch.sparse.mm(csr["At"], g), torch)

        # The bound counts the work this batch needs: the valid edges,
        # each needed x or g row once, the edge arrays of the valid edges,
        # W once, and every output written once.
        row = F * 4
        e_bytes = e_valid * 4 * (2 + has_x + (K if has_ein else 0))
        fwd_ops = e_valid * F * (2 * K * has_ein + (has_x and has_ein) + 2)
        bwd_ops = e_valid * F * (1 + has_x + 2 * K * has_ein)
        fwd_b, fwd_by = bound(fwd_ops, n_snd * row * has_x
                              + K * row * has_ein + e_bytes + nbytes(out))
        bwd_b, bwd_by = bound(bwd_ops, n_rcv * row + e_bytes
                              + sum(nbytes(t) for t in grads_k))
        library = ("torch.sparse.mm, CSR adjacency of w" if not has_ein else
                   "none: no single PyTorch call computes it")
        for d, ms, pms, b_ms, by, lms, err, line in (
                ("fwd", kern_fwd_ms, plain_fwd_ms, fwd_b, fwd_by, lib_fwd_ms,
                 fwd_abs, 328),
                ("bwd", kern_bwd_ms, plain_bwd_ms, bwd_b, bwd_by, lib_bwd_ms,
                 bwd_abs, 377)):
            entries.append(dict(
                name=f"blocked_spmm_{d}[{v}]", route="cuda", source=src,
                replaces=f"pretrain_gnns_tpu/ops/pallas_spmm.py:{line}",
                tpu_counterpart=(f"ops/pallas_spmm.py::_fused_{d}_kernel via "
                                 f"_fused_call_{d} (blocked_spmm_fused)"),
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms,
                bound_by=by, library_ms=lms, library=library, shape=shape,
                bit_equal=bit_equal))
    print(f"[kernels] K2 at the {shape}: N={N} F={F} K={K} E={E} valid_edges="
          f"{e_valid} senders={n_snd} receivers={n_rcv}", flush=True)
    for k in entries:
        lib = ("none" if k["library_ms"] is None
               else f"{k['library_ms']:.4f} ms")
        print(f"[kernels] {k['name']}: kernel {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, library {lib}, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']})", flush=True)
    return entries


def k3_phase(torch, batch, tag):
    """K3 against its plain version on an edge-prediction path's first
    batch, for both scoring heads. Returns ``{(direction, head): dict}``
    with the measured times, errors and bounds."""
    from pretrain_gnns_tpu_torch.ops import edge_dot as ed

    dev = batch.node_mask.device
    gen = torch.Generator().manual_seed(3)
    N, F, bn = batch.max_nodes, EMB, batch.block_nodes
    x = (torch.randn(N, F, generator=gen).to(dev)
         * batch.node_mask[:, None])
    neg = batch.extras["negative_edges_blocked"]
    heads = {
        # every edge slot; the loss keeps the even ones, so the backward's
        # cotangent is 0 on the odd slots
        "pos": (batch.receivers, batch.senders, batch.edge_mask,
                batch.block_edges, 2),
        "neg": (neg[:, 0].contiguous(), neg[:, 1].contiguous(),
                batch.extras["negative_edges_blocked_mask"],
                batch.block_edges // 2, 1),
    }
    results = {}
    for head, (a_idx, b_idx, valid, ppb, stride) in heads.items():
        w = valid.to(torch.float32)
        P = a_idx.shape[0]
        g = torch.randn(P, generator=gen).to(dev)
        g_path = torch.zeros_like(g)
        g_path[::stride] = g[::stride]
        with torch.no_grad():
            out = ed.edot_fwd(x, a_idx, b_idx, w, bn, ppb)
            out_again = ed.edot_fwd(x, a_idx, b_idx, w, bn, ppb)
            dx = ed.edot_bwd(g, x, a_idx, b_idx, w, bn, ppb)
            dx_again = ed.edot_bwd(g, x, a_idx, b_idx, w, bn, ppb)
            dx_path = ed.edot_bwd(g_path, x, a_idx, b_idx, w, bn, ppb)
        torch.cuda.synchronize()
        xl = x.detach().clone().requires_grad_(True)
        out_p = ed.edge_dot_plain(xl, a_idx, b_idx, w)
        (dx_p,) = torch.autograd.grad(out_p, [xl], g, retain_graph=True)
        (dx_path_p,) = torch.autograd.grad(out_p, [xl], g_path,
                                           retain_graph=True)
        fwd_err = rel_err(out, out_p.detach())
        bwd_err = max(rel_err(dx, dx_p), rel_err(dx_path, dx_path_p))
        touched = torch.zeros(N, dtype=torch.bool, device=dev)
        touched[a_idx[valid].long()] = True
        touched[b_idx[valid].long()] = True
        rerun = float((dx - dx_again).abs().max())
        same_fwd = torch.equal(out, out_again)
        print(f"[kernels] K3 {tag} {head}: P={P} ({ppb} a block, "
              f"{int(valid.sum())} valid) forward rel err {fwd_err:.3e}, dx "
              f"rel err {bwd_err:.3e}; padded pairs max "
              f"{float(out[~valid].abs().max()):.1e}, untouched rows max "
              f"{float(dx[~touched].abs().max()):.1e}; dx run-to-run max "
              f"abs difference {rerun:.1e}; scores equal bits in two runs: "
              f"{same_fwd}", flush=True)
        if not (fwd_err <= FWD_TOL and bwd_err <= GRAD_TOL
                and not out[~valid].any() and not dx[~touched].any()
                and rerun == 0.0 and same_fwd):
            raise AssertionError(f"K3 {tag} {head} disagrees with its plain "
                                 "version")
        if not (ed.launches["blocked_edge_dot_fwd"] > 0
                and ed.launches["blocked_edge_dot_bwd"] > 0):
            raise AssertionError(f"K3 launch counter did not move: "
                                 f"{ed.launches}")

        # timings (device ms per call, see time_ms), the backward with the
        # cotangent the path gives it
        plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
            out_p, [xl], g_path, retain_graph=True), torch)
        with torch.no_grad():
            fwd_ms = time_ms(lambda: ed.edot_fwd(x, a_idx, b_idx, w, bn, ppb),
                             torch)
            bwd_ms = time_ms(lambda: ed.edot_bwd(g_path, x, a_idx, b_idx, w,
                                                 bn, ppb), torch)
            plain_fwd_ms = time_ms(
                lambda: ed.edge_dot_plain(x, a_idx, b_idx, w), torch)

        # The bound counts the work this batch needs: the distinct x rows
        # that the contributing pairs read, their index, weight (and
        # cotangent) entries, every score written once; the backward also
        # writes dx [N, F] once. A pair costs 2F operations forward and 4F
        # backward.
        live = valid & (g_path != 0)
        rows_f = int(touched.sum())
        rows_b = int(torch.unique(torch.cat(
            [a_idx[live], b_idx[live]])).numel())
        nv, nl = int(valid.sum()), int(live.sum())
        fwd_b, fwd_by = bound(2 * F * nv, rows_f * F * 4 + nv * 12 + P * 4)
        bwd_b, bwd_by = bound(4 * F * nl,
                              rows_b * F * 4 + nl * 16 + N * F * 4)
        for d, ms, pms, b_ms, by, err in (
                ("fwd", fwd_ms, plain_fwd_ms, fwd_b, fwd_by,
                 float((out - out_p.detach()).abs().max())),
                ("bwd", bwd_ms, plain_bwd_ms, bwd_b, bwd_by,
                 float((dx - dx_p).abs().max()))):
            results[d, head] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                                    bound_by=by, max_abs_err=err, pairs=P,
                                    valid_pairs=nv if d == "fwd" else nl)
            print(f"[kernels] blocked_edge_dot_{d} {tag} {head}: kernel "
                  f"{ms:.4f} ms, plain {pms:.4f} ms, library none (no single "
                  f"call), bound {b_ms:.4f} ms ({by})", flush=True)
    return results


def k3_entries(chem, bio):
    """The ``kernels`` entries of K3: one per direction, with the times of
    the positive head (every edge slot) at the chem path's first batch
    under the contract's keys, and the other head and the bio batch
    beside them."""
    src = "pretrain_gnns_tpu_torch/csrc/edge_dot.cu"
    entries = []
    for d, line in (("fwd", 587), ("bwd", 610)):
        main = chem[d, "pos"]
        others = {f"{tag}_{head}": r[d, head]
                  for tag, r in (("chem", chem), ("bio", bio))
                  for head in ("pos", "neg") if (tag, head) != ("chem", "pos")}
        entries.append(dict(
            name=f"blocked_edge_dot_{d}", route="cuda", source=src,
            replaces=f"pretrain_gnns_tpu/ops/pallas_spmm.py:{line}",
            tpu_counterpart=(f"ops/pallas_spmm.py::_edot_{d}_kernel via "
                             "_edot_call (blocked_edge_dot)"),
            max_abs_err=max(r[d, h]["max_abs_err"] for r in (chem, bio)
                            for h in ("pos", "neg")),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=None,
            library="none: no single PyTorch call computes it",
            shape="chem edge-prediction first batch, positive head",
            other_shapes=others))
    return entries


def gat_phase(torch, batch, conv, ein, tag):
    """K4 and K5 against their plain versions on a GAT masking path's
    first batch, with the first layer's parameters (``conv``) and edge
    inputs ``ein`` [E, K]. Returns ``{kernel name: dict}`` with the
    measured times, errors and bounds."""
    from pretrain_gnns_tpu_torch.ops import attention as at
    from pretrain_gnns_tpu_torch.ops import gat_conv as gc

    dev = batch.node_mask.device
    gen = torch.Generator().manual_seed(4)
    N, E, bn, be = (batch.max_nodes, batch.max_edges, batch.block_nodes,
                    batch.block_edges)
    H, D, K, slope = conv.heads, conv.emb_dim, ein.shape[1], 0.2
    HD = H * D
    nm = batch.node_mask.to(torch.float32)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    h = rnd(N, D) * nm[:, None]
    # the trunk zeroes padded rows after the conv, so their cotangent is 0
    g, g3 = rnd(N, D) * nm[:, None], rnd(N, H, D) * nm[:, None, None]
    with torch.no_grad():
        We, e_self = conv.edge_kernel()
        Wl, bl = conv.weight_linear.weight.t(), conv.weight_linear.bias
        par = [We.contiguous(), e_self.reshape(H, D).contiguous(),
               conv.att[0, :, :D].contiguous(),
               conv.att[0, :, D:].contiguous()]
        bias = rnd(D) * 0.1  # the parameter starts at 0
    graph = (batch.senders, batch.receivers,
             batch.edge_mask.to(torch.float32))
    pad = ~batch.edge_mask

    def check(name, fwd_errs, grad_errs, zeros, same):
        print(f"[kernels] {name} {tag}: forward rel err {fwd_errs}, backward "
              f"rel err {grad_errs}; padded slots max "
              f"{max(float(z.abs().max()) for z in zeros):.1e}; equal bits "
              f"in two runs: {same}", flush=True)
        bad = {**{k: v for k, v in fwd_errs.items() if not v <= FWD_TOL},
               **{k: v for k, v in grad_errs.items() if not v <= GRAD_TOL}}
        if bad or any(z.any() for z in zeros) or not same:
            raise AssertionError(f"{name} {tag} disagrees with its plain "
                                 f"version: {bad}")

    # K4: the whole layer
    k4_fwd = lambda: gc.gat_conv_fwd(h, Wl, bl, ein, *par, bias, *graph, bn,
                                     be, slope)
    with torch.no_grad():
        out, x, saved = k4_fwd()
        k4_bwd = lambda: gc.gat_conv_bwd(g, h, Wl, x, ein, *par, *graph,
                                         saved, bn, be, slope)
        grads_k = k4_bwd()
        out2, x2, _ = k4_fwd()
        grads_k2 = k4_bwd()
    torch.cuda.synchronize()
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (h, Wl, bl, *par, bias)]
    lh, lWl, lbl, lWe, les, lai, laj, lbias = leaves
    k4_plain = lambda: gc.fused_gat_conv_plain(
        lh, lWl, lbl, ein, lWe, les, lai, laj, lbias, *graph, H, bn, be,
        slope, return_residuals=True)
    out_p, x_p = k4_plain()
    grads_p = torch.autograd.grad(out_p, leaves, g, retain_graph=True)
    names = ("dh", "dWl", "dbl", "dWe", "de_self", "da_i", "da_j", "dbias")
    check("K4",
          {"out": rel_err(out, out_p.detach()), "x": rel_err(x, x_p.detach())},
          {n: rel_err(a, b) for n, a, b in zip(names, grads_k, grads_p)},
          [saved[0][pad]],
          all(torch.equal(a, b) for a, b in
              zip((out, x, *grads_k), (out2, x2, *grads_k2))))
    k4_err = (max(float((a - b.detach()).abs().max())
                  for a, b in ((out, out_p), (x, x_p))),
              max(float((a - b).abs().max())
                  for a, b in zip(grads_k, grads_p)))

    # K5: the attention alone, on x and e as the unfused conv forms them
    with torch.no_grad():
        x5 = x_p.detach().reshape(N, H, D)
        e5 = (ein @ par[0]).reshape(E, H, D)
        k5_fwd = lambda: at.gat_attn_fwd(x5, e5, *par[1:], *graph, slope, bn,
                                         be)
        out5, saved5 = k5_fwd()
        k5_bwd = lambda: at.gat_attn_bwd(g3, x5, e5, *par[1:], *graph, saved5,
                                         slope, bn, be)
        grads5 = k5_bwd()
        out5_2, grads5_2 = k5_fwd()[0], k5_bwd()
    torch.cuda.synchronize()
    leaves5 = [t.detach().clone().requires_grad_(True)
               for t in (x5, e5, *par[1:])]
    k5_plain = lambda: at.blocked_gat_attention_plain(*leaves5, *graph, slope)
    out5_p = k5_plain()
    grads5_p = torch.autograd.grad(out5_p, leaves5, g3, retain_graph=True)
    names5 = ("dx", "de", "de_self", "da_i", "da_j")
    check("K5", {"out": rel_err(out5, out5_p.detach())},
          {n: rel_err(a, b) for n, a, b in zip(names5, grads5, grads5_p)},
          [saved5[0][pad], grads5[1][pad]],
          all(torch.equal(a, b) for a, b in
              zip((out5, *grads5), (out5_2, *grads5_2))))
    k5_err = (float((out5 - out5_p.detach()).abs().max()),
              max(float((a - b).abs().max())
                  for a, b in zip(grads5, grads5_p)))
    if not all(v > 0 for m in (gc, at) for v in m.launches.values()):
        raise AssertionError(f"a GAT launch counter did not move: "
                             f"{gc.launches} {at.launches}")

    # timings (device ms per call, see time_ms): (kernel, plain version)
    plain_bwd4 = time_ms(lambda: torch.autograd.grad(
        out_p, leaves, g, retain_graph=True), torch)
    plain_bwd5 = time_ms(lambda: torch.autograd.grad(
        out5_p, leaves5, g3, retain_graph=True), torch)
    with torch.no_grad():
        ms = {
            "gat_conv_fwd": (time_ms(k4_fwd, torch), time_ms(k4_plain, torch)),
            "gat_conv_bwd": (time_ms(k4_bwd, torch), plain_bwd4),
            "blocked_gat_attention_fwd": (time_ms(k5_fwd, torch),
                                          time_ms(k5_plain, torch)),
            "blocked_gat_attention_bwd": (time_ms(k5_bwd, torch), plain_bwd5),
        }
        dx = x.clone()
        matmul = {"gat_conv_fwd": time_ms(lambda: torch.matmul(h, Wl), torch),
                  "gat_conv_bwd": time_ms(lambda: (
                      torch.matmul(h.t(), dx), torch.matmul(dx, Wl.t())),
                      torch)}

    # The bounds count what the function needs on this batch, never what
    # the kernels recompute or choose to save: V valid rows (a padded row
    # of x is the constant bl, one more row through the projection; with a
    # zero cotangent it adds nothing to the backward's products), Ev valid
    # edges with their index, weight and input entries, the parameters, and
    # every output written once. The saved x is an output of K4's forward
    # and an input of its backward, as in the TPU kernel; the saved softmax
    # scalars are this port's choice and count nowhere. K4's edge term is
    # counted the cheaper of two ways on this batch: per edge and feature
    # (e = ein @ We once in each direction, 2K operations, and dWe = ein^T
    # de) or reassociated per row (A_r = sum alpha_e ein_e, 2K operations
    # an edge and head, then A_r @ We, 2K a row and feature; backward
    # q_r = We g_r and ein_e . q_r for dalpha, A_r^T g_r and S a_j^T for
    # dWe), which is less wherever valid rows are fewer than valid edges.
    # The edge logit is ein . (We a_j) and da_j's e term (sum_e dz_e ein_e)
    # @ We either way: 2K operations an edge and head each.
    V, Ev = int(nm.sum()), int(batch.edge_mask.sum())
    f4 = 4  # bytes
    small = nbytes(*par, bias, bl)
    edge_b4 = Ev * (K + 3) * f4
    node_ops, edge_ops = V * HD, Ev * HD
    edge_scalar_ops = Ev * H * 2 * K + 2 * K * HD
    e_fwd = {"per edge": edge_ops * (2 * K + 3),  # e once, alpha (x_j + e)
             "per row": edge_ops * 2 + Ev * H * 2 * K + node_ops * (2 * K + 1)}
    e_bwd = {"per edge": edge_ops * (2 * K + 3)   # e once, dalpha
             + edge_ops * 2 * K,                  # dWe = ein^T de
             "per row": edge_ops * 2 + node_ops * 2 * K + Ev * H * 2 * K
             + node_ops * 2 * K + Ev * H * 4 * K + 2 * K * HD}

    def k4_bounds(e_f, e_b):
        fwd = bound(
            2 * (V + 1) * D * HD      # x = h @ Wl + bl
            + node_ops * 7            # ps, pd, the self message
            + edge_scalar_ops         # pe = ein . (We a_j)
            + e_f                     # the edge term, alpha (x_j + e) summed
            + N * D * 2,              # head mean, + bias
            rows_nbytes(h, V) + nbytes(Wl) + small + edge_b4
            + nbytes(out, x))
        bwd = bound(
            2 * 2 * V * D * HD        # dWl = h^T dx, dh = dx Wl^T
            + e_b                     # dalpha = <g, x_j + e>, dWe
            + node_ops * 3            # the self loop's dalpha
            + edge_ops * 2            # de = alpha g, scattered into dx
            + node_ops * 12           # dx's other terms, de_self, da_i, da_j
            + edge_scalar_ops         # da_j's e term
            + N * D + node_ops,       # dbias, the 1/H
            rows_nbytes(g, V) + rows_nbytes(h, V) + rows_nbytes(x, V)
            + nbytes(Wl) + small + edge_b4 + nbytes(*grads_k))
        return fwd, bwd

    k4_fwd_b, k4_bwd_b = k4_bounds(min(e_fwd.values()), min(e_bwd.values()))
    edge_b5 = Ev * 3 * f4 + Ev * HD * f4
    k5_fwd_b = bound(
        node_ops * 7 + edge_ops * 5,
        V * HD * f4 + edge_b5 + nbytes(*par[1:]) + nbytes(out5))
    k5_bwd_b = bound(
        edge_ops * 3 + node_ops * 3 + edge_ops * 2 + node_ops * 12
        + edge_ops * 2,           # da_j's e term: e is an input here
        2 * V * HD * f4 + edge_b5 + nbytes(*par[1:]) + nbytes(*grads5))
    bounds = {"gat_conv_fwd": k4_fwd_b, "gat_conv_bwd": k4_bwd_b,
              "blocked_gat_attention_fwd": k5_fwd_b,
              "blocked_gat_attention_bwd": k5_bwd_b}
    errs = {"gat_conv_fwd": k4_err[0], "gat_conv_bwd": k4_err[1],
            "blocked_gat_attention_fwd": k5_err[0],
            "blocked_gat_attention_bwd": k5_err[1]}
    print(f"[kernels] GAT at the {tag}: N={N} E={E} H={H} D={D} K={K} "
          f"valid_nodes={V} valid_edges={Ev}", flush=True)
    results = {}
    for name, (kern_ms, plain_ms) in ms.items():
        b_ms, by = bounds[name]
        results[name] = dict(ms=kern_ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=by, max_abs_err=errs[name])
        extra = ""
        if name in matmul:
            results[name]["matmul_ms"] = matmul[name]
            extra = f", torch.matmul products {matmul[name]:.4f} ms"
        print(f"[kernels] {name} {tag}: kernel {kern_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms{extra}, library none (no single call), "
              f"bound {b_ms:.4f} ms ({by})", flush=True)
    return results


def gat_entries(chem, bio, chem_shape):
    """The ``kernels`` entries of K4 and K5: one per direction, with the
    times at the chem GAT paths' first batch (``chem_shape`` names it)
    under the contract's keys and the bio batch beside them."""
    src = "pretrain_gnns_tpu_torch/csrc/gat.cu"
    where = {
        "gat_conv_fwd": ("pallas_gat_conv.py", 101, "_fwd_kernel via "
                         "_call_fwd (fused_gat_conv)"),
        "gat_conv_bwd": ("pallas_gat_conv.py", 149, "_bwd_kernel via "
                         "_call_bwd (fused_gat_conv)"),
        "blocked_gat_attention_fwd": ("pallas_attention.py", 136,
                                      "_fwd_kernel via blocked_gat_forward"),
        "blocked_gat_attention_bwd": ("pallas_attention.py", 258,
                                      "_bwd_kernel via blocked_gat_backward"),
    }
    entries = []
    for name, (file, line, body) in where.items():
        entries.append(dict(
            name=name, route="cuda", source=src,
            replaces=f"pretrain_gnns_tpu/ops/{file}:{line}",
            tpu_counterpart=f"ops/{file}::{body}", **chem[name],
            library_ms=None,
            library="none: no single PyTorch call computes it",
            shape=chem_shape,
            other_shapes={"bio GAT masking first batch": bio[name]}))
    return entries


def probe_phase(torch):
    """P: launched exactly once so far (by the first library load), held
    against ``2 * x`` exactly at its own shape, and timed."""
    from pretrain_gnns_tpu_torch.ops import _build

    if _build.launches["probe_scale2"] != 1 or _build.probe() is not True:
        raise AssertionError("the probe was not launched exactly once by "
                             f"the first kernel load: {_build.launches}")
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(*_build.PROBE_SHAPE, generator=gen).to("cuda")
    out, want = _build.probe_scale2(x), _build.probe_scale2_plain(x)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError("the probe kernel disagrees with 2 * x")
    ms = time_ms(lambda: _build.probe_scale2(x), torch)
    plain_ms = time_ms(lambda: _build.probe_scale2_plain(x), torch)
    lib_ms = time_ms(lambda: torch.mul(x, 2.0), torch)
    b_ms, by = bound(x.numel(), 2 * nbytes(x))
    print(f"[kernels] P probe_scale2 at {tuple(x.shape)}: equal to 2 * x; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.mul "
          f"{lib_ms:.4f} ms, bound {b_ms:.2e} ms ({by}): launch latency",
          flush=True)
    return [dict(
        name="probe_scale2", route="cuda",
        source="pretrain_gnns_tpu_torch/csrc/probe.cu",
        replaces="pretrain_gnns_tpu/ops/pallas_spmm.py:76",
        tpu_counterpart="ops/pallas_spmm.py::_nopad_ok (the lowering probe)",
        max_abs_err=float((out - want).abs().max()), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=by, library_ms=lib_ms, library="torch.mul",
        shape="[8, 300] float32, the TPU probe's")]


SPMM_EE_LIBRARY = {
    ("fwd", False): "torch.sparse.mm, CSR of A (A[rcv, snd] = w), on x",
    ("bwd", False): "torch.sparse.mm, CSR of A^T, on g: dx",
    ("fwd", True): "torch.sparse.mm, CSR of [A | A_ee] (A_ee[rcv_e, e] = "
                   "w_e), on [x; ee] stacked outside the timed call",
    ("bwd", True): "torch.sparse.mm, CSR of [A | A_ee]^T, on g: dx over "
                   "every slot's dmsg row",
}


def spmm_ee_csr(torch, senders, receivers, w, valid, n_nodes, with_ee):
    """K6 as one sparse matrix, the library's yardstick: ``A`` with
    ``A[rcv_e, snd_e] = w_e`` over the valid slots and, ``with_ee``, beside
    it ``A_ee`` with ``A_ee[rcv_e, e] = w_e``, ``[N, N + E]``. So ``A @ x``
    (``A @ [x; ee]``) is K6's forward and ``A^T @ g`` its ``dx`` (stacked
    on ``dmsg``, a row for every slot, 0 where the slot adds nothing).
    Returns ``(A, A^T)`` in CSR."""
    slots = torch.nonzero(valid).flatten()
    rcv, snd = receivers[slots].long(), senders[slots].long()
    rows, cols = [rcv], [snd]
    if with_ee:
        rows.append(rcv)
        cols.append(slots + n_nodes)
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    vals = w[slots].repeat(len(rows))
    shape = (n_nodes, n_nodes + senders.shape[0] * with_ee)

    def csr(i, size):
        return (torch.sparse_coo_tensor(i, vals, size).coalesce()
                .to_sparse_csr())
    return csr(idx, shape), csr(idx.flip(0), shape[::-1])


def spmm_ee_phase(torch, batch, tag):
    """K6 and K7 against their plain versions on a path's first batch,
    with a random edge embedding and fractional, partly negative edge
    weights. Returns ``{kernel name: dict}`` with the measured times,
    errors and bounds; ``sorted_blocked_spmm_fwd`` also carries the time
    with the sort inside."""
    from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs
    from pretrain_gnns_tpu_torch.ops import sorted_spmm as ss

    dev = batch.node_mask.device
    gen = torch.Generator().manual_seed(6)
    N, E, F = batch.max_nodes, batch.max_edges, EMB
    bn, be = batch.block_nodes, batch.block_edges
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    x = rnd(N, F) * batch.node_mask[:, None]
    ee, g = rnd(E, F), rnd(N, F)
    valid = batch.edge_mask
    w = valid.to(torch.float32) * (torch.rand(E, generator=gen) * 2
                                   - 0.5).to(dev)
    snd, rcv = batch.senders, batch.receivers
    edges = (snd, rcv, w, bn, be)
    e_valid = int(valid.sum())
    n_snd = int(torch.unique(snd[valid]).numel())
    n_rcv = int(torch.unique(rcv[valid]).numel())
    pad_rows, pad_slots = ~batch.node_mask, ~valid

    # the library's yardstick: one torch.sparse.mm each way, [x+ee] on the
    # stacked [x; ee], which is built outside the timed call
    xe = torch.cat([x, ee])
    library = {}
    for has_ee in (True, False):
        A, At = spmm_ee_csr(torch, snd, rcv, w, valid, N, has_ee)
        rhs = xe if has_ee else x
        library[has_ee] = dict(
            fwd_ms=time_ms(lambda: torch.sparse.mm(A, rhs), torch),
            bwd_ms=time_ms(lambda: torch.sparse.mm(At, g), torch),
            out=torch.sparse.mm(A, rhs), back=torch.sparse.mm(At, g))

    results = {}
    for has_ee in (True, False):
        v = bs.ee_variant(has_ee)
        e_in = ee if has_ee else None
        lib = library[has_ee]
        fwd = lambda: bs.spmm_ee_fwd(x, e_in, *edges)
        bwd = lambda: bs.spmm_ee_bwd(g, *edges, has_ee, True, has_ee)
        with torch.no_grad():
            out, (dx, dmsg) = fwd(), bwd()
            out2, (dx2, dmsg2) = fwd(), bwd()
            dx_alone = bs.spmm_ee_bwd(g, *edges, has_ee, True, False)[0]
            dmsg_alone = (bs.spmm_ee_bwd(g, *edges, has_ee, False, True)[1]
                          if has_ee else None)
        torch.cuda.synchronize()
        xl = x.detach().clone().requires_grad_(True)
        el = ee.detach().clone().requires_grad_(True)
        out_p = bs.blocked_spmm_plain(xl, el if has_ee else None, *edges)
        leaves = [xl, el] if has_ee else [xl]
        grads_p = torch.autograd.grad(out_p, leaves, g, retain_graph=True)
        grads_k = [dx, dmsg] if has_ee else [dx]
        errs = {"out": rel_err(out, out_p.detach()),
                **{n: rel_err(a, b) for n, a, b in
                   zip(("dx", "dee"), grads_k, grads_p)}}
        zeros = [out[pad_rows], dx[pad_rows]] + (
            [dmsg[pad_slots]] if has_ee else [])
        same = (torch.equal(out, out2) and torch.equal(dx, dx2)
                and torch.equal(dx, dx_alone)
                and (not has_ee or (torch.equal(dmsg, dmsg2)
                                    and torch.equal(dmsg, dmsg_alone))))
        # the yardstick computes the same function: out, then dx over dmsg
        lib_errs = [rel_err(lib["out"], out),
                    rel_err(lib["back"], torch.cat(grads_k))]
        print(f"[kernels] K6[{v}] {tag}: rel err {errs}; padded rows and "
              f"slots max {max(float(z.abs().max()) for z in zeros):.1e}; "
              f"equal bits in two runs: {same}; torch.sparse.mm against "
              f"the kernel (out, back) {[f'{e:.1e}' for e in lib_errs]}",
              flush=True)
        if (not all(e <= FWD_TOL for e in [*errs.values(), *lib_errs])
                or any(z.any() for z in zeros) or not same):
            raise AssertionError(f"K6[{v}] {tag} disagrees with its plain "
                                 "version or its yardstick")
        plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
            out_p, leaves, g, retain_graph=True), torch)
        with torch.no_grad():
            fwd_ms, bwd_ms = time_ms(fwd, torch), time_ms(bwd, torch)
            plain_fwd_ms = time_ms(
                lambda: bs.blocked_spmm_plain(x, e_in, *edges), torch)
        # The bound counts what the function needs on this batch: each x
        # (or g) row a valid edge reads once, the valid edges' index,
        # weight and ee entries, and every output once at full size
        # (dmsg has a row for every slot).
        row = F * 4
        fwd_b = bound(e_valid * F * (2 + has_ee),
                      n_snd * row + e_valid * (12 + row * has_ee)
                      + nbytes(out))
        bwd_b = bound(e_valid * F * 2,
                      n_rcv * row + e_valid * 12 + nbytes(*grads_k))
        for d, ms, pms, (b_ms, by), err in (
                ("fwd", fwd_ms, plain_fwd_ms, fwd_b,
                 float((out - out_p.detach()).abs().max())),
                ("bwd", bwd_ms, plain_bwd_ms, bwd_b,
                 max(float((a - b).abs().max())
                     for a, b in zip(grads_k, grads_p)))):
            results[f"blocked_spmm_ee_{d}[{v}]"] = dict(
                ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=by,
                library_ms=lib[f"{d}_ms"], library=SPMM_EE_LIBRARY[d, has_ee],
                max_abs_err=err)
        if has_ee:
            k6_out, k6_fwd_b = out, fwd_b

    # K7 on the per-block sorted edges, against its plain version and
    # against K6 on the unsorted ones
    n_blocks = N // bn
    sort = lambda: ss.sort_block_edges(snd, rcv, w, ee, n_blocks, be)
    s2, r2, w2, ee2 = sort()
    k7 = lambda: ss.sorted_blocked_spmm(x, ee2, s2, r2, w2, bn, be)

    def k7_with_sort():
        a, b, c, d = sort()
        return ss.sorted_blocked_spmm(x, d, a, b, c, bn, be)

    with torch.no_grad():
        out7, out7_2, out7_s = k7(), k7(), k7_with_sort()
        want7 = ss.sorted_blocked_spmm_plain(x, ee2, s2, r2, w2, bn, be)
    torch.cuda.synchronize()
    errs = {"plain": rel_err(out7, want7), "K6": rel_err(out7, k6_out)}
    same = torch.equal(out7, out7_2) and torch.equal(out7, out7_s)
    print(f"[kernels] K7 {tag}: rel err vs {errs}; padded rows max "
          f"{float(out7[pad_rows].abs().max()):.1e}; equal bits in two "
          f"runs: {same}", flush=True)
    if (not all(e <= FWD_TOL for e in errs.values())
            or out7[pad_rows].any() or not same):
        raise AssertionError(f"K7 {tag} disagrees with its plain version "
                             "or with K6")
    with torch.no_grad():
        results["sorted_blocked_spmm_fwd"] = dict(
            ms=time_ms(k7, torch), with_sort_ms=time_ms(k7_with_sort, torch),
            plain_ms=time_ms(lambda: ss.sorted_blocked_spmm_plain(
                x, ee2, s2, r2, w2, bn, be), torch),
            bound_ms=k6_fwd_b[0], bound_by=k6_fwd_b[1],
            library_ms=library[True]["fwd_ms"],
            library=SPMM_EE_LIBRARY["fwd", True],
            max_abs_err=float((out7 - want7).abs().max()))
    print(f"[kernels] K6 and K7 at the {tag}: N={N} F={F} E={E} valid_edges="
          f"{e_valid} senders={n_snd} receivers={n_rcv}; K7 "
          f"{results['sorted_blocked_spmm_fwd']['ms']:.4f} ms against K6 "
          f"[x+ee] {results['blocked_spmm_ee_fwd[x+ee]']['ms']:.4f} ms",
          flush=True)
    for name, r in results.items():
        extra = (f" ({r['with_sort_ms']:.4f} ms with sort_block_edges)"
                 if "with_sort_ms" in r else "")
        print(f"[kernels] {name} {tag}: kernel {r['ms']:.4f} ms{extra}, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
              f"ms ({r['library'].split(',')[0]}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return results


def spmm_ee_entries(chem, bio):
    """The ``kernels`` entries of K6 and K7, with the times at the chem
    masking first batch under the contract's keys and the bio batch
    beside them."""
    where = {"fwd": (195, "_fwd_kernel via _call_fwd (blocked_spmm)"),
             "bwd": (217, "_bwd_kernel via _call_bwd (blocked_spmm)")}
    entries = []
    for name in chem:
        if name == "sorted_blocked_spmm_fwd":
            replaces = "pretrain_gnns_tpu/ops/pallas_spmm_sorted.py:160"
            body = ("ops/pallas_spmm_sorted.py::_sorted_fwd_kernel via "
                    "sorted_blocked_spmm")
        else:
            line, fn = where[name.split("_")[3][:3]]
            replaces = f"pretrain_gnns_tpu/ops/pallas_spmm.py:{line}"
            body = f"ops/pallas_spmm.py::{fn}"
        entries.append(dict(
            name=name, route="cuda",
            source="pretrain_gnns_tpu_torch/csrc/spmm_ee.cu",
            replaces=replaces, tpu_counterpart=body, **chem[name],
            shape="chem masking first batch, random edge embedding and "
                  "fractional edge weights",
            other_shapes={"bio masking first batch": bio[name]}))
    return entries


def edge_emb_path_phase(torch, batch):
    """K6's path: the op-level API. ``gather_scatter`` with a precomputed
    edge embedding in its add and concat forms, and ``blocked_spmm``
    without one, forward and backward on the card at the kernels' knob;
    every launch count is set to 0 just before and read just after, and
    each result is held against the plain path (at float32), or under
    the bfloat16 knob against the kernels' plain versions at bfloat16
    (BF16_KERNEL_TOL, BF16_KERNEL_MEAN_TOL)."""
    from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs
    from pretrain_gnns_tpu_torch.ops import spmm

    dev = batch.node_mask.device
    gen = torch.Generator().manual_seed(7)
    N, E, F = batch.max_nodes, batch.max_edges, EMB
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    x0 = rnd(N, F) * batch.node_mask[:, None]
    ee0 = rnd(E, F)
    ew = torch.rand(E, generator=gen).to(dev) + 0.5
    graph = (batch.senders, batch.receivers, batch.edge_mask, N)
    layout = dict(block_nodes=batch.block_nodes,
                  block_edges=batch.block_edges)

    def run(fn):
        x = x0.clone().requires_grad_(True)
        ee = ee0.clone().requires_grad_(True)
        out = fn(x, ee)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            8)).to(dev)
        out.backward(g)
        return [out.detach(), x.grad] + ([] if ee.grad is None
                                         else [ee.grad])

    w = batch.edge_mask.to(torch.float32) * ew
    cdt = spmm.kernel_dtype(x0)
    bf = cdt == torch.bfloat16
    # (on the card through the entry point, the plain path)
    forms = {
        "add": (
            lambda x, ee: spmm.gather_scatter(
                x, *graph, edge_emb=ee, combine="add", edge_weight=ew,
                **layout),
            lambda x, ee: spmm.gather_scatter_plain(
                x, *graph, edge_emb=ee, combine="add", edge_weight=ew)),
        "concat": (
            lambda x, ee: spmm.gather_scatter(
                x, *graph, edge_emb=ee, combine="concat", edge_weight=ew,
                **layout),
            lambda x, ee: spmm.gather_scatter_plain(
                x, *graph, edge_emb=ee, combine="concat", edge_weight=ew)),
        "no edge embedding": (
            lambda x, ee: bs.blocked_spmm(x, None, *graph[:2], w, **layout,
                                          compute_dtype=cdt),
            lambda x, ee: bs.blocked_spmm_plain(x, None, *graph[:2], w)),
    }
    if bf:  # the kernels' plain versions at bfloat16, the same dispatch
        k6_plain = lambda x, ee: bs.blocked_spmm_plain(
            x, ee, *graph[:2], w, compute_dtype=cdt)
        forms["add"] = forms["add"][0], k6_plain
        forms["concat"] = forms["concat"][0], lambda x, ee: torch.cat([
            bs.blocked_spmm_fused_plain(x, None, None, *graph[:2], w,
                                        has_x=True, has_ein=False,
                                        compute_dtype=cdt),
            k6_plain(x.new_zeros((N, F)), ee)], dim=-1)
        forms["no edge embedding"] = (forms["no edge embedding"][0],
                                      lambda x, ee: k6_plain(x, None))
    one = lambda *names: {n: 1 for n in names}
    want = {
        "add": one("blocked_spmm_ee_fwd[x+ee]", "blocked_spmm_ee_bwd[x+ee]"),
        "concat": one("blocked_spmm_fwd[x]", "blocked_spmm_bwd[x]",
                      "blocked_spmm_ee_fwd[x+ee]",
                      "blocked_spmm_ee_bwd[x+ee]"),
        "no edge embedding": one("blocked_spmm_ee_fwd[x]",
                                 "blocked_spmm_ee_bwd[x]"),
    }
    modules = counted_modules()
    total = {}
    for name, (on_card, plain) in forms.items():
        for m in modules:
            m.reset_launches()
        got = run(on_card)
        torch.cuda.synchronize()
        counts = read_counts(modules)
        moved = {k: v for k, v in counts.items() if v}
        ref = run(plain)
        if bf:  # (max, mean) readings, each within its limit
            errs = [bf16_readings(a, b) for a, b in zip(got, ref)]
            ok = all(m <= BF16_KERNEL_TOL and mean <= BF16_KERNEL_MEAN_TOL
                     for m, mean in errs)
        else:
            errs = [rel_err(a, b) for a, b in zip(got, ref)]
            ok = all(e <= FWD_TOL for e in errs)
        print(f"[edge_emb path{' bfloat16' * bf}] {name}: out "
              f"{tuple(got[0].shape)}, launches {moved}; rel err vs the "
              f"plain path (out, dx, dee) {errs}", flush=True)
        if (moved != want[name] or len(got) != len(ref) or not ok
                or not all(bool(torch.isfinite(t).all()) for t in got)):
            raise AssertionError(f"edge_emb path {name}: launches {moved} "
                                 f"(want {want[name]}), errors {errs}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total, 0


def micro_phase(torch, micro_main, dtype="float32"):
    """K7's path: the kernel micro-benchmark at a reduced number of
    trials, its kernels at compute dtype ``dtype``; every launch count is
    set to 0 just before and read just after."""
    modules = counted_modules()
    for m in modules:
        m.reset_launches()
    rows = micro_main(["--trials", "5", "--dtype", dtype])
    counts = read_counts(modules)
    moved = {k: v for k, v in counts.items() if v}
    print(f"[kernel micro] launches {moved}", flush=True)
    must = {"sorted_blocked_spmm_fwd", "blocked_spmm_ee_fwd[x+ee]",
            "blocked_spmm_fwd[x+ein]", "blocked_spmm_bwd[x+ein]",
            "blocked_gat_attention_fwd", "blocked_gat_attention_bwd"}
    if (set(moved) != must or len(rows) != 6
            or not all(math.isfinite(r["us"]) and r["us"] > 0
                       for r in rows)):
        raise AssertionError(f"kernel micro-benchmark: launches {moved}, "
                             f"rows {rows}")
    return counts, 0


def same_batch(a, b) -> bool:
    """Every array field and extra of two host batches equal in value."""
    import numpy as np

    fields = ("node_feat", "edge_feat", "senders", "receivers", "node_graph",
              "node_mask", "edge_mask", "graph_mask", "y")
    return ((a.block_nodes, a.block_edges) == (b.block_nodes, b.block_edges)
            and all((getattr(a, f) is None) == (getattr(b, f) is None)
                    for f in fields)
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in fields if getattr(a, f) is not None)
            and sorted(a.extras) == sorted(b.extras)
            and all(np.array_equal(a.extras[k], b.extras[k])
                    for k in a.extras))


def loader_phase(graphs, cfg, dev):
    """The first epoch of ``build_loader`` against ``PackedLoader`` with
    the same transform, seed and layout, batch for batch; the host's ms a
    batch of each (pack and transform, one thread) and of planning the
    epoch in C++ and in Python."""
    import numpy as np

    from pretrain_gnns_tpu_torch import native
    from pretrain_gnns_tpu_torch.data.flat import plan_epoch_plain
    from pretrain_gnns_tpu_torch.data.packing import PackedLoader
    from pretrain_gnns_tpu_torch.train import pretrain

    tag = f"[{path_name(cfg)} loader]"
    flat = pretrain.build_loader(cfg, graphs, dev)
    if type(flat).__name__ != "FlatLoader":
        raise AssertionError(f"{tag} build_loader gave {type(flat).__name__}")
    packed = PackedLoader(graphs, cfg.batch_size, flat.max_nodes,
                          flat.max_edges, seed=flat.seed,
                          extra_pad=flat.extra_pad, blocks=flat.blocks,
                          drop_last=flat.drop_last,
                          post_transform=flat.post_transform)
    t = time.perf_counter()
    first = list(flat)
    flat_ms = (time.perf_counter() - t) * 1e3 / len(first)
    t = time.perf_counter()
    batches = list(packed)
    packed_ms = (time.perf_counter() - t) * 1e3 / len(batches)
    if len(first) != len(batches) or not all(
            same_batch(a, b) for a, b in zip(first, batches)):
        raise AssertionError(f"{tag} FlatLoader's first epoch differs from "
                             "PackedLoader's")
    order = np.random.default_rng((0, 0)).permutation(len(graphs))
    lens = (flat.flat.lens_n, flat.flat.lens_e, order, cfg.batch_size)
    layout = flat.blocks or (1, flat.max_nodes, flat.max_edges)
    t = time.perf_counter()
    native.plan_epoch(*lens, *layout)
    plan_c = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    plan_epoch_plain(*lens, layout)
    plan_py = (time.perf_counter() - t) * 1e3
    print(f"{tag} FlatLoader: {len(first)} batches equal PackedLoader's "
          f"(node_feat {first[0].node_feat.dtype} against "
          f"{batches[0].node_feat.dtype}); host ms a batch, pack and "
          f"transform: flat {flat_ms:.3f}, packed {packed_ms:.3f}; "
          f"planning the epoch: plan_epoch {plan_c:.3f} ms, the Python walk "
          f"{plan_py:.3f} ms ({plan_c / len(first):.4f} / "
          f"{plan_py / len(first):.4f} ms a batch) "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)



# --- mixed precision: the bfloat16 variants of K1, K2 and K3 ----------------


@contextlib.contextmanager
def precision(model, kernels):
    """Both precision knobs for the block (``models.inits`` at ``model``,
    ``ops.spmm`` at ``kernels``), what they were again after it."""
    from pretrain_gnns_tpu_torch.models import inits
    from pretrain_gnns_tpu_torch.ops import spmm

    was = inits.get_compute_dtype(), spmm.get_compute_dtype()
    inits.set_compute_dtype(model)
    spmm.set_compute_dtype(kernels)
    try:
        yield
    finally:
        inits.set_compute_dtype(was[0])
        spmm.set_compute_dtype(was[1])


@contextlib.contextmanager
def plain_as_on_card(torch):
    """On the CPU, ``ops.spmm``'s dispatch as on the card: the blocked sums
    and pair scores through the kernels' wrappers (which run their plain
    versions on CPU tensors) at the kernels' knob, the GAT attention
    through K5's wrapper, and the fused GIN and GAT convs at it too. The
    CPU's own dispatch ignores the knob (the JAX package's XLA fallback);
    this is the reference a bfloat16 step on the card is held against."""
    from pretrain_gnns_tpu_torch.ops import attention
    from pretrain_gnns_tpu_torch.ops import edge_dot as ed
    from pretrain_gnns_tpu_torch.ops import spmm

    saved = (spmm.kernel_dtype, spmm.gather_scatter, spmm.edge_dot,
             attention.gat_attention)
    cdt = {"float32": torch.float32,
           "bfloat16": torch.bfloat16}[spmm.get_compute_dtype()]

    def gather_scatter(x, senders, receivers, edge_mask, num_nodes,
                       edge_in=None, edge_kernel=None, combine="add",
                       edge_weight=None, block_nodes=0, block_edges=0,
                       edge_emb=None, aggr="sum"):
        if aggr != "sum":
            return saved[1](x, senders, receivers, edge_mask, num_nodes,
                            edge_in, edge_kernel, combine, edge_weight,
                            block_nodes, block_edges, edge_emb, aggr)
        return spmm.blocked_gather_scatter(
            x, senders, receivers, edge_mask, edge_in, edge_kernel, combine,
            edge_weight, block_nodes, block_edges, edge_emb, cdt)

    def edge_dot(x, a_idx, b_idx, mask, block_nodes=0, pairs_per_block=0):
        return ed.blocked_edge_dot(x, a_idx, b_idx, mask.to(torch.float32),
                                   block_nodes, pairs_per_block, cdt)

    def gat_attention(x, e, e_self, a_i, a_j, senders, receivers, edge_mask,
                      num_nodes, slope=0.2, block_nodes=0, block_edges=0,
                      compute_dtype=torch.float32):
        H, D = x.shape[1:]
        return attention.blocked_gat_attention(
            x, e, e_self, a_i.reshape(H, D), a_j.reshape(H, D), senders,
            receivers, edge_mask.to(torch.float32), slope, block_nodes,
            block_edges, compute_dtype)

    spmm.kernel_dtype = lambda x: cdt
    spmm.gather_scatter, spmm.edge_dot = gather_scatter, edge_dot
    attention.gat_attention = gat_attention
    try:
        yield
    finally:
        (spmm.kernel_dtype, spmm.gather_scatter, spmm.edge_dot,
         attention.gat_attention) = saved


def bf16_agreement(torch, batch, cfg, fused="on"):
    """One train-mode step of ``cfg``'s objective under the bfloat16
    knobs: on the card (the bfloat16 kernels) and on the CPU (their plain
    versions at compute_dtype=bfloat16, ``plain_as_on_card``), from the
    same weights: loss, every gradient and the batch-norm statistics,
    within the limits that BF16_NOISE_SAMPLES noisy CPU steps set (see
    BF16_REFEREE_K), which the control (the card's step with the kernels'
    knob at float32) must break."""
    from pretrain_gnns_tpu_torch.ops import spmm
    from pretrain_gnns_tpu_torch.train.pretrain import build_objective

    name = path_name(cfg, fused) + " bfloat16"

    def step(dev, kernels="bfloat16", noise_seed=None):
        model = build_objective(cfg)
        if noise_seed is not None:
            gen = torch.Generator().manual_seed(noise_seed)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + NOISE_EPS * torch.randn(p.shape,
                                                       generator=gen))
        model = model.to(dev)
        ctx = plain_as_on_card(torch) if dev == "cpu" else \
            contextlib.nullcontext()
        spmm.set_compute_dtype(kernels)
        try:
            with fused_as(fused), ctx:
                loss, _ = model(batch.to(dev), train=True)
        finally:
            spmm.set_compute_dtype("bfloat16")
        loss.backward()
        if not (loss.dtype == torch.float32 and all(
                p.grad.dtype == torch.float32 for p in model.parameters())):
            raise AssertionError(f"[{name}] loss or gradients not float32")
        return (float(loss.detach()),
                {n: p.grad.detach().cpu()
                 for n, p in model.named_parameters()},
                {n: b.detach().cpu().float()
                 for n, b in model.named_buffers()})

    def readings(got, want):
        """(loss, largest gradient, gradients' L1 share, statistics)"""
        (lc, gc, bc), (lp, gp, bp) = got, want
        diff = sum(float((gc[n] - gp[n]).abs().sum()) for n in gp)
        return (abs(lc - lp) / max(1.0, abs(lp)),
                max(rel_err(gc[n], gp[n]) for n in gp),
                diff / sum(float(gp[n].abs().sum()) for n in gp),
                max((rel_err(bc[n], bp[n]) for n in bp), default=0.0))

    cpu = step("cpu")
    card, ctl = readings(step("cuda"), cpu), readings(
        step("cuda", kernels="float32"), cpu)
    noise = [readings(step("cpu", noise_seed=i), cpu)
             for i in range(BF16_NOISE_SAMPLES)]
    lim = [BF16_REFEREE_K * max(r[i] for r in noise) for i in (1, 2)]
    fmt = lambda r: "(" + ", ".join(f"{e:.3e}" for e in r) + ")"
    print(f"[{name} agreement] (loss, largest gradient, gradients' L1, BN "
          f"statistics) rel err from the CPU: card {fmt(card)}; limits "
          f"({BF16_STEP_LOSS_TOL:.0e}, {lim[0]:.3e}, {lim[1]:.3e}, "
          f"{BF16_STEP_STAT_TOL:.0e}); the control {fmt(ctl)}; CPU steps "
          f"from parameters scaled by 1 + {NOISE_EPS:.0e} * N(0, 1) "
          f"{' '.join(fmt(r) for r in noise)} "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)
    if not (card[0] <= BF16_STEP_LOSS_TOL and card[1] <= lim[0]
            and card[2] <= lim[1] and card[3] <= BF16_STEP_STAT_TOL
            and math.isfinite(cpu[0])):
        raise AssertionError(f"{name} step on the card disagrees with the "
                             "CPU's plain versions")
    if not (ctl[1] > lim[0] or ctl[2] > lim[1]):
        raise AssertionError(f"{name}: the float32 control passes the "
                             "gradient limits")


def bf16_readings(got, want):
    """|got - want| read twice: the largest over max(1, max |want|) and the
    mean over mean |want| (over 1 where ``want`` is all 0)."""
    d = (got.float() - want.float()).abs()
    scale = float(want.float().abs().mean())
    return (float(d.max()) / max(1.0, float(want.float().abs().max())),
            float(d.mean()) / (scale or 1.0))


def _bf16_check(torch, tag, runs, sound, control):
    """Two runs bit-equal and every sound reading (``sound`` maps an
    output to (kernel, plain at compute_dtype=bfloat16)) within
    BF16_KERNEL_TOL and BF16_KERNEL_MEAN_TOL; returns the control's
    (``control``: the same wrapper at compute_dtype=float32 on the same
    inputs) largest mean reading, which the caller holds over
    BF16_KERNEL_MEAN_TOL."""
    same = all(a is None or torch.equal(a, c) for a, c in zip(*runs))
    got = {k: bf16_readings(*v) for k, v in sound.items()}
    ctl = {k: bf16_readings(*v) for k, v in control.items()}
    fmt = lambda r: {k: (float(f"{a:.3e}"), float(f"{b:.3e}"))
                     for k, (a, b) in r.items()}
    print(f"[kernels bf16] {tag} (max, mean) rel err from the plain version "
          f"at compute_dtype=bfloat16 {fmt(got)}; the control at float32 "
          f"{fmt(ctl)}; two runs {'bit-equal' if same else 'DIFFER'}",
          flush=True)
    bad = {k: v for k, v in got.items() if not (
        v[0] <= BF16_KERNEL_TOL and v[1] <= BF16_KERNEL_MEAN_TOL)}
    if bad or not same:
        raise AssertionError(f"{tag} disagrees with its plain version or "
                             f"does not repeat: {bad}")
    return max(b for _, b in ctl.values())


def _control_shows(tag, means):
    """The gate can tell compute_dtype=float32 from bfloat16: the control
    read a mean over BF16_KERNEL_MEAN_TOL in one of its cases."""
    if not max(means) > BF16_KERNEL_MEAN_TOL:
        raise AssertionError(f"{tag}: the float32 control reads as the "
                             f"bfloat16 variant ({max(means):.3e})")


def _rows_entry(res, main, other):
    """The bfloat16-rows numbers as an entry's keys, the float32 rows'
    beside them."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    entry = {k: res[main][k] for k in keys}
    entry["rows_float32"] = {k: res[other][k] for k in keys}
    return entry


def k1_bf16_phase(torch, batch, model):
    """K1's bfloat16 variant (compute_dtype=bfloat16) on the chem masking
    path's first batch, with bfloat16 rows (the bfloat16_act path's) and
    float32 rows: against its plain version at compute_dtype=bfloat16 and
    the control at float32 (``_bf16_check``), every output equal bit for
    bit between two runs, timed beside the plain version and
    ``torch.matmul`` in bfloat16 on its products; then its products alone
    (``k1_gemm_bf16_check``)."""
    from pretrain_gnns_tpu_torch.ops import gin_conv

    bf, dev = torch.bfloat16, batch.node_mask.device
    conv = model.gnn.gnns[0]
    gen = torch.Generator().manual_seed(11)
    N = batch.max_nodes
    nm = batch.node_mask.to(torch.float32)
    x32 = torch.randn(N, EMB, generator=gen).to(dev) * nm[:, None]
    g32 = torch.randn(N, EMB, generator=gen).to(dev)
    base = conv.conv_inputs(x32, batch)
    base = base[:11] + (nm,) + base[12:]
    (_, ein, We, e_self, W1, b1, W2, b2, snd, rcv, w, _, bn, be) = base
    F, F2, K = EMB, W1.shape[1], ein.shape[1]
    V, e_valid = int(nm.sum()), int(batch.edge_mask.sum())
    names = ("out", "dx", "dWe", "de_self", "dW1", "db1", "dW2", "db2")
    res = {}
    for rows in (bf, torch.float32):
        x, g = x32.to(rows), g32.to(rows)
        args = (x,) + base[1:]
        bwd = lambda a, z, dt=bf: gin_conv.gin_conv_bwd(
            g, a, z, ein, W1, W2, snd, rcv, w, nm, bn, be, dt)

        def run(dt):
            out, aggr, z = gin_conv.gin_conv_fwd(*args, compute_dtype=dt)
            return (out, aggr, z) + bwd(aggr, z, dt)

        with torch.no_grad():
            runs = [run(bf) for _ in range(2)]
            control = run(torch.float32)
        torch.cuda.synchronize()
        out, aggr, z = runs[0][:3]
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, We, e_self, W1, b1, W2, b2)]
        out_p = gin_conv.fused_gin_conv_plain(
            leaves[0], ein, *leaves[1:], snd, rcv, w, nm, bn, be,
            compute_dtype=bf)
        grads_p = torch.autograd.grad(out_p, leaves, g, retain_graph=True)
        plain = (out_p.detach(),) + grads_p
        tag = f"K1 rows {str(rows)[6:]}"
        _control_shows(tag, [_bf16_check(
            torch, tag, runs,
            dict(zip(names, zip(runs[0][:1] + runs[0][3:], plain))),
            dict(zip(names, zip(control[:1] + control[3:], plain))))])
        max_abs = max(float((a.float() - c.detach().float()).abs().max())
                      for a, c in zip((out,) + runs[0][3:], plain))

        plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
            out_p, leaves, g, retain_graph=True), torch)
        with torch.no_grad():
            fwd_ms = time_ms(lambda: gin_conv.gin_conv_fwd(
                *args, compute_dtype=bf), torch)
            bwd_ms = time_ms(lambda: bwd(aggr, z), torch)
            plain_fwd_ms = time_ms(lambda: gin_conv.fused_gin_conv_plain(
                *args, compute_dtype=bf), torch)
            # the library: K1's products as torch.matmul in bfloat16
            W1b, W2b, gb = W1.to(bf), W2.to(bf), g.to(bf)
            dzr = z.clone()
            mm_fwd_ms = time_ms(lambda: (torch.matmul(aggr, W1b),
                                         torch.matmul(z, W2b)), torch)
            mm_bwd_ms = time_ms(lambda: (torch.matmul(gb, W2b.t()),
                                         torch.matmul(z.t(), gb),
                                         torch.matmul(aggr.t(), dzr),
                                         torch.matmul(dzr, W1b.t())), torch)
        # the bound: the float32 kernel's operations (see kernel_phase) at
        # the bfloat16 tensor peak; the bytes at the stored widths (rows
        # and the residuals aggr, z in bfloat16 or float32, parameters,
        # edge arrays and weight gradients float32)
        rs = x.element_size()
        row_ops = 2 * F * F2
        fwd_ops = (2 * (V + 1) * row_ops + e_valid * F * (2 * K + 3)
                   + 3 * V * F)
        bwd_ops = ((4 * V + 2) * row_ops + e_valid * F * (2 * K + 2)
                   + 2 * V * F + N * F + 2 * (V + 1) * F2)
        edge_bytes = sum(rows_nbytes(t, e_valid) for t in (ein, snd, rcv, w))
        fwd_b = bound(fwd_ops, V * F * rs + edge_bytes
                      + nbytes(We, e_self, W1, b1, W2, b2, nm, out, aggr, z),
                      PEAK_BF16_FLOPS)
        bwd_b = bound(bwd_ops, rows_nbytes(aggr, V) + rows_nbytes(z, V + 1)
                      + edge_bytes + nbytes(g, W1, W2, nm, *runs[0][3:]),
                      PEAK_BF16_FLOPS)
        for d, ms, pms, b, lms in (("fwd", fwd_ms, plain_fwd_ms, fwd_b,
                                    mm_fwd_ms),
                                   ("bwd", bwd_ms, plain_bwd_ms, bwd_b,
                                    mm_bwd_ms)):
            res[d, rows] = dict(max_abs_err=max_abs, ms=ms, plain_ms=pms,
                                bound_ms=b[0], bound_by=b[1], library_ms=lms)
            print(f"[kernels bf16] gin_conv_{d} rows {str(rows)[6:]}: "
                  f"kernel {ms:.4f} ms, plain {pms:.4f} ms, torch.matmul "
                  f"bf16 products {lms:.4f} ms, bound {b[0]:.4f} ms "
                  f"({b[1]})", flush=True)
        if rows == bf:
            products = (aggr, z, g32, W1, W2, b1, b2)
    gemm_ms = k1_gemm_bf16_check(torch, *products)
    src = "pretrain_gnns_tpu_torch/csrc/gin_conv.cu"
    return [dict(name=f"gin_conv_{d}[bf16]", counter=f"gin_conv_{d}",
                 route="cuda", source=src,
                 replaces=f"pretrain_gnns_tpu/ops/pallas_gin.py:{line}",
                 tpu_counterpart=(f"ops/pallas_gin.py::_{d}_kernel at "
                                  "compute_dtype=bfloat16"),
                 library="torch.matmul in bfloat16 on K1's products",
                 shape="chem masking first batch, bfloat16 rows",
                 gemm_bf16_ms=gemm_ms[d],
                 **_rows_entry({r: res[d, r] for r in (bf, torch.float32)},
                               bf, torch.float32))
            for d, line in (("fwd", 47), ("bwd", 114))]


def k1_gemm_bf16_check(torch, aggr, z, g32, W1, W2, b1, b2):
    """K1's six products at compute_dtype=bfloat16 alone through its
    tensor-core GEMM (``gin_conv.gemm_bf16``) on the chem masking first
    batch's operands (``aggr`` and ``z`` as K1 saved them, bfloat16; the
    cotangent, the weights and dzr rounded), each with the layout and the
    split K that K1 gives it, against ``torch.matmul`` on float32 copies
    (BF16_GEMM_TOL) and the control, the same reference with one operand
    left unrounded, which must break it; then the products timed with
    K1's epilogues beside ``torch.matmul`` in bfloat16. Returns the GEMM's
    ms of each direction."""
    from pretrain_gnns_tpu_torch.ops import gin_conv

    bf = torch.bfloat16
    N, F2, F = z.shape[0], z.shape[1], aggr.shape[1]
    s2 = gin_conv.wgrad_splits(F2, F, N)
    s1 = gin_conv.wgrad_splits(F, F2, N)
    readings = {}
    with torch.no_grad():
        g = g32.to(bf)
        W1b, W2b = W1.to(bf), W2.to(bf)  # the strides of linear.weight.t()
        dzr32 = torch.where(z > 0, g.float() @ W2b.float().t(), 0.0)
        dzr = dzr32.to(bf)
        # (name, a, b, splits, the unrounded operand: 0 a, 1 b, and it)
        cases = (("z = aggr W1", aggr, W1b, 1, 1, W1),
                 ("out = z W2", z, W2b, 1, 1, W2),
                 ("dzr = g W2^T", g, W2b.t(), 1, 0, g32),
                 ("dW2 = z^T g", z.t(), g, s2, 1, g32),
                 ("dW1 = aggr^T dzr", aggr.t(), dzr, s1, 1, dzr32),
                 ("da = dzr W1^T", dzr, W1b.t(), 1, 1, W1.t()))
        for name, a, b, s, which, raw in cases:
            got = gin_conv.gemm_bf16(a, b, splits=s)
            ctl = (raw @ b.float()) if which == 0 else (a.float() @ raw)
            readings[name] = (rel_err(got, a.float() @ b.float()),
                              rel_err(got, ctl))
        torch.cuda.synchronize()
        # K1's settings: the ordered roundings for dzr's product alone
        fwd_ms = time_ms(lambda: (
            gin_conv.gemm_bf16(aggr, W1b, b1, relu=True, out_dtype=bf,
                               ordered_ties=False),
            gin_conv.gemm_bf16(z, W2b, b2, out_dtype=bf,
                               ordered_ties=False)), torch)
        bwd_ms = time_ms(lambda: (
            gin_conv.gemm_bf16(g, W2b.t(), pos_mask=z),
            gin_conv.gemm_bf16(z.t(), g, splits=s2),
            gin_conv.gemm_bf16(aggr.t(), dzr, splits=s1),
            gin_conv.gemm_bf16(dzr, W1b.t(), ordered_ties=False)), torch)
    flops = 2 * N * F * F2
    print(f"[kernels bf16] K1's products alone on the tensor cores "
          f"(gemm_bf16), rel err (sound, control) against torch.matmul on "
          f"float32 copies: "
          f"{ {k: (float(f'{a:.3e}'), float(f'{c:.3e}')) for k, (a, c) in readings.items()} }; "  # noqa: E501
          f"forward {fwd_ms:.4f} ms = {2 * flops / fwd_ms / 1e9:.1f} TFLOP/s, "
          f"backward {bwd_ms:.4f} ms = {4 * flops / bwd_ms / 1e9:.1f} "
          f"TFLOP/s, with K1's epilogues and splits", flush=True)
    bad = {k: v for k, v in readings.items()
           if not (v[0] <= BF16_GEMM_TOL < v[1])}
    if bad:
        raise AssertionError(f"gemm_bf16 disagrees with torch.matmul, or "
                             f"its control passes: {bad}")
    return {"fwd": fwd_ms, "bwd": bwd_ms}


def k2_bf16_phase(torch, cases):
    """K2's bfloat16 variants, each with bfloat16 and float32 rows, as
    ``k1_bf16_phase``: ``cases`` maps a variant ``(has_x, has_ein)`` to its
    cases ``(shape, batch, ein, W, w)``, the first the shape of the path
    whose launches the entry reports (timed there), the others the same
    batch with fractional edge weights, where every rounding shows (the
    control must show in some case of each variant and rows). The
    library's yardstick is ``torch.sparse.mm`` in bfloat16 for the ``[x]``
    variant (no single call computes the others); its floor, the float32
    K2 on float32 rows at the same batch, stands beside each entry
    (``float32_ms``)."""
    from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs

    bf = torch.bfloat16
    entries = []
    for (has_x, has_ein), variant_cases in cases.items():
        v = bs.variant(has_x, has_ein)
        res = {}
        for rows in (bf, torch.float32):
            tag = f"K2[{v}] rows {str(rows)[6:]}"
            means = []
            for i, (shape, batch, ein, W, w) in enumerate(variant_cases):
                r, mean = _k2_bf16_case(torch, batch, ein, W, w, has_x,
                                        has_ein, rows, f"{tag}, {shape}",
                                        timed=i == 0)
                means.append(mean)
                if i == 0:
                    res.update({(d, rows): r[d] for d in r})
            _control_shows(tag, means)
        for d, line in (("fwd", 328), ("bwd", 377)):
            entries.append(dict(
                name=f"blocked_spmm_{d}[{v}][bf16]",
                counter=f"blocked_spmm_{d}[{v}]", route="cuda",
                source="pretrain_gnns_tpu_torch/csrc/spmm.cu",
                replaces=f"pretrain_gnns_tpu/ops/pallas_spmm.py:{line}",
                tpu_counterpart=(f"ops/pallas_spmm.py::_fused_{d}_kernel at "
                                 "compute_dtype=bfloat16"),
                library=("torch.sparse.mm in bfloat16, CSR adjacency of w"
                         if not has_ein else
                         "none: no single PyTorch call computes it"),
                shape=f"{variant_cases[0][0]}, bfloat16 rows",
                float32_ms=res[d, bf]["float32_ms"],
                **_rows_entry({r: res[d, r] for r in (bf, torch.float32)},
                              bf, torch.float32)))
    return entries


def _k2_bf16_case(torch, batch, ein, W, w, has_x, has_ein, rows, tag,
                  timed):
    """One case of ``k2_bf16_phase``: the checks, and with ``timed`` the
    times and the bound by direction; returns them and the control's
    largest mean reading."""
    from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs

    bf, dev = torch.bfloat16, batch.node_mask.device
    gen = torch.Generator().manual_seed(12)
    N = batch.max_nodes
    nm = batch.node_mask.to(torch.float32)
    x = (torch.randn(N, EMB, generator=gen).to(dev) * nm[:, None]).to(rows)
    g = torch.randn(N, EMB, generator=gen).to(dev).to(rows)
    W = W.detach().contiguous()
    snd, rcv, valid = batch.senders, batch.receivers, batch.edge_mask
    bn, be, K, F = batch.block_nodes, batch.block_edges, W.shape[0], EMB

    def run(dt):
        return ((bs.spmm_fwd(x, ein, W, snd, rcv, w, bn, be, has_x, has_ein,
                             dt),)
                + bs.spmm_bwd(g, ein, snd, rcv, w, K, bn, be, has_x,
                              has_ein, dt))

    with torch.no_grad():
        runs = [run(bf) for _ in range(2)]
        control = run(torch.float32)
    torch.cuda.synchronize()
    out, dx, dW = runs[0]
    xl = x.detach().clone().requires_grad_(True)
    Wl = W.detach().clone().requires_grad_(True)
    out_p = bs.blocked_spmm_fused_plain(xl, ein, Wl, snd, rcv, w, bn, be,
                                        has_x, has_ein, bf)
    leaves = [t for t, f in ((xl, has_x), (Wl, has_ein)) if f]
    names = ["out"] + [n for n, f in (("dx", has_x), ("dW", has_ein)) if f]
    grads_p = torch.autograd.grad(out_p, leaves, g, retain_graph=True)
    plain = (out_p.detach(),) + grads_p
    pick = lambda o: [o[0]] + [t for t, f in ((o[1], has_x),
                                               (o[2], has_ein)) if f]
    mean = _bf16_check(torch, tag, runs,
                       dict(zip(names, zip(pick(runs[0]), plain))),
                       dict(zip(names, zip(pick(control), plain))))
    if out[~batch.node_mask].any():
        raise AssertionError(f"{tag}: padded rows not 0")
    if not timed:
        return {}, mean
    max_abs = max(float((a.float() - c.float()).abs().max())
                  for a, c in zip(pick(runs[0]), plain))
    grads_k = pick(runs[0])[1:]
    fwd_args = (x, ein, W, snd, rcv, w, bn, be, has_x, has_ein, bf)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
        out_p, leaves, g, retain_graph=True), torch)
    x32, g32 = x.float(), g.float()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: bs.spmm_fwd(*fwd_args), torch)
        bwd_ms = time_ms(lambda: bs.spmm_bwd(g, ein, snd, rcv, w, K, bn, be,
                                             has_x, has_ein, bf), torch)
        f32_ms = (time_ms(lambda: bs.spmm_fwd(x32, *fwd_args[1:-1],
                                              torch.float32), torch),
                  time_ms(lambda: bs.spmm_bwd(g32, ein, snd, rcv, w, K, bn,
                                              be, has_x, has_ein,
                                              torch.float32), torch))
        plain_fwd_ms = time_ms(lambda: bs.blocked_spmm_fused_plain(
            *fwd_args), torch)
        lib = (None, None)
        if not has_ein:
            pairs = torch.stack([rcv[valid].long(), snd[valid].long()])
            csr = {k: torch.sparse_coo_tensor(i, w[valid].to(bf), (N, N))
                   .coalesce().to_sparse_csr()
                   for k, i in (("A", pairs), ("At", pairs.flip(0)))}
            xb, gb = x.to(bf), g.to(bf)
            try:
                lib = (time_ms(lambda: torch.sparse.mm(csr["A"], xb), torch),
                       time_ms(lambda: torch.sparse.mm(csr["At"], gb), torch))
            except RuntimeError as e:  # no bfloat16 CSR product
                print(f"[kernels bf16] torch.sparse.mm in bfloat16 does not "
                      f"run here: {e}", flush=True)
    e_valid = int(valid.sum())
    n_snd = int(torch.unique(snd[valid]).numel())
    n_rcv = int(torch.unique(rcv[valid]).numel())
    rs = x.element_size()
    e_bytes = e_valid * 4 * (2 + has_x + (K if has_ein else 0))
    fwd_ops = e_valid * F * (2 * K * has_ein + (has_x and has_ein) + 2)
    bwd_ops = e_valid * F * (1 + has_x + 2 * K * has_ein)
    fwd_b = bound(fwd_ops, n_snd * F * rs * has_x + K * F * 4 * has_ein
                  + e_bytes + nbytes(out), PEAK_BF16_FLOPS)
    bwd_b = bound(bwd_ops, n_rcv * F * rs + e_bytes
                  + sum(nbytes(t) for t in grads_k), PEAK_BF16_FLOPS)
    res = {}
    for d, ms, pms, b, lms, fms in (
            ("fwd", fwd_ms, plain_fwd_ms, fwd_b, lib[0], f32_ms[0]),
            ("bwd", bwd_ms, plain_bwd_ms, bwd_b, lib[1], f32_ms[1])):
        res[d] = dict(max_abs_err=max_abs, ms=ms, plain_ms=pms,
                      bound_ms=b[0], bound_by=b[1], library_ms=lms,
                      float32_ms=fms)
        lms_s = "none" if lms is None else f"{lms:.4f} ms"
        print(f"[kernels bf16] blocked_spmm_{d}[{bs.variant(has_x, has_ein)}]"
              f" rows {str(rows)[6:]}: kernel {ms:.4f} ms, plain {pms:.4f} "
              f"ms, library {lms_s}, bound {b[0]:.4f} ms ({b[1]}); the "
              f"float32 K2 on float32 rows {fms:.4f} ms ({fms / ms:.2f}x "
              f"this kernel's time)", flush=True)
    return res, mean


def k3_bf16_phase(torch, batch):
    """K3's bfloat16 variant on the chem edge-prediction path's first
    batch, the positive head (every edge slot, the cotangent the path gives
    it), with bfloat16 and float32 rows, as ``k1_bf16_phase``."""
    from pretrain_gnns_tpu_torch.ops import edge_dot as ed

    bf, dev = torch.bfloat16, batch.node_mask.device
    gen = torch.Generator().manual_seed(13)
    N, F, bn = batch.max_nodes, EMB, batch.block_nodes
    x32 = (torch.randn(N, F, generator=gen).to(dev)
           * batch.node_mask[:, None])
    a_idx, b_idx, valid = batch.receivers, batch.senders, batch.edge_mask
    ppb, P = batch.block_edges, batch.receivers.shape[0]
    w = valid.to(torch.float32)
    g = torch.zeros(P, device=dev)
    g[::2] = torch.randn(P, generator=gen).to(dev)[::2]
    res = {}
    for rows in (bf, torch.float32):
        x = x32.to(rows)

        def run(dt):
            return (ed.edot_fwd(x, a_idx, b_idx, w, bn, ppb, dt),
                    ed.edot_bwd(g, x, a_idx, b_idx, w, bn, ppb, dt))

        with torch.no_grad():
            runs = [run(bf) for _ in range(2)]
            control = run(torch.float32)
        torch.cuda.synchronize()
        out, dx = runs[0]
        xl = x.detach().clone().requires_grad_(True)
        out_p = ed.edge_dot_plain(xl, a_idx, b_idx, w, compute_dtype=bf)
        (dx_p,) = torch.autograd.grad(out_p, [xl], g, retain_graph=True)
        plain = (out_p.detach(), dx_p)
        tag = f"K3 rows {str(rows)[6:]}"
        _control_shows(tag, [_bf16_check(
            torch, tag, runs, dict(zip(("score", "dx"), zip(runs[0], plain))),
            dict(zip(("score", "dx"), zip(control, plain))))])
        max_abs = max(float((out - out_p.detach()).abs().max()),
                      float((dx.float() - dx_p.float()).abs().max()))
        plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
            out_p, [xl], g, retain_graph=True), torch)
        with torch.no_grad():
            fwd_ms = time_ms(lambda: ed.edot_fwd(x, a_idx, b_idx, w, bn, ppb,
                                                 bf), torch)
            bwd_ms = time_ms(lambda: ed.edot_bwd(g, x, a_idx, b_idx, w, bn,
                                                 ppb, bf), torch)
            plain_fwd_ms = time_ms(lambda: ed.edge_dot_plain(
                x, a_idx, b_idx, w, compute_dtype=bf), torch)
        rs = x.element_size()
        touched = torch.zeros(N, dtype=torch.bool, device=dev)
        touched[a_idx[valid].long()] = True
        touched[b_idx[valid].long()] = True
        live = valid & (g != 0)
        rows_b = int(torch.unique(torch.cat([a_idx[live], b_idx[live]]))
                     .numel())
        nv, nl = int(valid.sum()), int(live.sum())
        fwd_b = bound(2 * F * nv, int(touched.sum()) * F * rs + nv * 12
                      + P * 4, PEAK_BF16_FLOPS)
        bwd_b = bound(4 * F * nl, rows_b * F * rs + nl * 16 + N * F * rs,
                      PEAK_BF16_FLOPS)
        for d, ms, pms, b in (("fwd", fwd_ms, plain_fwd_ms, fwd_b),
                              ("bwd", bwd_ms, plain_bwd_ms, bwd_b)):
            res[d, rows] = dict(max_abs_err=max_abs, ms=ms, plain_ms=pms,
                                bound_ms=b[0], bound_by=b[1], library_ms=None)
            print(f"[kernels bf16] blocked_edge_dot_{d} rows "
                  f"{str(rows)[6:]}: kernel {ms:.4f} ms, plain {pms:.4f} "
                  f"ms, library none (no single call), bound {b[0]:.4f} ms "
                  f"({b[1]})", flush=True)
    return [dict(name=f"blocked_edge_dot_{d}[bf16]",
                 counter=f"blocked_edge_dot_{d}", route="cuda",
                 source="pretrain_gnns_tpu_torch/csrc/edge_dot.cu",
                 replaces=f"pretrain_gnns_tpu/ops/pallas_spmm.py:{line}",
                 tpu_counterpart=(f"ops/pallas_spmm.py::_edot_{d}_kernel at "
                                  "compute_dtype=bfloat16"),
                 library="none: no single PyTorch call computes it",
                 shape=("chem edge-prediction first batch, positive head, "
                        "bfloat16 rows"),
                 **_rows_entry({r: res[d, r] for r in (bf, torch.float32)},
                               bf, torch.float32))
            for d, line in (("fwd", 587), ("bwd", 610))]


# the device kernels a bfloat16 replay must show: the bfloat16
# instantiations (the last template argument, BF, true) of K1's and K3's
# walks, K2's bfloat16 kernels (spmm_bf16.cu), K1's products on the tensor
# cores (gemm_bf16_kernel) ...
BF16_KERNEL_NAMES = {
    "gin_conv_fwd": (r"edge_aggr_fwd_kernel<true, true, true, [^>]*, true>",
                     "gemm_bf16_kernel"),
    "gin_conv_bwd": (r"edge_aggr_bwd_kernel<true, true, true, [^>]*, true>",
                     "gemm_bf16_kernel"),
    # K2's: the x walk, the edge terms on the tensor cores, the backward
    **{f"blocked_spmm_fwd[{v}]": (pattern,) for v, pattern in (
        ("x", "spmm16_x_fwd_kernel<"),
        ("ein", "spmm16_edge_fwd_kernel<false, "),
        ("x+ein", "spmm16_edge_fwd_kernel<true, "))},
    **{f"blocked_spmm_bwd[{v}]": (f"spmm16_bwd_kernel<{args}, ",)
       for v, args in (("x", "true, false"), ("ein", "false, true"),
                       ("x+ein", "true, true"))},
    "blocked_edge_dot_fwd": (r"edot_fwd_kernel<[^>]*, true>",),
    "blocked_edge_dot_bwd": (r"edot_bwd_kernel<[^>]*, true>",),
    # K4: the forward's logit scalars and walk (both softmaxes), the
    # backward's walks on the saved softmax of the bfloat16 residual, dWe by
    # node block, and the products on the tensor cores; K5: its walks at BF
    "gat_conv_fwd": ("gat_proj16_kernel", "gat_conv_fwd16_kernel",
                     "gemm_bf16_kernel"),
    "gat_conv_bwd": (r"gat_bwd_rcv_kernel<true, [^>]*, true, [^>]*bfloat16>",
                     r"gat_bwd_snd_kernel<true, [^>]*, true, [^>]*bfloat16>",
                     "gat_dwe16_kernel", "gemm_bf16_kernel"),
    "blocked_gat_attention_fwd": (r"gat_fwd_kernel<false, [^>]*, true, "
                                  r"float>",),
    "blocked_gat_attention_bwd": (
        r"gat_bwd_rcv_kernel<false, [^>]*, true, float>",
        r"gat_bwd_snd_kernel<false, [^>]*, true, float>"),
}
# ... and the kernels it must not show: no K1 or K4 product on the CUDA
# cores, no float32 dWe of K4, no walk of K4's recomputing its softmax
BF16_ABSENT_NAMES = {"gin_conv_fwd": (r"gemm_kernel<",),
                     "gin_conv_bwd": (r"gemm_kernel<",),
                     "gat_conv_fwd": (r"gemm_kernel<", r"gat_fwd_kernel<true",
                                      "gat_proj_kernel", "gat_edge_vec"),
                     "gat_conv_bwd": (r"gemm_kernel<", "gat_dwe_kernel")}


# --- the bfloat16 variants of K4, K5, K6 and K7 ------------------------------


def gat_bf16_phase(torch, batch, conv, ein, tag):
    """K4's and K5's bfloat16 variants (compute_dtype=bfloat16) on a GAT
    masking path's first batch, with the first layer's parameters
    (``conv``) and edge inputs ``ein``: K4 on float32 h (as the trunks pass
    it), K5 on x (float32, as the unfused conv widens it) and e in float32
    (the chem embedding's dtype) and in bfloat16 (the bio encoder's under
    bfloat16_act). Each against its plain version at compute_dtype=
    bfloat16 and the control at float32 (``_bf16_check``), bit-equal
    between two runs, timed beside the plain version and, for K4's
    products, ``torch.matmul`` in bfloat16. The bounds count the stored
    widths' bytes, the products at the bfloat16 tensor peak and the
    attention's other operations at the float32 peak. Returns ``{kernel
    name: dict}`` (K5's with ``rows_bfloat16`` for bfloat16 e)."""
    from pretrain_gnns_tpu_torch.ops import attention as at
    from pretrain_gnns_tpu_torch.ops import gat_conv as gc

    bf, f32 = torch.bfloat16, torch.float32
    dev = batch.node_mask.device
    gen = torch.Generator().manual_seed(15)
    N, E, bn, be = (batch.max_nodes, batch.max_edges, batch.block_nodes,
                    batch.block_edges)
    H, D, K, slope = conv.heads, conv.emb_dim, ein.shape[1], 0.2
    HD = H * D
    nm = batch.node_mask.to(f32)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    h = rnd(N, D) * nm[:, None]
    g, g3 = rnd(N, D) * nm[:, None], rnd(N, H, D) * nm[:, None, None]
    with torch.no_grad():
        We, e_self = conv.edge_kernel()
        Wl, bl = conv.weight_linear.weight.t(), conv.weight_linear.bias
        par = [We.contiguous(), e_self.reshape(H, D).contiguous(),
               conv.att[0, :, :D].contiguous(),
               conv.att[0, :, D:].contiguous()]
        bias = rnd(D) * 0.1
    graph = (batch.senders, batch.receivers, batch.edge_mask.to(f32))
    V, Ev = int(nm.sum()), int(batch.edge_mask.sum())
    node_ops, edge_ops = V * HD, Ev * HD
    edge_scalar_ops = Ev * H * 2 * K + 2 * K * HD
    small = nbytes(*par, bias, bl)
    edge_b4 = Ev * (K + 3) * 4
    # the attention's float32 operations at the bfloat16 peak's rate
    f32_ops = PEAK_BF16_FLOPS / PEAK_F32_FLOPS
    results = {}

    # K4: float32 h, its bfloat16 residual x
    def k4(dt):
        out, x, saved = gc.gat_conv_fwd(h, Wl, bl, ein, *par, bias, *graph,
                                        bn, be, slope, dt)
        return (out, x) + gc.gat_conv_bwd(g, h, Wl, x, ein, *par, *graph,
                                          saved, bn, be, slope, dt)

    with torch.no_grad():
        runs = [k4(bf) for _ in range(2)]
        control = k4(f32)
        # the forward's saved softmax and rounded operands, for the timing
        saved16 = gc.gat_conv_fwd(h, Wl, bl, ein, *par, bias, *graph, bn, be,
                                  slope, bf)[2]
    torch.cuda.synchronize()
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (h, Wl, bl, *par, bias)]
    lh, lWl, lbl, lWe, les, lai, laj, lbias = leaves
    k4_plain = lambda: gc.fused_gat_conv_plain(
        lh, lWl, lbl, ein, lWe, les, lai, laj, lbias, *graph, H, bn, be,
        slope, return_residuals=True, compute_dtype=bf)
    out_p, x_p = k4_plain()
    grads_p = torch.autograd.grad(out_p, leaves, g, retain_graph=True)
    names = ("out", "x", "dh", "dWl", "dbl", "dWe", "de_self", "da_i",
             "da_j", "dbias")
    plain = (out_p.detach(), x_p) + grads_p
    _control_shows(f"K4 {tag}", [_bf16_check(
        torch, f"K4 {tag}", runs, dict(zip(names, zip(runs[0], plain))),
        dict(zip(names, zip(control, plain))))])
    if not all(bool(torch.isfinite(t.float()).all()) for t in runs[0]):
        raise AssertionError(f"K4 bfloat16 {tag}: not finite")
    x16 = runs[0][1]
    err4 = (max(float((a.float() - b.float()).abs().max())
                for a, b in zip(runs[0][:2], plain[:2])),
            max(float((a - b).abs().max())
                for a, b in zip(runs[0][2:], plain[2:])))
    plain_bwd = time_ms(lambda: torch.autograd.grad(
        out_p, leaves, g, retain_graph=True), torch)
    with torch.no_grad():
        hb, Wlb, dxb = h.to(bf), Wl.to(bf), x16
        ms4 = {
            "gat_conv_fwd": (
                time_ms(lambda: gc.gat_conv_fwd(h, Wl, bl, ein, *par, bias,
                                                *graph, bn, be, slope, bf),
                        torch),
                time_ms(k4_plain, torch),
                time_ms(lambda: torch.matmul(hb, Wlb), torch)),
            "gat_conv_bwd": (
                time_ms(lambda: gc.gat_conv_bwd(g, h, Wl, x16, ein, *par,
                                                *graph, saved16, bn, be,
                                                slope, bf), torch),
                plain_bwd,
                time_ms(lambda: (torch.matmul(hb.t(), dxb),
                                 torch.matmul(dxb, Wlb.t())), torch)),
        }
    # the bounds of the Pallas function's two directions, whatever the
    # kernels hand from one to the other: forward: x = h @ Wl and each
    # slot's e = ein @ We (the messages' rounding needs e a slot) on the
    # tensor cores, one softmax, out and the residual bf(x) written;
    # backward: dWl, dh and dWe = ein^T de a slot, dalpha's edge term the
    # cheaper of e a slot or q_r = We g_r a row, the softmax recomputed from
    # the residual (the forward's saved softmax and rounded h and Wl, which
    # the kernels hand over instead, are not counted)
    e_dalpha = min(edge_ops * 2 * K, node_ops * 2 * K + Ev * H * 2 * K)
    fwd4 = bound(2 * (V + 1) * D * HD + edge_ops * 2 * K + f32_ops * (
        node_ops * 7 + edge_scalar_ops + edge_ops * 4 + N * D * 2),
        rows_nbytes(h, V) + nbytes(Wl) + small + edge_b4 + N * D * 4
        + N * HD * 2, PEAK_BF16_FLOPS)
    bwd4 = bound(2 * 2 * V * D * HD + edge_ops * 2 * K + e_dalpha + f32_ops * (
        node_ops * 7 + edge_scalar_ops       # the softmax recomputed
        + node_ops * 3 + edge_ops * 2        # dalpha, the self loop's
        + edge_ops * 3 + node_ops * 12       # dmsg, dx, de_self, da_i, da_j
        + edge_scalar_ops + N * D + node_ops),
        rows_nbytes(g, V) + rows_nbytes(h, V) + V * HD * 2 + nbytes(Wl)
        + small + edge_b4 + nbytes(*runs[0][2:]), PEAK_BF16_FLOPS)
    for (name, (ms, pms, mm)), b, err in zip(ms4.items(), (fwd4, bwd4),
                                             err4):
        results[name] = dict(ms=ms, plain_ms=pms, matmul_ms=mm,
                             bound_ms=b[0], bound_by=b[1], max_abs_err=err,
                             library_ms=None)
        print(f"[kernels bf16] {name} {tag}: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, torch.matmul products in bfloat16 {mm:.4f} "
              f"ms, library none (no single call), bound {b[0]:.4f} ms "
              f"({b[1]})", flush=True)

    # K5: x float32, e in float32 and in bfloat16
    with torch.no_grad():
        x5 = (h @ Wl + bl).reshape(N, H, D)
        e32 = (ein @ par[0]).reshape(E, H, D)
    k5res = {}
    for erows in (f32, bf):
        e5 = e32.to(erows)

        def k5(dt, fn=at.blocked_gat_attention):
            lv = [t.detach().clone().requires_grad_(True)
                  for t in (x5, e5, *par[1:])]
            out = fn(*lv, *graph, slope, bn, be, compute_dtype=dt)
            return (out.detach(),) + torch.autograd.grad(out, lv, g3)

        runs5 = [k5(bf) for _ in range(2)]
        control5 = k5(f32)
        plain5 = k5(bf, at.blocked_gat_attention_plain)
        torch.cuda.synchronize()
        names5 = ("out", "dx", "de", "de_self", "da_i", "da_j")
        t5 = f"K5 {tag}, e {str(erows)[6:]}"
        _control_shows(t5, [_bf16_check(
            torch, t5, runs5, dict(zip(names5, zip(runs5[0], plain5))),
            dict(zip(names5, zip(control5, plain5))))])
        if runs5[0][2][~batch.edge_mask].any():
            raise AssertionError(f"{t5}: padded slots' de not 0")
        err5 = (float((runs5[0][0] - plain5[0]).abs().max()),
                max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(runs5[0][1:], plain5[1:])))
        with torch.no_grad():
            e5f = e5.float()  # the kernels read e widened
            fwd = lambda: at.gat_attn_fwd(x5, e5f, *par[1:], *graph, slope,
                                          bn, be, bf)
            _, saved5 = fwd()
            lv5 = [t.detach().clone().requires_grad_(True)
                   for t in (x5, e5, *par[1:])]
        out_p5 = at.blocked_gat_attention_plain(*lv5, *graph, slope,
                                                compute_dtype=bf)
        plain_bwd5 = time_ms(lambda: torch.autograd.grad(
            out_p5, lv5, g3, retain_graph=True), torch)
        with torch.no_grad():
            ms5 = {"blocked_gat_attention_fwd": (
                       time_ms(fwd, torch),
                       time_ms(lambda: at.blocked_gat_attention_plain(
                           x5, e5, *par[1:], *graph, slope,
                           compute_dtype=bf), torch)),
                   "blocked_gat_attention_bwd": (
                       time_ms(lambda: at.gat_attn_bwd(
                           g3, x5, e5f, *par[1:], *graph, saved5, slope, bn,
                           be, bf), torch), plain_bwd5)}
        eb = Ev * HD * e5.element_size()
        fwd5 = bound(node_ops * 7 + edge_ops * 5 + node_ops * 2,
                     V * HD * 4 + Ev * 12 + eb + nbytes(*par[1:])
                     + N * HD * 4)
        bwd5 = bound(edge_ops * 3 + node_ops * 3 + edge_ops * 2
                     + node_ops * 12 + edge_ops * 2,
                     2 * V * HD * 4 + Ev * 12 + eb + nbytes(*par[1:])
                     + nbytes(*runs5[0][1:]))
        for (name, (ms, pms)), b, err in zip(ms5.items(), (fwd5, bwd5),
                                             err5):
            k5res[name, erows] = dict(ms=ms, plain_ms=pms, bound_ms=b[0],
                                      bound_by=b[1], max_abs_err=err,
                                      library_ms=None)
            print(f"[kernels bf16] {name} {tag}, e {str(erows)[6:]}: "
                  f"kernel {ms:.4f} ms, plain {pms:.4f} ms, library none "
                  f"(no single call), bound {b[0]:.4f} ms ({b[1]})",
                  flush=True)
    for name in ("blocked_gat_attention_fwd", "blocked_gat_attention_bwd"):
        results[name] = dict(k5res[name, f32],
                             rows_bfloat16=k5res[name, bf])
    print(f"[kernels bf16] GAT at the {tag}: N={N} E={E} H={H} D={D} K={K} "
          f"valid_nodes={V} valid_edges={Ev} "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)
    return results


def gat_bf16_entries(chem, bio):
    """The ``kernels`` entries of K4's and K5's bfloat16 variants: the times
    at the chem GAT first batch (the paths that launch them) under the
    contract's keys, the bio batch beside them."""
    where = {"gat_conv_fwd": ("pallas_gat_conv.py", 338),
             "gat_conv_bwd": ("pallas_gat_conv.py", 389),
             "blocked_gat_attention_fwd": ("pallas_attention.py", 229),
             "blocked_gat_attention_bwd": ("pallas_attention.py", 389)}
    return [dict(
        name=f"{name}[bf16]", counter=name, route="cuda",
        source="pretrain_gnns_tpu_torch/csrc/gat_bf16.cu",
        replaces=f"pretrain_gnns_tpu/ops/{file}:{line}",
        tpu_counterpart=f"ops/{file} at compute_dtype=bfloat16",
        library="none: no single PyTorch call computes it",
        shape=("chem GAT first batch: the masking path (K4, float32 h) and "
               "the unfused edge-prediction path (K5, float32 x and e)"),
        **chem[name], other_shapes={"bio GAT masking first batch": bio[name]})
        for name, (file, line) in where.items()]


def spmm_ee_bf16_phase(torch, batch, tag):
    """K6's and K7's bfloat16 variants (compute_dtype=bfloat16) on a
    masking path's first batch with a random edge embedding and
    fractional, partly negative edge weights, rows in bfloat16 and in
    float32: K6 ``[x+ee]`` and ``[x]`` (out, dx, dmsg) and K7 on the sorted
    slots, each against its plain version at compute_dtype=bfloat16 and
    the control at float32 (``_bf16_check``), bit-equal between two runs,
    padded rows and slots exactly 0, timed beside the plain version and
    ``torch.sparse.mm`` in bfloat16 (SPMM_EE_LIBRARY's products, where it
    runs). Returns ``{kernel name: dict}`` for bfloat16 rows, with
    ``rows_float32`` beside."""
    from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs
    from pretrain_gnns_tpu_torch.ops import sorted_spmm as ss

    bf, f32 = torch.bfloat16, torch.float32
    dev = batch.node_mask.device
    gen = torch.Generator().manual_seed(16)
    N, E, F = batch.max_nodes, batch.max_edges, EMB
    bn, be = batch.block_nodes, batch.block_edges
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    x0 = rnd(N, F) * batch.node_mask[:, None]
    ee0, g0 = rnd(E, F), rnd(N, F)
    valid = batch.edge_mask
    w = valid.to(f32) * (torch.rand(E, generator=gen) * 2 - 0.5).to(dev)
    snd, rcv = batch.senders, batch.receivers
    edges = (snd, rcv, w, bn, be)
    e_valid = int(valid.sum())
    n_snd = int(torch.unique(snd[valid]).numel())
    n_rcv = int(torch.unique(rcv[valid]).numel())
    pad_rows, pad_slots = ~batch.node_mask, ~valid
    n_blocks = N // bn
    s2, r2, w2, ee_sorted = ss.sort_block_edges(snd, rcv, w, ee0, n_blocks,
                                                be)
    res = {}
    for rows in (bf, f32):
        x, ee, g = x0.to(rows), ee0.to(rows), g0.to(rows)
        es2 = ee_sorted.to(rows)
        rs = x.element_size()
        for has_ee in (True, False):
            v = bs.ee_variant(has_ee)
            e_in = ee if has_ee else None
            tag6 = f"K6[{v}] {tag}, rows {str(rows)[6:]}"

            def run(dt):
                return ((bs.spmm_ee_fwd(x, e_in, *edges, dt),)
                        + bs.spmm_ee_bwd(g, *edges, has_ee, True, has_ee,
                                         dt))

            with torch.no_grad():
                runs = [run(bf) for _ in range(2)]
                control = run(f32)
                alone = bs.spmm_ee_bwd(g, *edges, has_ee, True, False, bf)[0]
            torch.cuda.synchronize()
            xl = x.detach().clone().requires_grad_(True)
            el = ee.detach().clone().requires_grad_(True)
            out_p = bs.blocked_spmm_plain(xl, el if has_ee else None,
                                          *edges[:3], compute_dtype=bf)
            leaves = [xl, el] if has_ee else [xl]
            grads_p = torch.autograd.grad(out_p, leaves, g, retain_graph=True)
            names = ("out", "dx", "dmsg")[:2 + has_ee]
            plain = (out_p.detach(),) + grads_p
            _control_shows(tag6, [_bf16_check(
                torch, tag6, runs, dict(zip(names, zip(runs[0], plain))),
                dict(zip(names, zip(control, plain))))])
            out, dx, dmsg = runs[0]
            zeros = [out[pad_rows], dx[pad_rows]] + (
                [dmsg[pad_slots]] if has_ee else [])
            if any(z.any() for z in zeros) or not torch.equal(alone, dx):
                raise AssertionError(f"{tag6}: padded rows or slots not 0, "
                                     "or dx alone differs")
            grads_k = [dx, dmsg] if has_ee else [dx]
            plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
                out_p, leaves, g, retain_graph=True), torch)
            with torch.no_grad():
                fwd_ms = time_ms(lambda: bs.spmm_ee_fwd(x, e_in, *edges, bf),
                                 torch)
                bwd_ms = time_ms(lambda: bs.spmm_ee_bwd(
                    g, *edges, has_ee, True, has_ee, bf), torch)
                plain_fwd_ms = time_ms(lambda: bs.blocked_spmm_plain(
                    x, e_in, *edges[:3], compute_dtype=bf), torch)
                lib = [None, None]
                A, At = spmm_ee_csr(torch, snd, rcv, w, valid, N, has_ee)
                to_bf = lambda M: torch.sparse_csr_tensor(
                    M.crow_indices(), M.col_indices(), M.values().to(bf),
                    M.shape)
                rhs = (torch.cat([x, ee]) if has_ee else x).to(bf)
                try:
                    Ab, Atb, gb = to_bf(A), to_bf(At), g.to(bf)
                    lib = [time_ms(lambda: torch.sparse.mm(Ab, rhs), torch),
                           time_ms(lambda: torch.sparse.mm(Atb, gb), torch)]
                except RuntimeError as e:  # no bfloat16 CSR product
                    print(f"[kernels bf16] torch.sparse.mm in bfloat16 does "
                          f"not run here: {e}", flush=True)
            fwd_b = bound(e_valid * F * (2 + has_ee),
                          n_snd * F * rs + e_valid * (12 + F * rs * has_ee)
                          + nbytes(out), PEAK_BF16_FLOPS)
            bwd_b = bound(e_valid * F * 2,
                          n_rcv * F * rs + e_valid * 12 + nbytes(*grads_k),
                          PEAK_BF16_FLOPS)
            for d, ms, pms, b, lms, err in (
                    ("fwd", fwd_ms, plain_fwd_ms, fwd_b, lib[0],
                     float((out.float() - plain[0].float()).abs().max())),
                    ("bwd", bwd_ms, plain_bwd_ms, bwd_b, lib[1],
                     max(float((a.float() - c.float()).abs().max())
                         for a, c in zip(grads_k, grads_p)))):
                res[f"blocked_spmm_ee_{d}[{v}]", rows] = dict(
                    ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                    library_ms=lms, max_abs_err=err,
                    library=SPMM_EE_LIBRARY[d, has_ee] + ", in bfloat16")
            if has_ee:
                k6_fwd_b, k6_lib = fwd_b, lib[0]

        # K7 on the sorted slots
        tag7 = f"K7 {tag}, rows {str(rows)[6:]}"
        k7 = lambda dt: ss.sorted_blocked_spmm(x, es2, s2, r2, w2, bn, be, dt)
        with torch.no_grad():
            runs7 = [(k7(bf),), (k7(bf),)]
            control7 = k7(f32)
            plain7 = ss.sorted_blocked_spmm_plain(x, es2, s2, r2, w2,
                                                  compute_dtype=bf)
        torch.cuda.synchronize()
        mean7 = _bf16_check(torch, tag7, runs7, {"out": (runs7[0][0], plain7)},
                            {"out": (control7, plain7)})
        if rows == f32:  # on bfloat16 rows K7's one rounding is a no-op
            _control_shows(tag7, [mean7])
        if runs7[0][0][pad_rows].any():
            raise AssertionError(f"{tag7}: padded rows not 0")
        with torch.no_grad():
            res["sorted_blocked_spmm_fwd", rows] = dict(
                ms=time_ms(lambda: k7(bf), torch),
                plain_ms=time_ms(lambda: ss.sorted_blocked_spmm_plain(
                    x, es2, s2, r2, w2, compute_dtype=bf), torch),
                bound_ms=k6_fwd_b[0], bound_by=k6_fwd_b[1],
                library_ms=k6_lib,
                library=SPMM_EE_LIBRARY["fwd", True] + ", in bfloat16",
                max_abs_err=float((runs7[0][0].float()
                                   - plain7.float()).abs().max()))
    for (name, rows), r in res.items():
        lms = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[kernels bf16] {name} {tag}, rows {str(rows)[6:]}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lms}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    return {name: dict(res[name, bf], rows_float32=res[name, f32])
            for name, rows in res if rows == bf}


def spmm_ee_bf16_entries(chem, bio):
    """The ``kernels`` entries of K6's and K7's bfloat16 variants: the chem
    masking first batch under the contract's keys (bfloat16 rows), the bio
    batch beside them."""
    entries = []
    for name in chem:
        if name == "sorted_blocked_spmm_fwd":
            replaces = "pretrain_gnns_tpu/ops/pallas_spmm_sorted.py:160"
            body = "ops/pallas_spmm_sorted.py::_sorted_fwd_kernel"
        else:
            d = name.split("_")[3][:3]
            replaces = ("pretrain_gnns_tpu/ops/pallas_spmm.py:"
                        f"{195 if d == 'fwd' else 217}")
            body = f"ops/pallas_spmm.py::_{d}_kernel"
        entries.append(dict(
            name=f"{name}[bf16]", counter=name, route="cuda",
            source="pretrain_gnns_tpu_torch/csrc/spmm_ee.cu",
            replaces=replaces,
            tpu_counterpart=f"{body} at compute_dtype=bfloat16",
            shape="chem masking first batch, random edge embedding, "
                  "fractional edge weights, bfloat16 rows",
            **chem[name], other_shapes={"bio masking first batch": bio[name]}))
    return entries


def k2_bf16_cases(torch, chem_cfg, chem_first, bio_cfg, bio_first):
    """``k2_bf16_phase``'s cases: ``[x]`` and ``[ein]`` on the bio masking
    path's first batch (its edge inputs, the first layer's W, the path's
    0/1 edge weights), ``[x+ein]`` on the chem masking path's (the bond
    one-hots, the first layer's We, the unfused GIN path's 0/1 weights),
    each beside the same batch with fractional weights: 0.5 + U(0, 1) on
    the bio batch, GCN's symmetric normalisation on the chem one."""
    from pretrain_gnns_tpu_torch.models import bio, chem
    from pretrain_gnns_tpu_torch.train import pretrain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(14)
    b = bio_first.to(dev)
    conv = pretrain.build_objective(bio_cfg).to(dev).gnn.gnns[0]
    mask = b.edge_mask.to(torch.float32)
    frac = mask * (0.5 + torch.rand(mask.shape[0], generator=gen)).to(dev)
    bio_in = (bio.edge_inputs(b, torch.float32), conv.edge_kernel()[0])
    bio_cases = [("bio masking first batch", b, *bio_in, mask),
                 ("bio masking first batch, fractional edge weights", b,
                  *bio_in, frac)]
    c = chem_first.to(dev)
    conv = pretrain.build_objective(chem_cfg).to(dev).gnn.gnns[0]
    dis = chem.inv_sqrt_degree(c)
    mask = c.edge_mask.to(torch.float32)
    gcn = mask * dis[c.receivers.long()] * dis[c.senders.long()]
    chem_in = (chem.bond_one_hot(c, torch.float32), conv.edge_kernel()[0])
    return {(True, False): bio_cases, (False, True): bio_cases,
            (True, True): [
                ("chem masking first batch (the unfused GIN path's)", c,
                 *chem_in, mask),
                ("chem masking first batch, GCN edge weights", c, *chem_in,
                 gcn)]}


def bf16_section(torch, card, chem_graphs, chem_first, bio_graphs, bio_first,
                 edgepred_chem_first, f32_rates, gat_first, micro_main,
                 bf16_rates):
    """The bfloat16 variants and paths under the JAX bench's recipe;
    returns the ``kernels`` entries of the variants and puts each path's
    rate into ``bf16_rates``. ``gat_first`` holds the GAT paths' first
    batches ("chem", "bio" masking and "chem edgepred")."""
    from pretrain_gnns_tpu_torch.models import bio, chem
    from pretrain_gnns_tpu_torch.train import pretrain

    dev = torch.device("cuda")
    base = dict(num_layer=LAYERS, emb_dim=EMB, batch_size=BATCH, seed=0,
                packing="auto")
    chem_cfg = host_config(mask_edge=False, **base)
    bio_cfg = host_config(domain="bio", **base)
    ep_cfg = host_config(objective="edgepred", **base)
    gat_cfg = {d: host_config(
        domain=d, gnn_type="gat", mask_edge=False, **base)
        for d in ("chem", "bio")}
    gat_ep_cfg = host_config(objective="edgepred",
                                         gnn_type="gat", **base)
    with precision("bfloat16_act", "bfloat16"):
        entries = k1_bf16_phase(torch, chem_first.to(dev),
                                pretrain.build_objective(chem_cfg).to(dev))
        entries += k2_bf16_phase(torch, k2_bf16_cases(
            torch, chem_cfg, chem_first, bio_cfg, bio_first))
        entries += k3_bf16_phase(torch, edgepred_chem_first.to(dev))
        # K4 and K5 at the GAT paths' first batches, K6 and K7 at the
        # masking paths'
        gat = {}
        for d in ("chem", "bio"):
            on_card = gat_first[d].to(dev)
            ein = (bio.edge_inputs(on_card, torch.float32) if d == "bio"
                   else chem.bond_one_hot(on_card, torch.float32))
            conv = pretrain.build_objective(gat_cfg[d]).to(dev).gnn.gnns[0]
            gat[d] = gat_bf16_phase(torch, on_card, conv, ein,
                                    f"{d} GAT masking first batch")
        entries += gat_bf16_entries(gat["chem"], gat["bio"])
        k67 = spmm_ee_bf16_entries(*(spmm_ee_bf16_phase(
            torch, b.to(dev), f"{d} masking first batch")
            for d, b in (("chem", chem_first), ("bio", bio_first))))
        entries += k67
        record_launches(k67, edge_emb_path_phase(torch, chem_first.to(dev)),
                        {k["counter"] for k in k67
                         if k["counter"] != "sorted_blocked_spmm_fwd"})
        record_launches(k67, micro_phase(torch, micro_main, "bfloat16"),
                        {"sorted_blocked_spmm_fwd"})
        recorded = set()  # a variant's launches: the first path that runs it
        for graphs, cfg, first, per_step, fused in (
                (chem_graphs, chem_cfg, chem_first, K1, "on"),
                (chem_graphs, chem_cfg, chem_first, GCN_K2, "off"),
                (bio_graphs, bio_cfg, bio_first, BIO_K2, "on"),
                (chem_graphs, ep_cfg, edgepred_chem_first, {**K1, **K3},
                 "on"),
                (chem_graphs, gat_cfg["chem"], gat_first["chem"], K4, "on"),
                (chem_graphs, gat_ep_cfg, gat_first["chem edgepred"],
                 {**K5, **K3}, "off")):
            name = path_name(cfg, fused)
            bf16_agreement(torch, first, cfg, fused)
            launched = main_path_phase(torch, graphs, cfg, card, per_step,
                                       fused=fused,
                                       precision="bfloat16_act")
            record_launches([k for k in entries if k["counter"] in per_step
                             and k["counter"] not in recorded], launched)
            recorded.update(per_step)
            rate, f32 = launched[4], f32_rates.get(name)
            bf16_rates[name] = rate
            print(f"[{name} bfloat16_act] {rate:.1f} valid edges/s against "
                  f"{f32:.1f} in float32 earlier in this run, "
                  f"{rate / f32:.3f}x, on {card}", flush=True)
            capture_phase(torch, graphs, cfg, per_step, fused,
                          kernel_names=BF16_KERNEL_NAMES,
                          absent_names=BF16_ABSENT_NAMES)
        # the bio GAT masking path's step (K4 at K = 10); its kernels
        # above
        bf16_agreement(torch, gat_first["bio"], gat_cfg["bio"], "on")
    return entries


def default_section(torch, card, chem_graphs, chem_first, bio_graphs,
                    bio_first, f32_rates, bf16_rates):
    """The knobs' own defaults (the model's at float32, the kernels' at
    bfloat16: float32 rows through the bfloat16 kernels, what a run that
    sets no knob launches): the chem masking GIN path (K1) and the bio
    masking GIN path (K2 ``[x]`` and ``[ein]``), each its agreement step
    with the CPU, its 48 steps and its capture bits, its rate beside the
    float32 and bfloat16_act rates of the same path earlier in this run.
    The kernels' times on float32 rows are the bfloat16 section's (K1's
    and K2's ``rows_float32``; K4 bfloat16 always takes float32 h, which
    its wrapper widens under bfloat16_act)."""
    from pretrain_gnns_tpu_torch.train import pretrain

    base = dict(num_layer=LAYERS, emb_dim=EMB, batch_size=BATCH, seed=0,
                packing="auto")
    for graphs, first, cfg, per_step in (
            (chem_graphs, chem_first,
             host_config(mask_edge=False, **base), K1),
            (bio_graphs, bio_first,
             host_config(domain="bio", **base), BIO_K2)):
        name = path_name(cfg)
        with precision("float32", "bfloat16"):
            bf16_agreement(torch, first, cfg)
            rate = main_path_phase(torch, graphs, cfg, card, per_step,
                                   precision="default")[4]
            capture_phase(torch, graphs, cfg, per_step,
                          kernel_names=BF16_KERNEL_NAMES,
                          absent_names=BF16_ABSENT_NAMES)
        f32, bf = f32_rates[name], bf16_rates[name]
        print(f"[{name} default] {rate:.1f} valid edges/s against {f32:.1f} "
              f"in float32 ({rate / f32:.3f}x) and {bf:.1f} under "
              f"bfloat16_act ({rate / bf:.3f}x) earlier in this run, on "
              f"{card} [{time.perf_counter() - T0:.0f} s]", flush=True)


# --- context prediction: two trunks on two blocked streams ------------------

# launches a step: the substructure trunk's LAYERS and the context trunk's
# CONTEXT_LAYERS (csize 3 in chem, 3 in bio), each way
CONTEXT_LAYERS = 3
CP_K1 = {k: v + CONTEXT_LAYERS for k, v in K1.items()}
CP_BIO_K2 = {k: v + CONTEXT_LAYERS for k, v in BIO_K2.items()}
# The contextpred agreement steps' float32 noise from 1 + CP_NOISE_SAMPLES
# CPU steps: the unscaled step, always among them, reads most of the
# largest distance (on an H100 host: bio 3.17e-3 of the 17 steps' 3.19e-3;
# chem skipgram 5.4e-3 and chem cbow 8.9e-4, their scaled samples up to
# 1.4e-2 and 2.4e-2), fewer samples can only lower the limit, and a bio
# CPU step at full width takes about 6 s.
CP_NOISE_SAMPLES = 4
# chem: about 6% of the molecules have no context (nothing 4 to 7 hops
# from the root), so the chem path takes more molecules than MAIN_GRAPHS:
# at least 4,096 pairs a variant, 16 batches an epoch, one replay of K = 16
CP_CHEM_GRAPHS = 4400


def describe_pair(tag, pair):
    """Each stream of a pair batch: its graphs, valid nodes and edges, the
    valid rows no edge reaches, its blocks and those without a valid
    edge."""
    import numpy as np

    for name, g in (("substructure", pair.substruct),
                    ("context", pair.context)):
        deg = np.bincount(np.asarray(g.receivers)[np.asarray(g.edge_mask)],
                          minlength=g.max_nodes)
        nm = np.asarray(g.node_mask)
        idle = int((np.asarray(g.edge_mask).reshape(
            -1, g.block_edges).sum(axis=1) == 0).sum())
        print(f"[{tag}] first batch, {name} stream: "
              f"{int(np.asarray(g.graph_mask).sum())} graphs, {int(nm.sum())} "
              f"nodes ({int(((deg == 0) & nm).sum())} without a message), "
              f"{int(np.asarray(g.edge_mask).sum())} valid edges; blocks "
              f"{g.max_nodes // g.block_nodes} x ({g.block_nodes}, "
              f"{g.block_edges}), {idle} without a valid edge", flush=True)
    ov = np.asarray(pair.context.extras["overlap_context_substruct_idx_mask"])
    print(f"[{tag}] first batch: {int(ov.sum())} overlap rows of "
          f"{ov.shape[0]}", flush=True)


def pair_loader_phase(torch, pairs, cfg, dev):
    """The presampling's time and each stream's geometry; the blocked
    loader's first epoch on the host (the joint walk and both streams'
    packing, ms a batch); on the CPU the blocked first batch's loss equals
    the standard layout's on the same pairs (FWD_TOL)."""
    import dataclasses

    from pretrain_gnns_tpu_torch.train import pretrain

    tag = f"[{path_name(cfg)} loader]"
    blocked = pretrain.build_loader(cfg, pairs, dev)
    standard = pretrain.build_loader(
        dataclasses.replace(cfg, packing="standard"), pairs, dev)
    if blocked.blocks is None or standard.blocks is not None:
        raise AssertionError(f"{tag} layouts {blocked.blocks}, "
                             f"{standard.blocks}")
    print(f"{tag} presampled {pairs.variants} variants of "
          f"{len(pairs.graphs)} graphs in {pairs.seconds:.2f} s on the host "
          f"({[len(f) for f in pairs.sub]} pairs); geometry (n_blocks, "
          f"block_nodes, block_edges): substructures {blocked.blocks[0]}, "
          f"contexts {blocked.blocks[1]}", flush=True)
    t = time.perf_counter()
    first = list(blocked)
    ms = (time.perf_counter() - t) * 1e3 / len(first)
    v, ids, placement = next(blocked._iter_blocked())
    model = pretrain.build_objective(cfg)
    with torch.no_grad():
        a = float(model(blocked._batch_blocked(v, ids, placement).to("cpu"),
                        train=True)[0])
        b = float(model(standard._batch(v, ids).to("cpu"), train=True)[0])
    err = abs(a - b) / max(1.0, abs(b))
    print(f"{tag} {len(first)} blocked batches an epoch, "
          f"{blocked.last_epoch_stats['edges']} valid edges (both streams), "
          f"host ms a batch (walk and pack) {ms:.3f}; the first batch's "
          f"loss on the CPU blocked {a:.6f}, standard {b:.6f}, rel err "
          f"{err:.3e} (limit {FWD_TOL:.0e}) "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)
    if not err <= FWD_TOL:
        raise AssertionError(f"{tag} the blocked batch's loss differs from "
                             "the standard layout's")
    return first[0]


def trunk_launches(torch, pair, cfg, per_step):
    """Each trunk's launches, counted apart on the card (not part of a
    path's run): the substructure trunk's forward and backward on its
    stream, then the context trunk's on its own, must launch each kernel
    of ``per_step`` LAYERS and CONTEXT_LAYERS times."""
    from pretrain_gnns_tpu_torch.train import pretrain

    model = pretrain.build_objective(cfg).to("cuda")
    on_card = pair.to("cuda")
    modules = counted_modules()
    seen = {}
    for name, trunk, g, layers in (
            ("substructure", model.gnn_substruct, on_card.substruct, LAYERS),
            ("context", model.gnn_context, on_card.context, CONTEXT_LAYERS)):
        for m in modules:
            m.reset_launches()
        trunk(g, train=True).sum().backward()
        counts = read_counts(modules)
        # the probe runs once a process, at the first library's load
        seen[name] = {k: v for k, v in counts.items()
                      if v and k != "probe_scale2"}
        if seen[name] != {k: layers for k in per_step}:
            raise AssertionError(f"{path_name(cfg)}: the {name} trunk "
                                 f"launched {seen[name]}")
    print(f"[{path_name(cfg)} trunks] launches of one forward and backward "
          f"each, counted apart: {seen}", flush=True)


def contextpred_section(torch, card, chem_graphs_of, bio_graphs):
    """Context prediction in chem (cbow; a skipgram agreement step) and in
    bio (l1 1, center): the presampled pairs, the pair loader's phase, a
    float32 agreement step refereed by a float64 CPU step (the scores are
    300-term dot products, as edge prediction's), the 48-step path with
    both trunks' launches counted, its capture phase, and the same at the
    knobs' defaults (the bfloat16 kernels on float32 rows): agreement,
    path with its rate beside float32, capture. The bio float32 agreement
    step takes BIO_REFEREE_LAYERS layers of the substructure trunk (its
    float64 referee at 5 took 40 s); the bfloat16 one, which holds a
    control, all 5. Returns each path's float32 rate by name."""
    import dataclasses

    from pretrain_gnns_tpu_torch.train import pretrain

    dev = torch.device("cuda")
    base = dict(objective="contextpred", num_layer=LAYERS, emb_dim=EMB,
                batch_size=BATCH, seed=0, packing="auto", csize=3,
                mode="cbow", l1=1, center=True)
    rates = {}
    for domain, per_step in (("chem", CP_K1), ("bio", CP_BIO_K2)):
        cfg = host_config(domain=domain, **base)
        graphs = (chem_graphs_of(CP_CHEM_GRAPHS) if domain == "chem"
                  else bio_graphs)
        pairs = pretrain.presample_context(cfg, graphs)
        first = pair_loader_phase(torch, pairs, cfg, dev)
        describe_pair(f"data {path_name(cfg)}", first)
        trunk_launches(torch, first, cfg, per_step)
        agreement_phase(torch, first, referee_depth(cfg), referee=True,
                        noise_samples=CP_NOISE_SAMPLES)
        if domain == "chem":
            agreement_phase(torch, first,
                            dataclasses.replace(cfg, mode="skipgram"),
                            referee=True, noise_samples=CP_NOISE_SAMPLES)
        rate = rates[path_name(cfg)] = main_path_phase(
            torch, pairs, cfg, card, per_step)[4]
        capture_phase(torch, pairs, cfg, per_step)
        with precision("float32", "bfloat16"):
            bf16_agreement(torch, first, cfg)
            default = main_path_phase(torch, pairs, cfg, card, per_step,
                                      precision="default")[4]
            capture_phase(torch, pairs, cfg, per_step,
                          kernel_names=BF16_KERNEL_NAMES,
                          absent_names=BF16_ABSENT_NAMES)
        print(f"[{path_name(cfg)}] {LAYERS} + {CONTEXT_LAYERS} layers a "
              f"step: {per_step} launches a step; {default:.1f} valid "
              f"edges/s (both streams) at the knobs' defaults against "
              f"{rate:.1f} in float32 ({default / rate:.3f}x), on {card} "
              f"[{time.perf_counter() - T0:.0f} s]", flush=True)
    return rates


# --- fine-tuning from a pretrained trunk -------------------------------------

FT_EPOCHS = 3
# the CLI runs at full width (GIN 5 x 300, the protocol's batch of 32 graphs,
# dropout 0.5, the CLI's split seed 42): chem on 4,000 synthetic molecules
# (scaffold split), bio on 16,384 // 4 = 4,096 ego-networks (species split)
FT_RUNS = {"chem": ["--dataset", "synthetic", "--n_synthetic", "4000"],
           "bio": ["--domain", "bio", "--dataset", "synthetic_bio",
                   "--n_synthetic", "16384"]}
# train steps a profiled call runs, after the run, for the busy share
FT_PROFILED_STEPS = 16


def fwd_only(per_step):
    """The forward counters of ``per_step``: what an eval batch launches."""
    return {k: v for k, v in per_step.items() if "_fwd" in k}


def write_trunk(model, directory, name):
    """The path's trained trunk through the port's writer; returns the
    file."""
    import pathlib

    from pretrain_gnns_tpu_torch.train.checkpoints import (
        save_trunk_reference_format,
    )

    path = pathlib.Path(directory) / f"{name}.pth"
    save_trunk_reference_format(model.gnn, path)
    print(f"[trunk] the {name} path's trunk, "
          f"{len(model.gnn.state_dict())} tensors, written in the legacy "
          "format", flush=True)
    return path


def finetune_data(domain):
    """The CLI's flags, task count and splits for ``FT_RUNS[domain]``:
    ``(args, num_tasks, (train, valid, test, extra test sets))``."""
    from pretrain_gnns_tpu_torch.cli import finetune as ft_cli
    from pretrain_gnns_tpu_torch.data.datasets import load_dataset

    args = ft_cli.build_parser().parse_args(FT_RUNS[domain])
    graphs, scaffolds, meta = load_dataset(args.dataset, args.data_root,
                                           args.n_synthetic, args.seed)
    if args.domain == "bio":
        args.split = "species"
    return args, meta["num_tasks"], ft_cli.split_dataset(args, graphs,
                                                         scaffolds)


def describe_finetune(tag, first, last):
    """The first train batch's valid nodes, edges and blocks; the last
    eval batch's empty graph slots and blocks without a valid node."""
    import numpy as np

    nm = np.asarray(last.node_mask).reshape(-1, last.block_nodes)
    gm = np.asarray(last.graph_mask)
    print(f"{tag} first train batch: {int(np.asarray(first.graph_mask).sum())}"
          f" graphs, N = {int(np.asarray(first.node_mask).sum())} valid rows "
          f"of {first.max_nodes}, E = {int(np.asarray(first.edge_mask).sum())}"
          f" valid edges of {first.max_edges}, "
          f"{first.max_nodes // first.block_nodes} blocks of "
          f"({first.block_nodes}, {first.block_edges}); last validation "
          f"batch: {int(gm.sum())} graphs, {int((~gm).sum())} empty graph "
          f"slots, {int((~nm.any(axis=1)).sum())} of {nm.shape[0]} blocks "
          "without a valid node", flush=True)


def finetune_agreement(torch, domain, gnn_type, num_tasks, splits, trunk):
    """Float32 at dropout 0, from the same weights (the trunk ``trunk``
    grafted where given, else the seeded draws) and batches: one
    fine-tune train step on the first train batch (loss, every gradient,
    the batch-norm statistics) and one eval pass over the partly empty
    last validation batch (the valid slots' logits), on the card
    (kernels) against the CPU (plain versions), at the masking steps'
    limits; each launch counted, the step's and the pass's apart."""
    from pretrain_gnns_tpu_torch.train import finetune

    tag = f"[{domain} {gnn_type} finetune agreement]"
    cfg = finetune.FinetuneConfig(
        domain=domain, num_tasks=num_tasks, num_layer=LAYERS, emb_dim=EMB,
        dropout_ratio=0.0, gnn_type=gnn_type)
    train_loader, evals = finetune.build_loaders(cfg, *splits[:3], splits[3],
                                                 "cuda")
    first, last = next(iter(train_loader)), list(evals["val"])[-1]
    describe_finetune(tag, first, last)
    if last.graph_mask.all():
        raise AssertionError(f"{tag} the last validation batch is full")
    modules = counted_modules()

    def run(dev):
        counts = []
        for m in modules:
            m.reset_launches()
        st = finetune.init_state(cfg, finetune.build_model(cfg), trunk, dev)
        loss = finetune.make_train_step(cfg.loss_kind)(st, first.to(dev))
        counts.append(read_counts(modules))
        st_eval = finetune.init_state(cfg, finetune.build_model(cfg), trunk,
                                      dev)
        out = finetune.make_eval_step()(st_eval, last.to(dev))
        counts.append(read_counts(modules))
        return (float(loss),
                {n: p.grad.detach().cpu()
                 for n, p in st.model.named_parameters()},
                {n: b.detach().cpu().float()
                 for n, b in st.model.named_buffers()},
                out.cpu()[torch.as_tensor(last.graph_mask)], counts)

    (lc, gc, bc, oc, (tc, ec)), (lp, gp, bp, op, _) = run("cuda"), run("cpu")
    per_step = {"gin": BIO_K2 if domain == "bio" else K1, "gat": K4}[gnn_type]
    ec = {k: v - tc[k] for k, v in ec.items()}
    for counts, want in ((tc, per_step), (ec, fwd_only(per_step))):
        got = {k: v for k, v in counts.items() if v and k != "probe_scale2"}
        if got != want:
            raise AssertionError(f"{tag} launched {got}, not {want}")
    loss_err = abs(lc - lp) / max(1.0, abs(lp))
    grad_err = max(rel_err(gc[n], gp[n]) for n in gp)
    stat_err = max(rel_err(bc[n], bp[n]) for n in bp)
    out_err = rel_err(oc, op)
    print(f"{tag} train step: loss cuda={lc:.6f} cpu={lp:.6f} rel err "
          f"{loss_err:.3e}; max grad rel err {grad_err:.3e} (limit "
          f"{STEP_GRAD_TOL:.0e}); max BN stat rel err {stat_err:.3e}; eval "
          f"pass over the last validation batch: {oc.shape[0]} valid "
          f"slots' logits rel err {out_err:.3e} (limit "
          f"{STEP_LOSS_TOL:.0e}); launches: train step "
          f"{ {k: v for k, v in tc.items() if v} }, eval pass "
          f"{ {k: v for k, v in ec.items() if v} } "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)
    if not (loss_err <= STEP_LOSS_TOL and grad_err <= STEP_GRAD_TOL
            and stat_err <= STEP_GRAD_TOL and out_err <= STEP_LOSS_TOL
            and math.isfinite(lc)):
        raise AssertionError(f"{tag} the card disagrees with the CPU")
    return {"run": f"{domain} {gnn_type} fine-tune agreement (one train "
                   "step and one eval pass, float32, eager)",
            "precision": "float32",
            "counts": {k: v + ec[k] for k, v in tc.items()},
            "per_train_step": per_step, "per_eval_batch": fwd_only(per_step),
            "train_steps": 1, "eval_batches": 1}


def finetune_cli_phase(torch, card, domain, trunk, run_dir):
    """``cli.finetune.main`` on the card from the written ``trunk``: 3
    epochs at full width and the knobs' defaults, every launch counted
    (K1 or K2 at 5 a train step each way and 5 forwards an eval batch);
    the grafted trunk equals the file before the first step; the curves
    are finite. Then, on the run's final state, FT_PROFILED_STEPS train
    steps and one validation pass under ``torch.profiler``: the card's
    busy share of each."""
    import itertools

    from pretrain_gnns_tpu_torch.cli import finetune as ft_cli
    from pretrain_gnns_tpu_torch.train import finetune

    tag = f"[{domain} finetune]"
    per_step = BIO_K2 if domain == "bio" else K1
    seen = {}
    real_init, real_run = finetune.init_state, finetune.run_finetune

    def init_state(*args, **kw):
        st = real_init(*args, **kw)
        want = torch.load(trunk, map_location="cpu", weights_only=True)
        got = {k: v.cpu() for k, v in st.model.gnn.state_dict().items()}
        same = sorted(got) == sorted(want) and all(
            got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
            for k in want)
        print(f"{tag} trunk before the first step: {len(got)} tensors, "
              f"{'equal to' if same else 'NOT equal to'} the file's "
              f"{len(want)}", flush=True)
        if not same:
            raise AssertionError(f"{tag} the grafted trunk is not the file")
        seen["trunk"] = len(want)
        return st

    def run_finetune(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        seen["res"] = real_run(*args, **kw)
        return seen["res"]

    modules = counted_modules()
    finetune.init_state, finetune.run_finetune = init_state, run_finetune
    try:
        for m in modules:
            m.reset_launches()
        with precision("float32", "bfloat16"):
            out = ft_cli.main([*FT_RUNS[domain], "--epochs", str(FT_EPOCHS),
                               "--input_model_file", str(trunk),
                               "--run_dir", str(run_dir), "--device", "cuda"])
        counts = read_counts(modules)
    finally:
        finetune.init_state, finetune.run_finetune = real_init, real_run
    res, hist = seen["res"], seen["res"]["history"]
    steps = sum(h["steps"] for h in hist)
    evals = sum(h["eval_batches"] for h in hist)
    want = {k: per_step.get(k, 0) * steps
            + fwd_only(per_step).get(k, 0) * evals for k in counts}
    if counts != want or "trunk" not in seen:
        raise AssertionError(f"{tag} launches {counts} != {want} ({steps} "
                             f"train steps, {evals} eval batches)")
    curves = {k: v for k, v in res["curves"].items()}
    if not all(math.isfinite(v) for c in curves.values() for v in c):
        raise AssertionError(f"{tag} non-finite curves {curves}")
    if not (1 <= out["best_epoch"] <= FT_EPOCHS
            and 0.0 <= out["test_auc"] <= 1.0):
        raise AssertionError(f"{tag} result {out}")
    later = hist[1:]
    rate = sum(h["edges"] for h in later) / sum(h["train_seconds"]
                                                for h in later)
    eval_rate = sum(h["eval_graphs"] for h in later) / sum(
        h["eval_seconds"] for h in later)
    fmt = lambda c: " ".join(f"{v:.4f}" for v in c)  # noqa: E731
    print(f"{tag} cli.finetune {' '.join(FT_RUNS[domain])} --epochs "
          f"{FT_EPOCHS} --input_model_file <trunk> (knobs' defaults: "
          f"float32 model, bfloat16 kernels): per epoch "
          f"{[h['steps'] for h in hist]} train steps and "
          f"{[h['eval_batches'] for h in hist]} eval batches "
          f"({[h['eval_graphs'] for h in hist]} graphs); "
          + "; ".join(f"{k} {fmt(v)}" for k, v in curves.items())
          + f"; best epoch {out['best_epoch']}, test AUC "
          f"{out['test_auc']:.4f}; launches "
          f"{ {k: v for k, v in counts.items() if v} }: a train step "
          f"{per_step}, an eval batch {fwd_only(per_step)}; "
          f"{rate:.1f} valid edges/s and {eval_rate:.1f} eval graphs/s over "
          f"epochs 2-{FT_EPOCHS} on {card} "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)

    # the card's busy share of eager fine-tune steps and of an eval pass
    cfg, state = seen["args"][0], res["state"]
    train_loader, evals_of = finetune.build_loaders(
        cfg, *seen["args"][1:4], seen["kw"].get("extra_test"), "cuda")
    dev = torch.device("cuda")
    host = [b.pin_memory() for b in itertools.islice(
        train_loader, FT_PROFILED_STEPS + 1)]
    step = finetune.make_train_step(cfg.loss_kind)
    shares = {}
    with precision("float32", "bfloat16"):
        step(state, host[0].to(dev))
        for name, fn, n in (
                ("train steps", lambda: [step(state, b.to(
                    dev, non_blocking=True)) for b in host[1:]],
                 FT_PROFILED_STEPS),
                ("validation batches (one pass)", lambda: finetune.evaluate(
                    finetune.make_eval_step(), state, evals_of["val"],
                    "bio_auc" if domain == "bio" else "chem_auc"),
                 len(evals_of["val"]))):
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                t = time.perf_counter() - t
            shares[name] = (busy_ms(p), t * 1e3, n)
    print(f"{tag} profiled on the run's final state: " + "; ".join(
        f"{n} {name}: the card busy {b:.3f} ms of {w:.3f} ms "
        f"({100 * b / w:.1f}%), {w / n:.3f} ms each"
        for name, (b, w, n) in shares.items())
        + f" [{time.perf_counter() - T0:.0f} s]", flush=True)
    return {"run": f"{domain} gin cli.finetune ({FT_EPOCHS} epochs, knobs' "
                   "defaults, eager)",
            "precision": "default", "counts": counts,
            "per_train_step": per_step, "per_eval_batch": fwd_only(per_step),
            "train_steps": steps, "eval_batches": evals}


def finetune_section(torch, card, trunks, run_dir):
    """Fine-tuning from the masking paths' trunks: the float32 agreement of
    chem GIN and bio GIN (from the trunks) and chem GAT (K4, seeded
    weights), then ``cli.finetune`` in chem and bio at the knobs'
    defaults. Returns each run's launches for the ``kernels`` line."""
    from pretrain_gnns_tpu_torch.train.checkpoints import load_trunk_any

    runs = []
    for domain in ("chem", "bio"):
        args, tasks, splits = finetune_data(domain)
        print(f"[{domain} finetune data] {args.dataset}, {tasks} tasks, "
              f"{args.split} split: {[len(s) for s in splits[:3]]} "
              "train/valid/test graphs"
              + (f", {[len(v) for v in splits[3].values()]} hard test"
                 if splits[3] else ""), flush=True)
        trunk = load_trunk_any(trunks[domain])
        runs.append(finetune_agreement(torch, domain, "gin", tasks, splits,
                                       trunk))
        if domain == "chem":
            runs.append(finetune_agreement(torch, domain, "gat", tasks,
                                           splits, None))
    for domain in ("chem", "bio"):
        runs.append(finetune_cli_phase(torch, card, domain, trunks[domain],
                                       run_dir))
    return runs


def record_finetune(entries, runs):
    """Adds each fine-tune run's launches to the ``kernels`` entries of the
    variants it ran (the bfloat16 ones at the knobs' defaults), under
    ``finetune``: the calls counted, the train steps and eval batches
    that made them and the calls each of those makes."""
    for run in runs:
        for k in entries:
            key = k.get("counter", k["name"])
            if (run["counts"].get(key) and ("[bf16]" in k["name"])
                    == (run["precision"] == "default")):
                k.setdefault("finetune", []).append({
                    "run": run["run"], "launches": run["counts"][key],
                    "train_steps": run["train_steps"],
                    "eval_batches": run["eval_batches"],
                    "launches_per_train_step":
                        run["per_train_step"].get(key, 0),
                    "launches_per_eval_batch":
                        run["per_eval_batch"].get(key, 0)})


# --- step checkpoints with resume, on the dataset store ----------------------

# the uninterrupted run's epochs; the interrupted run stops one epoch
# before and a fresh run resumes it to the same end
RESUME_EPOCHS = {"chem": 3, "bio": 2}
RESUME_DATASETS = {"chem": "chem_masking_4096", "bio": "bio_masking_4096"}


class _Tee:
    """Standard output that also keeps its lines."""

    def __init__(self, out):
        self.out, self.lines, self._part = out, [], ""

    def write(self, text):
        self.out.write(text)
        self._part += text
        *done, self._part = self._part.split("\n")
        self.lines += done
        return len(text)

    def flush(self):
        self.out.flush()


def store_dataset(root, domain, graphs, scaffolds):
    """The path's graphs (and scaffolds) written under ``root`` with the
    port's ``save_graphs``, read back with ``load_graphs`` (timed) and
    checked equal, every array and extra."""
    import numpy as np

    from pretrain_gnns_tpu_torch.data import datasets

    name = RESUME_DATASETS[domain]
    d = datasets.processed_dir(root, name)
    t = time.perf_counter()
    datasets.save_graphs(graphs, d, scaffolds=scaffolds,
                         meta={"dataset": name, "domain": domain})
    t_save = time.perf_counter() - t
    t = time.perf_counter()
    back, back_scaffolds, meta = datasets.load_graphs(d)
    t_load = time.perf_counter() - t
    same = len(back) == len(graphs) and back_scaffolds == scaffolds and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for a, b in zip(graphs, back)
        for f in ("node_feat", "edge_index", "edge_feat", "y"))
    same = same and all(
        a.extras.keys() == b.extras.keys() and all(
            a.extras[k][1] == b.extras[k][1]
            and np.array_equal(a.extras[k][0], b.extras[k][0])
            for k in a.extras)
        for a, b in zip(graphs, back))
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    print(f"[{domain} store] {len(graphs)} graphs, extras "
          f"{meta['extra_kinds']}, written in {t_save:.3f} s, "
          f"{size} bytes; load_graphs {t_load:.3f} s; read back "
          f"{'equal' if same else 'NOT equal'}", flush=True)
    if not same:
        raise AssertionError(f"[{domain} store] the graphs read back differ")
    return name, t_load


def resume_phase(torch, card, domain, root, per_step):
    """``cli.pretrain.main`` on the stored dataset at full width and the
    knobs' defaults: once uninterrupted for RESUME_EPOCHS[domain] epochs
    with a checkpoint each epoch, once for one epoch less in another
    directory, then a fresh call to the full count in that directory,
    which must resume. Each call's launches counted; the resumed run's
    state (parameters, batch-norm statistics, Adam's moments and steps,
    the step, the dropout generators) and trunk file must equal the
    uninterrupted run's bit for bit. Returns the resumed trunk's file."""
    import re

    from pretrain_gnns_tpu_torch.cli import pretrain as pt_cli
    from pretrain_gnns_tpu_torch.train import checkpoints, pretrain

    tag = f"[{domain} resume]"
    epochs = RESUME_EPOCHS[domain]
    name = RESUME_DATASETS[domain]
    mgr_cls = checkpoints.CheckpointManager
    real_run, real_save, real_restore = (pretrain.run_pretrain,
                                         mgr_cls.save, mgr_cls.restore)
    saves, restores = [], []

    def timed(fn, into):
        def call(self, *args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, *args, **kw)
            into.append((time.perf_counter() - t) * 1e3)
            return out
        return call

    modules = counted_modules()

    def run(label, ck, n_epochs):
        seen = {}

        def run_pretrain(*args, **kw):
            seen["res"] = real_run(*args, **kw)
            return seen["res"]

        trunk = os.path.join(root, f"{domain}_{label}")
        argv = ["--domain", domain, "--dataset", name, "--data_root", root,
                "--epochs", str(n_epochs), "--checkpoint_dir", ck,
                "--checkpoint_every", "1", "--output_model_file", trunk,
                "--device", "cuda"]
        for m in modules:
            m.reset_launches()
        tee = _Tee(sys.stdout)
        pretrain.run_pretrain = run_pretrain
        mgr_cls.save = timed(real_save, saves)
        mgr_cls.restore = timed(real_restore, restores)
        try:
            with precision("float32", "bfloat16"), \
                    contextlib.redirect_stdout(tee):
                pt_cli.main(argv)
        finally:
            pretrain.run_pretrain = real_run
            mgr_cls.save, mgr_cls.restore = real_save, real_restore
        counts = read_counts(modules)
        res = seen["res"]
        counted = res["eager_steps"] + res["scan_steps"] * bool(
            res["replays"])
        want = {k: per_step.get(k, 0) * counted for k in counts}
        want["probe_scale2"] = counts.get("probe_scale2", 0)
        if counts != want:
            raise AssertionError(f"{tag} {label}: launches {counts} != "
                                 f"{want}")
        # the last epoch's edges/s and replays, from its log line
        last = [m.groups() for line in tee.lines for m in [re.search(
            r"edges/s=([0-9.]+) replays=([0-9]+)", line)] if m][-1]
        return (res, trunk + ".pth", (float(last[0]), int(last[1])),
                tee.lines, counted)

    whole_dir, part_dir = (os.path.join(root, f"{domain}_ck_{k}")
                           for k in ("whole", "part"))
    t0 = time.perf_counter()
    whole, whole_trunk, whole_last, _, _ = run("whole", whole_dir, epochs)
    part, _, _, _, _ = run("part", part_dir, epochs - 1)
    n_saves = len(saves)
    resumed, resumed_trunk, last, lines, counted = run("resumed", part_dir,
                                                       epochs)
    seconds = time.perf_counter() - t0
    steps_before = part["state"].step
    note = f"resumed from step {steps_before} (epoch {epochs})"
    if note not in lines or resumed["start_epoch"] != epochs:
        raise AssertionError(f"{tag} the resumed run did not log '{note}'")
    a, b = whole["state"].state_dict(), resumed["state"].state_dict()
    diffs = []
    if (a["step"], a["epoch"]) != (b["step"], b["epoch"]):
        diffs.append(("step, epoch", (a["step"], a["epoch"]),
                      (b["step"], b["epoch"])))
    diffs += [n for n, v in a["model"].items()
              if not torch.equal(v, b["model"][n])]
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    diffs += [f"adam {i}.{k}" for i in sa for k, v in sa[i].items()
              if not torch.equal(v, sb[i][k])]
    diffs += [f"dropout {n}" for n, st in a["dropout"].items()
              if st.keys() != b["dropout"][n].keys() or not all(
                  torch.equal(v, b["dropout"][n][dev])
                  for dev, v in st.items())]
    ta, tb = (checkpoints.load_trunk_any(p) for p in (whole_trunk,
                                                      resumed_trunk))
    diffs += [f"trunk {k}" for k in ta if not torch.equal(ta[k], tb[k])]
    if resumed["history"] != whole["history"][epochs - 1:]:
        diffs.append("history")
    latest = checkpoints.CheckpointManager(part_dir)
    size = os.path.getsize(latest.path(latest.latest_step()))
    print(f"{tag} cli.pretrain --dataset {name} --data_root <root> "
          f"(knobs' defaults): {epochs} epochs uninterrupted, {epochs - 1} "
          f"then a fresh call resumed to {epochs} ({note}); resumed state "
          f"{len(a['model'])} tensors, {sum(len(m) for m in sa.values())} "
          f"Adam tensors, step {b['step']}, trunk {len(tb)} tensors: "
          + ("bit-equal to the uninterrupted run's" if not diffs else
             f"DIFFERENT in {diffs[:8]}")
          + f"; launches a step {per_step} ({counted} counted steps in the "
          f"resumed call: {resumed['eager_steps']} eager, "
          f"{resumed['replays']} replays); checkpoint {size} bytes, "
          f"save {statistics.median(saves):.1f} ms (median of {len(saves)}; "
          f"{n_saves} before the resume), restore {restores[0]:.1f} ms; "
          f"resumed epoch {last[0]:.1f} valid edges/s ({last[1]} replays) "
          f"against {whole_last[0]:.1f} in the uninterrupted run's epoch "
          f"{epochs} ({whole_last[1]} replays); "
          f"{seconds:.1f} s on {card} [{time.perf_counter() - T0:.0f} s]",
          flush=True)
    if diffs:
        raise AssertionError(f"{tag} the resumed run differs: {diffs}")
    return resumed_trunk


def finetune_stored(torch, card, root, trunk):
    """``cli.finetune.main`` on the stored chem dataset from the resumed
    trunk: 1 epoch at the phase-28 settings (full width, batch 32, dropout
    0.5, the knobs' defaults), the scaffold split of the stored
    scaffolds.txt, K1 at 5 a train step each way and 5 forwards an eval
    batch, the curves finite."""
    from pretrain_gnns_tpu_torch.cli import finetune as ft_cli
    from pretrain_gnns_tpu_torch.data import datasets, splitters
    from pretrain_gnns_tpu_torch.train import finetune

    tag = "[chem stored finetune]"
    name = RESUME_DATASETS["chem"]
    with open(os.path.join(datasets.processed_dir(root, name),
                           "scaffolds.txt")) as f:
        stored = f.read().split("\n")
    seen = {}
    real_split, real_run = ft_cli.split_dataset, finetune.run_finetune

    def split_dataset(args, graphs, scaffolds):
        seen["scaffolds"] = scaffolds
        seen["splits"] = real_split(args, graphs, scaffolds)
        return seen["splits"]

    def run_finetune(*args, **kw):
        seen["res"] = real_run(*args, **kw)
        return seen["res"]

    modules = counted_modules()
    for m in modules:
        m.reset_launches()
    ft_cli.split_dataset, finetune.run_finetune = split_dataset, run_finetune
    t = time.perf_counter()
    try:
        with precision("float32", "bfloat16"):
            out = ft_cli.main(["--dataset", name, "--data_root", root,
                               "--input_model_file", str(trunk), "--epochs",
                               "1", "--run_dir", os.path.join(root, "ft"),
                               "--device", "cuda"])
    finally:
        ft_cli.split_dataset, finetune.run_finetune = real_split, real_run
    seconds = time.perf_counter() - t
    counts = read_counts(modules)
    sizes = [len(g) for g in seen["splits"][:3]]
    if seen["scaffolds"] != stored or [
            len(i) for i in splitters.scaffold_split(stored)] != sizes:
        raise AssertionError(f"{tag} the split is not the scaffold split of "
                             "the stored scaffolds")
    hist = seen["res"]["history"]
    steps = sum(h["steps"] for h in hist)
    evals = sum(h["eval_batches"] for h in hist)
    want = {k: K1.get(k, 0) * steps + fwd_only(K1).get(k, 0) * evals
            for k in counts}
    want["probe_scale2"] = counts.get("probe_scale2", 0)
    if counts != want:
        raise AssertionError(f"{tag} launches {counts} != {want} ({steps} "
                             f"train steps, {evals} eval batches)")
    curves = [out["val"], out["test"], out["train_loss"]]
    if not all(math.isfinite(v) for c in curves for v in c) or not (
            0.0 <= out["test_auc"] <= 1.0):
        raise AssertionError(f"{tag} result {out}")
    print(f"{tag} cli.finetune --dataset {name} --data_root <root> "
          f"--input_model_file <resumed trunk> --epochs 1: scaffold split "
          f"{sizes} of the stored scaffolds.txt; launches "
          f"{ {k: v for k, v in counts.items() if v} } ({steps} train "
          f"steps, {evals} eval batches); val AUC {out['val'][0]:.4f}, test "
          f"AUC {out['test_auc']:.4f}; {seconds:.1f} s on {card} "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)


def resume_section(torch, card, chem_graphs, chem_scaffolds, bio_graphs):
    """The chem and bio masking paths' graphs written to a temporary
    ``--data_root`` with the port's store; ``cli.pretrain`` on them with
    step checkpoints, interrupted and resumed (chem: 3 epochs against 2 +
    1, K1; bio: 2 against 1 + 1, K2 ``[x]`` and ``[ein]``; the knobs'
    defaults), bit-equal to the uninterrupted runs; ``cli.finetune`` from
    the resumed chem trunk on the stored chem dataset."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as root:
        loads = {}
        for domain, graphs, scaffolds in (
                ("chem", chem_graphs, chem_scaffolds),
                ("bio", bio_graphs, None)):
            loads[domain] = store_dataset(root, domain, graphs,
                                          scaffolds)[1]
        trunk = resume_phase(torch, card, "chem", root, K1)
        resume_phase(torch, card, "bio", root, BIO_K2)
        finetune_stored(torch, card, root, trunk)
    print(f"[resume] load_graphs chem {loads['chem']:.3f} s, bio "
          f"{loads['bio']:.3f} s; section {time.perf_counter() - t0:.1f} s "
          f"on {card} [{time.perf_counter() - T0:.0f} s]", flush=True)


# --- the per-graph host transforms (transform_device="host") ---------------

# (domain, objective, launches a step): chem masking GIN on K1, bio edge
# prediction GIN on K2 [x], [ein] and K3 (on the per-graph negatives moved
# into the block slots), chem context prediction GIN on K1 (both trunks,
# every pair drawn anew each epoch)
HOST_PATHS = (("chem", "masking", K1), ("bio", "edgepred", {**BIO_K2, **K3}),
              ("chem", "contextpred", CP_K1))


def host_loader_phase(torch, cfg, graphs, dev):
    """The host loader's first epoch on one thread (the per-graph
    transform and the packing, ms a batch), each batch blocked on one
    layout; the edge-prediction batches carry their negatives in the
    block slots only. Returns the first batch and the ms a batch."""
    from pretrain_gnns_tpu_torch.train import pretrain

    tag = f"[{path_name(cfg)} loader]"
    loader = pretrain.build_loader(cfg, graphs, dev)
    t = time.perf_counter()
    batches = list(loader)
    ms = (time.perf_counter() - t) * 1e3 / len(batches)
    layouts = {b.layout for b in batches}
    streams = ((batches[0].substruct, batches[0].context)
               if cfg.objective == "contextpred" else (batches[0],))
    if len(layouts) != 1 or not all(g.block_nodes > 0 for g in streams):
        raise AssertionError(f"{tag} layouts {layouts}")
    if cfg.objective == "edgepred":
        for b in batches:
            ex = b.extras
            if "negative_edges" in ex or not ex[
                    "negative_edges_blocked_mask"].any():
                raise AssertionError(f"{tag} the negatives are not in the "
                                     "block slots")
    print(f"{tag} {type(loader).__name__}: {len(batches)} batches, "
          f"{loader.last_epoch_stats['edges']} valid edges, blocks "
          f"{loader.blocks}; host ms a batch (the per-graph transform and "
          f"the packing, one thread) {ms:.3f} "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)
    return batches[0], ms


def record_host(entries, name, launched):
    """Adds a host path's launches to the float32 ``kernels`` entries of
    the kernels it ran, under ``host_paths``."""
    counts, steps = launched[:2]
    for k in entries:
        key = k.get("counter", k["name"])
        if counts.get(key) and "[bf16]" not in k["name"]:
            k.setdefault("host_paths", []).append({
                "path": name, "launches": counts[key],
                "launches_per_step": counts[key] // steps,
                "replays": launched[3]})


def host_section(torch, card, chem_graphs_of, bio_graphs, batch_rates,
                 entries):
    """``transform_device="host"`` at full width, float32, K = 16 (the
    reference's per-graph transforms in the loader's prefetch thread): for
    each of HOST_PATHS the host loader's first epoch, the float32
    agreement step on its first batch (edge and context prediction
    refereed by a float64 CPU step, bio at BIO_REFEREE_LAYERS layers, the
    float32 noise from 1 + CP_NOISE_SAMPLES CPU steps: fewer samples can
    only lower the limit), the
    48-step path with its launches counted, its edges/s beside the same
    path's under "batch" from earlier in the run and the card's busy share
    of the timed epoch."""
    import dataclasses

    from pretrain_gnns_tpu_torch.train import pretrain

    dev = torch.device("cuda")
    for domain, objective, per_step in HOST_PATHS:
        cfg = host_config(
            objective=objective, domain=domain, num_layer=LAYERS,
            emb_dim=EMB, batch_size=BATCH, mask_edge=False, seed=0,
            packing="auto", csize=3, transform_device="host")
        graphs = (bio_graphs if domain == "bio" else chem_graphs_of(
            CP_CHEM_GRAPHS if objective == "contextpred" else MAIN_GRAPHS))
        first, host_ms = host_loader_phase(torch, cfg, graphs, dev)
        if objective == "contextpred":
            describe_pair(f"data {path_name(cfg)}", first)
        else:
            describe(f"data {path_name(cfg)}", first)
        agreement_phase(torch, first, referee_depth(cfg),
                        referee=objective != "masking",
                        noise_samples=CP_NOISE_SAMPLES)
        launched = main_path_phase(torch, graphs, cfg, card, per_step,
                                   profile=True)
        record_host(entries, path_name(cfg), launched)
        rate, busy, step_ms = launched[4], launched[6], launched[7]
        batch = batch_rates[path_name(dataclasses.replace(
            cfg, transform_device="auto"))]
        # the prefetch queue holds two groups of K batches: at 16 batches
        # an epoch, what the thread made during the eager epoch and the
        # capture feeds the timed epoch, so its rate is the card's; the
        # loader's ms a batch against the card's ms a step bounds a long
        # run's
        print(f"[{path_name(cfg)}] {rate:.1f} valid edges/s under host "
              f"against {batch:.1f} under batch ({rate / batch:.3f}x), the "
              f"card busy {100 * busy:.1f}% of the timed epoch, fed from "
              f"the prefetch queue; the loader's {host_ms:.3f} ms a batch "
              f"on one thread against the card's {step_ms:.3f} ms a "
              f"replayed step bounds a long run at "
              f"{min(1.0, step_ms / host_ms):.3f} of the card's rate; on "
              f"{card} [{time.perf_counter() - T0:.0f} s]", flush=True)


# --- the device-resident dataset ---------------------------------------------

# the device paths' float32 agreement steps: one on each of the first
# descriptors' batches
DEVICE_AGREE_DESCS = 2


# chem masking GIN on and off the card's dataset: (the epochs of a run,
# the epoch whose log line main_path_phase profiles from). On: the epoch
# trainer's default group, 8 epochs at 16 steps an epoch; group 1 logs
# after group 2 is queued, so group 3 is timed. Off: epochs 3-10. Both
# time 128 steps.
RESIDENT_RUNS = {"on": (24, 8), "off": (10, 2)}


def resident(cfg, **changes):
    """``cfg`` on the device-resident dataset, its epoch trainer at one
    epoch a group unless ``changes`` say otherwise (so that a run of
    MAIN_EPOCHS epochs has a mark after the capture's epoch and an epoch
    to time after it)."""
    import dataclasses

    return dataclasses.replace(cfg, **{"device_dataset": "on",
                                       "epoch_group": 1, **changes})


def leaves_equal(torch, a, b):
    """The leaves of two batches that differ (by name), bit for bit."""
    la, lb = a.leaves(), b.leaves()
    return sorted(set(la) ^ set(lb)) + [
        n for n in la if n in lb and not (
            la[n].dtype == lb[n].dtype and la[n].shape == lb[n].shape
            and torch.equal(la[n].cpu(), lb[n].cpu()))]


def resident_loader_phase(torch, cfg, graphs):
    """The device loader's first epoch (descriptor ms a batch on one
    thread), its first descriptor's batch built on the card against
    ``materialize`` of the same descriptor on the CPU (every leaf and
    extra, bit for bit) and every batch blocked on chunk multiples.
    Returns the loader and the CPU batches of its first descriptors."""
    import copy

    from pretrain_gnns_tpu_torch.train import pretrain

    tag = f"[{path_name(cfg)} loader]"
    dev = torch.device("cuda")
    loader = pretrain.build_loader(cfg, graphs, dev)
    t = time.perf_counter()
    descs = list(loader)
    ms = (time.perf_counter() - t) * 1e3 / len(descs)
    twin = copy.copy(loader)  # the same loader, its resident arrays on the CPU
    twin.dev = {k: v.cpu() for k, v in loader.dev.items()}
    cpu = [twin.prepare(d.to("cpu")) for d in descs[:DEVICE_AGREE_DESCS]]
    card = loader.prepare(descs[0].to(dev))
    differ = leaves_equal(torch, card, cpu[0])
    blocks = loader.blocks if cfg.objective != "contextpred" else None
    print(f"{tag} {type(loader).__name__}: {len(descs)} descriptors of "
          f"{sum(v.nbytes for v in descs[0].values())} bytes, "
          f"{loader.last_epoch_stats['edges']} valid edges, "
          f"{loader.last_epoch_stats['graphs_per_batch']:.1f} graphs a "
          f"batch, blocks {loader.blocks}; descriptor ms a batch (one "
          f"thread) {ms:.3f}; resident arrays "
          f"{sum(v.nbytes for v in loader.dev.values()) / 2**20:.1f} MiB; "
          f"the first batch built on the card against the CPU's: "
          f"{len(card.leaves())} leaves, differing {differ} "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)
    if differ:
        raise AssertionError(f"{tag} the card's batch differs in {differ}")
    if not type(loader).__name__.startswith("Device") or (
            blocks is not None and (blocks[1] % 8 or blocks[2] % 8)):
        raise AssertionError(f"{tag} {type(loader).__name__}, {blocks}")
    return loader, cpu


def mask_stream_phase(torch, graphs, cfg, per_step):
    """``transform_device="device"`` (the atoms masked inside the step,
    ``FusedMaskingObjective``) at lr 0, so that only the masks move a
    step's loss: after ``graphed.WARMUP_STEPS`` eager steps, two replays
    of one captured group of CAPTURE_K steps on the same descriptors must
    give different losses (each replay draws new masks from the
    registered mask stream), and the same run again from the same seed
    the same losses bit for bit; the group's launches counted."""
    from pretrain_gnns_tpu_torch.train import graphed, optim, pretrain
    from pretrain_gnns_tpu_torch.train.state import TrainState

    cfg = resident(cfg, transform_device="device", lr=0.0)
    tag = f"[{path_name(cfg)} mask stream]"
    dev = torch.device("cuda")
    loader = pretrain.build_loader(cfg, graphs, dev)
    descs = [d.to(dev) for d, _ in zip(loader, range(CAPTURE_K))]
    W = graphed.WARMUP_STEPS

    def run():
        model = pretrain.build_objective(cfg).to(dev)
        st = TrainState(model, optim.adam(model.parameters(), 0.0, 0.0))
        scan = pretrain.make_scan_pretrain_step(st, descs[0], CAPTURE_K,
                                                loader.prepare)
        for d in descs[:W]:
            scan.step(d)
        return [scan(descs)[0].cpu() for _ in range(2)]

    modules = counted_modules()
    for m in modules:
        m.reset_launches()
    first, again = run(), run()
    counts = {k: v for k, v in read_counts(modules).items() if v}
    print(f"{tag} {type(pretrain.build_objective(cfg)).__name__}: two "
          f"replays of {CAPTURE_K} steps on the same descriptors at lr 0: "
          f"losses {first[0].tolist()} and {first[1].tolist()}; the rerun "
          f"from the seed equal bit for bit: "
          f"{all(torch.equal(a, b) for a, b in zip(first, again))}; "
          f"launches (two runs) {counts} "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)
    if torch.equal(first[0], first[1]) or not all(
            torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{tag} the replays' masks do not move, or "
                             "do not repeat from the seed")
    want = {k: 2 * v * (W + CAPTURE_K) for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"{tag} launches {counts} != {want}")


def negatives_phase(torch, loader):
    """Edge prediction's negatives drawn on the card
    (``objectives.edgepred.sample_negative_edges``) on the first blocked
    batch, held to the sampler's properties: no self-loop, no existing
    directed edge, no repeat, both ends valid nodes of one graph, at most
    ``E_g // 2`` pairs a graph, each pair in its own block's slots."""
    import numpy as np

    from pretrain_gnns_tpu_torch.objectives.edgepred import (
        sample_negative_edges,
    )

    dev = torch.device("cuda")
    batch = loader.prepare(next(iter(loader)).to(dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    pairs, mask = (t.cpu().numpy() for t in sample_negative_edges(batch,
                                                                  gen))
    b = batch._map(lambda t: t.cpu())
    a_, b_ = pairs[mask, 0].astype(np.int64), pairs[mask, 1].astype(np.int64)
    N, half = b.max_nodes, b.block_edges // 2
    ng, nm = b.node_graph.numpy(), b.node_mask.numpy()
    em = b.edge_mask.numpy()
    edges = set((b.senders.numpy()[em].astype(np.int64) * N
                 + b.receivers.numpy()[em]).tolist())
    keys = a_ * N + b_
    per_graph = np.bincount(ng[a_], minlength=b.max_graphs)
    quota = np.bincount(ng[b.senders.numpy()[em]],
                        minlength=b.max_graphs) // 2
    block = np.nonzero(mask)[0] // half
    faults = {
        "self-loop": int((a_ == b_).sum()),
        "existing edge": sum(k in edges for k in keys.tolist()),
        "repeat": len(keys) - len(set(keys.tolist())),
        "padded node": int((~nm[a_] | ~nm[b_]).sum()),
        "two graphs": int((ng[a_] != ng[b_]).sum()),
        "over quota": int((per_graph > quota).sum()),
        "outside its block": int(((a_ // b.block_nodes != block)
                                  | (b_ // b.block_nodes != block)).sum()),
    }
    print(f"[negatives on the card] {int(mask.sum())} pairs drawn in the "
          f"step on the first batch ({int(em.sum()) // 2} bonds, "
          f"{pairs.shape[0]} slots in {b.max_edges // b.block_edges} "
          f"blocks); faults {faults} "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)
    if any(faults.values()) or not mask.any():
        raise AssertionError(f"negatives drawn on the card: {faults}")


def record_device(entries, name, launched):
    """Adds a device path's launches to the float32 ``kernels`` entries of
    the kernels it ran, under ``device_paths``."""
    counts, steps = launched[:2]
    for k in entries:
        key = k.get("counter", k["name"])
        if counts.get(key) and "[bf16]" not in k["name"]:
            k.setdefault("device_paths", []).append({
                "path": name, "launches": counts[key],
                "launches_per_step": counts[key] // steps,
                "replays": launched[3]})


def device_section(torch, card, chem_graphs, chem_graphs_of, bio_graphs,
                   entries):
    """The device-resident dataset (``device_dataset="on"``, batches built
    on the card from descriptors; the epoch trainer, K = 16): chem masking
    GIN at full width, its first batch built on the card against the
    CPU's, float32 agreement steps on the first DEVICE_AGREE_DESCS
    descriptors' batches, then the path with the dataset on (the epoch
    trainer at its default group) and off (RESIDENT_RUNS) in float32 and
    at the knobs' defaults, each with its launches, edges/s and the card's
    busy share over 128 timed steps on the card's clock (see
    main_path_phase); the mask stream under ``transform_device="device"``,
    and the paths below at one epoch a group; bio edge
    prediction GIN with its negatives drawn in the step (the sampler's
    properties on the card, then the path through K2 and K3); chem context
    prediction GIN through ``DeviceContextLoader`` (K1 on both trunks)."""
    from pretrain_gnns_tpu_torch.train import pretrain

    t0 = time.perf_counter()
    cfg = resident(host_config(
        num_layer=LAYERS, emb_dim=EMB, batch_size=BATCH, mask_edge=False,
        seed=0, packing="auto"))
    _, cpu = resident_loader_phase(torch, cfg, chem_graphs)
    for batch in cpu:
        agreement_phase(torch, batch, cfg)
    rates = {}
    for prec, kernels in (("float32", "float32"), ("default", "bfloat16")):
        with precision("float32", kernels):
            for mode in ("on", "off"):
                c = resident(cfg, device_dataset=mode, epoch_group=0)
                epochs, profile_from = RESIDENT_RUNS[mode]
                launched = main_path_phase(
                    torch, chem_graphs, c, card, K1, epochs, profile=True,
                    profile_from=profile_from, precision=prec)
                if prec == "float32":
                    record_device(entries, path_name(c), launched)
                rates[prec, mode] = launched[4], launched[6]
    for prec in ("float32", "default"):
        (on, busy_on), (off, busy_off) = rates[prec, "on"], rates[prec, "off"]
        print(f"[{path_name(cfg)}] {prec}: {on:.1f} valid edges/s with the "
              f"dataset on the card against {off:.1f} off ({on / off:.3f}x)"
              f"; the card busy {100 * busy_on:.1f}% and "
              f"{100 * busy_off:.1f}% of the timed steps' time; on {card}",
              flush=True)
    mask_stream_phase(torch, chem_graphs, cfg, K1)

    cfg = resident(host_config(
        objective="edgepred", domain="bio", num_layer=LAYERS, emb_dim=EMB,
        batch_size=BATCH, seed=0, packing="auto",
        transform_device="device"))
    loader, _ = resident_loader_phase(torch, cfg, bio_graphs)
    negatives_phase(torch, loader)
    record_device(entries, path_name(cfg), main_path_phase(
        torch, bio_graphs, cfg, card, {**BIO_K2, **K3}))

    cfg = resident(host_config(
        objective="contextpred", num_layer=LAYERS, emb_dim=EMB,
        batch_size=BATCH, seed=0, packing="auto", csize=3))
    pairs = pretrain.presample_context(cfg, chem_graphs_of(CP_CHEM_GRAPHS))
    resident_loader_phase(torch, cfg, pairs)
    record_device(entries, path_name(cfg), main_path_phase(
        torch, pairs, cfg, card, CP_K1))
    print(f"[device section] {time.perf_counter() - t0:.1f} s on {card} "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)


# --- data parallelism at a world of one --------------------------------------

# the per-step path's eager steps (3 epochs of 16) and the epoch trainer's
# run (RESIDENT_RUNS["on"]: 24 epochs, its default group of 8, groups 3
# timed)
DP_PER_STEP_EPOCHS = 3


def record_dp(entries, name, launched):
    """Adds a data-parallel path's launches to the float32 ``kernels``
    entries of the kernels it ran, under ``dp_paths``."""
    counts, steps = launched[:2]
    for k in entries:
        key = k.get("counter", k["name"])
        if counts.get(key) and "[bf16]" not in k["name"]:
            k.setdefault("dp_paths", []).append({
                "path": name, "world": 1, "launches": counts[key],
                "launches_per_step": counts[key] // steps,
                "replays": launched[3]})


def same_run(torch, a, b):
    """The names of the state entries (and ``history``) in which two runs
    differ, bit for bit."""
    sa, sb = a[0].state_dict(), b[0].state_dict()
    return (["history"] if a[1] != b[1] else []) + [
        n for n in sa if not torch.equal(sa[n], sb[n])]


def dp_per_step_phase(torch, graphs, cfg):
    """The per-step path (host batches, eager steps: K = 1, as the JAX run
    under a mesh; data-parallel when a group is initialized): launches
    checked and edges/s over epochs 2-3 on the card's clock, in
    main_path_phase's tuple (no profile)."""
    from pretrain_gnns_tpu_torch.train import pretrain
    from pretrain_gnns_tpu_torch.train.telemetry import seconds_between

    modules = counted_modules()
    for m in modules:
        m.reset_launches()
    res = pretrain.run_pretrain(cfg, graphs, log=None,
                                epochs=DP_PER_STEP_EPOCHS, device="cuda")
    # the probe launches where the GIN library is first loaded
    counts = {k: v for k, v in read_counts(modules).items()
              if v and k != "probe_scale2"}
    hist, marks = res["history"], res["marks"]
    rate = sum(h["edges"] for h in hist[1:]) / seconds_between(marks[0],
                                                               marks[-1])
    steps = sum(h["steps"] for h in hist)
    want = {key: n * steps for key, n in K1.items()}
    if counts != want or res["replays"] or res["scan_steps"] != 1:
        raise AssertionError(f"[dp per-step] launches {counts} != {want}, "
                             f"K {res['scan_steps']}, {res['replays']} "
                             "replays")
    return (counts, steps, {}, 0, rate, res["model"], None, None, hist)


def dp_section(torch, card, chem_graphs, entries):
    """Data parallelism (``parallel``: one process a device, the process
    group's world the JAX mesh's ``data`` axis) at a world of one: an NCCL
    group from a ``file://`` store in a temporary directory, left at the
    end. Chem masking GIN at full width, each path without the group and
    in it, the two runs equal bit for bit (history, parameters, batch-norm
    statistics): the per-step path (host batches, 48 eager steps, every
    step's all-reduce eager) in float32, run alone, twice in the group and
    alone again (eager rates spread between runs), and the epoch trainer (the
    dataset on the card, K = 16, RESIDENT_RUNS["on"]) in float32 and at
    the knobs' defaults, through main_path_phase (launches, edges/s and
    the card's busy share over the timed groups) with each step's
    all-reduce issued under the capture (``WorldMean`` calls counted
    while the stream captures: K a capture) and replayed. Then the
    all-reduce of a step alone (``WorldMean``: the gradients, statistics,
    loss and metrics into one flat buffer, ``all_reduce``, the division
    and the copies back) and the bare ``all_reduce`` of that buffer, timed
    on the card's clock."""
    import dataclasses

    from pretrain_gnns_tpu_torch.parallel import dp, multihost
    from pretrain_gnns_tpu_torch.train import pretrain

    t0 = time.perf_counter()
    tag = "[dp world of one]"
    cfg = resident(host_config(
        num_layer=LAYERS, emb_dim=EMB, batch_size=BATCH, mask_edge=False,
        seed=0, packing="auto"), epoch_group=0)
    per_step = dataclasses.replace(cfg, device_dataset="off", scan_steps=1)
    epochs, profile_from = RESIDENT_RUNS["on"]
    captured = []
    call = dp.WorldMean.__call__

    def spy(self, loss, metrics):
        captured.append(torch.cuda.is_current_stream_capturing())
        return call(self, loss, metrics)

    def paths(grouped):
        out = {"per-step": dp_per_step_phase(torch, chem_graphs, per_step)}
        for prec, kernels in (("float32", "float32"),
                              ("default", "bfloat16")):
            with precision("float32", kernels):
                captured.clear()
                out[prec] = main_path_phase(
                    torch, chem_graphs, cfg, card, K1, epochs, profile=True,
                    profile_from=profile_from, precision=prec)
                if grouped and sum(captured) != pretrain.resolve_scan_steps(
                        0, "cuda"):
                    raise AssertionError(
                        f"{tag} {sum(captured)} all-reduces under the "
                        f"capture of {prec}")
        return out

    alone = paths(False)
    # eager steps are host-bound and their rate spreads between runs: the
    # per-step path runs alone, in the group twice, then alone again
    eager = [alone["per-step"][4]]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as d:
        multihost.init_group(f"file://{d}/store", 1, 0, "cuda")
        dp.WorldMean.__call__ = spy
        try:
            print(f"{tag} NCCL group: world {multihost.process_count()}, "
                  f"rank {multihost.process_index()}, backend "
                  f"{torch.distributed.get_backend()}, NCCL "
                  f"{torch.cuda.nccl.version()} "
                  f"[{time.perf_counter() - T0:.0f} s]", flush=True)
            grouped = paths(True)
            eager.append(grouped["per-step"][4])
            eager.append(dp_per_step_phase(torch, chem_graphs, per_step)[4])
            allreduce_ms = dp_allreduce_phase(torch, cfg)
        finally:
            dp.WorldMean.__call__ = call
            multihost.shutdown()
    eager.append(dp_per_step_phase(torch, chem_graphs, per_step)[4])
    print(f"{tag} per-step edges/s alone, in the group, in the group, "
          f"alone: {', '.join(f'{r:.1f}' for r in eager)}; in the group / "
          f"alone {(eager[1] + eager[2]) / (eager[0] + eager[3]):.3f}x "
          f"on {card}", flush=True)
    for name, a in alone.items():
        b = grouped[name]
        differ = same_run(torch, (a[5], a[8]), (b[5], b[8]))
        busy = (f"; the card busy {100 * a[6]:.1f}% alone, "
                f"{100 * b[6]:.1f}% in the group, {a[7]:.3f} and "
                f"{b[7]:.3f} ms a step" if a[6] is not None else "")
        print(f"{tag} {name}: {b[4]:.1f} valid edges/s in the group of one "
              f"against {a[4]:.1f} alone ({b[4] / a[4]:.3f}x){busy}; "
              f"launches in the group "
              f"{ {k: v for k, v in b[0].items() if v} }, alone "
              f"{ {k: v for k, v in a[0].items() if v} }; the runs "
              f"differ in {differ or 'nothing'} (bit for bit); on {card}",
              flush=True)
        if differ or a[0] != b[0]:
            raise AssertionError(f"{tag} {name}: the run in the group "
                                 f"differs from the run alone in {differ}"
                                 f" or its launches")
        if name == "per-step":
            record_dp(entries, path_name(per_step) + " per-step", b)
        elif name == "float32":
            record_dp(entries, path_name(cfg), b)
    print(f"{tag} section {time.perf_counter() - t0:.1f} s; a step's "
          f"all-reduce {allreduce_ms} on {card} "
          f"[{time.perf_counter() - T0:.0f} s]", flush=True)


def dp_allreduce_phase(torch, cfg):
    """A step's ``WorldMean`` on the full-width objective (random
    gradients) and the bare ``all_reduce`` of its flat buffer: device ms a
    call (time_ms) and the launching thread's ms a call (100 calls, not
    waited for), with the buffer's bytes."""
    import torch.distributed as dist

    from pretrain_gnns_tpu_torch.parallel import dp
    from pretrain_gnns_tpu_torch.train import pretrain

    model = pretrain.build_objective(cfg).to("cuda")
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    wm = dp.WorldMean(model)
    loss = torch.ones((), device="cuda")
    metrics = {"acc_node": torch.ones((), device="cuda")}
    wm(loss, metrics)
    (buf,) = wm.buffers
    out = {}
    for name, fn in (("WorldMean", lambda: wm(loss, metrics)),
                     ("all_reduce", lambda: dist.all_reduce(buf))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(100):
            fn()
        out[f"{name} host ms"] = round((time.perf_counter() - t) * 10, 4)
        torch.cuda.synchronize()
        out[f"{name} device ms"] = round(time_ms(fn, torch), 4)
    out["buffer bytes"] = buf.numel() * buf.element_size()
    out["parameters"] = sum(p.numel() for p in model.parameters())
    return out


# --- the study tools: cli.sweep and cli.aggregate ---------------------------


def sweep_phase(torch, card, trunk, entries):
    """``cli.sweep`` on the card at the knobs' defaults, the protocol's
    first block cut to 1 seed x 2 configs (``nopretrain`` and ``masking``,
    the chem masking path's trunk) x 1 epoch on the synthetic molecules at
    full width, each run a ``cli.finetune``; then ``cli.aggregate`` on its
    results. The runs' launches are counted and added to the bfloat16
    ``kernels`` entries under ``sweep``."""
    import shutil

    from pretrain_gnns_tpu_torch.cli import aggregate, sweep

    tag = "[sweep]"
    modules = counted_modules()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as d:
        os.makedirs(os.path.join(d, "models"))
        shutil.copy(trunk, os.path.join(d, "models", "masking.pth"))
        results = os.path.join(d, "runs")
        for m in modules:
            m.reset_launches()
        t = time.perf_counter()
        with precision("float32", "bfloat16"):
            sweep.main(["--datasets", "synthetic", "--seeds", "0",
                        "--configs", "nopretrain", "masking", "--epochs", "1",
                        "--model_dir", os.path.join(d, "models"),
                        "--result_dir", results, "--device", "cuda"])
        seconds = time.perf_counter() - t
        counts = {k: v for k, v in read_counts(modules).items() if v}
        with open(os.path.join(results, "sweep_summary.json")) as f:
            summary = json.load(f)
        table = aggregate.main(["--result_dir", results,
                                "--out", os.path.join(d, "agg.json")])
    rows = {(t["dataset"], t["config"]): t for t in table}
    if (len(summary) != 2 or sorted(rows) != [("synthetic", "masking"),
                                             ("synthetic", "nopretrain")]
            or not all(0.0 <= r["test_auc"] <= 1.0 for r in summary)
            or not all(t["n_seeds"] == 1 for t in table)
            or not counts.get("gin_conv_fwd")):
        raise AssertionError(f"{tag} summary {summary}, table {table}, "
                             f"launches {counts}")
    for k in entries:
        key = k.get("counter", k["name"])
        if counts.get(key) and "[bf16]" in k["name"]:
            k["sweep"] = {"runs": len(summary), "launches": counts[key]}
    print(f"{tag} cli.sweep: {len(summary)} cli.finetune runs in "
          f"{seconds:.1f} s (1 epoch each, GIN {LAYERS} x {EMB}, the knobs' "
          f"defaults); launches {counts}; cli.aggregate: "
          + "; ".join(f"{c} test AUC {t['mean_test_auc']:.4f}"
                      for (_, c), t in sorted(rows.items()))
          + f" [{time.perf_counter() - T0:.0f} s]", flush=True)


# the bench's timed windows in this script (its own default is 5): the
# device-resident section's time came out of them
BENCH_WINDOWS = 2


def bench_phase():
    """``python -m pretrain_gnns_tpu_torch.bench`` at ``--scan_steps 1``
    (eager steps), at its defaults (K = 16, CUDA-graph replays), at
    ``--dtype default`` (the knobs' defaults) and at ``--dtype
    bfloat16_act``, in turn, in this process, each with BENCH_WINDOWS
    timed windows; each prints its JSON line."""
    from pretrain_gnns_tpu_torch import bench

    for argv in (["--scan_steps", "1"], [], ["--dtype", "default"],
                 ["--dtype", "bfloat16_act"]):
        argv = argv + ["--windows", str(BENCH_WINDOWS)]
        print(f"[bench] pretrain_gnns_tpu_torch.bench {' '.join(argv)}:",
              flush=True)
        if bench.main(argv) != 0:
            raise AssertionError("the bench failed")
    print(f"[bench] done [{time.perf_counter() - T0:.0f} s]", flush=True)


def describe(tag, batch):
    print(f"[{tag}] first batch: {int(batch.graph_mask.sum())} graphs, "
          f"{int(batch.node_mask.sum())} nodes, "
          f"{int(batch.edge_mask.sum())} valid edges; blocks "
          f"{batch.max_nodes // batch.block_nodes} x ({batch.block_nodes}, "
          f"{batch.block_edges})", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from pretrain_gnns_tpu_torch import native
        from pretrain_gnns_tpu_torch.data.synthetic import (
            bio_dataset, molecule_dataset,
        )
        from pretrain_gnns_tpu_torch.device import resolve_device
        from pretrain_gnns_tpu_torch.models import bio, chem, inits
        from pretrain_gnns_tpu_torch.ops import _build, spmm
        from pretrain_gnns_tpu_torch.train import pretrain
        from scripts.torch_port_kernel_micro import main as micro_main
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})",
              file=sys.stderr)
        return 1

    t0 = T0
    card = card_line()
    dev = resolve_device("cuda")
    # every phase but the bfloat16 and default sections runs with both knobs
    # at float32
    inits.set_compute_dtype("float32")
    spmm.set_compute_dtype("float32")
    f32_rates = {}

    def rated(cfg, launched, fused="on"):
        f32_rates[path_name(cfg, fused)] = launched[4]
        return launched
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    reports = _build.build(["gin_conv", "spmm", "edge_dot", "gat", "spmm_ee",
                            "probe"])
    native.load()  # the C++ packer and negative sampler, g++
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        print(f"[build] {name}.cu:\n{text.strip()}", flush=True)

    # chem: K1 on the masking path (mask_edge off, as the JAX bench)
    graphs, chem_scaffolds = molecule_dataset(MAIN_GRAPHS, seed=0,
                                              mean_atoms=MEAN_ATOMS)
    cfg = host_config(
        num_layer=LAYERS, emb_dim=EMB, batch_size=BATCH, mask_edge=False,
        seed=0, packing="auto",
    )
    batch = next(iter(pretrain.build_loader(cfg, graphs, dev)))
    print(f"[data] {len(graphs)} molecules", flush=True)
    describe("data", batch)
    loader_phase(graphs, cfg, dev)
    model = pretrain.build_objective(cfg).to(dev)
    kernels = kernel_phase(torch, batch.to(dev), model)
    probe = probe_phase(torch)
    agreement_phase(torch, batch, cfg)
    launched = rated(cfg, main_path_phase(torch, graphs, cfg, card, K1))
    record_launches(kernels, launched)
    # the trained trunks, for the fine-tuning section
    trunk_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    trunks = {"chem": write_trunk(launched[5], trunk_dir.name,
                                  "chem masking gin")}
    capture_phase(torch, graphs, cfg, K1)
    # the same path on the unfused GIN route: K2 [x+ein], no K1
    agreement_phase(torch, batch, cfg, fused="off")
    rated(cfg, main_path_phase(torch, graphs, cfg, card, GCN_K2,
                               fused="off"), "off")
    capture_phase(torch, graphs, cfg, GCN_K2, fused="off")
    chem_graphs, chem_first = graphs, batch

    # bio: K2 on the bio masking path
    graphs = bio_dataset(MAIN_GRAPHS, seed=0)
    cfg = host_config(
        domain="bio", num_layer=LAYERS, emb_dim=EMB, batch_size=BATCH,
        seed=0, packing="auto",
    )
    batch = next(iter(pretrain.build_loader(cfg, graphs, dev)))
    print(f"[data] {len(graphs)} ego-networks", flush=True)
    describe("data", batch)
    loader_phase(graphs, cfg, dev)
    conv = pretrain.build_objective(cfg).to(dev).gnn.gnns[0]
    on_card = batch.to(dev)
    k2 = k2_phase(torch, on_card, bio.edge_inputs(on_card, torch.float32),
                  conv.edge_kernel()[0],
                  on_card.edge_mask.to(torch.float32),
                  ((True, False), (False, True), (True, True)),
                  "bio masking first batch")
    agreement_phase(torch, batch, cfg)
    launched = rated(cfg, main_path_phase(torch, graphs, cfg, card, BIO_K2))
    record_launches(k2, launched)
    trunks["bio"] = write_trunk(launched[5], trunk_dir.name,
                                "bio masking gin")
    capture_phase(torch, graphs, cfg, BIO_K2)
    bio_graphs, bio_first = graphs, batch

    # edge prediction: K3 in both scoring heads, K1 or K2 in the trunk
    def edgepred(domain, gnn_type="gin"):
        graphs = bio_graphs if domain == "bio" else chem_graphs
        cfg = host_config(
            objective="edgepred", domain=domain, gnn_type=gnn_type,
            num_layer=LAYERS, emb_dim=EMB, batch_size=BATCH, seed=0,
            packing="auto")
        return graphs, cfg

    first = {}
    for domain in ("chem", "bio"):
        graphs, cfg = edgepred(domain)
        first[domain] = next(iter(pretrain.build_loader(cfg, graphs, dev)))
        describe(f"data {domain} edgepred", first[domain])
        loader_phase(graphs, cfg, dev)
    k3 = k3_entries(*(k3_phase(torch, first[d].to(dev), d)
                      for d in ("chem", "bio")))

    # K2[x+ein] as the chem GCN trunk calls it: the bond one-hots (K = 9)
    # and the symmetric normalisation as edge weights. These entries take
    # the place of the bio batch's, which stay beside them.
    _, cfg = edgepred("chem", "gcn")
    conv = pretrain.build_objective(cfg).to(dev).gnn.gnns[0]
    on_card = first["chem"].to(dev)
    dis = chem.inv_sqrt_degree(on_card)
    norm = dis[on_card.receivers.long()] * dis[on_card.senders.long()]
    gcn_k2 = k2_phase(torch, on_card,
                      chem.bond_one_hot(on_card, torch.float32),
                      conv.edge_kernel()[0],
                      on_card.edge_mask.to(torch.float32) * norm,
                      ((True, True),),
                      "chem edge-prediction first batch, GCN edge weights")
    measured = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    for at_gcn in gcn_k2:
        i = next(i for i, k in enumerate(k2) if k["name"] == at_gcn["name"])
        at_gcn["other_shapes"] = {k2[i]["shape"]: {
            key: k2[i][key] for key in measured}}
        k2[i] = at_gcn

    paths = {name: edgepred(*name) for name in (
        ("chem", "gin"), ("chem", "gcn"), ("bio", "gin"),
        ("bio", "graphsage"))}
    for (domain, _), (_, cfg) in paths.items():
        agreement_phase(torch, first[domain], referee_depth(cfg),
                        referee=True)
    graphs, cfg = paths["chem", "gin"]
    record_launches(k3, rated(cfg, main_path_phase(torch, graphs, cfg, card,
                                                   {**K1, **K3})))
    edgepred_chem_first = first["chem"]
    capture_phase(torch, graphs, cfg, {**K1, **K3})
    graphs, cfg = paths["chem", "gcn"]
    record_launches(k2, main_path_phase(torch, graphs, cfg, card,
                                        {**GCN_K2, **K3}), GCN_K2)
    capture_phase(torch, graphs, cfg, {**GCN_K2, **K3})
    for path, per_step in ((("bio", "gin"), {**BIO_K2, **K3}),
                           (("bio", "graphsage"), {**GCN_K2, **K3})):
        rated(paths[path][1], main_path_phase(torch, *paths[path], card,
                                              per_step))
        capture_phase(torch, *paths[path], per_step)

    # GAT: K4 (the fused conv) and K5 (the attention of the unfused conv)
    def gat_path(domain, objective="masking"):
        graphs = bio_graphs if domain == "bio" else chem_graphs
        cfg = host_config(
            objective=objective, domain=domain, gnn_type="gat",
            num_layer=LAYERS, emb_dim=EMB, batch_size=BATCH, mask_edge=False,
            seed=0, packing="auto")
        return graphs, cfg

    gat_first, gat_results = {}, {}
    for domain in ("chem", "bio"):
        graphs, cfg = gat_path(domain)
        gat_first[domain] = next(iter(pretrain.build_loader(cfg, graphs,
                                                            dev)))
        describe(f"data {domain} GAT masking", gat_first[domain])
        conv = pretrain.build_objective(cfg).to(dev).gnn.gnns[0]
        on_card = gat_first[domain].to(dev)
        ein = (bio.edge_inputs(on_card, torch.float32) if domain == "bio"
               else chem.bond_one_hot(on_card, torch.float32))
        gat_results[domain] = gat_phase(
            torch, on_card, conv, ein, f"{domain} GAT masking first batch")
    # K4 is launched by the chem masking path and K5 by the chem
    # edge-prediction path: both start from the same packed batch, so one
    # set of tensors stands for both.
    unfused_first = next(iter(pretrain.build_loader(
        gat_path("chem", "edgepred")[1], chem_graphs, dev)))
    for field in ("senders", "receivers", "edge_mask", "node_mask"):
        if not torch.equal(
                torch.as_tensor(getattr(unfused_first, field)),
                torch.as_tensor(getattr(gat_first["chem"], field))):
            raise AssertionError(
                f"the chem GAT masking and edge-prediction first batches "
                f"differ in {field}")
    k45 = gat_entries(
        gat_results["chem"], gat_results["bio"],
        "chem GAT first batch: the masking path (K4) and the unfused "
        "edge-prediction path (K5) pack the same graphs; senders, "
        "receivers and masks checked equal")
    for domain, mode in (("chem", "on"), ("bio", "on"), ("chem", "off")):
        agreement_phase(torch, gat_first[domain], gat_path(domain)[1],
                        fused=mode)
    record_launches(k45, rated(gat_path("chem")[1], main_path_phase(
        torch, *gat_path("chem"), card, K4)), K4)
    capture_phase(torch, *gat_path("chem"), K4)
    main_path_phase(torch, *gat_path("bio"), card, K4)
    capture_phase(torch, *gat_path("bio"), K4)
    record_launches(k45, rated(gat_path("chem", "edgepred")[1],
                              main_path_phase(
                                  torch, *gat_path("chem", "edgepred"), card,
                                  {**K5, **K3}, fused="off"), "off"), K5)
    capture_phase(torch, *gat_path("chem", "edgepred"), {**K5, **K3},
                  fused="off")

    # K6 and K7: the precomputed-edge-embedding aggregation, through the
    # op-level API and the kernel micro-benchmark
    k67 = spmm_ee_entries(*(spmm_ee_phase(torch, b.to(dev),
                                          f"{d} masking first batch")
                            for d, b in (("chem", chem_first),
                                         ("bio", bio_first))))
    k6 = {k["name"] for k in k67 if k["name"] != "sorted_blocked_spmm_fwd"}
    record_launches(k67, edge_emb_path_phase(torch, chem_first.to(dev)), k6)
    record_launches(k67, micro_phase(torch, micro_main),
                    {"sorted_blocked_spmm_fwd"})

    # supervised pretraining: the graph-level heads over K1 (chem) and K2
    # (bio), mean pooling; the agreement steps without dropout
    def supervised(domain, dropout):
        if domain == "bio":
            graphs = bio_dataset(MAIN_GRAPHS, seed=0, num_pretrain=BIO_TASKS)
        else:
            graphs, _ = molecule_dataset(MAIN_GRAPHS, num_tasks=CHEM_TASKS,
                                         seed=0, mean_atoms=MEAN_ATOMS)
        graphs, tasks = pretrain.supervised_graphs(graphs, domain)
        return graphs, host_config(
            objective="supervised", domain=domain, num_layer=LAYERS,
            emb_dim=EMB, batch_size=BATCH, num_tasks=tasks,
            graph_pooling="mean", dropout_ratio=dropout, seed=0,
            packing="auto")

    sup = {}
    for domain in ("chem", "bio"):
        graphs, cfg = supervised(domain, 0.0)
        first = next(iter(pretrain.build_loader(cfg, graphs, dev)))
        describe(f"data {domain} supervised, {cfg.num_tasks} tasks", first)
        loader_phase(graphs, cfg, dev)
        agreement_phase(torch, first, cfg)
        sup[domain] = graphs, host_config(
            **{**cfg.__dict__, "dropout_ratio": 0.2})
    record_launches(probe, main_path_phase(torch, *sup["chem"], card, K1,
                                           reprobe=True))
    capture_phase(torch, *sup["chem"], K1)
    main_path_phase(torch, *sup["bio"], card, BIO_K2)
    capture_phase(torch, *sup["bio"], BIO_K2)

    # Deep Graph Infomax: mean pooling and a bilinear discriminator over K1
    # (chem) and K2 (bio); no transform
    for domain, graphs, per_step in (("chem", chem_graphs, K1),
                                     ("bio", bio_graphs, BIO_K2)):
        cfg = host_config(
            objective="infomax", domain=domain, num_layer=LAYERS,
            emb_dim=EMB, batch_size=BATCH, seed=0, packing="auto")
        loader_phase(graphs, cfg, dev)
        # as edge prediction's, the step is ill-conditioned at its random
        # start: a float64 step on the CPU referees (see REFEREE_K)
        agreement_phase(torch, next(iter(pretrain.build_loader(
            cfg, graphs, dev))), referee_depth(cfg), referee=True)
        main_path_phase(torch, graphs, cfg, card, per_step)
        capture_phase(torch, graphs, cfg, per_step)

    # context prediction: the substructure and the context trunk (5 + 3
    # layers) on two blocked streams, through K1 (chem) and K2 (bio)
    chem_graphs_of = (
        lambda n: chem_graphs if n == MAIN_GRAPHS else
        molecule_dataset(n, seed=0, mean_atoms=MEAN_ATOMS)[0])
    f32_rates.update(contextpred_section(torch, card, chem_graphs_of,
                                         bio_graphs))

    # mixed precision: the bfloat16 variants of K1, K2 and K3, and four
    # paths under the JAX bench's recipe
    gat_first["chem edgepred"] = unfused_first
    bf16_rates = {}
    bf16 = bf16_section(torch, card, chem_graphs, chem_first, bio_graphs,
                        bio_first, edgepred_chem_first, f32_rates, gat_first,
                        micro_main, bf16_rates)
    # the knobs' defaults: float32 rows through the bfloat16 kernels
    default_section(torch, card, chem_graphs, chem_first, bio_graphs,
                    bio_first, f32_rates, bf16_rates)

    # fine-tuning from the masking paths' trunks, through cli.finetune
    finetuned = finetune_section(torch, card, trunks, trunk_dir.name)
    # the study tools: a cut sweep from the chem masking trunk, aggregated
    sweep_phase(torch, card, trunks["chem"], kernels + k2 + k3 + bf16)
    trunk_dir.cleanup()

    # step checkpoints with resume on the dataset store, then fine-tuning
    # on the stored chem dataset
    resume_section(torch, card, chem_graphs, chem_scaffolds, bio_graphs)

    # the reference's per-graph transforms in the loader: chem masking,
    # bio edge prediction (K3 on the negatives moved into the block slots)
    # and chem context prediction (every pair drawn anew each epoch)
    host_section(torch, card, chem_graphs_of, bio_graphs, f32_rates,
                 kernels + k2 + k3)

    # the device-resident dataset: batches built on the card from
    # descriptors, the epoch trainer, the draws inside the step
    device_section(torch, card, chem_graphs, chem_graphs_of, bio_graphs,
                   kernels + k2 + k3)

    # data parallelism at a world of one: an NCCL group, the per-step path
    # and the epoch trainer's replays against the runs without it
    dp_section(torch, card, chem_graphs, kernels)

    bench_phase()
    kernels += k2 + k3 + k45 + k67 + probe + bf16
    record_finetune(kernels, finetuned)
    missing = [k["name"] for k in kernels if not k.get("launches")]
    if missing:
        raise AssertionError(f"no path launched {missing}")

    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
