#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pretrain_gnns_tpu_torch``) on
one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):
  1. the card's name and power limit; the kernels built from ``csrc/``
     (one ``nvcc`` per source, all started together);
  2. chem kernel phase: on the chem path's first batch (256 molecules,
     blocks of 128 nodes / 384 edge slots, F = 300, K = 9, float32) the
     fused GIN conv K1 is held against its plain PyTorch version (forward
     ``out``, ``aggr``, ``z`` and all seven gradients) and timed with CUDA
     events beside the plain version, ``torch.matmul`` for its products
     and its bound;
  3. chem agreement: one train-mode masking step at full width on the card
     (kernels) and on the CPU (plain version) from the same weights:
     loss, every gradient and the batch-norm running stats;
  4. chem main path: ``run_pretrain`` on ``cuda`` at full width (GIN
     5 x 300, batch 256, mask_edge off) for a few dozen steps, with every
     launch count checked: K1 at 5 x steps in each direction, K2 at 0;
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
     every other count at 0.
Then one ``{"kernels": [...]}`` line (each kernel's ``launches`` from the
main path that runs it), the card line and, last, the result line
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

BATCH = 256
EMB = 300
LAYERS = 5
MEAN_ATOMS = 23
MAIN_GRAPHS = 4096  # 16 steps per epoch at batch 256, both domains
MAIN_EPOCHS = 3  # epoch 1 warms up; epochs 2-3 are timed
# the bio path's four K2 launches per layer and step
BIO_K2 = ("blocked_spmm_fwd[x]", "blocked_spmm_fwd[ein]",
          "blocked_spmm_bwd[x]", "blocked_spmm_bwd[ein]")
WARMUP, TRIALS, REPS = 5, 20, 10

# NVIDIA H100 SXM data sheet: float32 on the CUDA cores (dense), HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Tolerances, as max |kernel - plain| / max(1, max |plain|). Both sides
# are full float32 (no TF32); they differ only in summation order (tiled
# FMA GEMMs vs cuBLAS, shared-memory atomics vs index_add_ atomics, per-
# block partials summed in block order). The same for K1 and K2.
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
# One full-width masking step, card (kernels) vs CPU (plain version):
# five layers of batch norm amplify the summation-order differences. The
# same for chem and bio.
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 2e-3


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
    The host enqueues ahead of the card, so its time between launches
    (checks, allocation, argument marshalling, dispatch) does not count."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(TRIALS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_F32_FLOPS
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
                  launches_per_step=LAYERS)
    fwd = dict(name="gin_conv_fwd",
               replaces="pretrain_gnns_tpu/ops/pallas_gin.py:47",
               tpu_counterpart="ops/pallas_gin.py::_fwd_kernel via _call_fwd",
               max_abs_err=fwd_abs, ms=kern_fwd_ms, plain_ms=plain_fwd_ms,
               bound_ms=fwd_b, bound_by=fwd_by, matmul_ms=mm_fwd_ms,
               **common)
    bwd = dict(name="gin_conv_bwd",
               replaces="pretrain_gnns_tpu/ops/pallas_gin.py:114",
               tpu_counterpart="ops/pallas_gin.py::_bwd_kernel via _call_bwd",
               max_abs_err=bwd_abs, ms=kern_bwd_ms, plain_ms=plain_bwd_ms,
               bound_ms=bwd_b, bound_by=bwd_by, matmul_ms=mm_bwd_ms,
               **common)
    print(f"[kernels] shapes N={N} F={F} F2={F2} K={K} E={E} "
          f"valid_nodes={V} valid_edges={e_valid}; bound operations "
          f"fwd {fwd_ops:.4e} bwd {bwd_ops:.4e}", flush=True)
    for k in (fwd, bwd):
        print(f"[kernels] {k['name']}: kernel {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, torch.matmul products "
              f"{k['matmul_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})", flush=True)
    return [fwd, bwd]


def agreement_phase(torch, batch, cfg):
    """One train-mode masking step on the card and on the CPU."""
    tag = f"[{cfg.domain} agreement]"
    from pretrain_gnns_tpu_torch.train.pretrain import build_objective

    results = []
    for dev in ("cuda", "cpu"):
        model = build_objective(cfg).to(dev)
        loss, _ = model(batch.to(dev), train=True)
        loss.backward()
        results.append((
            float(loss.detach()),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()},
        ))
    (lc, gc, bc), (lp, gp, bp) = results
    loss_err = abs(lc - lp) / max(1.0, abs(lp))
    grad_err = max(rel_err(gc[n], gp[n]) for n in gp)
    stat_err = max(rel_err(bc[n].float(), bp[n].float()) for n in bp)
    print(f"{tag} loss cuda={lc:.6f} cpu={lp:.6f} rel err "
          f"{loss_err:.3e}; max grad rel err {grad_err:.3e}; max BN stat "
          f"rel err {stat_err:.3e}", flush=True)
    if not (loss_err <= STEP_LOSS_TOL and grad_err <= STEP_GRAD_TOL
            and stat_err <= STEP_GRAD_TOL and math.isfinite(lc)):
        raise AssertionError(f"{cfg.domain} masking step on the card "
                             "disagrees with the CPU reference")


def launch_counts():
    from pretrain_gnns_tpu_torch.ops import blocked_spmm, gin_conv

    return {**gin_conv.launches, **blocked_spmm.launches}


def main_path_phase(torch, graphs, cfg, card, kernels):
    """``run_pretrain`` on the card; every launch count is set to 0 just
    before and read just after. ``kernels`` name the counts that must be
    LAYERS x steps; every other count must stay 0."""
    from pretrain_gnns_tpu_torch.ops import blocked_spmm, gin_conv
    from pretrain_gnns_tpu_torch.train import pretrain

    tag = f"[{cfg.domain} main]"
    stamps = []

    def log(msg):
        print(f"{tag} {msg}", flush=True)
        if msg.startswith("epoch="):
            stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    gin_conv.reset_launches()
    blocked_spmm.reset_launches()
    res = pretrain.run_pretrain(cfg, graphs, log=log, epochs=MAIN_EPOCHS,
                                device="cuda")
    counts = launch_counts()
    hist = res["history"]
    steps = sum(h["steps"] for h in hist)
    want = {k: (LAYERS * steps if k in kernels else 0) for k in counts}
    if counts != want or not steps:
        raise AssertionError(f"{cfg.domain} path launches {counts} != "
                             f"{want} ({LAYERS} x {steps} steps)")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss: {hist}")
    edges = sum(h["edges"] for h in hist[1:])
    rate = edges / (stamps[-1] - stamps[0])
    print(f"{tag} {steps} steps, launches "
          f"{ {k: counts[k] for k in kernels} }; "
          f"{rate:.1f} valid edges/s over epochs 2-{MAIN_EPOCHS} "
          f"({sum(h['steps'] for h in hist[1:])} steps, float32) on "
          f"{card}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    return counts


def k2_phase(torch, batch, model):
    """Each K2 variant against its plain version on the bio path's first
    batch, at the widths of the trunk's first layer."""
    from pretrain_gnns_tpu_torch.models import bio
    from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs

    dev = batch.node_mask.device
    gen = torch.Generator().manual_seed(2)
    N, E = batch.max_nodes, batch.max_edges
    nm = batch.node_mask.to(torch.float32)
    x = torch.randn(N, EMB, generator=gen).to(dev) * nm[:, None]
    g = torch.randn(N, EMB, generator=gen).to(dev)
    ein = bio.edge_inputs(batch, torch.float32)
    enc = model.gnn.gnns[0].edge_encoder
    W = torch.cat([enc.weight.t(), enc.bias[None]], 0).detach().contiguous()
    w = batch.edge_mask.to(torch.float32)
    snd, rcv = batch.senders, batch.receivers
    bn, be, K, F = batch.block_nodes, batch.block_edges, W.shape[0], EMB
    valid = batch.edge_mask
    e_valid = int(valid.sum())
    n_snd = int(torch.unique(snd[valid]).numel())  # x rows the sum reads
    n_rcv = int(torch.unique(rcv[valid]).numel())  # g rows dmsg reads
    # the library's yardstick for the has_x variant: out = A x and
    # dx = A^T g with A[r, s] = w over the valid edges, built untimed
    pairs = torch.stack([rcv[valid].long(), snd[valid].long()])
    csr = {name: torch.sparse_coo_tensor(idx, w[valid], (N, N)).coalesce()
           .to_sparse_csr()
           for name, idx in (("A", pairs), ("At", pairs.flip(0)))}
    lib_err = rel_err(torch.sparse.mm(csr["A"], x),
                      bs.blocked_spmm_fused_plain(x, None, None, snd, rcv, w,
                                                  bn, be, True, False))
    if not lib_err <= FWD_TOL:
        raise AssertionError(f"torch.sparse.mm yardstick disagrees: {lib_err}")
    src = "pretrain_gnns_tpu_torch/csrc/spmm.cu"
    entries = []
    for has_x, has_ein in ((True, False), (False, True), (True, True)):
        v = bs.variant(has_x, has_ein)
        fwd_args = (x, ein, W, snd, rcv, w, bn, be, has_x, has_ein)
        bwd_args = (g, ein, snd, rcv, w, K, bn, be, has_x, has_ein)
        with torch.no_grad():
            out = bs.spmm_fwd(*fwd_args)
            dx, dW = bs.spmm_bwd(*bwd_args)
        torch.cuda.synchronize()
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
              f"{float(out[~batch.node_mask].abs().max()):.1e}", flush=True)
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
                bound_by=by, library_ms=lms, library=library,
                launches_per_step=LAYERS))
    print(f"[kernels] K2 shapes N={N} F={F} K={K} E={E} valid_edges="
          f"{e_valid} senders={n_snd} receivers={n_rcv}", flush=True)
    for k in entries:
        lib = ("none" if k["library_ms"] is None
               else f"{k['library_ms']:.4f} ms")
        print(f"[kernels] {k['name']}: kernel {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, library {lib}, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']})", flush=True)
    return entries


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
        from pretrain_gnns_tpu_torch.data.synthetic import (
            bio_dataset, molecule_dataset,
        )
        from pretrain_gnns_tpu_torch.device import resolve_device
        from pretrain_gnns_tpu_torch.ops import _build
        from pretrain_gnns_tpu_torch.train import pretrain
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})",
              file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    card = card_line()
    dev = resolve_device("cuda")
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    reports = _build.build(["gin_conv", "spmm"])
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        print(f"[build] {name}.cu:\n{text.strip()}", flush=True)

    # chem: K1 on the masking path (mask_edge off, as the JAX bench)
    graphs, _ = molecule_dataset(MAIN_GRAPHS, seed=0, mean_atoms=MEAN_ATOMS)
    cfg = pretrain.PretrainConfig(
        num_layer=LAYERS, emb_dim=EMB, batch_size=BATCH, mask_edge=False,
        seed=0, packing="auto",
    )
    batch = next(iter(pretrain.build_loader(cfg, graphs, dev)))
    print(f"[data] {len(graphs)} molecules", flush=True)
    describe("data", batch)
    model = pretrain.build_objective(cfg).to(dev)
    kernels = kernel_phase(torch, batch.to(dev), model)
    agreement_phase(torch, batch, cfg)
    counts = main_path_phase(torch, graphs, cfg, card,
                             ("gin_conv_fwd", "gin_conv_bwd"))
    for k in kernels:
        k["launches"] = counts[k["name"]]

    # bio: K2 on the bio masking path
    graphs = bio_dataset(MAIN_GRAPHS, seed=0)
    cfg = pretrain.PretrainConfig(
        domain="bio", num_layer=LAYERS, emb_dim=EMB, batch_size=BATCH,
        seed=0, packing="auto",
    )
    batch = next(iter(pretrain.build_loader(cfg, graphs, dev)))
    print(f"[data] {len(graphs)} ego-networks", flush=True)
    describe("data", batch)
    model = pretrain.build_objective(cfg).to(dev)
    k2 = k2_phase(torch, batch.to(dev), model)
    agreement_phase(torch, batch, cfg)
    counts = main_path_phase(torch, graphs, cfg, card, BIO_K2)
    for k in k2:
        k["launches"] = counts[k["name"]]
    kernels += [k for k in k2 if k["name"] in BIO_K2]

    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
