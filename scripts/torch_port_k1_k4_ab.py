#!/usr/bin/env python3
"""Timing A/B of the fused GIN conv (K1), the fused GAT conv (K4), the
blocked GAT attention (K5), the fused edge-transform SpMM (K2), the
pair-dot head (K3) and the blocked SpMM on a precomputed edge embedding
(K6), forward and backward, and of the receiver-sorted SpMM (K7), between
this tree's ``csrc/gin_conv.cu``, ``csrc/gat.cu``, ``csrc/spmm.cu``,
``csrc/edge_dot.cu`` and ``csrc/spmm_ee.cu`` (with the headers they
include) and those of another checkout, in one process on one GPU.

Run from the repository root, with the other checkout's ``csrc`` directory
(for example a ``git archive`` of the parent commit unpacked under
``_archive/``):

    python3 scripts/torch_port_k1_k4_ab.py --ref_csrc _archive/parent/pretrain_gnns_tpu_torch/csrc [--kernels k1,k4,k5,k2,k3,k6,k7]

The libraries of both trees have the same C interfaces, but for K1's
forward scratch and workspace flags (added with its tensor-core GEMM), the
compute-dtype flags of K4-K7 (added with their bfloat16 variants) and K4's
saved rounded operands (``r16``), which ``compat`` leaves out when calling
an older library; a bfloat16 row
that the older library cannot run reads "n/a" on its side. It builds
the other sources with this tree's ``nvcc`` flags, then times each kernel
(device ms a call, ``chip_smoke.time_ms``) in the order reference, this
tree, this tree, reference, and prints each time beside the card's name
and power limit. Shapes: K1 on the chem masking path's first batch (GIN 5
x 300), in float32 and at compute_dtype bfloat16 with bfloat16 and with
float32 rows, and with bfloat16 rows at float32 compute; K4 and K5 on the chem and bio GAT masking paths' first batches
(GAT 5 x 300 with 2 heads; K5 on x and e as the unfused conv forms them,
as ``chip_smoke.py`` times it); K2 ``[x]``, ``[ein]`` and
``[x+ein]`` on the bio masking path's first batch (the first layer's
``[edge_feat | 1]`` edge inputs and edge kernel, K = 10) and ``[x+ein]``
on the chem edge-prediction path's first batch with the GCN trunk's bond
one-hots (K = 9) and symmetric-normalised edge weights, as
``chip_smoke.py`` times them, and at compute_dtype bfloat16 on bfloat16
and float32 rows ``[x]`` and ``[ein]`` on the bio masking first batch and
``[x+ein]`` on the chem masking one with the paths' 0/1 edge weights (the
float32 K2 on the same batches beside them); K3 on the chem and bio
edge-prediction
paths' first batches, both heads, the backward with the cotangent the path
gives it (0 on the positive head's odd slots), as ``chip_smoke.py`` times
it; K6 with and without an edge embedding on the chem and bio masking
paths' first batches (fractional, partly negative edge weights), forward
and backward (``dx`` and ``dmsg`` together, ``dx`` alone, ``dmsg`` alone),
with K2 ``[x]`` on the same inputs beside it; K7 with and without an edge
embedding on the same batches (the slots sorted by ``sort_block_edges``),
with K6's forward ``[x+ee]`` on the unsorted slots timed beside it. K4-K7
also at compute_dtype bfloat16 (rows ``[bf16]``: K4 on float32 h, K5 on
float32 x and e, K6 and K7 on bfloat16 rows), on the same batches. Every
float32 row pins compute_dtype float32, whatever ``PGT_SPMM_DTYPE`` says.
Random inputs from a seed.

``--parts`` splits K4's entry points (float32 and bfloat16, chem and bio
GAT first batches), or with ``--kernels k2`` K2's cases, into their
launches instead, for both trees in one call: each launch's device ms (the profiler's kernel records, the median
over PARTS_TRIALS calls, each after a 2 ms spin of the card so that the
host has enqueued the call's launches before the first one starts), by
launch order and kernel name, beside the call's span on the card (first
kernel's start to last kernel's end) and its event-pair time
(``chip_smoke.time_ms``):

    python3 scripts/torch_port_k1_k4_ab.py --ref_csrc DIR --parts [--kernels k2]
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pretrain_gnns_tpu_torch.data.synthetic import (  # noqa: E402
    bio_dataset, molecule_dataset,
)
from pretrain_gnns_tpu_torch.device import resolve_device  # noqa: E402
from pretrain_gnns_tpu_torch.models import bio, chem  # noqa: E402
from pretrain_gnns_tpu_torch.ops import _build, attention  # noqa: E402
from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs  # noqa: E402
from pretrain_gnns_tpu_torch.ops import gat_conv as gc  # noqa: E402
from pretrain_gnns_tpu_torch.ops import edge_dot as ed  # noqa: E402
from pretrain_gnns_tpu_torch.ops import gin_conv  # noqa: E402
from pretrain_gnns_tpu_torch.ops import sorted_spmm as ss  # noqa: E402
from pretrain_gnns_tpu_torch.train import pretrain  # noqa: E402

BF = torch.bfloat16

# Entry points that take (bf16_rows, bf16_compute) before the stream since
# the bfloat16 variants; a library that has no ``pgt_bf16_flags`` predates
# them.
_FLAGGED = ("pgt_gin_conv_fwd", "pgt_gin_conv_bwd", "pgt_spmm_fwd",
            "pgt_spmm_bwd", "pgt_edot_fwd", "pgt_edot_bwd")
# K1's forward takes its scratch (argument 19) and its workspace sizes take
# the two flags since the tensor-core GEMM; a library without
# ``pgt_gin_conv_fwd_workspace`` predates them.
_FWD_WORK_ARG = 19


def _drop(seq, idx):
    n = len(seq)
    idx = {i % n for i in idx}
    return [v for i, v in enumerate(seq) if i not in idx]


def _flags_zero(args):
    if args[-3] or args[-2]:
        raise ValueError("this library has float32 kernels only")


class _Shim:
    """A function of an older library called with this tree's arguments:
    those at the indices ``drop`` are left out, here and from
    ``argtypes`` (``check`` sees them first). Without ``fn``, a function
    the library lacks: calls return ``missing()``."""

    def __init__(self, fn, drop=(), check=None, missing=None):
        self.fn, self.drop, self.check = fn, set(drop), check
        self.missing = missing

    @property
    def argtypes(self):
        return None if self.fn is None else self.fn.argtypes

    @argtypes.setter
    def argtypes(self, types):
        if self.fn is not None:
            self.fn.argtypes = _drop(list(types), self.drop)

    @property
    def restype(self):
        return None if self.fn is None else self.fn.restype

    @restype.setter
    def restype(self, t):
        if self.fn is not None:
            self.fn.restype = t

    def __call__(self, *args):
        if self.fn is None:
            return self.missing()
        if self.check is not None:
            self.check(args)
        return self.fn(*_drop(args, self.drop))


def _lacks_bf16_gemm():
    raise ValueError("this library has no tensor-core GEMM")


def _zero_at(*idx):
    """A check that the arguments at ``idx`` (flags the older library
    lacks) are 0."""
    def check(args):
        if any(args[i] for i in idx):
            raise ValueError("this library has float32 kernels only")
    return check


class _Older:
    """An older library with this tree's entry points' arguments."""

    def __init__(self, lib, shims):
        self._lib, self._shims = lib, shims

    def __getattr__(self, name):
        if name in self._shims:
            return self._shims[name]
        return getattr(self._lib, name)


def compat(lib):
    """``lib``, or a wrapper that calls it with this tree's arguments where
    it predates the bfloat16 flags or K1's forward scratch."""
    flags = hasattr(lib, "pgt_bf16_flags")
    scratch = hasattr(lib, "pgt_gin_conv_fwd_workspace")
    shims = {}
    for name in _FLAGGED:
        if not hasattr(lib, name):
            continue
        drop = set() if flags else {-3, -2}
        if name == "pgt_gin_conv_fwd" and not scratch:
            drop.add(_FWD_WORK_ARG)
        if drop:
            shims[name] = _Shim(getattr(lib, name), drop,
                                None if flags else _flags_zero)
    if hasattr(lib, "pgt_gin_conv_bwd") and not scratch:
        shims.update(
            pgt_gin_conv_bwd_workspace=_Shim(lib.pgt_gin_conv_bwd_workspace,
                                             {5, 6}),
            pgt_gin_conv_fwd_workspace=_Shim(None, missing=lambda: 0),
            pgt_gemm_bf16=_Shim(None, missing=_lacks_bf16_gemm))
    # K4 and K5 before their bfloat16 variants: no compute-dtype flag
    if hasattr(lib, "pgt_gat_conv_fwd") and not hasattr(
            lib, "pgt_gat_bf16_flags"):
        for name in ("pgt_gat_attn_fwd", "pgt_gat_attn_bwd",
                     "pgt_gat_conv_fwd", "pgt_gat_conv_bwd"):
            shims[name] = _Shim(getattr(lib, name), {-2}, _zero_at(-2))
        shims.update(
            pgt_gat_conv_fwd_workspace=_Shim(lib.pgt_gat_conv_fwd_workspace,
                                             {1, 3, 4}, _zero_at(4)),
            pgt_gat_conv_bwd_workspace=_Shim(lib.pgt_gat_conv_bwd_workspace,
                                             {7}, _zero_at(7)))
    # K4 before its bfloat16 forward saved the rounded h and Wl: no r16
    # argument (fwd: after dls, index 20; bwd: after dls, index 18)
    if hasattr(lib, "pgt_gat_conv_fwd") and not hasattr(
            lib, "pgt_gat_conv_r16_elems"):
        for name, idx in (("pgt_gat_conv_fwd", 20), ("pgt_gat_conv_bwd", 18)):
            old = shims.get(name)
            shims[name] = _Shim(getattr(lib, name),
                                (old.drop if old else set()) | {idx},
                                old.check if old else None)
        shims["pgt_gat_conv_r16_elems"] = _Shim(None, missing=lambda: 0)
    # K6 and K7 before theirs: no rows or compute-dtype flag
    if hasattr(lib, "pgt_spmm_ee_fwd") and not hasattr(
            lib, "pgt_spmm_ee_bf16_flags"):
        for name in ("pgt_spmm_ee_fwd", "pgt_spmm_ee_bwd",
                     "pgt_spmm_sorted_fwd"):
            shims[name] = _Shim(getattr(lib, name), {-3, -2},
                                _zero_at(-3, -2))
    return _Older(lib, shims) if shims else lib


def build(srcdir: str, name: str, out_dir: str):
    """Library ``name`` of the ``csrc`` directory ``srcdir``, built with
    this tree's flags by one ``nvcc`` from the sources that directory has
    of it (an older tree's ``gat`` is one source)."""
    lib = Path(out_dir) / f"lib{name}_ref.so"
    srcs = [Path(srcdir) / f"{part}.cu"
            for part in _build.SOURCES.get(name, (name,))]
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
         *(str(p) for p in srcs if p.exists())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {srcdir}/{name}:\n"
                           f"{proc.stdout}")
    return compat(ctypes.CDLL(str(lib)))


SOURCES = {"k1": "gin_conv", "k4": "gat", "k5": "gat", "k2": "spmm",
           "k3": "edge_dot", "k6": "spmm_ee", "k7": "spmm_ee"}


def use(libs) -> None:
    """Route the K1, K4, K2, K3 and K6/K7 wrappers to the libraries of
    ``libs`` (``{source name: CDLL}``; a source not named: this tree's)."""
    _tree_gin_lib.cache_clear()
    attention.lib.cache_clear()
    bs._lib.cache_clear()
    bs._ee_lib.cache_clear()
    ed._lib.cache_clear()
    for name in SOURCES.values():
        _build._libs.pop(name, None)
        if name in libs:
            _build._libs[name] = libs[name]  # load() hands this one out
    gin_lib = libs.get("gin_conv")
    if gin_lib is not None:
        gin_conv.configure(gin_lib)
        gin_conv._lib = lambda: gin_lib
    else:
        gin_conv._lib = _tree_gin_lib


_tree_gin_lib = gin_conv._lib


def k2_cases(dev):
    """``{kernel: callable}`` for K2: at float32 its six rows on the bio
    masking path's first batch and, for ``[x+ein]``, the chem GCN
    edge-prediction one (GCN's edge weights) and the chem masking one; at
    compute_dtype bfloat16 (rows ``[bf16]``, on bfloat16 rows, and ``[bf16,
    f32 rows]``) ``[x]`` and ``[ein]`` on the bio masking first batch and
    ``[x+ein]`` on the chem masking one (the unfused GIN path's), each with
    the path's 0/1 edge weights, beside the float32 rows on the same
    batch."""
    gen = torch.Generator().manual_seed(2)
    out = {}
    base = dict(num_layer=5, emb_dim=300, batch_size=256, seed=0,
                packing="auto")
    bio_cfg = pretrain.PretrainConfig(device_dataset="off",
                                      domain="bio", **base)
    gcn_cfg = pretrain.PretrainConfig(device_dataset="off",
                                      objective="edgepred", gnn_type="gcn",
                                      **base)
    chem_cfg = pretrain.PretrainConfig(device_dataset="off",
                                       mask_edge=False, **base)
    chem_graphs, _ = molecule_dataset(4096, seed=0, mean_atoms=23)
    for tag, cfg, graphs in (("bio", bio_cfg, bio_dataset(4096, seed=0)),
                             ("chem GCN", gcn_cfg, chem_graphs),
                             ("chem masking", chem_cfg, chem_graphs)):
        b = next(iter(pretrain.build_loader(cfg, graphs, dev))).to(dev)
        conv = pretrain.build_objective(cfg).to(dev).gnn.gnns[0]
        W = conv.edge_kernel()[0].detach().contiguous()
        nm = b.node_mask.to(torch.float32)
        x = torch.randn(b.max_nodes, 300, generator=gen).to(dev) * nm[:, None]
        g = torch.randn(b.max_nodes, 300, generator=gen).to(dev)
        w = b.edge_mask.to(torch.float32)
        if tag == "bio":
            ein = bio.edge_inputs(b, torch.float32)
            variants = ((True, False), (False, True), (True, True))
            bf16_variants = ((True, False), (False, True))
        else:
            ein = chem.bond_one_hot(b, torch.float32)
            variants, bf16_variants = ((True, True),), ((True, True),)
        if tag == "chem GCN":
            dis = chem.inv_sqrt_degree(b)
            w = w * dis[b.receivers.long()] * dis[b.senders.long()]
            bf16_variants = ()
        edges = (b.senders, b.receivers, w)
        for has_x, has_ein in variants:
            flags = (b.block_nodes, b.block_edges, has_x, has_ein)
            name = f"K2[{bs.variant(has_x, has_ein)}] {tag}"
            out[f"{name} fwd"] = (
                lambda x=x, ein=ein, W=W, edges=edges, flags=flags:
                bs.spmm_fwd(x, ein, W, *edges, *flags))
            out[f"{name} bwd"] = (
                lambda g=g, ein=ein, K=W.shape[0], edges=edges, flags=flags:
                bs.spmm_bwd(g, ein, *edges, K, *flags))
        for has_x, has_ein in bf16_variants:
            flags = (b.block_nodes, b.block_edges, has_x, has_ein, BF)
            for rows, rtag in ((BF, "bf16"), (torch.float32, "bf16, f32 rows")):
                name = f"K2[{bs.variant(has_x, has_ein)}] {tag}"
                xr, gr = x.to(rows), g.to(rows)
                out[f"{name} fwd[{rtag}]"] = (
                    lambda x=xr, ein=ein, W=W, edges=edges, flags=flags:
                    bs.spmm_fwd(x, ein, W, *edges, *flags))
                out[f"{name} bwd[{rtag}]"] = (
                    lambda g=gr, ein=ein, K=W.shape[0], edges=edges,
                    flags=flags: bs.spmm_bwd(g, ein, *edges, K, *flags[:4],
                                             BF))
    return out


def k3_cases(dev):
    """``{kernel: callable}`` for K3, both heads and directions, on the
    chem and bio edge-prediction paths' first batches."""
    gen = torch.Generator().manual_seed(3)
    out = {}
    for domain in ("chem", "bio"):
        cfg = pretrain.PretrainConfig(device_dataset="off",
                                      objective="edgepred", domain=domain,
                                      num_layer=5, emb_dim=300,
                                      batch_size=256, seed=0, packing="auto")
        graphs = (bio_dataset(4096, seed=0) if domain == "bio"
                  else molecule_dataset(4096, seed=0, mean_atoms=23)[0])
        b = next(iter(pretrain.build_loader(cfg, graphs, dev))).to(dev)
        x = (torch.randn(b.max_nodes, 300, generator=gen).to(dev)
             * b.node_mask[:, None])
        neg = b.extras["negative_edges_blocked"]
        heads = {"pos": (b.receivers, b.senders, b.edge_mask,
                         b.block_edges, 2),
                 "neg": (neg[:, 0].contiguous(), neg[:, 1].contiguous(),
                         b.extras["negative_edges_blocked_mask"],
                         b.block_edges // 2, 1)}
        for head, (a_idx, b_idx, valid, ppb, stride) in heads.items():
            w = valid.to(torch.float32)
            g = torch.zeros(a_idx.shape[0], device=dev)
            g[::stride] = torch.randn(g[::stride].shape[0],
                                      generator=gen).to(dev)
            pairs = (x, a_idx, b_idx, w, b.block_nodes, ppb)
            out[f"blocked_edge_dot_fwd {domain} {head}"] = (
                lambda pairs=pairs: ed.edot_fwd(*pairs))
            out[f"blocked_edge_dot_bwd {domain} {head}"] = (
                lambda g=g, pairs=pairs: ed.edot_bwd(g, *pairs))
    return out


def k6_cases(dev):
    """``{kernel: callable}`` for K6 with and without an edge embedding,
    forward and backward (``dx`` and ``dmsg``; ``dx``; and ``dmsg`` alone,
    the concat form's), with K2 ``[x]`` on the same inputs beside it, on
    the chem and bio masking paths' first batches (fractional, partly
    negative edge weights)."""
    gen = torch.Generator().manual_seed(6)
    out = {}
    for domain in ("chem", "bio"):
        cfg = pretrain.PretrainConfig(device_dataset="off",
                                      domain=domain, num_layer=5, emb_dim=300,
                                      batch_size=256, mask_edge=False,
                                      seed=0, packing="auto")
        graphs = (bio_dataset(4096, seed=0) if domain == "bio"
                  else molecule_dataset(4096, seed=0, mean_atoms=23)[0])
        b = next(iter(pretrain.build_loader(cfg, graphs, dev))).to(dev)
        N, E, bn, be = b.max_nodes, b.max_edges, b.block_nodes, b.block_edges
        rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
        x, ee, g = rnd(N, 300) * b.node_mask[:, None], rnd(E, 300), rnd(N, 300)
        w = b.edge_mask.to(torch.float32) * (
            torch.rand(E, generator=gen) * 2 - 0.5).to(dev)
        e = (b.senders, b.receivers, w, bn, be)
        for tag, e_in in (("[x+ee]", ee), ("[x]", None)):
            out[f"blocked_spmm_ee_fwd{tag} {domain}"] = (
                lambda x=x, e_in=e_in, e=e: bs.spmm_ee_fwd(x, e_in, *e))
            # the bfloat16 variant on bfloat16 rows
            xb, eb, gb = (x.to(BF), None if e_in is None else e_in.to(BF),
                          g.to(BF))
            out[f"blocked_spmm_ee_fwd{tag}[bf16] {domain}"] = (
                lambda x=xb, e_in=eb, e=e: bs.spmm_ee_fwd(x, e_in, *e, BF))
            out[f"blocked_spmm_ee_bwd{tag}[bf16] {domain}"] = (
                lambda g=gb, e=e, has=e_in is not None: bs.spmm_ee_bwd(
                    g, *e, has, True, has, BF))
        out[f"blocked_spmm_ee_bwd[x+ee] {domain}"] = (
            lambda g=g, e=e: bs.spmm_ee_bwd(g, *e, True))
        out[f"blocked_spmm_ee_bwd[x] {domain}"] = (
            lambda g=g, e=e: bs.spmm_ee_bwd(g, *e, False, True, False))
        out[f"blocked_spmm_ee_bwd[x+ee] dmsg alone {domain}"] = (
            lambda g=g, e=e: bs.spmm_ee_bwd(g, *e, True, False, True))
        out[f"K2[x] fwd {domain}"] = (
            lambda x=x, e=e: bs.spmm_fwd(x, None, None, *e, True, False))
        out[f"K2[x] bwd {domain}"] = (
            lambda g=g, e=e: bs.spmm_bwd(g, None, *e[:3], 0, *e[3:], True,
                                         False))
    return out


def k7_cases(dev):
    """``{kernel: callable}`` for K7 with and without an edge embedding,
    and K6's forward ``[x+ee]`` beside it, on the chem and bio masking
    paths' first batches."""
    gen = torch.Generator().manual_seed(6)
    out = {}
    for domain in ("chem", "bio"):
        cfg = pretrain.PretrainConfig(device_dataset="off",
                                      domain=domain, num_layer=5, emb_dim=300,
                                      batch_size=256, mask_edge=False,
                                      seed=0, packing="auto")
        graphs = (bio_dataset(4096, seed=0) if domain == "bio"
                  else molecule_dataset(4096, seed=0, mean_atoms=23)[0])
        b = next(iter(pretrain.build_loader(cfg, graphs, dev))).to(dev)
        N, E, bn, be = b.max_nodes, b.max_edges, b.block_nodes, b.block_edges
        rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
        x, ee = rnd(N, 300) * b.node_mask[:, None], rnd(E, 300)
        w = b.edge_mask.to(torch.float32) * (
            torch.rand(E, generator=gen) * 2 - 0.5).to(dev)
        s2, r2, w2, ee2 = ss.sort_block_edges(b.senders, b.receivers, w, ee,
                                              N // bn, be)
        out[f"blocked_spmm_ee_fwd[x+ee] {domain}"] = (
            lambda x=x, ee=ee, e=(b.senders, b.receivers, w, bn, be):
            bs.spmm_ee_fwd(x, ee, *e))
        for tag, e_in in (("[x+ee]", ee2), ("[x]", None)):
            out[f"sorted_blocked_spmm_fwd{tag} {domain}"] = (
                lambda x=x, e_in=e_in, e=(s2, r2, w2, bn, be):
                ss.sorted_spmm_fwd(x, e_in, *e))
            out[f"sorted_blocked_spmm_fwd{tag}[bf16] {domain}"] = (
                lambda x=x.to(BF), e_in=None if e_in is None else e_in.to(BF),
                e=(s2, r2, w2, bn, be): ss.sorted_spmm_fwd(x, e_in, *e, BF))
    return out


def gat_cases(dev, kernels):
    """``{kernel: callable}`` for K4 and K5 (those of ``kernels``) on the
    chem and bio GAT masking paths' first batches, with each path's first
    layer's parameters and edge inputs."""
    out = {}
    gen = torch.Generator().manual_seed(4)
    for domain in ("chem", "bio"):
        cfg = pretrain.PretrainConfig(device_dataset="off",
                                      domain=domain, num_layer=5, emb_dim=300,
                                      batch_size=256, mask_edge=False,
                                      seed=0, packing="auto", gnn_type="gat")
        graphs = (bio_dataset(4096, seed=0) if domain == "bio"
                  else molecule_dataset(4096, seed=0, mean_atoms=23)[0])
        b = next(iter(pretrain.build_loader(cfg, graphs, dev))).to(dev)
        conv = pretrain.build_objective(cfg).to(dev).gnn.gnns[0]
        ein = (bio.edge_inputs(b, torch.float32) if domain == "bio"
               else chem.bond_one_hot(b, torch.float32))
        nm = b.node_mask.to(torch.float32)
        N, H, D, bn, be = (b.max_nodes, conv.heads, conv.emb_dim,
                           b.block_nodes, b.block_edges)
        rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
        h = rnd(N, D) * nm[:, None]
        g, g3 = rnd(N, D) * nm[:, None], rnd(N, H, D) * nm[:, None, None]
        with torch.no_grad():
            We, e_self = conv.edge_kernel()
            par = [We.contiguous(), e_self.reshape(H, D).contiguous(),
                   conv.att[0, :, :D].contiguous(),
                   conv.att[0, :, D:].contiguous()]
            Wl, bl = conv.weight_linear.weight.t(), conv.weight_linear.bias
            bias = rnd(D) * 0.1
            x5 = (h @ Wl + bl).reshape(N, H, D).contiguous()
            e5 = (ein @ par[0]).reshape(-1, H, D).contiguous()
        graph = (b.senders, b.receivers, b.edge_mask.to(torch.float32))
        res = {}

        def k4_fwd(res=res, h=h, Wl=Wl, bl=bl, ein=ein, par=par, bias=bias,
                   graph=graph, bn=bn, be=be):
            res["fx"] = gc.gat_conv_fwd(h, Wl, bl, ein, *par, bias, *graph,
                                        bn, be)

        def k4_bwd(res=res, g=g, h=h, Wl=Wl, ein=ein, par=par, graph=graph,
                   bn=bn, be=be):
            _, xx, saved = res["fx"]
            gc.gat_conv_bwd(g, h, Wl, xx, ein, *par, *graph, saved, bn, be)

        def k5_fwd(res=res, x5=x5, e5=e5, par=par, graph=graph, bn=bn,
                   be=be):
            res["f5"] = attention.gat_attn_fwd(x5, e5, *par[1:], *graph, 0.2,
                                               bn, be)

        def k5_bwd(res=res, g3=g3, x5=x5, e5=e5, par=par, graph=graph,
                   bn=bn, be=be):
            attention.gat_attn_bwd(g3, x5, e5, *par[1:], *graph,
                                   res["f5"][1], 0.2, bn, be)

        def k4_fwd16(res=res, h=h, Wl=Wl, bl=bl, ein=ein, par=par,
                     bias=bias, graph=graph, bn=bn, be=be):
            res["fx16"] = gc.gat_conv_fwd(h, Wl, bl, ein, *par, bias, *graph,
                                          bn, be, 0.2, BF)

        def k4_bwd16(res=res, g=g, h=h, Wl=Wl, ein=ein, par=par, graph=graph,
                     bn=bn, be=be):
            _, xx, saved = res["fx16"]
            gc.gat_conv_bwd(g, h, Wl, xx, ein, *par, *graph, saved, bn, be,
                            0.2, BF)

        def k5_fwd16(res=res, x5=x5, e5=e5, par=par, graph=graph, bn=bn,
                     be=be):
            res["f516"] = attention.gat_attn_fwd(x5, e5, *par[1:], *graph,
                                                 0.2, bn, be, BF)

        def k5_bwd16(res=res, g3=g3, x5=x5, e5=e5, par=par, graph=graph,
                     bn=bn, be=be):
            attention.gat_attn_bwd(g3, x5, e5, *par[1:], *graph,
                                   res["f516"][1], 0.2, bn, be, BF)

        if "k4" in kernels:
            out[f"gat_conv_fwd {domain}"] = k4_fwd
            out[f"gat_conv_bwd {domain}"] = k4_bwd
            out[f"gat_conv_fwd[bf16] {domain}"] = k4_fwd16
            out[f"gat_conv_bwd[bf16] {domain}"] = k4_bwd16
        if "k5" in kernels:
            out[f"blocked_gat_attention_fwd {domain}"] = k5_fwd
            out[f"blocked_gat_attention_bwd {domain}"] = k5_bwd
            out[f"blocked_gat_attention_fwd[bf16] {domain}"] = k5_fwd16
            out[f"blocked_gat_attention_bwd[bf16] {domain}"] = k5_bwd16
    return out


def cases(dev):
    """``{kernel: callable}`` for K1 on the chem masking first batch: in
    float32, and at compute_dtype bfloat16 with bfloat16 rows (the
    ``bfloat16_act`` path's) and float32 rows, and bfloat16 rows at
    float32 compute."""
    graphs, _ = molecule_dataset(4096, seed=0, mean_atoms=23)
    gen = torch.Generator().manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    cfg = pretrain.PretrainConfig(device_dataset="off",
                                  num_layer=5, emb_dim=300, batch_size=256,
                                  mask_edge=False, seed=0, packing="auto")
    b = next(iter(pretrain.build_loader(cfg, graphs, dev))).to(dev)
    conv = pretrain.build_objective(cfg).to(dev).gnn.gnns[0]
    nm = b.node_mask.to(torch.float32)
    x = rnd(b.max_nodes, 300) * nm[:, None]
    g = rnd(b.max_nodes, 300) * nm[:, None]
    bn, be = b.block_nodes, b.block_edges
    with torch.no_grad():
        args = conv.conv_inputs(x, b)
    args = args[:11] + (nm,) + args[12:]
    (_, ein, _, _, W1, _, W2, _, snd, rcv, w, _, _, _) = args
    res = {}

    def k1_fwd():
        res["fz"] = gin_conv.gin_conv_fwd(*args)

    def k1_bwd():
        _, aggr, z = res["fz"]
        gin_conv.gin_conv_bwd(g, aggr, z, ein, W1, W2, snd, rcv, w, nm, bn,
                              be)
    out = {"gin_conv_fwd": k1_fwd, "gin_conv_bwd": k1_bwd}
    bf, f32 = torch.bfloat16, torch.float32
    for tag, rows, cdt in (("bf16", bf, bf), ("bf16, f32 rows", f32, bf),
                           ("bf16 rows, f32 compute", bf, f32)):
        a, gr = (x.to(rows),) + args[1:], g.to(rows)

        def fwd(tag=tag, a=a, cdt=cdt):
            res[tag] = gin_conv.gin_conv_fwd(*a, compute_dtype=cdt)

        def bwd(tag=tag, gr=gr, cdt=cdt):
            _, aggr, z = res[tag]
            gin_conv.gin_conv_bwd(gr, aggr, z, ein, W1, W2, snd, rcv, w, nm,
                                  bn, be, cdt)
        out[f"gin_conv_fwd[{tag}]"] = fwd
        out[f"gin_conv_bwd[{tag}]"] = bwd
    return out


PARTS_TRIALS = 20


def _short(name: str) -> str:
    """A kernel's name without its namespace and arguments."""
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    return re.sub(r"\(.*$", "", name)[:72]


def launch_parts(fn):
    """``(parts, span_ms)`` of ``fn``'s calls on the card: ``parts`` the
    median device ms of each of its launches, ``[(name, ms)]`` in launch
    order, over PARTS_TRIALS calls (each after a 2 ms spin, whose kernel
    also marks where a call's launches start), and the median of the
    calls' spans from the first kernel's start to the last one's end."""
    from torch.autograd import DeviceType

    for _ in range(chip_smoke.WARMUP):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PARTS_TRIALS):
            torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
            fn()
        torch.cuda.synchronize()
    calls = []
    for start, end, name in sorted(
            (e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CUDA):
        if "spin_kernel" in name:
            calls.append([])
        elif calls:
            calls[-1].append((start, end, name))
    # the profiler may miss a record (the first spin, a kernel): the calls
    # with the most common count of kernels stand, at least half of them
    n = statistics.mode(len(c) for c in calls)
    calls = [c for c in calls if len(c) == n]
    if len(calls) < PARTS_TRIALS // 2 or not n:
        raise AssertionError(f"{len(calls)} whole calls of {n} kernels")
    parts = [(_short(calls[0][i][2]), statistics.median(
        (c[i][1] - c[i][0]) / 1e3 for c in calls)) for i in range(n)]
    span = statistics.median((c[-1][1] - c[0][0]) / 1e3 for c in calls)
    return parts, span


def parts_main(ref_csrc: str, card: str, only: str = "",
               kernels=("k4",)) -> int:
    """``--parts``: the launches of K4 (float32 and bfloat16) or K2's
    cases (``--kernels k2``), those whose name holds ``only``, both
    trees."""
    dev = resolve_device("cuda")
    cases = gat_cases(dev, ["k4"]) if "k4" in kernels else k2_cases(dev)
    fns = {k: fn for k, fn in cases.items()
           if only in k or only in k.replace("bwd", "fwd")}
    out = collections.defaultdict(dict)
    with tempfile.TemporaryDirectory() as tmp:
        ref = {SOURCES[k]: build(ref_csrc, SOURCES[k], tmp) for k in kernels}
        for tag in ("ref", "tree"):
            use(ref if tag == "ref" else {})
            with torch.no_grad():
                for k, fn in fns.items():
                    if "bwd" in k:
                        fns[k.replace("bwd", "fwd")]()  # its inputs
                    parts, span = launch_parts(fn)
                    out[k][tag] = parts, span, chip_smoke.time_ms(fn, torch)
        use({})
    print(f"card: {card}; the launches, device ms a launch (profiler "
          f"kernel records, median of {PARTS_TRIALS} calls after a 2 ms "
          f"spin), reference {ref_csrc} and this tree")
    if "k4" in kernels:
        k4_product_alone(dev)
    for k, trees in out.items():
        for tag, (parts, span, ms) in trees.items():
            print(f"  {k} [{tag}]: {len(parts)} launches, kernels "
                  f"{sum(t for _, t in parts):.4f} ms, span {span:.4f} ms, "
                  f"event pair {ms:.4f} ms")
            for i, (name, t) in enumerate(parts):
                print(f"    {i:2d} {t:.4f} {name}")
    return 0


def k4_product_alone(dev) -> None:
    """K4's x product alone at the chem batch's shape (this tree's gemm.cuh,
    through K1's library): with and without the ordered-tie fixup."""
    gen = torch.Generator().manual_seed(4)
    h16 = torch.randn(8192, 300, generator=gen).to(dev, BF)
    w16 = torch.randn(600, 300, generator=gen).to(dev, BF).t()
    bl = torch.randn(600, generator=gen).to(dev)
    with torch.no_grad():
        gemm = {tag: chip_smoke.time_ms(
            lambda ties=ties: gin_conv.gemm_bf16(h16, w16, bl,
                                                 ordered_ties=ties), torch)
            for tag, ties in (("ordered ties", True), ("no fixup", False))}
        gemm["torch.matmul"] = chip_smoke.time_ms(
            lambda: torch.matmul(h16, w16), torch)
    print("  K4's x product alone, [8192, 300] @ [300, 600] bf16 (event "
          "pairs): " + ", ".join(f"{k} {v:.4f} ms" for k, v in gemm.items()))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ref_csrc", required=True,
                   help="the other checkout's pretrain_gnns_tpu_torch/csrc")
    p.add_argument("--kernels", default="k1,k4",
                   help="comma-separated, of k1, k4, k5, k2, k3, k6 and k7")
    p.add_argument("--parts", action="store_true",
                   help="time K4's (or with --kernels k2, K2's) launches "
                        "one by one instead")
    p.add_argument("--only", default="",
                   help="--parts: the cases whose name holds this")
    args = p.parse_args()
    kernels = args.kernels.split(",")
    if args.parts:
        return parts_main(args.ref_csrc, chip_smoke.card_line(), args.only,
                          ["k2"] if kernels == ["k2"] else ["k4"])
    if not set(kernels) <= set(SOURCES):
        p.error(f"--kernels takes {sorted(SOURCES)}")
    dev = resolve_device("cuda")
    card = chip_smoke.card_line()
    fns = {}
    if "k1" in kernels:
        fns.update(cases(dev))
    if {"k4", "k5"} & set(kernels):
        fns.update(gat_cases(dev, kernels))
    if "k2" in kernels:
        fns.update(k2_cases(dev))
    if "k3" in kernels:
        fns.update(k3_cases(dev))
    if "k6" in kernels:
        fns.update(k6_cases(dev))
    if "k7" in kernels:
        fns.update(k7_cases(dev))
    times = {k: {"tree": [], "ref": []} for k in fns}
    with tempfile.TemporaryDirectory() as tmp:
        ref = {src: build(args.ref_csrc, src, tmp)
               for src in {SOURCES[k] for k in kernels}}
        for tag in ("ref", "tree", "tree", "ref"):
            use(ref if tag == "ref" else {})
            with torch.no_grad():
                for k, fn in fns.items():
                    try:
                        if k.startswith(("gin_conv_bwd", "gat_conv_bwd",
                                         "blocked_gat_attention_bwd")):
                            fns[k.replace("bwd", "fwd")]()  # its outputs
                        times[k][tag].append(chip_smoke.time_ms(fn, torch))
                    except ValueError:  # an older library's float32 only
                        if tag == "tree":
                            raise
        use({})
    print(f"card: {card}; device ms a call (chip_smoke.time_ms), reference "
          f"{args.ref_csrc} vs this tree, runs in the order ref, tree, tree, "
          "ref")
    for k, t in times.items():
        n = statistics.mean(t["tree"])
        if not t["ref"]:
            print(f"  {k}: reference n/a, this tree {n:.4f} ms "
                  f"{['%.4f' % v for v in t['tree']]}")
            continue
        r = statistics.mean(t["ref"])
        print(f"  {k}: reference {r:.4f} ms {['%.4f' % v for v in t['ref']]}"
              f", this tree {n:.4f} ms {['%.4f' % v for v in t['tree']]}: "
              f"{r / n:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
