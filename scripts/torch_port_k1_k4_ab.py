#!/usr/bin/env python3
"""Timing A/B of the fused GIN conv (K1), the fused GAT conv (K4), the
blocked GAT attention (K5), the fused edge-transform SpMM (K2) and the
pair-dot head (K3), forward and backward, and of the receiver-sorted SpMM
(K7), between this tree's ``csrc/gin_conv.cu``, ``csrc/gat.cu``,
``csrc/spmm.cu``, ``csrc/edge_dot.cu`` and ``csrc/spmm_ee.cu`` (with the
headers they include) and those of another checkout, in one process on
one GPU.

Run from the repository root, with the other checkout's ``csrc`` directory
(for example a ``git archive`` of the parent commit unpacked under
``_archive/``):

    python3 scripts/torch_port_k1_k4_ab.py --ref_csrc _archive/parent/pretrain_gnns_tpu_torch/csrc [--kernels k1,k4,k5,k2,k3,k7]

The libraries of both trees have the same C interfaces. The script builds
the other sources with this tree's ``nvcc`` flags, then times each kernel
(device ms a call, ``chip_smoke.time_ms``) in the order reference, this
tree, this tree, reference, and prints each time beside the card's name
and power limit. Shapes: K1 on the chem masking path's first batch (GIN 5
x 300); K4 and K5 on the chem and bio GAT masking paths' first batches
(GAT 5 x 300 with 2 heads; K5 on x and e as the unfused conv forms them,
as ``chip_smoke.py`` times it); K2 ``[x]``, ``[ein]`` and
``[x+ein]`` on the bio masking path's first batch (the first layer's
``[edge_feat | 1]`` edge inputs and edge kernel, K = 10) and ``[x+ein]``
on the chem edge-prediction path's first batch with the GCN trunk's bond
one-hots (K = 9) and symmetric-normalised edge weights, as
``chip_smoke.py`` times them; K3 on the chem and bio edge-prediction
paths' first batches, both heads, the backward with the cotangent the path
gives it (0 on the positive head's odd slots), as ``chip_smoke.py`` times
it; K7 with and without an edge embedding on the chem and bio masking
paths' first batches (fractional, partly negative edge weights, the slots
sorted by ``sort_block_edges``), with K6's forward ``[x+ee]`` on the
unsorted slots timed beside it. Random inputs from a seed.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

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


def build(srcdir: str, name: str, out_dir: str) -> ctypes.CDLL:
    lib = os.path.join(out_dir, f"lib{name}_ref.so")
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
                          os.path.join(srcdir, f"{name}.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stdout}"
                           f"{res.stderr}")
    return ctypes.CDLL(lib)


SOURCES = {"k1": "gin_conv", "k4": "gat", "k5": "gat", "k2": "spmm",
           "k3": "edge_dot", "k7": "spmm_ee"}


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
    if gin_lib is not None:  # the K1 entry points only
        L, I = ctypes.c_longlong, ctypes.c_int
        gin_lib.pgt_gin_conv_fwd.argtypes = gin_conv._FWD_ARGS
        gin_lib.pgt_gin_conv_bwd.argtypes = gin_conv._BWD_ARGS
        gin_lib.pgt_gin_conv_bwd_workspace.argtypes = [I] * 5
        gin_lib.pgt_gin_conv_bwd_workspace.restype = L
        for f in (gin_lib.pgt_gin_conv_fwd, gin_lib.pgt_gin_conv_bwd,
                  gin_lib.pgt_gin_conv_max_block_nodes,
                  gin_lib.pgt_gin_conv_max_k):
            f.restype = I
        gin_conv._lib = lambda: gin_lib
    else:
        gin_conv._lib = _tree_gin_lib


_tree_gin_lib = gin_conv._lib


def k2_cases(dev):
    """``{kernel: callable}`` for K2's six rows: the bio masking path's
    first batch and, for ``[x+ein]``, the chem GCN edge-prediction one."""
    gen = torch.Generator().manual_seed(2)
    out = {}
    bio_cfg = pretrain.PretrainConfig(domain="bio", num_layer=5, emb_dim=300,
                                      batch_size=256, seed=0,
                                      packing="auto")
    gcn_cfg = pretrain.PretrainConfig(objective="edgepred", gnn_type="gcn",
                                      num_layer=5, emb_dim=300,
                                      batch_size=256, seed=0,
                                      packing="auto")
    chem_graphs, _ = molecule_dataset(4096, seed=0, mean_atoms=23)
    for tag, cfg, graphs in (("bio", bio_cfg, bio_dataset(4096, seed=0)),
                             ("chem GCN", gcn_cfg, chem_graphs)):
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
        else:
            ein = chem.bond_one_hot(b, torch.float32)
            dis = chem.inv_sqrt_degree(b)
            w = w * dis[b.receivers.long()] * dis[b.senders.long()]
            variants = ((True, True),)
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
    return out


def k3_cases(dev):
    """``{kernel: callable}`` for K3, both heads and directions, on the
    chem and bio edge-prediction paths' first batches."""
    gen = torch.Generator().manual_seed(3)
    out = {}
    for domain in ("chem", "bio"):
        cfg = pretrain.PretrainConfig(objective="edgepred", domain=domain,
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


def k7_cases(dev):
    """``{kernel: callable}`` for K7 with and without an edge embedding,
    and K6's forward ``[x+ee]`` beside it, on the chem and bio masking
    paths' first batches."""
    gen = torch.Generator().manual_seed(6)
    out = {}
    for domain in ("chem", "bio"):
        cfg = pretrain.PretrainConfig(domain=domain, num_layer=5, emb_dim=300,
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
    return out


def gat_cases(dev, kernels):
    """``{kernel: callable}`` for K4 and K5 (those of ``kernels``) on the
    chem and bio GAT masking paths' first batches, with each path's first
    layer's parameters and edge inputs."""
    out = {}
    gen = torch.Generator().manual_seed(4)
    for domain in ("chem", "bio"):
        cfg = pretrain.PretrainConfig(domain=domain, num_layer=5, emb_dim=300,
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

        if "k4" in kernels:
            out[f"gat_conv_fwd {domain}"] = k4_fwd
            out[f"gat_conv_bwd {domain}"] = k4_bwd
        if "k5" in kernels:
            out[f"blocked_gat_attention_fwd {domain}"] = k5_fwd
            out[f"blocked_gat_attention_bwd {domain}"] = k5_bwd
    return out


def cases(dev):
    """``{kernel: callable}`` for K1 on the chem masking first batch."""
    graphs, _ = molecule_dataset(4096, seed=0, mean_atoms=23)
    gen = torch.Generator().manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    cfg = pretrain.PretrainConfig(num_layer=5, emb_dim=300, batch_size=256,
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
    return {"gin_conv_fwd": k1_fwd, "gin_conv_bwd": k1_bwd}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ref_csrc", required=True,
                   help="the other checkout's pretrain_gnns_tpu_torch/csrc")
    p.add_argument("--kernels", default="k1,k4",
                   help="comma-separated, of k1, k4, k5, k2, k3 and k7")
    args = p.parse_args()
    kernels = args.kernels.split(",")
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
                    if k.startswith(("gin_conv_bwd", "gat_conv_bwd",
                                     "blocked_gat_attention_bwd")):
                        fns[k.replace("bwd", "fwd")]()  # its saved outputs
                    times[k][tag].append(chip_smoke.time_ms(fn, torch))
        use({})
    print(f"card: {card}; device ms a call (chip_smoke.time_ms), reference "
          f"{args.ref_csrc} vs this tree, runs in the order ref, tree, tree, "
          "ref")
    for k, t in times.items():
        r, n = statistics.mean(t["ref"]), statistics.mean(t["tree"])
        print(f"  {k}: reference {r:.4f} ms {['%.4f' % v for v in t['ref']]}"
              f", this tree {n:.4f} ms {['%.4f' % v for v in t['tree']]}: "
              f"{r / n:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
