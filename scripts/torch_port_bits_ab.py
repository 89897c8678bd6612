#!/usr/bin/env python3
"""Bit-for-bit A/B of the fused GIN conv (K1), the blocked SpMM on a
precomputed edge embedding (K6), its receiver-sorted variant (K7) and the
pair-dot head's backward (K3 ``dx``) between this tree's
``csrc/gin_conv.cu``, ``csrc/spmm_ee.cu`` and ``csrc/edge_dot.cu`` (with
the headers they include) and those of another checkout, on one GPU.

Run from the repository root, with the other checkout's ``csrc`` directory
(for example a ``git archive`` of the parent commit unpacked under
``_archive/``):

    python3 scripts/torch_port_bits_ab.py --ref_csrc _archive/parent/pretrain_gnns_tpu_torch/csrc

It builds the other sources with this tree's ``nvcc`` flags into a
temporary directory, then runs both libraries through this tree's wrappers.
K1 on the chem masking path's first batch (the first layer's weights and
bond one-hots, random x and cotangent; the path's 0/1 edge weights and
fractional, partly negative ones): ``out``, ``aggr``, ``z`` and the seven
gradients. K6 and K7 on the chem and bio masking paths' first batches (256
graphs, F = 300, a random edge embedding, fractional and partly negative
edge weights): K6 forward with and without the edge embedding, K6
backward (``dx`` and ``dmsg`` together and each alone) and K7 forward on
the sorted slots, with and without the edge embedding. K3's ``dx`` on the
chem and bio edge-prediction paths' first batches, both heads, with the
path's 0/1 pair weights and the cotangent the path gives it (0 on the
positive head's odd slots) and with fractional, partly negative weights
and a random cotangent on every pair. (K3's scores are summed in another
order since the redesign, so they are not compared.) It prints whether every output is equal bit for bit and
exits non-zero if one is not.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from pretrain_gnns_tpu_torch.data.synthetic import (  # noqa: E402
    bio_dataset, molecule_dataset,
)
from pretrain_gnns_tpu_torch.device import resolve_device  # noqa: E402
from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs  # noqa: E402
from pretrain_gnns_tpu_torch.ops import edge_dot as ed  # noqa: E402
from pretrain_gnns_tpu_torch.ops import gin_conv  # noqa: E402
from pretrain_gnns_tpu_torch.ops import sorted_spmm as ss  # noqa: E402
from pretrain_gnns_tpu_torch.train import pretrain  # noqa: E402
from scripts.torch_port_k1_k4_ab import build, use  # noqa: E402

F = 300


def config(domain: str):
    return pretrain.PretrainConfig(domain=domain, num_layer=5, emb_dim=F,
                                   batch_size=256, mask_edge=False, seed=0,
                                   packing="auto")


def first_batch(domain: str, dev, cfg=None):
    if domain == "bio":
        graphs = bio_dataset(4096, seed=0)
    else:
        graphs, _ = molecule_dataset(4096, seed=0, mean_atoms=23)
    return next(iter(pretrain.build_loader(cfg or config(domain), graphs,
                                           dev))).to(dev)


def k3_outputs(batch, seed: int):
    """K3's ``dx`` for both heads on an edge-prediction ``batch`` through
    the loaded library."""
    gen = torch.Generator().manual_seed(seed)
    dev = batch.node_mask.device
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    x = rnd(batch.max_nodes, F) * batch.node_mask[:, None]
    neg = batch.extras["negative_edges_blocked"]
    heads = {"pos": (batch.receivers, batch.senders, batch.edge_mask,
                     batch.block_edges, 2),
             "neg": (neg[:, 0].contiguous(), neg[:, 1].contiguous(),
                     batch.extras["negative_edges_blocked_mask"],
                     batch.block_edges // 2, 1)}
    out = {}
    with torch.no_grad():
        for head, (a_idx, b_idx, valid, ppb, stride) in heads.items():
            P = a_idx.shape[0]
            g = rnd(P)
            g_path = torch.zeros_like(g)
            g_path[::stride] = g[::stride]
            w = valid.to(torch.float32)
            w_frac = w * (torch.rand(P, generator=gen) * 2 - 0.5).to(dev)
            for tag, gg, ww in (("", g_path, w),
                                (" fractional w", g, w_frac)):
                out[f"K3 dx {head}{tag}"] = ed.edot_bwd(
                    gg, x, a_idx, b_idx, ww, batch.block_nodes, ppb)
    torch.cuda.synchronize()
    return out


def k1_outputs(batch, conv, seed: int):
    """K1's ``out``, ``aggr``, ``z`` and seven gradients on ``batch``
    through the loaded library, with the path's edge weights and with
    fractional ones."""
    gen = torch.Generator().manual_seed(seed)
    dev = batch.node_mask.device
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    nm = batch.node_mask.to(torch.float32)
    x = rnd(batch.max_nodes, F) * nm[:, None]
    g = rnd(batch.max_nodes, F) * nm[:, None]
    names = ("out", "aggr", "z", "dx", "dWe", "de_self", "dW1", "db1", "dW2",
             "db2")
    out = {}
    with torch.no_grad():
        args = conv.conv_inputs(x, batch)
        args = args[:11] + (nm,) + args[12:]
        (_, ein, _, _, W1, _, W2, _, snd, rcv, w, _, bn, be) = args
        for tag, ww in (("", w), (" fractional w", w * rnd(w.shape[0]))):
            a = args[:10] + (ww,) + args[11:]
            res = gin_conv.gin_conv_fwd(*a)
            res += gin_conv.gin_conv_bwd(g, res[1], res[2], ein, W1, W2, snd,
                                         rcv, ww, nm, bn, be)
            out.update({f"K1 {n}{tag}": t for n, t in zip(names, res)})
    torch.cuda.synchronize()
    return out


def outputs(batch, seed: int):
    """Every K6 and K7 output on ``batch`` through the loaded library."""
    gen = torch.Generator().manual_seed(seed)
    dev = batch.node_mask.device
    N, E = batch.max_nodes, batch.max_edges
    bn, be = batch.block_nodes, batch.block_edges
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    x = rnd(N, F) * batch.node_mask[:, None]
    ee, g = rnd(E, F), rnd(N, F)
    w = batch.edge_mask.float() * rnd(E)
    edges = (batch.senders, batch.receivers, w, bn, be)
    out = {}
    with torch.no_grad():
        out["fwd[x+ee]"] = bs.spmm_ee_fwd(x, ee, *edges)
        out["fwd[x]"] = bs.spmm_ee_fwd(x, None, *edges)
        out["bwd dx"], out["bwd dmsg"] = bs.spmm_ee_bwd(g, *edges, True)
        out["bwd dx alone"] = bs.spmm_ee_bwd(g, *edges, True, True, False)[0]
        out["bwd dmsg alone"] = bs.spmm_ee_bwd(g, *edges, True, False,
                                               True)[1]
        s, r, ws, es = ss.sort_block_edges(batch.senders, batch.receivers, w,
                                           ee, N // bn, be)
        out["K7 fwd[x+ee]"] = ss.sorted_spmm_fwd(x, es, s, r, ws, bn, be)
        out["K7 fwd[x]"] = ss.sorted_spmm_fwd(x, None, s, r, ws, bn, be)
    torch.cuda.synchronize()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ref_csrc", required=True,
                   help="the other checkout's pretrain_gnns_tpu_torch/csrc")
    args = p.parse_args()
    dev = resolve_device("cuda")
    batches = {d: first_batch(d, dev) for d in ("chem", "bio")}
    edgepred = {d: first_batch(d, dev, pretrain.PretrainConfig(
        objective="edgepred", domain=d, num_layer=5, emb_dim=F,
        batch_size=256, seed=0, packing="auto")) for d in ("chem", "bio")}
    conv = pretrain.build_objective(config("chem")).to(dev).gnn.gnns[0]
    with tempfile.TemporaryDirectory() as tmp:
        ref = {name: build(args.ref_csrc, name, tmp)
               for name in ("gin_conv", "spmm_ee", "edge_dot")}
        results = {}
        for tag in ("tree", "ref"):
            use(ref if tag == "ref" else {})
            results[tag] = {f"{d} {k}": v for d, b in batches.items()
                            for k, v in outputs(b, seed=7).items()}
            results[tag].update({f"chem {k}": v for k, v in k1_outputs(
                batches["chem"], conv, seed=8).items()})
            results[tag].update({f"{d} {k}": v for d, b in edgepred.items()
                                 for k, v in k3_outputs(b, seed=9).items()})
        use({})
    bad = [k for k in results["tree"]
           if not torch.equal(results["tree"][k], results["ref"][k])]
    n = len(results["tree"])
    print(f"card: {torch.cuda.get_device_name(0)}; K1/K3/K6/K7 outputs of this "
          f"tree vs {args.ref_csrc}: {n - len(bad)} of {n} equal bit for bit"
          + (f"; differ: {bad}" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
