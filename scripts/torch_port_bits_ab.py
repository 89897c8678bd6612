#!/usr/bin/env python3
"""Bit-for-bit A/B of the fused GIN conv (K1), the fused edge-transform
SpMM (K2), the blocked SpMM on a precomputed edge embedding (K6), its
receiver-sorted variant (K7), the pair-dot head's backward (K3 ``dx``),
the fused GAT conv (K4) and the blocked GAT attention (K5) between this
tree's ``csrc`` libraries (``gin_conv``, ``spmm``, ``spmm_ee``,
``edge_dot`` and ``gat``, with the headers they include) and those of
another checkout, on one GPU.

Run from the repository root, with the other checkout's ``csrc`` directory
(for example a ``git archive`` of the parent commit unpacked under
``_archive/``):

    python3 scripts/torch_port_bits_ab.py --ref_csrc _archive/parent/pretrain_gnns_tpu_torch/csrc

It builds the other sources with this tree's ``nvcc`` flags into a
temporary directory, then runs both libraries through this tree's wrappers.
K1 on the chem masking path's first batch (the first layer's weights and
bond one-hots, random x and cotangent; the path's 0/1 edge weights and
fractional, partly negative ones): ``out``, ``aggr``, ``z`` and the seven
gradients; the same with ``x`` and the cotangent in bfloat16 at float32
compute (the float32 kernels on the stored values), and at compute dtype
bfloat16 on bfloat16 and on float32 rows (``K1 bf16:``). K2's three
variants on the bio masking path's first batch
(random x, cotangent, K = 10 edge inputs and edge kernel, fractional and
partly negative edge weights): ``out``, ``dx`` and ``dW``, at float32 and
at compute dtype bfloat16 on bfloat16 and float32 rows (``K2 bf16:``, with
the path's 0/1 edge weights too). K6 and K7 on
the chem and bio masking paths' first batches (256 graphs, F = 300, a
random edge embedding, fractional and partly negative edge weights): K6
forward with and without the edge embedding, K6 backward (``dx`` and
``dmsg`` together and each alone) and K7 forward on the sorted slots,
with and without the edge embedding. K3's ``dx`` on the
chem and bio edge-prediction paths' first batches, both heads, with the
path's 0/1 pair weights and the cotangent the path gives it (0 on the
positive head's odd slots) and with fractional, partly negative weights
and a random cotangent on every pair. (K3's scores are summed in another
order since the redesign, so they are not compared.) K4 and K5 on the chem
and bio GAT masking paths' first batches with the first layer's
parameters, at float32 (with K4's and K5's saved softmax scalars) and at
compute dtype bfloat16 (``bf16:``; K4's ``out``, ``x`` and eight
gradients, K5's every output). It prints whether every output is equal bit
for bit, and how far each one that is not lies from the other tree's, and
exits non-zero if one is not, but for K4 bfloat16's ``dWe`` and K2
bfloat16's ``dW`` and forward with ``ein`` (``resummed``: summed on the
tensor cores in one tree, by the CUDA cores in an older one).
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
from pretrain_gnns_tpu_torch.models import bio, chem  # noqa: E402
from pretrain_gnns_tpu_torch.ops import attention  # noqa: E402
from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs  # noqa: E402
from pretrain_gnns_tpu_torch.ops import gat_conv as gc  # noqa: E402
from pretrain_gnns_tpu_torch.ops import edge_dot as ed  # noqa: E402
from pretrain_gnns_tpu_torch.ops import gin_conv  # noqa: E402
from pretrain_gnns_tpu_torch.ops import sorted_spmm as ss  # noqa: E402
from pretrain_gnns_tpu_torch.train import pretrain  # noqa: E402
from scripts.torch_port_k1_k4_ab import build, use  # noqa: E402

F = 300
BF16_ROWS = "K1 bf16 rows at float32 compute:"
BF16 = "bf16:"  # K4's and K5's bfloat16 variants
K1_BF16, K2_BF16 = "K1 bf16:", "K2 bf16:"
# K4 bfloat16's dWe, and K2 bfloat16's dW and its edge terms (the forward
# with ein), are summed on the tensor cores (an older checkout may sum them
# on the CUDA cores, slot by slot): their distance from the other tree's is
# printed, their bits are not required equal.
RESUMMED = ("bf16: chem K4 dWe", "bf16: bio K4 dWe")


def resummed(key: str) -> bool:
    return key in RESUMMED or (key.startswith(K2_BF16) and (
        key.endswith(" dW") or "K2 fwd[ein]" in key
        or "K2 fwd[x+ein]" in key))


def config(domain: str):
    return pretrain.PretrainConfig(device_dataset="off",
                                   domain=domain, num_layer=5, emb_dim=F,
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


def k1_outputs(batch, conv, seed: int, rows=torch.float32,
               cdt=torch.float32):
    """K1's ``out``, ``aggr``, ``z`` and seven gradients on ``batch``
    through the loaded library at compute dtype ``cdt``, with the path's
    edge weights and with fractional ones; ``x`` and the cotangent in
    ``rows``."""
    gen = torch.Generator().manual_seed(seed)
    dev = batch.node_mask.device
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    nm = batch.node_mask.to(torch.float32)
    x = (rnd(batch.max_nodes, F) * nm[:, None]).to(rows)
    g = (rnd(batch.max_nodes, F) * nm[:, None]).to(rows)
    names = ("out", "aggr", "z", "dx", "dWe", "de_self", "dW1", "db1", "dW2",
             "db2")
    out = {}
    with torch.no_grad():
        args = conv.conv_inputs(x, batch)
        args = args[:11] + (nm,) + args[12:]
        (_, ein, _, _, W1, _, W2, _, snd, rcv, w, _, bn, be) = args
        for tag, ww in (("", w), (" fractional w", w * rnd(w.shape[0]))):
            a = args[:10] + (ww,) + args[11:]
            res = gin_conv.gin_conv_fwd(*a, compute_dtype=cdt)
            res += gin_conv.gin_conv_bwd(g, res[1], res[2], ein, W1, W2, snd,
                                         rcv, ww, nm, bn, be, cdt)
            out.update({f"K1 {n}{tag}": t for n, t in zip(names, res)})
    torch.cuda.synchronize()
    return out


def k2_outputs(batch, seed: int, cdt=torch.float32):
    """K2's ``out``, ``dx`` and ``dW`` in its three variants on ``batch``
    through the loaded library at compute dtype ``cdt`` (at bfloat16 on
    bfloat16 and float32 rows, with the fractional edge weights and the
    path's 0/1 ones)."""
    gen = torch.Generator().manual_seed(seed)
    dev = batch.node_mask.device
    N, E, K = batch.max_nodes, batch.max_edges, 10
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    x, g = rnd(N, F) * batch.node_mask[:, None], rnd(N, F)
    ein, W = rnd(E, K), rnd(K, F)
    mask = batch.edge_mask.float()
    weights = {"": mask * rnd(E)}
    cases = [("", torch.float32)]
    if cdt == torch.bfloat16:
        weights[" 0/1 w"] = mask
        cases = [(f" rows {str(r)[6:]}", r)
                 for r in (torch.bfloat16, torch.float32)]
    blocks = (batch.block_nodes, batch.block_edges)
    out = {}
    with torch.no_grad():
        for wtag, w in weights.items():
            edges = (batch.senders, batch.receivers, w)
            for rtag, rows in cases:
                xr, gr = x.to(rows), g.to(rows)
                for flags in ((True, False), (False, True), (True, True)):
                    v, tag = bs.variant(*flags), f"{rtag}{wtag}"
                    out[f"K2 fwd[{v}]{tag}"] = bs.spmm_fwd(
                        xr, ein, W, *edges, *blocks, *flags, cdt)
                    dx, dW = bs.spmm_bwd(gr, ein, *edges, K, *blocks, *flags,
                                         cdt)
                    out.update({f"K2 bwd[{v}]{tag} {n}": t for n, t in
                                (("dx", dx), ("dW", dW)) if t is not None})
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


def gat_outputs(batch, conv, ein, seed: int, dt=torch.float32):
    """K4's ``out``, ``x`` and eight gradients and K5's ``out``, softmax
    scalars, ``dx``, ``de`` and ``dpar`` on a GAT ``batch`` through the
    loaded library at compute dtype ``dt``, with the first layer's
    parameters (``conv``) and edge inputs ``ein``. At bfloat16 K4's saved
    softmax is not compared (an older library saved none)."""
    gen = torch.Generator().manual_seed(seed)
    dev = batch.node_mask.device
    N, H, D = batch.max_nodes, conv.heads, conv.emb_dim
    bn, be = batch.block_nodes, batch.block_edges
    nm = batch.node_mask.to(torch.float32)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    h, g = rnd(N, D) * nm[:, None], rnd(N, D) * nm[:, None]
    g3 = rnd(N, H, D) * nm[:, None, None]
    graph = (batch.senders, batch.receivers, batch.edge_mask.float())
    out = {}
    with torch.no_grad():
        We, e_self = conv.edge_kernel()
        par = [We.contiguous(), e_self.reshape(H, D).contiguous(),
               conv.att[0, :, :D].contiguous(),
               conv.att[0, :, D:].contiguous()]
        Wl, bl = conv.weight_linear.weight.t(), conv.weight_linear.bias
        bias = rnd(D) * 0.1
        o, x, saved = gc.gat_conv_fwd(h, Wl, bl, ein, *par, bias, *graph, bn,
                                      be, 0.2, dt)
        grads = gc.gat_conv_bwd(g, h, Wl, x, ein, *par, *graph, saved, bn,
                                be, 0.2, dt)
        names = ("out", "x", "dh", "dWl", "dbl", "dWe", "de_self", "da_i",
                 "da_j", "dbias")
        out.update({f"K4 {n}": t for n, t in zip(names, (o, x) + grads)})
        if dt == torch.float32:
            out.update({f"K4 {n}": t for n, t in zip(
                ("alpha", "aself", "dlr", "dls"), saved)})
        x5 = (h @ Wl + bl).reshape(N, H, D).contiguous()
        e5 = (ein @ par[0]).reshape(-1, H, D).contiguous()
        o5, saved5 = attention.gat_attn_fwd(x5, e5, *par[1:], *graph, 0.2, bn,
                                            be, dt)
        res5 = attention.gat_attn_bwd(g3, x5, e5, *par[1:], *graph, saved5,
                                      0.2, bn, be, dt)
        out.update({f"K5 {n}": t for n, t in zip(
            ("out", "alpha", "aself", "dlr", "dls"), (o5,) + tuple(saved5))})
        out.update({f"K5 bwd {i}": t for i, t in enumerate(res5)})
    torch.cuda.synchronize()
    return out


def gat_batches(dev):
    """``{domain: (first batch, first GAT layer, edge inputs)}`` of the chem
    and bio GAT masking paths."""
    out = {}
    for d in ("chem", "bio"):
        cfg = pretrain.PretrainConfig(device_dataset="off",
                                      domain=d, num_layer=5, emb_dim=F,
                                      batch_size=256, mask_edge=False,
                                      seed=0, packing="auto", gnn_type="gat")
        b = first_batch(d, dev, cfg)
        conv = pretrain.build_objective(cfg).to(dev).gnn.gnns[0]
        ein = (bio.edge_inputs(b, torch.float32) if d == "bio"
               else chem.bond_one_hot(b, torch.float32))
        out[d] = b, conv, ein
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ref_csrc", required=True,
                   help="the other checkout's pretrain_gnns_tpu_torch/csrc")
    args = p.parse_args()
    dev = resolve_device("cuda")
    batches = {d: first_batch(d, dev) for d in ("chem", "bio")}
    edgepred = {d: first_batch(d, dev, pretrain.PretrainConfig(
        device_dataset="off",
        objective="edgepred", domain=d, num_layer=5, emb_dim=F,
        batch_size=256, seed=0, packing="auto")) for d in ("chem", "bio")}
    conv = pretrain.build_objective(config("chem")).to(dev).gnn.gnns[0]
    gat = gat_batches(dev)
    with tempfile.TemporaryDirectory() as tmp:
        ref = {name: build(args.ref_csrc, name, tmp)
               for name in ("gin_conv", "spmm", "spmm_ee", "edge_dot", "gat")}
        results = {}
        for tag in ("tree", "ref"):
            use(ref if tag == "ref" else {})
            results[tag] = {f"{d} {k}": v for d, b in batches.items()
                            for k, v in outputs(b, seed=7).items()}
            results[tag].update({f"chem {k}": v for k, v in k1_outputs(
                batches["chem"], conv, seed=8).items()})
            results[tag].update({f"{BF16_ROWS} chem {k}": v for k, v in
                                 k1_outputs(batches["chem"], conv, seed=8,
                                            rows=torch.bfloat16).items()})
            results[tag].update({f"bio {k}": v for k, v in k2_outputs(
                batches["bio"], seed=10).items()})
            results[tag].update({f"{K2_BF16} bio {k}": v for k, v in
                                 k2_outputs(batches["bio"], seed=10,
                                            cdt=torch.bfloat16).items()})
            for rows in (torch.bfloat16, torch.float32):
                results[tag].update({
                    f"{K1_BF16} rows {str(rows)[6:]} chem {k}": v
                    for k, v in k1_outputs(batches["chem"], conv, seed=8,
                                           rows=rows,
                                           cdt=torch.bfloat16).items()})
            results[tag].update({f"{d} {k}": v for d, b in edgepred.items()
                                 for k, v in k3_outputs(b, seed=9).items()})
            for d, (b, cv, ein) in gat.items():
                results[tag].update({f"{d} {k}": v for k, v in gat_outputs(
                    b, cv, ein, seed=11).items()})
                results[tag].update({f"{BF16} {d} {k}": v for k, v in
                                     gat_outputs(b, cv, ein, seed=11,
                                                 dt=torch.bfloat16).items()})
        use({})
    bad = [k for k in results["tree"]
           if not torch.equal(results["tree"][k], results["ref"][k])]
    prefixes = {BF16_ROWS: BF16_ROWS, "K1 at bfloat16 compute": K1_BF16,
                "K2 at bfloat16 compute": K2_BF16,
                "K4 and K5 at bfloat16 compute": BF16}
    groups = {"float32": [k for k in results["tree"]
                          if not k.startswith(tuple(prefixes.values()))]}
    groups.update({g: [k for k in results["tree"] if k.startswith(p)]
                   for g, p in prefixes.items()})
    print(f"card: {torch.cuda.get_device_name(0)}; K1-K7 outputs of this "
          f"tree vs {args.ref_csrc}, equal bit for bit: "
          + "; ".join(f"{g}: {len([k for k in ks if k not in bad])} of "
                      f"{len(ks)}" for g, ks in groups.items())
          + (f"; differ: {bad}" if bad else ""))
    for k in bad:
        d = (results["tree"][k].float() - results["ref"][k].float()).abs()
        print(f"  {k}: max |tree - ref| {float(d.max()):.3e}, "
              f"{int((d > 0).sum())} of {d.numel()} entries differ")
    return 1 if [k for k in bad if not resummed(k)] else 0


if __name__ == "__main__":
    sys.exit(main())
