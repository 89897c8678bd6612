#!/usr/bin/env python3
"""Timing A/B of the fused GIN conv (K1) and the fused GAT conv (K4),
forward and backward, between this tree's ``csrc/gin_conv.cu`` and
``csrc/gat.cu`` (with the GEMM of ``gemm.cuh`` they share) and those of
another checkout, in one process on one GPU.

Run from the repository root, with the other checkout's ``csrc`` directory
(for example a ``git archive`` of the parent commit unpacked under
``_archive/``):

    python3 scripts/torch_port_k1_k4_ab.py --ref_csrc _archive/parent/pretrain_gnns_tpu_torch/csrc

Both libraries have the same C interface. The script builds the other
sources with this tree's ``nvcc`` flags, then times each kernel (device ms
a call, ``chip_smoke.time_ms``) on the chem masking path's first batch
(GIN 5 x 300 and GAT 5 x 300 with 2 heads; random inputs from a seed) in
the order reference, this tree, this tree, reference, and prints each
time beside the card's name and power limit.
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
from pretrain_gnns_tpu_torch.data.synthetic import molecule_dataset  # noqa: E402
from pretrain_gnns_tpu_torch.device import resolve_device  # noqa: E402
from pretrain_gnns_tpu_torch.models import chem  # noqa: E402
from pretrain_gnns_tpu_torch.ops import _build, attention  # noqa: E402
from pretrain_gnns_tpu_torch.ops import gat_conv as gc  # noqa: E402
from pretrain_gnns_tpu_torch.ops import gin_conv  # noqa: E402
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


def use(gin_lib, gat_lib) -> None:
    """Route the K1 and K4 wrappers to these libraries (None: this
    tree's)."""
    _tree_gin_lib.cache_clear()
    attention.lib.cache_clear()
    for name, lib in (("gin_conv", gin_lib), ("gat", gat_lib)):
        _build._libs.pop(name, None)
        if lib is not None:
            _build._libs[name] = lib
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


def cases(dev):
    """``{kernel: callable}`` on the chem masking first batch."""
    graphs, _ = molecule_dataset(4096, seed=0, mean_atoms=23)
    out = {}
    gen = torch.Generator().manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)
    for gnn in ("gin", "gat"):
        cfg = pretrain.PretrainConfig(num_layer=5, emb_dim=300,
                                      batch_size=256, mask_edge=False,
                                      seed=0, packing="auto", gnn_type=gnn)
        b = next(iter(pretrain.build_loader(cfg, graphs, dev))).to(dev)
        conv = pretrain.build_objective(cfg).to(dev).gnn.gnns[0]
        nm = b.node_mask.to(torch.float32)
        x = rnd(b.max_nodes, 300) * nm[:, None]
        g = rnd(b.max_nodes, 300) * nm[:, None]
        bn, be = b.block_nodes, b.block_edges
        with torch.no_grad():
            if gnn == "gin":
                args = conv.conv_inputs(x, b)
                args = args[:11] + (nm,) + args[12:]
                (_, ein, _, _, W1, _, W2, _, snd, rcv, w, _, _, _) = args
                res = {}

                def k1_fwd(args=args, res=res):
                    res["fz"] = gin_conv.gin_conv_fwd(*args)

                def k1_bwd(res=res, ein=ein, W1=W1, W2=W2, snd=snd, rcv=rcv,
                           w=w, nm=nm, g=g):
                    _, aggr, z = res["fz"]
                    gin_conv.gin_conv_bwd(g, aggr, z, ein, W1, W2, snd, rcv,
                                          w, nm, bn, be)
                out["gin_conv_fwd"], out["gin_conv_bwd"] = k1_fwd, k1_bwd
            else:
                We, e_self = conv.edge_kernel()
                H, D = conv.heads, conv.emb_dim
                par = [We.contiguous(), e_self.reshape(H, D).contiguous(),
                       conv.att[0, :, :D].contiguous(),
                       conv.att[0, :, D:].contiguous()]
                Wl = conv.weight_linear.weight.t()
                bl = conv.weight_linear.bias
                graph = (b.senders, b.receivers, b.edge_mask.to(torch.float32))
                ein = chem.bond_one_hot(b, torch.float32)
                bias = rnd(D) * 0.1
                res = {}

                def k4_fwd(res=res):
                    res["fx"] = gc.gat_conv_fwd(x, Wl, bl, ein, *par, bias,
                                                *graph, bn, be)

                def k4_bwd(res=res):
                    _, xx, saved = res["fx"]
                    gc.gat_conv_bwd(g, x, Wl, xx, ein, *par, *graph, saved,
                                    bn, be)
                out["gat_conv_fwd"], out["gat_conv_bwd"] = k4_fwd, k4_bwd
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ref_csrc", required=True,
                   help="the other checkout's pretrain_gnns_tpu_torch/csrc")
    args = p.parse_args()
    dev = resolve_device("cuda")
    card = chip_smoke.card_line()
    fns = cases(dev)
    times = {k: {"tree": [], "ref": []} for k in fns}
    with tempfile.TemporaryDirectory() as tmp:
        ref = (build(args.ref_csrc, "gin_conv", tmp),
               build(args.ref_csrc, "gat", tmp))
        for tag in ("ref", "tree", "tree", "ref"):
            use(*(ref if tag == "ref" else (None, None)))
            with torch.no_grad():
                for k in ("gin_conv_fwd", "gin_conv_bwd", "gat_conv_fwd",
                          "gat_conv_bwd"):
                    if k.endswith("bwd"):  # its forward's outputs first
                        fns[k.replace("bwd", "fwd")]()
                    times[k][tag].append(chip_smoke.time_ms(fns[k], torch))
        use(None, None)
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
