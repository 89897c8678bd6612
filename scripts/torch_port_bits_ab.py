#!/usr/bin/env python3
"""Bit-for-bit A/B of the blocked SpMM on a precomputed edge embedding (K6)
and its receiver-sorted variant (K7) between this tree's
``csrc/spmm_ee.cu`` and the one of another checkout, on one GPU.

Run from the repository root, with the other checkout's ``csrc`` directory
(for example a ``git archive`` of the parent commit unpacked under
``_archive/``):

    python3 scripts/torch_port_bits_ab.py --ref_csrc _archive/parent/pretrain_gnns_tpu_torch/csrc

It builds the other source with this tree's ``nvcc`` flags into a
temporary directory, then runs both libraries through this tree's wrappers
on the chem and bio masking paths' first batches (256 graphs, F = 300, a
random edge embedding, fractional and partly negative edge weights): K6
forward with and without the edge embedding, K6 backward (``dx`` and
``dmsg`` together and each alone) and K7 forward on the sorted slots. It
prints whether every output is equal bit for bit and exits non-zero if one
is not.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from pretrain_gnns_tpu_torch.data.synthetic import (  # noqa: E402
    bio_dataset, molecule_dataset,
)
from pretrain_gnns_tpu_torch.device import resolve_device  # noqa: E402
from pretrain_gnns_tpu_torch.ops import _build  # noqa: E402
from pretrain_gnns_tpu_torch.ops import blocked_spmm as bs  # noqa: E402
from pretrain_gnns_tpu_torch.ops import sorted_spmm as ss  # noqa: E402
from pretrain_gnns_tpu_torch.train import pretrain  # noqa: E402

F = 300


def first_batch(domain: str, dev):
    if domain == "bio":
        graphs = bio_dataset(4096, seed=0)
    else:
        graphs, _ = molecule_dataset(4096, seed=0, mean_atoms=23)
    cfg = pretrain.PretrainConfig(domain=domain, num_layer=5, emb_dim=F,
                                  batch_size=256, seed=0, packing="auto")
    return next(iter(pretrain.build_loader(cfg, graphs, dev))).to(dev)


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


def build_ref(ref_csrc: str, out_dir: str) -> ctypes.CDLL:
    lib = os.path.join(out_dir, "libspmm_ee_ref.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
           os.path.join(ref_csrc, "spmm_ee.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for the reference:\n{res.stdout}"
                           f"{res.stderr}")
    return ctypes.CDLL(lib)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ref_csrc", required=True,
                   help="the other checkout's pretrain_gnns_tpu_torch/csrc")
    args = p.parse_args()
    dev = resolve_device("cuda")
    batches = {d: first_batch(d, dev) for d in ("chem", "bio")}
    with tempfile.TemporaryDirectory() as tmp:
        ref = build_ref(args.ref_csrc, tmp)
        results = {}
        for tag in ("tree", "ref"):
            bs._ee_lib.cache_clear()
            _build._libs.pop("spmm_ee", None)
            if tag == "ref":
                _build._libs["spmm_ee"] = ref  # load() hands this one out
            results[tag] = {d: outputs(b, seed=7) for d, b in batches.items()}
        bs._ee_lib.cache_clear()
        _build._libs.pop("spmm_ee", None)
    bad = [f"{d} {k}" for d in batches for k in results["tree"][d]
           if not torch.equal(results["tree"][d][k], results["ref"][d][k])]
    n = sum(len(v) for v in results["tree"].values())
    print(f"card: {torch.cuda.get_device_name(0)}; K6/K7 outputs of this tree "
          f"vs {args.ref_csrc}: {n - len(bad)} of {n} equal bit for bit"
          + (f"; differ: {bad}" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
