#!/usr/bin/env python3
"""A third witness for K4's bfloat16 variant: the Pallas body's function at
``compute_dtype=bfloat16`` (``ops/gat_conv.py::_GatConvPlainBf16``, the
same rounding points) evaluated in float64, beside the kernel and the plain
version, on the card tests' GAT cases (``tests/test_torch_port_cuda.py::
_gat_case``).

Run from the repository root:

    python3 scripts/torch_port_k4_bf16_witness.py [--device cpu]
        [--cases bio:1,bio:2,bio:3,chem:1]

Each case is ``domain:heads`` at D = 300, one-hot edge inputs, blocks of
128 nodes and 384 slots. For each it prints:

- how many entries of the bfloat16 residual ``x`` differ between the
  kernel, the plain version, the float64 witness and ``chain``, the
  product summed as one k-ordered float32 FMA chain (emulated here);
- for every output, the mean relative error (the card tests' reading,
  mean |a - b| over mean |b|) of the kernel against the plain version
  (the card tests' gate), of the kernel against the witness's backward
  fed the kernel's own residual, of the plain version against the
  witness's backward fed the plain version's residual, and of the kernel
  against the plain version's backward fed the kernel's residual
  (``ops/gat_conv.py::gat_conv_bwd_plain``, as the card tests gate it).

With ``--device cpu`` there is no kernel: the plain version and the
witness only. Nothing is asserted; it exits 0 once every case has run.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch  # noqa: E402

from pretrain_gnns_tpu_torch.ops import attention, gat_conv  # noqa: E402
from pretrain_gnns_tpu_torch.ops import segment as seg  # noqa: E402
from test_torch_port_cuda import (  # noqa: E402
    GAT_DIFF, GAT_GRADS, _bf16_readings, _gat_case,
)

BF16 = torch.bfloat16
NAMES = ("out", "x") + GAT_GRADS


def body(t, ein, graph, heads, dt, x_res=None, slope=0.2):
    """The Pallas body at compute dtype bfloat16 with every sum in ``dt``:
    ``(out, x, dh, dWl, dbl, dWe, de_self, da_i, da_j, dbias)``, the
    backward from ``x_res`` (the bfloat16 residual) where given, else from
    its own forward's."""
    r = lambda a: a.to(BF16).to(dt)
    c = lambda a: a.to(dt)
    h, Wl, bl, We, es, ai, aj, bias, g = (
        c(t[k]) for k in ("h", "Wl", "bl", "We", "e_self", "a_i", "a_j",
                          "bias", "g"))
    snd, rcv, w = graph
    w = c(w)
    sl, rl = snd.long(), rcv.long()
    N, D = g.shape
    H = heads
    x = r(h) @ r(Wl) + bl
    eb = r(c(ein))
    e = (eb @ r(We)).reshape(-1, H, D)
    x3 = x.reshape(N, H, D)
    x_self, _, _, p, p_self, den = gat_conv._k4_pieces(
        x3, e, es, ai, aj, snd, rcv, w, slope)
    msg = r(x3)[sl] + e
    numer = seg.scatter_add_rows(torch.zeros_like(x3), rl,
                                 r(p[..., None] * msg))
    o = (numer + p_self[..., None] * x_self) / den[..., None]
    out = o.sum(1) / H + bias
    xr = r(x) if x_res is None else c(x_res)
    gH = (g / H)[:, None, :]
    x = xr.reshape(N, H, D)
    x_self, raw, sraw, p, p_self, den = gat_conv._k4_pieces(
        x, e, es, ai, aj, snd, rcv, w, slope)
    alpha = p / torch.clamp(den[rl], min=1e-30)
    aself = p_self / den
    g_r = r(gH)[rl]
    d_alpha = (g_r * (x[sl] + e)).sum(-1)
    d_aself = (gH * x_self).sum(-1)
    zeros = torch.zeros_like(aself)
    cc = seg.scatter_add_rows(zeros, rl, alpha * d_alpha) + aself * d_aself
    dz = alpha * (d_alpha - cc[rl]) * attention.leaky_slope(raw, slope)
    dzs = aself * (d_aself - cc) * attention.leaky_slope(sraw, slope)
    dmsg = alpha[..., None] * g_r
    dz_r = seg.scatter_add_rows(zeros, rl, dz)
    dz_s = seg.scatter_add_rows(zeros, sl, dz)
    dx = (seg.scatter_add_rows(torch.zeros_like(x), sl, r(dmsg))
          + aself[..., None] * gH + (dz_r + dzs)[..., None] * ai
          + (dz_s + dzs)[..., None] * aj)
    de = dmsg + dz[..., None] * aj
    dx2, dxb = dx.reshape(N, H * D), r(dx.reshape(N, H * D))
    dWl = r(h).t() @ dxb
    dWe = eb.t() @ r(de.reshape(-1, H * D))
    dh = dxb @ r(Wl).t()
    des = (aself[..., None] * gH + dzs[..., None] * aj).sum(0)
    dai = (x * (dz_r + dzs)[..., None]).sum(0)
    daj = ((x * (dz_s + dzs)[..., None] + dzs[..., None] * es).sum(0)
           + (e * dz[..., None]).sum(0))
    return (out, xr.reshape(N, H * D), dh, dWl, dx2.sum(0), dWe, des, dai,
            daj, g.sum(0))


def chain(t):
    """bf(x): ``bf(h) @ bf(Wl)`` summed as one float32 FMA chain in k's
    order from 0, then ``+ bl``, rounded to bfloat16 (each product of two
    bfloat16 values is exact in float32, each step rounds once)."""
    a = t["h"].cpu().to(BF16).double()
    b = t["Wl"].cpu().to(BF16).double()
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(a.shape[1]):
        acc = (acc.double() + a[:, k:k + 1] * b[k:k + 1, :]).float()
    return (acc + t["bl"].cpu().float()).to(BF16)


def kernel(t, ein, graph, bn, be):
    out, x, saved = gat_conv.gat_conv_fwd(
        t["h"], t["Wl"], t["bl"], ein, t["We"], t["e_self"], t["a_i"],
        t["a_j"], t["bias"], *graph, bn, be, compute_dtype=BF16)
    return (out, x) + gat_conv.gat_conv_bwd(
        t["g"], t["h"], t["Wl"], x, ein, t["We"], t["e_self"], t["a_i"],
        t["a_j"], *graph, saved, bn, be, compute_dtype=BF16)


def run_case(dev, domain, heads):
    t, ein, b, bn, be = _gat_case(dev, domain, 300, 128, 384,
                                  variant="onehot", heads=heads)
    graph = (b.senders, b.receivers, t["w"])
    leaves = [t[k].detach().clone().requires_grad_(True) for k in GAT_DIFF]
    lh, lWl, lbl, lWe, les, lai, laj, lbias = leaves
    out_p, x_p = gat_conv.fused_gat_conv_plain(
        lh, lWl, lbl, ein, lWe, les, lai, laj, lbias, *graph, heads,
        return_residuals=True, compute_dtype=BF16)
    plain = (out_p.detach(), x_p) + torch.autograd.grad(out_p, leaves,
                                                        t["g"])
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    tc, gc = cpu(t), tuple(v.cpu() for v in graph)
    f64 = torch.float64
    wit = body(tc, ein.cpu(), gc, heads, f64)
    wit_p = body(tc, ein.cpu(), gc, heads, f64, x_res=x_p.cpu())
    xs = {"plain": x_p.cpu(), "witness": wit[1].to(BF16),
          "chain": chain(t)}
    kern = None
    if dev != "cpu":
        with torch.no_grad():
            kern = kernel(t, ein, graph, bn, be)
        xs = {"kernel": kern[1].cpu(), **xs}
        wit_k = body(tc, ein.cpu(), gc, heads, f64, x_res=kern[1].cpu())
        with torch.no_grad():
            same_x = plain[:2] + gat_conv.gat_conv_bwd_plain(
                t["g"], t["h"], t["Wl"], kern[1], ein, t["We"], t["e_self"],
                t["a_i"], t["a_j"], *graph, heads)
    keys = list(xs)
    diffs = ", ".join(
        f"{a}~{b_} {int((xs[a].float() != xs[b_].float()).sum())}"
        for i, a in enumerate(keys) for b_ in keys[i + 1:])
    print(f"{domain} H={heads}: residual entries that differ (of "
          f"{x_p.numel()}): {diffs}", flush=True)
    mean = lambda a, b_: _bf16_readings(a.double().cpu(), b_.double().cpu())[1]
    for i, n in enumerate(NAMES):
        row = [f"plain~witness(plain x) {mean(plain[i], wit_p[i]):.2e}",
               f"plain~witness(own x) {mean(plain[i], wit[i]):.2e}"]
        if kern is not None:
            row = [f"kernel~plain {mean(kern[i], plain[i]):.2e}",
                   f"kernel~witness(kernel x) {mean(kern[i], wit_k[i]):.2e}",
                   f"kernel~plain(kernel x) {mean(kern[i], same_x[i]):.2e}",
                   ] + row
        print(f"  {n:8s} " + "  ".join(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cases", default="bio:1,bio:2,bio:3,chem:1")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    print(f"device {dev}, torch {torch.__version__}", flush=True)
    for case in args.cases.split(","):
        domain, heads = case.split(":")
        run_case(dev.type if dev.type == "cpu" else dev, domain, int(heads))
    return 0


if __name__ == "__main__":
    sys.exit(main())
