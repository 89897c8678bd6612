"""The plain versions of K4, K5, K6 and K7 at ``compute_dtype=bfloat16``
against the JAX package's Pallas kernels at ``jnp.bfloat16`` in interpret
mode, on the same inputs made with numpy from a seed: the fused GAT conv
(``pallas_gat_conv.fused_gat_conv``: out and its eight gradients), the
blocked GAT attention (``pallas_attention.blocked_gat_forward`` /
``blocked_gat_backward``: out and its five gradients), the blocked SpMM on
a precomputed edge embedding (``pallas_spmm.blocked_spmm``: out, dx and
dee, with and without the embedding) and its receiver-sorted variant
(``pallas_spmm_sorted.sorted_blocked_spmm``, forward only). Where rows can
arrive in either dtype (K5's ``e``, K6's and K7's ``x`` and ``ee``) both
are run. Parameters of the chem GAT trunk are carried across with
``compat/from_jax`` in tests/test_torch_port_mixed_precision.py; the
kernels' parameters here are plain arrays, the same on both sides.

Tolerance, each element against max(|reference|, 1): 1e-2, as the K1-K3
plain versions' (tests/test_torch_port_mixed_precision.py). Both sides
round at the same points and multiply exactly; only the order of the
float32 sums differs, which can move a later rounding by one bfloat16 step
(2^-8 of the value). Measured here: at most 1.5e-5 (K4), 5.8e-6 (K5;
3.9e-3 with bfloat16 e, whose gradient comes back rounded to e's dtype
against the Pallas kernel's float32 de), 0 (K6), 4.4e-6 (K7). The control,
K4's float32 plain version against the same bfloat16 Pallas reference,
reads 2.7e-2 (bio) and 0.32 (chem): a variant that skipped a rounding
would show. Sizes: 3 blocks of 64 nodes
(chem, K = 9; bio, K = 10), 2 heads of 16 features; K6 and K7 on 4 blocks
of 32 nodes, 24 features. The CUDA variants are held against these plain
versions on the card (tests/test_torch_port_cuda.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.ops import (
    pallas_attention, pallas_gat_conv, pallas_spmm, pallas_spmm_sorted,
)
from pretrain_gnns_tpu_torch.core import graphs as tg
from pretrain_gnns_tpu_torch.data import packing as tpk
from pretrain_gnns_tpu_torch.data.synthetic import (
    bio_dataset, molecule_dataset,
)
from pretrain_gnns_tpu_torch.models import bio as tbio
from pretrain_gnns_tpu_torch.models import chem as tchem
from pretrain_gnns_tpu_torch.ops import (
    attention, blocked_spmm, gat_conv, sorted_spmm,
)

KERNEL_TOL = 1e-2
H, D = 2, 16
BF = torch.bfloat16
ROWS = {"f32": (torch.float32, jnp.float32),
        "bf16": (torch.bfloat16, jnp.bfloat16)}
K4_LEAVES = ("h", "Wl", "bl", "We", "e_self", "a_i", "a_j", "bias")


def _err(a, ref) -> float:
    """max |a - ref| / max(|ref|, 1), element-wise, in float32."""
    a = np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
    return float((np.abs(a - ref) / np.maximum(np.abs(ref), 1.0)).max())


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _gat_batch(domain):
    """A blocked batch of 3 blocks of 64 nodes, the last all padding."""
    if domain == "chem":
        graphs, _ = molecule_dataset(6, num_tasks=1, seed=0, mean_atoms=16)
        n_blocks, bn, be = tpk.block_layout(graphs, 6, block_nodes=64,
                                            block_edges=192)
        return next(iter(tpk.PackedLoader(
            graphs, 6, shuffle=False, blocks=(n_blocks + 1, bn, be)))).to(
                "cpu")
    graphs = [dataclasses.replace(g, extras={})
              for g in bio_dataset(4, num_downstream=2, seed=1,
                                   mean_nodes=20)]
    return tg.pack_graphs_blocked(graphs, 3, 64, 256, 4).to("cpu")


@pytest.fixture(scope="module", params=["chem", "bio"])
def gat_case(request):
    """K4's inputs at a GAT batch and its cotangent, from a numpy seed."""
    domain = request.param
    b = _gat_batch(domain)
    ein = (tbio.edge_inputs(b, torch.float32) if domain == "bio"
           else tchem.bond_one_hot(b, torch.float32)).numpy()
    rng = np.random.default_rng(0)
    N, K = b.max_nodes, ein.shape[1]
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    t = dict(h=f(N, D) * np.asarray(b.node_mask, np.float32)[:, None],
             Wl=f(D, H * D, scale=D ** -0.5), bl=f(H * D, scale=0.1),
             ein=ein, We=f(K, H * D, scale=0.5), e_self=f(H, D, scale=0.5),
             a_i=f(H, D, scale=0.3), a_j=f(H, D, scale=0.3),
             bias=f(D, scale=0.1), senders=b.senders.numpy(),
             receivers=b.receivers.numpy(),
             w=b.edge_mask.numpy().astype(np.float32))
    assert not b.node_mask[-64:].any()
    return t, f(N, D), f(N, H, D), b


def test_k4_plain_bf16_matches_pallas(gat_case):
    """K4's plain version at compute_dtype=bfloat16 (the port's wrapper on
    CPU tensors) against pallas_gat_conv.fused_gat_conv at jnp.bfloat16:
    out and the eight gradients; the saved residual is bfloat16 and equal
    to x rounded."""
    t, g, _, b = gat_case
    fixed = tuple(jnp.asarray(t[k]) for k in ("senders", "receivers", "w"))

    def jf(h, Wl, bl, We, e_self, a_i, a_j, bias):
        return pallas_gat_conv.fused_gat_conv(
            h, Wl, bl, jnp.asarray(t["ein"]), We, e_self, a_i, a_j, bias,
            *fixed, (H, D), (b.block_nodes, b.block_edges), jnp.bfloat16,
            True)

    out_j, vjp = jax.vjp(jf, *(jnp.asarray(t[k]) for k in K4_LEAVES))
    grads_j = vjp(jnp.asarray(g))
    lv = [torch.from_numpy(t[k]).requires_grad_(True) for k in K4_LEAVES]
    graph = [torch.from_numpy(t[k]) for k in ("senders", "receivers", "w")]
    before = dict(gat_conv.launches)
    out_t = gat_conv.fused_gat_conv(
        lv[0], lv[1], lv[2], torch.from_numpy(t["ein"]), *lv[3:], *graph, H,
        b.block_nodes, b.block_edges, compute_dtype=BF)
    assert gat_conv.launches == before  # no kernel on a CPU tensor
    grads_t = torch.autograd.grad(out_t, lv, torch.from_numpy(g))
    assert out_t.dtype == torch.float32
    assert _err(_np(out_t), out_j) <= KERNEL_TOL
    for name, gt, gj in zip(K4_LEAVES, grads_t, grads_j):
        assert np.isfinite(_np(gt)).all(), name
        assert _err(_np(gt), gj) <= KERNEL_TOL, name
    _, x_res = gat_conv.fused_gat_conv_plain(
        *lv[:3], torch.from_numpy(t["ein"]), *lv[3:], *graph, H,
        return_residuals=True, compute_dtype=BF)
    x32 = (torch.from_numpy(t["h"]).to(BF).float()
           @ torch.from_numpy(t["Wl"]).to(BF).float()
           + torch.from_numpy(t["bl"]))
    assert x_res.dtype == BF and torch.equal(x_res, x32.to(BF))


def test_k4_plain_bwd_bf16_matches_pallas_from_the_residual(gat_case):
    """``gat_conv_bwd_plain`` (the plain backward the card tests hold K4's
    bfloat16 backward against, on the kernel's residual) from the plain
    forward's residual: the eight gradients of the Pallas backward at
    jnp.bfloat16 within the limit, and the plain version's own autograd
    gradients bit for bit."""
    t, g, _, b = gat_case
    fixed = tuple(jnp.asarray(t[k]) for k in ("senders", "receivers", "w"))

    def jf(*a):
        return pallas_gat_conv.fused_gat_conv(
            *a[:3], jnp.asarray(t["ein"]), *a[3:], *fixed, (H, D),
            (b.block_nodes, b.block_edges), jnp.bfloat16, True)

    _, vjp = jax.vjp(jf, *(jnp.asarray(t[k]) for k in K4_LEAVES))
    grads_j = vjp(jnp.asarray(g))
    lv = [torch.from_numpy(t[k]).requires_grad_(True) for k in K4_LEAVES]
    ein = torch.from_numpy(t["ein"])
    graph = [torch.from_numpy(t[k]) for k in ("senders", "receivers", "w")]
    out_t, x_res = gat_conv.fused_gat_conv_plain(
        *lv[:3], ein, *lv[3:], *graph, H, return_residuals=True,
        compute_dtype=BF)
    auto = torch.autograd.grad(out_t, lv, torch.from_numpy(g))
    grads = gat_conv.gat_conv_bwd_plain(
        torch.from_numpy(g), *(v.detach() for v in lv[:2]), x_res, ein,
        *(v.detach() for v in lv[3:7]), *graph, H)
    for name, gt, ga, gj in zip(K4_LEAVES, grads, auto, grads_j):
        assert torch.equal(gt, ga), name
        assert _err(_np(gt), gj) <= KERNEL_TOL, name


def test_k4_control_reads_the_rounding(gat_case):
    """The float32 plain version against the same bfloat16 Pallas
    reference reads over a tenth of the limit on some output: the test
    above would see a variant that skipped a rounding."""
    t, g, _, b = gat_case
    fixed = tuple(jnp.asarray(t[k]) for k in ("senders", "receivers", "w"))

    def jf(*a):
        return pallas_gat_conv.fused_gat_conv(
            *a[:3], jnp.asarray(t["ein"]), *a[3:], *fixed, (H, D),
            (b.block_nodes, b.block_edges), jnp.bfloat16, True)

    out_j, vjp = jax.vjp(jf, *(jnp.asarray(t[k]) for k in K4_LEAVES))
    grads_j = vjp(jnp.asarray(g))
    lv = [torch.from_numpy(t[k]).requires_grad_(True) for k in K4_LEAVES]
    out_t = gat_conv.fused_gat_conv_plain(
        *lv[:3], torch.from_numpy(t["ein"]), *lv[3:],
        *(torch.from_numpy(t[k]) for k in ("senders", "receivers", "w")), H)
    grads_t = torch.autograd.grad(out_t, lv, torch.from_numpy(g))
    errs = [_err(_np(out_t), out_j)] + [_err(_np(a), r)
                                        for a, r in zip(grads_t, grads_j)]
    assert max(errs) > KERNEL_TOL / 10, errs


@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_k5_plain_bf16_matches_pallas(gat_case, rows):
    """K5's plain version at compute_dtype=bfloat16 against
    blocked_gat_forward and blocked_gat_backward at jnp.bfloat16, on x and
    e as the unfused conv forms them (x float32, as the trunks widen it; e
    float32 or bfloat16, the bio encoder's dtype under bfloat16_act): out
    and the five gradients (de in e's dtype), a padded slot's de row 0."""
    t, _, g3, b = gat_case
    tdt, jdt = ROWS[rows]
    x = (t["h"] @ t["Wl"] + t["bl"]).reshape(-1, H, D)
    e = np.asarray(torch.from_numpy((t["ein"] @ t["We"]).reshape(-1, H, D))
                   .to(tdt).float())
    par = (t["e_self"], t["a_i"], t["a_j"])
    snd, rcv, w = (t[k] for k in ("senders", "receivers", "w"))
    jargs = (jnp.asarray(x), jnp.asarray(e).astype(jdt),
             jnp.asarray(par[0]), jnp.asarray(par[1])[None],
             jnp.asarray(par[2])[None])
    jgraph = (jnp.asarray(snd), jnp.asarray(rcv), jnp.asarray(w))
    out_j = pallas_attention.blocked_gat_forward(
        *jargs, *jgraph, 0.2, b.block_nodes, b.block_edges, jnp.bfloat16,
        True)
    grads_j = pallas_attention.blocked_gat_backward(
        *jargs, *jgraph, jnp.asarray(g3), 0.2, b.block_nodes, b.block_edges,
        jnp.bfloat16, True)
    leaves = [torch.from_numpy(x).requires_grad_(True),
              torch.from_numpy(e).to(tdt).requires_grad_(True)] + [
        torch.from_numpy(a).requires_grad_(True) for a in par]
    before = dict(attention.launches)
    out_t = attention.blocked_gat_attention(
        *leaves, torch.from_numpy(snd), torch.from_numpy(rcv),
        torch.from_numpy(w), 0.2, b.block_nodes, b.block_edges, BF)
    assert attention.launches == before
    grads_t = torch.autograd.grad(out_t, leaves, torch.from_numpy(g3))
    assert _err(_np(out_t), out_j) <= KERNEL_TOL
    assert grads_t[1].dtype == tdt
    for name, gt, gj in zip(("dx", "de", "de_self", "da_i", "da_j"), grads_t,
                            grads_j):
        gj = np.asarray(gj, np.float32).reshape(gt.shape)
        assert _err(_np(gt), gj) <= KERNEL_TOL, name
    assert not grads_t[1][torch.from_numpy(w) == 0].any()


@pytest.fixture(scope="module")
def k6_case():
    """4 blocks of 32 nodes / 96 slots (the last all padding) and K6's
    inputs: fractional and negative edge weights, 0 on padded slots."""
    graphs, _ = molecule_dataset(6, seed=7, mean_atoms=10)
    p = tg.pack_graphs_blocked(graphs, 4, 32, 96, max_graphs=6)
    assert not p.edge_mask.reshape(4, 96)[-1].any()
    rng = np.random.default_rng(1)
    N, E, F = p.max_nodes, p.max_edges, 24
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    w = ((rng.random(E) * 2 - 0.5) * p.edge_mask).astype(np.float32)
    return dict(x=f(N, F), ee=f(E, F), g=f(N, F), w=w,
                senders=np.asarray(p.senders),
                receivers=np.asarray(p.receivers), bn=32, be=96)


@pytest.mark.parametrize("rows", ["f32", "bf16"])
@pytest.mark.parametrize("has_ee", [True, False])
def test_k6_plain_bf16_matches_pallas(k6_case, rows, has_ee):
    """K6's plain version at compute_dtype=bfloat16 against
    pallas_spmm.blocked_spmm at jnp.bfloat16, [x+ee] and [x], rows float32
    and bfloat16: out and dx in the rows' dtype, dee."""
    a = k6_case
    tdt, jdt = ROWS[rows]
    snd, rcv, w = (a[k] for k in ("senders", "receivers", "w"))

    def jf(x, ee):
        return pallas_spmm.blocked_spmm(
            x, ee if has_ee else None, jnp.asarray(snd), jnp.asarray(rcv),
            jnp.asarray(w), a["bn"], a["be"], jnp.bfloat16, True)

    jx, jee = jnp.asarray(a["x"]).astype(jdt), jnp.asarray(a["ee"]).astype(jdt)
    out_j, vjp = jax.vjp(jf, jx, jee)
    dx_j, dee_j = vjp(jnp.asarray(a["g"]).astype(out_j.dtype))
    x = torch.from_numpy(a["x"]).to(tdt).requires_grad_(True)
    ee = torch.from_numpy(a["ee"]).to(tdt).requires_grad_(True)
    before = dict(blocked_spmm.launches)
    out_t = blocked_spmm.blocked_spmm(
        x, ee if has_ee else None, torch.from_numpy(snd),
        torch.from_numpy(rcv), torch.from_numpy(w), a["bn"], a["be"], BF)
    assert blocked_spmm.launches == before
    leaves = [x, ee] if has_ee else [x]
    grads = torch.autograd.grad(out_t, leaves,
                                torch.from_numpy(a["g"]).to(out_t.dtype))
    assert out_t.dtype == tdt and grads[0].dtype == tdt
    assert _err(_np(out_t), out_j) <= KERNEL_TOL
    assert _err(_np(grads[0]), dx_j) <= KERNEL_TOL
    if has_ee:
        assert _err(_np(grads[1]), dee_j) <= KERNEL_TOL


@pytest.mark.parametrize("rows", ["f32", "bf16"])
@pytest.mark.parametrize("has_ee", [True, False])
def test_k7_plain_bf16_matches_pallas(k6_case, rows, has_ee):
    """K7's plain version at compute_dtype=bfloat16 against
    pallas_spmm_sorted.sorted_blocked_spmm at jnp.bfloat16 on the sorted
    slots, rows float32 and bfloat16; out in the rows' dtype."""
    a = k6_case
    tdt, jdt = ROWS[rows]
    n_blocks = a["x"].shape[0] // a["bn"]
    s2, r2, w2, ee2 = sorted_spmm.sort_block_edges(
        *(torch.from_numpy(a[k]) for k in ("senders", "receivers", "w", "ee")),
        n_blocks, a["be"])
    x = torch.from_numpy(a["x"]).to(tdt)
    ee2 = ee2.to(tdt) if has_ee else None
    ref = pallas_spmm_sorted.sorted_blocked_spmm(
        jnp.asarray(a["x"]).astype(jdt),
        None if ee2 is None else jnp.asarray(ee2.float().numpy()).astype(jdt),
        jnp.asarray(s2.numpy()), jnp.asarray(r2.numpy()),
        jnp.asarray(w2.numpy()), a["bn"], a["be"], jnp.bfloat16, True)
    out = sorted_spmm.sorted_blocked_spmm(x, ee2, s2, r2, w2, a["bn"],
                                          a["be"], compute_dtype=BF)
    assert out.dtype == tdt and str(ref.dtype) == str(jdt.dtype)
    assert _err(_np(out), ref) <= KERNEL_TOL
