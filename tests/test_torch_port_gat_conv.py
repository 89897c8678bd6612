"""The plain version of the port's fused GAT conv (ops/gat_conv.py, K4)
against the JAX package: ``fused_gat_conv`` (the Pallas TPU kernels in
interpret mode, float32) and the unfused XLA composition (projection,
edge embedding, ``gat_attention_xla``, head mean, bias), forward and each
of the eight gradients by name.

Inputs come from a numpy seed and go to both sides. Sizes: emb 32, 2 heads;
chem blocks of 64 nodes / 192 edge slots with the bond one-hots (K = 9), bio
blocks of 64 / 512 with ``[edge_feat | 1]`` (K = 10). On the CPU the port's
wrapper takes the plain version; the CUDA kernels are held against it on
the card (tests/test_torch_port_cuda.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.ops import attention as jattention
from pretrain_gnns_tpu.ops import pallas_gat_conv
from pretrain_gnns_tpu_torch.core import graphs as tg
from pretrain_gnns_tpu_torch.data import packing as tpk
from pretrain_gnns_tpu_torch.data.synthetic import (
    bio_dataset, molecule_dataset,
)
from pretrain_gnns_tpu_torch.models import bio as tbio
from pretrain_gnns_tpu_torch.models import chem as tchem
from pretrain_gnns_tpu_torch.ops import gat_conv

H, D = 2, 32
LEAVES = ("h", "Wl", "bl", "We", "e_self", "a_i", "a_j", "bias")
GRADS = ("dh", "dWl", "dbl", "dWe", "de_self", "da_i", "da_j", "dbias")


def _batch(domain, extra_blocks=0):
    """A blocked batch on the CPU, as tests/test_pallas_gat_conv.py builds
    it; ``extra_blocks`` appends all-padding blocks."""
    if domain == "chem":
        graphs, _ = molecule_dataset(32, num_tasks=1, seed=0, mean_atoms=20)
        n_blocks, bn, be = tpk.block_layout(graphs, 32, block_nodes=64,
                                            block_edges=192)
        return next(iter(tpk.PackedLoader(
            graphs, 32, shuffle=False,
            blocks=(n_blocks + extra_blocks, bn, be)))).to("cpu")
    graphs = [dataclasses.replace(g, extras={})
              for g in bio_dataset(8, num_downstream=2, seed=1,
                                   mean_nodes=20)]
    return tg.pack_graphs_blocked(graphs, 4 + extra_blocks, 64, 512,
                                  8).to("cpu")


def _inputs(domain, batch, seed=0, w=None):
    """numpy inputs of the fused conv at this batch: the arrays, then the
    cotangent."""
    rng = np.random.default_rng(seed)
    ein = (tbio.edge_inputs(batch, torch.float32) if domain == "bio"
           else tchem.bond_one_hot(batch, torch.float32)).numpy()
    N, K = batch.max_nodes, ein.shape[1]
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    t = dict(
        h=f(N, D) * np.asarray(batch.node_mask, np.float32)[:, None],
        Wl=f(D, H * D, scale=D ** -0.5), bl=f(H * D, scale=0.1), ein=ein,
        We=f(K, H * D, scale=0.5), e_self=f(H, D, scale=0.5),
        a_i=f(H, D, scale=0.3), a_j=f(H, D, scale=0.3),
        bias=f(D, scale=0.1),
        senders=batch.senders.numpy(), receivers=batch.receivers.numpy(),
        w=(batch.edge_mask.numpy().astype(np.float32) if w is None else w),
    )
    return t, f(N, D)


def _port(t, g, batch):
    """out and the eight gradients of the port's fused_gat_conv on the CPU
    (its plain version)."""
    lv = {k: torch.from_numpy(t[k]).requires_grad_(True) for k in LEAVES}
    before = dict(gat_conv.launches)
    out = gat_conv.fused_gat_conv(
        lv["h"], lv["Wl"], lv["bl"], torch.from_numpy(t["ein"]), lv["We"],
        lv["e_self"], lv["a_i"], lv["a_j"], lv["bias"],
        torch.from_numpy(t["senders"]), torch.from_numpy(t["receivers"]),
        torch.from_numpy(t["w"]), H, batch.block_nodes, batch.block_edges)
    assert gat_conv.launches == before  # no kernel on a CPU tensor
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [lv[k].grad.numpy() for k in LEAVES]


def _jax_fused(t, g, batch):
    """The JAX fused_gat_conv (Pallas kernels, interpret mode, float32)."""
    fixed = tuple(jnp.asarray(t[k]) for k in ("senders", "receivers", "w"))

    def f(h, Wl, bl, We, e_self, a_i, a_j, bias):
        return pallas_gat_conv.fused_gat_conv(
            h, Wl, bl, jnp.asarray(t["ein"]), We, e_self, a_i, a_j, bias,
            *fixed, (H, D), (batch.block_nodes, batch.block_edges),
            jnp.float32, True)

    out, vjp = jax.vjp(f, *(jnp.asarray(t[k]) for k in LEAVES))
    return np.asarray(out), [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _jax_unfused(t, g, batch):
    """The unfused composition on the XLA path."""
    fixed = tuple(jnp.asarray(t[k]) for k in ("senders", "receivers"))
    mask = jnp.asarray(t["w"] > 0)

    def f(h, Wl, bl, We, e_self, a_i, a_j, bias):
        x = (h @ Wl + bl).reshape(-1, H, D)
        e = (jnp.asarray(t["ein"]) @ We).reshape(-1, H, D)
        out = jattention.gat_attention_xla(
            x, e, e_self, a_i[None], a_j[None], *fixed, mask, h.shape[0],
            0.2)
        return jnp.mean(out, axis=1) + bias

    out, vjp = jax.vjp(f, *(jnp.asarray(t[k]) for k in LEAVES))
    return np.asarray(out), [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _assert_matches(got, want, skip=()):
    (out, grads), (out_r, grads_r) = got, want
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, out_r, rtol=1e-5,
                               atol=1e-5 * np.abs(out_r).max())
    for name, a, b in zip(GRADS, grads, grads_r):
        assert np.isfinite(a).all(), name
        if name in skip:
            continue
        np.testing.assert_allclose(
            a, b, rtol=0, atol=1e-4 * max(float(np.abs(b).max()), 1e-6),
            err_msg=name)


REFS = {"pallas": _jax_fused, "xla": _jax_unfused}


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_plain_version_matches_jax(domain, ref):
    batch = _batch(domain)
    t, g = _inputs(domain, batch)
    assert t["ein"].shape[1] == (10 if domain == "bio" else 9)
    _assert_matches(_port(t, g, batch), REFS[ref](t, g, batch))


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_all_padding_block_gives_no_nan(domain, ref):
    """A batch whose last block holds no node and no edge: every row and
    every gradient finite, and as the JAX side; a padded row's only logit
    is its self loop, so it gets mean_h(bl + e_self) + bias."""
    batch = _batch(domain, extra_blocks=1)
    bn = batch.block_nodes
    assert not batch.node_mask[-bn:].any()
    assert not batch.edge_mask[-batch.block_edges:].any()
    t, g = _inputs(domain, batch, seed=1)
    got = _port(t, g, batch)
    _assert_matches(got, REFS[ref](t, g, batch))
    pad = (t["bl"].reshape(H, D) + t["e_self"]).mean(0) + t["bias"]
    np.testing.assert_allclose(got[0][-bn:], np.broadcast_to(pad, (bn, D)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_node_without_incoming_edge(ref):
    """Every edge into one valid node masked out: its softmax holds the
    self loop alone (m = sl, den = 1)."""
    batch = _batch("chem")
    node = int(batch.receivers[batch.edge_mask][5])
    w = batch.edge_mask.numpy().astype(np.float32)
    w[batch.receivers.numpy() == node] = 0.0
    assert 0 < w.sum() < batch.edge_mask.sum()
    t, g = _inputs("chem", batch, seed=2, w=w)
    got = _port(t, g, batch)
    _assert_matches(got, REFS[ref](t, g, batch))
    x = (t["h"] @ t["Wl"] + t["bl"]).reshape(-1, H, D)
    want = (x[node] + t["e_self"]).mean(0) + t["bias"]
    np.testing.assert_allclose(got[0][node], want, rtol=1e-5, atol=1e-5)


def test_leaky_relu_slope_at_zero_is_one():
    """Both sides take LeakyReLU' = 1 at raw == 0: with zero attention
    vectors every logit is exactly 0, and da_j (which the other convention
    would scale by the slope) still matches. da_i is then a sum that
    cancels to 0 (x[r]·a_i shifts all of a receiver's logits alike), so
    only its size is held."""
    batch = _batch("chem")
    t, g = _inputs("chem", batch, seed=3)
    t["a_i"][:] = 0.0
    t["a_j"][:] = 0.0
    got = _port(t, g, batch)
    want = _jax_fused(t, g, batch)
    _assert_matches(got, want, skip=("da_i",))
    da_i, da_j = (got[1][LEAVES.index(k)] for k in ("a_i", "a_j"))
    assert np.abs(da_j).max() > 1e-2
    assert np.abs(da_i).max() <= 1e-4 * np.abs(da_j).max()


def test_set_fused_takes_on_or_off():
    assert gat_conv.fused_enabled()
    gat_conv.set_fused("off")
    try:
        assert not gat_conv.fused_enabled()
        with pytest.raises(ValueError, match="'on' or 'off'"):
            gat_conv.set_fused("auto")
    finally:
        gat_conv.set_fused("on")
    assert gat_conv.fused_enabled()
