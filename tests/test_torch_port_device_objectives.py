"""The draws inside the step (``transform_device="device"``) on the CPU:
``objectives/masking.FusedMaskingObjective`` and ``sample_masked_nodes``,
``objectives/edgepred.sample_negative_edges`` and ``EdgePredObjective`` on
a batch without negatives.

The device samplers draw from torch generators, which cannot give
``jax.random``'s draws, so they are held to their properties (per-graph
counts and support; no self-loop, no existing edge, no repeat, both ends in
one graph, at most ``E_g // 2`` pairs a graph, a blocked batch's pairs in
their own block's slots), and the objective to the JAX objective on the
same mask (``masked_override``): loss rtol 1e-5, every gradient and the
batch-norm statistics rtol 1e-4 (atol 1e-5 of the tensor's largest
entry), mask_edge on and off. The blocked layout of the negatives gives
the compact list's loss and ``dx`` (rtol 1e-6). Sizes: 2 layers, emb 16,
batches of 8 graphs."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.objectives import masking as jmasking
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.data.packing import make_loader
from pretrain_gnns_tpu_torch.objectives import edgepred, masking
from pretrain_gnns_tpu_torch.ops import spmm

LAYERS, EMB, BATCH = 2, 16, 8
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
LAYOUT_TOL = dict(rtol=1e-6, atol=1e-7)
BLOCKS = (4, 128, 384)


def _batch(domain="chem", blocked=False, i=0):
    graphs = (tsyn.bio_dataset(32, seed=1) if domain == "bio"
              else tsyn.molecule_dataset(32, seed=1)[0])
    loader = make_loader(graphs, BATCH, 512, 1024, seed=i,
                         blocks=BLOCKS if blocked else None,
                         extra_pad=({"center_node_idx": BATCH}
                                    if domain == "bio" else None))
    return next(iter(loader)).to("cpu")


@contextlib.contextmanager
def jax_float32():
    backend, dtype = jspmm.get_backend(), jspmm._DTYPE
    jspmm.set_backend("xla")
    jspmm.set_compute_dtype("float32")
    try:
        yield
    finally:
        jspmm.set_backend(backend)
        jspmm.set_compute_dtype(dtype)


def _jax_batch(b):
    return jg.PackedGraphs(
        node_feat=jnp.asarray(b.node_feat.numpy()),
        edge_feat=jnp.asarray(b.edge_feat.numpy()),
        senders=jnp.asarray(b.senders.numpy()),
        receivers=jnp.asarray(b.receivers.numpy()),
        node_graph=jnp.asarray(b.node_graph.numpy()),
        node_mask=jnp.asarray(b.node_mask.numpy()),
        edge_mask=jnp.asarray(b.edge_mask.numpy()),
        graph_mask=jnp.asarray(b.graph_mask.numpy()),
        extras={}, block_nodes=b.block_nodes, block_edges=b.block_edges)


def _loss(model, b, **kw) -> float:
    with torch.no_grad():
        return float(model(b, train=False, **kw)[0])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- sample_masked_nodes ------------------------------------------------------

@pytest.mark.parametrize("rate", [0.15, 0.5])
@pytest.mark.parametrize("blocked", [False, True], ids=["standard",
                                                         "blocked"])
def test_sample_masked_nodes_properties(blocked, rate):
    """Each graph's count is the JAX sampler's ``floor(n_g * rate + 1e-4) +
    1`` (equal to what the JAX function draws on the same batch), every
    masked node is valid, the same generator state repeats the draw, and
    over draws every valid node gets masked (the support is all of it)."""
    b = _batch(blocked=blocked)
    ng, nm = b.node_graph.numpy(), b.node_mask.numpy()
    n_g = np.bincount(ng[nm], minlength=b.max_graphs)
    jm = np.asarray(jmasking.sample_masked_nodes(
        jax.random.PRNGKey(0), jnp.asarray(ng), jnp.asarray(nm),
        b.max_graphs, rate))
    want = np.bincount(ng[jm], minlength=b.max_graphs)
    seen = np.zeros(b.max_nodes, bool)
    for seed in range(40):
        gen = torch.Generator().manual_seed(seed)
        m = masking.sample_masked_nodes(b.node_graph, b.node_mask,
                                        b.max_graphs, rate, gen).numpy()
        assert not (m & ~nm).any()
        np.testing.assert_array_equal(
            np.bincount(ng[m], minlength=b.max_graphs), want)
        seen |= m
        if seed == 0:
            again = masking.sample_masked_nodes(
                b.node_graph, b.node_mask, b.max_graphs, rate,
                torch.Generator().manual_seed(0)).numpy()
            np.testing.assert_array_equal(m, again)
    assert (want[n_g > 0] >= 1).all()
    assert seen[nm].all()


# --- FusedMaskingObjective -----------------------------------------------------

@pytest.mark.parametrize("mask_edge", [True, False])
def test_fused_masking_matches_jax_on_the_same_mask(mask_edge):
    """One train-mode step on a clean batch with ``masked_override``: loss
    and metrics, every gradient and the batch-norm statistics against the
    JAX ``FusedMaskingObjective`` from the same weights."""
    b = _batch()
    gen = torch.Generator().manual_seed(5)
    override = masking.sample_masked_nodes(b.node_graph, b.node_mask,
                                           b.max_graphs, 0.15, gen)
    jm = jmasking.FusedMaskingObjective(num_layer=LAYERS, emb_dim=EMB,
                                        mask_edge=mask_edge)
    jb = _jax_batch(b)
    jover = jnp.asarray(override.numpy())
    with jax_float32():
        variables = jm.init({"params": jax.random.PRNGKey(0),
                             "mask": jax.random.PRNGKey(1)}, jb,
                            train=False, masked_override=jover)

        def loss_fn(params):
            (loss, metrics), mutated = jm.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jb, train=True, masked_override=jover,
                mutable=["batch_stats"])
            return loss, (metrics, mutated)

        (jloss, (jmetrics, mutated)), jgrads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
    model = masking.FusedMaskingObjective(num_layer=LAYERS, emb_dim=EMB,
                                          mask_edge=mask_edge)
    model.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])),
        strict=True)
    loss, metrics = model(b, train=True, masked_override=override)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   err_msg=k, **LOSS_TOL)
    ref = state_dict_from_jax(_np_tree(jgrads),
                              _np_tree(mutated["batch_stats"]))
    checked = [(n, p.grad) for n, p in model.named_parameters()] + [
        (n, v) for n, v in model.named_buffers()
        if n.endswith(("running_mean", "running_var"))]
    assert len(checked) > 8
    for name, got in checked:
        want = ref[name].numpy()
        np.testing.assert_allclose(
            got.detach().numpy(), want, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(1.0, float(np.abs(want).max())),
            err_msg=name)


def test_fused_masking_draws_from_its_mask_stream():
    """Without an override the step draws its mask from the objective's
    ``mask`` stream: the same seed the same loss, the next draw another;
    the loss equals the override's with the mask that stream draws."""
    b = _batch()
    model = masking.FusedMaskingObjective(num_layer=LAYERS, emb_dim=EMB)
    model.seed_masks(3)
    first = _loss(model, b)
    second = _loss(model, b)
    model.seed_masks(3)
    assert _loss(model, b) == first != second
    mask = masking.sample_masked_nodes(
        b.node_graph, b.node_mask, b.max_graphs, 0.15,
        torch.Generator().manual_seed(3))
    assert _loss(model, b, masked_override=mask) == first
    assert model.draws() and model.dropout_states()


# --- sample_negative_edges -----------------------------------------------------

def _check_negatives(b, pairs, mask):
    """The sampler's properties; returns the kept pairs as keys."""
    pairs, mask = pairs.numpy(), mask.numpy()
    a, c = pairs[mask, 0].astype(np.int64), pairs[mask, 1].astype(np.int64)
    N = b.max_nodes
    ng, nm, em = (b.node_graph.numpy(), b.node_mask.numpy(),
                  b.edge_mask.numpy())
    snd, rcv = b.senders.numpy()[em], b.receivers.numpy()[em]
    keys = a * N + c
    assert mask.any()
    assert (a != c).all()
    assert nm[a].all() and nm[c].all() and (ng[a] == ng[c]).all()
    assert len(set(keys.tolist())) == len(keys)
    assert not set(keys.tolist()) & set((snd.astype(np.int64) * N
                                         + rcv).tolist())
    quota = np.bincount(ng[snd], minlength=b.max_graphs) // 2
    assert (np.bincount(ng[a], minlength=b.max_graphs) <= quota).all()
    return set(keys.tolist())


@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_sample_negative_edges_properties_and_layouts(domain):
    """Standard and blocked: the properties; on a blocked batch the pairs
    lie in their block's ``block_edges // 2`` slots, and the compact list
    drawn from the same generator state (the same batch read as standard)
    holds the same set of pairs, in slot order, each layout's kept pairs
    first."""
    std = _batch(domain)
    pairs, mask = edgepred.sample_negative_edges(
        std, torch.Generator().manual_seed(0))
    assert pairs.shape == (std.max_edges // 2, 2) and pairs.dtype == (
        torch.int32)
    _check_negatives(std, pairs, mask)
    assert not mask[int(mask.sum()):].any()

    b = _batch(domain, blocked=True)
    bp, bm = edgepred.sample_negative_edges(
        b, torch.Generator().manual_seed(1))
    half = b.block_edges // 2
    assert bp.shape == (b.max_edges // 2, 2)
    keys = _check_negatives(b, bp, bm)
    slot_block = np.nonzero(bm.numpy())[0] // half
    kept = bp.numpy()[bm.numpy()]
    assert (kept[:, 0] // b.block_nodes == slot_block).all()
    assert (kept[:, 1] // b.block_nodes == slot_block).all()
    flat = b.replace(block_nodes=0, block_edges=0)
    cp, cm = edgepred.sample_negative_edges(
        flat, torch.Generator().manual_seed(1))
    assert keys == _check_negatives(flat, cp, cm)
    np.testing.assert_array_equal(np.sort(kept, axis=0),
                                  np.sort(cp.numpy()[cm.numpy()], axis=0))


def test_blocked_negatives_give_the_compact_loss_and_dx():
    """The negative head's masked BCE over the blocked layout and over the
    compact list of the same draw: loss and ``dx`` (rtol 1e-6)."""
    b = _batch(blocked=True)
    h0 = torch.randn(b.max_nodes, EMB, generator=torch.Generator()
                     .manual_seed(2)) * b.node_mask[:, None]
    out = []
    for blocked in (True, False):
        g = b if blocked else b.replace(block_nodes=0, block_edges=0)
        pairs, mask = edgepred.sample_negative_edges(
            g, torch.Generator().manual_seed(4))
        h = h0.clone().requires_grad_()
        args = (g.block_nodes, g.block_edges // 2) if blocked else ()
        score = spmm.edge_dot(h, pairs[:, 0].contiguous(),
                              pairs[:, 1].contiguous(), mask, *args)
        loss = edgepred._masked_bce_mean(score, 0.0, mask)
        loss.backward()
        out.append((float(loss.detach()), h.grad))
    np.testing.assert_allclose(out[0][0], out[1][0], **LAYOUT_TOL)
    np.testing.assert_allclose(out[0][1].numpy(), out[1][1].numpy(),
                               **LAYOUT_TOL)


@pytest.mark.parametrize("blocked", [False, True], ids=["standard",
                                                         "blocked"])
def test_edgepred_draws_what_it_is_given(blocked):
    """A batch without negatives: the objective's loss equals its loss on
    the same batch carrying the pairs that its mask stream draws (the
    layout's extra), and the stream moves on from step to step."""
    b = _batch("bio", blocked=blocked)
    from pretrain_gnns_tpu_torch.models import bio

    model = edgepred.EdgePredObjective(num_layer=LAYERS, emb_dim=EMB,
                                       trunk=bio.GNN)
    model.seed_masks(9)
    drawn = _loss(model, b)
    nxt = _loss(model, b)
    pairs, mask = edgepred.sample_negative_edges(
        b, torch.Generator().manual_seed(9))
    key = "negative_edges_blocked" if blocked else "negative_edges"
    given = b.replace(extras={**b.extras, key: pairs, f"{key}_mask": mask})
    assert _loss(model, given) == drawn != nxt
