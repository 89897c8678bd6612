"""The port's segment max / softmax (ops/segment.py) and GAT attention
(ops/attention.py) against the JAX package: ``segment_max``,
``segment_softmax`` and ``gat_attention_xla`` on the XLA path, and the
plain version of the blocked GAT attention (K5) against the Pallas TPU
kernels ``blocked_gat_forward`` / ``blocked_gat_backward`` in interpret
mode and float32, all five gradients by name; then the dispatch.

Inputs come from a numpy seed and go to both sides (2 heads, D = 20,
blocks of 32 nodes / 96 edge slots, as tests/test_pallas_attention.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.ops import attention as jattention
from pretrain_gnns_tpu.ops import pallas_attention
from pretrain_gnns_tpu.ops import segment as jseg
from pretrain_gnns_tpu_torch.core import graphs as tg
from pretrain_gnns_tpu_torch.data.synthetic import molecule_dataset
from pretrain_gnns_tpu_torch.ops import attention
from pretrain_gnns_tpu_torch.ops import segment as seg

H = 2
TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("dx", "de", "de_self", "da_i", "da_j")


def _segments(seed, rows=40, num_segments=9, trailing=(H,)):
    """Logits, ids (segments 3 and 8 stay empty) and a validity mask that
    empties segment 5 too."""
    rng = np.random.default_rng(seed)
    ids = rng.choice([0, 1, 2, 4, 5, 6, 7], size=rows).astype(np.int32)
    data = (rng.normal(size=(rows,) + trailing) * 3).astype(np.float32)
    mask = (rng.random(rows) < 0.7) & (ids != 5)
    extra = rng.normal(size=(num_segments,) + trailing).astype(np.float32)
    return data, ids, mask, extra, num_segments


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("trailing", [(), (H,)])
def test_segment_max_matches_jax(masked, trailing):
    data, ids, mask, _, n = _segments(0, trailing=trailing)
    m = mask if masked else None
    for empty_value in (0.0, -7.5):
        got = seg.segment_max(torch.from_numpy(data), torch.from_numpy(ids),
                              n, None if m is None else torch.from_numpy(m),
                              empty_value)
        want = jseg.segment_max(jnp.asarray(data), jnp.asarray(ids), n,
                                None if m is None else jnp.asarray(m),
                                empty_value)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got[3] == empty_value).all() and (got[8] == empty_value).all()
        if masked:
            assert (got[5] == empty_value).all()


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches_jax(masked, extra):
    """Probabilities and their gradients, with empty segments and, where
    masked, a segment whose rows are all invalid."""
    data, ids, mask, extra_logit, n = _segments(1)
    rng = np.random.default_rng(2)
    cot = rng.normal(size=data.shape).astype(np.float32)
    cot_x = rng.normal(size=extra_logit.shape).astype(np.float32)

    def jf(logits, xl):
        out = jseg.segment_softmax(
            logits, jnp.asarray(ids), n,
            jnp.asarray(mask) if masked else None, xl if extra else None)
        if extra:
            return jnp.sum(out[0] * cot) + jnp.sum(out[1] * cot_x), out
        return jnp.sum(out * cot), (out,)

    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(data), jnp.asarray(extra_logit))
    tl = torch.from_numpy(data).requires_grad_(True)
    tx = torch.from_numpy(extra_logit).requires_grad_(True)
    tout = seg.segment_softmax(
        tl, torch.from_numpy(ids), n,
        torch.from_numpy(mask) if masked else None, tx if extra else None)
    tout = tout if extra else (tout,)
    assert len(tout) == len(jout) == (2 if extra else 1)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    loss = (tout[0] * torch.from_numpy(cot)).sum()
    if extra:
        loss = loss + (tout[1] * torch.from_numpy(cot_x)).sum()
    loss.backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrads[0]), **TOL)
    if extra:
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[1]),
                                   **TOL)
        # a segment without valid rows gives its whole mass to the extra
        np.testing.assert_allclose(tout[1][3].detach().numpy(), 1.0)
    if masked:
        assert not tout[0][~torch.from_numpy(mask)].any()
    sums = seg.segment_sum(tout[0].detach(), torch.from_numpy(ids), n)
    if extra:
        sums = sums + tout[1].detach()
    filled = np.unique(ids[mask] if masked else ids)
    np.testing.assert_allclose(sums[filled].numpy(), 1.0, rtol=1e-5)


def _batch(blocked, seed=3):
    graphs, _ = molecule_dataset(10, seed=seed, mean_atoms=10)
    if blocked:
        return tg.pack_graphs_blocked(graphs, 5, 32, 96, max_graphs=10)
    return tg.pack_graphs(graphs, 160, 400, 10)


def _inputs(p, seed, D=20):
    rng = np.random.default_rng(seed)
    N, E = p.max_nodes, p.max_edges
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return (f(N, H, D), f(E, H, D, scale=0.3), f(H, D, scale=0.3),
            f(1, H, D, scale=0.2), f(1, H, D, scale=0.2)), f(N, H, D)


def _graph(p, lib):
    return tuple(lib(np.asarray(a)) for a in (p.senders, p.receivers))


@pytest.mark.parametrize("blocked", [False, True])
def test_gat_attention_plain_matches_xla(blocked):
    """Forward and the five gradients on both layouts; the CPU dispatch
    takes this path whatever the layout."""
    p = _batch(blocked)
    if blocked:  # the last block is all padding
        assert not np.asarray(p.node_mask)[-32:].any()
    args, cot = _inputs(p, 4)
    N = p.max_nodes
    mask = np.asarray(p.edge_mask)

    def jf(*a):
        return jattention.gat_attention_xla(
            *a, *_graph(p, jnp.asarray), jnp.asarray(mask), N, 0.2)

    jout, vjp = jax.vjp(jf, *map(jnp.asarray, args))
    jgrads = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    before = dict(attention.launches)
    tout = attention.gat_attention(
        *leaves, *_graph(p, torch.from_numpy), torch.from_numpy(mask), N,
        0.2, block_nodes=p.block_nodes, block_edges=p.block_edges)
    assert attention.launches == before  # no kernel on a CPU tensor
    assert torch.equal(tout, attention.gat_attention_plain(
        *leaves, *_graph(p, torch.from_numpy), torch.from_numpy(mask), N,
        0.2))
    assert torch.isfinite(tout).all()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    tout.backward(torch.from_numpy(cot))
    for name, leaf, ref in zip(NAMES, leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("seed", [5, 7])
def test_blocked_plain_version_matches_pallas_kernels(seed):
    """The plain K5 against the JAX Pallas forward and backward kernels
    (interpret mode), every row (padded rows and the all-padding block
    included) and all five gradients; a padded slot's de row is 0."""
    p = _batch(True, seed=seed)
    (x, e, e_self, a_i, a_j), cot = _inputs(p, seed)
    w = np.asarray(p.edge_mask, np.float32)
    snd, rcv = _graph(p, jnp.asarray)
    jargs = tuple(map(jnp.asarray, (x, e, e_self, a_i, a_j)))
    jout = pallas_attention.blocked_gat_forward(
        *jargs, snd, rcv, jnp.asarray(w), 0.2, p.block_nodes, p.block_edges,
        jnp.float32, True)
    jgrads = pallas_attention.blocked_gat_backward(
        *jargs, snd, rcv, jnp.asarray(w), jnp.asarray(cot), 0.2,
        p.block_nodes, p.block_edges, jnp.float32, True)

    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, e, e_self, a_i[0], a_j[0])]
    tout = attention.blocked_gat_attention(
        *leaves, *_graph(p, torch.from_numpy), torch.from_numpy(w), 0.2,
        p.block_nodes, p.block_edges)
    assert torch.isfinite(tout).all()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    tout.backward(torch.from_numpy(cot))
    for name, leaf, ref in zip(NAMES, leaves, jgrads):
        ref = np.asarray(ref).reshape(leaf.shape)  # da_i, da_j: [1, H, D]
        np.testing.assert_allclose(leaf.grad.numpy(), ref, err_msg=name,
                                   **TOL)
    assert not leaves[1].grad[torch.from_numpy(w) == 0].any()


def test_blocked_plain_version_takes_edge_weights():
    """``w`` multiplies p, as in the kernels: halving every weight of one
    receiver changes only that node's share of the self loop."""
    p = _batch(True)
    (x, e, e_self, a_i, a_j), _ = _inputs(p, 8)
    rcv = np.asarray(p.receivers)
    w = np.asarray(p.edge_mask, np.float32)
    node = int(rcv[np.asarray(p.edge_mask)][3])
    w2 = np.where(rcv == node, 0.5 * w, w).astype(np.float32)
    run = lambda ww: attention.blocked_gat_attention_plain(
        *map(torch.from_numpy, (x, e, e_self, a_i[0], a_j[0])),
        *_graph(p, torch.from_numpy), torch.from_numpy(ww), 0.2).numpy()
    out, out2 = run(w), run(w2)
    jout2 = pallas_attention.blocked_gat_forward(
        *map(jnp.asarray, (x, e, e_self, a_i, a_j)),
        *_graph(p, jnp.asarray), jnp.asarray(w2), 0.2, p.block_nodes,
        p.block_edges, jnp.float32, True)
    np.testing.assert_allclose(out2, np.asarray(jout2), **TOL)
    others = np.arange(p.max_nodes) != node
    np.testing.assert_array_equal(out[others], out2[others])
    assert np.abs(out[node] - out2[node]).max() > 1e-4


def test_plain_versions_are_one_implementation():
    """With weights of 0 and 1 the plain K5 is ``gat_attention_plain`` bit
    for bit, forward and in all five gradients; fractional weights (the
    test above) are the only case they differ in."""
    p = _batch(True)
    args, cot = _inputs(p, 9)
    mask = torch.from_numpy(np.asarray(p.edge_mask))
    graph = _graph(p, torch.from_numpy)

    def run(fn, *tail):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
        out = fn(*leaves, *graph, *tail)
        out.backward(torch.from_numpy(cot))
        return [out.detach()] + [leaf.grad for leaf in leaves]

    for a, b in zip(run(attention.gat_attention_plain, mask, p.max_nodes, 0.2),
                    run(attention.blocked_gat_attention_plain,
                        mask.to(torch.float32), 0.2)):
        assert torch.equal(a, b)


def test_leaky_relu_slope_at_zero():
    t = torch.tensor([-2.0, 0.0, 3.0], requires_grad=True)
    out = attention.leaky_relu(t, 0.2)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), [-0.4, 0.0, 3.0])
    np.testing.assert_allclose(t.grad.numpy(), [0.2, 1.0, 1.0])
