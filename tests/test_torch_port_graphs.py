"""The port's host data path (pretrain_gnns_tpu_torch: core/graphs,
data/synthetic, data/packing, data/batch_transforms, data/prefetch)
against the JAX package, element for element on the same inputs."""

import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.data import batch_transforms as jbt
from pretrain_gnns_tpu.data import packing as jpk
from pretrain_gnns_tpu.data import prefetch as jpf
from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu_torch.core import graphs as tg
from pretrain_gnns_tpu_torch.data import batch_transforms as tbt
from pretrain_gnns_tpu_torch.data import packing as tpk
from pretrain_gnns_tpu_torch.data import prefetch as tpf
from pretrain_gnns_tpu_torch.data import synthetic as tsyn

FIELDS = ("node_feat", "edge_feat", "senders", "receivers", "node_graph",
          "node_mask", "edge_mask", "graph_mask", "y")


def _assert_same(port, ref):
    for f in FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        if b is None:
            assert a is None, f
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert sorted(port.extras) == sorted(ref.extras)
    for k in ref.extras:
        a, b = np.asarray(port.extras[k]), np.asarray(ref.extras[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert port.block_nodes == ref.block_nodes
    assert port.block_edges == ref.block_edges


def _datasets(n=48, seed=0, mean_atoms=18):
    return (tsyn.molecule_dataset(n, seed=seed, mean_atoms=mean_atoms)[0],
            jsyn.molecule_dataset(n, seed=seed, mean_atoms=mean_atoms)[0])


def _with_extras(graphs, mod):
    """Copy graphs and attach one extra of each offset kind."""
    out = []
    for i, g in enumerate(graphs):
        h = mod.Graph(g.node_feat, g.edge_index, g.edge_feat, y=g.y)
        h.extras["center"] = (np.array([i % g.num_nodes]), mod.NODE_IDX)
        h.extras["first_edge"] = (np.array([0]), mod.EDGE_IDX)
        h.extras["gid"] = (np.array([i]), mod.GRAPH)
        out.append(h)
    return out


@pytest.mark.parametrize("seed", [0, 5])
def test_molecule_dataset_identical(seed):
    tgs, tsc = tsyn.molecule_dataset(40, num_tasks=3, seed=seed,
                                     missing_frac=0.2)
    jgs, jsc = jsyn.molecule_dataset(40, num_tasks=3, seed=seed,
                                     missing_frac=0.2)
    assert tsc == jsc
    for a, b in zip(tgs, jgs):
        for f in ("node_feat", "edge_index", "edge_feat", "y"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert getattr(a, f).dtype == getattr(b, f).dtype


def test_pack_graphs_blocked_matches_jax():
    tgs, jgs = _datasets()
    blocks = jpk.block_layout(jgs, 48, block_nodes=64, block_edges=192)
    assert tpk.block_layout(tgs, 48, block_nodes=64,
                            block_edges=192) == blocks
    extra_pad = {"center": 48, "first_edge": 48}
    port = tg.pack_graphs_blocked(_with_extras(tgs, tg), *blocks, 48,
                                  extra_pad=extra_pad)
    ref = jg.pack_graphs_blocked(_with_extras(jgs, jg), *blocks, 48,
                                 extra_pad=extra_pad, np_out=True)
    _assert_same(port, ref)


def test_pack_graphs_matches_jax():
    tgs, jgs = _datasets()
    mn, me = jpk.buffer_sizes(jgs, 48)
    assert tpk.buffer_sizes(tgs, 48) == (mn, me)
    extra_pad = {"center": 48, "first_edge": 48}
    port = tg.pack_graphs(_with_extras(tgs, tg), mn, me, 48,
                          extra_pad=extra_pad)
    ref = jg.pack_graphs(_with_extras(jgs, jg), mn, me, 48,
                         extra_pad=extra_pad, np_out=True)
    _assert_same(port, ref)


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("mask_edge", [False, True])
def test_packed_loader_with_masking_matches_jax(blocked, mask_edge):
    """Two shuffled epochs: same batches, same masks and extras."""
    tgs, jgs = _datasets(80, seed=2)
    blocks = (jpk.block_layout(jgs, 16, block_nodes=64, block_edges=192)
              if blocked else None)
    kw = dict(mask_rate=0.15, mask_edge=mask_edge, node_budget=200,
              edge_budget=400)
    tl = tpk.PackedLoader(tgs, 16, seed=3, blocks=blocks, drop_last=True,
                          post_transform=tbt.BatchMaskAtom(**kw))
    jl = jpk.PackedLoader(jgs, 16, seed=3, blocks=blocks, drop_last=True,
                          post_transform=jbt.BatchMaskAtom(**kw))
    assert len(tl) == len(jl)
    for _ in range(2):
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) > 0
        for a, b in zip(tb, jb):
            _assert_same(a, b)
        assert tl.last_epoch_stats == jl.last_epoch_stats


def test_packed_loader_early_flush_matches_jax():
    """Undersized buffers flush batches early in the same places."""
    tgs, jgs = _datasets(40, seed=4)
    tb = list(tpk.PackedLoader(tgs, 16, 160, 400, shuffle=False))
    jb = list(jpk.PackedLoader(jgs, 16, 160, 400, shuffle=False))
    assert len(tb) == len(jb) > 3
    for a, b in zip(tb, jb):
        _assert_same(a, b)


@pytest.mark.parametrize("rate", [0.15, 0.5])
def test_sample_per_group_matches_jax(rate):
    rng = np.random.default_rng(0)
    gid = rng.integers(0, 10, 300)
    valid = rng.random(300) < 0.8
    a = tbt.sample_per_group_np(np.random.default_rng(9), gid, valid, 10,
                                rate)
    b = jbt.sample_per_group_np(np.random.default_rng(9), gid, valid, 10,
                                rate)
    np.testing.assert_array_equal(a, b)


def test_choose_blocks_follows_device():
    tgs, _ = _datasets()
    assert tpk.choose_blocks(tgs, 16, "auto", torch.device("cpu")) is None
    assert tpk.choose_blocks(tgs, 16, "auto", torch.device("cuda")) == \
        tpk.block_layout(tgs, 16, block_nodes=128, block_edges=384)
    assert tpk.choose_blocks(tgs, 16, "standard",
                             torch.device("cuda")) is None
    assert tpk.choose_blocks(tgs, 16, "blocked") is not None
    with pytest.raises(ValueError):
        tpk.choose_blocks(tgs, 16, "bogus")


def test_packed_graphs_to_tensors():
    tgs, _ = _datasets(8)
    p = tg.pack_graphs_blocked(tgs, 4, 64, 192, 8)
    t = p.to("cpu")
    assert t.senders.dtype == torch.int32
    assert t.node_mask.dtype == torch.bool
    assert t.node_feat.dtype == torch.int64
    assert (t.block_nodes, t.block_edges) == (64, 192)
    np.testing.assert_array_equal(t.senders.numpy(), p.senders)
    assert t.max_nodes == 256 and t.max_edges == 768 and t.max_graphs == 8


def test_prefetch_and_chunked_match_jax():
    items = list(range(11))
    assert list(tpf.prefetch(iter(items), depth=2)) == list(
        jpf.prefetch(iter(items), depth=2))
    assert list(tpf.chunked(iter(items), 4)) == list(
        jpf.chunked(iter(items), 4))

    def boom():
        yield 1
        raise KeyError("producer failed")

    with pytest.raises(KeyError):
        list(tpf.prefetch(boom()))
