"""The port's blocked SpMM on a precomputed edge embedding (K6,
ops/blocked_spmm.blocked_spmm), its receiver-sorted variant (K7,
ops/sorted_spmm.py), the probe (ops/_build.probe) and the ``edge_emb`` and
``aggr`` forms of ops/spmm.gather_scatter, against the JAX package on the
same inputs, made with numpy from a seed.

On the CPU the port runs the kernels' plain PyTorch versions; the JAX side
runs its Pallas kernels in interpret mode with float32 compute, and its XLA
composition. Tolerances: forward rtol 1e-5 / atol 1e-5 and gradients rtol
1e-4 / atol 1e-5 (float32 on both sides; only the summation order
differs); the JAX sorted kernel subtracts prefix sums over a whole block,
so it is held to atol 1e-4, as its own test holds it. The CUDA kernels are
held against the plain versions in tests/test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.ops import pallas_spmm, pallas_spmm_sorted
from pretrain_gnns_tpu.ops import segment as jseg
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu_torch.core.graphs import pack_graphs_blocked
from pretrain_gnns_tpu_torch.data.synthetic import molecule_dataset
from pretrain_gnns_tpu_torch.ops import _build, blocked_spmm, sorted_spmm
from pretrain_gnns_tpu_torch.ops import spmm as tspmm

BN, BE, F, NB = 32, 96, 20, 6
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SORTED_TOL = dict(rtol=1e-5, atol=1e-4)
REFS = ["pallas_interpret", "xla"]


@pytest.fixture(scope="module")
def case():
    """A blocked batch (6 blocks of 32 nodes / 96 edge slots, the last
    ones all padding) and K6 inputs drawn from a seed: fractional and
    negative edge weights, 0 on the padded slots."""
    graphs, _ = molecule_dataset(10, seed=7, mean_atoms=10)
    p = pack_graphs_blocked(graphs, NB, BN, BE, max_graphs=10)
    assert not p.edge_mask.reshape(NB, BE)[-1].any()  # an all-padding block
    assert p.edge_mask.any() and not p.node_mask.all()
    rng = np.random.default_rng(0)
    N, E = p.max_nodes, p.max_edges

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    w = ((rng.random(E) * 2 - 0.5) * p.edge_mask).astype(np.float32)
    assert (w < 0).any()
    return dict(x=f32(N, F), ee=f32(E, F), senders=p.senders,
                receivers=p.receivers, w=w, g=f32(N, F),
                edge_mask=p.edge_mask, node_mask=p.node_mask,
                edge_weight=rng.random(E).astype(np.float32))


def _tensors(a):
    return {k: torch.from_numpy(np.array(v)) for k, v in a.items()}


def _jax_k6(a, has_ee, ref):
    """(out, dx, dee) of the JAX function on ``a``."""
    snd, rcv, w = (jnp.asarray(a[k]) for k in ("senders", "receivers", "w"))
    N = a["x"].shape[0]

    def f(x, ee):
        e = ee if has_ee else None
        if ref == "pallas_interpret":
            return pallas_spmm.blocked_spmm(x, e, snd, rcv, w, BN, BE,
                                            jnp.float32, True)
        msg = jnp.take(x, snd, axis=0)
        if has_ee:
            msg = msg + ee
        return jseg.segment_sum(msg * w[:, None], rcv, N)

    out, vjp = jax.vjp(f, jnp.asarray(a["x"]), jnp.asarray(a["ee"]))
    dx, dee = vjp(jnp.asarray(a["g"]))
    return np.asarray(out), np.asarray(dx), np.asarray(dee)


def _torch_k6(a, has_ee, fn=blocked_spmm.blocked_spmm_plain):
    """(out, dx, dee) of a port function on ``a`` (CPU tensors)."""
    t = _tensors(a)
    x = t["x"].requires_grad_(True)
    ee = t["ee"].requires_grad_(True)
    out = fn(x, ee if has_ee else None, t["senders"], t["receivers"],
             t["w"], BN, BE)
    dx, dee = torch.autograd.grad(out, [x, ee], t["g"], allow_unused=True)
    dee = np.zeros_like(a["ee"]) if dee is None else dee.numpy()
    return out.detach().numpy(), dx.numpy(), dee


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("has_ee", [True, False])
def test_plain_k6_matches_jax(case, has_ee, ref):
    out_j, dx_j, dee_j = _jax_k6(case, has_ee, ref)
    out_t, dx_t, dee_t = _torch_k6(case, has_ee)
    np.testing.assert_allclose(out_t, out_j, **FWD_TOL)
    np.testing.assert_allclose(dx_t, dx_j, err_msg="dx", **GRAD_TOL)
    np.testing.assert_allclose(dee_t, dee_j, err_msg="dee", **GRAD_TOL)
    if has_ee:
        # padded slots, the all-padding block included: exact zeros
        assert not np.any(dee_t[~case["edge_mask"]])
        assert np.any(dee_t)
    else:
        assert not np.any(dee_t) and not np.any(dee_j)
    assert not np.any(out_t[~case["node_mask"]])


@pytest.mark.parametrize("has_ee", [True, False])
def test_k6_wrapper_runs_plain_version_on_cpu(case, has_ee):
    before = dict(blocked_spmm.launches)
    got = _torch_k6(case, has_ee, blocked_spmm.blocked_spmm)
    want = _torch_k6(case, has_ee)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert blocked_spmm.launches == before


def test_k6_weight_gets_no_gradient(case):
    t = _tensors(case)
    w = t["w"].requires_grad_(True)
    x = t["x"].requires_grad_(True)
    out = blocked_spmm.blocked_spmm(x, t["ee"], t["senders"], t["receivers"],
                                    w, BN, BE)
    dx, dw = torch.autograd.grad(out, [x, w], t["g"], allow_unused=True)
    assert dx is not None and dw is None


def _sorted(a, with_ee=True):
    t = _tensors(a)
    return t, sorted_spmm.sort_block_edges(
        t["senders"], t["receivers"], t["w"], t["ee"] if with_ee else None,
        NB, BE)


def test_sort_block_edges_matches_jax(case):
    """Element for element: both sorts are stable."""
    ref = pallas_spmm_sorted.sort_block_edges(
        jnp.asarray(case["senders"]), jnp.asarray(case["receivers"]),
        jnp.asarray(case["w"]), jnp.asarray(case["ee"]), NB, BE)
    _, got = _sorted(case)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    r2 = got[1].reshape(NB, BE).numpy()
    assert (np.diff(r2, axis=1) >= 0).all()
    assert sorted_spmm.sort_block_edges(
        *(_tensors(case)[k] for k in ("senders", "receivers", "w")), None,
        NB, BE)[3] is None


@pytest.mark.parametrize("has_ee", [True, False])
def test_plain_k7_matches_jax_and_k6(case, has_ee):
    t, (s2, r2, w2, ee2) = _sorted(case, has_ee)
    ref = pallas_spmm_sorted.sorted_blocked_spmm(
        jnp.asarray(case["x"]),
        jnp.asarray(ee2.numpy()) if has_ee else None,
        jnp.asarray(s2.numpy()), jnp.asarray(r2.numpy()),
        jnp.asarray(w2.numpy()), BN, BE, jnp.float32, True)
    before = dict(sorted_spmm.launches)
    out = sorted_spmm.sorted_blocked_spmm(t["x"], ee2, s2, r2, w2, BN, BE)
    assert sorted_spmm.launches == before == {"sorted_blocked_spmm_fwd": 0}
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SORTED_TOL)
    # against K6 on the unsorted edges: equal up to the summation order
    k6 = blocked_spmm.blocked_spmm_plain(
        t["x"], t["ee"] if has_ee else None, t["senders"], t["receivers"],
        t["w"], BN, BE)
    np.testing.assert_allclose(out.numpy(), k6.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        out.numpy(), sorted_spmm.sorted_blocked_spmm_plain(
            t["x"], ee2, s2, r2, w2, BN, BE).numpy())


def test_k7_is_forward_only_and_checks_its_contract(case):
    t, (s2, r2, w2, ee2) = _sorted(case)
    x = t["x"].requires_grad_(True)
    out = sorted_spmm.sorted_blocked_spmm(x, ee2, s2, r2, w2, BN, BE)
    with pytest.raises(NotImplementedError, match="forward only"):
        out.sum().backward()
    # the unsorted edges break the contract: the CPU path says so
    assert (np.diff(case["receivers"].reshape(NB, BE), axis=1) < 0).any()
    with pytest.raises(ValueError, match="ascend"):
        sorted_spmm.sorted_blocked_spmm(
            t["x"].detach(), t["ee"], t["senders"], t["receivers"], t["w"],
            BN, BE)
    with pytest.raises(ValueError, match="block-diagonal"):
        sorted_spmm.sorted_blocked_spmm(t["x"].detach(), ee2, s2, r2, w2, 0,
                                        0)


@pytest.fixture(params=["pallas", "xla"])
def jax_backend_f32(request):
    """The JAX dispatch on its Pallas kernels (interpret mode on the CPU,
    float32 compute; its default is bfloat16) or on XLA."""
    backend, dtype = jspmm.get_backend(), jspmm._DTYPE
    jspmm.set_backend(request.param)
    jspmm.set_compute_dtype("float32")
    try:
        yield request.param
    finally:
        jspmm.set_backend(backend)
        jspmm.set_compute_dtype(dtype)


@pytest.mark.parametrize("combine,aggr,weighted", [
    ("add", "sum", True), ("concat", "sum", False), ("concat", "sum", True),
    ("add", "mean", False), ("concat", "mean", True)])
def test_gather_scatter_edge_emb_matches_jax(case, jax_backend_f32, combine,
                                             aggr, weighted):
    """``gather_scatter(..., edge_emb=...)``, value and both gradients,
    against the JAX dispatch on a blocked batch: the sum forms reach the
    Pallas ``blocked_spmm`` there (add directly, concat on a zero ``x``),
    the mean forms its XLA path."""
    a = case
    N = a["x"].shape[0]
    ew = jnp.asarray(a["edge_weight"]) if weighted else None
    snd, rcv, em = (jnp.asarray(a[k]) for k in
                    ("senders", "receivers", "edge_mask"))

    def f(x, ee):
        return jspmm.gather_scatter(x, ee, snd, rcv, em, N, combine=combine,
                                    aggr=aggr, edge_weight=ew,
                                    block_nodes=BN, block_edges=BE)

    ref, vjp = jax.vjp(f, jnp.asarray(a["x"]), jnp.asarray(a["ee"]))
    g = np.random.default_rng(1).normal(size=ref.shape).astype(np.float32)
    dx_j, dee_j = vjp(jnp.asarray(g))
    t = _tensors(a)
    x = t["x"].requires_grad_(True)
    ee = t["ee"].requires_grad_(True)
    before = dict(blocked_spmm.launches)
    got = tspmm.gather_scatter(
        x, t["senders"], t["receivers"], t["edge_mask"], N,
        edge_emb=ee, combine=combine, aggr=aggr,
        edge_weight=t["edge_weight"] if weighted else None, block_nodes=BN,
        block_edges=BE)
    assert blocked_spmm.launches == before  # the CPU launches nothing
    assert got.shape == ref.shape == (N, F if combine == "add" else 2 * F)
    dx, dee = torch.autograd.grad(got, [x, ee], torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **FWD_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), err_msg="dx",
                               **GRAD_TOL)
    np.testing.assert_allclose(dee.numpy(), np.asarray(dee_j), err_msg="dee",
                               **GRAD_TOL)


def test_gather_scatter_mean_with_edge_kernel_matches_jax(case):
    """The mean form with ``edge_in @ edge_kernel`` (the JAX package sends
    every mean to its XLA path)."""
    a = case
    rng = np.random.default_rng(2)
    N, E = a["x"].shape[0], a["senders"].shape[0]
    ein = rng.normal(size=(E, 9)).astype(np.float32)
    W = rng.normal(size=(9, F)).astype(np.float32)
    ref = jspmm.gather_scatter(
        jnp.asarray(a["x"]), None, jnp.asarray(a["senders"]),
        jnp.asarray(a["receivers"]), jnp.asarray(a["edge_mask"]), N,
        aggr="mean", block_nodes=BN, block_edges=BE,
        edge_in=jnp.asarray(ein), edge_kernel=jnp.asarray(W))
    t = _tensors(a)
    got = tspmm.gather_scatter(
        t["x"], t["senders"], t["receivers"], t["edge_mask"], N,
        edge_in=torch.from_numpy(ein), edge_kernel=torch.from_numpy(W),
        aggr="mean", block_nodes=BN, block_edges=BE)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


def test_dispatch_raises_and_counters(case):
    t = _tensors(case)
    graph = (t["senders"], t["receivers"], t["edge_mask"], t["x"].shape[0])
    with pytest.raises(ValueError, match="not both"):
        tspmm.gather_scatter(t["x"], *graph, edge_in=t["ee"][:, :3],
                             edge_kernel=t["x"][:3], edge_emb=t["ee"])
    with pytest.raises(ValueError, match="max"):
        tspmm.gather_scatter(t["x"], *graph, aggr="max")
    with pytest.raises(ValueError, match="concat"):
        tspmm.gather_scatter(t["x"], *graph, combine="concat")
    assert sorted(blocked_spmm.launches) == sorted(
        [f"blocked_spmm_{d}[{v}]" for d in ("fwd", "bwd")
         for v in ("x", "ein", "x+ein")]
        + [f"blocked_spmm_ee_{d}[{v}]" for d in ("fwd", "bwd")
           for v in ("x", "x+ee")])
    assert blocked_spmm.ee_variant(True) == "x+ee"
    assert blocked_spmm.ee_variant(False) == "x"
    assert not any(blocked_spmm.launches.values())


def test_kernel_entry_points_reject_cpu_tensors(case):
    t = _tensors(case)
    edges = (t["senders"], t["receivers"], t["w"], BN, BE)
    with pytest.raises(ValueError, match="CUDA"):
        blocked_spmm.spmm_ee_fwd(t["x"], t["ee"], *edges)
    with pytest.raises(ValueError, match="CUDA"):
        blocked_spmm.spmm_ee_bwd(t["g"], *edges, True)
    with pytest.raises(ValueError, match="CUDA"):
        sorted_spmm.sorted_spmm_fwd(t["x"], t["ee"], *edges)
    with pytest.raises(ValueError, match="both be false"):
        blocked_spmm.spmm_ee_bwd(t["g"], *edges, True, False, False)


def test_probe_on_the_cpu():
    """The probe kernel's wrapper runs its plain version on a CPU tensor
    and counts nothing; the probe itself needs a card and raises."""
    x = torch.arange(24, dtype=torch.float32).reshape(2, 12)
    before = dict(_build.launches)
    np.testing.assert_array_equal(_build.probe_scale2(x).numpy(),
                                  2 * x.numpy())
    assert _build.launches == before == {"probe_scale2": 0}
    assert _build.PROBE_SHAPE == (8, 300)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _build.probe()
        with pytest.raises(RuntimeError, match="CUDA"):
            _build.load("spmm_ee")  # no library is handed out unprobed
