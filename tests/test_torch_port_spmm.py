"""The port's fused edge-transform SpMM (pretrain_gnns_tpu_torch/ops/
blocked_spmm.py, K2) and the dispatch of ops/spmm.gather_scatter against
the JAX package on the same inputs, made with numpy from a seed.

On the CPU the port runs K2's plain PyTorch version; the JAX side runs the
Pallas kernel in interpret mode (pallas_spmm.blocked_spmm_fused(...,
float32, interpret=True)) and its XLA composition. Tolerances: rtol 1e-5 /
atol 1e-6 forward, rtol 1e-4 / atol 1e-5 gradients (float32 on both
sides; only the summation order differs). The CUDA kernels are held
against the plain version in tests/test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.ops import pallas_spmm
from pretrain_gnns_tpu.ops import segment as jseg
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu_torch.core.graphs import pack_graphs_blocked
from pretrain_gnns_tpu_torch.data.synthetic import molecule_dataset
from pretrain_gnns_tpu_torch.ops import blocked_spmm
from pretrain_gnns_tpu_torch.ops import spmm as tspmm

BN, BE, F, K = 32, 96, 20, 10
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
VARIANTS = [(True, True), (True, False), (False, True)]
REFS = ["pallas_interpret", "xla"]


@pytest.fixture(scope="module")
def case():
    """A blocked batch (4 blocks of 32 nodes / 96 edge slots) and K2 inputs
    drawn from a seed: signed edge weights, 0 on the padded slots."""
    graphs, _ = molecule_dataset(10, seed=7, mean_atoms=10)
    p = pack_graphs_blocked(graphs, 4, BN, BE, max_graphs=10)
    assert not p.edge_mask.all() and not p.node_mask.all()
    rng = np.random.default_rng(0)
    N, E = p.max_nodes, p.max_edges

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    w = ((rng.random(E) * 2 - 0.5) * p.edge_mask).astype(np.float32)
    return dict(x=f32(N, F), ein=f32(E, K), W=f32(K, F), senders=p.senders,
                receivers=p.receivers, w=w, g=f32(N, F),
                edge_mask=p.edge_mask, edge_weight=rng.random(E).astype(
                    np.float32), node_mask=p.node_mask)


def _jax_k2(a, has_x, has_ein, ref):
    """(out, dx, dW) of the JAX function on ``a``."""
    snd, rcv, w = (jnp.asarray(a[k]) for k in ("senders", "receivers", "w"))
    ein = jnp.asarray(a["ein"])
    N = a["x"].shape[0]

    def f(x, W):
        if ref == "pallas_interpret":
            return pallas_spmm.blocked_spmm_fused(
                x, ein if has_ein else None, W if has_ein else None, snd,
                rcv, w, BN, BE, jnp.float32, True, has_x, has_ein)
        msg = jnp.zeros((snd.shape[0], F), jnp.float32)
        if has_x:
            msg = msg + jnp.take(x, snd, axis=0)
        if has_ein:
            msg = msg + ein @ W
        return jseg.segment_sum(msg * w[:, None], rcv, N)

    out, vjp = jax.vjp(f, jnp.asarray(a["x"]), jnp.asarray(a["W"]))
    dx, dW = vjp(jnp.asarray(a["g"]))
    return np.asarray(out), np.asarray(dx), np.asarray(dW)


def _torch_k2(a, has_x, has_ein, fn=blocked_spmm.blocked_spmm_fused_plain):
    """(out, dx, dW) of a port function on ``a`` (CPU tensors)."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    x = t["x"].requires_grad_(True)
    W = t["W"].requires_grad_(True)
    out = fn(x, t["ein"], W, t["senders"], t["receivers"], t["w"], BN, BE,
             has_x, has_ein)
    dx, dW = torch.autograd.grad(out, [x, W], t["g"], allow_unused=True)
    dx = np.zeros_like(a["x"]) if dx is None else dx.numpy()
    dW = np.zeros_like(a["W"]) if dW is None else dW.numpy()
    return out.detach().numpy(), dx, dW


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("has_x,has_ein", VARIANTS)
def test_plain_matches_jax(case, has_x, has_ein, ref):
    out_j, dx_j, dW_j = _jax_k2(case, has_x, has_ein, ref)
    out_t, dx_t, dW_t = _torch_k2(case, has_x, has_ein)
    np.testing.assert_allclose(out_t, out_j, **FWD_TOL)
    np.testing.assert_allclose(dx_t, dx_j, err_msg="dx", **GRAD_TOL)
    if has_ein:
        np.testing.assert_allclose(dW_t, dW_j, err_msg="dW", **GRAD_TOL)
    if not has_x:
        assert not np.any(dx_t) and not np.any(dx_j)


@pytest.mark.parametrize("has_x,has_ein", VARIANTS)
def test_wrapper_runs_plain_version_on_cpu(case, has_x, has_ein):
    before = dict(blocked_spmm.launches)
    got = _torch_k2(case, has_x, has_ein, blocked_spmm.blocked_spmm_fused)
    want = _torch_k2(case, has_x, has_ein)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert blocked_spmm.launches == before


def test_padded_rows_come_out_zero(case):
    out, _, _ = _torch_k2(case, True, True)
    assert not np.any(out[~case["node_mask"]])


def test_launch_counters_and_variants():
    # K2's six counters, and K6's four beside them in the same dict
    assert sorted(k for k in blocked_spmm.launches if "_ee_" not in k) == sorted(
        f"blocked_spmm_{d}[{v}]" for d in ("fwd", "bwd")
        for v in ("x", "ein", "x+ein"))
    assert sum("_ee_" in k for k in blocked_spmm.launches) == 4
    assert blocked_spmm.variant(True, False) == "x"
    with pytest.raises(ValueError, match="both be false"):
        blocked_spmm.variant(False, False)


def test_kernel_entry_points_reject_cpu_tensors(case):
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items()}
    with pytest.raises(ValueError, match="CUDA"):
        blocked_spmm.spmm_fwd(t["x"], t["ein"], t["W"], t["senders"],
                              t["receivers"], t["w"], BN, BE)
    with pytest.raises(ValueError, match="CUDA"):
        blocked_spmm.spmm_bwd(t["g"], t["ein"], t["senders"],
                              t["receivers"], t["w"], K, BN, BE)


@pytest.fixture
def jax_pallas_f32():
    """The JAX dispatch on its Pallas kernels (interpret mode on the CPU)
    in float32; the JAX default compute dtype is bfloat16."""
    backend, dtype = jspmm.get_backend(), jspmm._DTYPE
    jspmm.set_backend("pallas")
    jspmm.set_compute_dtype("float32")
    try:
        yield
    finally:
        jspmm.set_backend(backend)
        jspmm.set_compute_dtype(dtype)


@pytest.mark.parametrize("combine,weighted", [("concat", False),
                                              ("add", True)])
def test_gather_scatter_matches_jax_dispatch(case, jax_pallas_f32, combine,
                                             weighted):
    """The CPU dispatch (plain path) against JAX ``gather_scatter`` on a
    blocked batch, which routes to the Pallas K2: the bio concat message
    and the weighted add form (GCN's) with ``edge_in @ edge_kernel``."""
    a = case
    N = a["x"].shape[0]
    ew = a["edge_weight"] if weighted else None
    ref = jspmm.gather_scatter(
        jnp.asarray(a["x"]), None, jnp.asarray(a["senders"]),
        jnp.asarray(a["receivers"]), jnp.asarray(a["edge_mask"]), N,
        combine=combine, edge_weight=None if ew is None else jnp.asarray(ew),
        block_nodes=BN, block_edges=BE, edge_in=jnp.asarray(a["ein"]),
        edge_kernel=jnp.asarray(a["W"]))
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    got = tspmm.gather_scatter(
        t["x"], t["senders"], t["receivers"], t["edge_mask"], N,
        edge_in=t["ein"], edge_kernel=t["W"], combine=combine,
        edge_weight=t["edge_weight"] if weighted else None,
        block_nodes=BN, block_edges=BE)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
