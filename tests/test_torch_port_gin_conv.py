"""The port's fused GIN conv (pretrain_gnns_tpu_torch/ops/gin_conv.py, K1)
and its plain building blocks (ops/spmm.py, ops/segment.py) against the
JAX package on the same inputs, made with numpy from a seed.

On the CPU the port runs K1's plain PyTorch version; the JAX side runs the
Pallas kernel in interpret mode (pallas_gin.fused_gin_conv(...,
interpret=True)) and its unfused XLA composition. The CUDA kernels are
held against the plain version in tests/test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.data.packing import PackedLoader, block_layout
from pretrain_gnns_tpu.data.synthetic import molecule_dataset
from pretrain_gnns_tpu.ops import pallas_gin
from pretrain_gnns_tpu.ops import segment as jseg
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu_torch.ops import gin_conv
from pretrain_gnns_tpu_torch.ops import segment as tseg
from pretrain_gnns_tpu_torch.ops import spmm as tspmm

F, F2, K = 32, 64, 9
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
DIFF = ("x", "We", "e_self", "W1", "b1", "W2", "b2")
SUM_THREADS = 8


@pytest.fixture(scope="module")
def case():
    """A blocked batch (blocks 64/192) and K1 inputs drawn from a seed."""
    graphs, _ = molecule_dataset(32, num_tasks=1, seed=0, mean_atoms=20)
    blocks = block_layout(graphs, 32, block_nodes=64, block_edges=192)
    b = next(iter(PackedLoader(graphs, 32, shuffle=False, blocks=blocks)))
    rng = np.random.default_rng(0)
    N, E = b.node_feat.shape[0], b.senders.shape[0]
    ef = np.asarray(b.edge_feat)
    ein = np.concatenate([np.eye(6, dtype=np.float32)[ef[:, 0]],
                          np.eye(3, dtype=np.float32)[ef[:, 1]]], axis=1)
    nm = np.asarray(b.node_mask)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    arrays = dict(
        x=f32(N, F) * nm[:, None], We=f32(K, F), e_self=f32(F),
        W1=f32(F, F2, scale=F ** -0.5), b1=f32(F2),
        W2=f32(F2, F, scale=F2 ** -0.5),
        b2=f32(F), ein=ein, senders=np.asarray(b.senders),
        receivers=np.asarray(b.receivers),
        w=np.asarray(b.edge_mask).astype(np.float32), nmask=nm,
        g=f32(N, F),
    )
    return arrays, blocks[1], blocks[2]


def _torch(a, grad=()):
    out = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    for k in grad:
        out[k].requires_grad_(True)
    return out


def _plain(t, bn, be, **kw):
    return gin_conv.fused_gin_conv_plain(
        t["x"], t["ein"], t["We"], t["e_self"], t["W1"], t["b1"], t["W2"],
        t["b2"], t["senders"], t["receivers"], t["w"], t["nmask"], bn, be,
        **kw)


def _pallas(a, bn, be):
    def f(x, We, e_self, W1, b1, W2, b2):
        return pallas_gin.fused_gin_conv(
            x, a["ein"], We, e_self, W1, b1, W2, b2, a["senders"],
            a["receivers"], a["w"], a["nmask"], bn, be, jnp.float32, True)
    return f


def _unfused(a):
    """The JAX XLA composition the fused kernel replaces."""
    N = a["x"].shape[0]

    def f(x, We, e_self, W1, b1, W2, b2):
        aggr = jspmm._xla(x, a["ein"] @ We, a["senders"], a["receivers"],
                          a["w"] > 0, N, "add", "sum", None)
        aggr = aggr + (x + e_self) * a["nmask"][:, None]
        z = jax.nn.relu(aggr @ W1 + b1)
        return z @ W2 + b2
    return f


def _jax_fwd_grads(f, a):
    args = [jnp.asarray(a[k]) for k in DIFF]
    out = f(*args)
    grads = jax.grad(lambda *p: jnp.sum(f(*p) * a["g"]),
                     argnums=tuple(range(len(DIFF))))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_fwd_grads(a, bn, be):
    """The plain version's output and gradients, with torch's CPU thread
    count pinned to SUM_THREADS for the call. The gradients are float32
    sums of some 600 products on both sides, and MKL orders a product's
    sums by its thread count: of the 2,048 W2 gradients one lies at 0.54
    (Pallas) and 0.67 (XLA) of GRAD_TOL with 2 or 8 threads and at 1.78
    and 1.15 with 1 or 4 (the JAX side's own float32 W2 gradient is at
    1.12 of it against a float64 reference). The pin keeps the torch
    side's order, the one of 8 threads under which the test has run, from
    depending on the environment (OMP_NUM_THREADS)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(SUM_THREADS)
    try:
        t = _torch(a, grad=DIFF)
        out = _plain(t, bn, be)
        grads = torch.autograd.grad(out, [t[k] for k in DIFF], t["g"])
    finally:
        torch.set_num_threads(prev)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_unfused"])
def test_plain_forward_matches_jax(case, ref):
    a, bn, be = case
    f = _pallas(a, bn, be) if ref == "pallas_interpret" else _unfused(a)
    out_j = np.asarray(f(*[jnp.asarray(a[k]) for k in DIFF]))
    out_t = _plain(_torch(a), bn, be).numpy()
    np.testing.assert_allclose(out_t, out_j, **FWD_TOL)


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_unfused"])
def test_plain_gradients_match_jax(case, ref):
    a, bn, be = case
    f = _pallas(a, bn, be) if ref == "pallas_interpret" else _unfused(a)
    _, gj = _jax_fwd_grads(f, a)
    _, gt = _torch_fwd_grads(a, bn, be)
    for name, x, y in zip(DIFF, gt, gj):
        np.testing.assert_allclose(x, y, err_msg=name, **GRAD_TOL)


def test_plain_residuals_match_pallas(case):
    """aggr and z, the residuals the kernel forward saves."""
    a, bn, be = case
    _, aggr_j, z_j = pallas_gin._call_fwd(
        *[jnp.asarray(a[k]) for k in ("x", "ein", "We", "e_self", "W1",
                                      "b1", "W2", "b2", "senders",
                                      "receivers", "w", "nmask")],
        bn, be, jnp.float32, True, save_res=True)
    _, aggr_t, z_t = _plain(_torch(a), bn, be, return_residuals=True)
    np.testing.assert_allclose(aggr_t.numpy(), np.asarray(aggr_j)[:, :F],
                               **FWD_TOL)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **FWD_TOL)


def test_padded_rows_poisoned_leave_valid_rows(case):
    """Junk in padded node rows changes no valid row; padded rows get
    relu(b1) @ W2 + b2 as in the JAX kernel."""
    a, bn, be = case
    nm = a["nmask"]
    out1 = _plain(_torch(a), bn, be).numpy()
    b = dict(a)
    b["x"] = np.where(nm[:, None], a["x"], np.float32(1e3))
    out2 = _plain(_torch(b), bn, be).numpy()
    np.testing.assert_array_equal(out1[nm], out2[nm])
    pad = np.maximum(a["b1"], 0) @ a["W2"] + a["b2"]
    np.testing.assert_allclose(
        out1[~nm], np.broadcast_to(pad, out1[~nm].shape), **FWD_TOL)


def test_wrapper_runs_plain_version_on_cpu(case):
    a, bn, be = case
    t = _torch(a)
    before = dict(gin_conv.launches)
    out = gin_conv.fused_gin_conv(
        t["x"], t["ein"], t["We"], t["e_self"], t["W1"], t["b1"], t["W2"],
        t["b2"], t["senders"], t["receivers"], t["w"], t["nmask"], bn, be)
    np.testing.assert_array_equal(out.numpy(), _plain(t, bn, be).numpy())
    assert gin_conv.launches == before


def test_kernel_entry_points_reject_cpu_tensors(case):
    a, bn, be = case
    t = _torch(a)
    with pytest.raises(ValueError, match="CUDA"):
        gin_conv.gin_conv_fwd(
            t["x"], t["ein"], t["We"], t["e_self"], t["W1"], t["b1"],
            t["W2"], t["b2"], t["senders"], t["receivers"], t["w"],
            t["nmask"].float(), bn, be)
    with pytest.raises(ValueError, match="CUDA"):
        gin_conv.gin_conv_bwd(
            t["g"], t["x"], t["x"], t["ein"], t["W1"], t["W2"],
            t["senders"], t["receivers"], t["w"], t["nmask"].float(), bn, be)


def test_gather_scatter_matches_jax(case):
    a, _, _ = case
    N = a["x"].shape[0]
    ref = jspmm._xla(jnp.asarray(a["x"]), a["ein"] @ a["We"], a["senders"],
                     a["receivers"], a["w"] > 0, N, "add", "sum", None)
    got = tspmm.gather_scatter(
        torch.from_numpy(a["x"]), torch.from_numpy(a["senders"]),
        torch.from_numpy(a["receivers"]), torch.from_numpy(a["w"] > 0), N,
        edge_in=torch.from_numpy(a["ein"]),
        edge_kernel=torch.from_numpy(a["We"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("op", ["sum", "count", "mean"])
def test_segment_ops_match_jax(op):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(50, 7)).astype(np.float32)
    ids = rng.integers(0, 6, 50).astype(np.int32)
    mask = rng.random(50) < 0.7
    td, ti, tm = (torch.from_numpy(v) for v in (data, ids, mask))
    if op == "count":
        got = tseg.segment_count(ti, 8, tm)
        ref = jseg.segment_count(jnp.asarray(ids), 8, jnp.asarray(mask))
    else:
        got = getattr(tseg, f"segment_{op}")(td, ti, 8, tm)
        ref = getattr(jseg, f"segment_{op}")(jnp.asarray(data),
                                             jnp.asarray(ids), 8,
                                             jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["nt", "nn", "tn"])
def test_gemm_bf16_plain_matches_pallas_product(layout, out_dtype):
    """``gin_conv.gemm_bf16`` on CPU tensors (its plain version, no launch)
    against the Pallas body's product at compute_dtype bfloat16,
    ``jnp.dot`` of bfloat16 operands with float32 sums, then the bias,
    ReLU and (mask > 0) epilogue, at K1's three operand layouts (a
    transposed operand is a strided view) and ragged sizes. A bfloat16
    result may differ by one rounding step where the float32 sums differ
    in their last bit."""
    rng = np.random.default_rng(5)
    M, K, N = 37, 45, 29
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    a, b, bias, mask = f32(M, K), f32(K, N), f32(N), f32(M, N)
    bf = torch.bfloat16
    ta = (torch.from_numpy(a).to(bf) if layout[0] == "n"
          else torch.from_numpy(a.T.copy()).to(bf).t())
    tb = (torch.from_numpy(b).to(bf) if layout[1] == "n"
          else torch.from_numpy(b.T.copy()).to(bf).t())
    before = dict(gin_conv.launches)
    got = gin_conv.gemm_bf16(ta, tb, torch.from_numpy(bias),
                             torch.from_numpy(mask).to(bf), relu=True,
                             out_dtype=getattr(torch, out_dtype))
    assert gin_conv.launches == before
    assert got.dtype == getattr(torch, out_dtype)
    ref = jnp.dot(jnp.asarray(a).astype(jnp.bfloat16),
                  jnp.asarray(b).astype(jnp.bfloat16),
                  preferred_element_type=jnp.float32)
    ref = jnp.maximum(ref + bias, 0.0)
    ref = jnp.where(jnp.asarray(mask).astype(jnp.bfloat16) > 0, ref, 0.0)
    ref = np.asarray(ref.astype(getattr(jnp, out_dtype)).astype(jnp.float32))
    tol = FWD_TOL if out_dtype == "float32" else dict(rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
