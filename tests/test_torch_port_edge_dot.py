"""The port's blocked pair-dot scoring head (pretrain_gnns_tpu_torch/ops/
edge_dot.py, K3) and the dispatch of ops/spmm.edge_dot against the JAX
package on the same inputs, made with numpy from a seed.

On the CPU the port runs K3's plain PyTorch version; the JAX side runs the
Pallas kernel in interpret mode (pallas_spmm.blocked_edge_dot(...,
float32, interpret=True)) and the XLA take path of spmm.edge_dot.
Tolerances: rtol 1e-5 / atol 1e-6 forward, rtol 1e-4 / atol 1e-6 on dx
(float32 on both sides; only the summation order differs). The CUDA
kernels are held against the plain version in
tests/test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.ops import pallas_spmm
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu_torch.core.graphs import pack_graphs_blocked
from pretrain_gnns_tpu_torch.data.synthetic import molecule_dataset
from pretrain_gnns_tpu_torch.ops import edge_dot
from pretrain_gnns_tpu_torch.ops import spmm as tspmm

BN, BE, F = 32, 96, 20
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
DX_TOL = dict(rtol=1e-4, atol=1e-6)
LAYOUTS = ["edges", "half"]  # pairs_per_block = BE (positives), BE // 2
REFS = ["pallas_interpret", "xla"]


@pytest.fixture(scope="module")
def batch():
    """A blocked batch: 8 blocks of 32 nodes / 96 edge slots, the last
    blocks all padding."""
    graphs, _ = molecule_dataset(8, seed=7, mean_atoms=10)
    p = pack_graphs_blocked(graphs, 8, BN, BE, max_graphs=8)
    used = p.edge_mask.reshape(8, BE).any(axis=1)
    assert used[:2].all() and not used[-1]
    return p


def _case(p, layout):
    """Pair lists drawn from a seed. "edges": every edge slot, padded
    slots with index 0 and weight 0, as the positive head gets them.
    "half": BE // 2 slots a block holding random in-block pairs and
    padding, as the negative head gets them."""
    rng = np.random.default_rng(0)
    N = p.max_nodes
    if layout == "edges":
        a, b, w = p.receivers, p.senders, p.edge_mask.astype(np.float32)
        ppb = BE
    else:
        ppb = BE // 2
        n_blocks = N // BN
        base = np.repeat(np.arange(n_blocks) * BN, ppb)
        a = base + rng.integers(0, BN, n_blocks * ppb)
        b = base + rng.integers(0, BN, n_blocks * ppb)
        keep = (rng.random(n_blocks * ppb) < 0.6) & (a != b)
        keep[-ppb:] = False  # the last block holds no pair
        a = np.where(keep, a, 0).astype(np.int32)
        b = np.where(keep, b, 0).astype(np.int32)
        w = keep.astype(np.float32)
    assert (w == 0).any() and (w != 0).any()
    x = rng.normal(size=(N, F)).astype(np.float32)
    g = rng.normal(size=a.shape[0]).astype(np.float32)
    return dict(x=x, a=a.astype(np.int32), b=b.astype(np.int32), w=w, g=g,
                ppb=ppb)


def _jax_k3(c, ref):
    """(scores, dx) of the JAX function on ``c``."""
    a, b, w = (jnp.asarray(c[k]) for k in ("a", "b", "w"))

    def f(x):
        if ref == "pallas_interpret":
            return pallas_spmm.blocked_edge_dot(x, a, b, w, BN, c["ppb"],
                                                jnp.float32, True)
        return jspmm.edge_dot(x, a, b, w != 0)  # unblocked: the take path

    out, vjp = jax.vjp(f, jnp.asarray(c["x"]))
    (dx,) = vjp(jnp.asarray(c["g"]))
    return np.asarray(out), np.asarray(dx)


def _torch_k3(c, fn=edge_dot.edge_dot_plain):
    """(scores, dx) of a port function on ``c`` (CPU tensors)."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()
         if k != "ppb"}
    x = t["x"].requires_grad_(True)
    out = fn(x, t["a"], t["b"], t["w"], BN, c["ppb"])
    (dx,) = torch.autograd.grad(out, [x], t["g"])
    return out.detach().numpy(), dx.numpy()


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_matches_jax(batch, layout, ref):
    c = _case(batch, layout)
    out_j, dx_j = _jax_k3(c, ref)
    out_t, dx_t = _torch_k3(c)
    np.testing.assert_allclose(out_t, out_j, **FWD_TOL)
    np.testing.assert_allclose(dx_t, dx_j, err_msg="dx", **DX_TOL)
    assert not np.any(out_t[c["w"] == 0])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_padded_pairs_and_rows_give_zero(batch, layout):
    """Padded pairs score 0 and add nothing to dx: rows that no valid
    pair touches, the all-padding block among them, get a zero
    gradient."""
    c = _case(batch, layout)
    out, dx = _torch_k3(c)
    valid = c["w"] != 0
    touched = np.zeros(batch.max_nodes, bool)
    touched[c["a"][valid]] = True
    touched[c["b"][valid]] = True
    assert not touched[-BN:].any()
    assert not np.any(out[~valid]) and not np.any(dx[~touched])
    assert np.any(dx[touched])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_wrapper_runs_plain_version_on_cpu(batch, layout):
    c = _case(batch, layout)
    before = dict(edge_dot.launches)
    got = _torch_k3(c, edge_dot.blocked_edge_dot)
    want = _torch_k3(c)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert edge_dot.launches == before
    assert sorted(before) == ["blocked_edge_dot_bwd", "blocked_edge_dot_fwd"]


def test_kernel_entry_points_reject_cpu_tensors(batch):
    c = _case(batch, "edges")
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()
         if k != "ppb"}
    with pytest.raises(ValueError, match="CUDA"):
        edge_dot.edot_fwd(t["x"], t["a"], t["b"], t["w"], BN, BE)
    with pytest.raises(ValueError, match="CUDA"):
        edge_dot.edot_bwd(t["g"], t["x"], t["a"], t["b"], t["w"], BN, BE)


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


@pytest.mark.parametrize("layout", LAYOUTS)
def test_edge_dot_matches_jax_dispatch(batch, jax_pallas_f32, layout):
    """The CPU dispatch (plain path) against JAX ``spmm.edge_dot`` on a
    blocked pair list, which routes to the Pallas K3; the positive head's
    ``[::2]`` slice included, whose backward hands K3 a cotangent that is
    0 on the odd slots."""
    c = _case(batch, layout)
    mask = c["w"] != 0

    def jf(x):
        s = jspmm.edge_dot(x, jnp.asarray(c["a"]), jnp.asarray(c["b"]),
                           jnp.asarray(mask), BN, c["ppb"])
        return jnp.sum(s[::2] * jnp.asarray(c["g"][::2]))

    jval, jdx = jax.value_and_grad(jf)(jnp.asarray(c["x"]))
    x = torch.from_numpy(c["x"].copy()).requires_grad_(True)
    s = tspmm.edge_dot(x, torch.from_numpy(c["a"]), torch.from_numpy(c["b"]),
                       torch.from_numpy(mask), BN, c["ppb"])
    val = (s[::2] * torch.from_numpy(c["g"][::2])).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), **DX_TOL)
