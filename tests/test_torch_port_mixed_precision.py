"""The port's mixed precision against the JAX package on the CPU: the two
knobs (``models.inits.set_compute_dtype``, ``PGT_MODEL_DTYPE``;
``ops.spmm.set_compute_dtype``, ``PGT_SPMM_DTYPE``), the trunks and the
masking slices under ``bfloat16_act``, and the plain versions of K1, K2 and
K3 at ``compute_dtype=bfloat16`` against the Pallas kernels in interpret
mode at the same dtype (rows in float32 and in bfloat16).

Tolerances, each element against max(|reference|, 1):
- the plain kernels against the Pallas kernels: 1e-2. Both round at the
  same points and multiply exactly; only the order of the float32 sums
  differs, which can move a later rounding by one bfloat16 step.
- the trunks under ``bfloat16_act`` against float32: 0.15 (bfloat16 keeps
  about three decimal digits), as ``tests/test_mixed_precision.py``.
- the port against the JAX package under the same knob: 5e-2 for a trunk
  or a loss, 0.15 for a gradient, 5e-2 for a 4-step loss trajectory. On the
  CPU the JAX package runs its XLA fallback and, for the chem GIN, the
  unfused layer with its dense layers in bfloat16, where the port's fused
  layer (K1's plain version) computes its MLP in float32 and rounds the
  output once.
Sizes: 2 layers, emb 16 or 32, batches of 32 molecules or 16 ego-networks."""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.data.packing import PackedLoader, block_layout
from pretrain_gnns_tpu.data.synthetic import molecule_dataset
from pretrain_gnns_tpu.models import bio as jbio
from pretrain_gnns_tpu.models import chem as jchem
from pretrain_gnns_tpu.models import inits as jinits
from pretrain_gnns_tpu.objectives.masking import (
    BioMaskEdgeObjective as JaxBioMasking, MaskingObjective as JaxMasking,
)
from pretrain_gnns_tpu.ops import pallas_gin, pallas_spmm
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu.train.state import TrainState as JaxState
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.models import bio as tbio
from pretrain_gnns_tpu_torch.models import chem as tchem
from pretrain_gnns_tpu_torch.models import inits as tinits
from pretrain_gnns_tpu_torch.objectives import losses as tlosses
from pretrain_gnns_tpu_torch.objectives.masking import (
    BioMaskEdgeObjective, MaskingObjective,
)
from pretrain_gnns_tpu_torch.ops import blocked_spmm, edge_dot, gin_conv
from pretrain_gnns_tpu_torch.ops import spmm as tspmm
from pretrain_gnns_tpu_torch.train import optim
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain
from pretrain_gnns_tpu_torch.train.state import TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_TOL = 1e-2
BF_VS_F32 = 0.15
PORT_VS_JAX = 5e-2
GRAD_VS_JAX = 0.15
ROWS = {"f32": (torch.float32, jnp.float32),
        "bf16": (torch.bfloat16, jnp.bfloat16)}


def _err(a, ref) -> float:
    """max |a - ref| / max(|ref|, 1), element-wise, in float32."""
    a = np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
    return float((np.abs(a - ref) / np.maximum(np.abs(ref), 1.0)).max())


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


@contextlib.contextmanager
def knobs(model: str, jax_spmm: str = "float32"):
    """Both packages' model knob at ``model`` (the JAX package's kernel
    knob at ``jax_spmm``: its CPU fallback ignores it), restored after."""
    old = (tinits.get_compute_dtype(), jinits.get_compute_dtype(),
           jspmm._DTYPE)
    tinits.set_compute_dtype(model)
    jinits.set_compute_dtype(model)
    jspmm.set_compute_dtype(jax_spmm)
    try:
        yield
    finally:
        tinits.set_compute_dtype(old[0])
        jinits.set_compute_dtype(old[1])
        jspmm.set_compute_dtype(old[2])


# --- the knobs ---------------------------------------------------------------


def test_knob_defaults_and_errors():
    """The model knob defaults to float32 and the kernel knob to bfloat16,
    each as the JAX package's (read in a process without
    ``PGT_SPMM_DTYPE``, which tests/conftest.py sets to float32 for the
    JAX package's parity tests); a CPU tensor's kernels get float32
    whatever the knob; other names raise."""
    assert tinits.get_compute_dtype() == "float32"
    assert tinits.activation_dtype() == torch.float32
    assert tspmm.get_compute_dtype() == os.environ.get("PGT_SPMM_DTYPE",
                                                       "bfloat16")
    code = ("from pretrain_gnns_tpu.ops import spmm as j\n"
            "from pretrain_gnns_tpu_torch.ops import spmm as t\n"
            "print(t.get_compute_dtype(), j._DTYPE)\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PGT_SPMM_DTYPE")}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.split() == ["bfloat16",
                                                      "bfloat16"], r.stderr
    with pytest.raises(ValueError):
        tinits.set_compute_dtype("float16")
    with pytest.raises(ValueError):
        tspmm.set_compute_dtype("bfloat16_act")
    old = tspmm.get_compute_dtype()
    tspmm.set_compute_dtype("bfloat16")
    try:
        assert tspmm.kernel_dtype(torch.zeros(2)) == torch.float32
    finally:
        tspmm.set_compute_dtype(old)
    with knobs("bfloat16_act"):
        assert tinits.activation_dtype() == torch.bfloat16
        assert tinits.downcast(torch.ones(2)).dtype == torch.bfloat16
    with knobs("bfloat16"):
        assert tinits.activation_dtype() == torch.float32


def test_knobs_read_their_environment_variables():
    code = ("from pretrain_gnns_tpu_torch.models import inits\n"
            "from pretrain_gnns_tpu_torch.ops import spmm\n"
            "print(inits.get_compute_dtype(), spmm.get_compute_dtype())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    def run(**kw):
        return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env=dict(env, **kw), capture_output=True,
                              text=True, timeout=120)

    r = run(PGT_MODEL_DTYPE="bfloat16_act", PGT_SPMM_DTYPE="bfloat16")
    assert r.returncode == 0 and r.stdout.split() == ["bfloat16_act",
                                                      "bfloat16"], r.stderr
    r = run(PGT_MODEL_DTYPE="half")
    assert r.returncode != 0 and "ValueError" in r.stderr


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "bfloat16_act"])
def test_dense_follows_the_knob(mode):
    """``inits.dense``: plain float32, or input, weight and bias cast to
    bfloat16 with the result cast back (``bfloat16``) or left in bfloat16
    (``bfloat16_act``); the parameters and their gradients stay float32."""
    gen = torch.Generator().manual_seed(0)
    lin = torch.nn.Linear(8, 5)
    tinits.reset_linear_(lin, gen)
    x = torch.randn(4, 8, generator=gen)
    with knobs(mode):
        y = tinits.dense(lin, x)
    if mode == "float32":
        want = lin(x)
    else:
        bf = torch.bfloat16
        want = torch.nn.functional.linear(x.to(bf), lin.weight.to(bf),
                                          lin.bias.to(bf))
        want = want.float() if mode == "bfloat16" else want
    assert y.dtype == want.dtype and torch.equal(y, want)
    y.float().sum().backward()
    assert lin.weight.grad.dtype == torch.float32
    assert lin.weight.dtype == torch.float32


def test_masked_batch_norm_keeps_f32_statistics_on_bf16_input():
    """The masked batch norm on bfloat16 rows: statistics and running
    statistics in float32, the result in bfloat16, against the JAX
    ``MaskedBatchNorm`` on the same rows (train and eval)."""
    from pretrain_gnns_tpu.models.norm import MaskedBatchNorm as JaxNorm
    from pretrain_gnns_tpu_torch.models.norm import MaskedBatchNorm

    rng = np.random.default_rng(5)
    x = (rng.normal(size=(40, 12)) * 3 + 1).astype(np.float32)
    mask = rng.random(40) < 0.8
    xb = torch.from_numpy(x).to(torch.bfloat16)
    norm = MaskedBatchNorm(12)
    jnorm = JaxNorm(12)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    variables = jnorm.init(jax.random.PRNGKey(0), jx, jnp.asarray(mask),
                           use_running_average=False)
    jy, state = jnorm.apply(variables, jx, jnp.asarray(mask),
                            use_running_average=False,
                            mutable=["batch_stats"])
    y = norm(xb, torch.from_numpy(mask), train=True)
    assert y.dtype == torch.bfloat16 and str(jy.dtype) == "bfloat16"
    assert norm.running_mean.dtype == torch.float32
    assert _err(_np(y), jy) <= KERNEL_TOL
    stats = state["batch_stats"]
    assert _err(norm.running_mean.numpy(), stats["mean"]) <= 1e-6
    assert _err(norm.running_var.numpy(), stats["var"]) <= 1e-6
    y_eval = norm(xb, torch.from_numpy(mask), train=False)
    jy_eval = jnorm.apply({"params": variables["params"],
                           "batch_stats": stats}, jx, jnp.asarray(mask),
                          use_running_average=True)
    assert y_eval.dtype == torch.bfloat16
    assert _err(_np(y_eval), jy_eval) <= KERNEL_TOL


def test_losses_upcast_bf16_logits():
    logits = torch.tensor([[0.5, -1.0]], dtype=torch.bfloat16)
    y = torch.tensor([[1.0, -1.0]])
    out = tlosses.masked_task_bce(logits, y, torch.tensor([True]))
    assert out.dtype == torch.float32
    xent = tlosses.masked_softmax_xent(logits, torch.tensor([1]),
                                       torch.tensor([True]))
    assert xent.dtype == torch.float32


# --- the trunks --------------------------------------------------------------


def _jax_batch(p):
    return jg.PackedGraphs(
        node_feat=jnp.asarray(p.node_feat), edge_feat=jnp.asarray(p.edge_feat),
        senders=jnp.asarray(p.senders), receivers=jnp.asarray(p.receivers),
        node_graph=jnp.asarray(p.node_graph),
        node_mask=jnp.asarray(p.node_mask),
        edge_mask=jnp.asarray(p.edge_mask),
        graph_mask=jnp.asarray(p.graph_mask),
        y=None if p.y is None else jnp.asarray(p.y),
        extras={k: jnp.asarray(v) for k, v in p.extras.items()},
        block_nodes=p.block_nodes, block_edges=p.block_edges,
    )


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trunk_pair(jmodel, tmodel, batch):
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), _jax_batch(batch))
    for leaf in jax.tree_util.tree_leaves(variables["params"]):
        assert leaf.dtype == jnp.float32
    tmodel.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]),
        _np_tree(variables.get("batch_stats", {}))))
    return variables, batch.to("cpu")


@pytest.fixture(scope="module")
def chem_batch():
    graphs, _ = tsyn.molecule_dataset(16, seed=1, mean_atoms=12)
    cfg = tpretrain.PretrainConfig(num_layer=2, emb_dim=16, batch_size=16,
                                   packing="blocked", mask_edge=False)
    return next(iter(tpretrain.build_loader(cfg, graphs,
                                            torch.device("cpu"))))


@pytest.fixture(scope="module")
def bio_batch():
    graphs = tsyn.bio_dataset(8, seed=2)
    cfg = tpretrain.PretrainConfig(domain="bio", num_layer=2, emb_dim=16,
                                   batch_size=8, packing="blocked")
    return next(iter(tpretrain.build_loader(cfg, graphs,
                                            torch.device("cpu"))))


@pytest.mark.parametrize("gnn_type", ["gin", "gcn", "graphsage", "gat"])
def test_chem_trunk_bf16_close_to_f32_and_to_jax(gnn_type, chem_batch):
    """Under bfloat16_act the port's trunk is within 0.15 of its float32
    output and within 5e-2 of the JAX trunk under the same knob; its
    parameters stay float32. (Measured on this batch, the larger of the
    two: gin 7.8e-3, gcn 2.0e-3, graphsage 1.8e-3, gat 8.9e-4.)"""
    jmodel = jchem.GNN(num_layer=2, emb_dim=16, gnn_type=gnn_type)
    tmodel = tchem.GNN(num_layer=2, emb_dim=16, gnn_type=gnn_type)
    variables, tb = _trunk_pair(jmodel, tmodel, chem_batch)
    with torch.no_grad():
        h32 = tmodel(tb, train=False)
        with knobs("bfloat16_act"):
            hbf = tmodel(tb, train=False)
            jbf = jmodel.apply(variables, _jax_batch(chem_batch),
                               train=False)
    assert h32.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    assert _err(_np(hbf), _np(h32)) < BF_VS_F32
    assert _err(_np(hbf), jbf) < PORT_VS_JAX


@pytest.mark.parametrize("gnn_type", ["gin", "gcn", "graphsage", "gat"])
def test_bio_trunk_bf16_finite_and_close_to_jax(gnn_type, bio_batch):
    """The bio trunk under bfloat16_act: finite, activations in bfloat16
    (GIN's layers end in a dense layer), within 0.15 of float32 and 5e-2
    of the JAX trunk under the same knob (measured, the larger of the two:
    gin 1.2e-2, gcn 1.8e-3, graphsage 1.7e-3, gat 2.0e-3)."""
    jmodel = jbio.GNN(num_layer=2, emb_dim=16, gnn_type=gnn_type)
    tmodel = tbio.GNN(num_layer=2, emb_dim=16, gnn_type=gnn_type)
    variables, tb = _trunk_pair(jmodel, tmodel, bio_batch)
    with torch.no_grad():
        h32 = tmodel(tb, train=False)
        with knobs("bfloat16_act"):
            hbf = tmodel(tb, train=False)
            jbf = jmodel.apply(variables, _jax_batch(bio_batch),
                               train=False)
    assert np.isfinite(_np(hbf)).all()
    if gnn_type == "gin":
        assert hbf.dtype == torch.bfloat16
    assert str(hbf.dtype) == f"torch.{jbf.dtype}", (hbf.dtype, jbf.dtype)
    assert _err(_np(hbf), _np(h32)) < BF_VS_F32
    assert _err(_np(hbf), jbf) < PORT_VS_JAX


def test_train_step_bf16_grads_and_adam_state_f32(chem_batch):
    """One train step under bfloat16_act: a finite float32 loss, float32
    gradients, parameters, batch-norm statistics and Adam moments."""
    with knobs("bfloat16_act"):
        model = MaskingObjective(num_layer=2, emb_dim=16, mask_edge=False)
        tinits.init_parameters(model, torch.Generator().manual_seed(0))
        state = TrainState(model, optim.adam(model.parameters(), lr=1e-3))
        loss, _ = tpretrain.train_step(state, chem_batch.to("cpu"))
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    for b in model.buffers():
        assert b.dtype in (torch.float32, torch.long)
    moments = [v for s in state.optimizer.state.values() for v in s.values()
               if torch.is_tensor(v) and v.is_floating_point()]
    assert moments and all(m.dtype == torch.float32 for m in moments)


# --- the plain kernels against the Pallas kernels at bfloat16 ----------------


@pytest.fixture(scope="module")
def k1_case():
    """A blocked chem batch (blocks 64/192) and K1 inputs from a seed."""
    graphs, _ = molecule_dataset(32, num_tasks=1, seed=0, mean_atoms=20)
    blocks = block_layout(graphs, 32, block_nodes=64, block_edges=192)
    b = next(iter(PackedLoader(graphs, 32, shuffle=False, blocks=blocks)))
    rng = np.random.default_rng(0)
    N, F = b.node_feat.shape[0], 32
    ef = np.asarray(b.edge_feat)
    ein = np.concatenate([np.eye(6, dtype=np.float32)[ef[:, 0]],
                          np.eye(3, dtype=np.float32)[ef[:, 1]]], axis=1)
    nm = np.asarray(b.node_mask)
    f32 = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(
        np.float32)
    a = dict(x=f32(N, F) * nm[:, None], We=f32(9, F), e_self=f32(F),
             W1=f32(F, 2 * F, scale=F ** -0.5), b1=f32(2 * F),
             W2=f32(2 * F, F, scale=(2 * F) ** -0.5), b2=f32(F), ein=ein,
             senders=np.asarray(b.senders), receivers=np.asarray(b.receivers),
             w=np.asarray(b.edge_mask).astype(np.float32), nmask=nm,
             g=f32(N, F))
    return a, blocks[1], blocks[2]


K1_DIFF = ("x", "We", "e_self", "W1", "b1", "W2", "b2")


@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_k1_plain_bf16_matches_pallas(k1_case, rows):
    """K1's plain version at compute_dtype=bfloat16 against
    pallas_gin.fused_gin_conv at jnp.bfloat16 in interpret mode: out and
    the seven gradients (measured: at most 2.7e-5 of max(|ref|, 1))."""
    a, bn, be = k1_case
    tdt, jdt = ROWS[rows]

    def f(x, We, e_self, W1, b1, W2, b2):
        return pallas_gin.fused_gin_conv(
            x, a["ein"], We, e_self, W1, b1, W2, b2, a["senders"],
            a["receivers"], a["w"], a["nmask"], bn, be, jnp.bfloat16, True)

    args = [jnp.asarray(a["x"]).astype(jdt)] + [jnp.asarray(a[k])
                                                for k in K1_DIFF[1:]]
    out_j, vjp = jax.vjp(f, *args)
    grads_j = vjp(jnp.asarray(a["g"]).astype(out_j.dtype))
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    leaves = [t["x"].to(tdt).requires_grad_(True)] + [
        t[k].requires_grad_(True) for k in K1_DIFF[1:]]
    out_t = gin_conv.fused_gin_conv_plain(
        leaves[0], t["ein"], *leaves[1:], t["senders"], t["receivers"],
        t["w"], t["nmask"], bn, be, compute_dtype=torch.bfloat16)
    grads_t = torch.autograd.grad(out_t, leaves, t["g"].to(out_t.dtype))
    assert out_t.dtype == tdt and str(out_j.dtype) == str(jdt.dtype)
    assert _err(_np(out_t), out_j) <= KERNEL_TOL
    for name, gt, gj in zip(K1_DIFF, grads_t, grads_j):
        assert _err(_np(gt), gj) <= KERNEL_TOL, name


@pytest.fixture(scope="module")
def k2_case():
    """A blocked bio-like batch: K = 10 edge inputs, fractional, partly
    negative (GCN-like) edge weights, x and a cotangent from a seed."""
    graphs = tsyn.bio_dataset(16, seed=3)
    cfg = tpretrain.PretrainConfig(domain="bio", num_layer=2, emb_dim=32,
                                   batch_size=16, packing="blocked")
    b = next(iter(tpretrain.build_loader(cfg, graphs,
                                         torch.device("cpu")))).to("cpu")
    rng = np.random.default_rng(1)
    N, E, F = b.max_nodes, b.max_edges, 32
    nm = b.node_mask.numpy()
    a = dict(x=(rng.normal(size=(N, F)) * nm[:, None]).astype(np.float32),
             ein=tbio.edge_inputs(b, torch.float32).numpy(),
             W=rng.normal(size=(10, F)).astype(np.float32),
             w=(b.edge_mask.numpy() * rng.uniform(-0.5, 1.5, E)).astype(
                 np.float32),
             senders=b.senders.numpy(), receivers=b.receivers.numpy(),
             g=rng.normal(size=(N, F)).astype(np.float32))
    return a, b.block_nodes, b.block_edges


@pytest.mark.parametrize("rows", ["f32", "bf16"])
@pytest.mark.parametrize("has_x,has_ein", [(True, True), (True, False),
                                           (False, True)])
def test_k2_plain_bf16_matches_pallas(k2_case, rows, has_x, has_ein):
    """K2's plain version at compute_dtype=bfloat16 against
    pallas_spmm.blocked_spmm_fused at jnp.bfloat16 in interpret mode, every
    variant: out, dx and dW (measured: at most 9.6e-7 of max(|ref|, 1))."""
    a, bn, be = k2_case
    tdt, jdt = ROWS[rows]

    def f(x, W):
        return pallas_spmm.blocked_spmm_fused(
            x, a["ein"], W, a["senders"], a["receivers"], a["w"], bn, be,
            jnp.bfloat16, True, has_x, has_ein)

    x_j = jnp.asarray(a["x"]).astype(jdt)
    out_j, vjp = jax.vjp(f, x_j, jnp.asarray(a["W"]))
    dx_j, dW_j = vjp(jnp.asarray(a["g"]).astype(out_j.dtype))
    x = torch.from_numpy(a["x"]).to(tdt).requires_grad_(True)
    W = torch.from_numpy(a["W"]).requires_grad_(True)
    out_t = blocked_spmm.blocked_spmm_fused_plain(
        x, torch.from_numpy(a["ein"]), W, torch.from_numpy(a["senders"]),
        torch.from_numpy(a["receivers"]), torch.from_numpy(a["w"]), bn, be,
        has_x, has_ein, compute_dtype=torch.bfloat16)
    dx_t, dW_t = torch.autograd.grad(
        out_t, [x, W], torch.from_numpy(a["g"]).to(out_t.dtype),
        allow_unused=True)
    assert out_t.dtype == tdt
    assert _err(_np(out_t), out_j) <= KERNEL_TOL
    if has_x:
        assert dx_t.dtype == tdt
        assert _err(_np(dx_t), dx_j) <= KERNEL_TOL
    if has_ein:
        assert dW_t.dtype == torch.float32
        assert _err(_np(dW_t), dW_j) <= KERNEL_TOL


@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_k3_plain_bf16_matches_pallas(k2_case, rows):
    """K3's plain version at compute_dtype=bfloat16 against
    pallas_spmm.blocked_edge_dot at jnp.bfloat16 in interpret mode, on the
    edge slots as pairs with fractional weights: float32 scores and dx
    (measured: at most 7.5e-7 of max(|ref|, 1))."""
    a, bn, be = k2_case
    tdt, jdt = ROWS[rows]
    rng = np.random.default_rng(2)
    g = rng.normal(size=a["w"].shape[0]).astype(np.float32)

    def f(x):
        return pallas_spmm.blocked_edge_dot(
            x, a["receivers"], a["senders"], a["w"], bn, be, jnp.bfloat16,
            True)

    out_j, vjp = jax.vjp(f, jnp.asarray(a["x"]).astype(jdt))
    (dx_j,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(a["x"]).to(tdt).requires_grad_(True)
    out_t = edge_dot.blocked_edge_dot(
        x, torch.from_numpy(a["receivers"]), torch.from_numpy(a["senders"]),
        torch.from_numpy(a["w"]), bn, be, torch.bfloat16)
    (dx_t,) = torch.autograd.grad(out_t, [x], torch.from_numpy(g))
    assert out_t.dtype == torch.float32 and dx_t.dtype == tdt
    assert _err(_np(out_t), out_j) <= KERNEL_TOL
    assert _err(_np(dx_t), dx_j) <= KERNEL_TOL


# --- the masking slices under bfloat16_act -----------------------------------


def _slice(domain):
    if domain == "chem":
        graphs, _ = tsyn.molecule_dataset(64, seed=3, mean_atoms=20)
        cfg = tpretrain.PretrainConfig(num_layer=2, emb_dim=32,
                                       batch_size=32, mask_edge=True,
                                       packing="blocked", seed=0)
        jm = JaxMasking(num_layer=2, emb_dim=32, mask_edge=True)
        tm = MaskingObjective(num_layer=2, emb_dim=32, mask_edge=True)
    else:
        graphs = tsyn.bio_dataset(32, seed=3)
        cfg = tpretrain.PretrainConfig(domain="bio", num_layer=2,
                                       emb_dim=32, batch_size=16,
                                       packing="blocked", seed=0)
        jm = JaxBioMasking(num_layer=2, emb_dim=32)
        tm = BioMaskEdgeObjective(num_layer=2, emb_dim=32)
    batches = list(tpretrain.build_loader(cfg, graphs, torch.device("cpu")))
    init = jax.jit(lambda p, m, b: jm.init({"params": p, "mask": m}, b,
                                           train=False))
    variables = init(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                     _jax_batch(batches[0]))
    tm.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])))
    return jm, variables, tm, batches


@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_masking_step_and_trajectory_bf16_match_jax(domain):
    """Masking GIN at 2 x 32 under bfloat16_act, the same parameters and
    batches in both packages: one step's loss within 5e-2 and gradients
    within 0.15 of max(|ref|, 1), then four Adam steps whose losses agree
    within 5e-2 (measured: loss under 1e-4, gradients 3.6e-2 chem and
    5.9e-3 bio, trajectory 1e-3)."""
    jm, variables, tm, batches = _slice(domain)
    with knobs("bfloat16_act"):
        def loss_fn(params):
            (loss, _), mutated = jm.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                _jax_batch(batches[0]), train=True, mutable=["batch_stats"])
            return loss, mutated

        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
        tloss, _ = tm(batches[0].to("cpu"), train=True)
        tloss.backward()
        assert tloss.dtype == torch.float32
        assert _err(float(tloss.detach()), float(jloss)) < PORT_VS_JAX
        ref = state_dict_from_jax(_np_tree(jgrads),
                                  _np_tree(variables["batch_stats"]))
        worst = max(_err(_np(p.grad), ref[n].numpy())
                    for n, p in tm.named_parameters())
        assert worst < GRAD_VS_JAX, worst

        tm.load_state_dict(state_dict_from_jax(
            _np_tree(variables["params"]),
            _np_tree(variables["batch_stats"])))
        tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
        jstate = JaxState.create(dict(variables), tx, jax.random.PRNGKey(2))
        jstep = jpretrain.make_pretrain_step(jm, tx)
        tstate = TrainState(tm, optim.adam(tm.parameters(), lr=1e-3))
        jl, tl = [], []
        for s in range(4):
            b = batches[s % len(batches)]
            jstate, loss, _ = jstep(jstate, _jax_batch(b))
            jl.append(float(loss))
            loss, _ = tpretrain.train_step(tstate, b.to("cpu"))
            tl.append(float(loss))
    assert len(set(np.round(tl, 5))) > 1  # the trajectory moved
    assert _err(tl, jl) < PORT_VS_JAX, (tl, jl)
