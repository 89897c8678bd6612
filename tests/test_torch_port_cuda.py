"""The port's CUDA kernels against its plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports only torch, numpy and the port, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest`` keeps the JAX package's tests/conftest.py out.)"""

import numpy as np
import pytest
import torch

from pretrain_gnns_tpu_torch.data.packing import PackedLoader, block_layout
from pretrain_gnns_tpu_torch.data.synthetic import molecule_dataset
from pretrain_gnns_tpu_torch.ops import gin_conv
from pretrain_gnns_tpu_torch.train import pretrain

# max |kernel - plain| / max(1, max |plain|): full f32 on both sides, only
# the summation order differs (tiled GEMMs vs cuBLAS, atomics)
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
DIFF = ("x", "We", "e_self", "W1", "b1", "W2", "b2")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gin_conv kernels run only "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _case(dev, F, block_nodes, block_edges, n_graphs=32, seed=0):
    graphs, _ = molecule_dataset(n_graphs, seed=seed, mean_atoms=20)
    blocks = block_layout(graphs, n_graphs, block_nodes, block_edges)
    b = next(iter(PackedLoader(graphs, n_graphs, shuffle=False,
                               blocks=blocks))).to(dev)
    gen = torch.Generator().manual_seed(seed)
    N, F2 = b.max_nodes, 2 * F
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    nm = b.node_mask.float()
    ein = torch.cat([torch.nn.functional.one_hot(b.edge_feat[:, 0], 6),
                     torch.nn.functional.one_hot(b.edge_feat[:, 1], 3)],
                    1).float()
    t = dict(x=r(N, F) * nm[:, None], We=r(9, F), e_self=r(F),
             # W1 as a transposed view, as the trunk passes it
             W1=r(F2, F, scale=F ** -0.5).t(), b1=r(F2),
             W2=r(F2, F, scale=F2 ** -0.5), b2=r(F), g=r(N, F))
    return t, ein, b, nm, blocks


@pytest.mark.cuda
@pytest.mark.parametrize("F,bn,be", [(32, 64, 192), (45, 128, 384)])
def test_kernels_match_plain_version(cuda_device, F, bn, be):
    t, ein, b, nm, blocks = _case(cuda_device, F, bn, be)
    args = (t["x"], ein, t["We"], t["e_self"], t["W1"], t["b1"], t["W2"],
            t["b2"], b.senders, b.receivers, b.edge_mask.float(), nm,
            blocks[1], blocks[2])
    before = dict(gin_conv.launches)
    out, aggr, z = gin_conv.gin_conv_fwd(*args)
    grads = gin_conv.gin_conv_bwd(t["g"], aggr, z, ein, t["W1"], t["W2"],
                                  b.senders, b.receivers, args[10], nm,
                                  blocks[1], blocks[2])
    torch.cuda.synchronize()
    assert gin_conv.launches["gin_conv_fwd"] == before["gin_conv_fwd"] + 1
    assert gin_conv.launches["gin_conv_bwd"] == before["gin_conv_bwd"] + 1
    leaves = [t[k].detach().clone().requires_grad_(True) for k in DIFF]
    out_p, aggr_p, z_p = gin_conv.fused_gin_conv_plain(
        leaves[0], ein, *leaves[1:], *args[8:], return_residuals=True)
    grads_p = torch.autograd.grad(out_p, leaves, t["g"])
    for name, x, y in (("out", out, out_p), ("aggr", aggr, aggr_p),
                       ("z", z, z_p)):
        assert _rel(x, y.detach()) <= FWD_TOL, name
    for name, x, y in zip(DIFF, grads, grads_p):
        assert _rel(x, y) <= GRAD_TOL, name


@pytest.mark.cuda
def test_autograd_function_matches_plain_version(cuda_device):
    t, ein, b, nm, blocks = _case(cuda_device, 40, 64, 192, seed=1)
    rest = (b.senders, b.receivers, b.edge_mask.float(), b.node_mask,
            blocks[1], blocks[2])
    results = []
    for fn in (gin_conv.fused_gin_conv, gin_conv.fused_gin_conv_plain):
        leaves = [t[k].detach().clone().requires_grad_(True) for k in DIFF]
        out = fn(leaves[0], ein, *leaves[1:], *rest)
        (out * t["g"]).sum().backward()
        results.append([out.detach()] + [p.grad for p in leaves])
    for x, y in zip(*results):
        assert _rel(x, y) <= GRAD_TOL


@pytest.mark.cuda
def test_masking_step_on_card_matches_cpu(cuda_device):
    """One train-mode step of a small masking model: card vs CPU."""
    graphs, _ = molecule_dataset(64, seed=2)
    cfg = pretrain.PretrainConfig(num_layer=3, emb_dim=48, batch_size=32,
                                  mask_edge=True, packing="blocked")
    batch = next(iter(pretrain.build_loader(cfg, graphs, cuda_device)))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = pretrain.build_objective(cfg).to(dev)
        loss, _ = model(batch.to(dev), train=True)
        loss.backward()
        out[dev.type] = (float(loss.detach()),
                         {n: p.grad.cpu() for n, p in
                          model.named_parameters()})
    assert np.isclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for n, gc in out["cuda"][1].items():
        assert _rel(gc, out["cpu"][1][n]) <= 1e-3, n
