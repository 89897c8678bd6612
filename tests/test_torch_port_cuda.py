"""The port's CUDA kernels against its plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports only torch, numpy and the port, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest`` keeps the JAX package's tests/conftest.py out.)"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from pretrain_gnns_tpu_torch.data.batch_transforms import NativeNegativeEdge
from pretrain_gnns_tpu_torch.data.packing import PackedLoader, block_layout
from pretrain_gnns_tpu_torch.data.synthetic import (
    bio_dataset, molecule_dataset,
)
from pretrain_gnns_tpu_torch.models import bio, chem
from pretrain_gnns_tpu_torch.ops import (
    _build, attention, blocked_spmm, edge_dot, gat_conv, gin_conv,
    sorted_spmm, spmm,
)
from pretrain_gnns_tpu_torch.train import pretrain

# max |kernel - plain| / max(1, max |plain|): full f32 on both sides, only
# the summation order differs (tiled GEMMs vs cuBLAS, rows summed in slot
# order vs index_add_)
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
DIFF = ("x", "We", "e_self", "W1", "b1", "W2", "b2")


@pytest.fixture
def cuda_device():
    """The card, with the kernels' knob (ops.spmm, bfloat16 by default)
    pinned at float32 for the test, which passes a bfloat16 compute dtype
    where it wants one, and restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gin_conv, blocked_spmm, "
                    "edge_dot and gat kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    old = spmm.get_compute_dtype()
    spmm.set_compute_dtype("float32")
    yield torch.device("cuda")
    spmm.set_compute_dtype(old)


def _packed_cfg(**kw):
    """A config of the host-packed pipeline, ``device_dataset`` "off"
    unless given: on CUDA "auto" keeps the dataset on the card, and the
    tests written for batches packed on the host keep to them."""
    return pretrain.PretrainConfig(**{"device_dataset": "off", **kw})


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
@pytest.mark.parametrize("F,K", [(300, 9), (33, 1), (33, 16), (300, 16)])
def test_k1_is_bit_repeatable(cuda_device, F, K):
    """K1 forward and backward, twice on the same inputs: out, aggr, z and
    all seven gradients equal bit for bit (no atomics), and within the
    tolerances of the plain version. Edge inputs of width K drawn at
    random (K = 9: the bond one-hots), fractional edge weights, and the
    first block left without a valid edge."""
    t, ein, b, nm, blocks = _case(cuda_device, F, 128, 384, seed=F + K)
    gen = torch.Generator().manual_seed(K)
    E = b.senders.shape[0]
    if K != 9:
        ein = torch.randn(E, K, generator=gen).to(cuda_device)
    We = torch.randn(K, F, generator=gen).to(cuda_device)
    w = b.edge_mask.float() * (0.5 + torch.rand(E, generator=gen)).to(
        cuda_device)
    w[:blocks[2]] = 0  # block 0: no valid edge
    args = (t["x"], ein, We, t["e_self"], t["W1"], t["b1"], t["W2"],
            t["b2"], b.senders, b.receivers, w, nm, blocks[1], blocks[2])
    runs = []
    for _ in range(2):
        out, aggr, z = gin_conv.gin_conv_fwd(*args)
        grads = gin_conv.gin_conv_bwd(t["g"], aggr, z, ein, t["W1"], t["W2"],
                                      b.senders, b.receivers, w, nm,
                                      blocks[1], blocks[2])
        runs.append((out, aggr, z) + grads)
    torch.cuda.synchronize()
    names = ("out", "aggr", "z", "dx", "dWe", "de_self", "dW1", "db1", "dW2",
             "db2")
    for name, a, c in zip(names, *runs):
        assert torch.equal(a, c), name
    t = dict(t, We=We)
    leaves = [t[k].detach().clone().requires_grad_(True) for k in DIFF]
    plain = gin_conv.fused_gin_conv_plain(leaves[0], ein, *leaves[1:],
                                          *args[8:], return_residuals=True)
    grads_p = torch.autograd.grad(plain[0], leaves, t["g"])
    for name, x, y in zip(names, runs[0], plain + grads_p):
        assert _rel(x, y.detach()) <= (FWD_TOL if name in names[:3]
                                       else GRAD_TOL), name
    # block 0 aggregates its self term only
    rows = slice(0, blocks[1])
    want = (t["x"][rows] + t["e_self"]) * nm[rows, None]
    assert _rel(runs[0][1][rows], want) <= FWD_TOL


# gemm.cuh's tensor-core GEMM (gemm_bf16) against torch.matmul on float32
# copies of its bfloat16 operands, max |diff| / max(1, max |ref|): every
# product of two bfloat16 values is exact in float32, so only the order of
# the float32 sums differs, as for the float32 GEMM. The control, the same
# reference with ``a`` left unrounded, must read over the limit.
BF16_GEMM_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,K,layout,splits", [
    (8192, 600, 300, "nt", 1),   # K1's first forward product
    (8192, 300, 600, "nt", 1),   # its second
    (8192, 600, 300, "nn", 1),   # g @ W2^T
    (600, 300, 8192, "tn", 11),  # dW2 = z^T g, split K
    (300, 600, 8192, "tn", 18),  # dW1 = aggr^T dzr
    (8192, 300, 600, "nn", 1),   # da = dzr @ W1^T
    (8100, 600, 300, "nt", 1),   # a ragged M at K1's widths
    (257, 129, 45, "nn", 1), (257, 129, 45, "tt", 1), (100, 70, 301, "tn", 3),
    (33, 600, 17, "nt", 1), (130, 300, 520, "tt", 2),
])
def test_gemm_matches_matmul(cuda_device, M, N, K, layout, splits, dtype):
    """The GEMMs of gemm.cuh alone against torch.matmul: the float32 GEMM
    in full float32, the tensor-core GEMM on bfloat16 operands (float32
    copies in the reference, and a control that must fail); plain and
    transposed operands (a transposed one is a strided view), M, N and K
    no multiples of the tiles, split K, the epilogue, and the same bits on
    a second run."""
    gen = torch.Generator().manual_seed(M + N + K)
    r = lambda *s: torch.randn(*s, generator=gen).to(cuda_device)
    a = r(M, K) if layout[0] == "n" else r(K, M).t()
    b = r(K, N) if layout[1] == "n" else r(N, K).t()
    bias, pos = r(N), r(M, N)
    if dtype == "bfloat16":
        _check_gemm_bf16(a, b, bias, pos, splits)
        return
    before = gin_conv.launches["gemm"]
    got = gin_conv.gemm(a, b, splits=splits)
    got_epi = gin_conv.gemm(a, b, bias, pos, relu=True, splits=splits)
    again = gin_conv.gemm(a, b, bias, pos, relu=True, splits=splits)
    torch.cuda.synchronize()
    assert gin_conv.launches["gemm"] == before + 3
    assert _rel(got, torch.matmul(a, b)) <= FWD_TOL
    want = gin_conv.gemm_plain(a.double(), b.double(), bias.double(),
                               pos.double(), relu=True)
    assert _rel(got_epi, want.float()) <= FWD_TOL
    assert torch.equal(got_epi, again)
    assert not got_epi[pos <= 0].any()


def _check_gemm_bf16(a32, b32, bias, pos, splits):
    """``test_gemm_matches_matmul`` for gemm_bf16: operands rounded to
    bfloat16 in their layouts; with one split also the bfloat16 mask, the
    bfloat16 result, which must be the float32 result rounded, and the
    roundings near a tie (``ordered_ties``): against the float32 GEMM's
    k-ordered FMA chain on the same values, rounded to bfloat16, they may
    disagree no more often than without."""
    # .to keeps a transposed view's strides (preserve_format)
    a, b = a32.to(torch.bfloat16), b32.to(torch.bfloat16)
    assert a.stride() == a32.stride() and b.stride() == b32.stride()
    pm = pos.to(torch.bfloat16) if splits == 1 else None
    before = gin_conv.launches["gemm_bf16"]
    got = gin_conv.gemm_bf16(a, b, splits=splits, ordered_ties=False)
    epi = gin_conv.gemm_bf16(a, b, bias, pm, relu=True, splits=splits)
    again = gin_conv.gemm_bf16(a, b, bias, pm, relu=True, splits=splits)
    calls = 3
    if splits == 1:
        epi16 = gin_conv.gemm_bf16(a, b, bias, pm, relu=True,
                                   out_dtype=torch.bfloat16)
        loose16 = gin_conv.gemm_bf16(a, b, bias, pm, relu=True,
                                     out_dtype=torch.bfloat16,
                                     ordered_ties=False)
        chain16 = gin_conv.gemm(a.float(), b.float(), bias, pm.float(),
                                relu=True).to(torch.bfloat16)
        calls += 2
    torch.cuda.synchronize()
    assert gin_conv.launches["gemm_bf16"] == before + calls
    sound = _rel(got, torch.matmul(a.float(), b.float()))
    control = _rel(got, torch.matmul(a32, b.float()))
    print(f"[gemm_bf16] {tuple(a.shape)} x {tuple(b.shape)} splits {splits}"
          f": sound {sound:.2e}, control {control:.2e}")
    assert sound <= BF16_GEMM_TOL and control > BF16_GEMM_TOL
    want = gin_conv.gemm_plain(a.double(), b.double(), bias.double(),
                               None if pm is None else pm.double(),
                               relu=True)
    assert _rel(epi, want.float()) <= BF16_GEMM_TOL
    assert torch.equal(epi, again)
    if splits == 1:
        assert not epi[pm <= 0].any()
        assert torch.equal(epi16, epi.to(torch.bfloat16))
        flips = int((epi16 != chain16).sum()), int((loose16 != chain16).sum())
        print(f"[gemm_bf16] roundings unlike the ordered chain's: "
              f"{flips[0]} with ordered_ties, {flips[1]} without, of "
              f"{epi16.numel()}")
        assert flips[0] <= flips[1]


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
    cfg = _packed_cfg(num_layer=3, emb_dim=48, batch_size=32,
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


@pytest.mark.cuda
def test_unfused_gin_masking_step_on_card_matches_cpu(cuda_device):
    """Under ``gin_conv.set_fused("off")`` the chem GIN trunk runs K2's
    ``[x+ein]`` variant (once a layer each way) and no K1: one train-mode
    step on the card against the CPU."""
    graphs, _ = molecule_dataset(64, seed=2)
    cfg = _packed_cfg(num_layer=3, emb_dim=48, batch_size=32,
                                  mask_edge=True, packing="blocked")
    batch = next(iter(pretrain.build_loader(cfg, graphs, cuda_device)))
    out = {}
    gin_conv.set_fused("off")
    try:
        for dev in (cuda_device, torch.device("cpu")):
            model = pretrain.build_objective(cfg).to(dev)
            gin_conv.reset_launches()
            blocked_spmm.reset_launches()
            loss, _ = model(batch.to(dev), train=True)
            loss.backward()
            out[dev.type] = (float(loss.detach()),
                             {n: p.grad.cpu() for n, p in
                              model.named_parameters()},
                             dict(gin_conv.launches),
                             dict(blocked_spmm.launches))
    finally:
        gin_conv.set_fused("on")
    assert not any(out["cuda"][2].values())
    moved = {k: v for k, v in out["cuda"][3].items() if v}
    assert moved == {"blocked_spmm_fwd[x+ein]": 3,
                     "blocked_spmm_bwd[x+ein]": 3}
    assert np.isclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for n, gc in out["cuda"][1].items():
        assert _rel(gc, out["cpu"][1][n]) <= 1e-3, n


K2_VARIANTS = [(True, True), (True, False), (False, True)]


def _k2_case(dev, F, block_nodes, block_edges, n_graphs=24, seed=0):
    """A blocked bio batch and K2 inputs: x, ein = [edge_feat | 1], W,
    signed edge weights (0 on padded slots) and a cotangent g."""
    graphs = bio_dataset(n_graphs, seed=seed)
    blocks = block_layout(graphs, n_graphs, block_nodes, block_edges)
    b = next(iter(PackedLoader(graphs, n_graphs, shuffle=False,
                               blocks=blocks,
                               extra_pad={"center_node_idx": n_graphs})))
    b = b.to(dev)
    gen = torch.Generator().manual_seed(seed)
    N, E = b.max_nodes, b.max_edges
    r = lambda *s: torch.randn(*s, generator=gen).to(dev)
    nm = b.node_mask.float()
    w = b.edge_mask.float() * (torch.rand(E, generator=gen) * 2 - 0.5).to(dev)
    t = dict(x=r(N, F) * nm[:, None], ein=bio.edge_inputs(b, torch.float32),
             W=r(bio.EDGE_FEAT_DIM + 1, F), w=w, g=r(N, F))
    return t, b, blocks


def _k2_plain(t, b, blocks, has_x, has_ein):
    x = t["x"].detach().clone().requires_grad_(True)
    W = t["W"].detach().clone().requires_grad_(True)
    out = blocked_spmm.blocked_spmm_fused_plain(
        x, t["ein"], W, b.senders, b.receivers, t["w"], blocks[1],
        blocks[2], has_x, has_ein)
    dx, dW = torch.autograd.grad(out, [x, W], t["g"], allow_unused=True)
    return out.detach(), dx, dW


@pytest.mark.cuda
@pytest.mark.parametrize("has_x,has_ein", K2_VARIANTS)
@pytest.mark.parametrize("F,bn,be", [(45, 128, 384), (300, 512, 1536)])
def test_k2_kernels_match_plain_version(cuda_device, has_x, has_ein, F, bn,
                                        be):
    """K2's forward and backward; blocks of 512 nodes need 64 KB of shared
    memory, above the 48 KB a launch gets without opting in."""
    t, b, blocks = _k2_case(cuda_device, F, bn, be)
    assert blocks[1] == bn
    name = blocked_spmm.variant(has_x, has_ein)
    before = dict(blocked_spmm.launches)
    out = blocked_spmm.spmm_fwd(t["x"], t["ein"], t["W"], b.senders,
                                b.receivers, t["w"], bn, be, has_x, has_ein)
    dx, dW = blocked_spmm.spmm_bwd(t["g"], t["ein"], b.senders, b.receivers,
                                   t["w"], t["W"].shape[0], bn, be, has_x,
                                   has_ein)
    torch.cuda.synchronize()
    after = dict(blocked_spmm.launches)
    for d in ("fwd", "bwd"):
        key = f"blocked_spmm_{d}[{name}]"
        assert after.pop(key) == before.pop(key) + 1
    assert after == before
    out_p, dx_p, dW_p = _k2_plain(t, b, blocks, has_x, has_ein)
    assert _rel(out, out_p) <= FWD_TOL
    assert not out[~b.node_mask].any()
    assert (dx is None) == (not has_x) and (dW is None) == (not has_ein)
    if has_x:
        assert _rel(dx, dx_p) <= GRAD_TOL
    if has_ein:
        assert dW.dtype == torch.float32
        assert _rel(dW, dW_p) <= GRAD_TOL


# [x] reads no edge input, so it takes one width only
K2_BITS_CASES = [(hx, he, k) for hx, he in K2_VARIANTS
                 for k in ((1, 10, 16) if he else (10,))]


@pytest.mark.cuda
@pytest.mark.parametrize("has_x,has_ein,K", K2_BITS_CASES)
@pytest.mark.parametrize("F", [300, 33])
@pytest.mark.parametrize("bn,be", [(128, 384), (512, 1536)])
def test_k2_is_bit_repeatable(cuda_device, has_x, has_ein, K, F, bn, be):
    """K2 forward and backward, twice on the same inputs: out, dx and dW
    equal bit for bit (no atomics), within the tolerances of the plain
    version, padded rows exactly 0. Edge inputs of width K drawn at random,
    signed fractional edge weights, and the first block left without a
    valid edge."""
    t, b, blocks = _k2_case(cuda_device, F, bn, be, seed=F + K)
    gen = torch.Generator().manual_seed(K)
    E = b.senders.shape[0]
    t["ein"] = torch.randn(E, K, generator=gen).to(cuda_device)
    t["W"] = torch.randn(K, F, generator=gen).to(cuda_device)
    t["w"][:blocks[2]] = 0  # block 0: no valid edge
    runs = []
    for _ in range(2):
        out = blocked_spmm.spmm_fwd(t["x"], t["ein"], t["W"], b.senders,
                                    b.receivers, t["w"], bn, be, has_x,
                                    has_ein)
        dx, dW = blocked_spmm.spmm_bwd(t["g"], t["ein"], b.senders,
                                       b.receivers, t["w"], K, bn, be,
                                       has_x, has_ein)
        runs.append((out, dx, dW))
    torch.cuda.synchronize()
    for name, a, c in zip(("out", "dx", "dW"), *runs):
        assert (a is None) == (c is None), name
        assert a is None or torch.equal(a, c), name
    out, dx, dW = runs[0]
    out_p, dx_p, dW_p = _k2_plain(t, b, blocks, has_x, has_ein)
    assert _rel(out, out_p) <= FWD_TOL
    assert not out[~b.node_mask].any() and not out[:bn].any()
    if has_x:
        assert _rel(dx, dx_p) <= GRAD_TOL
    if has_ein:
        assert _rel(dW, dW_p) <= GRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("has_x,has_ein", K2_VARIANTS)
def test_k2_autograd_function_gradients(cuda_device, has_x, has_ein):
    """Through autograd: dx is zeros without has_x, ein and w get zero
    gradients, and dx/dW match the plain version."""
    t, b, blocks = _k2_case(cuda_device, 64, 128, 384, seed=1)
    leaves = {k: t[k].detach().clone().requires_grad_(True)
              for k in ("x", "ein", "W", "w")}
    out = blocked_spmm.blocked_spmm_fused(
        leaves["x"], leaves["ein"], leaves["W"], b.senders, b.receivers,
        leaves["w"], blocks[1], blocks[2], has_x, has_ein)
    (out * t["g"]).sum().backward()
    _, dx_p, dW_p = _k2_plain(t, b, blocks, has_x, has_ein)
    assert not leaves["ein"].grad.any() and not leaves["w"].grad.any()
    if has_x:
        assert _rel(leaves["x"].grad, dx_p) <= GRAD_TOL
    else:
        assert not leaves["x"].grad.any()
    if has_ein:
        assert _rel(leaves["W"].grad, dW_p) <= GRAD_TOL


@pytest.mark.cuda
def test_gather_scatter_dispatch_on_cuda(cuda_device):
    """A blocked batch goes to K2 (the concat as two calls); an unblocked
    one raises."""
    t, b, blocks = _k2_case(cuda_device, 32, 128, 384, seed=2)
    args = (t["x"], b.senders, b.receivers, b.edge_mask, b.max_nodes)
    kw = dict(edge_in=t["ein"], edge_kernel=t["W"], combine="concat")
    before = dict(blocked_spmm.launches)
    got = spmm.gather_scatter(*args, block_nodes=blocks[1],
                              block_edges=blocks[2], **kw)
    assert blocked_spmm.launches["blocked_spmm_fwd[x]"] == \
        before["blocked_spmm_fwd[x]"] + 1
    assert blocked_spmm.launches["blocked_spmm_fwd[ein]"] == \
        before["blocked_spmm_fwd[ein]"] + 1
    want = spmm.gather_scatter_plain(*args, **kw)
    assert _rel(got, want) <= FWD_TOL
    with pytest.raises(ValueError, match="block-diagonal"):
        spmm.gather_scatter(*args, **kw)


@pytest.mark.cuda
def test_bio_masking_step_on_card_matches_cpu(cuda_device):
    """One train-mode step of a small bio masking model: card vs CPU."""
    graphs = bio_dataset(64, seed=2)
    cfg = _packed_cfg(domain="bio", num_layer=3, emb_dim=48,
                                  batch_size=32, packing="blocked")
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


@pytest.mark.cuda
def test_k2_with_gcn_edge_weight_matches_plain_version(cuda_device):
    """K2's x+ein variant as GCN drives it: ``gather_scatter`` with the
    edge product and the inverse-sqrt-degree weights of both endpoints."""
    t, b, blocks = _k2_case(cuda_device, 48, 128, 384, seed=3)
    dis = chem.inv_sqrt_degree(b)
    norm = dis[b.receivers.long()] * dis[b.senders.long()]
    assert 0 < float(norm[b.edge_mask].min()) < float(norm.max()) < 1
    results = []
    before = dict(blocked_spmm.launches)
    for fn, kw in ((spmm.gather_scatter, dict(block_nodes=blocks[1],
                                              block_edges=blocks[2])),
                   (spmm.gather_scatter_plain, {})):
        x = t["x"].detach().clone().requires_grad_(True)
        W = t["W"].detach().clone().requires_grad_(True)
        out = fn(x, b.senders, b.receivers, b.edge_mask, b.max_nodes,
                 edge_in=t["ein"], edge_kernel=W, edge_weight=norm, **kw)
        (out * t["g"]).sum().backward()
        results.append((out.detach(), x.grad, W.grad))
    for d in ("fwd", "bwd"):
        key = f"blocked_spmm_{d}[x+ein]"
        assert blocked_spmm.launches[key] == before[key] + 1
    (out, dx, dW), (out_p, dx_p, dW_p) = results
    assert _rel(out, out_p) <= FWD_TOL
    assert _rel(dx, dx_p) <= GRAD_TOL and _rel(dW, dW_p) <= GRAD_TOL


def _k3_case(dev, F, block_nodes, block_edges, head, n_graphs=24, seed=0,
             fractional=False):
    """A blocked bio batch with its last blocks all padding, and K3's
    inputs for one scoring head: "pos" = every edge slot, "neg" = the C++
    sampler's block-aligned pairs (block_edges // 2 a block). With
    ``fractional`` the valid pairs get fractional, partly negative weights
    and one of them becomes a self-pair (a == b)."""
    graphs = bio_dataset(n_graphs, seed=seed)
    n_blocks, bn, be = block_layout(graphs, n_graphs, block_nodes,
                                    block_edges)
    blocks = (n_blocks + 2, bn, be)
    b = next(iter(PackedLoader(
        graphs, n_graphs, shuffle=False, blocks=blocks, seed=seed,
        extra_pad={"center_node_idx": n_graphs},
        post_transform=NativeNegativeEdge()))).to(dev)
    assert not b.node_mask.reshape(blocks[0], bn)[-1].any()
    gen = torch.Generator().manual_seed(seed)
    if head == "pos":
        a_idx, b_idx, mask, ppb = b.receivers, b.senders, b.edge_mask, be
    else:
        neg = b.extras["negative_edges_blocked"]
        a_idx, b_idx = neg[:, 0].contiguous(), neg[:, 1].contiguous()
        mask, ppb = b.extras["negative_edges_blocked_mask"], be // 2
    assert mask.any() and not mask.all()
    x = (torch.randn(b.max_nodes, F, generator=gen).to(dev)
         * b.node_mask[:, None])
    g = torch.randn(a_idx.shape[0], generator=gen).to(dev)
    w = mask.float()
    if fractional:
        w = w * (torch.rand(w.shape[0], generator=gen) * 2 - 0.5).to(dev)
        b_idx = b_idx.clone()
        i = int(torch.nonzero(mask)[3])
        b_idx[i] = a_idx[i]
    return x, a_idx, b_idx, w, g, b, bn, ppb


# every load width of K3 and K7: F odd (4 B), F % 4 == 0 (16 B forward,
# 8 B backward and K7), F even with F % 4 != 0 (8 B); blocks of 512 nodes
# and 1,536 slots
WIDTH_CASES = [(45, 128, 384), (64, 128, 384), (300, 512, 1536),
               (334, 128, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("odd_offset", [False, True])
@pytest.mark.parametrize("head", ["pos", "neg"])
@pytest.mark.parametrize("F,bn,be", WIDTH_CASES)
def test_k3_kernels_match_plain_version(cuda_device, F, bn, be, head,
                                        odd_offset):
    """K3's forward and backward at every load width, at blocks of 512
    nodes (above the 48 KB of shared memory a launch gets without opting
    in), with all-padding blocks, fractional and negative weights and a
    self-pair, and (``odd_offset``) x at an odd float offset, which takes
    one feature a lane: padded pairs score exactly 0, rows no valid pair
    touches get exactly 0, and both directions are the same bits from run
    to run."""
    x, a_idx, b_idx, w, g, b, bn_, ppb = _k3_case(cuda_device, F, bn, be,
                                                  head, fractional=True)
    assert bn_ == bn and bool((a_idx == b_idx)[w != 0].any())
    if odd_offset:
        x = _at_odd_offset(x)
        assert x.data_ptr() % 8
    before = dict(edge_dot.launches)
    out = edge_dot.edot_fwd(x, a_idx, b_idx, w, bn, ppb)
    dx = edge_dot.edot_bwd(g, x, a_idx, b_idx, w, bn, ppb)
    torch.cuda.synchronize()
    assert edge_dot.launches == {k: v + 1 for k, v in before.items()}
    xl = x.detach().clone().requires_grad_(True)
    out_p = edge_dot.edge_dot_plain(xl, a_idx, b_idx, w)
    (dx_p,) = torch.autograd.grad(out_p, [xl], g)
    assert _rel(out, out_p.detach()) <= FWD_TOL
    assert _rel(dx, dx_p) <= GRAD_TOL
    assert not out[w == 0].any()
    touched = torch.zeros(b.max_nodes, dtype=torch.bool, device=x.device)
    touched[a_idx[w != 0].long()] = True
    touched[b_idx[w != 0].long()] = True
    assert not dx[~touched].any() and not dx[~b.node_mask].any()
    assert torch.equal(edge_dot.edot_bwd(g, x, a_idx, b_idx, w, bn, ppb), dx)
    assert torch.equal(edge_dot.edot_fwd(x, a_idx, b_idx, w, bn, ppb), out)


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["pos", "neg"])
def test_k3_autograd_function_and_dispatch(cuda_device, head):
    """Through ``spmm.edge_dot`` and autograd, with a non-contiguous
    cotangent, against the plain version; ``w`` gets a zero gradient; an
    unblocked pair list on CUDA raises and launches nothing."""
    x, a_idx, b_idx, w, g, b, bn, ppb = _k3_case(cuda_device, 64, 128, 384,
                                                 head, seed=1)
    g_strided = torch.stack([g, -g], dim=1)[:, 0]
    assert not g_strided.is_contiguous()
    before = dict(edge_dot.launches)
    xl = x.detach().clone().requires_grad_(True)
    out = spmm.edge_dot(xl, a_idx, b_idx, w != 0, bn, ppb)
    out.backward(g_strided)
    assert edge_dot.launches == {k: v + 1 for k, v in before.items()}
    xp = x.detach().clone().requires_grad_(True)
    out_p = edge_dot.edge_dot_plain(xp, a_idx, b_idx, w)
    out_p.backward(g_strided)
    assert _rel(out.detach(), out_p.detach()) <= FWD_TOL
    assert _rel(xl.grad, xp.grad) <= GRAD_TOL
    with pytest.raises(ValueError, match="block-aligned pair list"):
        spmm.edge_dot(xl, a_idx, b_idx, w != 0)
    assert edge_dot.launches == {k: v + 1 for k, v in before.items()}
    wl = w.detach().clone().requires_grad_(True)
    edge_dot.blocked_edge_dot(x, a_idx, b_idx, wl, bn, ppb).sum().backward()
    assert not wl.grad.any()
    with pytest.raises(ValueError, match="contiguous"):
        edge_dot.edot_fwd(x.t().contiguous().t(), a_idx, b_idx, w, bn, ppb)


@pytest.mark.cuda
@pytest.mark.parametrize("domain,gnn_type", [("chem", "gin"), ("chem", "gcn"),
                                             ("bio", "gin"),
                                             ("bio", "graphsage")])
def test_edgepred_step_on_card_matches_cpu(cuda_device, domain, gnn_type):
    """One train-mode step of a small edge-prediction model: card (K1 or
    K2 in the trunk, K3 in both heads) vs CPU."""
    graphs = (bio_dataset(64, seed=2) if domain == "bio"
              else molecule_dataset(64, seed=2)[0])
    cfg = _packed_cfg(objective="edgepred", domain=domain,
                                  gnn_type=gnn_type, num_layer=3, emb_dim=48,
                                  batch_size=32, packing="blocked")
    batch = next(iter(pretrain.build_loader(cfg, graphs, cuda_device)))
    out = {}
    before = dict(edge_dot.launches)
    for dev in (cuda_device, torch.device("cpu")):
        model = pretrain.build_objective(cfg).to(dev)
        loss, _ = model(batch.to(dev), train=True)
        loss.backward()
        out[dev.type] = (float(loss.detach()),
                         {n: p.grad.cpu() for n, p in
                          model.named_parameters()})
    assert edge_dot.launches == {k: v + 2 for k, v in before.items()}
    assert np.isclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for n, gc in out["cuda"][1].items():
        assert torch.isfinite(gc).all(), n
        assert _rel(gc, out["cpu"][1][n]) <= 1e-3, n


GAT_DIFF = ("h", "Wl", "bl", "We", "e_self", "a_i", "a_j", "bias")
GAT_GRADS = ("dh", "dWl", "dbl", "dWe", "de_self", "da_i", "da_j", "dbias")
H = 2


def _gat_case(dev, domain, D, block_nodes, block_edges, n_graphs=24, seed=0,
              variant="onehot", heads=H):
    """A blocked batch whose last two blocks are all padding, and the
    inputs of K4 (h, Wl as a transposed view, ein, We, ...) from which K5's
    x and e follow, with the edge weights ``t["w"]``. Chem: bond one-hots,
    K = 9; bio: [edge_feat | 1], K = 10. ``variant``: "onehot" (those),
    "K1" or "K16" (uniform random ein of that width), "dense" (normal
    random ein, the same width) or "frac" (one-hots, valid edge weights
    drawn from [0.25, 1.25)); ``heads`` attention heads."""
    if domain == "bio":
        graphs = bio_dataset(n_graphs, seed=seed)
        extra = {"center_node_idx": n_graphs}
    else:
        graphs, extra = molecule_dataset(n_graphs, seed=seed,
                                         mean_atoms=20)[0], None
    n_blocks, bn, be = block_layout(graphs, n_graphs, block_nodes,
                                    block_edges)
    b = next(iter(PackedLoader(graphs, n_graphs, shuffle=False,
                               blocks=(n_blocks + 2, bn, be),
                               extra_pad=extra))).to(dev)
    assert not b.node_mask.reshape(-1, bn)[-1].any()
    assert b.edge_mask.any() and not b.edge_mask.all()
    ein = (bio.edge_inputs(b, torch.float32) if domain == "bio"
           else chem.bond_one_hot(b, torch.float32))
    gen = torch.Generator().manual_seed(seed)
    if variant in ("K1", "K16"):
        ein = torch.rand(ein.shape[0], int(variant[1:]), generator=gen).to(dev)
    elif variant == "dense":
        ein = torch.randn(ein.shape, generator=gen).to(dev)
    w = b.edge_mask.float()
    if variant == "frac":
        w = w * (0.25 + torch.rand(w.shape, generator=gen).to(dev))
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    N, K = b.max_nodes, ein.shape[1]
    Hh = heads
    t = dict(w=w, h=r(N, D) * b.node_mask[:, None],
             Wl=r(Hh * D, D, scale=D ** -0.5).t(), bl=r(Hh * D, scale=0.1),
             We=r(K, Hh * D, scale=0.5), e_self=r(Hh, D, scale=0.5),
             a_i=r(Hh, D, scale=D ** -0.5), a_j=r(Hh, D, scale=D ** -0.5),
             bias=r(D, scale=0.1), g=r(N, D), g3=r(N, Hh, D))
    return t, ein, b, bn, be


def _graph(b):
    return b.senders, b.receivers, b.edge_mask.float()


# (D, block_nodes, block_edges, variant of _gat_case): an odd width, blocks
# of 512 nodes and 1,536 slots, the GAT paths' own shape, K = 1 at an odd
# width of two 320-feature chunks, K = 16, fractional edge weights, and an
# even width of two chunks with dense random ein
GAT_SHAPES = [(45, 128, 384, "onehot"), (300, 512, 1536, "onehot"),
              (300, 128, 384, "onehot"), (333, 128, 384, "K1"),
              (40, 128, 384, "K16"), (300, 128, 384, "frac"),
              (334, 128, 384, "dense")]


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["chem", "bio"])
@pytest.mark.parametrize("D,bn,be,variant",
                         GAT_SHAPES + [(45, 128, 384, "dense")])
def test_k4_kernels_match_plain_version(cuda_device, domain, D, bn, be,
                                        variant):
    """K4's forward (out and the saved x) and all eight gradients at the
    shapes of GAT_SHAPES and with dense random edge inputs (the
    reassociated edge term must hold for any ein, not only one-hots), with
    all-padding blocks: nothing is NaN, padded rows get (bl + e_self) head
    averaged + bias, and every output is the same bits from run to run."""
    t, ein, b, bn_, be_ = _gat_case(cuda_device, domain, D, bn, be,
                                    variant=variant)
    assert (bn_, be_) == (bn, be)
    graph = (b.senders, b.receivers, t["w"])
    before = dict(gat_conv.launches)
    run = lambda: gat_conv.gat_conv_fwd(
        t["h"], t["Wl"], t["bl"], ein, t["We"], t["e_self"], t["a_i"],
        t["a_j"], t["bias"], *graph, bn, be)
    out, x, saved = run()
    back = lambda: gat_conv.gat_conv_bwd(
        t["g"], t["h"], t["Wl"], x, ein, t["We"], t["e_self"], t["a_i"],
        t["a_j"], *graph, saved, bn, be)
    grads = back()
    torch.cuda.synchronize()
    assert gat_conv.launches == {k: v + 1 for k, v in before.items()}
    leaves = [t[k].detach().clone().requires_grad_(True) for k in GAT_DIFF]
    lh, lWl, lbl, lWe, les, lai, laj, lbias = leaves
    out_p, x_p = gat_conv.fused_gat_conv_plain(
        lh, lWl, lbl, ein, lWe, les, lai, laj, lbias, *graph, H,
        return_residuals=True)
    grads_p = torch.autograd.grad(out_p, leaves, t["g"])
    assert torch.isfinite(out).all()
    assert _rel(out, out_p.detach()) <= FWD_TOL
    assert _rel(x, x_p.detach()) <= FWD_TOL
    pad = (t["bl"].reshape(H, D) + t["e_self"]).mean(0) + t["bias"]
    assert _rel(out[~b.node_mask], pad.expand(int((~b.node_mask).sum()), D)) \
        <= FWD_TOL
    alpha = saved[0]
    assert not alpha[~b.edge_mask].any()
    for name, a, p in zip(GAT_GRADS, grads, grads_p):
        assert torch.isfinite(a).all(), name
        assert _rel(a, p) <= GRAD_TOL, name
    out2, x2, _ = run()
    assert torch.equal(out, out2) and torch.equal(x, x2)
    for name, a, a2 in zip(GAT_GRADS, grads, back()):
        assert torch.equal(a, a2), name


def _k5_inputs(t, ein, D):
    """x and e as the unfused GATConv forms them."""
    x = (t["h"] @ t["Wl"] + t["bl"]).reshape(-1, H, D).contiguous()
    e = (ein @ t["We"]).reshape(-1, H, D).contiguous()
    return x, e


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["chem", "bio"])
@pytest.mark.parametrize("D,bn,be,variant", GAT_SHAPES)
def test_k5_kernels_match_plain_version(cuda_device, domain, D, bn, be,
                                        variant):
    """K5's forward and its five gradients, as above; a padded slot's de
    row is exactly 0."""
    t, ein, b, bn_, be_ = _gat_case(cuda_device, domain, D, bn, be, seed=1,
                                    variant=variant)
    x, e = _k5_inputs(t, ein, D)
    par = (t["e_self"], t["a_i"], t["a_j"])
    graph = (b.senders, b.receivers, t["w"])
    before = dict(attention.launches)
    out, saved = attention.gat_attn_fwd(x, e, *par, *graph, 0.2, bn, be)
    back = lambda: attention.gat_attn_bwd(t["g3"], x, e, *par, *graph,
                                          saved, 0.2, bn, be)
    grads = back()
    torch.cuda.synchronize()
    assert attention.launches == {k: v + 1 for k, v in before.items()}
    leaves = [v.detach().clone().requires_grad_(True) for v in (x, e, *par)]
    out_p = attention.blocked_gat_attention_plain(*leaves, *graph, 0.2)
    grads_p = torch.autograd.grad(out_p, leaves, t["g3"])
    assert torch.isfinite(out).all()
    assert _rel(out, out_p.detach()) <= FWD_TOL
    for name, a, p in zip(("dx", "de", "de_self", "da_i", "da_j"), grads,
                          grads_p):
        assert torch.isfinite(a).all(), name
        assert _rel(a, p) <= GRAD_TOL, name
    assert not grads[1][~b.edge_mask].any()
    for a, a2 in zip(grads, back()):
        assert torch.equal(a, a2)


def _at_odd_offset(t):
    """A contiguous copy of ``t`` that starts 4 bytes past an 8-byte
    boundary."""
    buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=t.device)
    off = 1 if buf.data_ptr() % 8 == 0 else 2
    return buf[off:off + t.numel()].view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_gat_kernels_take_rows_at_odd_offsets(cuda_device, kernel):
    """At an even width, inputs at an odd float offset (their rows not
    8-byte aligned: K5's x, e and cotangent, K4's We and cotangent) take
    one feature a lane and agree with the plain version."""
    D = 40
    t, ein, b, bn, be = _gat_case(cuda_device, "chem", D, 128, 384, seed=3)
    graph = (b.senders, b.receivers, t["w"])
    par = (t["e_self"], t["a_i"], t["a_j"])
    if kernel == "k5":
        x, e = (_at_odd_offset(v) for v in _k5_inputs(t, ein, D))
        out, saved = attention.gat_attn_fwd(x, e, *par, *graph, 0.2, bn, be)
        grads = attention.gat_attn_bwd(_at_odd_offset(t["g3"]), x, e, *par,
                                       *graph, saved, 0.2, bn, be)
        leaves = [v.detach().clone().requires_grad_(True)
                  for v in (x, e, *par)]
        out_p = attention.blocked_gat_attention_plain(*leaves, *graph, 0.2)
        g = t["g3"]
    else:
        We = _at_odd_offset(t["We"])
        out, x, saved = gat_conv.gat_conv_fwd(
            t["h"], t["Wl"], t["bl"], ein, We, *par, t["bias"], *graph, bn,
            be)
        grads = gat_conv.gat_conv_bwd(
            _at_odd_offset(t["g"]), t["h"], t["Wl"], x, ein, We, *par,
            *graph, saved, bn, be)
        leaves = [t[k].detach().clone().requires_grad_(True)
                  for k in GAT_DIFF]
        lh, lWl, lbl, lWe, les, lai, laj, lbias = leaves
        out_p = gat_conv.fused_gat_conv_plain(
            lh, lWl, lbl, ein, lWe, les, lai, laj, lbias, *graph, H)
        g = t["g"]
    grads_p = torch.autograd.grad(out_p, leaves, g)
    assert _rel(out, out_p.detach()) <= FWD_TOL
    for i, (a, p) in enumerate(zip(grads, grads_p)):
        assert _rel(a, p) <= GRAD_TOL, i


@pytest.mark.cuda
@pytest.mark.parametrize("fused", ["on", "off"])
def test_gat_autograd_functions_and_dispatch(cuda_device, fused):
    """Through ``fused_gat_conv`` (K4) or ``gat_attention`` (K5) and
    autograd, ``a_i`` and ``a_j`` as slices of one ``att``, with a
    non-contiguous cotangent, against the plain version; ``ein``/``w`` get
    zero gradients; an unblocked batch on CUDA raises and launches
    nothing."""
    D = 40
    t, ein, b, bn, be = _gat_case(cuda_device, "chem", D, 128, 384, seed=2)
    att = torch.cat([t["a_i"], t["a_j"]], dim=1)[None]  # [1, H, 2D]
    g = torch.stack([t["g"], -t["g"]], dim=2)[:, :, 0]
    assert not g.is_contiguous()
    mod = gat_conv if fused == "on" else attention
    before = dict(mod.launches)

    def run(on_card):
        lv = {k: t[k].detach().clone().requires_grad_(True)
              for k in ("h", "Wl", "bl", "We", "e_self", "bias")}
        lv["att"] = att.detach().clone().requires_grad_(True)
        lv["w"] = b.edge_mask.float().requires_grad_(True)
        lv["ein"] = ein.detach().clone().requires_grad_(True)
        a_i, a_j = lv["att"][0, :, :D], lv["att"][0, :, D:]
        if fused == "on":
            fn = (gat_conv.fused_gat_conv if on_card
                  else gat_conv.fused_gat_conv_plain)
            out = fn(lv["h"], lv["Wl"], lv["bl"], lv["ein"], lv["We"],
                     lv["e_self"], a_i, a_j, lv["bias"], b.senders,
                     b.receivers, lv["w"], H, bn, be)
        else:
            x = (lv["h"] @ lv["Wl"] + lv["bl"]).reshape(-1, H, D)
            e = (lv["ein"] @ lv["We"]).reshape(-1, H, D)
            if on_card:
                out = attention.blocked_gat_attention(
                    x, e, lv["e_self"], a_i, a_j, b.senders, b.receivers,
                    lv["w"], 0.2, bn, be)
            else:
                out = attention.blocked_gat_attention_plain(
                    x, e, lv["e_self"], a_i, a_j, b.senders, b.receivers,
                    lv["w"], 0.2)
            out = out.mean(1) + lv["bias"]
        out.backward(g)
        return out.detach(), {k: v.grad for k, v in lv.items()}

    out, grads = run(True)
    assert mod.launches == {k: v + 1 for k, v in before.items()}
    out_p, grads_p = run(False)
    assert _rel(out, out_p) <= FWD_TOL
    assert not grads["w"].any()
    if fused == "on":
        assert not grads["ein"].any()
    for k in ("h", "Wl", "bl", "We", "e_self", "bias", "att"):
        assert _rel(grads[k], grads_p[k]) <= GRAD_TOL, k

    x, e = _k5_inputs(t, ein, D)
    launched = dict(mod.launches)
    with pytest.raises(ValueError, match="block-diagonal"):
        if fused == "on":
            gat_conv.fused_gat_conv(
                t["h"], t["Wl"], t["bl"], ein, t["We"], t["e_self"],
                t["a_i"], t["a_j"], t["bias"], *_graph(b), H, 0, 0)
        else:
            attention.gat_attention(x, e, t["e_self"], t["a_i"][None],
                                    t["a_j"][None], b.senders, b.receivers,
                                    b.edge_mask, b.max_nodes)
    with pytest.raises(ValueError, match="contiguous"):
        attention.gat_attn_fwd(x.transpose(0, 1).contiguous().transpose(0, 1),
                               e, t["e_self"], t["a_i"], t["a_j"],
                               *_graph(b), 0.2, bn, be)
    assert mod.launches == launched


@pytest.mark.cuda
@pytest.mark.parametrize("domain,fused", [("chem", "on"), ("chem", "off"),
                                          ("bio", "on"), ("bio", "off")])
def test_gat_masking_step_on_card_matches_cpu(cuda_device, domain, fused):
    """One train-mode step of a small GAT masking model: card (K4, or K5
    under set_fused("off")) vs CPU; an unblocked batch on CUDA raises."""
    graphs = (bio_dataset(64, seed=2) if domain == "bio"
              else molecule_dataset(64, seed=2)[0])
    cfg = _packed_cfg(domain=domain, gnn_type="gat", num_layer=3,
                                  emb_dim=48, batch_size=32,
                                  packing="blocked")
    batch = next(iter(pretrain.build_loader(cfg, graphs, cuda_device)))
    mod = gat_conv if fused == "on" else attention
    before = dict(mod.launches)
    gat_conv.set_fused(fused)
    try:
        out = {}
        for dev in (cuda_device, torch.device("cpu")):
            model = pretrain.build_objective(cfg).to(dev)
            loss, _ = model(batch.to(dev), train=True)
            loss.backward()
            out[dev.type] = (float(loss.detach()),
                             {n: p.grad.cpu() for n, p in
                              model.named_parameters()})
        assert mod.launches == {k: v + 3 for k, v in before.items()}
        std = _packed_cfg(domain=domain, gnn_type="gat",
                                      num_layer=3, emb_dim=48, batch_size=32,
                                      packing="standard")
        flat = next(iter(pretrain.build_loader(std, graphs, cuda_device)))
        with pytest.raises(ValueError, match="block-diagonal"):
            model = pretrain.build_objective(std).to(cuda_device)
            model(flat.to(cuda_device), train=True)
    finally:
        gat_conv.set_fused("on")
    assert np.isclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    assert any("att" in n for n in out["cuda"][1])
    for n, gc in out["cuda"][1].items():
        assert torch.isfinite(gc).all(), n
        assert _rel(gc, out["cpu"][1][n]) <= 1e-3, n


def _k6_case(dev, F, block_nodes, block_edges, n_graphs=24, seed=0):
    """A blocked bio batch with its last two blocks all padding, and K6's
    inputs: x, a precomputed edge embedding ee, fractional and negative
    edge weights (0 on padded slots) and a cotangent g."""
    graphs = bio_dataset(n_graphs, seed=seed)
    n_blocks, bn, be = block_layout(graphs, n_graphs, block_nodes,
                                    block_edges)
    blocks = (n_blocks + 2, bn, be)
    b = next(iter(PackedLoader(
        graphs, n_graphs, shuffle=False, blocks=blocks, seed=seed,
        extra_pad={"center_node_idx": n_graphs}))).to(dev)
    assert not b.edge_mask.reshape(blocks[0], be)[-1].any()
    gen = torch.Generator().manual_seed(seed)
    N, E = b.max_nodes, b.max_edges
    r = lambda *s: torch.randn(*s, generator=gen).to(dev)
    w = b.edge_mask.float() * (torch.rand(E, generator=gen) * 2 - 0.5).to(dev)
    t = dict(x=r(N, F) * b.node_mask[:, None], ee=r(E, F), w=w, g=r(N, F))
    return t, b, blocks


def _k6_plain(t, b, blocks, has_ee, g=None):
    x = t["x"].detach().clone().requires_grad_(True)
    ee = t["ee"].detach().clone().requires_grad_(True)
    out = blocked_spmm.blocked_spmm_plain(
        x, ee if has_ee else None, b.senders, b.receivers, t["w"],
        blocks[1], blocks[2])
    dx, dee = torch.autograd.grad(out, [x, ee], t["g"] if g is None else g,
                                  allow_unused=True)
    return out.detach(), dx, dee


def _long_runs(b, be, n):
    """``b`` with block 0's first ``n`` valid slots into one receiver and
    the next ``n`` from one sender: where ``n`` exceeds the 256 slots a
    pass stages, each run spans two passes."""
    v = torch.nonzero(b.edge_mask[:be]).flatten()
    assert v.numel() >= 2 * n
    rcv, snd = b.receivers.clone(), b.senders.clone()
    rcv[v[:n]] = int(rcv[v[0]])
    snd[v[n:2 * n]] = int(snd[v[n]])
    return dataclasses.replace(b, receivers=rcv, senders=snd)


@pytest.mark.cuda
@pytest.mark.parametrize("odd_offset", [False, True])
@pytest.mark.parametrize("has_ee", [True, False])
@pytest.mark.parametrize("F,bn,be", WIDTH_CASES)
def test_k6_kernels_match_plain_version(cuda_device, has_ee, F, bn, be,
                                        odd_offset):
    """K6's forward and backward at every load width (F = 300 at blocks of
    512 nodes takes two features a lane: its 4-wide tile would not fit
    shared memory), at blocks of 512 nodes (above the 48 KB a launch gets
    without opting in), with all-padding blocks, fractional and negative
    weights, a receiver and a sender with a run of 45 slots (300 at blocks
    of 1,536 slots: longer than one staged pass), and (``odd_offset``) x,
    the edge embedding and g at an odd float offset (one feature a lane):
    padded rows and padded slots come out exactly 0, and every output is
    the same bits from run to run and in every subset of dx and dmsg."""
    t, b, blocks = _k6_case(cuda_device, F, bn, be)
    assert blocks[1] == bn
    b = _long_runs(b, be, 300 if be > 1024 else 45)
    if odd_offset:
        t = {k: _at_odd_offset(v) if k in ("x", "ee", "g") else v
             for k, v in t.items()}
        assert t["x"].data_ptr() % 8
    ee = t["ee"] if has_ee else None
    edges = (b.senders, b.receivers, t["w"], bn, be)
    name = blocked_spmm.ee_variant(has_ee)
    before = dict(blocked_spmm.launches)
    out = blocked_spmm.spmm_ee_fwd(t["x"], ee, *edges)
    dx, dmsg = blocked_spmm.spmm_ee_bwd(t["g"], *edges, has_ee)
    torch.cuda.synchronize()
    after = dict(blocked_spmm.launches)
    for d in ("fwd", "bwd"):
        key = f"blocked_spmm_ee_{d}[{name}]"
        assert after.pop(key) == before.pop(key) + 1
    assert after == before
    out_p, dx_p, dee_p = _k6_plain(t, b, blocks, True)
    if not has_ee:
        out_p = _k6_plain(t, b, blocks, False)[0]
    assert _rel(out, out_p) <= FWD_TOL
    assert _rel(dx, dx_p) <= GRAD_TOL and _rel(dmsg, dee_p) <= GRAD_TOL
    assert not out[~b.node_mask].any() and not dx[~b.node_mask].any()
    assert not dmsg[~b.edge_mask].any() and dmsg[b.edge_mask].any()
    # each output alone, and the same bits again
    dx_only, none = blocked_spmm.spmm_ee_bwd(t["g"], *edges, has_ee,
                                             need_dmsg=False)
    none2, dmsg_only = blocked_spmm.spmm_ee_bwd(t["g"], *edges, has_ee,
                                                need_dx=False)
    assert none is None and none2 is None
    assert torch.equal(dx_only, dx) and torch.equal(dmsg_only, dmsg)
    assert torch.equal(blocked_spmm.spmm_ee_fwd(t["x"], ee, *edges), out)
    assert torch.equal(blocked_spmm.spmm_ee_bwd(t["g"], *edges, has_ee)[0],
                       dx)


@pytest.mark.cuda
@pytest.mark.parametrize("has_ee", [True, False])
def test_k6_autograd_function_gradients(cuda_device, has_ee):
    """Through autograd, with a strided cotangent: dx and dee match the
    plain version, w gets a zero gradient, and a leaf that asks for no
    gradient gets none."""
    t, b, blocks = _k6_case(cuda_device, 64, 128, 384, seed=1)
    leaves = {k: t[k].detach().clone().requires_grad_(True)
              for k in ("x", "ee", "w")}
    out = blocked_spmm.blocked_spmm(
        leaves["x"], leaves["ee"] if has_ee else None, b.senders,
        b.receivers, leaves["w"], blocks[1], blocks[2])
    g2 = torch.randn(out.shape[0], 2 * out.shape[1], device=out.device)
    g = g2[:, ::2]  # not contiguous
    assert not g.is_contiguous()
    out.backward(g)
    _, dx_p, dee_p = _k6_plain(t, b, blocks, has_ee, g)
    assert _rel(leaves["x"].grad, dx_p) <= GRAD_TOL
    assert not leaves["w"].grad.any()
    if has_ee:
        assert _rel(leaves["ee"].grad, dee_p) <= GRAD_TOL
    else:
        assert leaves["ee"].grad is None
    # only the edge embedding asks: one backward launch, no dx
    ee = t["ee"].detach().clone().requires_grad_(True)
    before = dict(blocked_spmm.launches)
    blocked_spmm.blocked_spmm(t["x"], ee, b.senders, b.receivers, t["w"],
                              blocks[1], blocks[2]).backward(g)
    assert blocked_spmm.launches["blocked_spmm_ee_bwd[x+ee]"] == \
        before["blocked_spmm_ee_bwd[x+ee]"] + 1
    assert _rel(ee.grad, _k6_plain(t, b, blocks, True, g)[2]) <= GRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("odd_offset", [False, True])
@pytest.mark.parametrize("has_ee", [True, False])
@pytest.mark.parametrize("F,bn,be", WIDTH_CASES)
def test_k7_kernel_matches_plain_version_and_k6(cuda_device, has_ee, F, bn,
                                                be, odd_offset):
    """K7 on the per-block sorted edges against its plain version and
    against K6 on the unsorted ones, at every load width, with fractional
    and negative weights, one receiver whose run (45 slots) is longer than
    a batch of loads, and (``odd_offset``) x and the edge embedding at an
    odd float offset (one feature a lane); padded rows exactly 0, the same
    bits from run to run, and no backward."""
    t, b, blocks = _k6_case(cuda_device, F, bn, be)
    # 45 valid slots of block 1 into one receiver
    lo = be
    v = torch.nonzero(b.edge_mask[lo:lo + be]).flatten()[:45] + lo
    assert v.numel() == 45
    rcv = b.receivers.clone()
    rcv[v] = int(rcv[v[0]])
    b = dataclasses.replace(b, receivers=rcv)
    s2, r2, w2, ee2 = sorted_spmm.sort_block_edges(
        b.senders, b.receivers, t["w"], t["ee"] if has_ee else None,
        blocks[0], be)
    assert bool((r2.reshape(-1, be).diff(dim=1) >= 0).all())
    x = t["x"]
    if odd_offset:
        x = _at_odd_offset(x)
        ee2 = None if ee2 is None else _at_odd_offset(ee2)
        assert x.data_ptr() % 8
    before = dict(sorted_spmm.launches)
    out = sorted_spmm.sorted_blocked_spmm(x, ee2, s2, r2, w2, bn, be)
    torch.cuda.synchronize()
    assert sorted_spmm.launches["sorted_blocked_spmm_fwd"] == \
        before["sorted_blocked_spmm_fwd"] + 1
    want = sorted_spmm.sorted_blocked_spmm_plain(x, ee2, s2, r2, w2)
    k6 = blocked_spmm.spmm_ee_fwd(t["x"], t["ee"] if has_ee else None,
                                  b.senders, b.receivers, t["w"], bn, be)
    assert _rel(out, want) <= FWD_TOL and _rel(out, k6) <= FWD_TOL
    assert not out[~b.node_mask].any()
    assert torch.equal(
        sorted_spmm.sorted_blocked_spmm(x, ee2, s2, r2, w2, bn, be), out)
    x = t["x"].detach().clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        sorted_spmm.sorted_blocked_spmm(x, ee2, s2, r2, w2, bn,
                                        be).sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["add", "concat"])
def test_gather_scatter_edge_emb_dispatch_on_cuda(cuda_device, combine):
    """With ``edge_emb`` a blocked batch goes to K6 (the concat form as
    K2[x] and K6 on a zero x, which gets no dx); the mean takes the plain
    path; an unblocked batch raises."""
    t, b, blocks = _k6_case(cuda_device, 32, 128, 384, seed=2)
    graph = (b.senders, b.receivers, b.edge_mask, b.max_nodes)
    kw = dict(edge_emb=None, combine=combine, edge_weight=t["w"].abs() + 0.5)
    results = []
    before = dict(blocked_spmm.launches)
    for fn, layout in ((spmm.gather_scatter, dict(block_nodes=blocks[1],
                                                  block_edges=blocks[2])),
                       (spmm.gather_scatter_plain, {})):
        x = t["x"].detach().clone().requires_grad_(True)
        ee = t["ee"].detach().clone().requires_grad_(True)
        out = fn(x, *graph, **{**kw, "edge_emb": ee}, **layout)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            3)).to(out.device)
        out.backward(g)
        results.append((out.detach(), x.grad, ee.grad))
    moved = {k: v - before[k] for k, v in blocked_spmm.launches.items()
             if v != before[k]}
    want = {"blocked_spmm_ee_fwd[x+ee]": 1, "blocked_spmm_ee_bwd[x+ee]": 1}
    if combine == "concat":
        want.update({"blocked_spmm_fwd[x]": 1, "blocked_spmm_bwd[x]": 1})
    assert moved == want
    (out, dx, dee), (out_p, dx_p, dee_p) = results
    assert out.shape == (b.max_nodes, 32 * (1 + (combine == "concat")))
    assert _rel(out, out_p) <= FWD_TOL
    assert _rel(dx, dx_p) <= GRAD_TOL and _rel(dee, dee_p) <= GRAD_TOL
    before = dict(blocked_spmm.launches)
    mean = spmm.gather_scatter(t["x"], *graph, edge_emb=t["ee"],
                               combine=combine, aggr="mean",
                               block_nodes=blocks[1], block_edges=blocks[2])
    assert blocked_spmm.launches == before
    assert _rel(mean, spmm.gather_scatter_plain(
        t["x"], *graph, edge_emb=t["ee"], combine=combine,
        aggr="mean")) <= FWD_TOL
    with pytest.raises(ValueError, match="block-diagonal"):
        spmm.gather_scatter(t["x"], *graph, edge_emb=t["ee"],
                            combine=combine)


@pytest.mark.cuda
def test_probe_launches_once_and_raises_on_a_wrong_answer(cuda_device,
                                                          monkeypatch):
    """The probe builds, launches once a process and caches its success;
    when its comparison is made to fail (the expected value, not the
    kernel, is changed) it raises and no kernel library is handed out."""
    _build.probe.cache_clear()
    before = _build.launches["probe_scale2"]
    assert _build.probe() is True and _build.probe() is True
    assert _build.launches["probe_scale2"] == before + 1
    x = torch.randn(*_build.PROBE_SHAPE, device=cuda_device)
    assert torch.equal(_build.probe_scale2(x), 2 * x)
    monkeypatch.setattr(_build, "probe_scale2_plain", lambda x: 2 * x + 1)
    _build.probe.cache_clear()
    with pytest.raises(RuntimeError, match="disagrees"):
        _build.probe()
    with pytest.raises(RuntimeError, match="disagrees"):
        _build.load("spmm_ee")
    monkeypatch.undo()
    assert _build.probe() is True


@pytest.mark.cuda
@pytest.mark.parametrize("domain,pooling", [("chem", "mean"),
                                            ("chem", "set2set2"),
                                            ("bio", "attention")])
def test_supervised_step_on_card_matches_cpu(cuda_device, domain, pooling):
    """One train-mode step of a small supervised model (dropout 0): card
    vs CPU; with dropout on, the card's masks repeat bit for bit under the
    same seed and the step stays finite. The loss itself repeats only to
    rtol 1e-6: the aggregations' and the readouts' atomics sum in an order
    that changes from run to run."""
    if domain == "bio":
        graphs = bio_dataset(64, seed=2, num_pretrain=7)
    else:
        graphs, _ = molecule_dataset(64, num_tasks=5, seed=2,
                                     missing_frac=0.2)
    graphs, T = pretrain.supervised_graphs(graphs, domain)
    cfg = _packed_cfg(
        objective="supervised", domain=domain, num_layer=3, emb_dim=48,
        batch_size=32, packing="blocked", num_tasks=T,
        graph_pooling=pooling)
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
    drop = dataclasses.replace(cfg, dropout_ratio=0.5)
    losses, masks = [], []
    h = torch.ones(64, 48, device=cuda_device)
    for _ in range(2):
        model = pretrain.build_objective(drop).to(cuda_device)
        with torch.no_grad():
            losses.append(float(model(batch.to(cuda_device), train=True)[0]))
            masks.append(model.gnn.dropout(h, True))
    assert torch.equal(masks[0], masks[1])
    assert set(masks[0].unique().tolist()) == {0.0, 2.0}
    assert np.isclose(losses[0], losses[1], rtol=1e-6, atol=0.0)
    assert np.isfinite(losses[0])
    assert not np.isclose(losses[0], out["cuda"][0], rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["masking", "supervised"])
def test_captured_steps_equal_eager_steps_bit_for_bit(cuda_device,
                                                      objective):
    """run_pretrain at scan_steps=4 (after three eager steps, each group of
    4 batches one CUDA-graph replay of 4 captured steps; the epochs' tails
    eager) against scan_steps=1 (every step eager) and against a second
    eager run, from the same seed: the history, every parameter and
    buffer and Adam's moments bit for bit. Chem GIN, 3 x 48, batches of 32
    (5 an epoch, 3 epochs): masking, and supervised with dropout 0.2,
    whose masks the replays must draw as eager steps draw them."""
    graphs, T = molecule_dataset(160, num_tasks=5, seed=2,
                                 missing_frac=0.2)
    extra = {}
    if objective == "supervised":
        graphs, T = pretrain.supervised_graphs(graphs, "chem")
        extra = dict(num_tasks=T, graph_pooling="mean", dropout_ratio=0.2)
    runs = []
    for k in (1, 4, 1):
        cfg = _packed_cfg(
            objective=objective, num_layer=3, emb_dim=48, batch_size=32,
            packing="blocked", scan_steps=k, **extra)
        runs.append(pretrain.run_pretrain(cfg, graphs, log=None, epochs=3,
                                          device=cuda_device))
    assert (runs[1]["replays"], runs[1]["eager_steps"]) == (2, 7)
    for other in runs[1:]:
        assert other["history"] == runs[0]["history"]
        for name, v in runs[0]["model"].state_dict().items():
            assert torch.equal(other["model"].state_dict()[name], v), name
        opt0, opt = runs[0]["state"].optimizer, other["state"].optimizer
        for p0, p in zip(runs[0]["model"].parameters(),
                         other["model"].parameters()):
            for key, v in opt0.state[p0].items():
                assert torch.equal(opt.state[p][key], v), key



@pytest.mark.cuda
@pytest.mark.parametrize("domain,gnn_type,mode", [("chem", "gin", "cbow"),
                                                  ("chem", "gin", "skipgram"),
                                                  ("chem", "gat", "cbow"),
                                                  ("bio", "gin", "cbow")])
def test_contextpred_step_on_card_matches_cpu(cuda_device, domain, gnn_type,
                                              mode):
    """One train-mode step of a small context-prediction model on a blocked
    pair batch: card (K1, K2 or K4 in both trunks, each stream its own
    block geometry, the context stream with rows no edge reaches and
    blocks without a valid edge) vs CPU; both trunks' launches counted."""
    graphs = (bio_dataset(64, seed=2) if domain == "bio"
              else molecule_dataset(80, seed=2)[0])
    cfg = _packed_cfg(objective="contextpred", domain=domain,
                                  gnn_type=gnn_type, mode=mode, num_layer=3,
                                  csize=2, emb_dim=48, batch_size=32,
                                  packing="blocked", context_variants=1)
    batch = next(iter(pretrain.build_loader(cfg, graphs, cuda_device)))
    ctx = batch.context
    reached = np.bincount(ctx.receivers[ctx.edge_mask],
                          minlength=ctx.max_nodes) > 0
    assert (ctx.node_mask & ~reached).any()
    assert (ctx.edge_mask.reshape(-1, ctx.block_edges).sum(1) == 0).any()
    out = {}
    counted, keys = ((gat_conv, ("gat_conv_fwd", "gat_conv_bwd"))
                     if gnn_type == "gat" else
                     (blocked_spmm, [f"blocked_spmm_{d}[{v}]"
                                     for d in ("fwd", "bwd")
                                     for v in ("x", "ein")])
                     if domain == "bio" else
                     (gin_conv, ("gin_conv_fwd", "gin_conv_bwd")))
    for dev in (cuda_device, torch.device("cpu")):
        model = pretrain.build_objective(cfg).to(dev)
        counted.reset_launches()
        loss, _ = model(batch.to(dev), train=True)
        loss.backward()
        out[dev.type] = (float(loss.detach()),
                         {n: p.grad.cpu() for n, p in
                          model.named_parameters()},
                         dict(counted.launches))
    layers = 3 + (3 if domain == "bio" else 2)  # both trunks, each way
    assert out["cuda"][2] == {k: layers if k in keys else 0
                              for k in out["cuda"][2]}
    assert not any(out["cpu"][2].values())
    assert np.isclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for n, gc in out["cuda"][1].items():
        assert torch.isfinite(gc).all(), n
        assert _rel(gc, out["cpu"][1][n]) <= 1e-3, n


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_contextpred_captured_steps_equal_eager_steps(cuda_device, domain):
    """run_pretrain of context prediction at scan_steps=2 (the graph's
    slots hold pair batches) against scan_steps=1, from the same seed: the
    history and every parameter and buffer bit for bit."""
    graphs = (bio_dataset(160, seed=2) if domain == "bio"
              else molecule_dataset(200, seed=2)[0])
    runs = []
    for k in (1, 2):
        cfg = _packed_cfg(
            objective="contextpred", domain=domain, num_layer=3, csize=2,
            emb_dim=48, batch_size=32, packing="blocked", scan_steps=k,
            context_variants=2)
        runs.append(pretrain.run_pretrain(cfg, graphs, log=None, epochs=3,
                                          device=cuda_device))
    assert runs[1]["replays"] > 0
    assert runs[1]["history"] == runs[0]["history"]
    for name, v in runs[0]["model"].state_dict().items():
        assert torch.equal(runs[1]["model"].state_dict()[name], v), name

# --- transform_device="host": the per-graph transforms' batches ------------

def _host_cfg(objective, domain, **kw):
    return _packed_cfg(
        objective=objective, domain=domain, num_layer=3, csize=2,
        emb_dim=48, batch_size=32, packing="blocked", mask_edge=False,
        transform_device="host", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_host_negatives_through_k3(cuda_device, domain):
    """The per-graph NegativeEdge's pairs, moved into the block slots
    (BlockAlignNegatives), through K3 on the card against its plain
    version (scores and dx; padded slots exactly 0), then one train-mode
    edge-prediction step card vs CPU, K3 launched twice each way; the
    card's loss equals the flat list's on the CPU."""
    graphs = (bio_dataset(64, seed=2) if domain == "bio"
              else molecule_dataset(64, seed=2)[0])
    cfg = _host_cfg("edgepred", domain)
    loader = pretrain.build_loader(cfg, graphs, cuda_device)
    batch = next(iter(loader))
    ex = batch.extras
    assert "negative_edges" not in ex and ex[
        "negative_edges_blocked_mask"].any()
    on_card = batch.to(cuda_device)
    neg = on_card.extras["negative_edges_blocked"]
    m = on_card.extras["negative_edges_blocked_mask"]
    gen = torch.Generator().manual_seed(0)
    h0 = torch.randn(batch.max_nodes, 300, generator=gen)
    g = torch.randn(m.shape[0], generator=gen)
    out = {}
    edge_dot.reset_launches()
    for dev in (cuda_device, torch.device("cpu")):
        h = h0.to(dev).requires_grad_(True)
        s = spmm.edge_dot(h, neg[:, 0].contiguous().to(dev),
                          neg[:, 1].contiguous().to(dev), m.to(dev),
                          batch.block_nodes, batch.block_edges // 2)
        (s * g.to(dev)).sum().backward()
        out[dev.type] = s.detach().cpu(), h.grad.cpu()
    assert dict(edge_dot.launches) == {"blocked_edge_dot_fwd": 1,
                                       "blocked_edge_dot_bwd": 1}
    assert _rel(out["cuda"][0], out["cpu"][0]) <= FWD_TOL
    assert _rel(out["cuda"][1], out["cpu"][1]) <= GRAD_TOL
    assert not out["cuda"][0][~m.cpu()].any()
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = pretrain.build_objective(cfg).to(dev)
        edge_dot.reset_launches()
        loss, _ = model(batch.to(dev), train=True)
        loss.backward()
        res[dev.type] = (float(loss.detach()),
                         {n: p.grad.cpu() for n, p in
                          model.named_parameters()},
                         dict(edge_dot.launches))
    assert res["cuda"][2] == {"blocked_edge_dot_fwd": 2,
                              "blocked_edge_dot_bwd": 2}
    assert not any(res["cpu"][2].values())
    assert np.isclose(res["cuda"][0], res["cpu"][0], rtol=1e-5)
    for n, gc in res["cuda"][1].items():
        assert torch.isfinite(gc).all(), n
        assert _rel(gc, res["cpu"][1][n]) <= 1e-3, n
    loader.set_epoch(0)
    loader.post_transform = None  # the flat list, on the CPU
    flat = next(iter(loader))
    assert "negative_edges" in flat.extras
    with torch.no_grad():
        model = pretrain.build_objective(cfg)
        lf = float(model(flat.to("cpu"), train=True)[0])
    assert np.isclose(res["cuda"][0], lf, rtol=1e-5)


@pytest.mark.cuda
def test_host_context_pair_batch_through_k1(cuda_device):
    """A blocked ContextPairLoader batch (pairs drawn anew, both streams on
    the graphs' geometry): one train-mode step card (K1 in both trunks)
    vs CPU."""
    graphs = molecule_dataset(80, seed=2)[0]
    cfg = _host_cfg("contextpred", "chem")
    loader = pretrain.build_loader(cfg, graphs, cuda_device)
    assert type(loader).__name__ == "ContextPairLoader"
    batch = next(iter(loader))
    assert batch.substruct.layout == batch.context.layout
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = pretrain.build_objective(cfg).to(dev)
        gin_conv.reset_launches()
        loss, _ = model(batch.to(dev), train=True)
        loss.backward()
        out[dev.type] = (float(loss.detach()),
                         {n: p.grad.cpu() for n, p in
                          model.named_parameters()},
                         dict(gin_conv.launches))
    assert out["cuda"][2]["gin_conv_fwd"] == out["cuda"][2][
        "gin_conv_bwd"] == 3 + 2  # both trunks
    assert not any(out["cpu"][2].values())
    assert np.isclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for n, gc in out["cuda"][1].items():
        assert torch.isfinite(gc).all(), n
        assert _rel(gc, out["cpu"][1][n]) <= 1e-3, n


@pytest.mark.cuda
@pytest.mark.parametrize("objective,domain", [("masking", "chem"),
                                              ("edgepred", "bio"),
                                              ("contextpred", "chem")])
def test_host_captured_steps_equal_eager_steps(cuda_device, objective,
                                               domain):
    """run_pretrain under transform_device="host" at scan_steps=2 (every
    host batch keeps the captured slots' shapes) against scan_steps=1:
    the history and every parameter and buffer bit for bit."""
    graphs = (bio_dataset(160, seed=2) if domain == "bio"
              else molecule_dataset(200, seed=2)[0])
    runs = [pretrain.run_pretrain(_host_cfg(objective, domain, scan_steps=k),
                                  graphs, log=None, epochs=3,
                                  device=cuda_device) for k in (1, 2)]
    assert runs[1]["replays"] > 0
    assert runs[1]["history"] == runs[0]["history"]
    for name, v in runs[0]["model"].state_dict().items():
        assert torch.equal(runs[1]["model"].state_dict()[name], v), name


# --- bfloat16: K1, K2 and K3 at compute_dtype bfloat16 and bfloat16 rows ---

# Two readings of |kernel - plain| for each output: the largest over
# max(1, max |plain|) and the mean over mean |plain|. Both sides round at
# the same points and multiply exactly, but a float32 sum taken in another
# order can move a later rounding (a message, aggr, z, a bfloat16 output)
# by one bfloat16 step, 2^-8 of the value: BF16_TOL bounds such a step and
# BF16_MEAN_TOL their share. A variant that skips a rounding (or rounds
# where the plain version does not) moves most entries by about 2^-9: the
# control, the same wrapper at the other compute dtype on the same inputs,
# must read a mean above BF16_MEAN_TOL on some output. Measured on an
# H100: the largest sound readings 2.2e-3, the sound means at most 2.8e-6,
# the control's means at least 1.4e-3.
BF16_TOL = 5e-3
BF16_MEAN_TOL = 2e-5
BF16 = torch.bfloat16
# (rows' dtype, compute dtype): every combination but float32 with float32
BF16_MODES = [(torch.float32, BF16), (BF16, BF16), (BF16, torch.float32)]


def _in(t, dtype, odd_offset=False):
    t = t.to(dtype)
    return _at_odd_offset(t) if odd_offset else t


def _other(cdt):
    return torch.float32 if cdt == BF16 else BF16


def _bf16_readings(got, want):
    d = (got.float() - want.float()).abs()
    scale = float(want.float().abs().mean())
    return (float(d.max()) / max(1.0, float(want.float().abs().max())),
            float(d.mean()) / scale if scale else float(d.mean()))


def _bf16_gate(tag, sound, control, control_shows=True):
    """``sound`` and ``control`` map an output's name to (kernel, plain):
    every sound reading within the limits, and (``control_shows``) the
    control's mean over BF16_MEAN_TOL on some output."""
    got = {n: _bf16_readings(*ab) for n, ab in sound.items()}
    ctl = {n: _bf16_readings(*ab) for n, ab in control.items()}
    print(f"[bf16 readings] {tag} sound "
          f"{ {n: (f'{a:.2e}', f'{b:.2e}') for n, (a, b) in got.items()} } "
          f"control "
          f"{ {n: (f'{a:.2e}', f'{b:.2e}') for n, (a, b) in ctl.items()} }")
    for n, (mx, mean) in got.items():
        assert mx <= BF16_TOL and mean <= BF16_MEAN_TOL, (n, mx, mean)
    if control_shows:
        assert max(mean for _, mean in ctl.values()) > BF16_MEAN_TOL, ctl


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cdt", BF16_MODES)
@pytest.mark.parametrize("F,odd_offset", [(300, False), (45, False),
                                          (300, True)])
def test_k1_bf16_matches_plain_version_and_repeats(cuda_device, rows, cdt,
                                                   F, odd_offset):
    """K1's bfloat16 variants, forward and every gradient, against the
    plain version at the same compute dtype (the Pallas body written out in
    torch), with fractional edge weights, and the control at the other
    compute dtype (``_bf16_gate``); two runs equal bit for bit; out and dx
    in the rows' dtype, aggr and z in the compute dtype, the weight
    gradients float32."""
    t, ein, b, nm, blocks = _case(cuda_device, F, 128, 384, seed=F)
    E = b.senders.shape[0]
    gen = torch.Generator().manual_seed(3)
    w = b.edge_mask.float() * (0.5 + torch.rand(E, generator=gen)).to(
        cuda_device)
    x, g = _in(t["x"], rows, odd_offset), _in(t["g"], rows, odd_offset)
    if odd_offset:  # one element past a pair's alignment
        assert x.data_ptr() % (2 * x.element_size())
    args = (x, ein, t["We"], t["e_self"], t["W1"], t["b1"], t["W2"],
            t["b2"], b.senders, b.receivers, w, nm, blocks[1], blocks[2])

    def run(dt):
        out, aggr, z = gin_conv.gin_conv_fwd(*args, compute_dtype=dt)
        return (out, aggr, z) + gin_conv.gin_conv_bwd(
            g, aggr, z, ein, t["W1"], t["W2"], b.senders, b.receivers, w,
            nm, blocks[1], blocks[2], dt)

    runs = [run(cdt) for _ in range(2)]
    control = run(_other(cdt))
    torch.cuda.synchronize()
    names = ("out", "aggr", "z", "dx", "dWe", "de_self", "dW1", "db1", "dW2",
             "db2")
    for name, a, c in zip(names, *runs):
        assert torch.equal(a, c), name
    out, aggr, z, *grads = runs[0]
    assert out.dtype == rows and grads[0].dtype == rows
    assert aggr.dtype == cdt and z.dtype == cdt
    assert all(d.dtype == torch.float32 for d in grads[1:])
    leaves = [x.detach().clone().requires_grad_(True)] + [
        t[k].detach().clone().requires_grad_(True) for k in DIFF[1:]]
    out_p = gin_conv.fused_gin_conv_plain(leaves[0], ein, *leaves[1:],
                                          *args[8:], compute_dtype=cdt)
    plain = (out_p.detach(),) + torch.autograd.grad(out_p, leaves, g)
    outs = ("out",) + DIFF
    _bf16_gate(f"K1 F={F} rows={rows} cdt={cdt} odd={odd_offset}",
               dict(zip(outs, zip((out,) + tuple(grads), plain))),
               dict(zip(outs, zip(control[:1] + control[3:], plain))))


def _k2_bf16_check(dev, rows, cdt, has_x, has_ein, F, odd_offset,
                   ein_kind="bio", w01=False, bn=128, be=384):
    """K2 at ``cdt`` on ``rows``: out, dx and dW against the plain version
    at the same compute dtype, and the control at the other
    (``_bf16_gate``), bit-equal between two runs, padded rows exactly 0.
    ``ein_kind``: the bio batch's ``[edge_feat | 1]`` (K = 10), or K = 16
    edge inputs with 30% of the entries set (``k16``), with 5% set and
    every third slot's row all 0 (``sparse``), or all 0 (``zero``);
    ``w01``: the path's 0/1 edge weights instead of fractional, partly
    negative ones; ``bn``, ``be``: the blocks' nodes and edge slots."""
    t, b, blocks = _k2_case(dev, F, bn, be)
    x, g = _in(t["x"], rows, odd_offset), _in(t["g"], rows, odd_offset)
    ein, W, w = t["ein"], t["W"], t["w"]
    if ein_kind != "bio":
        gen = torch.Generator().manual_seed(5)
        E = ein.shape[0]
        share = {"k16": 0.3, "sparse": 0.05, "zero": 0.0}[ein_kind]
        ein = ((torch.rand(E, 16, generator=gen) < share).float()
               * torch.randn(E, 16, generator=gen))
        if ein_kind == "sparse":
            ein[::3] = 0
        ein = ein.to(dev)
        W = torch.randn(16, F, generator=gen).to(dev)
    if w01:
        w = b.edge_mask.float()

    def run(dt):
        out = blocked_spmm.spmm_fwd(x, ein, W, b.senders, b.receivers, w,
                                    bn, be, has_x, has_ein, dt)
        dx, dW = blocked_spmm.spmm_bwd(g, ein, b.senders, b.receivers, w,
                                       W.shape[0], bn, be, has_x, has_ein,
                                       dt)
        return out, dx, dW

    runs = [run(cdt) for _ in range(2)]
    control = run(_other(cdt))
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert (a is None and c is None) or torch.equal(a, c)
    out, dx, dW = runs[0]
    assert out.dtype == rows and not out[~b.node_mask].any()
    xl = x.detach().clone().requires_grad_(True)
    Wl = W.detach().clone().requires_grad_(True)
    out_p = blocked_spmm.blocked_spmm_fused_plain(
        xl, ein, Wl, b.senders, b.receivers, w, bn, be, has_x, has_ein, cdt)
    dx_p, dW_p = torch.autograd.grad(out_p, [xl, Wl], g, allow_unused=True)
    if has_x:
        assert dx.dtype == rows
    if has_ein:
        assert dW.dtype == torch.float32
    outs = [n for n, f in (("out", True), ("dx", has_x), ("dW", has_ein))
            if f]
    plain = dict(zip(("out", "dx", "dW"), (out_p.detach(), dx_p, dW_p)))
    # the two compute dtypes agree where nothing is rounded: a 0/1 weight
    # times a bfloat16 row, or no edge input and no x
    shows = not ((w01 and rows == BF16 and not has_ein)
                 or (ein_kind == "zero" and not has_x))
    _bf16_gate(f"K2 x={has_x} ein={has_ein} F={F} rows={rows} cdt={cdt} "
               f"odd={odd_offset} ein={ein_kind} w01={w01}",
               {n: (k, plain[n]) for n, k in zip(("out", "dx", "dW"),
                                                  runs[0]) if n in outs},
               {n: (k, plain[n]) for n, k in zip(("out", "dx", "dW"),
                                                  control) if n in outs},
               control_shows=shows)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cdt", BF16_MODES)
@pytest.mark.parametrize("has_x,has_ein", K2_VARIANTS)
@pytest.mark.parametrize("F,odd_offset", [(300, False), (45, False),
                                          (300, True), (302, False)])
def test_k2_bf16_matches_plain_version_and_repeats(cuda_device, rows, cdt,
                                                   has_x, has_ein, F,
                                                   odd_offset):
    """K2's bfloat16 variants with fractional, partly negative (GCN-like)
    edge weights: out, dx and dW against the plain version at the same
    compute dtype, and the control at the other (``_bf16_gate``),
    bit-equal between two runs, padded rows exactly 0. F = 300 takes four
    features a lane (its last 128-wide tile partial), 302 two, 45 one."""
    _k2_bf16_check(cuda_device, rows, cdt, has_x, has_ein, F, odd_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cdt", BF16_MODES)
@pytest.mark.parametrize("has_x,has_ein", K2_VARIANTS)
@pytest.mark.parametrize("ein_kind,w01", [("k16", False), ("sparse", False),
                                          ("zero", False), ("bio", True),
                                          ("sparse", True)])
def test_k2_bf16_edge_inputs_and_weights(cuda_device, rows, cdt, has_x,
                                         has_ein, ein_kind, w01):
    """K2's bfloat16 variants at F = 300 at the redesign's edges: K = 16
    (AGG_MAX_K) edge inputs, mostly or wholly zero ones with all-zero rows
    (the forward skips the zero bf(w ein_k)), and the masking paths' 0/1
    edge weights beside fractional, negative ones; as
    ``test_k2_bf16_matches_plain_version_and_repeats`` checks them."""
    _k2_bf16_check(cuda_device, rows, cdt, has_x, has_ein, 300, False,
                   ein_kind, w01)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cdt", BF16_MODES)
@pytest.mark.parametrize("has_x,has_ein", K2_VARIANTS)
def test_k2_bf16_large_blocks(cuda_device, rows, cdt, has_x, has_ein):
    """K2's bfloat16 variants on blocks of 512 nodes and 1,536 edge slots:
    six staged passes a block, 64 rows a warp, and four features a lane
    where shared memory allows; as
    ``test_k2_bf16_matches_plain_version_and_repeats`` checks them."""
    _k2_bf16_check(cuda_device, rows, cdt, has_x, has_ein, 300, False,
                   bn=512, be=1536)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cdt", BF16_MODES)
@pytest.mark.parametrize("head", ["pos", "neg"])
@pytest.mark.parametrize("F,odd_offset", [(300, False), (45, False),
                                          (300, True)])
def test_k3_bf16_matches_plain_version_and_repeats(cuda_device, rows, cdt,
                                                   head, F, odd_offset):
    """K3's bfloat16 variants with fractional weights and a self-pair:
    float32 scores and dx in the rows' dtype against the plain version at
    the same compute dtype, and the control at the other
    (``_bf16_gate``), bit-equal between two runs."""
    x, a_idx, b_idx, w, g, b, bn, ppb = _k3_case(cuda_device, F, 128, 384,
                                                 head, fractional=True)
    x = _in(x, rows, odd_offset)

    def run(dt):
        return (edge_dot.edot_fwd(x, a_idx, b_idx, w, bn, ppb, dt),
                edge_dot.edot_bwd(g, x, a_idx, b_idx, w, bn, ppb, dt))

    runs = [run(cdt) for _ in range(2)]
    control = run(_other(cdt))
    torch.cuda.synchronize()
    (out, dx), (out2, dx2) = runs
    assert torch.equal(out, out2) and torch.equal(dx, dx2)
    assert out.dtype == torch.float32 and dx.dtype == rows
    xl = x.detach().clone().requires_grad_(True)
    out_p = edge_dot.edge_dot_plain(xl, a_idx, b_idx, w,
                                    compute_dtype=cdt)
    (dx_p,) = torch.autograd.grad(out_p, [xl], g)
    plain = (out_p.detach(), dx_p)
    _bf16_gate(f"K3 {head} F={F} rows={rows} cdt={cdt} odd={odd_offset}",
               dict(zip(("score", "dx"), zip(runs[0], plain))),
               dict(zip(("score", "dx"), zip(control, plain))))
    assert not out[w == 0].any()


# K4 and K5 at the GAT paths' own shape (D = 300, blocks of 128 / 384), an
# odd width, fractional edge weights and a width of two 320-feature chunks
# (every case's last two blocks hold no valid slot, see _gat_case)
GAT_BF16_SHAPES = [(300, "onehot"), (45, "onehot"), (300, "frac"),
                   (333, "K1")]
# ... and for K4's bfloat16 walks, the widest edge input (K = MAX_K = 16,
# dense) and one and three heads
K4_BF16_SHAPES = ([(D, v, H) for D, v in GAT_BF16_SHAPES]
                  + [(300, "K16", H), (300, "onehot", 1), (300, "onehot", 3)])


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["chem", "bio"])
@pytest.mark.parametrize("D,variant,heads", K4_BF16_SHAPES)
def test_k4_bf16_matches_plain_version_and_repeats(cuda_device, domain, D,
                                                   variant, heads):
    """K4's bfloat16 variant: out, the bfloat16 residual x and the eight
    gradients against the plain version at compute_dtype=bfloat16, and the
    control at float32 (``_bf16_gate``); two runs equal bit for bit;
    nothing is NaN; padded slots get alpha 0 (in the float32 control).
    Each direction is held against its plain version on the same inputs:
    the gradients against ``gat_conv_bwd_plain`` on the kernel's residual.
    The residual's float32 sums (the tie fixup's k-ordered chain, cuBLAS's
    own order) round apart on a few dozen entries at some shapes, and a few
    dozen such entries move the gradients' mean error by up to 9e-5
    (scripts/torch_port_k4_bf16_witness.py: on its own residual the plain
    version's reads up to 4e-5 against the same function in float64)."""
    t, ein, b, bn, be = _gat_case(cuda_device, domain, D, 128, 384,
                                  variant=variant, heads=heads)
    graph = (b.senders, b.receivers, t["w"])

    def run(dt):
        out, x, saved = gat_conv.gat_conv_fwd(
            t["h"], t["Wl"], t["bl"], ein, t["We"], t["e_self"], t["a_i"],
            t["a_j"], t["bias"], *graph, bn, be, compute_dtype=dt)
        return (out, x) + gat_conv.gat_conv_bwd(
            t["g"], t["h"], t["Wl"], x, ein, t["We"], t["e_self"], t["a_i"],
            t["a_j"], *graph, saved, bn, be, compute_dtype=dt)

    before = dict(gat_conv.launches)
    runs = [run(BF16) for _ in range(2)]
    control = run(torch.float32)
    torch.cuda.synchronize()
    assert gat_conv.launches == {k: v + 3 for k, v in before.items()}
    names = ("out", "x") + GAT_GRADS
    for n, a, c in zip(names, *runs):
        assert torch.equal(a, c), n
        assert torch.isfinite(a.float()).all(), n
    assert runs[0][1].dtype == BF16 and runs[0][0].dtype == torch.float32
    args = (ein, t["We"], t["e_self"], t["a_i"], t["a_j"])
    with torch.no_grad():
        out_p, x_p = gat_conv.fused_gat_conv_plain(
            t["h"], t["Wl"], t["bl"], *args, t["bias"], *graph, heads,
            return_residuals=True, compute_dtype=BF16)
        plain = (out_p, x_p) + gat_conv.gat_conv_bwd_plain(
            t["g"], t["h"], t["Wl"], runs[0][1], *args, *graph, heads)
    _bf16_gate(f"K4 {domain} D={D} {variant} H={heads}",
               dict(zip(names, zip(runs[0], plain))),
               dict(zip(names, zip(control, plain))))


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["chem", "bio"])
@pytest.mark.parametrize("D,variant,heads", [(300, "onehot", H),
                                             (300, "frac", H),
                                             (300, "onehot", 3),
                                             (333, "K1", H)])
def test_k4_bf16_saved_softmax_is_the_residuals(cuda_device, domain, D,
                                                 variant, heads):
    """K4's bfloat16 forward saves the softmax that the Pallas backward
    recomputes from the residual bf(x): alpha and aself against the plain
    version's p / den and p_self / den on the returned residual (float32
    rounding apart), the LeakyReLU slopes dlr and dls exactly (but where
    the logit lies within rounding of 0), padded slots' alpha and dlr
    exactly 0; the backward reads them and the saved rounded h and Wl
    (``saved[4]``: bf(h) then bf(Wl), as torch rounds them) and gives the
    same bits twice. (scripts/torch_port_bits_ab.py holds the gradients bit
    for bit against a checkout whose backward recomputes these scalars.)"""
    t, ein, b, bn, be = _gat_case(cuda_device, domain, D, 128, 384,
                                  variant=variant, heads=heads)
    graph = (b.senders, b.receivers, t["w"])
    args = (t["We"], t["e_self"], t["a_i"], t["a_j"])
    out, x, saved = gat_conv.gat_conv_fwd(
        t["h"], t["Wl"], t["bl"], ein, *args, t["bias"], *graph, bn, be,
        compute_dtype=BF16)
    alpha, aself, dlr, dls, r16 = saved
    assert r16.dtype == BF16 and alpha.shape == (b.max_edges, heads)
    N, Din = t["h"].shape
    pad = lambda n: (n + 7) // 8 * 8
    h16 = r16[:N * pad(Din)].reshape(N, pad(Din))[:, :Din]
    assert torch.equal(h16, t["h"].to(BF16))
    # the plain version's softmax on the residual, as its backward forms it
    xr = x.float().reshape(N, heads, D)
    e = (_build.round_bf16(ein) @ _build.round_bf16(t["We"])).reshape(
        -1, heads, D)
    _, raw, sraw, p, p_self, den = gat_conv._k4_pieces(
        xr, e, t["e_self"], t["a_i"], t["a_j"], *graph, 0.2)
    rcv = b.receivers.long()
    want_alpha = p / torch.clamp(den[rcv], min=1e-30)
    valid = t["w"] > 0
    assert not alpha[~valid].any() and not dlr[~valid].any()
    # the kernel sums each logit's edge term as ein . (We a_j), the plain
    # version as (ein @ We) . a_j: float32 rounding apart, which exp
    # magnifies by the logit's size
    assert torch.allclose(alpha, want_alpha, rtol=1e-4, atol=1e-6)
    assert torch.allclose(aself, p_self / den, rtol=1e-4, atol=1e-6)
    near0 = raw.abs() <= 1e-5 * (1 + raw.abs())
    slope = attention.leaky_slope(raw, 0.2)
    assert torch.equal(dlr[valid & ~near0.any(1)],
                       slope[valid & ~near0.any(1)])
    snear0 = (sraw.abs() <= 1e-5 * (1 + sraw.abs())).any(1)
    assert torch.equal(dls[~snear0],
                       attention.leaky_slope(sraw, 0.2)[~snear0])
    back = lambda: gat_conv.gat_conv_bwd(
        t["g"], t["h"], t["Wl"], x, ein, *args, *graph, saved, bn, be,
        compute_dtype=BF16)
    first, second = back(), back()
    torch.cuda.synchronize()
    for n, a, c in zip(GAT_GRADS, first, second):
        assert torch.equal(a, c), n


@pytest.mark.cuda
@pytest.mark.parametrize("erows", [torch.float32, BF16])
@pytest.mark.parametrize("domain", ["chem", "bio"])
@pytest.mark.parametrize("D,variant", GAT_BF16_SHAPES)
def test_k5_bf16_matches_plain_version_and_repeats(cuda_device, domain, D,
                                                   variant, erows):
    """K5's bfloat16 variant on x (float32, as the unfused conv widens it)
    and e (float32, or bfloat16 as the bio encoder gives it under
    bfloat16_act) through its autograd Function: out and the five
    gradients against the plain version at compute_dtype=bfloat16, and
    the control at float32; two runs bit-equal; padded slots' de exactly
    0."""
    t, ein, b, bn, be = _gat_case(cuda_device, domain, D, 128, 384, seed=1,
                                  variant=variant)
    x, e = _k5_inputs(t, ein, D)
    e = e.to(erows)
    par = (t["e_self"], t["a_i"], t["a_j"])
    graph = (b.senders, b.receivers, t["w"])

    def run(dt, fn=attention.blocked_gat_attention, **kw):
        leaves = [v.detach().clone().requires_grad_(True)
                  for v in (x, e, *par)]
        out = fn(*leaves, *graph, 0.2, bn, be, **kw, compute_dtype=dt)
        return (out.detach(),) + torch.autograd.grad(out, leaves, t["g3"])

    before = dict(attention.launches)
    runs = [run(BF16) for _ in range(2)]
    control = run(torch.float32)
    torch.cuda.synchronize()
    assert attention.launches == {k: v + 3 for k, v in before.items()}
    names = ("out", "dx", "de", "de_self", "da_i", "da_j")
    for n, a, c in zip(names, *runs):
        assert torch.equal(a, c), n
    assert runs[0][2].dtype == erows
    assert not runs[0][2][~b.edge_mask].any()
    plain = run(BF16, attention.blocked_gat_attention_plain)
    _bf16_gate(f"K5 {domain} D={D} {variant} e={erows}",
               dict(zip(names, zip(runs[0], plain))),
               dict(zip(names, zip(control, plain))))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cdt", BF16_MODES)
@pytest.mark.parametrize("has_ee", [True, False])
@pytest.mark.parametrize("F,odd_offset", [(300, False), (45, False),
                                          (300, True)])
def test_k6_bf16_matches_plain_version_and_repeats(cuda_device, rows, cdt,
                                                   has_ee, F, odd_offset):
    """K6's bfloat16 variants with fractional and negative edge weights and
    runs of 45 slots: out, dx and dmsg in the rows' dtype against the plain
    version at the same compute dtype, and the control at the other
    (``_bf16_gate``); two runs and dx and dmsg alone bit-equal; padded rows
    and slots exactly 0."""
    t, b, blocks = _k6_case(cuda_device, F, 128, 384)
    b = _long_runs(b, 384, 45)
    x, g = _in(t["x"], rows, odd_offset), _in(t["g"], rows, odd_offset)
    ee = _in(t["ee"], rows, odd_offset) if has_ee else None
    edges = (b.senders, b.receivers, t["w"], 128, 384)

    def run(dt):
        out = blocked_spmm.spmm_ee_fwd(x, ee, *edges, compute_dtype=dt)
        return (out,) + blocked_spmm.spmm_ee_bwd(g, *edges, has_ee, True,
                                                 has_ee, compute_dtype=dt)

    runs = [run(cdt) for _ in range(2)]
    control = run(_other(cdt))
    dx_alone = blocked_spmm.spmm_ee_bwd(g, *edges, has_ee, True, False,
                                        compute_dtype=cdt)[0]
    torch.cuda.synchronize()
    out, dx, dmsg = runs[0]
    for a, c in zip(*runs):
        assert (a is None and c is None) or torch.equal(a, c)
    assert torch.equal(dx_alone, dx)
    assert out.dtype == rows and dx.dtype == rows
    assert not out[~b.node_mask].any() and not dx[~b.node_mask].any()
    if has_ee:
        dmsg_alone = blocked_spmm.spmm_ee_bwd(g, *edges, has_ee, False, True,
                                              compute_dtype=cdt)[1]
        assert torch.equal(dmsg_alone, dmsg) and dmsg.dtype == rows
        assert not dmsg[~b.edge_mask].any()
    xl = x.detach().clone().requires_grad_(True)
    el = ee.detach().clone().requires_grad_(True) if has_ee else None
    out_p = blocked_spmm.blocked_spmm_plain(xl, el, *edges[:3],
                                            compute_dtype=cdt)
    dx_p, dee_p = torch.autograd.grad(out_p, [xl, el] if has_ee else [xl],
                                      g) + ((None,) if not has_ee else ())
    names = ("out", "dx", "dmsg")
    plain = (out_p.detach(), dx_p, dee_p)
    keep = lambda o: {n: (a, p) for n, a, p in zip(names, o, plain)
                      if p is not None}
    _bf16_gate(f"K6 ee={has_ee} F={F} rows={rows} cdt={cdt} "
               f"odd={odd_offset}", keep(runs[0]), keep(control))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cdt", BF16_MODES)
@pytest.mark.parametrize("has_ee", [True, False])
@pytest.mark.parametrize("F,odd_offset", [(300, False), (45, False),
                                          (300, True)])
def test_k7_bf16_matches_plain_version_and_repeats(cuda_device, rows, cdt,
                                                   has_ee, F, odd_offset):
    """K7's bfloat16 variants on the per-block sorted slots with fractional
    and negative weights: out in the rows' dtype against the plain version
    at the same compute dtype, the control at the other
    (``_bf16_gate``), two runs bit-equal, padded rows exactly 0."""
    t, b, blocks = _k6_case(cuda_device, F, 128, 384)
    s2, r2, w2, ee2 = sorted_spmm.sort_block_edges(
        b.senders, b.receivers, t["w"], t["ee"] if has_ee else None,
        blocks[0], 384)
    x = _in(t["x"], rows, odd_offset)
    ee2 = None if ee2 is None else _in(ee2, rows, odd_offset)
    run = lambda dt: sorted_spmm.sorted_blocked_spmm(
        x, ee2, s2, r2, w2, 128, 384, compute_dtype=dt)
    out, out2, control = run(cdt), run(cdt), run(_other(cdt))
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and out.dtype == rows
    assert not out[~b.node_mask].any()
    plain = sorted_spmm.sorted_blocked_spmm_plain(x, ee2, s2, r2, w2,
                                                  compute_dtype=cdt)
    # on bfloat16 rows K7's one rounding (of x) is a no-op, so its two
    # compute dtypes give one function there: no control can show
    _bf16_gate(f"K7 ee={has_ee} F={F} rows={rows} cdt={cdt} "
               f"odd={odd_offset}", {"out": (out, plain)},
               {"out": (control, plain)}, control_shows=rows != BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["add", "concat"])
def test_gather_scatter_edge_emb_runs_k6_bf16_under_the_knob(cuda_device,
                                                             combine):
    """With the kernels' knob at bfloat16, ``gather_scatter(edge_emb=)``
    launches K6 (the concat form also K2 ``[x]``) at compute_dtype=bfloat16:
    the result and its gradients equal the wrappers called with
    compute_dtype=bfloat16, and differ from the float32 knob's."""
    t, b, blocks = _k6_case(cuda_device, 32, 128, 384, seed=2)
    graph = (b.senders, b.receivers, b.edge_mask, b.max_nodes)
    ew = t["w"].abs() + 0.5
    w = b.edge_mask.float() * ew
    layout = dict(block_nodes=blocks[1], block_edges=blocks[2])

    def run(fn):
        x = t["x"].detach().clone().requires_grad_(True)
        ee = t["ee"].detach().clone().requires_grad_(True)
        out = fn(x, ee)
        out.backward(torch.ones_like(out) * 0.5 + out.detach() * 0.1)
        return out.detach(), x.grad, ee.grad

    def via_knob(x, ee):
        return spmm.gather_scatter(x, *graph, edge_emb=ee, combine=combine,
                                   edge_weight=ew, **layout)

    def direct(x, ee):
        k6 = lambda a, e: blocked_spmm.blocked_spmm(
            a, e, b.senders, b.receivers, w, blocks[1], blocks[2], BF16)
        if combine == "add":
            return k6(x, ee)
        left = blocked_spmm.blocked_spmm_fused(
            x, None, None, b.senders, b.receivers, w, blocks[1], blocks[2],
            True, False, BF16)
        return torch.cat([left, k6(x.new_zeros((x.shape[0], ee.shape[1])),
                                   ee)], dim=-1)

    spmm.set_compute_dtype("bfloat16")
    try:
        before = dict(blocked_spmm.launches)
        got = run(via_knob)
        moved = {k: v - before[k] for k, v in blocked_spmm.launches.items()
                 if v != before[k]}
    finally:
        spmm.set_compute_dtype("float32")
    want = {"blocked_spmm_ee_fwd[x+ee]": 1, "blocked_spmm_ee_bwd[x+ee]": 1}
    if combine == "concat":
        want.update({"blocked_spmm_fwd[x]": 1, "blocked_spmm_bwd[x]": 1})
    assert moved == want
    ref, f32 = run(direct), run(via_knob)
    torch.cuda.synchronize()
    for a, r, c in zip(got, ref, f32):
        assert torch.equal(a, r)
        assert not torch.equal(a, c)


# --- fine-tuning: forwards under no_grad, eval batches with empty blocks -------


@pytest.mark.cuda
@pytest.mark.parametrize("grad", ["no_grad", "no_input_needs_grad"])
def test_k1_k4_forward_alone_where_autograd_records_nothing(cuda_device,
                                                            grad):
    """Under ``torch.no_grad()``, or with no input that needs a gradient,
    K1's and K4's autograd Functions launch their forward alone (no
    backward count, an output without ``grad_fn``) and give the output of
    a call that records a gradient bit for bit."""
    t, ein, b, nm, blocks = _case(cuda_device, 40, 64, 192, seed=3)
    args = (t["x"], ein, t["We"], t["e_self"], t["W1"], t["b1"], t["W2"],
            t["b2"], b.senders, b.receivers, b.edge_mask.float(), nm,
            blocks[1], blocks[2])
    g, gein, gb, gbn, gbe = _gat_case(cuda_device, "chem", 45, 128, 384)
    gargs = (g["h"], g["Wl"], g["bl"], gein, g["We"], g["e_self"],
             g["a_i"], g["a_j"], g["bias"], *_graph(gb), H, gbn, gbe)
    with_grad = [fn(*(a.detach().clone().requires_grad_(True)
                      if i == 0 else a for i, a in enumerate(xs)))
                 for fn, xs in ((gin_conv.fused_gin_conv, args),
                                (gat_conv.fused_gat_conv, gargs))]
    gin_conv.reset_launches()
    gat_conv.reset_launches()
    ctx = torch.no_grad() if grad == "no_grad" else contextlib.nullcontext()
    with ctx:
        alone = [gin_conv.fused_gin_conv(*args),
                 gat_conv.fused_gat_conv(*gargs)]
    assert gin_conv.launches["gin_conv_fwd"] == 1
    assert gin_conv.launches["gin_conv_bwd"] == 0
    assert gat_conv.launches["gat_conv_fwd"] == 1
    assert gat_conv.launches["gat_conv_bwd"] == 0
    for a, w in zip(alone, with_grad):
        assert a.grad_fn is None and not a.requires_grad
        assert torch.equal(a, w.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("domain,gnn_type", [("chem", "gin"), ("bio", "gin"),
                                             ("chem", "gat")])
def test_finetune_step_and_eval_on_card_match_cpu(cuda_device, domain,
                                                  gnn_type):
    """A small fine-tune model (dropout 0) on blocked batches of 16
    graphs: one train step (loss, gradients, batch-norm statistics) and
    an eval pass (the initial weights, the step's statistics) over a
    loader whose last batch is partly empty and holds blocks without a
    node, card vs CPU; the eval pass launches forwards only."""
    from pretrain_gnns_tpu_torch.train import finetune

    if domain == "bio":
        graphs = bio_dataset(60, seed=4, mean_nodes=20)
    else:
        graphs, _ = molecule_dataset(60, num_tasks=3, seed=4,
                                     missing_frac=0.2)
    cfg = finetune.FinetuneConfig(
        domain=domain, num_tasks=int(np.asarray(graphs[0].y).shape[0]),
        num_layer=3, emb_dim=48, dropout_ratio=0.0, gnn_type=gnn_type,
        batch_size=16, packing="blocked")
    train_loader, evals = finetune.build_loaders(
        cfg, graphs[:40], graphs[40:], graphs[40:], None, cuda_device)
    first, val = next(iter(train_loader)), list(evals["val"])
    last = val[-1]
    assert not last.graph_mask.all()
    assert not last.node_mask.reshape(-1, last.block_nodes).any(1).all()
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        for m in (gin_conv, blocked_spmm, gat_conv):
            m.reset_launches()
        st = finetune.init_state(cfg, finetune.build_model(cfg), None, dev)
        loss = finetune.make_train_step(cfg.loss_kind)(st, first.to(dev))
        step_counts = {**gin_conv.launches, **blocked_spmm.launches,
                       **gat_conv.launches}
        # the eval pass: the initial weights (the step's Adam update moves
        # a parameter by lr times the sign of a gradient that may be ~0,
        # so updated weights differ by ~lr) and the step's batch-norm
        # statistics
        st_eval = finetune.init_state(cfg, finetune.build_model(cfg), None,
                                      dev)
        st_eval.model.load_state_dict(dict(st.model.named_buffers()),
                                      strict=False)
        logits = [finetune.make_eval_step()(st_eval, b.to(dev)).cpu()
                  for b in val]
        eval_counts = {k: v - step_counts[k] for k, v in {
            **gin_conv.launches, **blocked_spmm.launches,
            **gat_conv.launches}.items()}
        out.append((float(loss),
                    {n: p.grad.cpu() for n, p in st.model.named_parameters()},
                    {n: x.cpu().float() for n, x in st.model.named_buffers()},
                    torch.cat(logits), step_counts, eval_counts))
    (lc, gc, bc, oc, sc, ec), (lp, gp, bp, op, _, _) = out
    assert np.isclose(lc, lp, rtol=1e-5), (lc, lp)
    errs = {n: _rel(gc[n], gp[n]) for n in gp}
    assert max(errs.values()) <= 1e-3, errs
    errs = {n: _rel(bc[n], bp[n]) for n in bp}
    assert max(errs.values()) <= 1e-3, errs
    mask = torch.cat([torch.as_tensor(b.graph_mask).cpu() for b in val])
    assert _rel(oc[mask], op[mask]) <= 1e-4, _rel(oc[mask], op[mask])
    per = 3 * (2 if domain == "bio" else 1)
    assert sum(sc.values()) == 2 * per, sc
    assert sum(ec.values()) == len(val) * per, (len(val), ec)
    assert all(v == 0 for k, v in ec.items() if "_bwd" in k), ec


def _equal_states(a, b):
    """Two ``TrainState.state_dict()``s bit for bit: the parameters and
    batch-norm statistics, Adam's moments and steps, the step, the epoch
    and the dropout generators' states."""
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"])
    for name, v in a["model"].items():
        assert torch.equal(b["model"][name], v), name
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for key, v in sa[i].items():
            assert torch.equal(sb[i][key], v), (i, key)
    assert a["dropout"].keys() == b["dropout"].keys()
    for name, states in a["dropout"].items():
        assert states.keys() == b["dropout"][name].keys()
        for dev, v in states.items():
            assert torch.equal(b["dropout"][name][dev], v), (name, dev)


def _supervised_run(graphs, T, dev, epochs, **kw):
    cfg = _packed_cfg(
        objective="supervised", num_layer=3, emb_dim=48, batch_size=32,
        packing="blocked", scan_steps=4, num_tasks=T, graph_pooling="mean",
        dropout_ratio=0.2)
    return pretrain.run_pretrain(cfg, graphs, log=kw.pop("log", None),
                                 epochs=epochs, device=dev, **kw)


@pytest.mark.cuda
def test_resume_under_replays_equals_the_uninterrupted_run(cuda_device,
                                                           tmp_path):
    """Chem supervised GIN at dropout 0.2, scan_steps 4, 8 batches an
    epoch: 3 epochs in one run against 2 epochs with a checkpoint each
    epoch and a fresh run to 3 from the same directory. Both parts capture
    and replay, so the dropout generator's saved state is its state after
    replays, and the resumed run registers the restored generator with its
    own capture. Everything bit for bit, the history of epoch 3 too."""
    graphs, _ = molecule_dataset(256, num_tasks=5, seed=2, missing_frac=0.2)
    graphs, T = pretrain.supervised_graphs(graphs, "chem")
    whole = _supervised_run(graphs, T, cuda_device, 3)
    ck = str(tmp_path / "ck")
    first = _supervised_run(graphs, T, cuda_device, 2, checkpoint_dir=ck,
                            checkpoint_every=1)
    logs = []
    resumed = _supervised_run(graphs, T, cuda_device, 3, checkpoint_dir=ck,
                              checkpoint_every=1, log=logs.append)
    assert first["replays"] and resumed["replays"]
    assert "resumed from step 16 (epoch 3)" in logs
    assert resumed["history"] == whole["history"][2:]
    _equal_states(whole["state"].state_dict(), resumed["state"].state_dict())
    assert whole["state"].state_dict()["dropout"]["pred.gnn"]


@pytest.mark.cuda
def test_a_card_checkpoint_continues_on_the_cpu(cuda_device, tmp_path):
    """Two epochs on the card with a checkpoint, then a CPU run to epoch 3
    from the same directory: the card's capturable Adam groups do not come
    along (capturable Adam raises on CPU parameters), the moments and the
    steps do, and the run trains on."""
    graphs, _ = molecule_dataset(256, num_tasks=5, seed=2, missing_frac=0.2)
    graphs, T = pretrain.supervised_graphs(graphs, "chem")
    ck = str(tmp_path / "ck")
    card = _supervised_run(graphs, T, cuda_device, 2, checkpoint_dir=ck)
    assert all(g["capturable"] for g in card["state"].optimizer.param_groups)
    saved = card["state"].state_dict()
    logs = []
    cpu = _supervised_run(graphs, T, "cpu", 3, checkpoint_dir=ck,
                          log=logs.append)
    assert "resumed from step 16 (epoch 3)" in logs
    assert not any(g["capturable"] for g in cpu["state"].optimizer.param_groups)
    assert cpu["state"].step == 24 and [h["epoch"]
                                       for h in cpu["history"]] == [3]
    assert np.isfinite(cpu["history"][0]["loss"])
    # the CPU run started from the card's moments and parameters
    restored = torch.load(f"{ck}/step_{16:09d}.pt", map_location="cpu",
                          weights_only=True)
    for name, v in saved["model"].items():
        assert torch.equal(restored["model"][name], v.cpu()), name

# --- the device-resident dataset ---------------------------------------------

def _resident_cfg(objective="masking", domain="chem", **kw):
    return _packed_cfg(
        objective=objective, domain=domain, num_layer=2, emb_dim=32,
        batch_size=16, seed=0, packing="auto", csize=2, device_dataset="on",
        **kw)


def _resident_graphs(domain, n=96):
    if domain == "bio":
        return bio_dataset(n, seed=1)
    return molecule_dataset(n, seed=1)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("objective,domain,kw", [
    ("masking", "chem", dict(mask_edge=True)),
    ("masking", "bio", {}),
    ("edgepred", "chem", {}),
    ("supervised", "bio", {}),
    ("contextpred", "chem", {}),
])
def test_materialize_on_card_equals_cpu(cuda_device, objective, domain, kw):
    """Each descriptor of an epoch, built into its batch on the card and by
    ``materialize`` on the CPU from the same resident arrays: every leaf
    and extra equal bit for bit, blocked on chunk multiples."""
    import copy

    graphs = _resident_graphs(domain)
    if objective == "supervised":
        graphs, tasks = pretrain.supervised_graphs(graphs, domain)
        kw = dict(kw, num_tasks=tasks)
    loader = pretrain.build_loader(_resident_cfg(objective, domain, **kw),
                                   graphs, cuda_device)
    assert type(loader).__name__.startswith("Device")
    twin = copy.copy(loader)
    twin.dev = {k: v.cpu() for k, v in loader.dev.items()}
    n = 0
    for desc in loader:
        card = loader.prepare(desc.to(cuda_device)).leaves()
        cpu = twin.prepare(desc.to("cpu")).leaves()
        assert sorted(card) == sorted(cpu)
        for name, v in card.items():
            assert v.is_cuda and v.dtype == cpu[name].dtype, name
            assert torch.equal(v.cpu(), cpu[name]), name
        n += 1
    assert n > 1


@pytest.mark.cuda
def test_mask_stream_advances_across_replays(cuda_device):
    """``FusedMaskingObjective`` under a capture at lr 0 (only the masks
    move the loss): two replays on the same descriptors draw different
    masks, and a rerun from the same seed repeats both bit for bit."""
    from pretrain_gnns_tpu_torch.train import graphed, optim
    from pretrain_gnns_tpu_torch.train.state import TrainState

    cfg = _resident_cfg(transform_device="device", lr=0.0)
    loader = pretrain.build_loader(cfg, _resident_graphs("chem"),
                                   cuda_device)
    descs = [d.to(cuda_device) for d, _ in zip(loader, range(4))]

    def run():
        model = pretrain.build_objective(cfg).to(cuda_device)
        st = TrainState(model, optim.adam(model.parameters(), 0.0, 0.0))
        scan = pretrain.make_scan_pretrain_step(st, descs[0], 4,
                                                loader.prepare)
        for d in descs[:graphed.WARMUP_STEPS]:
            scan.step(d)
        return [scan(descs)[0].cpu() for _ in range(2)]

    first, again = run(), run()
    assert not torch.equal(first[0], first[1])
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_device_drawn_negatives_go_through_k3(cuda_device):
    """Bio edge prediction with the negatives drawn in the step: the batch
    carries none, the pairs lie in their blocks' slots with the sampler's
    properties, and a step launches K3 on both heads."""
    from pretrain_gnns_tpu_torch.objectives.edgepred import (
        sample_negative_edges,
    )

    cfg = _resident_cfg("edgepred", "bio", transform_device="device")
    loader = pretrain.build_loader(cfg, _resident_graphs("bio"), cuda_device)
    batch = loader.prepare(next(iter(loader)).to(cuda_device))
    assert not {"negative_edges", "negative_edges_blocked"} & set(
        batch.extras)
    pairs, mask = sample_negative_edges(
        batch, torch.Generator(device=cuda_device).manual_seed(0))
    pairs, mask = pairs.cpu().numpy(), mask.cpu().numpy()
    b = batch._map(lambda t: t.cpu())
    a_, b_ = (pairs[mask, i].astype(np.int64) for i in (0, 1))
    ng = b.node_graph.numpy()
    em = b.edge_mask.numpy()
    N, half = b.max_nodes, b.block_edges // 2
    keys = a_ * N + b_
    edges = set((b.senders.numpy()[em].astype(np.int64) * N
                 + b.receivers.numpy()[em]).tolist())
    block = np.nonzero(mask)[0] // half
    assert mask.any() and (a_ != b_).all() and (ng[a_] == ng[b_]).all()
    assert b.node_mask.numpy()[a_].all() and b.node_mask.numpy()[b_].all()
    assert len(set(keys.tolist())) == len(keys)
    assert not edges & set(keys.tolist())
    assert (a_ // b.block_nodes == block).all()
    assert (b_ // b.block_nodes == block).all()
    quota = np.bincount(ng[b.senders.numpy()[em]],
                        minlength=b.max_graphs) // 2
    assert (np.bincount(ng[a_], minlength=b.max_graphs) <= quota).all()
    model = pretrain.build_objective(cfg).to(cuda_device)
    edge_dot.reset_launches()
    loss, _ = model(batch, train=True)
    loss.backward()
    assert edge_dot.launches["blocked_edge_dot_fwd"] == 2
    assert edge_dot.launches["blocked_edge_dot_bwd"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("objective,domain,kw", [
    ("masking", "chem", {}),
    ("masking", "chem", dict(transform_device="device")),
    ("edgepred", "bio", dict(transform_device="device")),
    ("contextpred", "chem", {}),
])
def test_epoch_trainer_on_card_equals_per_step(cuda_device, objective,
                                               domain, kw):
    """``run_pretrain`` on the device-resident dataset: the epoch trainer
    (K = 4, two epochs a group, CUDA-graph replays) equals per-step mode
    (K = 1, eager steps) bit for bit: history, parameters and statistics."""
    graphs = _resident_graphs(domain)
    runs = [pretrain.run_pretrain(
        _resident_cfg(objective, domain, scan_steps=k, epoch_group=2, **kw),
        graphs, log=None, epochs=3, device="cuda") for k in (1, 4)]
    assert runs[1]["replays"] > 0
    assert runs[0]["history"] == runs[1]["history"]
    ref = runs[0]["model"].state_dict()
    for name, v in runs[1]["model"].state_dict().items():
        assert torch.equal(v, ref[name]), name
