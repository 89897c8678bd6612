"""The CUDA sources of the port, read as text on the CPU: the fused GIN conv
(K1, csrc/gin_conv.cu) and the fused edge-transform SpMM (K2,
csrc/spmm.cu) aggregate through the one row-owned walk of
csrc/edge_aggr.cuh, which sums every row in a fixed order; K3's backward
(csrc/edge_dot.cu) and K6 (csrc/spmm_ee.cu) walk their slots with the same
staging and walk, and K7 (the same source) takes the header's row loads.
No atomic add may come back into K1, K2, the header and the GEMM, K3, K6
and K7, or the GAT attention (K4 and K5: csrc/gat.cu, csrc/gat_bf16.cu and
the walks they share, csrc/gat_walks.cuh; row-owned too): their outputs
would change in their last bits from run to run. The build must rebuild
every user's library when the header changes, and the GAT library when
any of its files does."""

import re
import shutil

import pytest

from pretrain_gnns_tpu_torch.ops import _build

HEADER = "edge_aggr.cuh"
USERS = ["gin_conv", "spmm", "edge_dot", "spmm_ee"]


# K2 (its float32 and bfloat16 sources), its header, and the kernels built
# on the header's walk and rows (K3, K6 and K7); since the bfloat16
# variants K1 and its GEMM too
@pytest.mark.parametrize("name", ["spmm.cu", "spmm_bf16.cu", HEADER,
                                  "edge_dot.cu", "spmm_ee.cu", "gin_conv.cu",
                                  "gemm.cuh"])
def test_no_atomics_in_k2(name):
    text = (_build.CSRC / name).read_text()
    assert not re.search(r"\batomic\w*\s*\(", text), name


# the GAT library's two sources (float32 and bfloat16 instantiations) and
# the walks they share
GAT_FILES = ["gat.cu", "gat_bf16.cu", "gat_walks.cuh"]


@pytest.mark.parametrize("name", GAT_FILES)
def test_no_atomics_in_gat(name):
    text = (_build.CSRC / name).read_text()
    assert not re.search(r"\batomic\w*\s*\(", text), name


def test_gat_library_is_built_from_both_sources():
    """``_build`` compiles gat.cu and gat_bf16.cu in parallel, one ``nvcc``
    each, and links them into one library; both include the shared
    walks."""
    srcs = _build.sources("gat")
    assert [p.name for p in srcs] == ["gat.cu", "gat_bf16.cu"]
    for src in srcs:
        assert _build.CSRC / "gat_walks.cuh" in _build._with_headers(src)
    assert _build._target("gat")[0] == srcs


@pytest.mark.parametrize("name", GAT_FILES)
def test_build_hash_covers_each_gat_source(name, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    _, before = _build._target("gat")
    with open(csrc / name, "a") as f:
        f.write("\n// changed\n")
    _, after = _build._target("gat")
    assert before != after


def test_spmm_library_is_built_from_both_sources():
    """``_build`` compiles K2's float32 (spmm.cu) and bfloat16
    (spmm_bf16.cu) sources in parallel, one ``nvcc`` each, and links them
    into one library; both include the shared walk, and the hash covers
    the new source."""
    srcs = _build.sources("spmm")
    assert [p.name for p in srcs] == ["spmm.cu", "spmm_bf16.cu"]
    for src in srcs:
        assert _build.CSRC / HEADER in _build._with_headers(src)
    assert _build._target("spmm")[0] == srcs


def test_spmm_bf16_hash_covers_its_source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    _, before = _build._target("spmm")
    with open(csrc / "spmm_bf16.cu", "a") as f:
        f.write("\n// changed\n")
    _, after = _build._target("spmm")
    assert before != after


def test_k2_bf16_route_puts_edge_terms_and_dw_on_tensor_cores():
    """Under bf16_compute both K2 entry points hand over to spmm_bf16.cu.
    Its forward walks x alone (no edge term) or forms the edge terms of 16
    slots at a time on the tensor cores (mma.sync), W's fragments held in
    registers; its backward sums dW on the tensor cores, not slot by slot
    in registers. Every walk sums a row's slots in slot order in a run
    (walk_rows, or the edge kernel's own). The shared header keeps K1's
    bfloat16 walk and no K2 branch (the per-slot dW, SLOT_DW, is gone)."""
    spmm = (_build.CSRC / "spmm.cu").read_text()
    k2 = (_build.CSRC / "spmm_bf16.cu").read_text()
    header = (_build.CSRC / HEADER).read_text()
    for d in ("fwd", "bwd"):
        body = _body(spmm, rf"^int pgt_spmm_{d}\(")
        assert re.search(rf"if \(bf16_compute\)\s+(?:return|err =) "
                         rf"pgt_spmm_{d}_bf16\(", body), d
        assert re.search(rf'^extern "C" int pgt_spmm_{d}_bf16\(', k2,
                         re.MULTILINE), d
    xfwd = _body(k2, r"^spmm16_x_fwd_kernel\(")
    edge = _body(k2, r"^spmm16_edge_fwd_kernel\(")
    bwd = _body(k2, r"^spmm16_bwd_kernel\(")
    assert "walk_rows<" in xfwd and "mma_bf16" not in xfwd
    assert _calls(edge, "mma_bf16") == 1 and "fmaf" not in edge
    assert _calls(bwd, "mma_bf16") == 1 and "fmaf" not in bwd
    assert "walk_rows<" in bwd and "round_staged" not in k2
    assert "SLOT_DW" not in header
    assert 'static_assert(!BF || SELF, "K2\'s bfloat16 backward is ' \
        'spmm_bf16.cu\'s");' in header


@pytest.mark.parametrize("name", USERS)
def test_k1_and_k2_include_the_shared_aggregation(name):
    src = _build.CSRC / f"{name}.cu"
    assert re.search(rf'^#include "{re.escape(HEADER)}"$', src.read_text(),
                     re.MULTILINE)
    assert _build.CSRC / HEADER in _build._with_headers(src)


@pytest.mark.parametrize("name", USERS)
def test_build_hash_covers_the_shared_aggregation(name, tmp_path,
                                                  monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    _, before = _build._target(name)
    with open(csrc / HEADER, "a") as f:
        f.write("\n// changed\n")
    _, after = _build._target(name)
    assert before != after


@pytest.mark.parametrize("name", ["gin_conv", "spmm", "edge_dot"])
def test_bf16_variants_take_both_flags(name):
    """K1, K2 and K3 have bfloat16 variants: each entry point takes the
    rows' dtype and the compute dtype before the stream, and the library
    says so (``pgt_bf16_flags``, which the A/B scripts read)."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    assert "int pgt_bf16_flags() { return 1; }" in text
    entries = re.findall(r"^int (pgt_\w+_(?:fwd|bwd))\((.*?)\) \{", text,
                         re.MULTILINE | re.DOTALL)
    assert len(entries) == 2
    for fn, params in entries:
        assert re.search(r"int bf16_rows,\s+int bf16_compute,\s+void\* "
                         r"stream$", params), fn



def _body(text, head):
    """The brace-balanced body of the first definition that ``head`` (a
    regex) starts, its signature included."""
    m = re.search(head, text, re.MULTILINE)
    assert m, head
    depth, i = 0, text.index("{", m.end())
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[m.start():j + 1]
    raise AssertionError(f"unbalanced braces after {head}")


def _calls(body, fn):
    return len(re.findall(rf"(?<![\w.]){fn}\(", body))


def test_k1_bf16_products_run_on_the_tensor_cores():
    """Under bf16_compute K1's six products go to gemm.cuh's tensor-core
    GEMM (mma.sync on bfloat16 fragments from ldmatrix, cp.async stages),
    never to the float GEMM's FMA loop (an FMA chain recomputes only the
    sums near a bfloat16 rounding tie); the register-staged bfloat16 GEMM
    that preceded it is gone. Only bfloat16 rows at float32 compute keep
    the float kernels (they have no rounded operand)."""
    gemm = (_build.CSRC / "gemm.cuh").read_text()
    gin = (_build.CSRC / "gin_conv.cu").read_text()
    assert not re.search(r"gemm_cvt|GEMM_[AB]_ROUND|fetch_tile|put_tile",
                         gemm + gin)
    kernel = _body(gemm, r"^gemm_bf16_kernel\(")
    tile = _body(gemm, r"^__device__ __forceinline__ void tc_tile\(")
    load = _body(gemm, r"^__device__ __forceinline__ void tc_load\(")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in gemm
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in gemm
    assert _calls(tile, "mma_bf16") == 1 and _calls(tile, "ldsm_x4<true>") == 2
    assert _calls(load, "cp_async_b") == 1 and "cp_async_wait<" in kernel
    for text in (kernel, tile, load):
        assert "fma_tile" not in text
    # the products' loop has no FMA on the CUDA cores (the kernel's only
    # fmaf is the ordered chain of the few sums near a rounding tie)
    assert "fmaf" not in tile + load and kernel.count("fmaf(") == 1
    fwd = _body(gin, r"^int fwd_bf16\(")
    bwd = _body(gin, r"^int bwd_bf16\(")
    # the bf16_compute route: after the float32-compute branch of each
    f32_fwd, bf_fwd = fwd.split("if (!c)", 1)[1].split(";", 1)
    f32_bwd, bf_bwd = bwd.split("if (!c) {", 1)[1].split("} else {", 1)
    assert _calls(bf_fwd, "gemm_bf16") == 2 and _calls(bf_fwd, "gemm") == 0
    assert _calls(bf_bwd, "gemm_bf16") == 4 and _calls(bf_bwd, "gemm") == 0
    assert _calls(f32_fwd, "fwd_products") == 1
    assert _calls(f32_bwd, "bwd_products") == 1
    assert _calls(f32_fwd + f32_bwd, "gemm_bf16") == 0
    assert _calls(_body(gin, r"^int fwd_products\("), "gemm") == 2
    assert _calls(_body(gin, r"^int bwd_products\("), "gemm") == 4


def _block(text, head):
    """The brace-balanced block that opens at the first ``head`` (a plain
    string ending in ``{``) and what follows it."""
    i = text.index(head) + len(head) - 1
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1], text[j + 1:]
    raise AssertionError(f"unbalanced braces after {head}")


def test_k4_to_k7_bf16_routes_and_k4_products_on_the_tensor_cores():
    """K4, K5, K6 and K7 have bfloat16 variants: their entry points take the
    compute dtype (K6 and K7 also the rows' dtype) before the stream, each
    library says so, and the bfloat16 instantiations are launched (K4's and
    K5's from gat_bf16.cu, which the public entry points of gat.cu call
    under bf16_compute). Under bf16_compute K4's three products (x, dWl,
    dh) go to gemm.cuh's tensor-core GEMM alone; the float32 route keeps
    the float GEMM. K4's bfloat16 backward recomputes nothing of its
    forward: no softmax walk, no logit scalars, no rounding of h or Wl."""
    gat = (_build.CSRC / "gat.cu").read_text()
    gat16 = (_build.CSRC / "gat_bf16.cu").read_text()
    ee = (_build.CSRC / "spmm_ee.cu").read_text()
    assert "int pgt_gat_bf16_flags() { return 1; }" in gat
    assert "int pgt_spmm_ee_bf16_flags() { return 1; }" in ee
    for text, names, flags in (
            (gat, ("gat_attn_fwd", "gat_attn_bwd", "gat_conv_fwd",
                   "gat_conv_bwd"), r"int bf16_compute,\s+void\* stream$"),
            (ee, ("spmm_ee_fwd", "spmm_ee_bwd", "spmm_sorted_fwd"),
             r"int bf16_rows,\s+int bf16_compute,\s+void\* stream$")):
        for name in names:
            sig = re.search(rf"^int pgt_{name}\((.*?)\) \{{", text,
                            re.MULTILINE | re.DOTALL)
            assert sig and re.search(flags, sig.group(1)), name
    # each public entry point hands bf16_compute to gat_bf16.cu's
    for name in ("gat_attn_fwd", "gat_attn_bwd", "gat_conv_fwd",
                 "gat_conv_bwd"):
        body = _body(gat, rf"^int pgt_{name}\(")
        assert re.search(rf"if \(bf16_compute\)\s+return pgt_{name}_bf16\(",
                         body), name
    # K5's bfloat16 entry points reach the bfloat16 walks; K4's its own
    for fn, want in (("pgt_gat_attn_fwd_bf16", "attention_fwd<false, true>"),
                     ("pgt_gat_attn_bwd_bf16", "attention_bwd<false, true>")):
        assert want in _body(gat16, rf"^int {fn}\("), fn
    fwd16 = _body(gat16, r"^int pgt_gat_conv_fwd_bf16\(")
    bwd16 = _body(gat16, r"^int pgt_gat_conv_bwd_bf16\(")
    assert "gat_proj16_kernel<<<" in fwd16 and "gat_conv_fwd16_kernel<" in fwd16
    assert "gat_dwe16_kernel<<<" in bwd16
    assert "gat_bwd_rcv_kernel<true, 2, false, true, bf16>" in bwd16
    for absent in ("gat_proj", "gat_conv_fwd16_kernel", "gat_fwd_kernel",
                   "gat_edge_vec_kernel", "convert(", "round_weight("):
        assert absent not in bwd16, absent
    for body, n_bf in ((fwd16, 1), (bwd16, 2)):
        assert _calls(body, "gemm_bf16") == n_bf and _calls(body, "gemm") == 0
    for fn, n in (("pgt_gat_conv_fwd", 1), ("pgt_gat_conv_bwd", 2)):
        body = _body(gat, rf"^int {fn}\(")
        assert _calls(body, "gemm_bf16") == 0 and _calls(body, "gemm") == n, fn
    # K6's and K7's kernels load their gathered rows through the rounding
    # load of edge_aggr.cuh and dispatch on both flags
    for head in (r"^spmm_ee_walk_kernel\(", r"^spmm_ee_dmsg_kernel\(",
                 r"^spmm_sorted_fwd_kernel\("):
        assert "ld_row_bf<VEC, BF>" in _body(ee, head), head
    for fn in ("pgt_spmm_ee_fwd", "pgt_spmm_ee_bwd", "pgt_spmm_sorted_fwd"):
        assert "with_types(bf16_rows, bf16_compute" in _body(ee, rf"^int {fn}\(")
