"""The CUDA sources of the port, read as text on the CPU: the fused GIN conv
(K1, csrc/gin_conv.cu) and the fused edge-transform SpMM (K2,
csrc/spmm.cu) aggregate through the one row-owned walk of
csrc/edge_aggr.cuh, which sums every row in a fixed order; K3's backward
(csrc/edge_dot.cu) walks its pairs' sides with the same staging and walk,
and K7 (csrc/spmm_ee.cu) takes the header's row loads. No atomic add may
come back into K2, the header, K3, K6 and K7, or the GAT attention (K4 and
K5, csrc/gat.cu, whose walks are row-owned too): their outputs would change
in their last bits from run to run. The build must rebuild every user's
library when the header changes."""

import re
import shutil

import pytest

from pretrain_gnns_tpu_torch.ops import _build

HEADER = "edge_aggr.cuh"
USERS = ["gin_conv", "spmm", "edge_dot", "spmm_ee"]


# K2, its header, and the kernels built on the header's walk and rows
@pytest.mark.parametrize("name", ["spmm.cu", HEADER, "edge_dot.cu",
                                  "spmm_ee.cu"])
def test_no_atomics_in_k2(name):
    text = (_build.CSRC / name).read_text()
    assert not re.search(r"\batomic\w*\s*\(", text), name


def test_no_atomics_in_gat():
    text = (_build.CSRC / "gat.cu").read_text()
    assert not re.search(r"\batomic\w*\s*\(", text)


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
