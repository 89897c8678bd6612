#!/usr/bin/env python3
"""Timing variants of the fused GAT conv's (K4's) backward: copies of this
tree's ``pretrain_gnns_tpu_torch/csrc`` in which ``gat.cu`` does one job
with the shared code of ``gemm.cuh`` in place of its own kernel, for
``scripts/torch_port_k1_k4_ab.py --ref_csrc``.

    python3 scripts/torch_port_gat_variants.py --out _archive/variants
    python3 scripts/torch_port_k1_k4_ab.py --kernels k4,k5 \\
        --ref_csrc _archive/variants/sum_partials

Variants (each a directory under ``--out``):
- ``sum_partials``: the walks' and dWe's partials summed by
  ``gemm.cuh``'s ``sum_partials`` (one thread a column, the partials in
  order) in place of ``gat_finish_kernel``;
- ``gemm_dwe``: ``dWe``'s ``sum_r A_r^T g_r`` by ``gemm.cuh``'s split-K
  GEMM (one product a head) and ``S``'s column sums by ``colsum``, in
  place of ``gat_dwe_kernel``.

They are for timing only: each leaves out the small kernel that would
combine its results into ``dpar`` and ``dWe`` (so the variant's time is a
lower bound of that route's), and its outputs are not the function's.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "pretrain_gnns_tpu_torch", "csrc")

FINISH = """  const ll outs = (3 + (FUSED ? a.K : 0)) * HD;
  gat_finish_kernel<<<(unsigned)((outs + 31) / 32), 32 * FIN_GROUPS, 0, st>>>(
      w.o.part, walk_ctas(a), FUSED ? w.dwe_part : nullptr, dwe_chunks(a.N),
      a.K, HD, dpar, dWe);
  return (int)cudaGetLastError();
"""

SUM_PARTIALS = """  // each column summed in place, partials in order
  err = sum_partials(w.o.part, walk_ctas(a), NPART * HD, NPART * HD,
                     w.o.part, nullptr, nullptr, 0, st);
  if (err || !FUSED) return err;
  return sum_partials(w.dwe_part, dwe_chunks(a.N), (a.K + 1) * HD,
                      (a.K + 1) * HD, w.dwe_part, nullptr, nullptr, 0, st);
"""

DWE = """    gat_dwe_kernel<<<dim3((unsigned)((HD + DWE_THREADS - 1) / DWE_THREADS),
                          dwe_chunks(a.N)),
                     DWE_THREADS, 0, st>>>(a, c, w.o.Ar, w.o.Sr, w.dwe_part);
    err = (int)cudaGetLastError();
"""

GEMM_DWE = """    // A_h^T g, one split-K product a head, and S's column sums, all in
    // dwe_part
    const int KP = padded_k(a.K);
    const int splits = wgrad_splits(a.K, a.D, a.N);
    float* C = w.dwe_part;
    float* gp = C + (ll)a.H * a.K * a.D;
    float* cp = gp + (ll)splits * a.K * a.D;
    for (int h = 0; h < a.H && !err; ++h)
      err = gemm(w.o.Ar + h * KP, 1, (ll)a.H * KP, c.g + h * c.hs, c.rs, 1,
                 C + (ll)h * a.K * a.D, a.K, a.D, a.N, splits, gp, nullptr,
                 nullptr, 0, st);
    if (!err)
      err = colsum(w.o.Sr, a.N, a.H * KP, cp,
                   cp + (ll)((a.N + COLSUM_ROWS - 1) / COLSUM_ROWS) * a.H * KP,
                   st);
"""

GEMM_DWE_FINISH = FINISH.replace("FUSED ? w.dwe_part : nullptr", "nullptr")

VARIANTS = {
    "sum_partials": ((FINISH, SUM_PARTIALS),),
    "gemm_dwe": ((DWE, GEMM_DWE), (FINISH, GEMM_DWE_FINISH)),
}


def write(out: str) -> None:
    src = open(os.path.join(CSRC, "gat.cu")).read()
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the text to replace is not in "
                                 "gat.cu exactly once")
            text = text.replace(old, new)
        dst = os.path.join(out, name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(CSRC, dst)
        with open(os.path.join(dst, "gat.cu"), "w") as f:
            f.write(text)
        print(dst)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True,
                   help="directory for the variants' csrc copies")
    write(p.parse_args().out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
