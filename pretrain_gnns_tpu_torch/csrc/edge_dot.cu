// Blocked pair-dot scoring head (K3) for Hopper (sm_90a), forward and
// backward.
//
// Replaces the Pallas TPU kernel pretrain_gnns_tpu/ops/pallas_spmm.py
// (_edot_fwd_kernel and _edot_bwd_kernel via _edot_call, wrapped by the
// custom_vjp blocked_edge_dot). On the block-diagonal batch, for P =
// n_blocks * pairs_per_block pairs whose endpoints lie in their block:
//
//   score_p = w_p * <x[a_p], x[b_p]>
//
// Backward, with c_p = g_p * w_p:
//   dx_n = sum_{a_p = n} c_p * x[b_p] + sum_{b_p = n} c_p * x[a_p]
// and nothing for a, b and w.
//
// What bounds it on the card: at the edge-prediction path's shapes (chem
// N = 8,192 rows, F = 300, P = 24,576 or 12,288 pairs; bio N = 20,480,
// P = 61,440 or 30,720) a forward reads the x rows its valid pairs touch
// (7-18 MB) and a backward also writes dx [N, F] (10-25 MB), against at
// most 0.1 GFLOP: bytes, a few microseconds at 3.35 TB/s. At that size the
// time is the latency of the dependent loads (weight and indices, then the
// rows), not the bytes.
//
// Design (simple and right first; float4 rows, bf16 and fusing the two
// heads of a step into one launch are later work):
// - The TPU kernel gathered and scattered with one-hot matmuls on the MXU.
//   Here the forward gives one warp to a pair: lanes stride the F features
//   of both rows (coalesced), a shuffle tree sums the products.
// - Backward: one CTA per (node block, 32-wide feature tile) keeps the
//   block's dx rows in a shared f32 tile, a lane per feature. Each warp
//   owns the rows r with r % WARPS == warp and is the only writer of those
//   rows: the warp reads 32 pairs at a time (one per lane, coalesced),
//   ballots which of them touch a row it owns, and walks those in pair
//   order. So the sums need no atomics and are taken in a fixed order: dx
//   is the same bits from run to run.
// - Padded pairs (w == 0, global index 0), pairs with a zero cotangent
//   (the odd edge slots of the positive head) and any pair with an
//   endpoint outside its block are skipped, so index 0 never reaches a
//   row of another block's tile. Every row of the block is written once,
//   so padded rows and blocks without pairs come out exactly 0 and dx
//   needs no zeroing pass.
// - The shared tile is sized from block_nodes at launch (dynamic shared
//   memory, opted in above 48 KB up to the 227 KB a block may use), since
//   block_layout grows block_nodes to the largest graph.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;                  // feature tile: one warp wide
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / FT;
constexpr int MAX_SMEM = 232448;        // 227 KB: a block's most on the H100
constexpr int DEFAULT_SMEM = 48 * 1024; // above this only after opting in
constexpr unsigned FULL = 0xffffffffu;

typedef long long ll;

int bwd_smem(int block_nodes) {
  return block_nodes * FT * (int)sizeof(float);
}

__global__ void __launch_bounds__(THREADS)
edot_fwd_kernel(const float* __restrict__ x, const int* __restrict__ a,
                const int* __restrict__ b, const float* __restrict__ w,
                float* __restrict__ out, int P, int F, int block_nodes,
                int pairs_per_block) {
  const int lane = threadIdx.x % FT;
  const int warp = threadIdx.x / FT;
  const ll p = (ll)blockIdx.x * WARPS + warp;
  if (p >= P) return;  // the whole warp leaves together
  // every lane reads the same pair: the branch below is warp-uniform
  const float wp = w[p];
  float s = 0.f;
  if (wp != 0.f) {
    const ll base = (p / pairs_per_block) * block_nodes;
    const ll ia = a[p] - base;
    const ll ib = b[p] - base;
    if (ia >= 0 && ia < block_nodes && ib >= 0 && ib < block_nodes) {
      const float* xa = x + (base + ia) * F;
      const float* xb = x + (base + ib) * F;
      for (int f = lane; f < F; f += FT) s = fmaf(xa[f], xb[f], s);
    }
  }
#pragma unroll
  for (int o = FT / 2; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) out[p] = wp * s;
}

__global__ void __launch_bounds__(THREADS)
edot_bwd_kernel(const float* __restrict__ x, const int* __restrict__ a,
                const int* __restrict__ b, const float* __restrict__ w,
                const float* __restrict__ g, float* __restrict__ dx, int F,
                int block_nodes, int pairs_per_block) {
  extern __shared__ float acc[];  // [block_nodes][FT]
  const int blk = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int lane = threadIdx.x % FT;
  const int warp = threadIdx.x / FT;
  const int f = f0 + lane;
  const bool fok = f < F;
  for (int i = threadIdx.x; i < block_nodes * FT; i += THREADS) acc[i] = 0.f;
  __syncthreads();

  const ll base = (ll)blk * block_nodes;
  const ll p0 = (ll)blk * pairs_per_block;
  for (int q0 = 0; q0 < pairs_per_block; q0 += FT) {
    // one pair per lane; la, lb = -1 marks a pair to skip
    const int q = q0 + lane;
    int la = -1, lb = -1;
    float c = 0.f;
    if (q < pairs_per_block) {
      c = g[p0 + q] * w[p0 + q];
      if (c != 0.f) {
        const ll ia = a[p0 + q] - base;
        const ll ib = b[p0 + q] - base;
        if (ia >= 0 && ia < block_nodes && ib >= 0 && ib < block_nodes) {
          la = (int)ia;
          lb = (int)ib;
        }
      }
    }
    // this warp adds into the rows it owns, and no other warp does
    const unsigned ma = __ballot_sync(FULL, la >= 0 && la % WARPS == warp);
    const unsigned mb = __ballot_sync(FULL, lb >= 0 && lb % WARPS == warp);
    unsigned m = ma | mb;  // the same in every lane: the loop is uniform
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const int ra = __shfl_sync(FULL, la, src);
      const int rb = __shfl_sync(FULL, lb, src);
      const float cp = __shfl_sync(FULL, c, src);
      if (!fok) continue;
      if ((ma >> src) & 1u)
        acc[ra * FT + lane] = fmaf(cp, x[(base + rb) * F + f],
                                   acc[ra * FT + lane]);
      if ((mb >> src) & 1u)
        acc[rb * FT + lane] = fmaf(cp, x[(base + ra) * F + f],
                                   acc[rb * FT + lane]);
    }
  }
  __syncthreads();

  if (!fok) return;
  for (int r = warp; r < block_nodes; r += WARPS)
    dx[(base + r) * F + f] = acc[r * FT + lane];
}

bool bad_shape(int N, int F, int P, int block_nodes, int pairs_per_block) {
  return N <= 0 || F <= 0 || block_nodes <= 0 || pairs_per_block <= 0 ||
         N % block_nodes != 0 ||
         (ll)P != (ll)(N / block_nodes) * pairs_per_block;
}

}  // namespace

extern "C" {

int pgt_edot_max_smem() { return MAX_SMEM; }
int pgt_edot_bwd_smem(int block_nodes) { return bwd_smem(block_nodes); }

// Forward: writes out [P] from x [N, F], a, b [P] (global row indices) and
// w [P]; P = (N / block_nodes) * pairs_per_block. Returns the first CUDA
// error, 0 if none.
int pgt_edot_fwd(const float* x, const int* a, const int* b, const float* w,
                 float* out, int N, int F, int P, int block_nodes,
                 int pairs_per_block, void* stream) {
  if (bad_shape(N, F, P, block_nodes, pairs_per_block))
    return (int)cudaErrorInvalidValue;
  const int grid = (P + WARPS - 1) / WARPS;
  edot_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, a, b, w, out, P, F, block_nodes, pairs_per_block);
  return (int)cudaGetLastError();
}

// Backward from the cotangent g [P]: writes every row of dx [N, F].
int pgt_edot_bwd(const float* x, const int* a, const int* b, const float* w,
                 const float* g, float* dx, int N, int F, int P,
                 int block_nodes, int pairs_per_block, void* stream) {
  const int smem = bwd_smem(block_nodes);
  if (bad_shape(N, F, P, block_nodes, pairs_per_block) || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (smem > DEFAULT_SMEM) {
    const int err = (int)cudaFuncSetAttribute(
        edot_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  dim3 grid(N / block_nodes, (F + FT - 1) / FT);
  edot_bwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, a, b, w, g, dx, F, block_nodes, pairs_per_block);
  return (int)cudaGetLastError();
}

}  // extern "C"
