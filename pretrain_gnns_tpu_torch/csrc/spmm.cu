// Fused edge-transform SpMM (K2) for Hopper (sm_90a), forward and backward.
//
// Replaces the Pallas TPU kernel pretrain_gnns_tpu/ops/pallas_spmm.py
// (_fused_fwd_kernel via _fused_call_fwd, _fused_bwd_kernel via
// _fused_call_bwd, wrapped by the custom_vjp blocked_spmm_fused). On the
// block-diagonal batch, for the variants has_x, has_ein or both:
//
//   out_r = sum_{rcv_e = r} w_e * (x[snd_e] [has_x] + (ein_e @ W) [has_ein])
//
// Backward, with dmsg_e = w_e * g[rcv_e]:
//   dx_n = sum_{snd_e = n} dmsg_e       (has_x)
//   dW   = sum_e ein_e^T dmsg_e         (has_ein; K x F, float32)
//
// What bounds it on the card: at the bio path's shapes (N = 20,480 rows,
// F = 300, K = 10, about 44 k valid edges of 61,440 slots) a call moves
// 20-45 MB (the x or g rows of the valid nodes, the [N, F] output, the
// edge arrays) and does at most 0.3 GFLOP, so it is bound by bytes
// (3.35 TB/s), not by operations: about 0.01 ms at the peak.
//
// Design: the three variants are instantiations of the row-owned
// aggregation of edge_aggr.cuh, the one K1 runs with its self term
// (<HAS_X, HAS_EIN, SELF = false, VEC>): one CTA per (node block, feature
// tile), two features a lane where F is even and the rows 8-byte aligned
// (a 64-wide tile, float2 accesses), else one; the block's slots staged
// in shared memory, each warp the only writer of its rows, the x or g rows
// of up to eight owned slots in flight a warp, and the edge term
// reassociated (A_r = sum w_e ein_e in [block_nodes, K] row sums, then
// A_r @ W once a row; dW = sum_r A_r^T g_r a block). The TPU carried dW
// across its sequential grid in VMEM; Hopper's blocks run in no order, so
// each node block writes a K x F partial and a second pass sums the
// partials in block order. No atomics: out, dx and dW are the same bits
// on every run.

#include <cuda_runtime.h>

#include "edge_aggr.cuh"

namespace {

constexpr int MAX_K = AGG_MAX_K;        // edge input width
constexpr int MAX_SMEM = 232448;        // 227 KB: a block's most on the H100
constexpr int NUM_SMS = 132;            // H100 SXM

// out[i] = sum_p part[p * MN + i], summed in order p = 0, 1, ...
__global__ void sum_partials_kernel(const float* __restrict__ part, int S,
                                    ll MN, float* __restrict__ out) {
  for (ll idx = blockIdx.x * (ll)blockDim.x + threadIdx.x; idx < MN;
       idx += (ll)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < S; ++p) s += part[p * MN + idx];
    out[idx] = s;
  }
}

int fwd_smem(int block_nodes, int K, int vec, bool has_x, bool has_ein) {
  return edge_aggr_smem(block_nodes, has_ein ? K : 0, vec, has_x, has_ein,
                        false);
}

int bwd_smem(int block_nodes, int K, int vec, bool has_x, bool has_ein) {
  return edge_aggr_smem(block_nodes, has_ein ? K : 0, vec, has_x, has_ein,
                        true);
}

template <bool HAS_X, bool HAS_EIN>
int launch_fwd(const float* x, const float* ein, const float* W,
               const int* snd, const int* rcv, const float* w, float* out,
               int N, int F, int K, int block_nodes, int block_edges,
               cudaStream_t st) {
  const int n_blocks = N / block_nodes;
  K = HAS_EIN ? K : 0;
  if (row_vec(F, {x, W, out}, 2) == 2)
    return edge_aggr_fwd<HAS_X, HAS_EIN, false, 2>(
        x, ein, W, nullptr, snd, rcv, w, nullptr, out, n_blocks, F, K,
        block_nodes, block_edges, st);
  return edge_aggr_fwd<HAS_X, HAS_EIN, false, 1>(
      x, ein, W, nullptr, snd, rcv, w, nullptr, out, n_blocks, F, K,
      block_nodes, block_edges, st);
}

template <bool HAS_X, bool HAS_EIN>
int launch_bwd(const float* g, const float* ein, const int* snd,
               const int* rcv, const float* w, float* dx, float* dW,
               float* dW_part, int N, int F, int K, int block_nodes,
               int block_edges, cudaStream_t st) {
  const int n_blocks = N / block_nodes;
  K = HAS_EIN ? K : 0;
  int err = row_vec(F, {g, dx}, 2) == 2
      ? edge_aggr_bwd<HAS_X, HAS_EIN, false, 2>(
            g, ein, snd, rcv, w, nullptr, dx, dW_part, nullptr, n_blocks, F,
            K, block_nodes, block_edges, st)
      : edge_aggr_bwd<HAS_X, HAS_EIN, false, 1>(
            g, ein, snd, rcv, w, nullptr, dx, dW_part, nullptr, n_blocks, F,
            K, block_nodes, block_edges, st);
  if (err || !HAS_EIN) return err;
  const ll MN = (ll)K * F;
  const ll want = (MN + 255) / 256;
  const int blocks = (int)(want < 4 * NUM_SMS ? want : 4 * NUM_SMS);
  sum_partials_kernel<<<blocks, 256, 0, st>>>(dW_part, n_blocks, MN, dW);
  return (int)cudaGetLastError();
}

bool bad_shape(int N, int F, int K, int block_nodes, int block_edges,
               bool has_x, bool has_ein, int smem) {
  return !(has_x || has_ein) || block_nodes <= 0 || block_edges <= 0 ||
         N <= 0 || F <= 0 || N % block_nodes != 0 ||
         (has_ein && (K <= 0 || K > MAX_K)) || smem > MAX_SMEM;
}

}  // namespace

extern "C" {

int pgt_spmm_max_k() { return MAX_K; }
int pgt_spmm_max_smem() { return MAX_SMEM; }
// Shared bytes of a forward launch at most (with x's tile, two features a
// lane).
int pgt_spmm_fwd_smem(int block_nodes, int K, int has_ein) {
  return fwd_smem(block_nodes, K, 2, true, has_ein != 0);
}
// Shared bytes of a backward launch at most (at K = MAX_K, two features a
// lane).
int pgt_spmm_bwd_smem(int block_nodes, int has_x, int has_ein) {
  return bwd_smem(block_nodes, MAX_K, 2, has_x != 0, has_ein != 0);
}

// Forward: writes out [N, F]. x [N, F] is read only with has_x; ein [E, K]
// and W [K, F] only with has_ein. E = (N / block_nodes) * block_edges.
// Returns the first CUDA error, 0 if none.
int pgt_spmm_fwd(const float* x, const float* ein, const float* W,
                 const int* snd, const int* rcv, const float* w, float* out,
                 int N, int F, int K, int block_nodes, int block_edges,
                 int has_x, int has_ein, void* stream) {
  if (bad_shape(N, F, K, block_nodes, block_edges, has_x, has_ein,
                fwd_smem(block_nodes, K, 2, has_x != 0, has_ein != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (has_x && has_ein)
    return launch_fwd<true, true>(x, ein, W, snd, rcv, w, out, N, F, K, block_nodes, block_edges, st);
  if (has_x)
    return launch_fwd<true, false>(x, ein, W, snd, rcv, w, out, N, F, K, block_nodes, block_edges, st);
  return launch_fwd<false, true>(x, ein, W, snd, rcv, w, out, N, F, K, block_nodes, block_edges, st);
}

// Backward from g [N, F]: writes dx [N, F] (has_x) and dW [K, F] (has_ein),
// with dW_part [N / block_nodes, K, F] as scratch.
int pgt_spmm_bwd(const float* g, const float* ein, const int* snd,
                 const int* rcv, const float* w, float* dx, float* dW,
                 float* dW_part, int N, int F, int K, int block_nodes,
                 int block_edges, int has_x, int has_ein, void* stream) {
  if (bad_shape(N, F, K, block_nodes, block_edges, has_x, has_ein,
                bwd_smem(block_nodes, K, 2, has_x != 0, has_ein != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (has_x && has_ein)
    return launch_bwd<true, true>(g, ein, snd, rcv, w, dx, dW, dW_part, N, F, K, block_nodes, block_edges, st);
  if (has_x)
    return launch_bwd<true, false>(g, ein, snd, rcv, w, dx, dW, dW_part, N, F, K, block_nodes, block_edges, st);
  return launch_bwd<false, true>(g, ein, snd, rcv, w, dx, dW, dW_part, N, F, K, block_nodes, block_edges, st);
}

}  // extern "C"
