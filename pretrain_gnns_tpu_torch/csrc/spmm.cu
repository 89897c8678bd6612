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
// Design (simple and right first; a receiver-sorted segment reduction
// without atomics, bf16 and TMA are later work):
// - The TPU kernel gathered and scattered with one-hot matmuls on the MXU
//   and grouped blocks per grid step. Here one CTA per (node block,
//   32-wide feature tile) keeps the block's rows in a shared f32 tile; a
//   warp takes one edge at a time and a lane one feature, so the x/g row
//   loads are coalesced, and the message goes into the tile with a
//   shared-memory atomic. No [E, F] message ever reaches device memory.
// - The edge input row ein_e (K <= 16 floats) is loaded once per edge, one
//   value per lane, and broadcast with warp shuffles; W's K x 32 tile sits
//   in shared memory.
// - Padded edge slots (w == 0) and any slot whose endpoints fall outside
//   its block are skipped, so a padded slot's global index 0 never
//   indexes shared memory out of bounds. Every row of the block is
//   written, so padded rows come out 0.
// - The shared tile is sized from block_nodes at launch (dynamic shared
//   memory, opted in above 48 KB up to the 227 KB a block may use), since
//   block_layout grows block_nodes to the largest graph.
// - The TPU carried dW across its sequential grid in VMEM. Hopper's
//   blocks run in no order, so each node block writes a K x F partial
//   (per-warp register sums, then summed across warps in order) and a
//   second pass sums the partials in block order.
// Summation order: the shared-memory atomics make out and dx sums of a few
// terms per row in an order that varies from run to run (a relative error
// of a few float32 ulps); dW is summed in a fixed order.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;                  // feature tile: one warp wide
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / FT;
constexpr int MAX_K = 16;               // edge input width
constexpr int MAX_SMEM = 232448;        // 227 KB: a block's most on the H100
constexpr int DEFAULT_SMEM = 48 * 1024; // above this only after opting in
constexpr int NUM_SMS = 132;            // H100 SXM
constexpr unsigned FULL = 0xffffffffu;

typedef long long ll;

int fwd_smem(int block_nodes, int K, bool has_ein) {
  return (block_nodes + (has_ein ? K : 0)) * FT * (int)sizeof(float);
}

int bwd_smem(int block_nodes, bool has_x, bool has_ein) {
  const int acc = has_x ? block_nodes * FT : 0;
  const int red = has_ein ? WARPS * MAX_K * FT : 0;
  return (acc > red ? acc : red) * (int)sizeof(float);
}

template <bool HAS_X, bool HAS_EIN>
__global__ void __launch_bounds__(THREADS)
spmm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ ein,
                const float* __restrict__ W, const int* __restrict__ snd,
                const int* __restrict__ rcv, const float* __restrict__ w,
                float* __restrict__ out, int F, int K, int block_nodes,
                int block_edges) {
  extern __shared__ float smem[];
  float* acc = smem;                     // [block_nodes][FT]
  float* W_s = smem + block_nodes * FT;  // [K][FT]
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int lane = threadIdx.x % FT;
  const int warp = threadIdx.x / FT;
  const int f = f0 + lane;
  const bool fok = f < F;
  for (int i = threadIdx.x; i < block_nodes * FT; i += THREADS) acc[i] = 0.f;
  if (HAS_EIN) {
    for (int i = threadIdx.x; i < K * FT; i += THREADS) {
      const int k = i / FT, l = i % FT;
      W_s[i] = (f0 + l < F) ? W[(ll)k * F + f0 + l] : 0.f;
    }
  }
  __syncthreads();

  const ll base = (ll)b * block_nodes;
  const ll e0 = (ll)b * block_edges;
  for (int e = warp; e < block_edges; e += WARPS) {
    // every lane reads the same slot: the branches below are warp-uniform
    const float we = w[e0 + e];
    if (we == 0.f) continue;
    const ll s = snd[e0 + e] - base;
    const ll r = rcv[e0 + e] - base;
    if (s < 0 || s >= block_nodes || r < 0 || r >= block_nodes) continue;
    float m = 0.f;
    if (HAS_X) m = fok ? x[(base + s) * F + f] : 0.f;
    if (HAS_EIN) {
      const float ek = lane < K ? ein[(e0 + e) * K + lane] : 0.f;
#pragma unroll
      for (int k = 0; k < MAX_K; ++k)
        if (k < K) m = fmaf(__shfl_sync(FULL, ek, k), W_s[k * FT + lane], m);
    }
    atomicAdd(&acc[r * FT + lane], we * m);
  }
  __syncthreads();

  if (!fok) return;
  for (int r = warp; r < block_nodes; r += WARPS)
    out[(base + r) * F + f] = acc[r * FT + lane];
}

template <bool HAS_X, bool HAS_EIN>
__global__ void __launch_bounds__(THREADS)
spmm_bwd_kernel(const float* __restrict__ g, const float* __restrict__ ein,
                const int* __restrict__ snd, const int* __restrict__ rcv,
                const float* __restrict__ w, float* __restrict__ dx,
                float* __restrict__ dW_part, int F, int K, int block_nodes,
                int block_edges) {
  extern __shared__ float smem[];
  float* acc = smem;  // [block_nodes][FT] (HAS_X), then the dW reduction
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int lane = threadIdx.x % FT;
  const int warp = threadIdx.x / FT;
  const int f = f0 + lane;
  const bool fok = f < F;
  if (HAS_X) {
    for (int i = threadIdx.x; i < block_nodes * FT; i += THREADS) acc[i] = 0.f;
    __syncthreads();
  }

  const ll base = (ll)b * block_nodes;
  const ll e0 = (ll)b * block_edges;
  float dw[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) dw[k] = 0.f;
  for (int e = warp; e < block_edges; e += WARPS) {
    const float we = w[e0 + e];
    if (we == 0.f) continue;
    const ll s = snd[e0 + e] - base;
    const ll r = rcv[e0 + e] - base;
    if (s < 0 || s >= block_nodes || r < 0 || r >= block_nodes) continue;
    const float dm = fok ? we * g[(base + r) * F + f] : 0.f;  // dmsg_e
    if (HAS_X) atomicAdd(&acc[s * FT + lane], dm);
    if (HAS_EIN) {
      const float ek = lane < K ? ein[(e0 + e) * K + lane] : 0.f;
#pragma unroll
      for (int k = 0; k < MAX_K; ++k)
        if (k < K) dw[k] = fmaf(__shfl_sync(FULL, ek, k), dm, dw[k]);
    }
  }

  if (HAS_X) {
    __syncthreads();
    if (fok)
      for (int r = warp; r < block_nodes; r += WARPS)
        dx[(base + r) * F + f] = acc[r * FT + lane];
  }
  if (HAS_EIN) {
    __syncthreads();  // the dx tile has been read: reuse it
    float* red = smem;  // [WARPS][MAX_K][FT]
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (k < K) red[(warp * MAX_K + k) * FT + lane] = dw[k];
    __syncthreads();
    for (int i = threadIdx.x; i < K * FT; i += THREADS) {
      const int k = i / FT, l = i % FT;
      float sum = 0.f;
      for (int v = 0; v < WARPS; ++v) sum += red[(v * MAX_K + k) * FT + l];
      if (f0 + l < F) dW_part[((ll)b * K + k) * F + f0 + l] = sum;
    }
  }
}

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

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  if (smem <= DEFAULT_SMEM) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <bool HAS_X, bool HAS_EIN>
int launch_fwd(const float* x, const float* ein, const float* W,
               const int* snd, const int* rcv, const float* w, float* out,
               int N, int F, int K, int block_nodes, int block_edges,
               cudaStream_t st) {
  const int smem = fwd_smem(block_nodes, K, HAS_EIN);
  int err = set_smem(spmm_fwd_kernel<HAS_X, HAS_EIN>, smem);
  if (err) return err;
  dim3 grid(N / block_nodes, (F + FT - 1) / FT);
  spmm_fwd_kernel<HAS_X, HAS_EIN><<<grid, THREADS, smem, st>>>(
      x, ein, W, snd, rcv, w, out, F, K, block_nodes, block_edges);
  return (int)cudaGetLastError();
}

template <bool HAS_X, bool HAS_EIN>
int launch_bwd(const float* g, const float* ein, const int* snd,
               const int* rcv, const float* w, float* dx, float* dW,
               float* dW_part, int N, int F, int K, int block_nodes,
               int block_edges, cudaStream_t st) {
  const int smem = bwd_smem(block_nodes, HAS_X, HAS_EIN);
  int err = set_smem(spmm_bwd_kernel<HAS_X, HAS_EIN>, smem);
  if (err) return err;
  const int n_blocks = N / block_nodes;
  dim3 grid(n_blocks, (F + FT - 1) / FT);
  spmm_bwd_kernel<HAS_X, HAS_EIN><<<grid, THREADS, smem, st>>>(
      g, ein, snd, rcv, w, dx, dW_part, F, K, block_nodes, block_edges);
  err = (int)cudaGetLastError();
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
int pgt_spmm_fwd_smem(int block_nodes, int K, int has_ein) {
  return fwd_smem(block_nodes, K, has_ein != 0);
}
int pgt_spmm_bwd_smem(int block_nodes, int has_x, int has_ein) {
  return bwd_smem(block_nodes, has_x != 0, has_ein != 0);
}

// Forward: writes out [N, F]. x [N, F] is read only with has_x; ein [E, K]
// and W [K, F] only with has_ein. E = (N / block_nodes) * block_edges.
// Returns the first CUDA error, 0 if none.
int pgt_spmm_fwd(const float* x, const float* ein, const float* W,
                 const int* snd, const int* rcv, const float* w, float* out,
                 int N, int F, int K, int block_nodes, int block_edges,
                 int has_x, int has_ein, void* stream) {
  if (bad_shape(N, F, K, block_nodes, block_edges, has_x, has_ein,
                fwd_smem(block_nodes, K, has_ein != 0)))
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
                bwd_smem(block_nodes, has_x != 0, has_ein != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (has_x && has_ein)
    return launch_bwd<true, true>(g, ein, snd, rcv, w, dx, dW, dW_part, N, F, K, block_nodes, block_edges, st);
  if (has_x)
    return launch_bwd<true, false>(g, ein, snd, rcv, w, dx, dW, dW_part, N, F, K, block_nodes, block_edges, st);
  return launch_bwd<false, true>(g, ein, snd, rcv, w, dx, dW, dW_part, N, F, K, block_nodes, block_edges, st);
}

}  // extern "C"
