// Fused GIN conv (K1) for Hopper (sm_90a), forward and backward.
//
// Replaces the Pallas TPU kernel pretrain_gnns_tpu/ops/pallas_gin.py
// (_fwd_kernel via _call_fwd, _bwd_kernel via _call_bwd, wrapped by the
// custom_vjp fused_gin_conv). One GIN layer on the block-diagonal batch:
//
//   msg_e  = w_e * (x[snd_e] + ein_e @ We)
//   aggr_i = sum_{rcv_e = i} msg_e + (x_i + e_self) * nm_i
//   z      = relu(aggr @ W1 + b1)          (saved for the backward)
//   out    = z @ W2 + b2
//
// Backward from the saved aggr and z (not recomputed):
//   dzr = (g @ W2^T) * (z > 0); dW2 = z^T g; db2 = sum g;
//   dW1 = aggr^T dzr; db1 = sum dzr; da = dzr @ W1^T;
//   dx_n = sum_{snd_e = n} w_e * da[rcv_e] + da_n * nm_n;
//   dWe  = sum_e (w_e * ein_e)^T da[rcv_e];  de_self = sum_n da_n * nm_n.
//
// What bounds it on the card: at the main path's shapes (N = 8192 rows,
// F = 300, 2F = 600, about 14 k valid edges) the two forward and four
// backward products are about 5.9 and 11.8 GFLOP per layer against
// about 50-60 MB of device-memory traffic per direction, so in float32 on
// the CUDA cores the layer is bound by operations (67 TFLOP/s peak), not
// by bytes (3.35 TB/s). The aggregation is a small share of the work.
//
// Design:
// - The TPU kernel gathered and scattered with one-hot matmuls on the MXU.
//   Here one CTA per (node block, 32-wide feature tile) keeps the block's
//   rows in a shared f32 tile, a lane per feature, and each warp is the
//   only writer of the rows it owns (the slot walk of slot_walk.cuh, K6's
//   scheme): no atomics, and every sum is taken in slot order, so aggr, dx
//   and dWe are the same bits from run to run. Padded edge slots (w == 0)
//   and any slot whose endpoints fall outside its block add nothing.
// - The edge term is reassociated: aggr_r = sum_{rcv_e = r} w_e x[snd_e]
//   + A_r @ We with A_r = sum_{rcv_e = r} w_e ein_e. The owning warp adds
//   w_e ein_e into the block's [block_nodes, K] row sums A in shared memory
//   (lanes k < K, one add a slot), then each row gets A_r @ We with the
//   lane's column of We in registers: K FMAs a row, not a slot. In the
//   backward, dWe = sum_r A_r^T da_r per block: the backward walks the
//   slots by sender (for dx) and by receiver (to rebuild A, which costs
//   one add a slot and saves keeping A from the forward).
// - The MLP products go through the GEMM of gemm.cuh (register-tiled,
//   double-buffered cp.async, full float32, no TF32) with a
//   bias/ReLU/(z > 0) epilogue. Operand strides are arguments, so
//   transposed operands need no copies. Weight gradients contract over
//   all N rows; they split K into partial products that a second pass
//   sums in a fixed order.
// - The TPU carried the cross-block sums (dWe, de_self) in VMEM across a
//   sequential grid. Hopper's blocks run in no order, so each node block
//   writes its partial and a second pass sums the partials in block order.
// Every output is summed in a fixed order: the kernels give the same bits
// on every run.

#include <cuda_runtime.h>

#include "gemm.cuh"
#include "slot_walk.cuh"

namespace {

constexpr int FT = 32;                    // feature tile: one warp wide
constexpr int AGG_THREADS = 256;
constexpr int AGG_WARPS = AGG_THREADS / FT;
constexpr int MAX_BN = 256;               // node rows per block
constexpr int MAX_K = 16;                 // edge input width
constexpr int DEFAULT_SMEM = 48 * 1024;   // above this only after opting in

// shared floats of an aggregation CTA: the rows' feature tile and their
// edge-input sums, [block_nodes][FT + MAX_K]; the backward reuses them for
// its cross-warp sums, [AGG_WARPS][MAX_K + 1][FT]
int aggr_smem(int block_nodes) {
  const int rows = block_nodes * (FT + MAX_K);
  const int red = AGG_WARPS * (MAX_K + 1) * FT;
  return (rows > red ? rows : red) * (int)sizeof(float);
}

__global__ void __launch_bounds__(AGG_THREADS)
gin_aggr_fwd_kernel(const float* __restrict__ x, const float* __restrict__ ein,
                    const float* __restrict__ We, const float* __restrict__ e_self,
                    const int* __restrict__ snd, const int* __restrict__ rcv,
                    const float* __restrict__ w, const float* __restrict__ nm,
                    float* __restrict__ aggr, int F, int K, int block_nodes,
                    int block_edges) {
  extern __shared__ float smem[];
  float* acc = smem;                        // [block_nodes][FT]
  float* asum = smem + block_nodes * FT;    // [block_nodes][MAX_K]
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int lane = threadIdx.x % FT;
  const int warp = threadIdx.x / FT;
  const int f = f0 + lane;
  const bool fok = f < F;
  // a warp zeroes, fills and reads only the rows it owns: no block barrier
  for (int r = warp; r < block_nodes; r += AGG_WARPS) {
    acc[r * FT + lane] = 0.f;
    if (lane < MAX_K) asum[r * MAX_K + lane] = 0.f;
  }
  float we_f[MAX_K];  // this lane's column of We
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) we_f[k] = (k < K && fok) ? We[(ll)k * F + f] : 0.f;
  __syncwarp();

  const ll base = (ll)b * block_nodes;
  const ll e0 = (ll)b * block_edges;
  for (int q0 = 0; q0 < block_edges; q0 += FT) {
    int ls, lr;
    float we;
    load_slot(snd, rcv, w, e0, base, q0 + lane, block_nodes, block_edges, ls,
              lr, we);
    walk_owned(lr, ls, lr, we, warp, AGG_WARPS,
               [&](int src, int s, int r, float wq) {
                 if (lane < K)
                   asum[r * MAX_K + lane] = fmaf(
                       wq, ein[(e0 + q0 + src) * K + lane],
                       asum[r * MAX_K + lane]);
                 if (fok)
                   acc[r * FT + lane] = fmaf(wq, x[(base + s) * F + f],
                                             acc[r * FT + lane]);
               });
  }
  __syncwarp();

  if (!fok) return;
  const float es = e_self[f];
  for (int r = warp; r < block_nodes; r += AGG_WARPS) {
    float e = 0.f;  // A_r @ We[:, f]
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (k < K) e = fmaf(asum[r * MAX_K + k], we_f[k], e);
    const ll n = base + r;
    aggr[n * F + f] = acc[r * FT + lane] + e + (x[n * F + f] + es) * nm[n];
  }
}

__global__ void __launch_bounds__(AGG_THREADS)
gin_aggr_bwd_kernel(const float* __restrict__ da, const float* __restrict__ ein,
                    const int* __restrict__ snd, const int* __restrict__ rcv,
                    const float* __restrict__ w, const float* __restrict__ nm,
                    float* __restrict__ dx, float* __restrict__ dWe_part,
                    float* __restrict__ des_part, int F, int K, int block_nodes,
                    int block_edges) {
  extern __shared__ float smem[];
  float* acc = smem;                        // [block_nodes][FT], by sender
  float* asum = smem + block_nodes * FT;    // [block_nodes][MAX_K], by receiver
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int lane = threadIdx.x % FT;
  const int warp = threadIdx.x / FT;
  const int f = f0 + lane;
  const bool fok = f < F;
  for (int r = warp; r < block_nodes; r += AGG_WARPS) {
    acc[r * FT + lane] = 0.f;
    if (lane < MAX_K) asum[r * MAX_K + lane] = 0.f;
  }
  __syncwarp();

  const ll base = (ll)b * block_nodes;
  const ll e0 = (ll)b * block_edges;
  for (int q0 = 0; q0 < block_edges; q0 += FT) {
    int ls, lr;
    float we;
    load_slot(snd, rcv, w, e0, base, q0 + lane, block_nodes, block_edges, ls,
              lr, we);
    walk_owned(ls, ls, lr, we, warp, AGG_WARPS,
               [&](int, int s, int r, float wq) {
                 if (fok)
                   acc[s * FT + lane] = fmaf(wq, da[(base + r) * F + f],
                                             acc[s * FT + lane]);
               });
    walk_owned(lr, ls, lr, we, warp, AGG_WARPS,
               [&](int src, int, int r, float wq) {
                 if (lane < K)
                   asum[r * MAX_K + lane] = fmaf(
                       wq, ein[(e0 + q0 + src) * K + lane],
                       asum[r * MAX_K + lane]);
               });
  }
  __syncwarp();

  float dwe[MAX_K];  // sum over the warp's rows of A_r[k] * da_r[f]
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) dwe[k] = 0.f;
  float des = 0.f;
  for (int r = warp; r < block_nodes; r += AGG_WARPS) {
    const ll n = base + r;
    const float d = fok ? da[n * F + f] : 0.f;
    const float dn = d * nm[n];
    des += dn;
    if (fok) dx[n * F + f] = acc[r * FT + lane] + dn;
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (k < K) dwe[k] = fmaf(asum[r * MAX_K + k], d, dwe[k]);
  }
  __syncthreads();  // smem is reused below for the cross-warp sums

  float* red_we = smem;                           // [AGG_WARPS][MAX_K][FT]
  float* red_es = smem + AGG_WARPS * MAX_K * FT;  // [AGG_WARPS][FT]
#pragma unroll
  for (int k = 0; k < MAX_K; ++k)
    if (k < K) red_we[(warp * MAX_K + k) * FT + lane] = dwe[k];
  red_es[warp * FT + lane] = des;
  __syncthreads();

  for (int i = threadIdx.x; i < K * FT; i += AGG_THREADS) {
    const int k = i / FT, l = i % FT;
    float s = 0.f;
    for (int v = 0; v < AGG_WARPS; ++v) s += red_we[(v * MAX_K + k) * FT + l];
    if (f0 + l < F) dWe_part[((ll)b * K + k) * F + f0 + l] = s;
  }
  const int t = threadIdx.x;
  if (t < FT && f0 + t < F) {
    float s = 0.f;
    for (int v = 0; v < AGG_WARPS; ++v) s += red_es[v * FT + t];
    des_part[(ll)b * F + f0 + t] = s;
  }
}

template <typename Kernel, typename... Args>
int launch_aggr(Kernel kernel, int n_blocks, int F, int block_nodes,
                cudaStream_t st, Args... args) {
  const int smem = aggr_smem(block_nodes);
  if (smem > DEFAULT_SMEM) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  dim3 grid(n_blocks, (F + FT - 1) / FT);
  kernel<<<grid, AGG_THREADS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

struct BwdWork {
  float* dzr;       // [N, F2]
  float* da;        // [N, F]
  float* part;      // split-K partials of dW1 / dW2
  float* cpart;     // column-sum partials of db1 / db2
  float* dWe_part;  // [n_blocks, K, F]
  float* des_part;  // [n_blocks, F]
  ll total;
};

BwdWork carve(float* base, int N, int F, int F2, int K, int n_blocks) {
  BwdWork w;
  ll off = 0;
  auto take = [&](ll n) { float* p = base ? base + off : nullptr; off += (n + 3) / 4 * 4; return p; };
  const ll s2 = (ll)wgrad_splits(F2, F, N) * F2 * F;
  const ll s1 = (ll)wgrad_splits(F, F2, N) * F * F2;
  const ll chunks = (N + COLSUM_ROWS - 1) / COLSUM_ROWS;
  w.dzr = take((ll)N * F2);
  w.da = take((ll)N * F);
  w.part = take(s1 > s2 ? s1 : s2);
  w.cpart = take(chunks * (F2 > F ? F2 : F));
  w.dWe_part = take((ll)n_blocks * K * F);
  w.des_part = take((ll)n_blocks * F);
  w.total = off;
  return w;
}

bool bad_shape(int N, int K, int block_nodes, int block_edges) {
  return block_nodes <= 0 || block_nodes > MAX_BN || block_edges <= 0 ||
         K > MAX_K || N % block_nodes != 0;
}

}  // namespace

extern "C" {

// Float32 elements of scratch that pgt_gin_conv_bwd needs.
long long pgt_gin_conv_bwd_workspace(int N, int F, int F2, int K,
                                     int n_blocks) {
  return carve(nullptr, N, F, F2, K, n_blocks).total;
}

int pgt_gin_conv_max_block_nodes() { return MAX_BN; }
int pgt_gin_conv_max_k() { return MAX_K; }

// Forward: writes out [N, F], aggr [N, F] and z [N, F2]. W1 is [F, F2] and
// W2 [F2, F] with any strides. Returns the first CUDA error, 0 if none.
int pgt_gin_conv_fwd(const float* x, const float* ein, const float* We,
                     const float* e_self, const float* W1, ll w1s0, ll w1s1,
                     const float* b1, const float* W2, ll w2s0, ll w2s1,
                     const float* b2, const int* snd, const int* rcv,
                     const float* w, const float* nm, float* out, float* aggr,
                     float* z, int N, int F, int F2, int K, int block_nodes,
                     int block_edges, void* stream) {
  if (bad_shape(N, K, block_nodes, block_edges)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_blocks = N / block_nodes;
  int err = launch_aggr(gin_aggr_fwd_kernel, n_blocks, F, block_nodes, st, x,
                        ein, We, e_self, snd, rcv, w, nm, aggr, F, K,
                        block_nodes, block_edges);
  if (err) return err;
  err = gemm(aggr, F, 1, W1, w1s0, w1s1, z, N, F2, F, 1, nullptr, b1, nullptr, 1, st);
  if (err) return err;
  return gemm(z, F2, 1, W2, w2s0, w2s1, out, N, F, F2, 1, nullptr, b2, nullptr, 0, st);
}

// Backward: writes dx [N, F], dWe [K, F], des [F], dW1 [F, F2], db1 [F2],
// dW2 [F2, F], db2 [F]. ``work`` holds pgt_gin_conv_bwd_workspace floats.
int pgt_gin_conv_bwd(const float* g, const float* aggr, const float* z,
                     const float* ein, const float* W1, ll w1s0, ll w1s1,
                     const float* W2, ll w2s0, ll w2s1, const int* snd,
                     const int* rcv, const float* w, const float* nm,
                     float* dx, float* dWe, float* des, float* dW1,
                     float* db1, float* dW2, float* db2, float* work, int N,
                     int F, int F2, int K, int block_nodes, int block_edges,
                     void* stream) {
  if (bad_shape(N, K, block_nodes, block_edges)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_blocks = N / block_nodes;
  const BwdWork wk = carve(work, N, F, F2, K, n_blocks);
  int err;
  // dzr = (g @ W2^T) * (z > 0): B(k = f, j = c) = W2[c, f]
  err = gemm(g, F, 1, W2, w2s1, w2s0, wk.dzr, N, F2, F, 1, nullptr, nullptr, z, 0, st);
  if (err) return err;
  // dW2 = z^T g: A(i = c, k = n) = z[n, c]
  err = gemm(z, 1, F2, g, F, 1, dW2, F2, F, N, wgrad_splits(F2, F, N), wk.part, nullptr, nullptr, 0, st);
  if (err) return err;
  err = colsum(g, N, F, wk.cpart, db2, st);
  if (err) return err;
  // dW1 = aggr^T dzr
  err = gemm(aggr, 1, F, wk.dzr, F2, 1, dW1, F, F2, N, wgrad_splits(F, F2, N), wk.part, nullptr, nullptr, 0, st);
  if (err) return err;
  err = colsum(wk.dzr, N, F2, wk.cpart, db1, st);
  if (err) return err;
  // da = dzr @ W1^T: B(k = c, j = f) = W1[f, c]
  err = gemm(wk.dzr, F2, 1, W1, w1s1, w1s0, wk.da, N, F, F2, 1, nullptr, nullptr, nullptr, 0, st);
  if (err) return err;
  err = launch_aggr(gin_aggr_bwd_kernel, n_blocks, F, block_nodes, st, wk.da,
                    ein, snd, rcv, w, nm, dx, wk.dWe_part, wk.des_part, F, K,
                    block_nodes, block_edges);
  if (err) return err;
  err = sum_partials(wk.dWe_part, n_blocks, (ll)K * F, F, dWe, nullptr, nullptr, 0, st);
  if (err) return err;
  return sum_partials(wk.des_part, n_blocks, F, F, des, nullptr, nullptr, 0, st);
}

// The GEMM of gemm.cuh alone, for tests and timing: C [M, N] =
// epilogue(A @ B) with A(i, k) = A[i*sa0 + k*sa1], B(k, j) = B[k*sb0 +
// j*sb1]; bias [N] and pos_mask [M, N] may be null. With splits > 1,
// ``part`` holds pgt_gemm_workspace floats.
// The splits of K that K1's (and K4's) weight gradients take.
int pgt_gemm_wgrad_splits(int M, int N, int K) {
  return wgrad_splits(M, N, K);
}

long long pgt_gemm_workspace(int M, int N, int K, int splits) {
  const int k_chunk = ((K + splits - 1) / splits + TK - 1) / TK * TK;
  const int s = (K + k_chunk - 1) / k_chunk;
  return s > 1 ? (ll)s * M * N : 0;
}

int pgt_gemm(const float* A, ll sa0, ll sa1, const float* B, ll sb0, ll sb1,
             float* C, int M, int N, int K, int splits, float* part,
             const float* bias, const float* pos_mask, int relu,
             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  return gemm(A, sa0, sa1, B, sb0, sb1, C, M, N, K, splits, part, bias,
              pos_mask, relu, (cudaStream_t)stream);
}

}  // extern "C"
