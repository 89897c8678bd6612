// Tiled float32 GEMM, ordered partial sums and column sums, shared by the
// fused GIN conv (gin_conv.cu) and the fused GAT conv (gat.cu).
//
// One tiled FMA GEMM (64x64x16 tiles, 4x4 outputs per thread, full float32,
// no TF32) with a bias/ReLU/(mask > 0) epilogue. Operand strides are
// arguments, so transposed operands need no copies. A product that
// contracts over many rows (a weight gradient) splits K into partial
// products that a second pass sums in a fixed order, so every result is the
// same bits from run to run. Everything here has internal linkage
// (an anonymous namespace), so each including source gets its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64, TN = 64, TK = 16;  // GEMM tile
constexpr int GEMM_THREADS = 256;         // 16 x 16 threads, 4 x 4 each
constexpr int NUM_SMS = 132;              // H100 SXM
constexpr int COLSUM_ROWS = 128;          // rows per column-sum partial

typedef long long ll;

__device__ __forceinline__ float epilogue(float v, ll i, ll j, ll N,
                                          const float* bias,
                                          const float* pos_mask, int relu) {
  if (bias) v += bias[j];
  if (relu) v = fmaxf(v, 0.f);
  if (pos_mask) v = pos_mask[i * N + j] > 0.f ? v : 0.f;
  return v;
}

// C[M, N] = epilogue(sum_k A(i, k) * B(k, j)), A(i, k) = A[i*sa0 + k*sa1],
// B(k, j) = B[k*sb0 + j*sb1]. With gridDim.z > 1, slice z of K writes its
// raw partial product to C + z*M*N and the epilogue is left to the sum.
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const float* __restrict__ A, ll sa0, ll sa1,
            const float* __restrict__ B, ll sb0, ll sb1,
            float* __restrict__ C, int M, int N, int K, int k_chunk,
            const float* __restrict__ bias, const float* __restrict__ pos_mask,
            int relu) {
  __shared__ float As[TK][TM + 1];
  __shared__ float Bs[TK][TN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const bool a_rowfast = (sa0 == 1);  // consecutive rows adjacent in memory
  const bool b_colfast = (sb1 == 1);  // consecutive columns adjacent
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += TK) {
    for (int l = tid; l < TM * TK; l += GEMM_THREADS) {
      int r, kk;
      if (a_rowfast) { r = l % TM; kk = l / TM; } else { kk = l % TK; r = l / TK; }
      const int gi = m0 + r, gk = k0 + kk;
      As[kk][r] = (gi < M && gk < ke) ? A[gi * sa0 + gk * sa1] : 0.f;
    }
    for (int l = tid; l < TN * TK; l += GEMM_THREADS) {
      int c, kk;
      if (b_colfast) { c = l % TN; kk = l / TN; } else { kk = l % TK; c = l / TK; }
      const int gj = n0 + c, gk = k0 + kk;
      Bs[kk][c] = (gj < N && gk < ke) ? B[gk * sb0 + gj * sb1] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool raw = gridDim.z > 1;
  float* out = C + (ll)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = m0 + ty + 16 * i;
    if (gi >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = n0 + tx + 16 * j;
      if (gj >= N) continue;
      float v = acc[i][j];
      if (!raw) v = epilogue(v, gi, gj, N, bias, pos_mask, relu);
      out[(ll)gi * N + gj] = v;
    }
  }
}

// out[i] = epilogue(sum_p part[p*MN + i]), summed in order p = 0, 1, ...
__global__ void sum_partials_kernel(const float* __restrict__ part, int S,
                                    ll MN, int N, float* __restrict__ out,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ pos_mask,
                                    int relu) {
  for (ll idx = blockIdx.x * (ll)blockDim.x + threadIdx.x; idx < MN;
       idx += (ll)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < S; ++p) s += part[p * MN + idx];
    out[idx] = epilogue(s, idx / N, idx % N, N, bias, pos_mask, relu);
  }
}

// part[chunk, c] = sum of X[r, c] over the chunk's COLSUM_ROWS rows
__global__ void colsum_partial_kernel(const float* __restrict__ X, int R,
                                      int Cc, float* __restrict__ part) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Cc) return;
  const int r0 = blockIdx.y * COLSUM_ROWS;
  const int r1 = min(R, r0 + COLSUM_ROWS);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += X[(ll)r * Cc + c];
  part[(ll)blockIdx.y * Cc + c] = s;
}

int sum_partials(const float* part, int S, ll MN, int N, float* out,
                 const float* bias, const float* pos_mask, int relu,
                 cudaStream_t st) {
  const ll want = (MN + 255) / 256;
  const int blocks = (int)(want < 4 * NUM_SMS ? want : 4 * NUM_SMS);
  sum_partials_kernel<<<blocks, 256, 0, st>>>(part, S, MN, N, out, bias, pos_mask, relu);
  return (int)cudaGetLastError();
}

// Splits of K for a weight-gradient product: about two waves of CTAs.
int wgrad_splits(int M, int N, int K) {
  const int tiles = ((M + TM - 1) / TM) * ((N + TN - 1) / TN);
  int s = (2 * NUM_SMS + tiles - 1) / tiles;
  const int cap = K / 256 > 1 ? K / 256 : 1;
  if (s > cap) s = cap;
  return s > 1 ? s : 1;
}

int gemm(const float* A, ll sa0, ll sa1, const float* B, ll sb0, ll sb1,
         float* C, int M, int N, int K, int splits, float* part,
         const float* bias, const float* pos_mask, int relu, cudaStream_t st) {
  const int k_chunk = ((K + splits - 1) / splits + TK - 1) / TK * TK;
  splits = (K + k_chunk - 1) / k_chunk;
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, splits);
  if (splits <= 1) {
    grid.z = 1;
    gemm_kernel<<<grid, GEMM_THREADS, 0, st>>>(A, sa0, sa1, B, sb0, sb1, C, M, N, K, K, bias, pos_mask, relu);
    return (int)cudaGetLastError();
  }
  gemm_kernel<<<grid, GEMM_THREADS, 0, st>>>(A, sa0, sa1, B, sb0, sb1, part, M, N, K, k_chunk, nullptr, nullptr, 0);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return sum_partials(part, splits, (ll)M * N, N, C, bias, pos_mask, relu, st);
}

int colsum(const float* X, int R, int Cc, float* part, float* out,
           cudaStream_t st) {
  dim3 grid((Cc + 127) / 128, (R + COLSUM_ROWS - 1) / COLSUM_ROWS);
  colsum_partial_kernel<<<grid, 128, 0, st>>>(X, R, Cc, part);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return sum_partials(part, (int)grid.y, Cc, Cc, out, nullptr, nullptr, 0, st);
}

}  // namespace
