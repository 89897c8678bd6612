// Tiled float32 GEMM, ordered partial sums and column sums, shared by the
// fused GIN conv (gin_conv.cu) and the fused GAT conv (gat.cu).
//
// What bounds it: full float32 on the CUDA cores (no TF32: the port is held
// to the JAX package in float32), 67 TFLOP/s on the H100 SXM. At K1's
// shapes (8,192 x 300 x 600) a product does 2.9 GFLOP on 10-30 MB, so it is
// bound by operations, and what the kernel must do is keep the FMA units
// fed: every shared-memory load has to serve many FMAs, and the loads of
// the next k-tile have to overlap the FMAs of this one.
//
// Design:
// - Register tiles: a thread computes 8 rows by 4 or 8 columns. A product
//   over all the batch's rows (M = 8,192: K1's and K4's activation
//   products) takes 128 x 64 CTA tiles, 256 threads of 8 x 4: a product
//   of 8,192 x 600 or 8,192 x 300 has too few 8 x 8 tiles to keep enough
//   warps on 132 SMs, and on the card the smaller tile ran faster. N = 600
//   computes 640 columns (6.25% waste), N = 300 computes 320 (6.25%). A
//   weight gradient (a split-K product of M = 300 or 600 rows, N = 600 or
//   300 columns) takes 128 x 128 tiles, 256 threads of 8 x 8: it computes
//   384 or 640 rows and 640 or 384 columns (up to 22% waste), and on the
//   card that ran faster than 128 x 64 tiles for N = 300.
// - Each operand is staged in shared memory along its contiguous
//   dimension, so that cp.async copies it without a transpose: an operand
//   contiguous along its rows (m for A, n for B: the weight gradients' z^T,
//   aggr^T, h^T and the cotangents) k-major as [TK][rows], one contiguous
//   along k (activations in row-major layout, linear.weight.t() views)
//   row-major as [rows][TK + 4]. Either way a thread reads float4s: four
//   rows of one k from a k-major tile, four k of one row from a row-major
//   one. Per four k, a thread of 8 x 8 loads 8 float4 of A and 8 of B for
//   256 FMAs, one of 8 x 4 8 and 4 for 128. A thread's rows (columns) are
//   adjacent fours in a k-major tile and rows 16 (or TN / CPT) apart in a
//   row-major one, so that a warp's float4 reads hit distinct banks; the
//   pitch TK + 4 keeps a row-major tile's 16-byte reads aligned and
//   conflict-free.
// - Two shared-memory stages filled by cp.async: the copies of k-tile t + 1
//   are in flight while the FMAs of k-tile t run. 16-byte copies where the
//   operand's contiguous stride is 1, the other stride a multiple of 4 and
//   the base 16-byte aligned (rows of 300 and 600 floats are), with the
//   hardware's zero fill for the ragged edge; 4-byte copies otherwise.
// - Each output is one thread's sum over k in increasing order, so a
//   product is the same bits on every run. A product that contracts over
//   many rows (a weight gradient) splits K into partial products that a
//   second pass sums in a fixed order. Epilogue: bias, ReLU, (mask > 0).
// Everything here has internal linkage (an anonymous namespace), so each
// including source gets its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TM = 128, TK = 16;  // CTA tile rows and depth
constexpr int TKP = TK + 4;       // row pitch of a k-contiguous tile
constexpr int NUM_SMS = 132;      // H100 SXM
constexpr int COLSUM_ROWS = 128;  // rows per column-sum partial

typedef long long ll;

__device__ __forceinline__ float epilogue(float v, ll i, ll j, ll N,
                                          const float* bias,
                                          const float* pos_mask, int relu) {
  if (bias) v += bias[j];
  if (relu) v = fmaxf(v, 0.f);
  if (pos_mask) v = pos_mask[i * N + j] > 0.f ? v : 0.f;
  return v;
}

// Asynchronous copies into shared memory; bytes < the copy size fills the
// rest of the destination with zeros (bytes = 0 reads nothing).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group (the one just committed) is in flight
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copies of one operand tile: X(r, k) = X[r*s_r + k*s_k] for the
// tile's R rows from r0 (valid below rmax) and TK k from k0 (valid below
// ke), k-major ([TK][R]) with KMAJ, else row-major ([R][TKP]).
template <int R, bool KMAJ, int NT>
__device__ __forceinline__ void load_tile(float* sm,
                                          const float* __restrict__ X,
                                          ll s_r, ll s_k, int r0, int rmax,
                                          int k0, int ke, bool vec, int tid) {
  if (vec) {
    constexpr int GROUPS = R * TK / 4;  // 16-byte groups
#pragma unroll
    for (int l = tid; l < GROUPS; l += NT) {
      int r, k, bytes;
      if (KMAJ) {
        k = l / (R / 4);
        r = l % (R / 4) * 4;
        bytes = k0 + k < ke ? 4 * max(0, min(4, rmax - (r0 + r))) : 0;
      } else {
        r = l / (TK / 4);
        k = l % (TK / 4) * 4;
        bytes = r0 + r < rmax ? 4 * max(0, min(4, ke - (k0 + k))) : 0;
      }
      const float* src = bytes ? X + (ll)(r0 + r) * s_r + (ll)(k0 + k) * s_k
                               : X;
      cp_async16(KMAJ ? sm + k * R + r : sm + r * TKP + k, src, bytes);
    }
  } else {
#pragma unroll 4
    for (int l = tid; l < R * TK; l += NT) {
      int r, k;
      if (KMAJ) {  // consecutive threads on consecutive rows
        k = l / R;
        r = l % R;
      } else {     // consecutive threads on consecutive k
        r = l / TK;
        k = l % TK;
      }
      const bool ok = r0 + r < rmax && k0 + k < ke;
      const float* src = ok ? X + (ll)(r0 + r) * s_r + (ll)(k0 + k) * s_k : X;
      cp_async4(KMAJ ? sm + k * R + r : sm + r * TKP + k, src, ok ? 4 : 0);
    }
  }
}

// C[M, N] = epilogue(sum_k A(i, k) * B(k, j)), A(i, k) = A[i*sa0 + k*sa1],
// B(k, j) = B[k*sb0 + j*sb1], on TM x TN tiles, CPT columns a thread; A_KM:
// A staged k-major (sa0 == 1), B_KM: B staged k-major (sb1 == 1). With
// gridDim.z > 1, slice z of K writes its raw partial product to
// C + z*M*N and the epilogue is left to the sum.
template <int TN, int CPT, bool A_KM, bool B_KM>
__global__ void __launch_bounds__(16 * (TN / CPT), 512 / (16 * (TN / CPT)))
gemm_kernel(const float* __restrict__ A, ll sa0, ll sa1,
            const float* __restrict__ B, ll sb0, ll sb1,
            float* __restrict__ C, int M, int N, int K, int k_chunk,
            bool a_vec, bool b_vec, const float* __restrict__ bias,
            const float* __restrict__ pos_mask, int relu) {
  constexpr int TX = TN / CPT;  // threads along n; 16 along m
  constexpr int NT = 16 * TX;
  constexpr int A_SIZE = A_KM ? TK * TM : TM * TKP;
  constexpr int B_SIZE = B_KM ? TK * TN : TN * TKP;
  __shared__ __align__(16) float sA[2][A_SIZE];
  __shared__ __align__(16) float sB[2][B_SIZE];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int tiles = (ke - kb + TK - 1) / TK;
  float acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // B(k, j) is a tile of rows j: s_r = sb1, s_k = sb0
  load_tile<TM, A_KM, NT>(sA[0], A, sa0, sa1, m0, M, kb, ke, a_vec, tid);
  load_tile<TN, B_KM, NT>(sB[0], B, sb1, sb0, n0, N, kb, ke, b_vec, tid);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int k1 = kb + (t + 1) * TK;
      load_tile<TM, A_KM, NT>(sA[(t + 1) & 1], A, sa0, sa1, m0, M, k1, ke,
                              a_vec, tid);
      load_tile<TN, B_KM, NT>(sB[(t + 1) & 1], B, sb1, sb0, n0, N, k1, ke,
                              b_vec, tid);
    }
    cp_async_commit();
    cp_async_wait_prior();  // k-tile t has landed (this thread's copies)
    __syncthreads();        // ... and every other thread's
    const float* a = sA[t & 1];
    const float* b = sB[t & 1];
#pragma unroll
    for (int kq = 0; kq < TK; kq += 4) {
      float bf[4][CPT];  // B(kq + q, thread's column j)
      if (B_KM) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int h = 0; h < CPT / 4; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(
                b + (kq + q) * TN + h * (TN / 2) + tx * 4);
            bf[q][4 * h] = v.x; bf[q][4 * h + 1] = v.y;
            bf[q][4 * h + 2] = v.z; bf[q][4 * h + 3] = v.w;
          }
      } else {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(b + (tx + TX * j) * TKP + kq);
          bf[0][j] = v.x; bf[1][j] = v.y; bf[2][j] = v.z; bf[3][j] = v.w;
        }
      }
      if (A_KM) {  // four rows of one k a load, k in increasing order
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(
                a + (kq + q) * TM + h * (TM / 2) + ty * 4);
            const float av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int j = 0; j < CPT; ++j)
                acc[h * 4 + r][j] = fmaf(av[r], bf[q][j], acc[h * 4 + r][j]);
          }
      } else {     // four k of one row a load
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(a + (ty + 16 * i) * TKP + kq);
          const float av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              acc[i][j] = fmaf(av[q], bf[q][j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the stage is refilled two k-tiles on
  }

  const bool raw = gridDim.z > 1;
  float* out = C + (ll)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = m0 + (A_KM ? i / 4 * (TM / 2) + ty * 4 + i % 4
                              : ty + 16 * i);
    if (gi >= M) continue;
    if (B_KM) {  // four adjacent columns: one 16-byte store where it fits
#pragma unroll
      for (int h = 0; h < CPT / 4; ++h) {
        const int gj = n0 + h * (TN / 2) + tx * 4;
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[c] = acc[i][h * 4 + c];
          if (!raw && gj + c < N)
            v[c] = epilogue(v[c], gi, gj + c, N, bias, pos_mask, relu);
        }
        float* o = out + (ll)gi * N + gj;
        if (N % 4 == 0 && gj + 3 < N) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (gj + c < N) o[c] = v[c];
        }
      }
    } else {     // columns TX apart: a warp's stores are contiguous
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int gj = n0 + tx + TX * j;
        if (gj >= N) continue;
        float v = acc[i][j];
        if (!raw) v = epilogue(v, gi, gj, N, bias, pos_mask, relu);
        out[(ll)gi * N + gj] = v;
      }
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
  const int tiles = ((M + TM - 1) / TM) * ((N + 127) / 128);
  int s = (2 * NUM_SMS + tiles - 1) / tiles;
  const int cap = K / 256 > 1 ? K / 256 : 1;
  if (s > cap) s = cap;
  return s > 1 ? s : 1;
}

template <int TN, int CPT, bool A_KM, bool B_KM>
void launch_gemm(dim3 grid, cudaStream_t st, const float* A, ll sa0, ll sa1,
                 const float* B, ll sb0, ll sb1, float* C, int M, int N,
                 int K, int k_chunk, bool a_vec, bool b_vec,
                 const float* bias, const float* pos_mask, int relu) {
  gemm_kernel<TN, CPT, A_KM, B_KM><<<grid, 16 * (TN / CPT), 0, st>>>(
      A, sa0, sa1, B, sb0, sb1, C, M, N, K, k_chunk, a_vec, b_vec, bias,
      pos_mask, relu);
}

template <int TN, int CPT>
void launch_gemm_tn(bool a_km, bool b_km, dim3 grid, cudaStream_t st,
                    const float* A, ll sa0, ll sa1, const float* B, ll sb0,
                    ll sb1, float* C, int M, int N, int K, int k_chunk,
                    bool a_vec, bool b_vec, const float* bias,
                    const float* pos_mask, int relu) {
  auto fn = a_km ? (b_km ? launch_gemm<TN, CPT, true, true>
                         : launch_gemm<TN, CPT, true, false>)
                 : (b_km ? launch_gemm<TN, CPT, false, true>
                         : launch_gemm<TN, CPT, false, false>);
  fn(grid, st, A, sa0, sa1, B, sb0, sb1, C, M, N, K, k_chunk, a_vec, b_vec,
     bias, pos_mask, relu);
}

bool aligned16(const float* p) { return ((size_t)p & 15) == 0; }

int gemm(const float* A, ll sa0, ll sa1, const float* B, ll sb0, ll sb1,
         float* C, int M, int N, int K, int splits, float* part,
         const float* bias, const float* pos_mask, int relu, cudaStream_t st) {
  const int k_chunk = ((K + splits - 1) / splits + TK - 1) / TK * TK;
  splits = (K + k_chunk - 1) / k_chunk;
  const bool split = splits > 1;
  const int tn = split ? 128 : 64;  // see the note above
  dim3 grid((N + tn - 1) / tn, (M + TM - 1) / TM, split ? splits : 1);
  // each operand staged along its contiguous dimension (see the note above)
  const bool a_km = sa0 == 1 && sa1 != 1;
  const bool b_km = sb1 == 1 && sb0 != 1;
  const bool a_vec = aligned16(A) && (a_km ? sa1 % 4 == 0
                                           : sa1 == 1 && sa0 % 4 == 0);
  const bool b_vec = aligned16(B) && (b_km ? sb0 % 4 == 0
                                           : sb0 == 1 && sb1 % 4 == 0);
  float* dst = split ? part : C;
  const float* bi = split ? nullptr : bias;
  const float* pm = split ? nullptr : pos_mask;
  const int rl = split ? 0 : relu;
  const int kc = split ? k_chunk : K;
  if (split)
    launch_gemm_tn<128, 8>(a_km, b_km, grid, st, A, sa0, sa1, B, sb0, sb1,
                           dst, M, N, K, kc, a_vec, b_vec, bi, pm, rl);
  else
    launch_gemm_tn<64, 4>(a_km, b_km, grid, st, A, sa0, sa1, B, sb0, sb1, dst,
                          M, N, K, kc, a_vec, b_vec, bi, pm, rl);
  const int err = (int)cudaGetLastError();
  if (err || !split) return err;
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
