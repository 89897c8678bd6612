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
//   The float kernel may write its output rounded to bfloat16 (K1 with
//   bfloat16 rows at compute_dtype = float32).
// - bfloat16 operands (gemm_bf16, K1 at compute_dtype = bfloat16) go to the
//   tensor cores instead: see the note above gemm_bf16_kernel below.
// Everything here has internal linkage (an anonymous namespace), so each
// including source gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TM = 128, TK = 16;  // CTA tile rows and depth
constexpr int TKP = TK + 4;       // row pitch of a k-contiguous tile
constexpr int NUM_SMS = 132;      // H100 SXM
constexpr int COLSUM_ROWS = 128;  // rows per column-sum partial

typedef long long ll;

__device__ __forceinline__ float epilogue(float v, ll i, ll j, ll N,
                                          const float* bias,
                                          const float* pos_mask, int relu,
                                          bool pm_bf16 = false) {
  if (bias) v += bias[j];
  if (relu) v = fmaxf(v, 0.f);
  if (pos_mask) {
    const float m = pm_bf16
        ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(pos_mask)[i * N + j])
        : pos_mask[i * N + j];
    v = m > 0.f ? v : 0.f;
  }
  return v;
}

// One element of a float or bfloat16 matrix, as a float, rounded to
// bfloat16 with rnd.
__device__ __forceinline__ float ld_elem(const void* X, ll off, bool bf,
                                         bool rnd) {
  float v = bf ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(X)[off])
               : reinterpret_cast<const float*>(X)[off];
  return rnd ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Asynchronous copies into shared memory of ``size`` (16 or 8) or 4 bytes;
// bytes < the copy size fills the rest of the destination with zeros
// (bytes = 0 reads nothing).
__device__ __forceinline__ void cp_async_b(void* dst, const void* src,
                                           int bytes, int size) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes) : "memory");
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

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
      cp_async_b(KMAJ ? sm + k * R + r : sm + r * TKP + k, src, bytes, 16);
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

// The FMAs of one k-tile on the staged tiles a and b, into a thread's 8 x
// CPT accumulators (k in increasing order).
template <int TN, int CPT, bool A_KM, bool B_KM>
__device__ __forceinline__ void fma_tile(float (&acc)[8][CPT],
                                         const float* a, const float* b,
                                         int tx, int ty) {
  constexpr int TX = TN / CPT;
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
}

// Writes a thread's 8 x CPT outputs of the CTA tile at (m0, n0): the raw
// partial product to C + z*M*N with gridDim.z > 1, else epilogue(acc) to C,
// as bfloat16 (rounded to nearest) with c_bf16.
template <int TN, int CPT, bool A_KM, bool B_KM>
__device__ __forceinline__ void store_tile(
    const float (&acc)[8][CPT], void* C, bool c_bf16, int M, int N, int m0,
    int n0, int tx, int ty, const float* bias, const float* pos_mask,
    bool pm_bf16, int relu) {
  constexpr int TX = TN / CPT;
  const bool raw = gridDim.z > 1;
  float* out = reinterpret_cast<float*>(C) + (ll)blockIdx.z * M * N;
  __nv_bfloat16* out16 = reinterpret_cast<__nv_bfloat16*>(C);
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
            v[c] = epilogue(v[c], gi, gj + c, N, bias, pos_mask, relu,
                            pm_bf16);
        }
        if (c_bf16 && !raw) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (gj + c < N) out16[(ll)gi * N + gj + c] = __float2bfloat16_rn(v[c]);
          continue;
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
        if (!raw) v = epilogue(v, gi, gj, N, bias, pos_mask, relu, pm_bf16);
        if (c_bf16 && !raw)
          out16[(ll)gi * N + gj] = __float2bfloat16_rn(v);
        else
          out[(ll)gi * N + gj] = v;
      }
    }
  }
}

// C[M, N] = epilogue(sum_k A(i, k) * B(k, j)), A(i, k) = A[i*sa0 + k*sa1],
// B(k, j) = B[k*sb0 + j*sb1], on TM x TN tiles, CPT columns a thread; A_KM:
// A staged k-major (sa0 == 1), B_KM: B staged k-major (sb1 == 1). With
// gridDim.z > 1, slice z of K writes its raw partial product to
// C + z*M*N and the epilogue is left to the sum; else C is bfloat16 with
// c_bf16.
template <int TN, int CPT, bool A_KM, bool B_KM>
__global__ void __launch_bounds__(16 * (TN / CPT), 512 / (16 * (TN / CPT)))
gemm_kernel(const float* __restrict__ A, ll sa0, ll sa1,
            const float* __restrict__ B, ll sb0, ll sb1,
            void* __restrict__ C, int M, int N, int K, int k_chunk,
            bool a_vec, bool b_vec, const float* __restrict__ bias,
            const float* __restrict__ pos_mask, int relu, bool c_bf16) {
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
    cp_async_wait<1>();  // k-tile t has landed (this thread's copies)
    __syncthreads();        // ... and every other thread's
    fma_tile<TN, CPT, A_KM, B_KM>(acc, sA[t & 1], sB[t & 1], tx, ty);
    __syncthreads();  // the stage is refilled two k-tiles on
  }

  store_tile<TN, CPT, A_KM, B_KM>(acc, C, c_bf16, M, N, m0, n0, tx, ty, bias,
                                  pos_mask, false, relu);
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

// part[chunk, c] = sum of X[r, c] over the chunk's COLSUM_ROWS rows, in row
// order; X stored as bfloat16 with bf, its entries rounded to bfloat16 with
// rnd. COLSUM_U rows' loads are in flight before their adds: the loads'
// latency, not the adds, sets the time.
constexpr int COLSUM_U = 16;

__global__ void colsum_partial_kernel(const void* __restrict__ X, int R,
                                      int Cc, float* __restrict__ part,
                                      bool bf, bool rnd) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Cc) return;
  const int r0 = blockIdx.y * COLSUM_ROWS;
  const int r1 = min(R, r0 + COLSUM_ROWS);
  float s = 0.f;
  for (int r = r0; r < r1; r += COLSUM_U) {
    float v[COLSUM_U];
#pragma unroll
    for (int u = 0; u < COLSUM_U; ++u)
      v[u] = r + u < r1 ? ld_elem(X, (ll)(r + u) * Cc + c, bf, rnd) : 0.f;
#pragma unroll
    for (int u = 0; u < COLSUM_U; ++u)
      if (r + u < r1) s += v[u];
  }
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
                 const float* B, ll sb0, ll sb1, void* C, int M, int N,
                 int K, int k_chunk, bool a_vec, bool b_vec,
                 const float* bias, const float* pos_mask, int relu,
                 bool c_bf16) {
  gemm_kernel<TN, CPT, A_KM, B_KM><<<grid, 16 * (TN / CPT), 0, st>>>(
      A, sa0, sa1, B, sb0, sb1, C, M, N, K, k_chunk, a_vec, b_vec, bias,
      pos_mask, relu, c_bf16);
}

template <int TN, int CPT>
void launch_gemm_tn(bool a_km, bool b_km, dim3 grid, cudaStream_t st,
                    const float* A, ll sa0, ll sa1, const float* B, ll sb0,
                    ll sb1, void* C, int M, int N, int K, int k_chunk,
                    bool a_vec, bool b_vec, const float* bias,
                    const float* pos_mask, int relu, bool c_bf16) {
  auto fn = a_km ? (b_km ? launch_gemm<TN, CPT, true, true>
                         : launch_gemm<TN, CPT, true, false>)
                 : (b_km ? launch_gemm<TN, CPT, false, true>
                         : launch_gemm<TN, CPT, false, false>);
  fn(grid, st, A, sa0, sa1, B, sb0, sb1, C, M, N, K, k_chunk, a_vec, b_vec,
     bias, pos_mask, relu, c_bf16);
}

bool aligned16(const float* p) { return ((size_t)p & 15) == 0; }

// C written as bfloat16 (rounded to nearest) with c_bf16, which a split
// product does not take. Returns the first CUDA error, 0 if none.
int gemm(const float* A, ll sa0, ll sa1, const float* B, ll sb0, ll sb1,
         void* C, int M, int N, int K, int splits, float* part,
         const float* bias, const float* pos_mask, int relu, cudaStream_t st,
         bool c_bf16 = false) {
  const int k_chunk = ((K + splits - 1) / splits + TK - 1) / TK * TK;
  splits = (K + k_chunk - 1) / k_chunk;
  const bool split = splits > 1;
  if (split && c_bf16) return (int)cudaErrorInvalidValue;
  const int tn = split ? 128 : 64;  // see the note above
  dim3 grid((N + tn - 1) / tn, (M + TM - 1) / TM, split ? splits : 1);
  // each operand staged along its contiguous dimension (see the note above)
  const bool a_km = sa0 == 1 && sa1 != 1;
  const bool b_km = sb1 == 1 && sb0 != 1;
  const bool a_vec = aligned16(A) && (a_km ? sa1 % 4 == 0
                                           : sa1 == 1 && sa0 % 4 == 0);
  const bool b_vec = aligned16(B) && (b_km ? sb0 % 4 == 0
                                           : sb0 == 1 && sb1 % 4 == 0);
  void* dst = split ? part : C;
  const float* bi = split ? nullptr : bias;
  const float* pm = split ? nullptr : pos_mask;
  const int rl = split ? 0 : relu;
  const int kc = split ? k_chunk : K;
  if (split)
    launch_gemm_tn<128, 8>(a_km, b_km, grid, st, A, sa0, sa1, B, sb0, sb1,
                           dst, M, N, K, kc, a_vec, b_vec, bi, pm, rl, false);
  else
    launch_gemm_tn<64, 4>(a_km, b_km, grid, st, A, sa0, sa1, B, sb0, sb1, dst,
                          M, N, K, kc, a_vec, b_vec, bi, pm, rl, c_bf16);
  const int err = (int)cudaGetLastError();
  if (err || !split) return err;
  return sum_partials(part, splits, (ll)M * N, N, static_cast<float*>(C),
                      bias, pos_mask, relu, st);
}

int colsum(const void* X, int R, int Cc, float* part, float* out,
           cudaStream_t st, bool bf = false, bool rnd = false) {
  dim3 grid((Cc + 127) / 128, (R + COLSUM_ROWS - 1) / COLSUM_ROWS);
  colsum_partial_kernel<<<grid, 128, 0, st>>>(X, R, Cc, part, bf, rnd);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return sum_partials(part, (int)grid.y, Cc, Cc, out, nullptr, nullptr, 0, st);
}

// ---- gemm_bf16: bfloat16 operands on the tensor cores --------------------
//
// K1 at compute_dtype = bfloat16 (gin_conv.cu's bfloat16 route): the Pallas
// kernel's products of bfloat16 operands with float32 accumulation.
//
// What bounds it: at K1's shapes a product does 2.9 GFLOP and moves 10-30
// MB, so at the bfloat16 tensor-core peak (989 TFLOP/s) it is bound by
// bytes (3-9 us at 3.35 TB/s); on the CUDA cores (gemm above, 67 TFLOP/s)
// it would take 44 us. So the products go to the tensor cores, and what
// the kernel must do is keep them fed from device memory.
//
// Design:
// - mma.sync.m16n8k16 (bfloat16 in, float32 sums) on 128 x 64 CTA tiles, 4
//   warps of 64 x 32 (4 x 4 mma tiles, 64 accumulators a thread), k-tiles
//   of 32. Every operand is bfloat16 in device memory: cp.async cannot
//   convert, so the caller rounds a float operand into scratch first
//   (convert below), once a call.
// - Each operand is staged along its contiguous dimension, as in gemm, so
//   that no transpose copy is made: one contiguous along k as [rows][BK +
//   8], one contiguous along m (A) or n (B) as [BK][rows + 8] (the weight
//   gradients' z^T and aggr^T, the cotangent and dzr as B, the transposed
//   weight views). ldmatrix loads the fragments, ldmatrix.trans those of
//   the second kind. The pads make each row's offset an odd multiple of 16
//   bytes modulo 128, so the 8 rows an ldmatrix phase reads hit distinct
//   banks.
// - Three shared-memory stages filled by cp.async: the copies of k-tiles t
//   + 1 and t + 2 are in flight while the mma of tile t run. 16-byte copies
//   where the base is 16-byte aligned and the pitch a multiple of 8
//   elements, 8-byte copies where they are 8-byte aligned and the pitch a
//   multiple of 4 (300-wide bfloat16 rows are 600 bytes), else plain
//   element loads (odd pitches and offsets: tests, small widths). The ragged
//   k tail and rows past M or N are zero-filled (cp.async's source size),
//   so the padded products add exact zeros.
// - Float32 sums in two levels: each k-tile's 32 products are summed on
//   the tensor cores from zero, and that partial is added to the thread's
//   float32 accumulator by an ordinary add, k-tile after k-tile. The
//   tensor cores' own float32 adds do not round to nearest; one mma chain
//   over all of K read twice as far from torch.matmul's float32 sums (up
//   to 1.4e-6 of the largest entry against 6.4e-7, on the H100).
// - Optionally (``exact``), roundings decided as under the k-ordered
//   float32 FMA chain: the float kernel's order, and cuBLAS's at these
//   shapes, which the plain version runs. The tensor cores sum in their own
//   order, and the last bits of a sum decide its rounding to bfloat16 when
//   it lies near a midpoint between two bfloat16 values. With ``exact`` an
//   epilogue value within NEAR_TIE float32 ulps of such a midpoint (about
//   0.05% of them) is recomputed as that chain after the tile's stores: the
//   CTA lists them, stages their A rows and B columns in the freed shared
//   memory, and one thread walks each; every other value rounds as the
//   chain's would. K1 asks it of dzr's product, whose bfloat16 copy feeds
//   two later products (measured on the H100: the card tests' mean reading
//   of dWe 4.3e-5 without it, over its limit of 2e-5; 1.2e-6 to 2.0e-6
//   with it).
// - Epilogue as gemm's (bias, ReLU, (mask > 0) with the mask bfloat16),
//   written float32 or bfloat16, optionally also a bfloat16 copy of the
//   float32 result into a second matrix (K1's dzr). A weight gradient
//   splits K into raw float32 partials that sum_partials adds in a fixed
//   order. Each output is one thread's sum in a fixed order: the kernel
//   gives the same bits on every run.

constexpr int TC_BM = 128, TC_BN = 64, TC_BK = 32, TC_STAGES = 3;
constexpr int TC_WARPS_N = 2;                     // 2 x 2 warps
constexpr int TC_NT = 128;
constexpr int TC_WM = 64, TC_WN = 32;             // a warp's tile
constexpr int TC_MI = TC_WM / 16, TC_NI = TC_WN / 8;

// The staged tile of R rows by TC_BK: pitch and size in elements; RC: the
// operand is contiguous along its rows (m or n), staged [TC_BK][R + 8].
template <int R, bool RC>
struct TcTile {
  static constexpr int P = RC ? R + 8 : TC_BK + 8;
  static constexpr int SIZE = RC ? TC_BK * P : R * P;
};


// Copies one operand tile into shared memory: X(r, k) for R rows from r0
// (valid below rmax) and TC_BK k from k0 (valid below ke), X(r, k) =
// X[r*ld + k], or X[k*ld + r] with RC; V elements a copy (8 or 4 by
// cp.async, 1 by plain loads), zeros outside.
template <int R, bool RC, int V>
__device__ __forceinline__ void tc_load(bf16* sm, const bf16* __restrict__ X,
                                        ll ld, int r0, int rmax, int k0,
                                        int ke, int tid) {
  constexpr int P = TcTile<R, RC>::P;
  constexpr int ALONG = (RC ? R : TC_BK) / V;  // copies along the pitch
#pragma unroll
  for (int l = tid; l < R * TC_BK / V; l += TC_NT) {
    const int c = l % ALONG * V, o = l / ALONG;
    const int r = RC ? c : o, k = RC ? o : c;
    int n = RC ? (k0 + k < ke ? rmax - (r0 + r) : 0)
               : (r0 + r < rmax ? ke - (k0 + k) : 0);
    n = max(0, min(V, n));  // valid elements of the copy
    bf16* dst = RC ? sm + k * P + r : sm + r * P + k;
    const bf16* src = X + (RC ? (ll)(k0 + k) * ld + r0 + r
                              : (ll)(r0 + r) * ld + k0 + k);
    if (V > 1)
      cp_async_b(dst, n ? src : X, 2 * n, 2 * V);
    else
      *dst = n ? *src : __ushort_as_bfloat16(0);
  }
}

template <int R, bool RC>
__device__ __forceinline__ void tc_load_any(bf16* sm, const bf16* X, ll ld,
                                            int r0, int rmax, int k0, int ke,
                                            int vec, int tid) {
  if (vec == 8)
    tc_load<R, RC, 8>(sm, X, ld, r0, rmax, k0, ke, tid);
  else if (vec == 4)
    tc_load<R, RC, 4>(sm, X, ld, r0, rmax, k0, ke, tid);
  else
    tc_load<R, RC, 1>(sm, X, ld, r0, rmax, k0, ke, tid);
}

// Four 8 x 8 bfloat16 matrices from shared memory, one row address a lane
// (lanes 8j to 8j + 7 give matrix j's rows); TR transposes each.
template <bool TR>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if (TR)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16 x 16, row) @ b (16 x 8, col), bfloat16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The products of one staged k-tile into a warp's 64 x 32 accumulators at
// (wm0, wn0) of the CTA tile: the tile's 32 products of each output summed
// on the tensor cores from zero, that partial added to the accumulator in
// float32 (see the note above). Fragments: A's 16 x 16 as four 8 x 8
// matrices (rows 0-7 / 8-15 by k 0-7, then by k 8-15), B's 16 x 16 (two n8
// tiles) as (n 0-7 by k 0-7, k 8-15), then n 8-15.
template <bool A_MC, bool B_NC>
__device__ __forceinline__ void tc_tile(float (&acc)[TC_MI][TC_NI][4],
                                        const bf16* a, const bf16* b,
                                        int wm0, int wn0, int lane) {
  constexpr int PA = TcTile<TC_BM, A_MC>::P, PB = TcTile<TC_BN, B_NC>::P;
  constexpr int KS = TC_BK / 16;  // mma k-steps a tile
  const int lr = lane % 8, lj = lane / 8;
  unsigned bfr[KS][TC_NI][2];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int nj = 0; nj < TC_NI; nj += 2) {
      unsigned r[4];
      const int n = wn0 + nj * 8 + (lj / 2) * 8, k = 16 * s + (lj % 2) * 8;
      if (B_NC)  // stored [k][n]
        ldsm_x4<true>(r, b + (k + lr) * PB + n);
      else       // stored [n][k]
        ldsm_x4<false>(r, b + (n + lr) * PB + k);
      bfr[s][nj][0] = r[0];
      bfr[s][nj][1] = r[1];
      bfr[s][nj + 1][0] = r[2];
      bfr[s][nj + 1][1] = r[3];
    }
#pragma unroll
  for (int mi = 0; mi < TC_MI; ++mi) {
    unsigned af[KS][4];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int m = wm0 + mi * 16 + (lj % 2) * 8, k = 16 * s + (lj / 2) * 8;
      if (A_MC)  // stored [k][m]
        ldsm_x4<true>(af[s], a + (k + lr) * PA + m);
      else       // stored [m][k]
        ldsm_x4<false>(af[s], a + (m + lr) * PA + k);
    }
    float part[TC_NI][4];
#pragma unroll
    for (int ni = 0; ni < TC_NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[ni][c] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int ni = 0; ni < TC_NI; ++ni)
        mma_bf16(part[ni], af[s], bfr[s][ni][0], bfr[s][ni][1]);
#pragma unroll
    for (int ni = 0; ni < TC_NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] += part[ni][c];
  }
}

constexpr unsigned NEAR_TIE = 16;  // float32 ulps, see the note above

// True where v lies within NEAR_TIE ulps of a midpoint between two
// bfloat16 values (its low 16 bits near 0x8000): where the order of the
// float32 adds that made it could decide its rounding to bfloat16.
__device__ __forceinline__ bool near_tie(float v) {
  const unsigned low = __float_as_uint(v) & 0xffffu;
  return low + NEAR_TIE > 0x8000u && low < 0x8000u + NEAR_TIE;
}

// The ordered chain's staging in the freed stages: up to FIX_E outputs a
// round, FIX_K of their k a step, rows at an odd word pitch (no bank
// conflicts between the threads that walk them)
constexpr int FIX_E = 16, FIX_K = 608, FIX_P = FIX_K + 2;
static_assert(2 * FIX_E * FIX_P <=
                  TC_STAGES * (TcTile<TC_BM, true>::SIZE +
                               TcTile<TC_BN, true>::SIZE),
              "the ordered chain's staging must fit the stages");

// C[M, N] = epilogue(sum_k A(i, k) * B(k, j)) with A(i, k) = A[i*lda + k]
// (A[k*lda + i] with A_MC) and B(k, j) = B[j*ldb + k] (B[k*ldb + j] with
// B_NC), bfloat16, float32 sums; va, vb: elements a copy (see tc_load).
// With gridDim.z > 1, slice z of K writes its raw partial product to
// (float*)C + z*M*N. Else C (pitch N) is bfloat16 with c_bf16, and C2, if
// set, gets a bfloat16 copy at pitch ldc2.
template <bool A_MC, bool B_NC>
__global__ void __launch_bounds__(TC_NT)
gemm_bf16_kernel(const bf16* __restrict__ A, ll lda,
                 const bf16* __restrict__ B, ll ldb, void* __restrict__ C,
                 bool c_bf16, bf16* __restrict__ C2, ll ldc2, int M, int N,
                 int K, int k_chunk, int va, int vb,
                 const float* __restrict__ bias,
                 const bf16* __restrict__ pos_mask, int relu, bool exact) {
  constexpr int A_SIZE = TcTile<TC_BM, A_MC>::SIZE;
  constexpr int B_SIZE = TcTile<TC_BN, B_NC>::SIZE;
  __shared__ __align__(16) bf16 smem[TC_STAGES * (A_SIZE + B_SIZE)];
  bf16* sA = smem;                       // [TC_STAGES][A_SIZE]
  bf16* sB = smem + TC_STAGES * A_SIZE;  // [TC_STAGES][B_SIZE]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm0 = warp / TC_WARPS_N * TC_WM, wn0 = warp % TC_WARPS_N * TC_WN;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int tiles = (ke - kb + TC_BK - 1) / TC_BK;
  float acc[TC_MI][TC_NI][4];
#pragma unroll
  for (int mi = 0; mi < TC_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TC_NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  auto load = [&](int t) {
    const int s = t % TC_STAGES, k0 = kb + t * TC_BK;
    tc_load_any<TC_BM, A_MC>(sA + s * A_SIZE, A, lda, m0, M, k0, ke, va,
                             tid);
    tc_load_any<TC_BN, B_NC>(sB + s * B_SIZE, B, ldb, n0, N, k0, ke, vb,
                             tid);
  };
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < tiles) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<TC_STAGES - 2>();  // k-tile t has landed (this thread's)
    __syncthreads();  // ... every thread's, and tile t - 1's mma are done
    if (t + TC_STAGES - 1 < tiles) load(t + TC_STAGES - 1);  // tile t - 1's
    cp_async_commit();                                       // stage
    tc_tile<A_MC, B_NC>(acc, sA + t % TC_STAGES * A_SIZE,
                        sB + t % TC_STAGES * B_SIZE, wm0, wn0, lane);
  }

  // accumulator c of mma tile (mi, ni): row g + 8 (c / 2), column 2 t + c % 2
  const bool raw = gridDim.z > 1;
  const int g = lane / 4, t4 = lane % 4;
  float* out = reinterpret_cast<float*>(C) + (raw ? (ll)blockIdx.z * M * N : 0);
  bf16* out16 = reinterpret_cast<bf16*>(C);
  const bool pairs = N % 2 == 0 && ((size_t)C & 7) == 0;  // 2 columns a store
  const bool pairs2 = ldc2 % 2 == 0 && ((size_t)C2 & 3) == 0;
  const float* pm = reinterpret_cast<const float*>(pos_mask);
  unsigned long long ties = 0;  // this thread's outputs near a tie, by bit
#pragma unroll
  for (int mi = 0; mi < TC_MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = m0 + wm0 + mi * 16 + g + 8 * h;
      if (i >= M) continue;
#pragma unroll
      for (int ni = 0; ni < TC_NI; ++ni) {
        const int j = n0 + wn0 + ni * 8 + 2 * t4;
        if (j >= N) continue;
        const bool two = j + 1 < N;
        float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        const ll o = (ll)i * N + j;
        if (raw) {
          if (two && pairs) {
            *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
          } else {
            out[o] = v0;
            if (two) out[o + 1] = v1;
          }
          continue;
        }
        v0 = epilogue(v0, i, j, N, bias, pm, relu, true);
        if (two) v1 = epilogue(v1, i, j + 1, N, bias, pm, relu, true);
        const int bit = ((mi * 2 + h) * TC_NI + ni) * 2;
        ties |= (unsigned long long)(exact && near_tie(v0)) << bit;
        if (two) ties |= (unsigned long long)(exact && near_tie(v1)) << (bit + 1);
        if (c_bf16) {
          if (two && pairs) {
            *reinterpret_cast<__nv_bfloat162*>(out16 + o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            out16[o] = __float2bfloat16_rn(v0);
            if (two) out16[o + 1] = __float2bfloat16_rn(v1);
          }
        } else if (two && pairs) {
          *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
        } else {
          out[o] = v0;
          if (two) out[o + 1] = v1;
        }
        if (C2) {
          bf16* o2 = C2 + (ll)i * ldc2 + j;
          if (two && pairs2) {
            *reinterpret_cast<__nv_bfloat162*>(o2) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            o2[0] = __float2bfloat16_rn(v0);
            if (two) o2[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  if (!exact) return;
  // the outputs near a tie again, as the ordered chain: the CTA lists them
  // (in thread order), stages their A rows and B columns in the freed
  // stages, and each of the first threads walks one in k order
  __shared__ int fix_i[FIX_E], fix_j[FIX_E], warp_n[TC_NT / 32];
  bf16* fa = smem;                // [FIX_E][FIX_P]
  bf16* fb = smem + FIX_E * FIX_P;
  for (;;) {
    __syncthreads();  // the stages, and the last round's lists, are free
    const int n = __popcll(ties);
    int incl = n;     // inclusive scan of n over the warp
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_n[warp] = incl;
    __syncthreads();
    int slot = incl - n, total = 0;
#pragma unroll
    for (int w = 0; w < TC_NT / 32; ++w) {
      if (w < warp) slot += warp_n[w];
      total += warp_n[w];
    }
    if (total == 0) break;
    for (; ties && slot < FIX_E; ++slot) {  // the rest wait a round
      const int bit = __ffsll((long long)ties) - 1;
      ties &= ties - 1;
      const int c = bit % 2, ni = bit / 2 % TC_NI, h = bit / (2 * TC_NI) % 2;
      const int mi = bit / (4 * TC_NI);
      fix_i[slot] = m0 + wm0 + mi * 16 + g + 8 * h;
      fix_j[slot] = n0 + wn0 + ni * 8 + 2 * t4 + c;
    }
    const int m = min(total, FIX_E);
    __syncthreads();
    float s = 0.f;
    for (int k0 = 0; k0 < K; k0 += FIX_K) {
      const int kn = min(FIX_K, K - k0);
      for (int l = tid; l < m * kn; l += TC_NT) {
        const int e = l / kn, k = l % kn;
        const ll ka = k0 + k, i = fix_i[e], j = fix_j[e];
        fa[e * FIX_P + k] = A_MC ? A[ka * lda + i] : A[i * lda + ka];
        fb[e * FIX_P + k] = B_NC ? B[ka * ldb + j] : B[j * ldb + ka];
      }
      __syncthreads();
      if (tid < m) {
        const bf16* x = fa + tid * FIX_P;
        const bf16* y = fb + tid * FIX_P;
#pragma unroll 8
        for (int k = 0; k < kn; ++k)
          s = fmaf(__bfloat162float(x[k]), __bfloat162float(y[k]), s);
      }
      __syncthreads();
    }
    if (tid < m) {
      const int i = fix_i[tid], j = fix_j[tid];
      const float v = epilogue(s, i, j, N, bias, pm, relu, true);
      const ll o = (ll)i * N + j;
      if (c_bf16)
        out16[o] = __float2bfloat16_rn(v);
      else
        out[o] = v;
      if (C2) C2[(ll)i * ldc2 + j] = __float2bfloat16_rn(v);
    }
  }
}

// Elements a copy for a bfloat16 operand at p with pitch ld (see tc_load).
inline int tc_vec(const void* p, ll ld) {
  const size_t a = (size_t)p;
  if (a % 16 == 0 && ld % 8 == 0) return 8;
  if (a % 8 == 0 && ld % 4 == 0) return 4;
  return 1;
}

// gemm on the tensor cores for bfloat16 A and B (A(i, k) = A[i*sa0 +
// k*sa1], B(k, j) = B[k*sb0 + j*sb1], one stride of each 1), float32 sums:
// C [M, N] float32, or bfloat16 with c_bf16; C2, if set, a bfloat16 copy
// of C at pitch ldc2; pos_mask [M, N] bfloat16. Splits of K and ``part`` as
// gemm's; a split product takes no bfloat16 output, copy or mask. Returns
// the first CUDA error, 0 if none.
template <int = 0>
int gemm_bf16(const bf16* A, ll sa0, ll sa1, const bf16* B, ll sb0, ll sb1,
              void* C, bool c_bf16, bf16* C2, ll ldc2, int M, int N, int K,
              int splits, float* part, const float* bias,
              const bf16* pos_mask, int relu, bool exact, cudaStream_t st) {
  const bool a_mc = sa1 != 1, b_nc = sb0 != 1;
  if ((a_mc && sa0 != 1) || (b_nc && sb1 != 1))
    return (int)cudaErrorInvalidValue;
  const ll lda = a_mc ? sa1 : sa0, ldb = b_nc ? sb0 : sb1;
  const int k_chunk = ((K + splits - 1) / splits + TC_BK - 1) / TC_BK * TC_BK;
  splits = (K + k_chunk - 1) / k_chunk;
  const bool split = splits > 1;
  if (split && (c_bf16 || C2 || pos_mask)) return (int)cudaErrorInvalidValue;
  dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, splits);
  auto k = a_mc ? (b_nc ? gemm_bf16_kernel<true, true>
                        : gemm_bf16_kernel<true, false>)
                : (b_nc ? gemm_bf16_kernel<false, true>
                        : gemm_bf16_kernel<false, false>);
  k<<<grid, TC_NT, 0, st>>>(A, lda, B, ldb, split ? part : C, c_bf16, C2,
                            ldc2, M, N, K, split ? k_chunk : K,
                            tc_vec(A, lda), tc_vec(B, ldb),
                            split ? nullptr : bias, pos_mask,
                            split ? 0 : relu, exact && !split);
  const int err = (int)cudaGetLastError();
  if (err || !split) return err;
  return sum_partials(part, splits, (ll)M * N, N, static_cast<float*>(C),
                      bias, nullptr, relu, st);
}

// Y[i*t0 + j*t1] = X[i*s0 + j*s1] for i < R, j < C, converted from TI to
// TO (float to bfloat16 rounded to nearest, or bfloat16 to float);
// consecutive threads along j.
template <typename TI, typename TO>
__global__ void convert_kernel(const TI* __restrict__ X, ll s0, ll s1, int R,
                               int C, TO* __restrict__ Y, ll t0, ll t1) {
  const ll n = (ll)R * C;
  for (ll idx = blockIdx.x * (ll)blockDim.x + threadIdx.x; idx < n;
       idx += (ll)gridDim.x * blockDim.x) {
    const ll i = idx / C, j = idx % C;
    const TI v = X[i * s0 + j * s1];
    if constexpr (std::is_same<TO, bf16>::value)
      Y[i * t0 + j * t1] = __float2bfloat16_rn(v);
    else
      Y[i * t0 + j * t1] = __bfloat162float(v);
  }
}

// The same for rows contiguous in both (s1 = t1 = 1) whose width and
// pitches are multiples of 4: four elements a thread, 16-byte float and
// 8-byte bfloat16 accesses (each element converted as above).
template <typename TI, typename TO>
__global__ void convert4_kernel(const TI* __restrict__ X, ll s0, int R, int C,
                                TO* __restrict__ Y, ll t0) {
  const ll C4 = C / 4, n = (ll)R * C4;
  for (ll idx = blockIdx.x * (ll)blockDim.x + threadIdx.x; idx < n;
       idx += (ll)gridDim.x * blockDim.x) {
    const ll i = idx / C4, j = idx % C4 * 4;
    if constexpr (std::is_same<TO, bf16>::value) {
      const float4 v = *reinterpret_cast<const float4*>(X + i * s0 + j);
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 o;
      o.x = *reinterpret_cast<unsigned*>(&lo);
      o.y = *reinterpret_cast<unsigned*>(&hi);
      *reinterpret_cast<uint2*>(Y + i * t0 + j) = o;
    } else {
      uint2 u = *reinterpret_cast<const uint2*>(X + i * s0 + j);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
      *reinterpret_cast<float4*>(Y + i * t0 + j) = make_float4(lo.x, lo.y, hi.x,
                                                               hi.y);
    }
  }
}

template <typename TI, typename TO>
int convert(const TI* X, ll s0, ll s1, int R, int C, TO* Y, ll t0, ll t1,
            cudaStream_t st) {
  const bool rows4 = s1 == 1 && t1 == 1 && C % 4 == 0 && s0 % 4 == 0 &&
                     t0 % 4 == 0 && (size_t)X % (4 * sizeof(TI)) == 0 &&
                     (size_t)Y % (4 * sizeof(TO)) == 0;
  if (rows4) {
    convert4_kernel<TI, TO><<<NUM_SMS * 4, 256, 0, st>>>(X, s0, R, C, Y, t0);
  } else if (s0 == 1 && s1 != 1) {  // walk X's contiguous dimension
    convert_kernel<TI, TO><<<NUM_SMS * 4, 256, 0, st>>>(X, s1, s0, C, R, Y,
                                                        t1, t0);
  } else {
    convert_kernel<TI, TO><<<NUM_SMS * 4, 256, 0, st>>>(X, s0, s1, R, C, Y,
                                                        t0, t1);
  }
  return (int)cudaGetLastError();
}

ll pad8(ll n) { return (n + 7) / 8 * 8; }

// A weight [R, C] (strides s0, s1) rounded to bfloat16 into Wr, contiguous
// along the same dimension as W with a pitch of pad8 elements; *t0, *t1
// receive Wr's strides. K1's and K4's bfloat16 routes round their weights
// so, once a call, before the products read them.
int round_weight(const float* W, ll s0, ll s1, int R, int C, bf16* Wr,
                 ll* t0, ll* t1, cudaStream_t st) {
  const bool col = s0 == 1 && s1 != 1;
  *t0 = col ? 1 : pad8(C);
  *t1 = col ? pad8(R) : 1;
  return convert(W, s0, s1, R, C, Wr, *t0, *t1, st);
}

}  // namespace
