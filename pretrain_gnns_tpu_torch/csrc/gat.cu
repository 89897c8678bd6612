// GAT attention for Hopper (sm_90a), forward and backward: the whole-layer
// fused GAT conv (K4) and the blocked GAT attention (K5) from one source.
//
// Replaces two Pallas TPU kernels:
//   K4  pretrain_gnns_tpu/ops/pallas_gat_conv.py (_fwd_kernel via _call_fwd,
//       _bwd_kernel via _call_bwd, wrapped by the custom_vjp fused_gat_conv)
//   K5  pretrain_gnns_tpu/ops/pallas_attention.py (_fwd_kernel via
//       blocked_gat_forward, _bwd_kernel via blocked_gat_backward)
//
// Both compute, per head h on the block-diagonal batch (s = snd_e, r = rcv_e):
//
//   raw_e  = x[r]·a_i + (x[s] + e_e)·a_j        logit_e = LeakyReLU(raw_e)
//   sraw_n = x[n]·a_i + (x[n] + e_self)·a_j     sl_n    = LeakyReLU(sraw_n)
//   m_n    = max(max_{e -> n} logit_e, sl_n)
//   p_e    = exp(logit_e - m_r) * w_e           p_self_n = exp(sl_n - m_n)
//   den_n  = sum_{e -> n} p_e + p_self_n
//   out_n  = sum_{e -> n} alpha_e (x[s] + e_e) + aself_n (x[n] + e_self)
//            alpha_e = p_e / den_r, aself_n = p_self_n / den_n
//
// K5 takes x [N, H, D] and e [E, H, D] ready-made and returns out [N, H, D].
// K4 forms x = h @ Wl + bl itself (saved for the backward) and never forms
// e: e_e = ein_e @ We (K <= 16 terms) is recomputed wherever it is needed,
// and e_e·a_j = ein_e · (We a_j). It returns mean_h out + bias, [N, D].
//
// Backward (g the cotangent of a head's out; K4: g / H for every head):
//   dalpha_e = g[r]·(x[s] + e_e)     daself_n = g[n]·(x[n] + e_self)
//   c_n   = sum_{e -> n} alpha_e dalpha_e + aself_n daself_n
//   dz_e  = alpha_e (dalpha_e - c_r) LeakyReLU'(raw_e)
//   dzs_n = aself_n (daself_n - c_n) LeakyReLU'(sraw_n)
//   u_n = sum_{e -> n} dz_e + dzs_n  (on a_i)   v_n = sum_{s_e = n} dz_e + dzs_n
//   dx_n  = sum_{s_e = n} alpha_e g[r] + aself_n g[n] + u_n a_i + v_n a_j
//   de_e  = alpha_e g[r] + dz_e a_j               (K5; K4: dWe = ein^T de)
//   de_self = sum_n aself_n g[n] + (sum_n dzs_n) a_j
//   da_i = sum_n u_n x[n]
//   da_j = sum_n v_n x[n] + (sum_n dzs_n) e_self + sum_e dz_e e_e
//   K4 only: dbias = sum_n g_n (all rows, before the 1/H), dWl = h^T dx,
//   dbl = sum_n dx_n, dh = dx Wl^T.
// LeakyReLU' is 1 where raw >= 0, else the slope (as the TPU kernels).
//
// What bounds it on the card: at the GAT paths' shapes (chem N = 8,192 rows,
// 24,576 edge slots, about 14 k valid; bio N = 20,480, 61,440 slots; H = 2,
// D = 300, float32) K4 is bound by operations, the [N, 300] x [300, 600]
// projection and its two backward products on the CUDA cores (67 TFLOP/s,
// gemm.cuh); its attention, and all of K5, by bytes: x (and g) read, out
// (dx, de) written once, 10-60 MB at 3.35 TB/s, 0.01-0.04 ms. What keeps a
// simple kernel far from that is latency (chains of dependent loads, too
// few warps in flight when registers run short) and repeated work, not
// arithmetic. Tensor cores do not apply: the attention is float32, sparse
// and bound by bytes and latency, and TF32 in K4's products would break the
// float32 parity the port is held to (they stay on gemm.cuh).
//
// Design (the attention of K4 and K5, forward and backward):
// - Row ownership, row by row. One CTA per (node block, group of RPC rows,
//   feature chunk of CH = 320 features); each warp owns RPW consecutive rows
//   and is their only writer. The CTA stages the block's slots in shared
//   memory (local sender, local receiver, weight; -1 for a padded slot, a
//   slot with w <= 0 or with an endpoint outside the block), and each warp
//   lists, by ballot, the slots of each of its rows in slot order: every
//   sum below is taken in a fixed order, with no atomics, so every output is
//   the same bits on every run. A lane holds NV = 10 features of a row in
//   registers, two adjacent ones (float2) where D is even, the row fits one
//   chunk and the rows are 8-byte aligned. Staging loops issue all their
//   loads before the first store (copy_batched, stage).
// - Forward, one kernel: for each row and head the warp forms x_r·a_i and
//   the self logit, then walks the row's slots B at a time (the x[s] rows of
//   a batch, and K5's e rows, loaded before any is used), takes the sender
//   term of each logit by a warp sum and runs an online softmax: a running
//   max and denominator, the accumulated message rescaled when the max
//   grows. The self loop starts it (max = its logit, denominator 1,
//   accumulator x_r + e_self). So the softmax needs no scan of the block,
//   and K5 reads e once. alpha is written after the walk from the logits
//   kept in shared memory. K4 reassociates its edge term: the logit's is
//   ein_e · (We_h a_j) (We_h a_j formed once a call, gat_edge_vec_kernel),
//   and the message's A_r = sum p_e ein_e is summed with one add a slot
//   (lanes k < K) and multiplied by We_h once a row: out_r = acc / den +
//   (A_r / den) @ We_h.
// - Backward, two walks. By receiver: dalpha_e = g_r·(x[s] + e_e) (K4:
//   g_r·x[s] + ein_e · q_r, with q_r = We_h g_r formed once a row and head
//   from We_h's chunk in shared memory and a reduce-scatter over the warp),
//   c_r and K4's A_r = sum alpha_e ein_e in the same pass; then dz, dzs, u
//   lane-parallel over the row's slots; K5 writes de and takes da_j's e
//   term re-reading the row's e rows, which the first pass has just brought
//   to L1; K4 writes A_r and S_r = sum dz_e ein_e. By sender: v_n and dx_n
//   = sum alpha_e g_r + aself g_n + u a_i + v a_j. e is read from device
//   memory once in each direction. K4's dWe = sum_r A_r^T g_r + S a_j^T and
//   da_j's e term S @ We_h come from A and S (gat_dwe_kernel), never from a
//   per-slot ein_e @ We.
// - Parameter gradients: each walk CTA (and each dWe CTA) writes its partial
//   sums of de_self, da_i, da_j (and dWe), its warps' shares added in warp
//   order; gat_finish_kernel sums them in CTA order.
// - Rows wider than a chunk (D > 320) take one CTA per chunk and one
//   feature a lane (no path has them: they are kept correct, not fast);
//   the full-row dot products are then summed chunk by chunk in the same
//   order in every CTA, so all chunks see the same logits.
// - Padded slots and slots with an endpoint outside their block get alpha
//   = 0 and dlr = 0, and K5 writes their de rows as exact zeros. Padded
//   node rows and all-padding blocks are computed like any other: their
//   only logit is the self loop, so aself = 1 and out = x + e_self.
// - K4's three products and its two column sums go through gemm.cuh
//   (shared with gin_conv.cu). edge_aggr.cuh's walk does not fit here:
//   the softmax needs each row's slots together, and a GAT slot counts only
//   with w > 0 (the header's with w != 0).

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "gemm.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = 2;                   // rows a warp owns
constexpr int RPC = WARPS * RPW;         // rows a CTA owns
constexpr int NV = 10;                   // features a lane holds
constexpr int CH = 32 * NV;              // features a chunk
constexpr int MAX_K = 16;                // edge input width (K4)
static_assert(MAX_K == 16, "q_r's reduce-scatter halves 16 values");
// partial rows a walk CTA: de_self, da_i, da_j by receiver, da_j by sender
constexpr int NPART = 4;
// walk CTAs an SM: at most 128 registers a thread
constexpr int WALK_MIN_CTAS = 2;
constexpr int DWE_ROWS = 64;             // rows a dWe partial sums
constexpr int DWE_THREADS = 128;         // columns of a dWe CTA
constexpr int MAX_SMEM = 232448;         // 227 KB: a block's most on the H100
constexpr int DEFAULT_SMEM = 48 * 1024;  // above this only after opting in
constexpr unsigned FULL = 0xffffffffu;

// Ar and Sr hold K values a row and head padded to KP, a multiple of 4, so
// that gat_dwe_kernel reads them as float4.
__host__ __device__ int padded_k(int K) { return (K + 3) / 4 * 4; }

// What every kernel reads. x is [N, H*D]; e is [E, H*D] (K5) or null; ein
// [E, K] and We [K, H*D] (K4) or null; es, ai, aj are [H*D].
struct Graph {
  const float* x;
  const float* e;
  const float* ein;
  const float* We;
  const float* es;
  const float* ai;
  const float* aj;
  const int* snd;
  const int* rcv;
  const float* w;
  int N, E, H, D, K, bn, be;
  float slope;
};

// The cotangent of a head's out: g[n * rs + h * hs + f] * scale.
struct Cot {
  const float* g;
  ll rs, hs;
  float scale;
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;  // the same bits in every lane
}

// NV features of one row, a lane's share of a chunk: with VEC = 2 the
// pairs (c0 + 2 (lane + 32 j), + 1), else c0 + lane + 32 j.
struct Chunk {
  float v[NV];
};

template <int VEC>
__device__ __forceinline__ int feat(int c0, int lane, int i) {
  return c0 + (lane + 32 * (i / VEC)) * VEC + i % VEC;
}

// p is the row's first feature; zeros past D (VEC = 2 needs D even).
template <int VEC>
__device__ __forceinline__ Chunk ld(const float* p, int c0, int D, int lane,
                                    float scale = 1.f) {
  Chunk c;
#pragma unroll
  for (int j = 0; j < NV / VEC; ++j) {
    const int f = c0 + (lane + 32 * j) * VEC;
    if constexpr (VEC == 2) {
      const float2 t = f < D ? *reinterpret_cast<const float2*>(p + f)
                             : make_float2(0.f, 0.f);
      c.v[2 * j] = t.x * scale;
      c.v[2 * j + 1] = t.y * scale;
    } else {
      c.v[j] = f < D ? p[f] * scale : 0.f;
    }
  }
  return c;
}

template <int VEC>
__device__ __forceinline__ void st(float* p, const Chunk& c, int c0, int D,
                                   int lane) {
#pragma unroll
  for (int j = 0; j < NV / VEC; ++j) {
    const int f = c0 + (lane + 32 * j) * VEC;
    if (f >= D) continue;
    if constexpr (VEC == 2)
      *reinterpret_cast<float2*>(p + f) = make_float2(c.v[2 * j], c.v[2 * j + 1]);
    else
      p[f] = c.v[j];
  }
}

__device__ __forceinline__ Chunk zero() {
  Chunk c;
#pragma unroll
  for (int i = 0; i < NV; ++i) c.v[i] = 0.f;
  return c;
}

__device__ __forceinline__ Chunk add(const Chunk& a, const Chunk& b) {
  Chunk c;
#pragma unroll
  for (int i = 0; i < NV; ++i) c.v[i] = a.v[i] + b.v[i];
  return c;
}

__device__ __forceinline__ float dot(const Chunk& a, const Chunk& b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) s = fmaf(a.v[i], b.v[i], s);
  return s;
}

// c = c * s + p * m, elementwise
__device__ __forceinline__ void rescale_add(Chunk& c, float s, float p,
                                            const Chunk& m) {
#pragma unroll
  for (int i = 0; i < NV; ++i) c.v[i] = fmaf(p, m.v[i], c.v[i] * s);
}

__device__ __forceinline__ void axpy(Chunk& c, float p, const Chunk& m) {
#pragma unroll
  for (int i = 0; i < NV; ++i) c.v[i] = fmaf(p, m.v[i], c.v[i]);
}

// A lane's part of a whole-row dot product: ``cur`` is its part on this
// CTA's chunk c0, ``part(cc)`` forms it on chunk cc from device memory the
// same way. WIDE (D > CH): summed chunk by chunk in order, so that every
// chunk's CTA gets the same bits.
template <bool WIDE, typename Part>
__device__ __forceinline__ float row_dot(int c0, int D, float cur, Part part) {
  if constexpr (!WIDE) {
    return cur;
  } else {
    float s = 0.f;
    for (int cc = 0; cc < D; cc += CH) s += cc == c0 ? cur : part(cc);
    return s;
  }
}

// Shared memory of a walk CTA: the staged slots, each warp's per-row slot
// lists, its per-slot scalars (one or, backward, two a slot) and,
// backward, its share of the CTA's partial sums and a head's We chunk.
struct Walk {
  float* w;              // [be]
  float* buf;            // [WARPS][be] (backward: [WARPS][2 be])
  float* part;           // backward: [WARPS][2][NV][32]
  float* We;             // backward: [MAX_K][NV][32]
  int* ls;               // [be] local sender, -1: skipped
  int* lr;               // [be] local receiver, -1: skipped
  unsigned short* list;  // [WARPS][RPW][be]
};

__host__ __device__ int walk_floats(int be, bool backward) {
  return be + WARPS * (backward ? 2 * be + 2 * CH : be) +
         (backward ? MAX_K * CH : 0);
}

int walk_smem(int be, bool backward) {
  return walk_floats(be, backward) * 4 + 2 * be * 4 + WARPS * RPW * be * 2;
}

__device__ __forceinline__ Walk carve(float* smem, int be, bool backward) {
  Walk s;
  s.w = smem;
  s.buf = smem + be;
  s.part = s.buf + WARPS * 2 * be;  // backward only
  s.We = s.part + WARPS * 2 * CH;   // backward only
  s.ls = (int*)(smem + walk_floats(be, backward));
  s.lr = s.ls + be;
  s.list = (unsigned short*)(s.lr + be);
  return s;
}

// Copies n values, load(i) to store(i, v) for i = t, t + stride, ...: U
// loads in flight a thread before the first store, so that a staging loop
// costs one trip to device memory, not one an iteration.
template <int U, typename Load, typename Store>
__device__ __forceinline__ void copy_batched(int n, int t, int stride,
                                             Load load, Store store) {
  for (int i0 = t; i0 < n; i0 += U * stride) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * stride;
      v[u] = i < n ? load(i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * stride;
      if (i < n) store(i, v[u]);
    }
  }
}

// Stage block b's slots, STAGE_U a thread with every load issued before the
// first store; returns after the CTA's barrier.
constexpr int STAGE_U = 4;

__device__ __forceinline__ void stage(const Walk& s, const Graph& a, ll e0,
                                      ll base) {
  for (int q0 = threadIdx.x; q0 < a.be; q0 += STAGE_U * THREADS) {
    float we[STAGE_U];
    int sg[STAGE_U], rg[STAGE_U];
#pragma unroll
    for (int u = 0; u < STAGE_U; ++u) {
      const int q = q0 + u * THREADS;
      if (q >= a.be) break;
      we[u] = a.w[e0 + q];
      sg[u] = a.snd[e0 + q];
      rg[u] = a.rcv[e0 + q];
    }
#pragma unroll
    for (int u = 0; u < STAGE_U; ++u) {
      const int q = q0 + u * THREADS;
      if (q >= a.be) break;
      const ll ls = sg[u] - base, lr = rg[u] - base;
      const bool ok = we[u] > 0.f && ls >= 0 && ls < a.bn && lr >= 0 &&
                      lr < a.bn;
      s.ls[q] = ok ? (int)ls : -1;
      s.lr[q] = ok ? (int)lr : -1;
      s.w[q] = we[u];
    }
  }
  __syncthreads();
}

// The slots of each of the warp's rows r0 .. r0 + RPW - 1, by receiver or
// (BY_SENDER) by sender, in slot order, into the warp's lists; cnt[j] gets
// row r0 + j's count.
template <bool BY_SENDER>
__device__ __forceinline__ void list_rows(const Walk& s, int be, int r0,
                                          int lane, int warp, int* cnt) {
  unsigned short* list = s.list + warp * RPW * be;
#pragma unroll
  for (int j = 0; j < RPW; ++j) cnt[j] = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int c = 0; c < be; c += 32) {
    const int q = c + lane;
    const int key = q < be ? (BY_SENDER ? s.ls[q] : s.lr[q]) - r0 : -1;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const unsigned m = __ballot_sync(FULL, key == j);
      if (key == j) list[j * be + cnt[j] + __popc(m & below)] = (unsigned short)q;
      cnt[j] += __popc(m);
    }
  }
  __syncwarp();
}

// One step of a reduce-scatter over the warp: lanes with bit O set keep
// values M .. 2M - 1 of v, the others 0 .. M - 1, each added to its
// partner's (lane ^ O) copy; the kept values move to 0 .. M - 1.
template <int O, int M>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float send = up ? v[i] : v[i + M];
    v[i] = (up ? v[i + M] : v[i]) + __shfl_xor_sync(FULL, send, O);
  }
}

// This warp's share of partial row ``which`` (0 or 1): part += v.
__device__ __forceinline__ void add_part(float* mine, int which,
                                         const Chunk& v, int lane) {
#pragma unroll
  for (int i = 0; i < NV; ++i) mine[(which * NV + i) * 32 + lane] += v.v[i];
}

// The CTA's partial rows j0 and j1 of head h: the warps' shares summed in
// warp order into part[cta][j][h*D + f]; then each warp zeroes its own
// share (the entries its lanes add to) for the next head.
template <int VEC>
__device__ __forceinline__ void write_partials(float* shares, int j0, int j1,
                                               float* __restrict__ part,
                                               ll HD, int h, int D, int c0) {
  __syncthreads();
  const ll cta = (ll)blockIdx.x * gridDim.y + blockIdx.y;
  for (int t = threadIdx.x; t < 2 * CH; t += THREADS) {
    const int which = t / CH, i = (t % CH) / 32, l = t % 32;
    const int f = feat<VEC>(c0, l, i);
    if (f >= D) continue;
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v += shares[w * 2 * CH + t];
    part[(cta * NPART + (which ? j1 : j0)) * HD + (ll)h * D + f] = v;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int t = lane; t < 2 * CH; t += 32) shares[warp * 2 * CH + t] = 0.f;
}

// va [H, K] = We_h a_j: the edge logit's ein_e · va_h (K4). One warp an
// entry.
__global__ void __launch_bounds__(THREADS)
gat_edge_vec_kernel(const Graph a, float* __restrict__ va) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * WARPS + threadIdx.x / 32;
  if (i >= a.H * a.K) return;  // the whole warp leaves together
  const int h = i / a.K, k = i % a.K;
  const ll HD = (ll)a.H * a.D;
  const float* W = a.We + k * HD + (ll)h * a.D;
  const float* aj = a.aj + (ll)h * a.D;
  float s = 0.f;
  for (int f = lane; f < a.D; f += 32) s = fmaf(W[f], aj[f], s);
  s = warp_sum(s);
  if (lane == 0) va[i] = s;
}

// Forward: out (K5 [N, H*D]; K4 [N, D] = mean_h + bias), and, from the
// first chunk's CTAs, alpha, dlr [E, H] and aself, dls [N, H].
template <bool FUSED, int VEC, bool WIDE>
__global__ void __launch_bounds__(THREADS, WALK_MIN_CTAS)
gat_fwd_kernel(const Graph a, const float* __restrict__ va,
               const float* __restrict__ bias, float* __restrict__ out,
               float* __restrict__ alpha, float* __restrict__ aself,
               float* __restrict__ dlr, float* __restrict__ dls) {
  // slots in flight a warp: K5 loads an e row beside each x row
  constexpr int B = FUSED ? 4 : 2;
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, D = a.D, K = a.K, be = a.be;
  const Walk s = carve(smem, be, false);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.z * CH;
  const bool first = blockIdx.z == 0;  // writes the softmax scalars
  const ll base = (ll)blockIdx.x * a.bn, e0 = (ll)blockIdx.x * be;
  const ll HD = (ll)H * D;
  stage(s, a, e0, base);
  if (first && blockIdx.y == 0)  // skipped slots: alpha = dlr = 0
    for (int i = threadIdx.x; i < be * H; i += THREADS)
      if (s.ls[i / H] < 0) {
        alpha[e0 * H + i] = 0.f;
        dlr[e0 * H + i] = 0.f;
      }
  const int r0 = blockIdx.y * RPC + warp * RPW;
  int cnt[RPW];
  list_rows<false>(s, be, r0, lane, warp, cnt);
  float* lg = s.buf + warp * be;  // the row's logits, in list order

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = r0 + j;
    if (r >= a.bn) break;  // warp-uniform
    const ll n = base + r;
    const unsigned short* L = s.list + (warp * RPW + j) * be;
    const int nq = cnt[j];
    Chunk o = zero();  // K4: the heads' sum
    for (int h = 0; h < H; ++h) {
      const ll hD = (ll)h * D;
      const float* xr_p = a.x + n * HD + hD;
      const float* es_p = a.es + hD;
      const float* ai_p = a.ai + hD;
      const float* aj_p = a.aj + hD;
      const Chunk xr = ld<VEC>(xr_p, c0, D, lane);
      const Chunk aj = ld<VEC>(aj_p, c0, D, lane);
      const Chunk xe = add(xr, ld<VEC>(es_p, c0, D, lane));
      const float ps = warp_sum(row_dot<WIDE>(
          c0, D, dot(xr, ld<VEC>(ai_p, c0, D, lane)), [&](int cc) {
            return dot(ld<VEC>(xr_p, cc, D, lane), ld<VEC>(ai_p, cc, D, lane));
          }));
      const float pself = warp_sum(row_dot<WIDE>(c0, D, dot(xe, aj), [&](int cc) {
        return dot(add(ld<VEC>(xr_p, cc, D, lane), ld<VEC>(es_p, cc, D, lane)),
                   ld<VEC>(aj_p, cc, D, lane));
      }));
      const float sraw = ps + pself;
      const float ds = sraw >= 0.f ? 1.f : a.slope;
      const float sl = sraw * ds;
      // online softmax, started by the self loop
      float m = sl, den = 1.f;
      Chunk acc = xe;
      float A = 0.f;  // K4, lane k < K: sum of p * ein[k]
      const float vak = FUSED && lane < K ? va[h * K + lane] : 0.f;
      for (int i0 = 0; i0 < nq; i0 += B) {
        Chunk msg[B];
        float ek[B];
#pragma unroll
        for (int u = 0; u < B; ++u) {
          if (i0 + u >= nq) break;
          const int q = L[i0 + u];
          const float* xs = a.x + (base + s.ls[q]) * HD + hD;
          msg[u] = ld<VEC>(xs, c0, D, lane);
          if (FUSED)
            ek[u] = lane < K ? a.ein[(e0 + q) * K + lane] : 0.f;
          else
            msg[u] = add(msg[u], ld<VEC>(a.e + (e0 + q) * HD + hD, c0, D, lane));
        }
#pragma unroll
        for (int u = 0; u < B; ++u) {
          if (i0 + u >= nq) break;
          const int q = L[i0 + u];
          const float* xs = a.x + (base + s.ls[q]) * HD + hD;
          const float* es = FUSED ? nullptr : a.e + (e0 + q) * HD + hD;
          float part = row_dot<WIDE>(c0, D, dot(msg[u], aj), [&](int cc) {
            Chunk t = ld<VEC>(xs, cc, D, lane);
            if (!FUSED) t = add(t, ld<VEC>(es, cc, D, lane));
            return dot(t, ld<VEC>(aj_p, cc, D, lane));
          });
          if (FUSED) part = fmaf(ek[u], vak, part);
          const float raw = ps + warp_sum(part);
          const float d = raw >= 0.f ? 1.f : a.slope;
          const float l = raw * d;
          const float wq = s.w[q];
          float p, sc = 1.f;
          if (l > m) {  // warp-uniform
            sc = expf(m - l);
            m = l;
            p = wq;
          } else {
            p = expf(l - m) * wq;
          }
          den = fmaf(den, sc, p);
          rescale_add(acc, sc, p, msg[u]);
          if (FUSED) A = fmaf(p, ek[u], A * sc);
          if (lane == 0) lg[i0 + u] = l;
          if (first && lane == 0) dlr[(e0 + q) * H + h] = d;
        }
      }
      __syncwarp();
      const float inv = 1.f / fmaxf(den, 1e-30f);
      if (first) {
        for (int i = lane; i < nq; i += 32) {
          const int q = L[i];
          alpha[(e0 + q) * H + h] = expf(lg[i] - m) * s.w[q] * inv;
        }
        if (lane == 0) {
          aself[n * H + h] = expf(sl - m) * inv;
          dls[n * H + h] = ds;
        }
      }
      __syncwarp();  // lg is rewritten by the next head
#pragma unroll
      for (int i = 0; i < NV; ++i) acc.v[i] *= inv;
      if (FUSED) {
        // the edge term: (A_r / den) @ We_h on this lane's features
#pragma unroll
        for (int k = 0; k < MAX_K; ++k)
          if (k < K)
            axpy(acc, __shfl_sync(FULL, A, k) * inv,
                 ld<VEC>(a.We + k * HD + hD, c0, D, lane));
        o = add(o, acc);
      } else {
        st<VEC>(out + n * HD + hD, acc, c0, D, lane);
      }
    }
    if (FUSED) {
      const Chunk bs = ld<VEC>(bias, c0, D, lane);
#pragma unroll
      for (int i = 0; i < NV; ++i) o.v[i] = o.v[i] / (float)H + bs.v[i];
      st<VEC>(out + n * D, o, c0, D, lane);
    }
  }
}

struct BwdOut {
  float* dz;    // [E, H]
  float* dzs;   // [N, H]
  float* u;     // [N, H]
  float* Ar;    // [N, H, K] (K4) sum_{e -> n} alpha_e ein_e
  float* Sr;    // [N, H, K] (K4) sum_{e -> n} dz_e ein_e
  float* part;  // [CTAs][NPART][H*D]
};

// Backward walk by receiver: dalpha, c, dz [E, H], dzs, u [N, H]; K5 de
// [E, H*D]; K4 Ar, Sr; partial rows 0 (de_self) and 2 (da_j: dzs e_self
// and, K5, dz e).
template <bool FUSED, int VEC, bool WIDE>
__global__ void __launch_bounds__(THREADS, WALK_MIN_CTAS)
gat_bwd_rcv_kernel(const Graph a, const Cot c, const float* __restrict__ alpha,
                   const float* __restrict__ aself,
                   const float* __restrict__ dlr,
                   const float* __restrict__ dls, float* __restrict__ de,
                   const BwdOut o) {
  // slots in flight a warp: K5 loads an e row beside each x row
  constexpr int B = FUSED ? 4 : 2;
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, D = a.D, K = a.K, be = a.be;
  const Walk s = carve(smem, be, true);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.z * CH;
  const bool first = blockIdx.z == 0;
  const ll base = (ll)blockIdx.x * a.bn, e0 = (ll)blockIdx.x * be;
  const ll HD = (ll)H * D;
  for (int t = threadIdx.x; t < WARPS * 2 * CH; t += THREADS) s.part[t] = 0.f;
  stage(s, a, e0, base);
  // K5: skipped slots' de rows are exact zeros, shared out over the CTAs
  if (!FUSED) {
    for (int cq = (blockIdx.y * WARPS + warp) * 32; cq < be;
         cq += gridDim.y * WARPS * 32) {
      const int q = cq + lane;
      unsigned m = __ballot_sync(FULL, q < be && s.ls[q] < 0);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        for (int h = 0; h < H; ++h)
          st<VEC>(de + (e0 + cq + src) * HD + (ll)h * D, zero(), c0, D, lane);
      }
    }
  }
  const int r0 = blockIdx.y * RPC + warp * RPW;
  int cnt[RPW];
  list_rows<false>(s, be, r0, lane, warp, cnt);
  float* dal = s.buf + warp * 2 * be;  // dalpha, then dz, in list order
  float* adl = dal + be;               // alpha * LeakyReLU'(raw)
  float* mine = s.part + warp * 2 * CH;

  for (int h = 0; h < H; ++h) {
    const ll hD = (ll)h * D;
    const float* es_p = a.es + hD;
    const float* aj_p = a.aj + hD;
    if (FUSED) {  // We_h's chunk, as the lanes hold it; read after the barrier
      copy_batched<8>(
          K * CH, threadIdx.x, THREADS,
          [&](int t) {
            const int k = t / CH, f = feat<VEC>(c0, t % 32, (t % CH) / 32);
            return f < D ? a.We[k * HD + hD + f] : 0.f;
          },
          [&](int t, float v) { s.We[t] = v; });
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = r0 + j;
      if (r >= a.bn) break;  // warp-uniform
      const ll n = base + r;
      const unsigned short* L = s.list + (warp * RPW + j) * be;
      const int nq = cnt[j];
      const float* g_p = c.g + n * c.rs + h * c.hs;
      const float* xr_p = a.x + n * HD + hD;
      const Chunk g = ld<VEC>(g_p, c0, D, lane, c.scale);
      const float daself = warp_sum(row_dot<WIDE>(
          c0, D,
          dot(g, add(ld<VEC>(xr_p, c0, D, lane), ld<VEC>(es_p, c0, D, lane))),
          [&](int cc) {
            return dot(ld<VEC>(g_p, cc, D, lane, c.scale),
                       add(ld<VEC>(xr_p, cc, D, lane),
                           ld<VEC>(es_p, cc, D, lane)));
          }));
      float qk = 0.f;  // K4, lane k < K: (We_h g_r)[k]
      if (FUSED) {
        float qp[MAX_K];  // the lane's parts of the K dot products
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) {
          float t = 0.f;
          if (k < K) {
#pragma unroll
            for (int i = 0; i < NV; ++i)
              t = fmaf(g.v[i], s.We[(k * NV + i) * 32 + lane], t);
            const float* W = a.We + k * HD + hD;
            t = row_dot<WIDE>(c0, D, t, [&](int cc) {
              return dot(ld<VEC>(g_p, cc, D, lane, c.scale),
                         ld<VEC>(W, cc, D, lane));
            });
          }
          qp[k] = t;
        }
        // reduce-scatter over the warp: lane l ends with the sum of
        // qp[l >> 1]
        halve<16, 8>(qp, lane);
        halve<8, 4>(qp, lane);
        halve<4, 2>(qp, lane);
        halve<2, 1>(qp, lane);
        const float q = qp[0] + __shfl_xor_sync(FULL, qp[0], 1);
        qk = __shfl_sync(FULL, q, (2 * lane) & 31);
      }
      const float asr = aself[n * H + h], dlsr = dls[n * H + h];
      // pass 1: dalpha_e = g_r · (x[s] + e_e), c_r = sum alpha_e dalpha_e
      // (+ the self loop's), K4 A_r = sum alpha_e ein_e
      float ar = 0.f, cr = 0.f;
      for (int i0 = 0; i0 < nq; i0 += B) {
        Chunk msg[B];
        float ek[B], al[B], dl[B];
#pragma unroll
        for (int u = 0; u < B; ++u) {
          if (i0 + u >= nq) break;
          const int q = L[i0 + u];
          msg[u] = ld<VEC>(a.x + (base + s.ls[q]) * HD + hD, c0, D, lane);
          al[u] = alpha[(e0 + q) * H + h];
          dl[u] = dlr[(e0 + q) * H + h];
          if (FUSED)
            ek[u] = lane < K ? a.ein[(e0 + q) * K + lane] : 0.f;
          else
            msg[u] = add(msg[u], ld<VEC>(a.e + (e0 + q) * HD + hD, c0, D, lane));
        }
#pragma unroll
        for (int u = 0; u < B; ++u) {
          if (i0 + u >= nq) break;
          const int q = L[i0 + u];
          const float* xs = a.x + (base + s.ls[q]) * HD + hD;
          const float* ep = FUSED ? nullptr : a.e + (e0 + q) * HD + hD;
          float part = row_dot<WIDE>(c0, D, dot(g, msg[u]), [&](int cc) {
            Chunk t = ld<VEC>(xs, cc, D, lane);
            if (!FUSED) t = add(t, ld<VEC>(ep, cc, D, lane));
            return dot(ld<VEC>(g_p, cc, D, lane, c.scale), t);
          });
          if (FUSED) {
            part = fmaf(ek[u], qk, part);
            ar = fmaf(al[u], ek[u], ar);
          }
          const float d = warp_sum(part);
          cr = fmaf(al[u], d, cr);
          if (lane == 0) {
            dal[i0 + u] = d;
            adl[i0 + u] = al[u] * dl[u];
          }
        }
      }
      __syncwarp();
      // dz, dzs and u, lane-parallel over the row's slots
      cr = fmaf(asr, daself, cr);
      const float dzs = asr * (daself - cr) * dlsr;
      float up = 0.f;
      for (int i = lane; i < nq; i += 32) {
        const int q = L[i];
        const float z = adl[i] * (dal[i] - cr);
        dal[i] = z;
        up += z;
        if (first) o.dz[(e0 + q) * H + h] = z;
      }
      const float uu = warp_sum(up) + dzs;
      if (first && lane == 0) {
        o.u[n * H + h] = uu;
        o.dzs[n * H + h] = dzs;
      }
      __syncwarp();
      if (FUSED) {
        // S_r = sum dz_e ein_e, one add a slot; lanes K .. KP - 1 write 0
        if (first && lane < padded_k(K)) {
          float sr = 0.f;
          for (int i0 = 0; i0 < nq; i0 += 8) {
            float ev[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              ev[u] = i0 + u < nq && lane < K
                          ? a.ein[(e0 + L[i0 + u]) * K + lane] : 0.f;
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (i0 + u < nq) sr = fmaf(dal[i0 + u], ev[u], sr);
          }
          o.Ar[(n * H + h) * padded_k(K) + lane] = ar;
          o.Sr[(n * H + h) * padded_k(K) + lane] = sr;
        }
      } else {
        // pass 2: de_e = alpha_e g_r + dz_e a_j; da_j += dz_e e_e
        const Chunk aj = ld<VEC>(aj_p, c0, D, lane);
        for (int i0 = 0; i0 < nq; i0 += B) {
          Chunk ev[B];
          float al[B];
#pragma unroll
          for (int u = 0; u < B; ++u)
            if (i0 + u < nq) {
              const int q = L[i0 + u];
              ev[u] = ld<VEC>(a.e + (e0 + q) * HD + hD, c0, D, lane);
              al[u] = alpha[(e0 + q) * H + h];
            }
#pragma unroll
          for (int u = 0; u < B; ++u) {
            if (i0 + u >= nq) break;
            const int q = L[i0 + u];
            const float z = dal[i0 + u];
            Chunk dv;
#pragma unroll
            for (int i = 0; i < NV; ++i) {
              dv.v[i] = fmaf(al[u], g.v[i], z * aj.v[i]);
              ev[u].v[i] *= z;
            }
            st<VEC>(de + (e0 + q) * HD + hD, dv, c0, D, lane);
            add_part(mine, 1, ev[u], lane);
          }
        }
      }
      __syncwarp();  // the slot scalars are rewritten by the next row
      const Chunk aj = ld<VEC>(aj_p, c0, D, lane);
      const Chunk es = ld<VEC>(es_p, c0, D, lane);
      Chunk t0, t1;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        t0.v[i] = fmaf(asr, g.v[i], dzs * aj.v[i]);
        t1.v[i] = dzs * es.v[i];
      }
      add_part(mine, 0, t0, lane);
      add_part(mine, 1, t1, lane);
    }
    write_partials<VEC>(s.part, 0, 2, o.part, HD, h, D, c0);
  }
}

// Backward walk by sender: v_n and dx [N, H*D]; partial rows 1 (da_i) and
// 3 (da_j: v x).
template <bool FUSED, int VEC, bool WIDE>
__global__ void __launch_bounds__(THREADS, WALK_MIN_CTAS)
gat_bwd_snd_kernel(const Graph a, const Cot c, const float* __restrict__ alpha,
                   const float* __restrict__ aself,
                   const float* __restrict__ dz, const float* __restrict__ dzs,
                   const float* __restrict__ u, float* __restrict__ dx,
                   float* __restrict__ part) {
  constexpr int B = 4;
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, D = a.D, be = a.be;
  const Walk s = carve(smem, be, true);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.z * CH;
  const ll base = (ll)blockIdx.x * a.bn, e0 = (ll)blockIdx.x * be;
  const ll HD = (ll)H * D;
  for (int t = threadIdx.x; t < WARPS * 2 * CH; t += THREADS) s.part[t] = 0.f;
  stage(s, a, e0, base);
  const int r0 = blockIdx.y * RPC + warp * RPW;
  int cnt[RPW];
  list_rows<true>(s, be, r0, lane, warp, cnt);
  float* mine = s.part + warp * 2 * CH;

  for (int h = 0; h < H; ++h) {
    const ll hD = (ll)h * D;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = r0 + j;
      if (r >= a.bn) break;  // warp-uniform
      const ll n = base + r;
      const unsigned short* L = s.list + (warp * RPW + j) * be;
      const int nq = cnt[j];
      float vp = 0.f;
      for (int i = lane; i < nq; i += 32) vp += dz[(e0 + L[i]) * H + h];
      const float v = warp_sum(vp) + dzs[n * H + h];
      const float uu = u[n * H + h];
      const float asn = aself[n * H + h];
      Chunk acc = zero();
      for (int i0 = 0; i0 < nq; i0 += B) {
        Chunk gr[B];
        float al[B];
#pragma unroll
        for (int t = 0; t < B; ++t) {
          if (i0 + t >= nq) break;
          const int q = L[i0 + t];
          gr[t] = ld<VEC>(c.g + (base + s.lr[q]) * c.rs + h * c.hs, c0, D,
                          lane, c.scale);
          al[t] = alpha[(e0 + q) * H + h];
        }
#pragma unroll
        for (int t = 0; t < B; ++t)
          if (i0 + t < nq) axpy(acc, al[t], gr[t]);
      }
      const Chunk gn = ld<VEC>(c.g + n * c.rs + h * c.hs, c0, D, lane, c.scale);
      const Chunk ai = ld<VEC>(a.ai + hD, c0, D, lane);
      const Chunk aj = ld<VEC>(a.aj + hD, c0, D, lane);
#pragma unroll
      for (int i = 0; i < NV; ++i)
        acc.v[i] = fmaf(v, aj.v[i],
                        fmaf(uu, ai.v[i], fmaf(asn, gn.v[i], acc.v[i])));
      st<VEC>(dx + n * HD + hD, acc, c0, D, lane);
      const Chunk xn = ld<VEC>(a.x + n * HD + hD, c0, D, lane);
      Chunk t0, t1;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        t0.v[i] = uu * xn.v[i];
        t1.v[i] = v * xn.v[i];
      }
      add_part(mine, 0, t0, lane);
      add_part(mine, 1, t1, lane);
    }
    write_partials<VEC>(s.part, 1, 3, part, HD, h, D, c0);
  }
}

// K4: dwe_part[chunk][k][c] = sum_n Ar[n, h, k] g_h[n, f] + S_chunk[h, k]
// a_j[c] over the chunk's DWE_ROWS rows (S_chunk: Sr summed over them), and
// row K: da_j's e term, sum_k S_chunk[h, k] We[k, c] (c = h*D + f). One
// thread a column: a row's g entry and its Ar and Sr (float4s, the same
// address across the warp) each row, several rows in flight. The rows'
// loads, not the arithmetic, set the time, so a chunk is short: 64 rows
// ran faster on the card than 32 (more partials) or 128 (longer chains).
__global__ void __launch_bounds__(DWE_THREADS)
gat_dwe_kernel(const Graph a, const Cot c, const float* __restrict__ Ar,
               const float* __restrict__ Sr, float* __restrict__ dwe_part) {
  const int H = a.H, D = a.D, K = a.K, KP = padded_k(a.K);
  const ll HD = (ll)H * D;
  const ll col = (ll)blockIdx.x * DWE_THREADS + threadIdx.x;
  if (col >= HD) return;
  const int h = (int)(col / D), f = (int)(col % D);
  const int n0 = blockIdx.y * DWE_ROWS, n1 = min(a.N, n0 + DWE_ROWS);
  float acc[MAX_K], sk[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) acc[k] = sk[k] = 0.f;
#pragma unroll 4
  for (int n = n0; n < n1; ++n) {
    const float gv = c.g[(ll)n * c.rs + h * c.hs + f] * c.scale;
    const float4* ar = reinterpret_cast<const float4*>(Ar + ((ll)n * H + h) * KP);
    const float4* sr = reinterpret_cast<const float4*>(Sr + ((ll)n * H + h) * KP);
#pragma unroll
    for (int kq = 0; kq < MAX_K / 4; ++kq)
      if (4 * kq < K) {
        const float4 t = ar[kq], u = sr[kq];
        acc[4 * kq] = fmaf(t.x, gv, acc[4 * kq]);
        acc[4 * kq + 1] = fmaf(t.y, gv, acc[4 * kq + 1]);
        acc[4 * kq + 2] = fmaf(t.z, gv, acc[4 * kq + 2]);
        acc[4 * kq + 3] = fmaf(t.w, gv, acc[4 * kq + 3]);
        sk[4 * kq] += u.x;
        sk[4 * kq + 1] += u.y;
        sk[4 * kq + 2] += u.z;
        sk[4 * kq + 3] += u.w;
      }
  }
  const float ajc = a.aj[col];
  float* out = dwe_part + (ll)blockIdx.y * (K + 1) * HD + col;
  float ej = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    if (k >= K) break;
    out[k * HD] = fmaf(sk[k], ajc, acc[k]);
    ej = fmaf(sk[k], a.We[k * HD + col], ej);
  }
  out[K * HD] = ej;
}

constexpr int FIN_GROUPS = 32;  // a column's ranges of partials
constexpr int FIN_BATCH = 8;    // partials in flight a thread

// dpar [3, H*D] = de_self, da_i, da_j and (K4) dWe [K, H*D]: the walks'
// partials (S CTAs) and the dWe partials (S3 chunks) summed in order, each
// column by FIN_GROUPS contiguous ranges whose sums are added in range
// order.
__global__ void __launch_bounds__(32 * FIN_GROUPS)
gat_finish_kernel(const float* __restrict__ part, int S,
                  const float* __restrict__ dwe_part, int S3, int K, ll HD,
                  float* __restrict__ dpar, float* __restrict__ dWe) {
  __shared__ float red[FIN_GROUPS][32];
  const int lane = threadIdx.x % 32, grp = threadIdx.x / 32;
  const ll o = (ll)blockIdx.x * 32 + lane;
  const int rows = 3 + (dwe_part ? K : 0);
  const bool ok = o < rows * HD;
  const int row = ok ? (int)(o / HD) : 0;
  const ll col = ok ? o % HD : 0;
  float s = 0.f;
  if (ok && row < 3) {
    const int a0 = (int)((ll)S * grp / FIN_GROUPS);
    const int a1 = (int)((ll)S * (grp + 1) / FIN_GROUPS);
    for (int i0 = a0; i0 < a1; i0 += FIN_BATCH) {
      float v[FIN_BATCH];
#pragma unroll
      for (int t = 0; t < FIN_BATCH; ++t) {
        const float* p = part + (ll)(i0 + t) * NPART * HD + col;
        v[t] = i0 + t >= a1 ? 0.f
               : row == 2   ? p[2 * HD] + p[3 * HD]
                            : p[row * HD];
      }
#pragma unroll
      for (int t = 0; t < FIN_BATCH; ++t)
        if (i0 + t < a1) s += v[t];
    }
  }
  if (ok && dwe_part && row >= 2) {
    const int k = row == 2 ? K : row - 3;
    const int a0 = (int)((ll)S3 * grp / FIN_GROUPS);
    const int a1 = (int)((ll)S3 * (grp + 1) / FIN_GROUPS);
    for (int i0 = a0; i0 < a1; i0 += FIN_BATCH) {
      float v[FIN_BATCH];
#pragma unroll
      for (int t = 0; t < FIN_BATCH; ++t)
        v[t] = i0 + t < a1 ? dwe_part[((ll)(i0 + t) * (K + 1) + k) * HD + col]
                           : 0.f;
#pragma unroll
      for (int t = 0; t < FIN_BATCH; ++t)
        if (i0 + t < a1) s += v[t];
    }
  }
  red[grp][lane] = s;
  __syncthreads();
  if (grp != 0 || !ok) return;
  float t = 0.f;
  for (int g2 = 0; g2 < FIN_GROUPS; ++g2) t += red[g2][lane];
  if (row < 3) dpar[row * HD + col] = t;
  else dWe[(row - 3) * HD + col] = t;
}

template <typename Kern>
int allow_smem(Kern kern, int bytes) {
  if (bytes <= DEFAULT_SMEM) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int max_smem(int bn, int be) {
  (void)bn;  // a walk CTA holds slots, never rows
  return walk_smem(be, true);
}

bool bad_shape(const Graph& a, bool fused) {
  return a.N <= 0 || a.H <= 0 || a.D <= 0 || a.bn <= 0 || a.be <= 0 ||
         a.N % a.bn != 0 || (ll)a.E != (ll)(a.N / a.bn) * a.be ||
         (fused && (a.K <= 0 || a.K > MAX_K)) ||
         max_smem(a.bn, a.be) > MAX_SMEM;
}

int walk_ctas(const Graph& a) { return (a.N / a.bn) * ((a.bn + RPC - 1) / RPC); }

dim3 walk_grid(const Graph& a) {
  return dim3(a.N / a.bn, (a.bn + RPC - 1) / RPC, (a.D + CH - 1) / CH);
}

// The instantiation of a walk kernel for this row: two features a lane
// (VEC = 2) where D is even, the row fits one chunk and every row the walks
// read or write starts 8-byte aligned (the graph's float rows and those of
// ``ptrs``); else one, WIDE where a row spans more than one chunk.
template <typename Kern>
Kern pick(const Graph& a, std::initializer_list<const float*> ptrs,
          Kern k1, Kern k1_wide, Kern k2) {
  if (a.D > CH) return k1_wide;
  if (a.D % 2) return k1;
  for (const float* p : {a.x, a.e, a.We, a.es, a.ai, a.aj})
    if (p && reinterpret_cast<uintptr_t>(p) % 8) return k1;
  for (const float* p : ptrs)
    if (p && reinterpret_cast<uintptr_t>(p) % 8) return k1;
  return k2;
}

// The whole forward attention on a.x: va [H, K] scratch for K4, else null.
template <bool FUSED>
int attention_fwd(const Graph& a, const float* bias, float* va, float* alpha,
                  float* aself, float* dlr, float* dls, float* out,
                  cudaStream_t st) {
  if (FUSED) {
    const int blocks = (a.H * a.K + WARPS - 1) / WARPS;
    gat_edge_vec_kernel<<<blocks, THREADS, 0, st>>>(a, va);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int smem = walk_smem(a.be, false);
  auto kern = pick(a, {bias, out}, gat_fwd_kernel<FUSED, 1, false>,
                   gat_fwd_kernel<FUSED, 1, true>,
                   gat_fwd_kernel<FUSED, 2, false>);
  const int err = allow_smem(kern, smem);
  if (err) return err;
  kern<<<walk_grid(a), THREADS, smem, st>>>(a, va, bias, out, alpha, aself,
                                            dlr, dls);
  return (int)cudaGetLastError();
}

struct AttnWork {  // scratch of attention_bwd
  BwdOut o;
  float* dwe_part;  // [S3][K + 1][H*D] (K4)
};

struct Carver {
  float* base;
  ll off = 0;
  float* take(ll n) {
    float* p = base ? base + off : nullptr;
    off += (n + 3) / 4 * 4;
    return p;
  }
};

int dwe_chunks(int N) { return (N + DWE_ROWS - 1) / DWE_ROWS; }

AttnWork carve_attn(Carver& cv, const Graph& a, bool fused) {
  AttnWork w{};
  const ll NH = (ll)a.N * a.H, EH = (ll)a.E * a.H, HD = (ll)a.H * a.D;
  w.o.dz = cv.take(EH);
  w.o.dzs = cv.take(NH);
  w.o.u = cv.take(NH);
  w.o.part = cv.take((ll)walk_ctas(a) * NPART * HD);
  if (fused) {
    w.o.Ar = cv.take(NH * padded_k(a.K));
    w.o.Sr = cv.take(NH * padded_k(a.K));
    w.dwe_part = cv.take((ll)dwe_chunks(a.N) * (a.K + 1) * HD);
  }
  return w;
}

// The whole backward attention: dx, de (K5) or dWe (K4), and dpar [3, H*D]
// = de_self, da_i, da_j.
template <bool FUSED>
int attention_bwd(const Graph& a, const Cot& c, const float* alpha,
                  const float* aself, const float* dlr, const float* dls,
                  const AttnWork& w, float* dx, float* de, float* dWe,
                  float* dpar, cudaStream_t st) {
  const ll HD = (ll)a.H * a.D;
  const int smem = walk_smem(a.be, true);
  auto rcv = pick(a, {c.g, dx, de}, gat_bwd_rcv_kernel<FUSED, 1, false>,
                  gat_bwd_rcv_kernel<FUSED, 1, true>,
                  gat_bwd_rcv_kernel<FUSED, 2, false>);
  auto snd = pick(a, {c.g, dx, de}, gat_bwd_snd_kernel<FUSED, 1, false>,
                  gat_bwd_snd_kernel<FUSED, 1, true>,
                  gat_bwd_snd_kernel<FUSED, 2, false>);
  int err = allow_smem(rcv, smem);
  if (err) return err;
  err = allow_smem(snd, smem);
  if (err) return err;
  rcv<<<walk_grid(a), THREADS, smem, st>>>(a, c, alpha, aself, dlr, dls, de, w.o);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (FUSED) {
    gat_dwe_kernel<<<dim3((unsigned)((HD + DWE_THREADS - 1) / DWE_THREADS),
                          dwe_chunks(a.N)),
                     DWE_THREADS, 0, st>>>(a, c, w.o.Ar, w.o.Sr, w.dwe_part);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  snd<<<walk_grid(a), THREADS, smem, st>>>(a, c, alpha, aself, w.o.dz,
                                           w.o.dzs, w.o.u, dx, w.o.part);
  err = (int)cudaGetLastError();
  if (err) return err;
  const ll outs = (3 + (FUSED ? a.K : 0)) * HD;
  gat_finish_kernel<<<(unsigned)((outs + 31) / 32), 32 * FIN_GROUPS, 0, st>>>(
      w.o.part, walk_ctas(a), FUSED ? w.dwe_part : nullptr, dwe_chunks(a.N),
      a.K, HD, dpar, dWe);
  return (int)cudaGetLastError();
}

struct ConvBwdWork {
  float* dx;     // [N, H*D]
  AttnWork attn;
  float* gpart;  // split-K partials of dWl
  float* cpart;  // column-sum partials of dbias / dbl
  ll total;
};

ConvBwdWork carve_conv_bwd(float* base, const Graph& a, int Din) {
  Carver cv{base};
  ConvBwdWork w;
  const ll HD = (ll)a.H * a.D;
  w.dx = cv.take((ll)a.N * HD);
  w.attn = carve_attn(cv, a, true);
  w.gpart = cv.take((ll)wgrad_splits(Din, (int)HD, a.N) * Din * HD);
  w.cpart = cv.take((ll)((a.N + COLSUM_ROWS - 1) / COLSUM_ROWS) * HD);
  w.total = cv.off;
  return w;
}

}  // namespace

extern "C" {

int pgt_gat_max_k() { return MAX_K; }
int pgt_gat_max_smem() { return MAX_SMEM; }
// Dynamic shared memory, in bytes, of the largest kernel at this layout.
int pgt_gat_smem(int block_nodes, int block_edges) {
  return max_smem(block_nodes, block_edges);
}

// Float32 elements of scratch for each entry point.
long long pgt_gat_attn_fwd_workspace(int N, int E, int H) {
  (void)N; (void)E; (void)H;
  return 4;  // K5's forward needs none
}
long long pgt_gat_conv_fwd_workspace(int N, int H) {
  (void)N;
  Carver cv{nullptr};
  cv.take((ll)H * MAX_K);  // va
  return cv.off;
}
long long pgt_gat_attn_bwd_workspace(int N, int E, int H, int D,
                                     int block_nodes) {
  Graph a{};
  a.N = N; a.E = E; a.H = H; a.D = D; a.bn = block_nodes;
  Carver cv{nullptr};
  carve_attn(cv, a, false);
  return cv.off;
}
long long pgt_gat_conv_bwd_workspace(int N, int E, int Din, int H, int D,
                                     int K, int block_nodes) {
  Graph a{};
  a.N = N; a.E = E; a.H = H; a.D = D; a.K = K; a.bn = block_nodes;
  return carve_conv_bwd(nullptr, a, Din).total;
}

// K5 forward: out [N, H*D] from x [N, H*D], e [E, H*D], es, ai, aj [H*D],
// snd, rcv (global rows), w [E]. Also writes alpha, dlr [E, H] and aself,
// dls [N, H] for the backward. Returns the first CUDA error, 0 if none.
int pgt_gat_attn_fwd(const float* x, const float* e, const float* es,
                     const float* ai, const float* aj, const int* snd,
                     const int* rcv, const float* w, float* out, float* alpha,
                     float* aself, float* dlr, float* dls, float* work, int N,
                     int E, int H, int D, int block_nodes, int block_edges,
                     float slope, void* stream) {
  (void)work;
  const Graph a{x, e, nullptr, nullptr, es, ai, aj, snd, rcv, w,
                N, E, H, D, 0, block_nodes, block_edges, slope};
  if (bad_shape(a, false)) return (int)cudaErrorInvalidValue;
  return attention_fwd<false>(a, nullptr, nullptr, alpha, aself, dlr, dls,
                              out, (cudaStream_t)stream);
}

// K5 backward from the cotangent g [N, H*D] and the forward's alpha, aself,
// dlr, dls: writes dx [N, H*D], de [E, H*D] (every row) and dpar [3, H*D]
// = de_self, da_i, da_j.
int pgt_gat_attn_bwd(const float* g, const float* x, const float* e,
                     const float* es, const float* ai, const float* aj,
                     const int* snd, const int* rcv, const float* w,
                     const float* alpha, const float* aself, const float* dlr,
                     const float* dls, float* dx, float* de, float* dpar,
                     float* work, int N, int E, int H, int D, int block_nodes,
                     int block_edges, float slope, void* stream) {
  const Graph a{x, e, nullptr, nullptr, es, ai, aj, snd, rcv, w,
                N, E, H, D, 0, block_nodes, block_edges, slope};
  if (bad_shape(a, false)) return (int)cudaErrorInvalidValue;
  Carver cv{work};
  const AttnWork wk = carve_attn(cv, a, false);
  const Cot c{g, (ll)H * D, (ll)D, 1.f};
  return attention_bwd<false>(a, c, alpha, aself, dlr, dls, wk, dx, de,
                              nullptr, dpar, (cudaStream_t)stream);
}

// K4 forward: out [N, D] and the saved projection x [N, H*D] from h
// [N, Din], Wl [Din, H*D] (any strides), bl [H*D], ein [E, K], We
// [K, H*D], es, ai, aj [H*D], bias [D]. Also writes alpha, dlr [E, H] and
// aself, dls [N, H].
int pgt_gat_conv_fwd(const float* h, const float* Wl, ll wls0, ll wls1,
                     const float* bl, const float* ein, const float* We,
                     const float* es, const float* ai, const float* aj,
                     const float* bias, const int* snd, const int* rcv,
                     const float* w, float* out, float* x, float* alpha,
                     float* aself, float* dlr, float* dls, float* work, int N,
                     int E, int Din, int H, int D, int K, int block_nodes,
                     int block_edges, float slope, void* stream) {
  const Graph a{x, nullptr, ein, We, es, ai, aj, snd, rcv, w,
                N, E, H, D, K, block_nodes, block_edges, slope};
  if (bad_shape(a, true) || Din <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = gemm(h, Din, 1, Wl, wls0, wls1, x, N, H * D, Din, 1, nullptr,
                       bl, nullptr, 0, st);
  if (err) return err;
  Carver cv{work};
  float* va = cv.take((ll)H * MAX_K);
  return attention_fwd<true>(a, bias, va, alpha, aself, dlr, dls, out, st);
}

// K4 backward from g [N, D], the saved x and the forward's alpha, aself,
// dlr, dls: writes dh [N, Din], dWl [Din, H*D], dbl [H*D], dWe [K, H*D],
// dpar [3, H*D] = de_self, da_i, da_j, and dbias [D].
int pgt_gat_conv_bwd(const float* g, const float* h, const float* Wl, ll wls0,
                     ll wls1, const float* x, const float* ein,
                     const float* We, const float* es, const float* ai,
                     const float* aj, const int* snd, const int* rcv,
                     const float* w, const float* alpha, const float* aself,
                     const float* dlr, const float* dls, float* dh,
                     float* dWl, float* dbl, float* dWe, float* dpar,
                     float* dbias, float* work, int N, int E, int Din, int H,
                     int D, int K, int block_nodes, int block_edges,
                     float slope, void* stream) {
  const Graph a{x, nullptr, ein, We, es, ai, aj, snd, rcv, w,
                N, E, H, D, K, block_nodes, block_edges, slope};
  if (bad_shape(a, true) || Din <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * D;
  const ConvBwdWork wk = carve_conv_bwd(work, a, Din);
  // dbias sums g over all rows, before the head mean's 1/H
  int err = colsum(g, N, D, wk.cpart, dbias, st);
  if (err) return err;
  const Cot c{g, (ll)D, 0, 1.f / (float)H};
  err = attention_bwd<true>(a, c, alpha, aself, dlr, dls, wk.attn, wk.dx,
                            nullptr, dWe, dpar, st);
  if (err) return err;
  // dWl = h^T dx: A(i = d, k = n) = h[n, d]
  err = gemm(h, 1, Din, wk.dx, HD, 1, dWl, Din, HD, N,
             wgrad_splits(Din, HD, N), wk.gpart, nullptr, nullptr, 0, st);
  if (err) return err;
  err = colsum(wk.dx, N, HD, wk.cpart, dbl, st);
  if (err) return err;
  // dh = dx @ Wl^T: B(k = c, j = d) = Wl[d, c]
  return gemm(wk.dx, HD, 1, Wl, wls1, wls0, dh, N, Din, HD, 1, nullptr,
              nullptr, nullptr, 0, st);
}

}  // extern "C"
