// The GAT attention walks and their helpers, shared by gat.cu (K4's and
// K5's float32 kernels and the library's C interface) and gat_bf16.cu
// (their bfloat16 variants): two sources, so that the two sets of walk
// instantiations compile in parallel (ops/_build.py). What the kernels
// compute, what bounds them and how they are designed: the notes at the
// top of gat.cu. Everything in the anonymous namespace has internal
// linkage, so each source gets its own copy of what it instantiates.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

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

// What every kernel reads. x is [N, H*D], float or (K4's bfloat16
// backward) bfloat16, as the kernel's TX says; xm the bfloat16 copy of x
// that K4's bfloat16 forward takes its messages from, else null; e is
// [E, H*D] (K5) or null; ein [E, K] and We [K, H*D] (K4) or null; es, ai,
// aj are [H*D].
struct Graph {
  const void* x;
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
  const bf16* xm;
  // K4's bfloat16 forward: [N][H][3] = x·a_i, x·a_j, (x + e_self)·a_j of
  // the float32 x (gat_bf16.cu's gat_proj16_kernel), else null
  const float* proj;
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

// v rounded to the nearest bfloat16 (ties to even), as a float: the Pallas
// kernel's astype(bfloat16).
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// The same from bfloat16 rows (VEC = 2: 4-byte pairs).
template <int VEC>
__device__ __forceinline__ Chunk ld(const bf16* p, int c0, int D, int lane,
                                    float scale = 1.f) {
  Chunk c;
#pragma unroll
  for (int j = 0; j < NV / VEC; ++j) {
    const int f = c0 + (lane + 32 * j) * VEC;
    if constexpr (VEC == 2) {
      const float2 t =
          f < D ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + f))
                : make_float2(0.f, 0.f);
      c.v[2 * j] = t.x * scale;
      c.v[2 * j + 1] = t.y * scale;
    } else {
      c.v[j] = f < D ? __bfloat162float(p[f]) * scale : 0.f;
    }
  }
  return c;
}

__device__ __forceinline__ Chunk rnd(Chunk c) {
#pragma unroll
  for (int i = 0; i < NV; ++i) c.v[i] = rnd(c.v[i]);
  return c;
}

// ld, each value rounded to bfloat16 with R.
template <int VEC, bool R, typename T>
__device__ __forceinline__ Chunk ldr(const T* p, int c0, int D, int lane,
                                     float scale = 1.f) {
  const Chunk c = ld<VEC>(p, c0, D, lane, scale);
  return R ? rnd(c) : c;
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

template <int VEC>
__device__ __forceinline__ void st(bf16* p, const Chunk& c, int c0, int D,
                                   int lane) {
#pragma unroll
  for (int j = 0; j < NV / VEC; ++j) {
    const int f = c0 + (lane + 32 * j) * VEC;
    if (f >= D) continue;
    if constexpr (VEC == 2)
      *reinterpret_cast<__nv_bfloat162*>(p + f) =
          __floats2bfloat162_rn(c.v[2 * j], c.v[2 * j + 1]);
    else
      p[f] = __float2bfloat16_rn(c.v[j]);
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

// c += bf(p * m), elementwise: a bfloat16 message added to a float32 sum
__device__ __forceinline__ void add_rounded(Chunk& c, float p, const Chunk& m) {
#pragma unroll
  for (int i = 0; i < NV; ++i) c.v[i] += rnd(__fmul_rn(p, m.v[i]));
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

// ``we``: floats of the We tile (backward MAX_K * CH, else 0)
__host__ __device__ int walk_floats(int be, bool backward, int we) {
  return be + WARPS * (backward ? 2 * be + 2 * CH : be) + we;
}

int walk_smem(int be, bool backward, int we) {
  return walk_floats(be, backward, we) * 4 + 2 * be * 4 + WARPS * RPW * be * 2;
}

int bwd_smem(int be) { return walk_smem(be, true, MAX_K * CH); }

__device__ __forceinline__ Walk carve(float* smem, int be, bool backward,
                                      int we) {
  Walk s;
  s.w = smem;
  s.buf = smem + be;
  s.part = s.buf + WARPS * 2 * be;  // backward only
  s.We = backward ? s.part + WARPS * 2 * CH : s.buf + WARPS * be;
  s.ls = (int*)(smem + walk_floats(be, backward, we));
  s.lr = s.ls + be;
  s.list = (unsigned short*)(s.lr + be);
  return s;
}

// Heads h0 .. h0 + nh - 1 of We's chunk c0 into dst as the lanes hold them,
// dst[((h - h0) * K + k) * CH + i * 32 + lane] = We[k, h*D + feat(c0, lane,
// i)] (zeros past D), rounded to bfloat16 with BF: a warp a row of We, its
// NV loads a lane in flight together; every thread of the CTA takes part,
// and the caller's barrier follows.
template <int VEC, bool BF>
__device__ __forceinline__ void stage_we(float* dst, const Graph& a, int h0,
                                         int nh, int c0) {
  const ll HD = (ll)a.H * a.D;
  const int lane = threadIdx.x % 32;
  for (int hk = threadIdx.x / 32; hk < nh * a.K; hk += WARPS) {
    const float* src = a.We + (hk % a.K) * HD + (ll)(h0 + hk / a.K) * a.D;
    float v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int f = feat<VEC>(c0, lane, i);
      v[i] = f < a.D ? (BF ? rnd(src[f]) : src[f]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) dst[(hk * NV + i) * 32 + lane] = v[i];
  }
}

// Stage block b's slots, STAGE_U a thread with every load issued before the
// first store; returns after the CTA's barrier.
constexpr int STAGE_U = 4;

// The rule of a slot that counts: w > 0, both endpoints in the block.
__host__ __device__ __forceinline__ bool counts(float w, ll ls, ll lr,
                                                int bn) {
  return w > 0.f && ls >= 0 && ls < bn && lr >= 0 && lr < bn;
}

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
      const bool ok = counts(we[u], ls, lr, a.bn);
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
// first chunk's CTAs, alpha, dlr [E, H] and aself, dls [N, H]. BF: K5's
// bfloat16 variant (see the note above; K4's is gat_bf16.cu's).
template <bool FUSED, int VEC, bool WIDE, bool BF, typename TX>
__global__ void __launch_bounds__(THREADS, WALK_MIN_CTAS)
gat_fwd_kernel(const Graph a, const float* __restrict__ va,
               const float* __restrict__ bias, float* __restrict__ out,
               float* __restrict__ alpha, float* __restrict__ aself,
               float* __restrict__ dlr, float* __restrict__ dls) {
  static_assert(!(BF && FUSED) && std::is_same<TX, float>::value,
                "K4's bfloat16 forward is gat_conv_fwd16_kernel");
  // slots in flight a warp: K5 loads an e row beside each x row
  constexpr int B = FUSED ? 4 : 2;
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, D = a.D, K = a.K, be = a.be;
  const TX* X = static_cast<const TX*>(a.x);
  const Walk s = carve(smem, be, false, 0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.z * CH;
  // writes the softmax scalars
  const bool first = blockIdx.z == 0 && alpha != nullptr;
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
      const TX* xr_p = X + n * HD + hD;
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
      const float pself = warp_sum(row_dot<WIDE>(
          c0, D, dot(xe, aj), [&](int cc) {
            return dot(add(ld<VEC>(xr_p, cc, D, lane),
                           ld<VEC>(es_p, cc, D, lane)),
                       ld<VEC>(aj_p, cc, D, lane));
          }));
      const float sraw = ps + pself;
      const float ds = sraw >= 0.f ? 1.f : a.slope;
      const float sl = sraw * ds;
      // online softmax, started by the self loop (BF: the max and the
      // denominator only; the messages follow in a second walk)
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
          const TX* xs = X + (base + s.ls[q]) * HD + hD;
          msg[u] = ld<VEC>(xs, c0, D, lane);
          if (FUSED) {
            ek[u] = lane < K ? a.ein[(e0 + q) * K + lane] : 0.f;
          } else {
            msg[u] = add(msg[u], ld<VEC>(a.e + (e0 + q) * HD + hD, c0, D, lane));
          }
        }
#pragma unroll
        for (int u = 0; u < B; ++u) {
          if (i0 + u >= nq) break;
          const int q = L[i0 + u];
          const TX* xs = X + (base + s.ls[q]) * HD + hD;
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
          if (!BF) {
            rescale_add(acc, sc, p, msg[u]);
            if (FUSED) A = fmaf(p, ek[u], A * sc);
          }
          if (lane == 0) lg[i0 + u] = l;
          if (first && lane == 0) dlr[(e0 + q) * H + h] = d;
        }
      }
      __syncwarp();
      if (BF) {  // the body's denominator: p summed in slot order, p_self
        den = 0.f;
        for (int i = 0; i < nq; ++i) den += expf(lg[i] - m) * s.w[L[i]];
        den += expf(sl - m);
      }
      const float inv = 1.f / fmaxf(den, 1e-30f);
      if (first) {
        for (int i = lane; i < nq; i += 32) {
          const int q = L[i];
          const float p = expf(lg[i] - m) * s.w[q];
          alpha[(e0 + q) * H + h] = BF ? p / fmaxf(den, 1e-30f) : p * inv;
        }
        if (lane == 0) {
          aself[n * H + h] = BF ? expf(sl - m) / den : expf(sl - m) * inv;
          dls[n * H + h] = ds;
        }
      }
      if constexpr (BF) {
        // the second walk: numer = sum bf(p_e msg_e), p_e = exp(l_e - m)
        // w_e at the row's max, msg_e = bf(x[s]) + bf(e_e)
        constexpr int B2 = 2;
        Chunk nu = zero();
        for (int i0 = 0; i0 < nq; i0 += B2) {
          Chunk msg[B2];
#pragma unroll
          for (int u = 0; u < B2; ++u) {
            if (i0 + u >= nq) break;
            const int q = L[i0 + u];
            msg[u] = add(ldr<VEC, true>(X + (base + s.ls[q]) * HD + hD, c0, D, lane),
                         ldr<VEC, true>(a.e + (e0 + q) * HD + hD, c0, D, lane));
          }
#pragma unroll
          for (int u = 0; u < B2; ++u) {
            if (i0 + u >= nq) break;
            const int q = L[i0 + u];
            add_rounded(nu, expf(lg[i0 + u] - m) * s.w[q], msg[u]);
          }
        }
        __syncwarp();  // lg is rewritten by the next head
        // the self message, rounded
        const Chunk self = rnd(xe);
        const float p_self = expf(sl - m);
#pragma unroll
        for (int i = 0; i < NV; ++i)
          acc.v[i] = fmaf(p_self, self.v[i], nu.v[i]) / den;
      } else {
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
        }
      }
      if (FUSED)
        o = add(o, acc);
      else
        st<VEC>(out + n * HD + hD, acc, c0, D, lane);
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
// [E, H*D]; K4 Ar, Sr (not under BF: its dWe takes each slot's de);
// partial rows 0 (de_self) and 2 (da_j: dzs e_self and, K5, dz e). BF:
// the bfloat16 variant (see the note above), x read as TX.
template <bool FUSED, int VEC, bool WIDE, bool BF, typename TX>
__global__ void __launch_bounds__(THREADS, WALK_MIN_CTAS)
gat_bwd_rcv_kernel(const Graph a, const Cot c, const float* __restrict__ alpha,
                   const float* __restrict__ aself,
                   const float* __restrict__ dlr,
                   const float* __restrict__ dls, float* __restrict__ de,
                   const BwdOut o) {
  static_assert(BF || std::is_same<TX, float>::value, "bfloat16 x is BF's");
  // slots in flight a warp: K5 loads an e row beside each x row
  constexpr int B = FUSED ? 4 : 2;
  // K5 under BF rounds the gathered x and e rows and the self message
  constexpr bool RX = BF && !FUSED;
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, D = a.D, K = a.K, be = a.be;
  const TX* X = static_cast<const TX*>(a.x);
  const Walk s = carve(smem, be, true, MAX_K * CH);
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
  float* adl = dal + be;  // alpha * LeakyReLU'(raw) (BF: LeakyReLU'(raw))
  float* mine = s.part + warp * 2 * CH;

  for (int h = 0; h < H; ++h) {
    const ll hD = (ll)h * D;
    const float* es_p = a.es + hD;
    const float* aj_p = a.aj + hD;
    if (FUSED) {  // We_h's chunk, as the lanes hold it; read after the barrier
      stage_we<VEC, BF>(s.We, a, h, 1, c0);
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
      const TX* xr_p = X + n * HD + hD;
      const Chunk g = ld<VEC>(g_p, c0, D, lane, c.scale);
      const Chunk gb = BF ? rnd(g) : g;  // the gathered g_r's rounding
      // daself = g_n · (x_n + e_self); K5 under BF: both rounded
      const float daself = warp_sum(row_dot<WIDE>(
          c0, D,
          dot(RX ? gb : g,
              RX ? rnd(add(ld<VEC>(xr_p, c0, D, lane), ld<VEC>(es_p, c0, D, lane)))
                 : add(ld<VEC>(xr_p, c0, D, lane), ld<VEC>(es_p, c0, D, lane))),
          [&](int cc) {
            const Chunk xe = add(ld<VEC>(xr_p, cc, D, lane),
                                 ld<VEC>(es_p, cc, D, lane));
            return dot(ldr<VEC, RX>(g_p, cc, D, lane, c.scale),
                       RX ? rnd(xe) : xe);
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
              t = fmaf(gb.v[i], s.We[(k * NV + i) * 32 + lane], t);
            const float* W = a.We + k * HD + hD;
            t = row_dot<WIDE>(c0, D, t, [&](int cc) {
              return dot(ldr<VEC, BF>(g_p, cc, D, lane, c.scale),
                         ldr<VEC, BF>(W, cc, D, lane));
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
          msg[u] = ldr<VEC, RX>(X + (base + s.ls[q]) * HD + hD, c0, D, lane);
          al[u] = alpha[(e0 + q) * H + h];
          dl[u] = dlr[(e0 + q) * H + h];
          if (FUSED) {
            ek[u] = lane < K ? a.ein[(e0 + q) * K + lane] : 0.f;
            if (BF) ek[u] = rnd(ek[u]);
          } else {
            msg[u] = add(msg[u], ldr<VEC, RX>(a.e + (e0 + q) * HD + hD, c0, D,
                                             lane));
          }
        }
#pragma unroll
        for (int u = 0; u < B; ++u) {
          if (i0 + u >= nq) break;
          const int q = L[i0 + u];
          const TX* xs = X + (base + s.ls[q]) * HD + hD;
          const float* ep = FUSED ? nullptr : a.e + (e0 + q) * HD + hD;
          float part = row_dot<WIDE>(c0, D, dot(gb, msg[u]), [&](int cc) {
            Chunk t = ldr<VEC, RX>(xs, cc, D, lane);
            if (!FUSED) t = add(t, ldr<VEC, RX>(ep, cc, D, lane));
            return dot(ldr<VEC, BF>(g_p, cc, D, lane, c.scale), t);
          });
          if (FUSED) {
            part = fmaf(ek[u], qk, part);
            ar = fmaf(al[u], ek[u], ar);
          }
          const float d = warp_sum(part);
          // BF: the body's order, each product rounded, then summed
          cr = BF ? cr + __fmul_rn(al[u], d) : fmaf(al[u], d, cr);
          if (lane == 0) {
            dal[i0 + u] = d;
            adl[i0 + u] = BF ? dl[u] : al[u] * dl[u];  // BF: the slope alone
          }
        }
      }
      __syncwarp();
      // dz, dzs and u, lane-parallel over the row's slots (BF: dz as
      // alpha (dalpha - c) LeakyReLU' and u summed in slot order, the
      // body's association)
      cr = BF ? cr + __fmul_rn(asr, daself) : fmaf(asr, daself, cr);
      const float dzs = asr * (daself - cr) * dlsr;
      float up = 0.f;
      for (int i = lane; i < nq; i += 32) {
        const int q = L[i];
        const float z = BF ? __fmul_rn(__fmul_rn(alpha[(e0 + q) * H + h],
                                                 dal[i] - cr),
                                       adl[i])
                           : adl[i] * (dal[i] - cr);
        dal[i] = z;
        up += z;
        if (first) o.dz[(e0 + q) * H + h] = z;
      }
      float uu;
      if (BF) {
        __syncwarp();
        float sq = 0.f;
        for (int i = 0; i < nq; ++i) sq += dal[i];
        uu = sq + dzs;
      } else {
        uu = warp_sum(up) + dzs;
      }
      if (first && lane == 0) {
        o.u[n * H + h] = uu;
        o.dzs[n * H + h] = dzs;
      }
      __syncwarp();
      if (FUSED) {
        // S_r = sum dz_e ein_e, one add a slot; lanes K .. KP - 1 write 0
        if (!BF && first && lane < padded_k(K)) {
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
        // pass 2: de_e = alpha_e g_r + dz_e a_j; da_j += dz_e e_e (e
        // unrounded)
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
              dv.v[i] = fmaf(al[u], gb.v[i], z * aj.v[i]);
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

// Backward walk by sender: v_n and dx [N, H*D] (K4 under BF also its
// bfloat16 copy dxb, pitch ldb); partial rows 1 (da_i) and 3 (da_j: v x).
template <bool FUSED, int VEC, bool WIDE, bool BF, typename TX>
__global__ void __launch_bounds__(THREADS, WALK_MIN_CTAS)
gat_bwd_snd_kernel(const Graph a, const Cot c, const float* __restrict__ alpha,
                   const float* __restrict__ aself,
                   const float* __restrict__ dz, const float* __restrict__ dzs,
                   const float* __restrict__ u, float* __restrict__ dx,
                   bf16* __restrict__ dxb, ll ldb, float* __restrict__ part) {
  static_assert(BF || std::is_same<TX, float>::value, "bfloat16 x is BF's");
  constexpr int B = 4;
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, D = a.D, be = a.be;
  const TX* X = static_cast<const TX*>(a.x);
  const Walk s = carve(smem, be, true, MAX_K * CH);
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
      float vp = 0.f;  // BF: the sum in slot order, the body's
      if (BF)
        for (int i = 0; i < nq; ++i) vp += dz[(e0 + L[i]) * H + h];
      else
        for (int i = lane; i < nq; i += 32) vp += dz[(e0 + L[i]) * H + h];
      const float v = (BF ? vp : warp_sum(vp)) + dzs[n * H + h];
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
          gr[t] = ldr<VEC, BF>(c.g + (base + s.lr[q]) * c.rs + h * c.hs, c0,
                               D, lane, c.scale);
          al[t] = alpha[(e0 + q) * H + h];
        }
#pragma unroll
        for (int t = 0; t < B; ++t)
          if (i0 + t < nq) {
            if (BF)  // the message gradient's rounding, bf(alpha_e g_r)
              add_rounded(acc, al[t], gr[t]);
            else
              axpy(acc, al[t], gr[t]);
          }
      }
      // the self term: K5 under BF takes the rounded g_n, K4 the unrounded
      const Chunk gn = ldr<VEC, BF && !FUSED>(c.g + n * c.rs + h * c.hs, c0, D,
                                              lane, c.scale);
      const Chunk ai = ld<VEC>(a.ai + hD, c0, D, lane);
      const Chunk aj = ld<VEC>(a.aj + hD, c0, D, lane);
#pragma unroll
      for (int i = 0; i < NV; ++i)  // BF: each product rounded, the body's
        acc.v[i] = BF ? acc.v[i] + __fmul_rn(asn, gn.v[i])
                          + __fmul_rn(uu, ai.v[i]) + __fmul_rn(v, aj.v[i])
                      : fmaf(v, aj.v[i],
                             fmaf(uu, ai.v[i], fmaf(asn, gn.v[i], acc.v[i])));
      st<VEC>(dx + n * HD + hD, acc, c0, D, lane);
      if (BF && FUSED) st<VEC>(dxb + n * ldb + hD, acc, c0, D, lane);
      const Chunk xn = ld<VEC>(X + n * HD + hD, c0, D, lane);
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
  return bwd_smem(be);
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
// read or write starts 8-byte aligned (4-byte for bfloat16 rows: x as TX,
// the graph's float rows, those of ``ptrs`` and, bfloat16, ``ptrs16``);
// else one, WIDE where a row spans more than one chunk.
template <typename TX, typename Kern>
Kern pick(const Graph& a, std::initializer_list<const float*> ptrs,
          std::initializer_list<const bf16*> ptrs16, Kern k1, Kern k1_wide,
          Kern k2) {
  if (a.D > CH) return k1_wide;
  if (a.D % 2) return k1;
  if (reinterpret_cast<uintptr_t>(a.x) % (2 * sizeof(TX))) return k1;
  for (const float* p : {a.e, a.We, a.es, a.ai, a.aj})
    if (p && reinterpret_cast<uintptr_t>(p) % 8) return k1;
  for (const float* p : ptrs)
    if (p && reinterpret_cast<uintptr_t>(p) % 8) return k1;
  for (const bf16* p : ptrs16)
    if (p && reinterpret_cast<uintptr_t>(p) % 4) return k1;
  return k2;
}

// The whole forward attention: va [H, K] scratch for K4, else null.
template <bool FUSED, bool BF>
int attention_fwd(const Graph& a, const float* bias, float* va, float* alpha,
                  float* aself, float* dlr, float* dls, float* out,
                  cudaStream_t st) {
  if (FUSED) {
    const int blocks = (a.H * a.K + WARPS - 1) / WARPS;
    gat_edge_vec_kernel<<<blocks, THREADS, 0, st>>>(a, va);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int smem = walk_smem(a.be, false, 0);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = pick<float>(a, {bias, out}, {},
                          gat_fwd_kernel<FUSED, 1, false, BF, float>,
                          gat_fwd_kernel<FUSED, 1, true, BF, float>,
                          gat_fwd_kernel<FUSED, 2, false, BF, float>);
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
  bf16* take16(ll n) { return reinterpret_cast<bf16*>(take((n + 1) / 2)); }
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

// The whole backward attention of K4's float32 variant and of K5: dx, de
// (K5) or dWe (K4), and dpar [3, H*D] = de_self, da_i, da_j. (K4's
// bfloat16 backward is gat_bf16.cu's.)
template <bool FUSED, bool BF>
int attention_bwd(const Graph& a, const Cot& c, const float* alpha,
                  const float* aself, const float* dlr, const float* dls,
                  const AttnWork& w, float* dx, float* de, float* dWe,
                  float* dpar, cudaStream_t st) {
  static_assert(!(FUSED && BF), "K4's bfloat16 backward is gat_bf16.cu's");
  const ll HD = (ll)a.H * a.D;
  const int smem = bwd_smem(a.be);
  auto rcv = pick<float>(a, {c.g, dx, de}, {},
                         gat_bwd_rcv_kernel<FUSED, 1, false, BF, float>,
                         gat_bwd_rcv_kernel<FUSED, 1, true, BF, float>,
                         gat_bwd_rcv_kernel<FUSED, 2, false, BF, float>);
  auto snd = pick<float>(a, {c.g, dx, de}, {},
                         gat_bwd_snd_kernel<FUSED, 1, false, BF, float>,
                         gat_bwd_snd_kernel<FUSED, 1, true, BF, float>,
                         gat_bwd_snd_kernel<FUSED, 2, false, BF, float>);
  int err = allow_smem(rcv, smem);
  if (err) return err;
  err = allow_smem(snd, smem);
  if (err) return err;
  rcv<<<walk_grid(a), THREADS, smem, st>>>(a, c, alpha, aself, dlr, dls, de, w.o);
  err = (int)cudaGetLastError();
  if (err) return err;
  const unsigned cols = (unsigned)((HD + DWE_THREADS - 1) / DWE_THREADS);
  int s3 = 0;
  if (FUSED) {
    s3 = dwe_chunks(a.N);
    gat_dwe_kernel<<<dim3(cols, s3), DWE_THREADS, 0, st>>>(a, c, w.o.Ar,
                                                           w.o.Sr, w.dwe_part);
  }
  err = (int)cudaGetLastError();
  if (err) return err;
  snd<<<walk_grid(a), THREADS, smem, st>>>(a, c, alpha, aself, w.o.dz,
                                           w.o.dzs, w.o.u, dx, nullptr, 0,
                                           w.o.part);
  err = (int)cudaGetLastError();
  if (err) return err;
  const ll outs = (3 + (FUSED ? a.K : 0)) * HD;
  gat_finish_kernel<<<(unsigned)((outs + 31) / 32), 32 * FIN_GROUPS, 0, st>>>(
      w.o.part, walk_ctas(a), FUSED ? w.dwe_part : nullptr, s3, a.K, HD, dpar,
      dWe);
  return (int)cudaGetLastError();
}

// K4's float32 scratch besides the walks'.
struct ConvFwdWork {
  float* va;  // [H, MAX_K]
  ll total;
};

ConvFwdWork carve_conv_fwd(float* base, int H) {
  Carver cv{base};
  ConvFwdWork w{};
  w.va = cv.take((ll)H * MAX_K);
  w.total = cv.off;
  return w;
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
  ConvBwdWork w{};
  const ll HD = (ll)a.H * a.D;
  w.dx = cv.take((ll)a.N * HD);
  w.attn = carve_attn(cv, a, true);
  w.gpart = cv.take((ll)wgrad_splits(Din, (int)HD, a.N) * Din * HD);
  w.cpart = cv.take((ll)((a.N + COLSUM_ROWS - 1) / COLSUM_ROWS) * HD);
  w.total = cv.off;
  return w;
}

}  // namespace

// The bfloat16 entry points (gat_bf16.cu): the arguments of the public
// ones in gat.cu, without bf16_compute.
extern "C" {
long long pgt_gat_conv_fwd_workspace_bf16(int N, int Din, int H, int D);
long long pgt_gat_conv_r16_elems_bf16(int N, int Din, int H, int D);
long long pgt_gat_conv_bwd_workspace_bf16(int N, int E, int Din, int H,
                                          int D, int K, int block_nodes);
int pgt_gat_attn_fwd_bf16(const float* x, const float* e, const float* es,
                          const float* ai, const float* aj, const int* snd,
                          const int* rcv, const float* w, float* out,
                          float* alpha, float* aself, float* dlr, float* dls,
                          int N, int E, int H, int D, int block_nodes,
                          int block_edges, float slope, void* stream);
int pgt_gat_attn_bwd_bf16(const float* g, const float* x, const float* e,
                          const float* es, const float* ai, const float* aj,
                          const int* snd, const int* rcv, const float* w,
                          const float* alpha, const float* aself,
                          const float* dlr, const float* dls, float* dx,
                          float* de, float* dpar, float* work, int N, int E,
                          int H, int D, int block_nodes, int block_edges,
                          float slope, void* stream);
int pgt_gat_conv_fwd_bf16(const float* h, const float* Wl, ll wls0, ll wls1,
                          const float* bl, const float* ein, const float* We,
                          const float* es, const float* ai, const float* aj,
                          const float* bias, const int* snd, const int* rcv,
                          const float* w, float* out, void* x, float* alpha,
                          float* aself, float* dlr, float* dls, void* r16,
                          float* work, int N, int E, int Din, int H, int D,
                          int K, int block_nodes, int block_edges,
                          float slope, void* stream);
int pgt_gat_conv_bwd_bf16(const float* g, const float* h, const float* Wl,
                          ll wls0, ll wls1, const void* x, const float* ein,
                          const float* We, const float* es, const float* ai,
                          const float* aj, const int* snd, const int* rcv,
                          const float* w, const float* alpha,
                          const float* aself, const float* dlr,
                          const float* dls, const void* r16, float* dh,
                          float* dWl, float* dbl, float* dWe, float* dpar,
                          float* dbias, float* work, int N, int E, int Din,
                          int H, int D, int K, int block_nodes,
                          int block_edges, float slope, void* stream);
}  // extern "C"
