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
// 24,576 edge slots; bio N = 20,480, 61,440 slots; H = 2, D = 300, float32)
// K4 is bound by operations, the [N, 300] x [300, 600] projection and its
// two backward products on the CUDA cores (67 TFLOP/s); K5 is bound by bytes,
// mostly e [E, H, D] and, backward, de (3.35 TB/s).
//
// Design (simple and right first; wgmma/TMA and bf16 are later work):
// - A (block, head) tile of x is 150 KB and a block's messages 450 KB, so
//   nothing is staged whole. The logits need whole-row dot products, the
//   aggregation does not, so the work is cut in three: (1) scalars, one
//   warp per (node, head) or (edge, head): ps = x·a_i, pd = x·a_j and, for
//   K5, pe = e·a_j (K4 takes pe = ein·(We a_j) inside step 2); (2) one CTA
//   per (block, head) does the segment softmax on the block's scalars in
//   shared memory and writes alpha [E, H], aself [N, H] and the two
//   LeakyReLU slopes, which the backward reuses instead of recomputing the
//   softmax (0.6 MB a layer at the bio shapes); (3) one CTA per (block,
//   32-feature tile) aggregates into a shared tile, both heads in turn.
// - The TPU kernels gathered and scattered with one-hot matmuls on the MXU.
//   Here, in the aggregations, each warp owns the rows r with r % 8 == warp
//   of the shared tile and is their only writer: it reads 32 edge slots at
//   a time (one per lane, coalesced), ballots which of them touch a row it
//   owns and walks those in slot order. In the softmax a thread owns a node
//   and walks the block's slots in order. No atomics anywhere: every sum is
//   taken in a fixed order and every output is the same bits every run.
// - Padded edge slots (w == 0, global index 0) and slots with an endpoint
//   outside their block get alpha = 0 in step 2 and are skipped on that
//   everywhere else, so index 0 never reaches another block's tile; their
//   de rows are written as exact zeros. Padded node rows and all-padding
//   blocks are computed like any other: their only logit is the self loop,
//   so aself = 1 and out = x + e_self.
// - The TPU carried dWe, de_self, da_i, da_j across a sequential grid in
//   VMEM. Here each block writes its partial and a second pass sums the
//   partials in block order. K4's three products and its two column sums
//   go through gemm.cuh (shared with gin_conv.cu).

#include <cuda_runtime.h>

#include "gemm.cuh"

namespace {

constexpr int FT = 32;                   // feature tile: one warp wide
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / FT;
constexpr int MAX_K = 16;                // edge input width (K4)
constexpr int RED_ROWS = 3 + MAX_K;      // de_self, da_i, da_j, dWe[k]
constexpr int MAX_SMEM = 232448;         // 227 KB: a block's most on the H100
constexpr int DEFAULT_SMEM = 48 * 1024;  // above this only after opting in
constexpr unsigned FULL = 0xffffffffu;

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
  for (int o = FT / 2; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

// e[e, h, f]: stored (K5) or ein[e] @ We[:, h*D + f] (K4)
template <bool FUSED>
__device__ __forceinline__ float edge_feat(const Graph& a, ll e, int h, int f) {
  const ll HD = (ll)a.H * a.D;
  if (!FUSED) return a.e[e * HD + (ll)h * a.D + f];
  const float* ee = a.ein + e * a.K;
  const float* W = a.We + (ll)h * a.D + f;
  float s = 0.f;
  for (int k = 0; k < a.K; ++k) s = fmaf(ee[k], W[k * HD], s);
  return s;
}

// Step 1. One warp per item: items [0, N*H) are (node, head) and give ps,
// pd [N, H]; for K5 items [N*H, N*H + E*H) are (edge, head) and give pe.
template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
gat_scalars_kernel(const Graph a, float* __restrict__ ps,
                   float* __restrict__ pd, float* __restrict__ pe) {
  const int lane = threadIdx.x % FT;
  const ll item = (ll)blockIdx.x * WARPS + threadIdx.x / FT;
  const ll NH = (ll)a.N * a.H;
  const ll total = NH + (FUSED ? 0 : (ll)a.E * a.H);
  if (item >= total) return;  // the whole warp leaves together
  if (item < NH) {
    const int h = (int)(item % a.H);
    const float* xr = a.x + item * a.D;
    const float* ai = a.ai + (ll)h * a.D;
    const float* aj = a.aj + (ll)h * a.D;
    float s1 = 0.f, s2 = 0.f;
    for (int f = lane; f < a.D; f += FT) {
      const float xv = xr[f];
      s1 = fmaf(xv, ai[f], s1);
      s2 = fmaf(xv, aj[f], s2);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) { ps[item] = s1; pd[item] = s2; }
  } else {
    const ll q = item - NH;
    const int h = (int)(q % a.H);
    float s = 0.f;
    if (a.w[q / a.H] > 0.f) {  // warp-uniform
      const float* er = a.e + q * a.D;
      const float* aj = a.aj + (ll)h * a.D;
      for (int f = lane; f < a.D; f += FT) s = fmaf(er[f], aj[f], s);
    }
    s = warp_sum(s);
    if (lane == 0) pe[q] = s;
  }
}

int softmax_fwd_smem(int bn, int be) {
  return (4 * bn + 3 * be + MAX_K + 1) * (int)sizeof(float);
}

// Step 2. One CTA per (block, head): the masked segment softmax over the
// block's receivers with the self loop as one more logit per node. Writes
// alpha [E, H], aself [N, H], and the LeakyReLU slopes dlr [E, H] (0 on
// skipped slots) and dls [N, H].
template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
gat_softmax_fwd_kernel(const Graph a, const float* __restrict__ ps,
                       const float* __restrict__ pd,
                       const float* __restrict__ pe,
                       float* __restrict__ alpha, float* __restrict__ aself,
                       float* __restrict__ dlr, float* __restrict__ dls) {
  extern __shared__ float sm[];
  const int bn = a.bn, be = a.be, H = a.H, D = a.D;
  float* ps_s = sm;            // [bn]
  float* pd_s = ps_s + bn;     // [bn]
  float* m_s = pd_s + bn;      // [bn]
  float* den_s = m_s + bn;     // [bn] sl first, then den
  float* lg = den_s + bn;      // [be] logit, then p
  float* wv = lg + be;         // [be]
  int* rl = (int*)(wv + be);   // [be] local receiver, -1 = skipped
  float* va = (float*)(rl + be);  // [MAX_K] We_h a_j; [MAX_K] = e_self·a_j
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % FT, warp = tid / FT;
  const ll base = (ll)b * bn, e0 = (ll)b * be, HD = (ll)H * D;
  const float* aj = a.aj + (ll)h * D;

  for (int k = warp; k <= MAX_K; k += WARPS) {  // warp-uniform
    const bool self = (k == MAX_K);
    if (!self && (!FUSED || k >= a.K)) continue;
    const float* v = self ? a.es + (ll)h * D : a.We + k * HD + (ll)h * D;
    float s = 0.f;
    for (int f = lane; f < D; f += FT) s = fmaf(v[f], aj[f], s);
    s = warp_sum(s);
    if (lane == 0) va[k] = s;
  }
  for (int r = tid; r < bn; r += THREADS) {
    ps_s[r] = ps[(base + r) * H + h];
    pd_s[r] = pd[(base + r) * H + h];
  }
  __syncthreads();

  for (int e = tid; e < be; e += THREADS) {
    const ll ge = e0 + e;
    const float we = a.w[ge];
    int r = -1;
    float l = 0.f, d = 0.f;
    if (we > 0.f) {
      const ll s = a.snd[ge] - base, rr = a.rcv[ge] - base;
      if (s >= 0 && s < bn && rr >= 0 && rr < bn) {
        float t;
        if (FUSED) {
          t = 0.f;
          const float* ee = a.ein + ge * a.K;
          for (int k = 0; k < a.K; ++k) t = fmaf(ee[k], va[k], t);
        } else {
          t = pe[ge * H + h];
        }
        const float raw = ps_s[rr] + pd_s[s] + t;
        d = raw >= 0.f ? 1.f : a.slope;
        l = raw * d;
        r = (int)rr;
      }
    }
    rl[e] = r;
    lg[e] = l;
    wv[e] = we;
    dlr[ge * H + h] = d;
  }
  __syncthreads();

  for (int r = tid; r < bn; r += THREADS) {
    const float sraw = ps_s[r] + pd_s[r] + va[MAX_K];
    const float ds = sraw >= 0.f ? 1.f : a.slope;
    const float sl = sraw * ds;
    float m = sl;
    for (int e = 0; e < be; ++e)
      if (rl[e] == r) m = fmaxf(m, lg[e]);
    m_s[r] = m;
    den_s[r] = sl;
    dls[(base + r) * H + h] = ds;
  }
  __syncthreads();

  for (int e = tid; e < be; e += THREADS) {
    const int r = rl[e];
    lg[e] = r >= 0 ? expf(lg[e] - m_s[r]) * wv[e] : 0.f;
  }
  __syncthreads();

  for (int r = tid; r < bn; r += THREADS) {
    const float p_self = expf(den_s[r] - m_s[r]);
    float den = 0.f;
    for (int e = 0; e < be; ++e)
      if (rl[e] == r) den += lg[e];
    den += p_self;
    den_s[r] = den;
    aself[(base + r) * H + h] = p_self / den;
  }
  __syncthreads();

  for (int e = tid; e < be; e += THREADS) {
    const int r = rl[e];
    alpha[(e0 + e) * H + h] =
        r >= 0 ? lg[e] / fmaxf(den_s[r], 1e-30f) : 0.f;
  }
}

int aggr_fwd_smem(int bn) {
  return (bn * FT + MAX_K * FT) * (int)sizeof(float);
}

// Step 3. One CTA per (block, 32-feature tile), the heads in turn. K5
// writes out [N, H*D]; K4 sums the heads in the tile and writes
// out [N, D] = sum / H + bias.
template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
gat_aggr_fwd_kernel(const Graph a, const float* __restrict__ alpha,
                    const float* __restrict__ aself,
                    const float* __restrict__ bias, float* __restrict__ out) {
  extern __shared__ float sm[];
  const int bn = a.bn, be = a.be, H = a.H, D = a.D;
  float* acc = sm;              // [bn][FT]
  float* We_s = acc + bn * FT;  // [MAX_K][FT]
  const int b = blockIdx.x, f0 = blockIdx.y * FT;
  const int tid = threadIdx.x, lane = tid % FT, warp = tid / FT;
  const int f = f0 + lane;
  const bool fok = f < D;
  const ll base = (ll)b * bn, e0 = (ll)b * be, HD = (ll)H * D;

  for (int h = 0; h < H; ++h) {
    if (FUSED) {
      if (h > 0) __syncthreads();  // the last head's We_s is done with
      for (int i = tid; i < a.K * FT; i += THREADS) {
        const int k = i / FT, l = i % FT;
        We_s[i] = (f0 + l < D) ? a.We[k * HD + (ll)h * D + f0 + l] : 0.f;
      }
      __syncthreads();
    }
    if (!FUSED || h == 0)
      for (int r = warp; r < bn; r += WARPS) acc[r * FT + lane] = 0.f;
    const ll hf = (ll)h * D + f;
    for (int q0 = 0; q0 < be; q0 += FT) {
      // one slot per lane; lr = -1 marks a slot to skip
      const int q = q0 + lane;
      int ls = -1, lr = -1;
      float al = 0.f;
      if (q < be) {
        al = alpha[(e0 + q) * H + h];
        if (al != 0.f) {
          const ll s = a.snd[e0 + q] - base, r = a.rcv[e0 + q] - base;
          if (s >= 0 && s < bn && r >= 0 && r < bn) { ls = (int)s; lr = (int)r; }
        }
      }
      // this warp adds into the rows it owns, and no other warp does
      unsigned m = __ballot_sync(FULL, lr >= 0 && lr % WARPS == warp);
      while (m) {  // the same in every lane: the loop is uniform
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const int rs = __shfl_sync(FULL, ls, src);
        const int rr = __shfl_sync(FULL, lr, src);
        const float av = __shfl_sync(FULL, al, src);
        if (!fok) continue;
        const ll ge = e0 + q0 + src;
        float msg = a.x[(base + rs) * HD + hf];
        if (FUSED) {
          const float* ee = a.ein + ge * a.K;
          for (int k = 0; k < a.K; ++k)
            msg = fmaf(ee[k], We_s[k * FT + lane], msg);
        } else {
          msg += a.e[ge * HD + hf];
        }
        acc[rr * FT + lane] = fmaf(av, msg, acc[rr * FT + lane]);
      }
    }
    if (!fok) continue;
    const float esf = a.es[hf];
    for (int r = warp; r < bn; r += WARPS) {
      const ll n = base + r;
      const float v = fmaf(aself[n * H + h], a.x[n * HD + hf] + esf,
                           acc[r * FT + lane]);
      if (!FUSED) out[n * HD + hf] = v;
      else if (h == H - 1) out[n * D + f] = v / (float)H + bias[f];
      else acc[r * FT + lane] = v;
    }
  }
}

// Backward step 1. One warp per item: (node, head) gives daself [N, H],
// (edge, head) gives dalpha [E, H] (0 where alpha is 0).
template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
gat_bwd_dots_kernel(const Graph a, const Cot c,
                    const float* __restrict__ alpha,
                    float* __restrict__ das, float* __restrict__ dal) {
  const int lane = threadIdx.x % FT;
  const ll item = (ll)blockIdx.x * WARPS + threadIdx.x / FT;
  const ll NH = (ll)a.N * a.H;
  if (item >= NH + (ll)a.E * a.H) return;  // the whole warp leaves together
  float s = 0.f;
  if (item < NH) {
    const ll n = item / a.H;
    const int h = (int)(item % a.H);
    const float* gr = c.g + n * c.rs + h * c.hs;
    const float* xr = a.x + item * a.D;
    const float* es = a.es + (ll)h * a.D;
    for (int f = lane; f < a.D; f += FT) s = fmaf(gr[f], xr[f] + es[f], s);
    s = warp_sum(s);
    if (lane == 0) das[item] = s * c.scale;
  } else {
    const ll q = item - NH, e = q / a.H;
    const int h = (int)(q % a.H);
    if (alpha[q] != 0.f) {  // warp-uniform; implies endpoints in the block
      const float* gr = c.g + (ll)a.rcv[e] * c.rs + h * c.hs;
      const float* xr = a.x + ((ll)a.snd[e] * a.H + h) * a.D;
      for (int f = lane; f < a.D; f += FT)
        s = fmaf(gr[f], xr[f] + edge_feat<FUSED>(a, e, h, f), s);
    }
    s = warp_sum(s);
    if (lane == 0) dal[q] = s * c.scale;
  }
}

int softmax_bwd_smem(int bn, int be) {
  return (2 * bn + 4 * be) * (int)sizeof(float);
}

// Backward step 2. One CTA per (block, head): the softmax Jacobian on the
// block's scalars. Writes dz [E, H], dzs, u, v [N, H].
__global__ void __launch_bounds__(THREADS)
gat_softmax_bwd_kernel(const Graph a, const float* __restrict__ alpha,
                       const float* __restrict__ aself,
                       const float* __restrict__ dlr,
                       const float* __restrict__ dls,
                       const float* __restrict__ dal,
                       const float* __restrict__ das, float* __restrict__ dz,
                       float* __restrict__ dzs, float* __restrict__ u,
                       float* __restrict__ v) {
  extern __shared__ float sm[];
  const int bn = a.bn, be = a.be, H = a.H;
  float* c_s = sm;               // [bn]
  float* dzs_s = c_s + bn;       // [bn]
  float* al = dzs_s + bn;        // [be]
  float* dz_s = al + be;         // [be] dalpha, then dz
  int* rl = (int*)(dz_s + be);   // [be] local receiver, -1 = skipped
  int* sl = rl + be;             // [be] local sender
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const ll base = (ll)b * bn, e0 = (ll)b * be;

  for (int e = tid; e < be; e += THREADS) {
    const ll ge = e0 + e;
    float av = alpha[ge * H + h];
    int r = -1, s = -1;
    if (av != 0.f) {
      const ll ss = a.snd[ge] - base, rr = a.rcv[ge] - base;
      if (ss >= 0 && ss < bn && rr >= 0 && rr < bn) { s = (int)ss; r = (int)rr; }
      else av = 0.f;
    }
    rl[e] = r;
    sl[e] = s;
    al[e] = av;
    dz_s[e] = dal[ge * H + h];
  }
  __syncthreads();

  for (int r = tid; r < bn; r += THREADS) {
    const ll i = (base + r) * H + h;
    const float as = aself[i], d = das[i];
    float c = 0.f;
    for (int e = 0; e < be; ++e)
      if (rl[e] == r) c = fmaf(al[e], dz_s[e], c);
    c = fmaf(as, d, c);
    c_s[r] = c;
    const float z = as * (d - c) * dls[i];
    dzs_s[r] = z;
    dzs[i] = z;
  }
  __syncthreads();

  for (int e = tid; e < be; e += THREADS) {
    const int r = rl[e];
    const ll ge = e0 + e;
    const float z =
        r >= 0 ? al[e] * (dz_s[e] - c_s[r]) * dlr[ge * H + h] : 0.f;
    dz_s[e] = z;  // read above by this thread only
    dz[ge * H + h] = z;
  }
  __syncthreads();

  for (int r = tid; r < bn; r += THREADS) {
    float zr = 0.f, zs = 0.f;
    for (int e = 0; e < be; ++e) {
      if (rl[e] == r) zr += dz_s[e];
      if (sl[e] == r) zs += dz_s[e];
    }
    const ll i = (base + r) * H + h;
    u[i] = zr + dzs_s[r];
    v[i] = zs + dzs_s[r];
  }
}

int aggr_bwd_smem(int bn) {
  return (bn * FT + MAX_K * FT + WARPS * RED_ROWS * FT) * (int)sizeof(float);
}

// Backward step 3. One CTA per (block, 32-feature tile), the heads in turn:
// dx [N, H*D]; K5 also de [E, H*D], K4 the block's partial of dWe
// [n_blocks, K, H*D]; and the block's partials of de_self, da_i, da_j
// [n_blocks, 3, H*D].
template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
gat_aggr_bwd_kernel(const Graph a, const Cot c,
                    const float* __restrict__ alpha,
                    const float* __restrict__ aself,
                    const float* __restrict__ dz,
                    const float* __restrict__ dzs,
                    const float* __restrict__ u, const float* __restrict__ v,
                    float* __restrict__ dx, float* __restrict__ de,
                    float* __restrict__ dWe_part, float* __restrict__ part) {
  extern __shared__ float sm[];
  const int bn = a.bn, be = a.be, H = a.H, D = a.D, K = a.K;
  float* acc = sm;                  // [bn][FT]
  float* We_s = acc + bn * FT;      // [MAX_K][FT]
  float* red = We_s + MAX_K * FT;   // [WARPS][RED_ROWS][FT]
  const int b = blockIdx.x, f0 = blockIdx.y * FT;
  const int tid = threadIdx.x, lane = tid % FT, warp = tid / FT;
  const int f = f0 + lane;
  const bool fok = f < D;
  const ll base = (ll)b * bn, e0 = (ll)b * be, HD = (ll)H * D;

  for (int h = 0; h < H; ++h) {
    if (h > 0) __syncthreads();  // the last head's We_s and red are done with
    if (FUSED) {
      for (int i = tid; i < K * FT; i += THREADS) {
        const int k = i / FT, l = i % FT;
        We_s[i] = (f0 + l < D) ? a.We[k * HD + (ll)h * D + f0 + l] : 0.f;
      }
      __syncthreads();
    }
    for (int r = warp; r < bn; r += WARPS) acc[r * FT + lane] = 0.f;
    const ll hf = (ll)h * D + f;
    const float* gh = c.g + h * c.hs + f;  // + row * c.rs
    const float aif = fok ? a.ai[hf] : 0.f;
    const float ajf = fok ? a.aj[hf] : 0.f;
    const float esf = fok ? a.es[hf] : 0.f;

    // the message path of dx: each warp owns the sender rows r % WARPS
    for (int q0 = 0; q0 < be; q0 += FT) {
      const int q = q0 + lane;
      int ls = -1, lr = -1;
      float al = 0.f;
      if (q < be) {
        al = alpha[(e0 + q) * H + h];
        if (al != 0.f) {
          const ll s = a.snd[e0 + q] - base, r = a.rcv[e0 + q] - base;
          if (s >= 0 && s < bn && r >= 0 && r < bn) { ls = (int)s; lr = (int)r; }
        }
      }
      unsigned m = __ballot_sync(FULL, ls >= 0 && ls % WARPS == warp);
      while (m) {  // the same in every lane: the loop is uniform
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const int rs = __shfl_sync(FULL, ls, src);
        const int rr = __shfl_sync(FULL, lr, src);
        const float av = __shfl_sync(FULL, al, src);
        if (!fok) continue;
        acc[rs * FT + lane] = fmaf(av, c.scale * gh[(base + rr) * c.rs],
                                   acc[rs * FT + lane]);
      }
    }

    // the node terms of dx, and this warp's share of the parameter sums
    float des = 0.f, dai = 0.f, daj = 0.f, sdzs = 0.f;
    for (int r = warp; r < bn; r += WARPS) {
      const ll n = base + r, i = n * H + h;
      const float as = aself[i], uu = u[i], vv = v[i];
      sdzs += dzs[i];
      if (!fok) continue;
      const float gv = c.scale * gh[n * c.rs];
      const float xv = a.x[n * HD + hf];
      dx[n * HD + hf] = fmaf(vv, ajf, fmaf(uu, aif, fmaf(as, gv,
                                                         acc[r * FT + lane])));
      des = fmaf(as, gv, des);
      dai = fmaf(xv, uu, dai);
      daj = fmaf(xv, vv, daj);
    }
    des = fmaf(sdzs, ajf, des);
    daj = fmaf(sdzs, esf, daj);

    // the edge gradients: warp w takes the slots e % WARPS == w in order
    float dwe[MAX_K];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) dwe[k] = 0.f;
    for (int e = warp; e < be; e += WARPS) {
      const ll ge = e0 + e;
      const float av = alpha[ge * H + h];
      if (av == 0.f) {  // skipped slot: its de row is exactly 0
        if (!FUSED && fok) de[ge * HD + hf] = 0.f;
        continue;
      }
      if (!fok) continue;
      const float zv = dz[ge * H + h];
      const float gv = c.scale * gh[(ll)a.rcv[ge] * c.rs];
      const float def = fmaf(av, gv, zv * ajf);
      if (FUSED) {
        const float* ee = a.ein + ge * K;
        float ef = 0.f;
#pragma unroll
        for (int k = 0; k < MAX_K; ++k)
          if (k < K) {
            ef = fmaf(ee[k], We_s[k * FT + lane], ef);
            dwe[k] = fmaf(ee[k], def, dwe[k]);
          }
        daj = fmaf(ef, zv, daj);
      } else {
        de[ge * HD + hf] = def;
        daj = fmaf(a.e[ge * HD + hf], zv, daj);
      }
    }

    // the warps' shares summed in warp order
    float* mine = red + warp * RED_ROWS * FT + lane;
    mine[0 * FT] = des;
    mine[1 * FT] = dai;
    mine[2 * FT] = daj;
    if (FUSED) {
#pragma unroll
      for (int k = 0; k < MAX_K; ++k)
        if (k < K) mine[(3 + k) * FT] = dwe[k];
    }
    __syncthreads();
    const int rows = 3 + (FUSED ? K : 0);
    for (int i = tid; i < rows * FT; i += THREADS) {
      const int j = i / FT, l = i % FT;
      if (f0 + l >= D) continue;
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += red[(w * RED_ROWS + j) * FT + l];
      const ll col = (ll)h * D + f0 + l;
      if (j < 3) part[((ll)b * 3 + j) * HD + col] = s;
      else dWe_part[((ll)b * K + (j - 3)) * HD + col] = s;
    }
  }
}

template <typename Kern>
int allow_smem(Kern kern, int bytes) {
  if (bytes <= DEFAULT_SMEM) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int max_smem(int bn, int be) {
  int s = softmax_fwd_smem(bn, be);
  if (softmax_bwd_smem(bn, be) > s) s = softmax_bwd_smem(bn, be);
  if (aggr_bwd_smem(bn) > s) s = aggr_bwd_smem(bn);  // >= aggr_fwd_smem
  return s;
}

bool bad_shape(const Graph& a, bool fused) {
  return a.N <= 0 || a.H <= 0 || a.D <= 0 || a.bn <= 0 || a.be <= 0 ||
         a.N % a.bn != 0 || (ll)a.E != (ll)(a.N / a.bn) * a.be ||
         (fused && (a.K <= 0 || a.K > MAX_K)) ||
         max_smem(a.bn, a.be) > MAX_SMEM;
}

int warp_blocks(ll items) { return (int)((items + WARPS - 1) / WARPS); }

// Steps 1-3 of the forward on a.x; ps, pd are [N, H] and pe [E, H] scratch.
template <bool FUSED>
int attention_fwd(const Graph& a, const float* bias, float* ps, float* pd,
                  float* pe, float* alpha, float* aself, float* dlr,
                  float* dls, float* out, cudaStream_t st) {
  const int nb = a.N / a.bn;
  const ll items = (ll)a.N * a.H + (FUSED ? 0 : (ll)a.E * a.H);
  gat_scalars_kernel<FUSED><<<warp_blocks(items), THREADS, 0, st>>>(a, ps, pd, pe);
  int err = (int)cudaGetLastError();
  if (err) return err;
  int smem = softmax_fwd_smem(a.bn, a.be);
  err = allow_smem(gat_softmax_fwd_kernel<FUSED>, smem);
  if (err) return err;
  gat_softmax_fwd_kernel<FUSED><<<dim3(nb, a.H), THREADS, smem, st>>>(
      a, ps, pd, pe, alpha, aself, dlr, dls);
  err = (int)cudaGetLastError();
  if (err) return err;
  smem = aggr_fwd_smem(a.bn);
  err = allow_smem(gat_aggr_fwd_kernel<FUSED>, smem);
  if (err) return err;
  gat_aggr_fwd_kernel<FUSED><<<dim3(nb, (a.D + FT - 1) / FT), THREADS, smem, st>>>(
      a, alpha, aself, bias, out);
  return (int)cudaGetLastError();
}

struct AttnWork {  // scratch of attention_bwd
  float* das;   // [N, H]
  float* dal;   // [E, H]
  float* dz;    // [E, H]
  float* dzs;   // [N, H]
  float* u;     // [N, H]
  float* v;     // [N, H]
  float* part;  // [n_blocks, 3, H*D]
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

AttnWork carve_attn(Carver& cv, const Graph& a) {
  AttnWork w;
  const ll NH = (ll)a.N * a.H, EH = (ll)a.E * a.H;
  w.das = cv.take(NH);
  w.dal = cv.take(EH);
  w.dz = cv.take(EH);
  w.dzs = cv.take(NH);
  w.u = cv.take(NH);
  w.v = cv.take(NH);
  w.part = cv.take((ll)(a.N / a.bn) * 3 * a.H * a.D);
  return w;
}

// Backward steps 1-3 and the ordered sum of the partials: dx, de or
// dWe_part, and dpar [3, H*D] = de_self, da_i, da_j.
template <bool FUSED>
int attention_bwd(const Graph& a, const Cot& c, const float* alpha,
                  const float* aself, const float* dlr, const float* dls,
                  const AttnWork& w, float* dx, float* de, float* dWe_part,
                  float* dpar, cudaStream_t st) {
  const int nb = a.N / a.bn;
  const ll HD = (ll)a.H * a.D;
  const ll items = (ll)a.N * a.H + (ll)a.E * a.H;
  gat_bwd_dots_kernel<FUSED><<<warp_blocks(items), THREADS, 0, st>>>(
      a, c, alpha, w.das, w.dal);
  int err = (int)cudaGetLastError();
  if (err) return err;
  int smem = softmax_bwd_smem(a.bn, a.be);
  err = allow_smem(gat_softmax_bwd_kernel, smem);
  if (err) return err;
  gat_softmax_bwd_kernel<<<dim3(nb, a.H), THREADS, smem, st>>>(
      a, alpha, aself, dlr, dls, w.dal, w.das, w.dz, w.dzs, w.u, w.v);
  err = (int)cudaGetLastError();
  if (err) return err;
  smem = aggr_bwd_smem(a.bn);
  err = allow_smem(gat_aggr_bwd_kernel<FUSED>, smem);
  if (err) return err;
  gat_aggr_bwd_kernel<FUSED><<<dim3(nb, (a.D + FT - 1) / FT), THREADS, smem, st>>>(
      a, c, alpha, aself, w.dz, w.dzs, w.u, w.v, dx, de, dWe_part, w.part);
  err = (int)cudaGetLastError();
  if (err) return err;
  return sum_partials(w.part, nb, 3 * HD, (int)HD, dpar, nullptr, nullptr, 0, st);
}

struct ConvBwdWork {
  float* dx;        // [N, H*D]
  AttnWork attn;
  float* gpart;     // split-K partials of dWl
  float* cpart;     // column-sum partials of dbias / dbl
  float* dWe_part;  // [n_blocks, K, H*D]
  ll total;
};

ConvBwdWork carve_conv_bwd(float* base, const Graph& a, int Din) {
  Carver cv{base};
  ConvBwdWork w;
  const ll HD = (ll)a.H * a.D;
  w.dx = cv.take((ll)a.N * HD);
  w.attn = carve_attn(cv, a);
  w.gpart = cv.take((ll)wgrad_splits(Din, (int)HD, a.N) * Din * HD);
  w.cpart = cv.take((ll)((a.N + COLSUM_ROWS - 1) / COLSUM_ROWS) * HD);
  w.dWe_part = cv.take((ll)(a.N / a.bn) * a.K * HD);
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
  Carver cv{nullptr};
  cv.take((ll)N * H); cv.take((ll)N * H); cv.take((ll)E * H);
  return cv.off;
}
long long pgt_gat_conv_fwd_workspace(int N, int H) {
  Carver cv{nullptr};
  cv.take((ll)N * H); cv.take((ll)N * H);
  return cv.off;
}
long long pgt_gat_attn_bwd_workspace(int N, int E, int H, int D,
                                     int block_nodes) {
  Graph a{};
  a.N = N; a.E = E; a.H = H; a.D = D; a.bn = block_nodes;
  Carver cv{nullptr};
  carve_attn(cv, a);
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
  const Graph a{x, e, nullptr, nullptr, es, ai, aj, snd, rcv, w,
                N, E, H, D, 0, block_nodes, block_edges, slope};
  if (bad_shape(a, false)) return (int)cudaErrorInvalidValue;
  Carver cv{work};
  float* ps = cv.take((ll)N * H);
  float* pd = cv.take((ll)N * H);
  float* pe = cv.take((ll)E * H);
  return attention_fwd<false>(a, nullptr, ps, pd, pe, alpha, aself, dlr, dls,
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
  const AttnWork wk = carve_attn(cv, a);
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
  int err = gemm(h, Din, 1, Wl, wls0, wls1, x, N, H * D, Din, 1, nullptr, bl,
                 nullptr, 0, st);
  if (err) return err;
  Carver cv{work};
  float* ps = cv.take((ll)N * H);
  float* pd = cv.take((ll)N * H);
  return attention_fwd<true>(a, bias, ps, pd, nullptr, alpha, aself, dlr, dls,
                             out, st);
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
  const int HD = H * D, nb = N / block_nodes;
  const ConvBwdWork wk = carve_conv_bwd(work, a, Din);
  // dbias sums g over all rows, before the head mean's 1/H
  int err = colsum(g, N, D, wk.cpart, dbias, st);
  if (err) return err;
  const Cot c{g, (ll)D, 0, 1.f / (float)H};
  err = attention_bwd<true>(a, c, alpha, aself, dlr, dls, wk.attn, wk.dx,
                            nullptr, wk.dWe_part, dpar, st);
  if (err) return err;
  err = sum_partials(wk.dWe_part, nb, (ll)K * HD, HD, dWe, nullptr, nullptr, 0, st);
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
