// The bfloat16 variants (compute_dtype = bfloat16) of K4, the fused GAT
// conv, and K5, the blocked GAT attention: the entry points that gat.cu's
// C interface calls under bf16_compute. What they compute (the Pallas
// bodies' function at bfloat16, rounding where the bodies round) and how:
// the notes at the top of gat.cu; the walks and helpers: gat_walks.cuh.
// A source of its own so that its walk instantiations compile beside
// gat.cu's float32 ones (ops/_build.py builds the two in parallel and
// links them into one library).

#include "gat_walks.cuh"

namespace {

// ---- K4 at bfloat16 ---------------------------------------------------------
//
// What bounds it: bytes (0.009 ms at the chem GAT first batch, PERF.md §6),
// but in practice the walks' per-row latency and the x product; the design
// computes everything the backward needs once, in the forward, and keeps
// each walk's per-slot work to loads and FMAs.
// - Forward: one kernel (gat_proj16_kernel) forms the logit scalars of
//   both the float32 x and the residual xb = bf(x) (x·a_i, x·a_j, (x +
//   e_self)·a_j a row and head, each gat_proj_kernel's sum) and the edge
//   vector (gat_edge_vec_kernel's), then the walk (gat_conv_fwd16_kernel)
//   computes both softmaxes: the float32 x's for the messages, the
//   residual's for the backward (alpha, aself, dlr, dls, saved with the
//   rounded h and Wl: the Pallas backward recomputes this softmax from the
//   residual). Its slots' logits are formed lane-parallel, a lane a slot:
//   the edge term ein_e · (bf(We_h) a_j) as the tree of gat_fwd_kernel's
//   warp sum (lanes k < K), the max by a warp max; the denominators in slot
//   order; the messages' weights a lane a slot. So the first pass is one
//   trip for up to 32 slots, and every scalar has gat_fwd_kernel's bits.
//   The messages are the Pallas body's, four slots' rows in flight; a
//   slot's edge term runs over the k whose bf(ein_ek) is not 0 only (a
//   ballot: fmaf(0, w, e) is e, so the bits do not change), no shuffle or
//   branch for the others (the bond one-hots have two of nine set).
// - Backward: no recomputation: the walks read the saved softmax, the
//   products the saved rounded h and Wl. dWe (gat_dwe16_kernel) sums its
//   products over chunks of 128 slots on the tensor cores, de formed in the
//   mma's operand registers (a thread a column would issue a load, a
//   rounding and 2K FMAs a slot and column). The column sums take 16 rows'
//   loads in flight (gemm.cuh).
// - Not taken: four rows a warp (half the CTAs, so half the staging)
//   spilled at 128 registers and ran slower on the H100 (chem 0.150 ms
//   against 0.141); three CTAs an SM spilled at 80 registers.

constexpr int FWD16_MIN_CTAS = 2;  // walk CTAs an SM: at most 128 registers
constexpr int PROJ16_U = 4;         // row chunks in flight in gat_proj16
// x's bfloat16 copy: its roundings decided as the k-ordered float32 chain's
// (gemm.cuh's ordered-tie fixup). The copy is the backward's residual: a
// flipped rounding there moves a logit and, through dx, whole rows of dWl
// and dh (PERF.md §6, K4 bf16).
constexpr bool X16_EXACT = true;

// The rounded operands K4's bfloat16 forward saves for the backward.
struct Rounded {
  bf16* h;   // [N, pad8(Din)]
  bf16* Wl;  // [Din, HD] in Wl's orientation, see round_weight
};

Rounded carve_rounded(bf16* base, int N, int Din) {
  return {base, base + (ll)N * pad8(Din)};
}

ll rounded_elems(int N, int Din, ll HD) {
  return (ll)N * pad8(Din) + pad8(Din) * pad8(HD);
}

// round_weight's strides of the rounded Wl.
void wl16_strides(ll s0, ll s1, int Din, ll HD, ll* t0, ll* t1) {
  const bool col = s0 == 1 && s1 != 1;
  *t0 = col ? 1 : pad8(HD);
  *t1 = col ? pad8(Din) : 1;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// ein_e · va_h (K <= MAX_K terms, ein rounded) summed in one thread as
// warp_sum sums the products held by lanes k < K (the others 0) on lane 0:
// the butterfly's tree, each product rounded first.
__device__ __forceinline__ float edge_logit(const float* __restrict__ ein,
                                            const float* va, int K) {
  float v[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k)
    v[k] = k < K ? __fmul_rn(rnd(ein[k]), va[k]) : 0.f;
  float b[8], c[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = v[i] + v[i + 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = b[i] + b[i + 4];
  return (c[0] + c[2]) + (c[1] + c[3]);
}

// proj [N, H, 3] of the float32 x (a.x) and projb of the residual:
// gat_proj_kernel's three sums for both, one warp a row and head; the first
// H * K warps also form va [H, K] = bf(We_h) a_j, gat_edge_vec_kernel's
// sums. The residual is bf(x) entry for entry (gemm_bf16 writes both from
// one value, the tie fixup's too), so it is rounded here, not read.
__global__ void __launch_bounds__(THREADS)
gat_proj16_kernel(const Graph a, float* __restrict__ proj,
                  float* __restrict__ projb, float* __restrict__ va) {
  const int lane = threadIdx.x % 32;
  const ll i = (ll)blockIdx.x * WARPS + threadIdx.x / 32;
  if (i < a.H * a.K) {
    const int h = (int)i / a.K, k = (int)i % a.K;
    const float* W = a.We + k * (ll)a.H * a.D + (ll)h * a.D;
    const float* aj = a.aj + (ll)h * a.D;
    float t = 0.f;
    for (int f = lane; f < a.D; f += 32) t = fmaf(rnd(W[f]), aj[f], t);
    t = warp_sum(t);
    if (lane == 0) va[i] = t;
  }
  if (i >= (ll)a.N * a.H) return;  // the whole warp leaves together
  const int h = (int)(i % a.H);
  const ll hD = (ll)h * a.D, row = i / a.H * a.H * a.D + hD;
  const float* x = static_cast<const float*>(a.x) + row;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, t0 = 0.f, t1 = 0.f, t2 = 0.f;
  // each lane's features f = lane + 32 u in order, PROJ16_U at a time with
  // every load issued first
  for (int f0 = lane; f0 < a.D; f0 += 32 * PROJ16_U) {
    float v[PROJ16_U], vb[PROJ16_U], ai[PROJ16_U], aj[PROJ16_U], es[PROJ16_U];
#pragma unroll
    for (int u = 0; u < PROJ16_U; ++u) {
      const int f = f0 + 32 * u;
      const bool ok = f < a.D;
      v[u] = ok ? x[f] : 0.f;
      vb[u] = rnd(v[u]);
      ai[u] = ok ? a.ai[hD + f] : 0.f;
      aj[u] = ok ? a.aj[hD + f] : 0.f;
      es[u] = ok ? a.es[hD + f] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < PROJ16_U; ++u) {
      if (f0 + 32 * u >= a.D) break;
      s0 = fmaf(v[u], ai[u], s0);
      s1 = fmaf(v[u], aj[u], s1);
      s2 = fmaf(v[u] + es[u], aj[u], s2);
      t0 = fmaf(vb[u], ai[u], t0);
      t1 = fmaf(vb[u], aj[u], t1);
      t2 = fmaf(vb[u] + es[u], aj[u], t2);
    }
  }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  t0 = warp_sum(t0);
  t1 = warp_sum(t1);
  t2 = warp_sum(t2);
  if (lane == 0) {
    proj[i * 3] = s0;
    proj[i * 3 + 1] = s1;
    proj[i * 3 + 2] = s2;
    projb[i * 3] = t0;
    projb[i * 3 + 1] = t1;
    projb[i * 3 + 2] = t2;
  }
}

// Shared memory of the forward walk: Walk's slots and lists, each warp's
// two logit rows (x's, then its messages' weights in place; the
// residual's), every head's rounded We chunk and the edge vector.
struct Fwd16 {
  Walk s;       // w, ls, lr, list, buf ([WARPS][be]: x's logits)
  float* lgb;   // [WARPS][be]
  float* va;    // [H][K]
};

__host__ __device__ int fwd16_floats(int be, int H, int K) {
  return be + 2 * WARPS * be + H * K * CH + H * MAX_K;
}

int fwd16_smem(int be, int H, int K) {
  return fwd16_floats(be, H, K) * 4 + 2 * be * 4 + WARPS * RPW * be * 2;
}

__device__ __forceinline__ Fwd16 carve16(float* smem, int be, int H, int K) {
  Fwd16 f{};
  f.s.w = smem;
  f.s.buf = smem + be;                      // [WARPS][be]: x's logits
  f.lgb = f.s.buf + WARPS * be;             // [WARPS][be]
  f.s.We = f.lgb + WARPS * be;              // [H][K][NV][32]
  f.va = f.s.We + H * K * CH;               // [H][K]
  f.s.ls = (int*)(smem + fwd16_floats(be, H, K));
  f.s.lr = f.s.ls + be;
  f.s.list = (unsigned short*)(f.s.lr + be);
  return f;
}

// K4's bfloat16 forward walk: out [N, D], and from the first chunk's CTAs
// the residual's alpha, dlr [E, H], aself, dls [N, H]. a.x is the float32
// x, a.xm the residual, a.proj and projb their logit scalars, va the edge
// vector (gat_proj16_kernel's).
template <int VEC>
__global__ void __launch_bounds__(THREADS, FWD16_MIN_CTAS)
gat_conv_fwd16_kernel(const Graph a, const float* __restrict__ projb,
                      const float* __restrict__ va,
                      const float* __restrict__ bias, float* __restrict__ out,
                      float* __restrict__ alpha, float* __restrict__ aself,
                      float* __restrict__ dlr, float* __restrict__ dls) {
  constexpr int B2 = 4;  // message rows in flight a warp
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, D = a.D, K = a.K, be = a.be;
  const float* X = static_cast<const float*>(a.x);
  const Fwd16 f = carve16(smem, be, H, K);
  const Walk& s = f.s;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.z * CH;
  const bool first = blockIdx.z == 0;  // writes the softmax scalars
  const ll base = (ll)blockIdx.x * a.bn, e0 = (ll)blockIdx.x * be;
  const ll HD = (ll)H * D;
  // every head's rounded We chunk as the lanes hold it
  stage_we<VEC, true>(s.We, a, 0, H, c0);
  for (int t = threadIdx.x; t < H * K; t += THREADS) f.va[t] = va[t];
  stage(s, a, e0, base);  // its barrier covers the two above
  if (first && blockIdx.y == 0)  // skipped slots: alpha = dlr = 0
    for (int i = threadIdx.x; i < be * H; i += THREADS)
      if (s.ls[i / H] < 0) {
        alpha[e0 * H + i] = 0.f;
        dlr[e0 * H + i] = 0.f;
      }
  const int r0 = blockIdx.y * RPC + warp * RPW;
  int cnt[RPW];
  list_rows<false>(s, be, r0, lane, warp, cnt);
  // x's logits in list order, then in place the messages' weights
  float* lg = s.buf + warp * be;
  float* lgb = f.lgb + warp * be;  // the residual's logits

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = r0 + j;
    if (r >= a.bn) break;  // warp-uniform
    const ll n = base + r;
    const unsigned short* L = s.list + (warp * RPW + j) * be;
    const int nq = cnt[j];
    Chunk o = zero();  // the heads' sum
#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      const ll hD = (ll)h * D;
      const float* pr = a.proj + (n * H + h) * 3;
      const float* prb = projb + (n * H + h) * 3;
      const float ps = pr[0], psb = prb[0];
      const float sraw = ps + pr[2], srawb = psb + prb[2];
      const float ds = sraw >= 0.f ? 1.f : a.slope;
      const float dsb = srawb >= 0.f ? 1.f : a.slope;
      const float sl = sraw * ds, slb = srawb * dsb;
      // the slots' logits, a lane a slot; the max over them and the self
      // loop's (gat_fwd_kernel's online max)
      float m = sl, mb = slb;
      const float* vah = f.va + h * K;
      for (int i = lane; i < nq; i += 32) {
        const int q = L[i];
        const ll sg = (base + s.ls[q]) * H + h;
        const float pe = edge_logit(a.ein + (e0 + q) * K, vah, K);
        const float raw = (ps + a.proj[sg * 3 + 1]) + pe;
        const float rawb = (psb + projb[sg * 3 + 1]) + pe;
        const float d = raw >= 0.f ? 1.f : a.slope;
        const float db = rawb >= 0.f ? 1.f : a.slope;
        const float l = raw * d, lb = rawb * db;
        lg[i] = l;
        lgb[i] = lb;
        m = fmaxf(m, l);
        mb = fmaxf(mb, lb);
        if (first) dlr[(e0 + q) * H + h] = db;
      }
      m = warp_max(m);
      mb = warp_max(mb);
      __syncwarp();
      // the body's denominators: p summed in slot order, then p_self
      float den = 0.f, denb = 0.f;
      for (int i = 0; i < nq; ++i) {
        den += expf(lg[i] - m) * s.w[L[i]];
        denb += expf(lgb[i] - mb) * s.w[L[i]];
      }
      den += expf(sl - m);
      denb += expf(slb - mb);
      __syncwarp();  // every lane has read lg
      // p_e = exp(l_e - m) w_e, the messages' weights, in place of the
      // logits; the residual's softmax, for the backward
      for (int i = lane; i < nq; i += 32) {
        const int q = L[i];
        lg[i] = expf(lg[i] - m) * s.w[q];
        if (first)
          alpha[(e0 + q) * H + h] = expf(lgb[i] - mb) * s.w[q] /
                                    fmaxf(denb, 1e-30f);
      }
      __syncwarp();
      if (first && lane == 0) {
        aself[n * H + h] = expf(slb - mb) / denb;
        dls[n * H + h] = dsb;
      }
      // numer = sum bf(p_e msg_e), p_e = exp(l_e - m) w_e at the row's max,
      // msg_e = xb[s] + bf(ein_e) @ bf(We_h)
      Chunk nu = zero();
      const float* W_s = s.We + h * K * CH;
      for (int i0 = 0; i0 < nq; i0 += B2) {
        Chunk msg[B2];
        float ek[B2];
        unsigned nzu[B2];
#pragma unroll
        for (int u = 0; u < B2; ++u) {
          if (i0 + u >= nq) break;
          const int q = L[i0 + u];
          msg[u] = ld<VEC>(a.xm + (base + s.ls[q]) * HD + hD, c0, D, lane);
          ek[u] = lane < K ? rnd(a.ein[(e0 + q) * K + lane]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < B2; ++u)
          if (i0 + u < nq) nzu[u] = __ballot_sync(FULL, ek[u] != 0.f);
#pragma unroll
        for (int u = 0; u < B2; ++u) {
          if (i0 + u >= nq) break;
          // the k of bf(ein_ek) != 0 in order (warp-uniform): fmaf(0, w, e)
          // is e, so the others change no bit
          Chunk e = zero();
          for (unsigned mk = nzu[u]; mk; mk &= mk - 1) {
            const int k = __ffs(mk) - 1;
            const float ekk = __shfl_sync(FULL, ek[u], k);
#pragma unroll
            for (int i = 0; i < NV; ++i)
              e.v[i] = fmaf(ekk, W_s[(k * NV + i) * 32 + lane], e.v[i]);
          }
          msg[u] = add(msg[u], e);
          add_rounded(nu, lg[i0 + u], msg[u]);
        }
      }
      __syncwarp();  // lg and lgb are rewritten by the next head
      // the self message x + e_self, unrounded
      const Chunk xe = add(ld<VEC>(X + n * HD + hD, c0, D, lane),
                           ld<VEC>(a.es + hD, c0, D, lane));
      const float p_self = expf(sl - m);
      Chunk acc;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        acc.v[i] = fmaf(p_self, xe.v[i], nu.v[i]) / den;
      o = add(o, acc);
    }
    const Chunk bs = ld<VEC>(bias, c0, D, lane);
#pragma unroll
    for (int i = 0; i < NV; ++i) o.v[i] = o.v[i] / (float)H + bs.v[i];
    st<VEC>(out + n * D, o, c0, D, lane);
  }
}

// K4's dWe under BF: dwe_part[chunk][k][c] = sum over the chunk's
// DWE16_EDGES slots e that count of bf(ein_ek) bf(de_e[c]), de_e[c] =
// alpha_eh g_r[c] + dz_eh a_j[c] with g_r = bf(g[rcv_e] / H), de rounded as
// the Pallas body's (c = h*D + f); row K: da_j's e term, sum_k (sum_e dz_eh
// bf(ein_ek)) bf(We[k, c]), its sums in slot order. The sum over
// the slots is a product of bf(ein)^T [K, slots] and bf(de) [slots, c] on
// the tensor cores (mma.sync m16n8k16: K padded to 16 rows, 16 slots a
// step, each step's float32 partial added to the accumulator), de formed in
// the B fragment, a lane 4 slots of 8 columns' tile; a warp 32 columns, a
// CTA 128 and one chunk of 128 slots (its slots' receiver
// rows, alpha and dz of every head and rounded ein staged in shared
// memory; a 16-slot step with no slot that counts is skipped).
constexpr int DWE16_EDGES = 128;

int dwe16_smem(int H) {
  return (DWE16_EDGES * (1 + 2 * H + MAX_K) + H * MAX_K + DWE16_EDGES / 16) *
         4;
}
int dwe16_chunks(int E) { return (E + DWE16_EDGES - 1) / DWE16_EDGES; }

// Two floats that are bfloat16 values as an mma operand register, ``lo``
// in the lower half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__global__ void __launch_bounds__(DWE_THREADS)
gat_dwe16_kernel(const Graph a, const Cot c, const float* __restrict__ alpha,
                 const float* __restrict__ dz, float* __restrict__ dwe_part) {
  extern __shared__ __align__(16) float sm[];
  const int H = a.H, D = a.D, K = a.K;
  const ll HD = (ll)H * D;
  int* s_row = reinterpret_cast<int*>(sm);
  float* s_al = sm + DWE16_EDGES;
  float* s_dz = s_al + DWE16_EDGES * H;
  float* s_ek = s_dz + DWE16_EDGES * H;      // [slot][MAX_K], 0 past K
  float* s_sk = s_ek + DWE16_EDGES * MAX_K;  // [H][K]
  int* s_any = reinterpret_cast<int*>(s_sk + H * MAX_K);  // a step counts
  const ll e0 = (ll)blockIdx.y * DWE16_EDGES;
  const int n = (int)min((ll)DWE16_EDGES, (ll)a.E - e0);
  for (int t = threadIdx.x; t < DWE16_EDGES; t += DWE_THREADS) {
    int row = -1;
    if (t < n) {
      const ll e = e0 + t, base = e / a.be * a.bn, lr = a.rcv[e] - base;
      if (counts(a.w[e], a.snd[e] - base, lr, a.bn)) row = (int)(base + lr);
    }
    s_row[t] = row;
  }
  for (int t = threadIdx.x; t < n * H; t += DWE_THREADS) {
    s_al[t] = alpha[e0 * H + t];
    s_dz[t] = dz[e0 * H + t];  // read only for the slots that count
  }
  for (int t = threadIdx.x; t < DWE16_EDGES * MAX_K; t += DWE_THREADS) {
    const int i = t / MAX_K, k = t % MAX_K;
    s_ek[t] = i < n && k < K ? rnd(a.ein[(e0 + i) * K + k]) : 0.f;
  }
  __syncthreads();
  // da_j's e term: sk[h][k] = sum_e dz_eh bf(ein_ek), in slot order
  for (int t = threadIdx.x; t < H * K; t += DWE_THREADS) {
    const int h = t / K, k = t % K;
    float v = 0.f;
    for (int i = 0; i < n; ++i)
      if (s_row[i] >= 0) v = fmaf(s_dz[i * H + h], s_ek[i * MAX_K + k], v);
    s_sk[t] = v;
  }
  if (threadIdx.x < DWE16_EDGES / 16) {
    int any = 0;
    for (int i = 0; i < 16; ++i) any |= s_row[threadIdx.x * 16 + i] >= 0;
    s_any[threadIdx.x] = any;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const ll cw = (ll)blockIdx.x * DWE_THREADS + warp * 32;  // the warp's
  // this lane's B column in each of the warp's four 8-column tiles
  const float* gc[4];
  float ajc[4];
  int hc[4];
  bool okc[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const ll col = cw + nt * 8 + gid;
    okc[nt] = col < HD;
    hc[nt] = okc[nt] ? (int)(col / D) : 0;
    ajc[nt] = okc[nt] ? a.aj[col] : 0.f;
    gc[nt] = c.g + hc[nt] * c.hs + (okc[nt] ? (int)(col % D) : 0);
  }
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
  for (int s0 = 0; s0 < DWE16_EDGES; s0 += 16) {
    if (!s_any[s0 / 16]) continue;  // the same in every thread
    const int i0 = s0 + tig * 2;
    const int sl[4] = {i0, i0 + 1, i0 + 8, i0 + 9};
    unsigned af[4];  // A = bf(ein)^T: rows k = gid (+ 8), columns the slots
    af[0] = pack_bf16(s_ek[i0 * MAX_K + gid], s_ek[(i0 + 1) * MAX_K + gid]);
    af[1] = pack_bf16(s_ek[i0 * MAX_K + gid + 8],
                      s_ek[(i0 + 1) * MAX_K + gid + 8]);
    af[2] = pack_bf16(s_ek[(i0 + 8) * MAX_K + gid],
                      s_ek[(i0 + 9) * MAX_K + gid]);
    af[3] = pack_bf16(s_ek[(i0 + 8) * MAX_K + gid + 8],
                      s_ek[(i0 + 9) * MAX_K + gid + 8]);
    int rw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) rw[j] = s_row[sl[j]];
    float gv[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        gv[nt][j] = rw[j] >= 0 && okc[nt] ? gc[nt][(ll)rw[j] * c.rs] : 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float de[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float al = rw[j] >= 0 ? s_al[sl[j] * H + hc[nt]] : 0.f;
        const float z = rw[j] >= 0 ? s_dz[sl[j] * H + hc[nt]] : 0.f;
        de[j] = rnd(__fadd_rn(__fmul_rn(al, rnd(gv[nt][j] * c.scale)),
                              __fmul_rn(z, ajc[nt])));
      }
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(part, af, pack_bf16(de[0], de[1]), pack_bf16(de[2], de[3]));
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] += part[q];
    }
  }
  float* out = dwe_part + (ll)blockIdx.y * (K + 1) * HD;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const ll col = cw + nt * 8 + tig * 2;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = gid + (q / 2) * 8;
      const ll cc = col + q % 2;
      if (k < K && cc < HD) out[k * HD + cc] = acc[nt][q];
    }
  }
  const ll col = (ll)blockIdx.x * DWE_THREADS + threadIdx.x;
  if (col < HD) {
    const float* sk = s_sk + (int)(col / D) * K;
    float ej = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k >= K) break;
      ej = fmaf(sk[k], rnd(a.We[k * HD + col]), ej);
    }
    out[K * HD + col] = ej;
  }
}

struct Fwd16Work {
  float* x;      // the float32 x, [N, H*D]
  float* proj;   // [N, H, 3] of x
  float* projb;  // [N, H, 3] of the residual
  float* va;     // [H, MAX_K]
  ll total;
};

Fwd16Work carve_fwd16(float* base, int N, int H, int D) {
  Carver cv{base};
  Fwd16Work w{};
  w.x = cv.take((ll)N * H * D);
  w.proj = cv.take((ll)N * H * 3);
  w.projb = cv.take((ll)N * H * 3);
  w.va = cv.take((ll)H * MAX_K);
  w.total = cv.off;
  return w;
}

struct Bwd16Work {
  float* dx;        // [N, H*D]
  BwdOut o;         // dz, dzs, u and the walks' partials
  float* dwe_part;  // [dwe16_chunks(E)][K + 1][H*D]
  float* gpart;     // split-K partials of dWl
  float* cpart;     // column-sum partials of dbias / dbl
  bf16* dxb;        // dx rounded, [N, pad8(H*D)]
  ll total;
};

Bwd16Work carve_bwd16(float* base, const Graph& a, int Din) {
  Carver cv{base};
  Bwd16Work w{};
  const ll NH = (ll)a.N * a.H, HD = (ll)a.H * a.D;
  w.dx = cv.take((ll)a.N * HD);
  w.o.dz = cv.take((ll)a.E * a.H);
  w.o.dzs = cv.take(NH);
  w.o.u = cv.take(NH);
  w.o.part = cv.take((ll)walk_ctas(a) * NPART * HD);
  w.dwe_part = cv.take((ll)dwe16_chunks(a.E) * (a.K + 1) * HD);
  w.gpart = cv.take((ll)wgrad_splits(Din, (int)HD, a.N) * Din * HD);
  w.cpart = cv.take((ll)((a.N + COLSUM_ROWS - 1) / COLSUM_ROWS) * HD);
  w.dxb = cv.take16((ll)a.N * pad8(HD));
  w.total = cv.off;
  return w;
}

}  // namespace

extern "C" {

int pgt_gat_attn_fwd_bf16(const float* x, const float* e, const float* es,
                          const float* ai, const float* aj, const int* snd,
                          const int* rcv, const float* w, float* out,
                          float* alpha, float* aself, float* dlr, float* dls,
                          int N, int E, int H, int D, int block_nodes,
                          int block_edges, float slope, void* stream) {
  const Graph a{x, e, nullptr, nullptr, es, ai, aj, snd, rcv, w,
                N, E, H, D, 0, block_nodes, block_edges, slope, nullptr};
  if (bad_shape(a, false)) return (int)cudaErrorInvalidValue;
  return attention_fwd<false, true>(a, nullptr, nullptr, alpha, aself, dlr,
                                    dls, out, (cudaStream_t)stream);
}

int pgt_gat_attn_bwd_bf16(const float* g, const float* x, const float* e,
                          const float* es, const float* ai, const float* aj,
                          const int* snd, const int* rcv, const float* w,
                          const float* alpha, const float* aself,
                          const float* dlr, const float* dls, float* dx,
                          float* de, float* dpar, float* work, int N, int E,
                          int H, int D, int block_nodes, int block_edges,
                          float slope, void* stream) {
  const Graph a{x, e, nullptr, nullptr, es, ai, aj, snd, rcv, w,
                N, E, H, D, 0, block_nodes, block_edges, slope, nullptr};
  if (bad_shape(a, false)) return (int)cudaErrorInvalidValue;
  Carver cv{work};
  const AttnWork wk = carve_attn(cv, a, false);
  const Cot c{g, (ll)H * D, (ll)D, 1.f};
  return attention_bwd<false, true>(a, c, alpha, aself, dlr, dls, wk, dx, de,
                                    nullptr, dpar, (cudaStream_t)stream);
}

long long pgt_gat_conv_fwd_workspace_bf16(int N, int Din, int H, int D) {
  (void)Din;
  return carve_fwd16(nullptr, N, H, D).total;
}

long long pgt_gat_conv_bwd_workspace_bf16(int N, int E, int Din, int H,
                                          int D, int K, int block_nodes) {
  Graph a{};
  a.N = N; a.E = E; a.H = H; a.D = D; a.K = K; a.bn = block_nodes;
  return carve_bwd16(nullptr, a, Din).total;
}

long long pgt_gat_conv_r16_elems_bf16(int N, int Din, int H, int D) {
  return rounded_elems(N, Din, (ll)H * D);
}

int pgt_gat_conv_fwd_bf16(const float* h, const float* Wl, ll wls0, ll wls1,
                          const float* bl, const float* ein, const float* We,
                          const float* es, const float* ai, const float* aj,
                          const float* bias, const int* snd, const int* rcv,
                          const float* w, float* out, void* x, float* alpha,
                          float* aself, float* dlr, float* dls, void* r16,
                          float* work, int N, int E, int Din, int H, int D,
                          int K, int block_nodes, int block_edges,
                          float slope, void* stream) {
  Graph a{x, nullptr, ein, We, es, ai, aj, snd, rcv, w,
          N, E, H, D, K, block_nodes, block_edges, slope, nullptr};
  if (bad_shape(a, true) || Din <= 0) return (int)cudaErrorInvalidValue;
  const int smem = fwd16_smem(block_edges, H, K);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Fwd16Work wk = carve_fwd16(work, N, H, D);
  const Rounded r = carve_rounded(static_cast<bf16*>(r16), N, Din);
  const ll HD = (ll)H * D;
  // h and Wl rounded, saved for the backward's products
  int err = convert(h, Din, 1, N, Din, r.h, pad8(Din), 1, st);
  if (err) return err;
  ll t0, t1;
  err = round_weight(Wl, wls0, wls1, Din, (int)HD, r.Wl, &t0, &t1, st);
  if (err) return err;
  // x = bf(h) @ bf(Wl) + bl, float32 into scratch and its bfloat16 copy
  // into the residual
  err = gemm_bf16(r.h, pad8(Din), 1, r.Wl, t0, t1, wk.x, false,
                  static_cast<bf16*>(x), HD, N, (int)HD, Din, 1, nullptr, bl,
                  nullptr, 0, X16_EXACT, st);
  if (err) return err;
  a.x = wk.x;  // the logits from the float32 x, the messages from its copy
  a.xm = static_cast<const bf16*>(x);
  a.proj = wk.proj;
  const ll warps = (ll)N * H > H * K ? (ll)N * H : H * K;
  gat_proj16_kernel<<<(unsigned)((warps + WARPS - 1) / WARPS), THREADS, 0,
                      st>>>(a, wk.proj, wk.projb, wk.va);
  err = (int)cudaGetLastError();
  if (err) return err;
  auto kern = pick<float>(a, {bias, out}, {a.xm}, gat_conv_fwd16_kernel<1>,
                          gat_conv_fwd16_kernel<1>, gat_conv_fwd16_kernel<2>);
  err = allow_smem(kern, smem);
  if (err) return err;
  kern<<<walk_grid(a), THREADS, smem, st>>>(a, wk.projb, wk.va, bias, out,
                                            alpha, aself, dlr, dls);
  return (int)cudaGetLastError();
}

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
                          int block_edges, float slope, void* stream) {
  (void)h;  // its rounded copy is r16's
  Graph a{x, nullptr, ein, We, es, ai, aj, snd, rcv, w,
          N, E, H, D, K, block_nodes, block_edges, slope, nullptr};
  if (bad_shape(a, true) || Din <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * D;
  const Bwd16Work wk = carve_bwd16(work, a, Din);
  const Rounded r = carve_rounded(
      static_cast<bf16*>(const_cast<void*>(r16)), N, Din);
  // dbias sums g over all rows, before the head mean's 1/H
  int err = colsum(g, N, D, wk.cpart, dbias, st);
  if (err) return err;
  const Cot c{g, (ll)D, 0, 1.f / (float)H};
  const ll ldb = pad8(HD);
  // the walks on the saved softmax of the bfloat16 residual
  const int smem = bwd_smem(a.be);
  auto rcv_k = pick<bf16>(a, {c.g, wk.dx}, {wk.dxb},
                          gat_bwd_rcv_kernel<true, 1, false, true, bf16>,
                          gat_bwd_rcv_kernel<true, 1, true, true, bf16>,
                          gat_bwd_rcv_kernel<true, 2, false, true, bf16>);
  auto snd_k = pick<bf16>(a, {c.g, wk.dx}, {wk.dxb},
                          gat_bwd_snd_kernel<true, 1, false, true, bf16>,
                          gat_bwd_snd_kernel<true, 1, true, true, bf16>,
                          gat_bwd_snd_kernel<true, 2, false, true, bf16>);
  err = allow_smem(rcv_k, smem);
  if (err) return err;
  err = allow_smem(snd_k, smem);
  if (err) return err;
  rcv_k<<<walk_grid(a), THREADS, smem, st>>>(a, c, alpha, aself, dlr, dls,
                                             nullptr, wk.o);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int chunks = dwe16_chunks(E);
  gat_dwe16_kernel<<<dim3((unsigned)((HD + DWE_THREADS - 1) / DWE_THREADS),
                          chunks), DWE_THREADS, dwe16_smem(H), st>>>(
      a, c, alpha, wk.o.dz, wk.dwe_part);
  err = (int)cudaGetLastError();
  if (err) return err;
  snd_k<<<walk_grid(a), THREADS, smem, st>>>(a, c, alpha, aself, wk.o.dz,
                                             wk.o.dzs, wk.o.u, wk.dx, wk.dxb,
                                             ldb, wk.o.part);
  err = (int)cudaGetLastError();
  if (err) return err;
  const ll outs = (3 + (ll)K) * HD;
  gat_finish_kernel<<<(unsigned)((outs + 31) / 32), 32 * FIN_GROUPS, 0, st>>>(
      wk.o.part, walk_ctas(a), wk.dwe_part, chunks, K, HD, dpar, dWe);
  err = (int)cudaGetLastError();
  if (err) return err;
  ll t0, t1;
  wl16_strides(wls0, wls1, Din, HD, &t0, &t1);
  // dWl = bf(h)^T bf(dx): A(i = d, k = n) = h16[n, d]
  err = gemm_bf16(r.h, 1, pad8(Din), wk.dxb, ldb, 1, dWl, false, nullptr, 0,
                  Din, HD, N, wgrad_splits(Din, HD, N), wk.gpart, nullptr,
                  nullptr, 0, false, st);
  if (err) return err;
  err = colsum(wk.dx, N, HD, wk.cpart, dbl, st);
  if (err) return err;
  // dh = bf(dx) @ bf(Wl)^T: B(k = c, j = d) = Wl16[d, c]
  return gemm_bf16(wk.dxb, ldb, 1, r.Wl, t1, t0, dh, false, nullptr, 0, N,
                   Din, HD, 1, nullptr, nullptr, nullptr, 0, false, st);
}

}  // extern "C"
