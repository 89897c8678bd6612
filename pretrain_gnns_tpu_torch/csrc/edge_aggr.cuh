// Row-owned edge aggregation on the block-diagonal batch, forward and
// backward, shared by the fused GIN conv (gin_conv.cu, K1) and the fused
// edge-transform SpMM (spmm.cu, K2); K2's bfloat16 variant (spmm_bf16.cu),
// the pair-dot head's backward (edge_dot.cu, K3) and the blocked SpMM on a
// precomputed edge embedding (spmm_ee.cu, K6) walk their slots with the
// same staging and walk, and the receiver-sorted SpMM (spmm_ee.cu, K7)
// takes its row accesses and launch. One template, three flags:
//
//   out_r = sum_{rcv_e = r} w_e * (x[snd_e] [HAS_X] + ein_e @ W [HAS_EIN])
//           + (x_r + e_self) * nm_r                                  [SELF]
//
// Backward from g [N, F]:
//   dx_n    = sum_{snd_e = n} w_e * g[rcv_e] [HAS_X] + g_n * nm_n    [SELF]
//   dW      = sum_r A_r^T g_r with A_r = sum_{rcv_e = r} w_e ein_e  [HAS_EIN]
//   de_self = sum_n g_n * nm_n                                        [SELF]
// dW and de_self leave as one partial per node block; the including
// source sums the partials over blocks in block order.
//
// What bounds it on the card: at the bio shapes (N = 20,480 rows, F = 300,
// K = 10, about 44 k valid edges of 61,440 slots) a call reads the x or g
// rows that valid edges touch and writes [N, F], 20-45 MB, and does at most
// 0.3 GFLOP: bound by bytes (3.35 TB/s), about 0.01 ms. What keeps a
// simple kernel far from that is latency: chains of dependent loads a slot,
// and too few warps in flight to hide them when registers run short.
//
// Design:
// - One CTA per (node block, 32 * VEC-wide feature tile), VEC adjacent
//   features a lane (VEC = 2, float2 accesses, where F is even and the rows
//   8-byte aligned: half the CTAs, and the walk's cost shared by two
//   features; K1 keeps VEC = 1); the block's rows sit in a shared f32
//   tile. Each warp owns the rows r with r % AGG_WARPS == warp and is the
//   only writer of them: no atomics, and every row is summed in slot
//   order, so out, dx, dW and de_self are the same bits on every run.
// - The CTA stages AGG_STAGE slots at a time in shared memory (local
//   sender, local receiver, weight, and the slots' ein rows), one slot a
//   thread, every load independent and coalesced. Each warp then ballots
//   which staged slots touch a row it owns, lists them in slot order, and
//   walks the list AGG_BATCH slots at a time: the x or g rows of a batch
//   are loaded before any of them is added, so a warp has up to AGG_BATCH
//   row loads in flight instead of one dependent chain a slot.
// - The edge term is reassociated: the owning warp adds w_e ein_e into the
//   block's [block_nodes, K] row sums A (lanes k < K, one add a slot), and
//   each row then gets A_r @ W from W's tile in shared memory: K FMAs a
//   row, not a slot. The backward rebuilds A by the receiver walk
//   (one add a slot) and forms dW_block = sum_r A_r^T g_r; dx walks the
//   slots by sender.
// - Padded slots (w == 0) and slots with an endpoint outside their block
//   add nothing, so a padded slot's global index 0 never reaches a row of
//   another block. Every row of out and dx is written, so padded rows come
//   out exactly 0 (K1: its self term, which the node mask zeroes).
// bfloat16 (BF = true, K1's: with the self term): the rows may be stored
// as float or bfloat16 (TI the rows read, TO the rows written), and with
// BF the walk rounds its operands to bfloat16 where the Pallas kernel at
// compute_dtype = bfloat16 does, every product and sum in float32:
// - forward, each slot's message m_e = bf(w_e) bf(x[snd_e]) + sum_k
//   bf(w_e ein_ek) bf(W_k), then out_r = sum bf(m_e) + the self term,
//   unrounded. The rounding of each message leaves no room for the row
//   sums A, so the edge term is formed per slot from W's tile in shared
//   memory (K FMAs a feature and slot);
// - backward: dx_n = sum bf(w_e) bf(g[rcv_e]) + g_n nm_n and
//   dW = sum_r A_r^T bf(g_r) with A_r = sum bf(w_e ein_e), as the Pallas
//   kernel's one-hot products give it.
// K2's bfloat16 variant (no self term, each dmsg rounded) is spmm_bf16.cu's.
// Products of two bfloat16 values are exact in float32, so only the order
// of the sums differs from the Pallas kernel. The float instantiations
// (TI = TO = float, BF = false) are the code above, the same bits.
// Everything here has internal linkage (an anonymous namespace), so each
// including source gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

typedef long long ll;
typedef __nv_bfloat16 bf16;

// v rounded to the nearest bfloat16 (ties to even), as a float: the
// Pallas kernel's astype(bfloat16).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int AGG_FT = 32;                   // lanes of a feature tile
constexpr int AGG_THREADS = 256;
constexpr int AGG_WARPS = AGG_THREADS / AGG_FT;
constexpr int AGG_STAGE = AGG_THREADS;       // slots staged a pass, one a thread
constexpr int AGG_BATCH = 8;                 // row loads in flight a warp
constexpr int AGG_MAX_K = 16;                // edge input width
constexpr int AGG_DEFAULT_SMEM = 48 * 1024;  // above this only after opting in

// CTAs an SM that a kernel's registers must allow. The x-only variant is
// bound by its row loads in flight: on an H100 (bio batch, F = 300) five
// CTAs of it (48 registers, 12 bytes spilled) ran 14% faster than three of
// 79 registers; the variants with an edge term ran slower so capped.
constexpr int agg_min_ctas(bool has_x, bool has_ein) {
  return has_x && !has_ein ? 5 : 1;
}

static_assert(AGG_STAGE <= 256, "a warp's slot list holds bytes");

// Shared bytes of an aggregation CTA with VEC features a lane: the walk's
// tiles, [block_nodes][32 * VEC] row sums (with x or for dx),
// [block_nodes][K] edge-input sums and, forward, W's [K][32 * VEC] tile,
// the staged slots and their ein rows, each warp's slot list; the backward
// reuses the space for its cross-warp sums, [AGG_WARPS][MAX_K + 1][32 *
// VEC].
int edge_aggr_smem(int block_nodes, int K, int vec, bool acc, bool has_ein,
                   bool backward) {
  const int ke = has_ein ? K : 0;
  const int walk = (acc ? block_nodes * AGG_FT * vec : 0) + block_nodes * ke +
                   (backward ? 0 : ke * AGG_FT * vec) + AGG_STAGE * (3 + ke);
  const int red = backward && has_ein
                      ? AGG_WARPS * (AGG_MAX_K + 1) * AGG_FT * vec : 0;
  return (walk > red ? walk : red) * (int)sizeof(float) +
         AGG_WARPS * AGG_STAGE;
}

// The widest VEC, of 4, 2 and 1 and at most max_vec, whose accesses the
// rows allow: F a multiple of VEC and every row pointer elem * VEC-byte
// aligned, elem the bytes of an element (null pointers are not read).
int row_vec(int F, std::initializer_list<const void*> ptrs, int max_vec,
            int elem = 4) {
  for (int vec = max_vec; vec > 1; vec /= 2) {
    bool ok = F % vec == 0;
    for (const void* p : ptrs)
      if (p && reinterpret_cast<uintptr_t>(p) % (elem * vec)) ok = false;
    if (ok) return vec;
  }
  return 1;
}

// VEC adjacent features of one row: a lane's share of a feature tile.
template <int VEC>
struct Row {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Row<VEC> ld_row(const float* p) {
  Row<VEC> r;
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r.v[0] = t.x;
    r.v[1] = t.y;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void st_row(float* p, const Row<VEC>& r) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  else if constexpr (VEC == 2)
    *reinterpret_cast<float2*>(p) = make_float2(r.v[0], r.v[1]);
  else
    *p = r.v[0];
}

// The same for bfloat16 rows: 8-, 4- or 2-byte accesses, the values
// widened to float on the load and rounded to nearest on the store.
template <int VEC>
__device__ __forceinline__ Row<VEC> ld_row(const bf16* p) {
  Row<VEC> r;
  if constexpr (VEC == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    r.v[0] = a.x;
    r.v[1] = a.y;
    r.v[2] = b.x;
    r.v[3] = b.y;
  } else if constexpr (VEC == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    r.v[0] = a.x;
    r.v[1] = a.y;
  } else {
    r.v[0] = __bfloat162float(*p);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void st_row(bf16* p, const Row<VEC>& r) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(r.v[0], r.v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(r.v[2], r.v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&a);
    u.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(r.v[0], r.v[1]);
  } else {
    *p = __float2bfloat16_rn(r.v[0]);
  }
}

// A row read from rows of type T, rounded to bfloat16 values under BF
// (bfloat16 rows already hold them).
template <int VEC, bool BF, typename T>
__device__ __forceinline__ Row<VEC> ld_row_bf(const T* p) {
  Row<VEC> r = ld_row<VEC>(p);
  if constexpr (BF && std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[j] = round_bf16(r.v[j]);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ Row<VEC> zero_row() {
  Row<VEC> r;
#pragma unroll
  for (int j = 0; j < VEC; ++j) r.v[j] = 0.f;
  return r;
}

// A staged slot as a warp's walk loads it: the row it adds, the local row
// that row adds into, the weight, and a second row to add (K6's ee).
template <int VEC>
struct Slot {
  Row<VEC> x;
  int r;
  float w;
  Row<VEC> e;
};

struct Staged {
  int* ls;              // [AGG_STAGE] local sender, -1: adds nothing
  int* lr;              // [AGG_STAGE] local receiver, -1: adds nothing
  float* w;             // [AGG_STAGE]
  float* ein;           // [AGG_STAGE][K]
  unsigned char* list;  // [AGG_WARPS][AGG_STAGE] a warp's owned slots
};

// Stage slots p0 .. p0 + n - 1 of block b, one a thread (-1 for a slot
// that adds nothing: w == 0, or an endpoint outside the block, so that a
// padded slot's global index 0 never reaches a row of another block's
// tile), and with K > 0 their ein rows, every load issued before the first
// store. Between two __syncthreads of the caller.
__device__ __forceinline__ void stage_slots(
    const Staged& s, const int* __restrict__ snd, const int* __restrict__ rcv,
    const float* __restrict__ w, const float* __restrict__ ein, ll e0,
    ll base, int p0, int n, int block_nodes, int K) {
  const int t = threadIdx.x;
  const float* src = ein + (e0 + p0) * K;
  float e[AGG_MAX_K];
#pragma unroll
  for (int j = 0; j < AGG_MAX_K; ++j) {
    const int i = t + j * AGG_THREADS;
    e[j] = i < n * K ? src[i] : 0.f;
  }
  int ls = -1, lr = -1;
  float we = 0.f;
  if (t < n) {
    we = w[e0 + p0 + t];
    const ll sg = snd[e0 + p0 + t] - base;
    const ll rg = rcv[e0 + p0 + t] - base;
    if (we != 0.f && sg >= 0 && sg < block_nodes && rg >= 0 &&
        rg < block_nodes) {
      ls = (int)sg;
      lr = (int)rg;
    }
  }
  s.ls[t] = ls;
  s.lr[t] = lr;
  s.w[t] = we;
#pragma unroll
  for (int j = 0; j < AGG_MAX_K; ++j) {
    const int i = t + j * AGG_THREADS;
    if (i < n * K) s.ein[i] = e[j];
  }
}

// Under BF, rounds the staged ein rows of slots 0 .. n - 1 in place to
// bf(w_e ein_e), one entry a thread. Between two __syncthreads of the
// caller.
__device__ __forceinline__ void round_staged(const Staged& s, int n, int K) {
  for (int i = threadIdx.x; i < n * K; i += AGG_THREADS)
    s.ein[i] = round_bf16(s.ein[i] * s.w[i / K]);
}

// Visits, in slot order, the staged slots 0 .. n - 1 whose sender
// (BY_SENDER) or receiver row this warp owns: load(q) for a batch of up to
// AGG_BATCH slots q, then add(q, loaded) for each in order. Every lane
// runs the same loop. The list entries of a batch are read from shared
// memory before any is used, so that those reads overlap; load may return
// what add needs besides the row (the slot's weight, its row index), read
// in the same overlapped step.
template <bool BY_SENDER, typename Load, typename Add>
__device__ __forceinline__ void walk_staged(const Staged& s, int n, int lane,
                                            int warp, Load load, Add add) {
  unsigned char* list = s.list + warp * AGG_STAGE;
  int cnt = 0;
  for (int c = 0; c < n; c += AGG_FT) {
    const int q = c + lane;
    const int key = q < n ? (BY_SENDER ? s.ls[q] : s.lr[q]) : -1;
    const bool own = key >= 0 && key % AGG_WARPS == warp;
    const unsigned m = __ballot_sync(FULL_MASK, own);
    if (own) list[cnt + __popc(m & ((1u << lane) - 1u))] = (unsigned char)q;
    cnt += __popc(m);
  }
  __syncwarp();
  for (int i = 0; i < cnt; i += AGG_BATCH) {
    int q[AGG_BATCH];
#pragma unroll
    for (int u = 0; u < AGG_BATCH; ++u) q[u] = i + u < cnt ? list[i + u] : 0;
    decltype(load(0)) v[AGG_BATCH];
#pragma unroll
    for (int u = 0; u < AGG_BATCH; ++u)
      if (i + u < cnt) v[u] = load(q[u]);
#pragma unroll
    for (int u = 0; u < AGG_BATCH; ++u)
      if (i + u < cnt) add(q[u], v[u]);
  }
  __syncwarp();  // the next walk rewrites the list
}

// Carves the walk's shared memory: acc [block_nodes][FTV] (with ``acc``),
// asum [block_nodes][K], W's tile [K][FTV] (with ``wtile``), then the
// staging.
__device__ __forceinline__ Staged carve_walk(float* smem, int block_nodes,
                                             int K, int ftv, bool acc,
                                             bool wtile, float*& acc_p,
                                             float*& asum_p, float*& W_p) {
  acc_p = smem;
  asum_p = acc_p + (acc ? block_nodes * ftv : 0);
  W_p = asum_p + block_nodes * K;
  Staged s;
  s.w = W_p + (wtile ? K * ftv : 0);
  s.ls = (int*)(s.w + AGG_STAGE);
  s.lr = s.ls + AGG_STAGE;
  s.ein = (float*)(s.lr + AGG_STAGE);
  s.list = (unsigned char*)(s.ein + AGG_STAGE * K);
  return s;
}

// Forward, with VEC adjacent features a lane (VEC = 2 needs F even: a
// lane's pair lies wholly inside or wholly past F). K = 0 without HAS_EIN;
// W, e_self and nm are read only where their flag asks. x is read as TI,
// out written as TO; BF rounds as the note above says.
template <bool HAS_X, bool HAS_EIN, bool SELF, int VEC, typename TI = float,
          typename TO = float, bool BF = false>
__global__ void __launch_bounds__(AGG_THREADS, agg_min_ctas(HAS_X, HAS_EIN))
edge_aggr_fwd_kernel(const TI* __restrict__ x, const float* __restrict__ ein,
                     const float* __restrict__ W, const float* __restrict__ e_self,
                     const int* __restrict__ snd, const int* __restrict__ rcv,
                     const float* __restrict__ w, const float* __restrict__ nm,
                     TO* __restrict__ out, int F, int K, int block_nodes,
                     int block_edges) {
  static_assert(HAS_X || HAS_EIN, "nothing to aggregate");
  static_assert(!SELF || HAS_X, "the self term reads x");
  constexpr int FTV = AGG_FT * VEC;
  constexpr bool ACC = HAS_X || BF;  // the message sums' shared tile
  extern __shared__ float smem[];
  float *acc, *asum, *W_s;
  const Staged st = carve_walk(smem, block_nodes, K, FTV, ACC, HAS_EIN, acc,
                               asum, W_s);
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * FTV;
  const int lane = threadIdx.x % AGG_FT;
  const int warp = threadIdx.x / AGG_FT;
  const int c = lane * VEC;  // the lane's first column of the tile
  const int f = f0 + c;
  const bool fok = f < F;
  // a warp zeroes, fills and reads only the rows it owns
  for (int r = warp; r < block_nodes; r += AGG_WARPS) {
    if (ACC) st_row(acc + r * FTV + c, zero_row<VEC>());
    if (HAS_EIN && lane < K) asum[r * K + lane] = 0.f;
  }
  if (HAS_EIN)  // read after the pass loop's first barrier
    for (int i = threadIdx.x; i < K * FTV; i += AGG_THREADS) {
      const int k = i / FTV, l = i % FTV;
      const float v = f0 + l < F ? W[(ll)k * F + f0 + l] : 0.f;
      W_s[i] = BF ? round_bf16(v) : v;
    }

  const ll base = (ll)b * block_nodes;
  const ll e0 = (ll)b * block_edges;
  for (int p0 = 0; p0 < block_edges; p0 += AGG_STAGE) {
    const int n = min(AGG_STAGE, block_edges - p0);
    __syncthreads();  // the last pass's staging has been read
    stage_slots(st, snd, rcv, w, ein, e0, base, p0, n, block_nodes,
                HAS_EIN ? K : 0);
    __syncthreads();
    if (BF && HAS_EIN) {
      round_staged(st, n, K);
      __syncthreads();
    }
    walk_staged<false>(
        st, n, lane, warp,
        [&](int q) {
          return (HAS_X && fok)
                     ? ld_row_bf<VEC, BF>(x + (base + st.ls[q]) * F + f)
                     : zero_row<VEC>();
        },
        [&](int q, const Row<VEC>& xs) {
          const int r = st.lr[q];
          const float wq = st.w[q];
          if constexpr (BF) {  // the slot's message, rounded, into acc
            if (!fok) return;
            const float wr = round_bf16(wq);
            Row<VEC> m = zero_row<VEC>();
#pragma unroll
            for (int k = 0; k < AGG_MAX_K; ++k)
              if (HAS_EIN && k < K) {
                const float ek = st.ein[q * K + k];
                const Row<VEC> wk = ld_row<VEC>(W_s + k * FTV + c);
#pragma unroll
                for (int j = 0; j < VEC; ++j) m.v[j] = fmaf(ek, wk.v[j], m.v[j]);
              }
            Row<VEC> a = ld_row<VEC>(acc + r * FTV + c);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              if (HAS_X) m.v[j] = HAS_EIN ? m.v[j] + wr * xs.v[j] : wr * xs.v[j];
              a.v[j] += round_bf16(m.v[j]);
            }
            st_row(acc + r * FTV + c, a);
            return;
          }
          if (HAS_EIN && lane < K)
            asum[r * K + lane] = fmaf(wq, st.ein[q * K + lane], asum[r * K + lane]);
          if (HAS_X && fok) {
            Row<VEC> a = ld_row<VEC>(acc + r * FTV + c);
#pragma unroll
            for (int j = 0; j < VEC; ++j) a.v[j] = fmaf(wq, xs.v[j], a.v[j]);
            st_row(acc + r * FTV + c, a);
          }
        });
  }
  __syncwarp();

  if (!fok) return;
  Row<VEC> es = zero_row<VEC>();
  if (SELF) es = ld_row<VEC>(e_self + f);
  for (int r = warp; r < block_nodes; r += AGG_WARPS) {
    const ll nr = base + r;
    const Row<VEC> a = ACC ? ld_row<VEC>(acc + r * FTV + c) : zero_row<VEC>();
    Row<VEC> xr = zero_row<VEC>();
    if (SELF) xr = ld_row<VEC>(x + nr * F + f);
    Row<VEC> e = zero_row<VEC>();  // A_r @ W[:, f .. f + VEC - 1]
#pragma unroll
    for (int k = 0; k < AGG_MAX_K; ++k)
      if (!BF && HAS_EIN && k < K) {
        const float ak = asum[r * K + k];
        const Row<VEC> wk = ld_row<VEC>(W_s + k * FTV + c);
#pragma unroll
        for (int j = 0; j < VEC; ++j) e.v[j] = fmaf(ak, wk.v[j], e.v[j]);
      }
    Row<VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (BF)  // acc holds the rounded messages' sum, the edge term in it
        o.v[j] = SELF ? a.v[j] + (xr.v[j] + es.v[j]) * nm[nr] : a.v[j];
      else if (SELF)
        o.v[j] = a.v[j] + e.v[j] + (xr.v[j] + es.v[j]) * nm[nr];
      else if (HAS_X && HAS_EIN)
        o.v[j] = a.v[j] + e.v[j];
      else if (HAS_X)
        o.v[j] = a.v[j];
      else
        o.v[j] = e.v[j];
    }
    st_row(out + nr * F + f, o);
  }
}

// Backward from g, with VEC adjacent features a lane as the forward.
// Writes dx (HAS_X), the block's dW partial [n_blocks][K][F] (HAS_EIN) and
// its de_self partial [n_blocks][F] (SELF). g is read as TI, dx written as
// TO; BF rounds as the note above says.
template <bool HAS_X, bool HAS_EIN, bool SELF, int VEC, typename TI = float,
          typename TO = float, bool BF = false>
__global__ void __launch_bounds__(AGG_THREADS, agg_min_ctas(HAS_X, HAS_EIN))
edge_aggr_bwd_kernel(const TI* __restrict__ g, const float* __restrict__ ein,
                     const int* __restrict__ snd, const int* __restrict__ rcv,
                     const float* __restrict__ w, const float* __restrict__ nm,
                     TO* __restrict__ dx, float* __restrict__ dW_part,
                     float* __restrict__ des_part, int F, int K,
                     int block_nodes, int block_edges) {
  static_assert(HAS_X || HAS_EIN, "nothing to aggregate");
  static_assert(!SELF || HAS_X, "the self term writes dx");
  static_assert(!SELF || HAS_EIN, "de_self shares the dW reduction's space");
  static_assert(!BF || SELF, "K2's bfloat16 backward is spmm_bf16.cu's");
  constexpr int FTV = AGG_FT * VEC;
  extern __shared__ float smem[];
  float *acc, *asum, *unused;  // acc by sender, asum (A) by receiver
  const Staged st = carve_walk(smem, block_nodes, K, FTV, HAS_X, false, acc,
                               asum, unused);
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * FTV;
  const int lane = threadIdx.x % AGG_FT;
  const int warp = threadIdx.x / AGG_FT;
  const int c = lane * VEC;
  const int f = f0 + c;
  const bool fok = f < F;
  for (int r = warp; r < block_nodes; r += AGG_WARPS) {
    if (HAS_X) st_row(acc + r * FTV + c, zero_row<VEC>());
    if (HAS_EIN && lane < K) asum[r * K + lane] = 0.f;
  }
  // sum over the warp's rows of A_r[k] * g_r[f]
  Row<VEC> dwe[AGG_MAX_K];
#pragma unroll
  for (int k = 0; k < AGG_MAX_K; ++k) dwe[k] = zero_row<VEC>();

  const ll base = (ll)b * block_nodes;
  const ll e0 = (ll)b * block_edges;
  for (int p0 = 0; p0 < block_edges; p0 += AGG_STAGE) {
    const int n = min(AGG_STAGE, block_edges - p0);
    __syncthreads();
    stage_slots(st, snd, rcv, w, ein, e0, base, p0, n, block_nodes,
                HAS_EIN ? K : 0);
    __syncthreads();
    if (BF && HAS_EIN) {
      round_staged(st, n, K);
      __syncthreads();
    }
    if (HAS_X)
      walk_staged<true>(
          st, n, lane, warp,
          [&](int q) {
            return fok ? ld_row_bf<VEC, BF>(g + (base + st.lr[q]) * F + f)
                       : zero_row<VEC>();
          },
          [&](int q, const Row<VEC>& gr) {
            const int s = st.ls[q];
            if (fok) {
              Row<VEC> a = ld_row<VEC>(acc + s * FTV + c);
              const float wq = BF ? round_bf16(st.w[q]) : st.w[q];
#pragma unroll
              for (int j = 0; j < VEC; ++j) a.v[j] = fmaf(wq, gr.v[j], a.v[j]);
              st_row(acc + s * FTV + c, a);
            }
          });
    if (HAS_EIN)
      walk_staged<false>(
          st, n, lane, warp, [](int) { return 0.f; },
          [&](int q, float) {
            const int r = st.lr[q];
            if (lane < K)
              asum[r * K + lane] =
                  BF ? asum[r * K + lane] + st.ein[q * K + lane]
                     : fmaf(st.w[q], st.ein[q * K + lane], asum[r * K + lane]);
          });
  }
  __syncwarp();

  Row<VEC> des = zero_row<VEC>();
  for (int r = warp; r < block_nodes; r += AGG_WARPS) {
    const ll nr = base + r;
    Row<VEC> d = zero_row<VEC>();
    if ((SELF || HAS_EIN) && fok) d = ld_row<VEC>(g + nr * F + f);
    if (SELF) {
      Row<VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float dn = d.v[j] * nm[nr];
        des.v[j] += dn;
        o.v[j] = acc[r * FTV + c + j] + dn;
      }
      if (fok) st_row(dx + nr * F + f, o);
    } else if (HAS_X && fok) {
      st_row(dx + nr * F + f, ld_row<VEC>(acc + r * FTV + c));
    }
#pragma unroll
    for (int k = 0; k < AGG_MAX_K; ++k)
      if (HAS_EIN && k < K)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          dwe[k].v[j] = fmaf(asum[r * K + k], BF ? round_bf16(d.v[j]) : d.v[j],
                             dwe[k].v[j]);
  }
  if (!(HAS_EIN || SELF)) return;
  __syncthreads();  // smem is reused below for the cross-warp sums

  float* red_we = smem;                                // [WARPS][MAX_K][FTV]
  float* red_es = smem + AGG_WARPS * AGG_MAX_K * FTV;  // [WARPS][FTV]
#pragma unroll
  for (int k = 0; k < AGG_MAX_K; ++k)
    if (HAS_EIN && k < K) st_row(red_we + (warp * AGG_MAX_K + k) * FTV + c, dwe[k]);
  if (SELF) st_row(red_es + warp * FTV + c, des);
  __syncthreads();

  if (HAS_EIN)
    for (int i = threadIdx.x; i < K * FTV; i += AGG_THREADS) {
      const int k = i / FTV, l = i % FTV;
      float s = 0.f;
      for (int v = 0; v < AGG_WARPS; ++v) s += red_we[(v * AGG_MAX_K + k) * FTV + l];
      if (f0 + l < F) dW_part[((ll)b * K + k) * F + f0 + l] = s;
    }
  const int t = threadIdx.x;
  if (SELF && t < FTV && f0 + t < F) {
    float s = 0.f;
    for (int v = 0; v < AGG_WARPS; ++v) s += red_es[v * FTV + t];
    des_part[(ll)b * F + f0 + t] = s;
  }
}

// The card's SMs (one query a process).
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename Kernel, typename... Args>
int launch_edge_aggr(Kernel kernel, int smem, int n_blocks, int F, int ftv,
                     cudaStream_t st, Args... args) {
  if (smem > AGG_DEFAULT_SMEM) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  dim3 grid(n_blocks, (F + ftv - 1) / ftv);
  kernel<<<grid, AGG_THREADS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// Launches at2, a kernel bound to two CTAs an SM, where the (n_blocks,
// feature tile) grid fits the card at two or where at3, its build bound to
// three, spills registers; else at3, so that a second wave stays short.
template <typename Kernel, typename... Args>
int launch_two_or_three(Kernel at2, Kernel at3, int smem, int n_blocks,
                        int F, int ftv, cudaStream_t st, Args... args) {
  cudaFuncAttributes a3;
  const int err = (int)cudaFuncGetAttributes(&a3, at3);
  if (err) return err;
  const ll ctas = (ll)n_blocks * ((F + ftv - 1) / ftv);
  return launch_edge_aggr(
      ctas <= 2LL * sm_count() || a3.localSizeBytes > 0 ? at2 : at3, smem,
      n_blocks, F, ftv, st, args...);
}

// Launches the forward: out [n_blocks * block_nodes, F].
template <bool HAS_X, bool HAS_EIN, bool SELF, int VEC, typename TI = float,
          typename TO = float, bool BF = false>
int edge_aggr_fwd(const TI* x, const float* ein, const float* W,
                  const float* e_self, const int* snd, const int* rcv,
                  const float* w, const float* nm, TO* out, int n_blocks,
                  int F, int K, int block_nodes, int block_edges,
                  cudaStream_t st) {
  return launch_edge_aggr(
      edge_aggr_fwd_kernel<HAS_X, HAS_EIN, SELF, VEC, TI, TO, BF>,
      edge_aggr_smem(block_nodes, K, VEC, HAS_X || BF, HAS_EIN, false),
      n_blocks, F, AGG_FT * VEC, st, x, ein, W, e_self, snd, rcv, w, nm, out,
      F, K, block_nodes, block_edges);
}

// Launches the backward: dx, and the per-block partials of dW and de_self.
template <bool HAS_X, bool HAS_EIN, bool SELF, int VEC, typename TI = float,
          typename TO = float, bool BF = false>
int edge_aggr_bwd(const TI* g, const float* ein, const int* snd,
                  const int* rcv, const float* w, const float* nm, TO* dx,
                  float* dW_part, float* des_part, int n_blocks, int F, int K,
                  int block_nodes, int block_edges, cudaStream_t st) {
  return launch_edge_aggr(
      edge_aggr_bwd_kernel<HAS_X, HAS_EIN, SELF, VEC, TI, TO, BF>,
      edge_aggr_smem(block_nodes, K, VEC, HAS_X, HAS_EIN, true),
      n_blocks, F, AGG_FT * VEC, st, g, ein, snd, rcv, w, nm, dx, dW_part,
      des_part, F, K, block_nodes, block_edges);
}

}  // namespace
