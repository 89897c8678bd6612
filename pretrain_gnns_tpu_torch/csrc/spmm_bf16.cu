// The bfloat16 variant of K2, the fused edge-transform SpMM (compute_dtype
// = bfloat16), forward and backward: the entry points that spmm.cu's C
// interface calls under bf16_compute. A source of its own so that it
// compiles beside spmm.cu's float32 instantiations (ops/_build.py builds
// the two in parallel and links them into one library).
//
// What it computes (pallas_spmm.py's _fused_fwd_kernel and
// _fused_bwd_kernel at compute_dtype = bfloat16, bf() a rounding to the
// nearest bfloat16, every product and sum in float32):
//
//   out_r  = sum_{rcv_e = r} bf(m_e),
//   m_e    = sum_k bf(w_e ein_ek) bf(W_k) [has_ein] + bf(w_e) bf(x[snd_e])
//   dmsg_e = bf(bf(w_e) bf(g[rcv_e])),  dx_n = sum_{snd_e = n} dmsg_e,
//   dW     = sum_e bf(ein_e)^T dmsg_e                   (float32, K x F)
//
// out and dx in the rows' dtype (float or bfloat16). Products of two
// bfloat16 values are exact in float32, so only the order of the sums can
// differ from the Pallas kernel.
//
// What bounds it on the card: bytes, at the bio masking path's first batch
// (N = 20,480 rows, F = 300, K = 10, 44 k valid edges of 61,440 slots)
// about 0.003-0.013 ms (PERF.md §6). What kept the first bfloat16 walk
// (edge_aggr.cuh's BF branch, which K1 keeps) at 2.6-15x that was the work
// a slot: the rounding of each message leaves no room for the float32
// walk's row sums, so every slot formed its edge term from all K entries
// of W's tile, and the backward summed dW slot by slot into K x VEC
// registers a lane, which held the walk at one CTA an SM. Measured on the
// H100 (PERF.md §6), the walks are bound by each warp's chain of
// dependent shared-memory steps a slot, not by bytes or FMAs.
//
// Design (edge_aggr.cuh's staging and row ownership; no atomics, so out,
// dx and dW are the same bits on every run; every row summed in slot
// order):
// - One CTA per (node block, 32 * VEC-wide feature tile). A pass's slots
//   are staged as stage_slots does, but the next pass's loads are issued
//   before this pass's walk (fetch_slots / put_slots), and bf(w) is stored.
// - Each warp lists the slots of its rows sorted by row, each row's slots
//   in slot order (list_by_row), and sums a row's messages in registers,
//   adding the run to the shared float32 tile once a row and pass
//   (walk_rows): no shared read-modify-write a slot.
// - [x] forward and the dx walk: a batch's rows loaded together, each
//   message bf(bf(w) bf(x)) rounded unless w is 1 (then it is bf(x), so the
//   masking paths round only float rows); float rows rounded two values
//   to a conversion. Four features a lane where they fit (8- or 16-byte
//   row accesses, three tiles at F = 300).
// - [ein] and [x+ein] forward: a warp forms the edge terms of 16 of its
//   slots at a time on the tensor cores, E [16 slots, 16] @ bf(W) [16,
//   FTV] (K padded to 16, E = bf(w ein) staged in bfloat16, W's B
//   fragments held in registers for the whole kernel, mma.sync m16n8k16,
//   the product the Pallas body takes on the MXU), into a shared tile of
//   its own, then adds bf(w) bf(x) and rounds each message in the walk's
//   order. Two features a lane: the tiles and sums fit three CTAs an SM
//   without x, two with.
// - dW on the tensor cores: each pass's staged slots give A = bf(ein)^T
//   [16 x 16 slots] (staged transposed in bfloat16) and B = dmsg [16 slots
//   x 8 features], formed in the mma's operand registers from the g rows
//   (dmsg = bf(g) where every weight of the step is 0 or 1). A warp owns
//   FTV / 8 features of the tile for dW, so no warp shares an output: the
//   block's dW partial leaves from the fragments, and spmm.cu sums the
//   partials over blocks in block order.
// Products of two bfloat16 values are exact in float32; the tensor cores'
// sums of up to 16 of them may round otherwise than an FMA chain, so the
// edge terms and dW may differ from the first walk's in their last bits
// (within the card tests' gate); out without an edge term and dx are the
// first walk's bits.

#include "edge_aggr.cuh"
#include "gemm.cuh"  // mma_bf16

namespace {

constexpr int MAX_SMEM16 = 232448;     // 227 KB: a block's most on the H100
constexpr int ET_LD = AGG_STAGE + 8;   // row pitch of the staged bf(ein)^T:
                                       // the A fragments' loads hit 32 banks
constexpr int DW_U = 4;                // 16-slot steps whose g loads fly at once

// CTAs an SM that a kernel's registers must allow. Without an edge term
// the walk is bound by its row loads in flight: as many CTAs as the shared
// memory allows (3 at four features a lane, 5 at two; at two, 48
// registers spill 8 bytes and still ran faster on the H100 than 4 CTAs of
// 64); with one, two (dW's registers).
constexpr int min_ctas16(bool has_ein, int vec) {
  return has_ein ? 2 : vec == 4 ? 3 : 5;
}

// a and b rounded to the nearest bfloat16 (ties to even), as floats, by
// one conversion: the card converts at a fraction of its FMA rate, and
// each value of a walk is rounded once or twice.
__device__ __forceinline__ void round_pair(float& a, float& b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  const unsigned u = *reinterpret_cast<const unsigned*>(&v);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}

template <int VEC>
__device__ __forceinline__ Row<VEC> round_row(Row<VEC> r) {
  if constexpr (VEC == 1) {
    r.v[0] = round_bf16(r.v[0]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; j += 2) round_pair(r.v[j], r.v[j + 1]);
  }
  return r;
}

// A row read as bfloat16 values: rows of floats rounded, bfloat16 rows as
// they are.
template <int VEC, typename T>
__device__ __forceinline__ Row<VEC> ld_row16(const T* p) {
  const Row<VEC> r = ld_row<VEC>(p);
  return std::is_same<T, float>::value ? round_row(r) : r;
}

// Two floats that are bfloat16 values as an mma operand register, ``lo``
// in the lower half: their upper halves, no conversion.
__device__ __forceinline__ unsigned pack2_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Two floats rounded to bfloat16 (ties to even) into one register, ``lo``
// in the lower half: one conversion.
__device__ __forceinline__ unsigned pack_round2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Shared bytes of the x walk: the message sums' tile [block_nodes][FTV],
// the staged slots, the warps' lists (in slot order and by row).
int x_fwd16_smem(int block_nodes, int vec) {
  return (block_nodes * AGG_FT * vec + AGG_STAGE * 3) * 4 +
         2 * AGG_WARPS * AGG_STAGE;
}

// Backward: dx's tile (has_x), the staged slots, bf(ein)^T [MAX_K][ET_LD]
// in bfloat16 (has_ein), the warps' lists.
int bwd16_smem(int block_nodes, int vec, bool has_x, bool has_ein) {
  return ((has_x ? block_nodes * AGG_FT * vec : 0) + AGG_STAGE * 3) * 4 +
         (has_ein ? AGG_MAX_K * ET_LD * 2 : 0) + 2 * AGG_WARPS * AGG_STAGE;
}

// The widest of 4, 2 and 1 features a lane that F, the rows (elem bytes an
// element) and the shared memory allow.
template <typename Smem>
int vec16(int F, std::initializer_list<const void*> rows, int elem,
          Smem smem) {
  for (int vec = 4; vec > 1; vec /= 2)
    if (row_vec(F, rows, vec, elem) == vec && smem(vec) <= MAX_SMEM16)
      return vec;
  return 1;
}

// Lists the staged slots 0 .. n - 1 whose sender (BY_SENDER) or receiver
// row this warp owns into ``out``, sorted by row (the warp's rows in turn,
// each row's slots in slot order), through ``tmp`` (the same slots in slot
// order); returns their count.
template <bool BY_SENDER>
__device__ __forceinline__ int list_by_row(const Staged& s, int n, int lane,
                                           int warp, int block_nodes,
                                           unsigned char* tmp,
                                           unsigned char* out) {
  constexpr int CHUNKS = AGG_STAGE / AGG_FT;
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;
  for (int c = 0; c < n; c += AGG_FT) {
    const int q = c + lane;
    const int key = q < n ? (BY_SENDER ? s.ls[q] : s.lr[q]) : -1;
    const bool own = key >= 0 && key % AGG_WARPS == warp;
    const unsigned m = __ballot_sync(FULL_MASK, own);
    if (own) tmp[cnt + __popc(m & below)] = (unsigned char)q;
    cnt += __popc(m);
  }
  __syncwarp();
  int kq[CHUNKS];  // (row << 8 | slot) of list entry j * 32 + lane, or -1
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int i = j * AGG_FT + lane;
    const int q = i < cnt ? tmp[i] : 0;
    kq[j] = i < cnt ? (BY_SENDER ? s.ls[q] : s.lr[q]) << 8 | q : -1;
  }
  int k = 0;
  for (int r = warp; r < block_nodes && k < cnt; r += AGG_WARPS)
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      if (j * AGG_FT >= cnt) break;  // the same in every lane
      const bool mine = kq[j] >= 0 && kq[j] >> 8 == r;
      const unsigned m = __ballot_sync(FULL_MASK, mine);
      if (mine) out[k + __popc(m & below)] = (unsigned char)(kq[j] & 0xff);
      k += __popc(m);
    }
  __syncwarp();
  return cnt;
}

// Visits the staged slots this warp owns by row (list_by_row's order):
// load(q) for a batch of up to B slots, every load issued with no branch
// between them (past the list's end the last slot is loaded again and not
// used), then msg(q, loaded) for each in order, summed into the row's run
// in registers; a run is added to its row of ``acc`` ([rows][FTV] at lane
// column c) once, when the next row's starts. ``fresh``: acc's rows are
// still 0 (the first pass), so a run starts from 0 without reading them.
template <int VEC, int FTV, int B, bool BY_SENDER, typename Load,
          typename Msg>
__device__ __forceinline__ void walk_rows(const Staged& s, int n, int lane,
                                          int warp, int block_nodes,
                                          float* acc, int c, bool fresh,
                                          Load load, Msg msg) {
  unsigned char* tmp = s.list + warp * AGG_STAGE;
  unsigned char* list = s.list + (AGG_WARPS + warp) * AGG_STAGE;
  const int cnt = list_by_row<BY_SENDER>(s, n, lane, warp, block_nodes, tmp,
                                         list);
  int run_row = -1;
  Row<VEC> run = zero_row<VEC>();
  for (int i = 0; i < cnt; i += B) {
    int q[B];
#pragma unroll
    for (int u = 0; u < B; ++u) q[u] = list[min(i + u, cnt - 1)];
    decltype(load(0)) v[B];
#pragma unroll
    for (int u = 0; u < B; ++u) v[u] = load(q[u]);
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (i + u >= cnt) break;  // the same in every lane
      const Row<VEC> m = msg(q[u], v[u]);
      const int r = BY_SENDER ? s.ls[q[u]] : s.lr[q[u]];
      if (r != run_row) {
        if (run_row >= 0) st_row(acc + run_row * FTV + c, run);
        run = fresh ? zero_row<VEC>() : ld_row<VEC>(acc + r * FTV + c);
        run_row = r;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) run.v[j] += m.v[j];
    }
  }
  if (run_row >= 0) st_row(acc + run_row * FTV + c, run);
  __syncwarp();  // the next pass rewrites the lists
}

// A thread's share of a pass's staging (stage_slots'), held in registers
// from its loads to its stores, so that the next pass's loads fly during
// this pass's walk: slot p0 + t's sender, receiver and weight, and entries
// t + j * AGG_THREADS of the pass's [n, K] ein rows.
struct Fetched {
  int s, r;
  float w;
  float e[AGG_MAX_K];
};

__device__ __forceinline__ Fetched fetch_slots(
    const int* __restrict__ snd, const int* __restrict__ rcv,
    const float* __restrict__ w, const float* __restrict__ ein, ll e0,
    int p0, int n, int K) {
  const int t = threadIdx.x;
  Fetched f;
  f.s = f.r = 0;
  f.w = 0.f;
  if (t < n) {
    f.w = w[e0 + p0 + t];
    f.s = snd[e0 + p0 + t];
    f.r = rcv[e0 + p0 + t];
  }
#pragma unroll
  for (int j = 0; j < AGG_MAX_K; ++j) {
    const int i = t + j * AGG_THREADS;
    f.e[j] = K > 0 && i < n * K ? ein[(e0 + p0) * K + i] : 0.f;
  }
  return f;
}

// Stores a pass of n slots as stage_slots does (-1 for a slot that adds
// nothing: w == 0, or an endpoint outside the block), but bf(w) for w, and
// the ein entries flat into s.ein, or with ``et`` their bf(ein) transposed
// into et [k][slot] (bfloat16). Between two __syncthreads of the caller.
__device__ __forceinline__ void put_slots(const Staged& s, bf16* et,
                                          const Fetched& f, ll base, int n,
                                          int block_nodes, int K) {
  const int t = threadIdx.x;
  int ls = -1, lr = -1;
  const ll sg = f.s - base, rg = f.r - base;
  if (t < n && f.w != 0.f && sg >= 0 && sg < block_nodes && rg >= 0 &&
      rg < block_nodes) {
    ls = (int)sg;
    lr = (int)rg;
  }
  s.ls[t] = ls;
  s.lr[t] = lr;
  s.w[t] = round_bf16(f.w);  // bf(w): no walk reads w unrounded
  if (K == 0) return;
  if (!et) {
#pragma unroll
    for (int j = 0; j < AGG_MAX_K; ++j)
      if (t + j * AGG_THREADS < n * K) s.ein[t + j * AGG_THREADS] = f.e[j];
    return;
  }
  // entry i = t + j * AGG_THREADS is slot i / K's k = i % K
  int q = t / K, k = t % K;
  const int dq = AGG_THREADS / K, dk = AGG_THREADS % K;
#pragma unroll
  for (int j = 0; j < AGG_MAX_K; ++j) {
    if (t + j * AGG_THREADS < n * K)
      et[k * ET_LD + q] = __float2bfloat16_rn(f.e[j]);
    q += dq;
    k += dk;
    if (k >= K) {
      k -= K;
      ++q;
    }
  }
}

// ---- [x] forward: the x walk ----------------------------------------------
//
// out_r = sum bf(bf(w_e) bf(x[snd_e])): each warp walks its rows' slots
// (walk_rows), the x rows of a batch in flight together, the message
// rounded unless w_e is 1 (then it is bf(x) as loaded).
template <int VEC, typename T>
__global__ void __launch_bounds__(AGG_THREADS, min_ctas16(false, VEC))
spmm16_x_fwd_kernel(const T* __restrict__ x, const int* __restrict__ snd,
                    const int* __restrict__ rcv, const float* __restrict__ w,
                    T* __restrict__ out, int F, int block_nodes,
                    int block_edges) {
  constexpr int FTV = AGG_FT * VEC;
  extern __shared__ float smem[];
  float* acc = smem;  // [block_nodes][FTV]
  Staged st;
  st.w = acc + block_nodes * FTV;
  st.ls = reinterpret_cast<int*>(st.w + AGG_STAGE);
  st.lr = st.ls + AGG_STAGE;
  st.ein = nullptr;
  st.list = reinterpret_cast<unsigned char*>(st.lr + AGG_STAGE);
  const int f0 = blockIdx.y * FTV;
  const int lane = threadIdx.x % AGG_FT;
  const int warp = threadIdx.x / AGG_FT;
  const int c = lane * VEC;
  const int f = f0 + c;
  const bool fok = f < F;
  const ll base = (ll)blockIdx.x * block_nodes;
  const ll e0 = (ll)blockIdx.x * block_edges;
  Fetched fe = fetch_slots(snd, rcv, w, nullptr, e0, 0,
                           min(AGG_STAGE, block_edges), 0);
  for (int r = warp; r < block_nodes; r += AGG_WARPS)
    st_row(acc + r * FTV + c, zero_row<VEC>());

  for (int p0 = 0; p0 < block_edges; p0 += AGG_STAGE) {
    const int n = min(AGG_STAGE, block_edges - p0);
    __syncthreads();  // the last pass's staging has been read
    put_slots(st, nullptr, fe, base, n, block_nodes, 0);
    __syncthreads();
    if (p0 + AGG_STAGE < block_edges)  // the next pass's, in flight
      fe = fetch_slots(snd, rcv, w, nullptr, e0, p0 + AGG_STAGE,
                       min(AGG_STAGE, block_edges - p0 - AGG_STAGE), 0);
    walk_rows<VEC, FTV, AGG_BATCH, false>(
        st, n, lane, warp, block_nodes, acc, c, p0 == 0,
        [&](int q) {
          return fok ? ld_row<VEC>(x + (base + st.ls[q]) * F + f)
                     : zero_row<VEC>();
        },
        [&](int q, const Row<VEC>& xl) {  // the message, rounded
          const Row<VEC> xr =
              std::is_same<T, float>::value ? round_row(xl) : xl;
          const float wr = st.w[q];
          if (wr == 1.f) return xr;  // bf(1 * bf(x)) is bf(x); the same in
                                     // every lane
          Row<VEC> m;
#pragma unroll
          for (int j = 0; j < VEC; ++j) m.v[j] = wr * xr.v[j];
          return round_row(m);
        });
  }
  __syncwarp();

  if (!fok) return;
  for (int r = warp; r < block_nodes; r += AGG_WARPS)
    st_row(out + (base + r) * F + f, ld_row<VEC>(acc + r * FTV + c));
}

template <bool HAS_X, bool HAS_EIN, int VEC, typename T>
__global__ void __launch_bounds__(AGG_THREADS, min_ctas16(HAS_EIN, VEC))
spmm16_bwd_kernel(const T* __restrict__ g, const float* __restrict__ ein,
                  const int* __restrict__ snd, const int* __restrict__ rcv,
                  const float* __restrict__ w, T* __restrict__ dx,
                  float* __restrict__ dW_part, int F, int K, int block_nodes,
                  int block_edges) {
  constexpr int FTV = AGG_FT * VEC;
  // dW: a warp's FW features of the tile, NTW n8 tiles of the mma; B's
  // column gid of tile t is the warp's feature gid * NTW + t (a lane's NTW
  // features adjacent, one load a slot)
  constexpr int FW = FTV / AGG_WARPS;
  constexpr int NTW = FW >= 8 ? FW / 8 : 1;
  extern __shared__ float smem[];
  float* acc = smem;  // [block_nodes][FTV], by sender (HAS_X)
  Staged st;
  st.w = acc + (HAS_X ? block_nodes * FTV : 0);
  st.ls = reinterpret_cast<int*>(st.w + AGG_STAGE);
  st.lr = st.ls + AGG_STAGE;
  bf16* et = reinterpret_cast<bf16*>(st.lr + AGG_STAGE);  // [MAX_K][ET_LD]
  st.ein = nullptr;
  st.list = reinterpret_cast<unsigned char*>(
      et + (HAS_EIN ? AGG_MAX_K * ET_LD : 0));
  const int f0 = blockIdx.y * FTV;
  const int lane = threadIdx.x % AGG_FT;
  const int warp = threadIdx.x / AGG_FT;
  const int c = lane * VEC;
  const int f = f0 + c;
  const bool fok = f < F;
  if (HAS_X)
    for (int r = warp; r < block_nodes; r += AGG_WARPS)
      st_row(acc + r * FTV + c, zero_row<VEC>());
  if (HAS_EIN)  // rows k >= K and slots past a short pass stay 0
    for (int i = threadIdx.x; i < AGG_MAX_K * ET_LD; i += AGG_THREADS)
      et[i] = __float2bfloat16_rn(0.f);
  const ll base = (ll)blockIdx.x * block_nodes;
  const ll e0 = (ll)blockIdx.x * block_edges;
  const int ke = HAS_EIN ? K : 0;
  Fetched fe = fetch_slots(snd, rcv, w, ein, e0, 0,
                           min(AGG_STAGE, block_edges), ke);
  const int gid = lane / 4, tig = lane % 4;
  const int fw0 = f0 + warp * FW;  // the warp's first dW feature
  const int fo = gid * NTW;        // this lane's first B column's, after it
  const bool cok = fo < FW && fw0 + fo < F;
  float dw[NTW][4];
#pragma unroll
  for (int t = 0; t < NTW; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) dw[t][i] = 0.f;

  for (int p0 = 0; p0 < block_edges; p0 += AGG_STAGE) {
    const int n = min(AGG_STAGE, block_edges - p0);
    __syncthreads();
    put_slots(st, et, fe, base, n, block_nodes, ke);
    __syncthreads();
    if (p0 + AGG_STAGE < block_edges)  // the next pass's, in flight
      fe = fetch_slots(snd, rcv, w, ein, e0, p0 + AGG_STAGE,
                       min(AGG_STAGE, block_edges - p0 - AGG_STAGE), ke);
    if (HAS_X)
      walk_rows<VEC, FTV, AGG_BATCH, true>(
          st, n, lane, warp, block_nodes, acc, c, p0 == 0,
          [&](int q) {
            return fok ? ld_row<VEC>(g + (base + st.lr[q]) * F + f)
                       : zero_row<VEC>();
          },
          [&](int q, const Row<VEC>& gl) {  // dmsg = bf(bf(w) bf(g))
            const Row<VEC> gr =
                std::is_same<T, float>::value ? round_row(gl) : gl;
            const float wq = st.w[q];
            if (wq == 1.f) return gr;  // bf(1 * bf(g)) is bf(g); the same
                                       // in every lane
            Row<VEC> dm;
#pragma unroll
            for (int j = 0; j < VEC; ++j) dm.v[j] = wq * gr.v[j];
            return round_row(dm);
          });
    if constexpr (!HAS_EIN) continue;
    // dW += bf(ein)^T dmsg over the pass, 16 slots a step, DW_U steps'
    // g loads in flight; this lane's slots of a step: tig * 2 + {0, 1, 8, 9}
    for (int s0 = 0; s0 < n; s0 += 16 * DW_U) {
      Row<NTW> gv[DW_U][4];
      float wq[DW_U][4];
      bool any[DW_U], ones = true;
#pragma unroll
      for (int u = 0; u < DW_U; ++u) {
        bool mine = false;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = s0 + u * 16 + tig * 2 + (j & 1) + (j >> 1) * 8;
          const int r = q < n ? st.lr[q] : -1;
          mine |= r >= 0;
          wq[u][j] = r >= 0 ? st.w[q] : 0.f;
          ones &= wq[u][j] == 0.f || wq[u][j] == 1.f;
          gv[u][j] = r >= 0 && cok
                         ? ld_row16<NTW>(g + (base + r) * F + fw0 + fo)
                         : zero_row<NTW>();
        }
        any[u] = __any_sync(FULL_MASK, mine);
      }
      // dmsg = bf(bf(w) bf(g)) is bf(g) (or 0) where every weight is 0 or 1
      ones = __all_sync(FULL_MASK, ones);
#pragma unroll
      for (int u = 0; u < DW_U; ++u) {
        if (!any[u]) continue;  // the same in every lane
        const bf16* ec = et + s0 + u * 16 + tig * 2;
        unsigned af[4];  // A = bf(ein)^T: rows k = gid (+ 8), columns slots
        af[0] = *reinterpret_cast<const unsigned*>(ec + gid * ET_LD);
        af[1] = *reinterpret_cast<const unsigned*>(ec + (gid + 8) * ET_LD);
        af[2] = *reinterpret_cast<const unsigned*>(ec + gid * ET_LD + 8);
        af[3] = *reinterpret_cast<const unsigned*>(ec + (gid + 8) * ET_LD + 8);
        Row<NTW> dm[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dm[j] = gv[u][j];
          if (!ones) {
#pragma unroll
            for (int t = 0; t < NTW; ++t) dm[j].v[t] *= wq[u][j];
            dm[j] = round_row(dm[j]);
          }
        }
#pragma unroll
        for (int t = 0; t < NTW; ++t) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(part, af, pack2_bf16(dm[0].v[t], dm[1].v[t]),
                   pack2_bf16(dm[2].v[t], dm[3].v[t]));
#pragma unroll
          for (int i = 0; i < 4; ++i) dw[t][i] += part[i];
        }
      }
    }
  }
  __syncwarp();

  if (HAS_X && fok)
    for (int r = warp; r < block_nodes; r += AGG_WARPS)
      st_row(dx + (base + r) * F + f, ld_row<VEC>(acc + r * FTV + c));
  if (HAS_EIN)  // C fragment: rows k = gid (+ 8), columns tig * 2 (+ 1)
#pragma unroll
    for (int t = 0; t < NTW; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = gid + (i >> 1) * 8;
        const int col = (tig * 2 + (i & 1)) * NTW + t;
        if (k < K && col < FW && fw0 + col < F)
          dW_part[((ll)blockIdx.x * K + k) * F + fw0 + col] = dw[t][i];
      }
}

// ---- [ein] and [x+ein] forward: the edge terms on the tensor cores -------
//
// A slot's edge term sum_k bf(w_e ein_ek) bf(W_k) is a row of E [slots, 16]
// @ bf(W) [16, FTV] (K padded to 16), the product the Pallas body takes on
// the MXU. The owning warp forms the edge terms of 16 of its slots at a
// time on the tensor cores (mma.sync m16n8k16, W's B fragments held in
// registers for the whole kernel, E's A fragments from the pass's rounded
// rows) into a shared [16][FTV + MSG_PAD] tile of its own: rounded (the
// message) without x; in float32 with x, whose term bf(w) bf(x) (the 16
// slots' x rows loaded during the products) is added and the sum rounded
// as the walk takes the slot. The messages go into the rows' runs in slot
// order, as walk_rows does. Two features a lane at most: the tiles and the
// sums fit three CTAs an SM without x, two with.
constexpr int E16_LD = 24;  // bf16 a staged E row (16 used): A loads spread over banks
constexpr int MSG_PAD = 8;  // bf16 past a message row: its pairs spread over banks

int edge_fwd16_smem(int block_nodes, int K, int vec, bool has_x) {
  const int ftv = AGG_FT * vec;
  const int flat = AGG_STAGE * K * 4, e16 = AGG_STAGE * E16_LD * 2;
  return (block_nodes * ftv + AGG_STAGE * 3) * 4 + (flat > e16 ? flat : e16) +
         AGG_WARPS * 16 * (ftv + MSG_PAD) * (has_x ? 4 : 2) +
         2 * AGG_WARPS * AGG_STAGE;
}

template <bool HAS_X, int VEC, typename T>
__global__ void __launch_bounds__(AGG_THREADS, HAS_X ? 2 : 3)
spmm16_edge_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ein,
                      const float* __restrict__ W, const int* __restrict__ snd,
                      const int* __restrict__ rcv, const float* __restrict__ w,
                      T* __restrict__ out, int F, int K, int block_nodes,
                      int block_edges) {
  constexpr int FTV = AGG_FT * VEC, NT = FTV / 8, MLD = FTV + MSG_PAD;
  // with x the edge terms wait unrounded for bf(w) bf(x) in float32
  typedef typename std::conditional<HAS_X, float, bf16>::type M;
  extern __shared__ float smem[];
  float* acc = smem;  // [block_nodes][FTV]
  Staged st;
  st.w = acc + block_nodes * FTV;
  st.ls = reinterpret_cast<int*>(st.w + AGG_STAGE);
  st.lr = st.ls + AGG_STAGE;
  st.ein = reinterpret_cast<float*>(st.lr + AGG_STAGE);  // flat, then E16
  bf16* e16 = reinterpret_cast<bf16*>(st.ein);            // [slot][E16_LD]
  const int region = max(AGG_STAGE * K * 4, AGG_STAGE * E16_LD * 2);
  M* msg = reinterpret_cast<M*>(reinterpret_cast<char*>(st.ein) + region);
  st.list = reinterpret_cast<unsigned char*>(msg + AGG_WARPS * 16 * MLD);
  const int f0 = blockIdx.y * FTV;
  const int lane = threadIdx.x % AGG_FT, warp = threadIdx.x / AGG_FT;
  const int gid = lane / 4, tig = lane % 4;
  const int c = lane * VEC, f = f0 + c;
  const bool fok = f < F;
  const ll base = (ll)blockIdx.x * block_nodes;
  const ll e0 = (ll)blockIdx.x * block_edges;
  Fetched fe = fetch_slots(snd, rcv, w, ein, e0, 0,
                           min(AGG_STAGE, block_edges), K);
  // B = bf(W)[k][f0 + nt * 8 + gid], k = tig * 2 (+ 1), (+ 8)
  unsigned bw[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int fc = f0 + nt * 8 + gid;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = tig * 2 + (j & 1) + (j >> 1) * 8;
      v[j] = k < K && fc < F ? W[(ll)k * F + fc] : 0.f;
    }
    bw[nt][0] = pack_round2(v[0], v[1]);
    bw[nt][1] = pack_round2(v[2], v[3]);
  }
  for (int r = warp; r < block_nodes; r += AGG_WARPS)
    st_row(acc + r * FTV + c, zero_row<VEC>());
  M* mw = msg + warp * 16 * MLD;  // this warp's message tile

  for (int p0 = 0; p0 < block_edges; p0 += AGG_STAGE) {
    const int n = min(AGG_STAGE, block_edges - p0);
    const int t = threadIdx.x;
    __syncthreads();
    put_slots(st, nullptr, fe, base, n, block_nodes, K);
    __syncthreads();
    float ev[AGG_MAX_K];  // slot t's bf(w ein_k), then its E row
#pragma unroll
    for (int k = 0; k < AGG_MAX_K; ++k)
      ev[k] = t < n && k < K ? round_bf16(fe.w * st.ein[t * K + k]) : 0.f;
    __syncthreads();  // the flat rows have been read: E overlays them
    if (t < n) {
      unsigned* er = reinterpret_cast<unsigned*>(e16 + t * E16_LD);
#pragma unroll
      for (int k = 0; k < AGG_MAX_K; k += 2) er[k / 2] = pack2_bf16(ev[k], ev[k + 1]);
    }
    __syncthreads();
    if (p0 + AGG_STAGE < block_edges)  // the next pass's, in flight
      fe = fetch_slots(snd, rcv, w, ein, e0, p0 + AGG_STAGE,
                       min(AGG_STAGE, block_edges - p0 - AGG_STAGE), K);
    unsigned char* list = st.list + (AGG_WARPS + warp) * AGG_STAGE;
    const int cnt = list_by_row<false>(st, n, lane, warp, block_nodes,
                                       st.list + warp * AGG_STAGE, list);
    int run_row = -1;
    Row<VEC> run = zero_row<VEC>();
    for (int i = 0; i < cnt; i += 16) {
      const int g = min(16, cnt - i);
      Row<VEC> xs[16];  // the 16 slots' x rows, in flight during the products
      if constexpr (HAS_X) {
#pragma unroll
        for (int u = 0; u < 16; ++u)
          xs[u] = u < g && fok
                      ? ld_row<VEC>(x + (base + st.ls[list[i + u]]) * F + f)
                      : zero_row<VEC>();
      }
      const unsigned* ea = reinterpret_cast<const unsigned*>(
          e16 + list[i + min(gid, g - 1)] * E16_LD);
      const unsigned* eb = reinterpret_cast<const unsigned*>(
          e16 + list[i + min(gid + 8, g - 1)] * E16_LD);
      const unsigned af[4] = {ea[tig], eb[tig], ea[tig + 4], eb[tig + 4]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float cc[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(cc, af, bw[nt][0], bw[nt][1]);
        M* m0 = mw + gid * MLD + nt * 8 + tig * 2;
        M* m1 = mw + (gid + 8) * MLD + nt * 8 + tig * 2;
        if constexpr (HAS_X) {
          *reinterpret_cast<float2*>(m0) = make_float2(cc[0], cc[1]);
          *reinterpret_cast<float2*>(m1) = make_float2(cc[2], cc[3]);
        } else {
          *reinterpret_cast<unsigned*>(m0) = pack_round2(cc[0], cc[1]);
          *reinterpret_cast<unsigned*>(m1) = pack_round2(cc[2], cc[3]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (u >= g) break;  // the same in every lane
        const int q = list[i + u];
        const int r = st.lr[q];
        Row<VEC> m = ld_row<VEC>(mw + u * MLD + c);
        if constexpr (HAS_X) {  // bf(edge term + bf(w) bf(x))
          const float wr = st.w[q];
          const Row<VEC> xr =
              std::is_same<T, float>::value ? round_row(xs[u]) : xs[u];
#pragma unroll
          for (int j = 0; j < VEC; ++j) m.v[j] = m.v[j] + wr * xr.v[j];
          m = round_row(m);
        }
        if (r != run_row) {
          if (run_row >= 0) st_row(acc + run_row * FTV + c, run);
          run = p0 == 0 ? zero_row<VEC>() : ld_row<VEC>(acc + r * FTV + c);
          run_row = r;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) run.v[j] += m.v[j];
      }
      __syncwarp();  // the tile is rewritten by the next 16
    }
    if (run_row >= 0) st_row(acc + run_row * FTV + c, run);
    __syncwarp();
  }
  __syncwarp();
  if (!fok) return;
  for (int r = warp; r < block_nodes; r += AGG_WARPS)
    st_row(out + (base + r) * F + f, ld_row<VEC>(acc + r * FTV + c));
}

template <bool HAS_X, bool HAS_EIN, typename T>
int fwd16(const void* x_, const float* ein, const float* W, const int* snd,
          const int* rcv, const float* w, void* out_, int N, int F, int K,
          int block_nodes, int block_edges, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  T* out = static_cast<T*>(out_);
  const int nb = N / block_nodes;
  if constexpr (HAS_EIN) {  // the edge terms on the tensor cores
    const bool two = row_vec(F, {HAS_X ? x : nullptr, out}, 2, sizeof(T)) ==
                         2 &&
                     edge_fwd16_smem(block_nodes, K, 2, HAS_X) <= MAX_SMEM16;
    const int smem = edge_fwd16_smem(block_nodes, K, two ? 2 : 1, HAS_X);
    auto kernel = two ? spmm16_edge_fwd_kernel<HAS_X, 2, T>
                      : spmm16_edge_fwd_kernel<HAS_X, 1, T>;
    return launch_edge_aggr(kernel, smem, nb, F, AGG_FT * (two ? 2 : 1), st,
                            x, ein, W, snd, rcv, w, out, F, K, block_nodes,
                            block_edges);
  } else {
    const int vec = vec16(F, {x, out}, sizeof(T), [&](int v) {
      return x_fwd16_smem(block_nodes, v);
    });
    auto kernel = vec == 4   ? spmm16_x_fwd_kernel<4, T>
                  : vec == 2 ? spmm16_x_fwd_kernel<2, T>
                             : spmm16_x_fwd_kernel<1, T>;
    return launch_edge_aggr(kernel, x_fwd16_smem(block_nodes, vec), nb, F,
                            AGG_FT * vec, st, x, snd, rcv, w, out, F,
                            block_nodes, block_edges);
  }
}

template <bool HAS_X, bool HAS_EIN, typename T>
int bwd16(const void* g_, const float* ein, const int* snd, const int* rcv,
          const float* w, void* dx_, float* dW_part, int N, int F, int K,
          int block_nodes, int block_edges, cudaStream_t st) {
  const T* g = static_cast<const T*>(g_);
  T* dx = static_cast<T*>(dx_);
  const int vec = vec16(F, {g, dx}, sizeof(T), [&](int v) {
    return bwd16_smem(block_nodes, v, HAS_X, HAS_EIN);
  });
  auto kernel = vec == 4   ? spmm16_bwd_kernel<HAS_X, HAS_EIN, 4, T>
                : vec == 2 ? spmm16_bwd_kernel<HAS_X, HAS_EIN, 2, T>
                           : spmm16_bwd_kernel<HAS_X, HAS_EIN, 1, T>;
  return launch_edge_aggr(kernel, bwd16_smem(block_nodes, vec, HAS_X, HAS_EIN),
                          N / block_nodes, F, AGG_FT * vec, st, g, ein, snd,
                          rcv, w, dx, dW_part, F, K, block_nodes,
                          block_edges);
}

template <bool HAS_X, bool HAS_EIN>
int fwd16_rows(bool rows, const void* x, const float* ein, const float* W,
               const int* snd, const int* rcv, const float* w, void* out,
               int N, int F, int K, int block_nodes, int block_edges,
               cudaStream_t st) {
  return (rows ? fwd16<HAS_X, HAS_EIN, bf16> : fwd16<HAS_X, HAS_EIN, float>)(
      x, ein, W, snd, rcv, w, out, N, F, K, block_nodes, block_edges, st);
}

template <bool HAS_X, bool HAS_EIN>
int bwd16_rows(bool rows, const void* g, const float* ein, const int* snd,
               const int* rcv, const float* w, void* dx, float* dW_part,
               int N, int F, int K, int block_nodes, int block_edges,
               cudaStream_t st) {
  return (rows ? bwd16<HAS_X, HAS_EIN, bf16> : bwd16<HAS_X, HAS_EIN, float>)(
      g, ein, snd, rcv, w, dx, dW_part, N, F, K, block_nodes, block_edges,
      st);
}

}  // namespace

// The bfloat16 forward: pgt_spmm_fwd's arguments (spmm.cu has checked
// them), out in the rows' dtype.
extern "C" int pgt_spmm_fwd_bf16(const void* x, const float* ein,
                                 const float* W, const int* snd,
                                 const int* rcv, const float* w, void* out,
                                 int N, int F, int K, int block_nodes,
                                 int block_edges, int has_x, int has_ein,
                                 int bf16_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool r = bf16_rows;
  K = has_ein ? K : 0;
  if (has_x && has_ein)
    return fwd16_rows<true, true>(r, x, ein, W, snd, rcv, w, out, N, F, K, block_nodes, block_edges, st);
  if (has_x)
    return fwd16_rows<true, false>(r, x, ein, W, snd, rcv, w, out, N, F, K, block_nodes, block_edges, st);
  return fwd16_rows<false, true>(r, x, ein, W, snd, rcv, w, out, N, F, K, block_nodes, block_edges, st);
}

// The bfloat16 backward: dx (has_x) and the blocks' dW partials
// [N / block_nodes][K][F] (has_ein), which spmm.cu then sums.
extern "C" int pgt_spmm_bwd_bf16(const void* g, const float* ein,
                                 const int* snd, const int* rcv,
                                 const float* w, void* dx, float* dW_part,
                                 int N, int F, int K, int block_nodes,
                                 int block_edges, int has_x, int has_ein,
                                 int bf16_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool r = bf16_rows;
  K = has_ein ? K : 0;
  if (has_x && has_ein)
    return bwd16_rows<true, true>(r, g, ein, snd, rcv, w, dx, dW_part, N, F, K, block_nodes, block_edges, st);
  if (has_x)
    return bwd16_rows<true, false>(r, g, ein, snd, rcv, w, dx, dW_part, N, F, K, block_nodes, block_edges, st);
  return bwd16_rows<false, true>(r, g, ein, snd, rcv, w, dx, dW_part, N, F, K, block_nodes, block_edges, st);
}
