// Blocked SpMM on a precomputed edge embedding (K6, forward and backward)
// and its receiver-sorted variant (K7, forward only) for Hopper (sm_90a).
//
// K6 replaces the Pallas TPU kernel pretrain_gnns_tpu/ops/pallas_spmm.py
// (_fwd_kernel via _call_fwd, _bwd_kernel via _call_bwd, wrapped by the
// custom_vjp blocked_spmm). On the block-diagonal batch:
//
//   out_r = sum_{rcv_e = r} w_e * (x[snd_e] + ee_e [has_ee])
//
// Backward, with dmsg_e = w_e * g[rcv_e] written for every edge slot:
//   dx_n  = sum_{snd_e = n} dmsg_e
//   dee_e = dmsg_e                      (has_ee)
//
// K7 replaces pretrain_gnns_tpu/ops/pallas_spmm_sorted.py
// (_sorted_fwd_kernel via sorted_blocked_spmm): the same forward under the
// contract that the receivers ascend within each block.
//
// What bounds them on the card: at the chem shapes (N = 8,192 rows,
// F = 300, 24,576 edge slots of which about 13.8 k are valid) a forward
// reads the x rows of the valid edges' senders, the ee rows of the valid
// edges and writes out [N, F], 33 MB; a backward reads g, writes dx [N, F]
// and dmsg [E, F], 46 MB; at most 0.02 GFLOP either way. So bytes
// (3.35 TB/s), about 0.010 and 0.014 ms; 0.029 and 0.035 ms at the bio
// shapes (N = 20,480, 61,440 slots).
//
// Design:
// - The TPU kernels gathered and scattered with one-hot matmuls on the MXU.
//   K6's forward and its dx are the staged, row-owned walk of
//   edge_aggr.cuh that K2 and K3's backward take: one CTA per (node block,
//   32 * VEC-wide feature tile), VEC = 4, 2 or 1 features a lane (F a
//   multiple of VEC, every row pointer 4 * VEC-byte aligned, the block's
//   tile within shared memory), each warp the only writer of the tile's
//   rows r with r % AGG_WARPS == warp. A warp lists the staged slots whose
//   row it owns (receiver forward, sender backward) in slot order and
//   loads the rows of up to AGG_BATCH of them (x and ee forward, g
//   backward) before adding any. Every row is summed in slot order with
//   the arithmetic of the one-slot-at-a-time walk this replaced: no
//   atomics, the same bits on every run and the same bits as before. Two
//   CTAs an SM where the grid fits at two or three would spill registers,
//   else three.
// - The backward's walk also writes dmsg: each slot's w * g row (rounded
//   as dx adds it) from the walk's add, and exact zeros for the slots that
//   add nothing, the warps taking the staged slots in turn. On the H100
//   this beat a pass over each stage that loads the g rows again, flat
//   dmsg CTAs in the same launch, and a dmsg kernel on a second stream
//   beside the walk (PERF.md section 6). Without dx (the concat form of
//   gather_scatter aggregates the edge embedding over an all-zero x that
//   needs no dx), dmsg is a kernel of its own, one VEC-wide piece a
//   thread, the array written front to back.
// - The TPU's sorted kernel formed a log-depth prefix sum over the block's
//   messages and subtracted two boundary rows per node, its answer to a
//   missing cumsum and to the MXU. On the card a sorted block is a
//   segmented reduction. K7 gives one CTA a (node block, 32 * VEC-wide
//   feature tile), two features a lane where F is even and the rows
//   8-byte aligned, and loads the block's slots (local receiver, local
//   sender or -1, weight) into shared memory once, coalesced. One parallel
//   pass marks where each receiver's run of slots starts and ends (slot i
//   starts a run where rl[i] != rl[i - 1]) and the span of slots whose
//   receiver lies in the block. The span splits into one range a warp,
//   each moved to the next start of a run, so that every run lies in one
//   range. A warp reads its range 32 slots at a time, a slot a lane,
//   ballots the slots that add (and each run's first slot), and walks
//   them SORTED_BATCH at a time, their metadata by shuffle: the x and ee
//   rows of a batch are loaded before any is added. Each run is summed in
//   slot order in a register, as v = x + ee and then fmaf(w, v, sum) from
//   0, and its row written once; rows without a run are written as 0. No
//   shared accumulator, no atomics, the same bits every run, and no
//   cancellation between large prefix sums. What bounds it is latency:
//   the staging trip, then one trip for each batch of a range.
// - Padded edge slots (w == 0, global index 0) and any slot with an
//   endpoint outside its block add nothing, so index 0 never reaches a row
//   of another block's tile; in a sorted block such slots sort to the
//   front (negative local receiver) or the back and add nothing. Every row
//   of out, dx and dmsg is written once, so padded rows and slots come out
//   exactly 0 and no output needs a zeroing pass.
// - bfloat16: the rows (x or g, ee, out or dx, dmsg) may be stored as
//   float or bfloat16 (T), and with BF (compute_dtype = bfloat16) the
//   kernels round where the Pallas bodies do, every sum in float32, through
//   edge_aggr.cuh's rounding loads (ld_row_bf) and row accesses. K6
//   forward: out_r = sum bf(w_e (bf(x[snd_e]) + ee_e)), ee unrounded;
//   backward: dmsg_e = w_e bf(g[rcv_e]) in the rows' dtype, dx_n = sum
//   bf(dmsg_e). K7: out_r = sum w_e (bf(x[snd_e]) + ee_e), the messages
//   summed unrounded in float32 as the body's prefix sums. With float32
//   compute bfloat16 rows are read widened and written rounded. The new
//   instantiations take two CTAs an SM; the float ones keep their launch.
// - K6's tile is sized from block_nodes at launch (dynamic shared memory,
//   opted in above 48 KB up to the 227 KB a block may use), since
//   block_layout grows block_nodes to the largest graph; blocks too large
//   for a wider tile take a narrower one.

#include <cuda_runtime.h>

#include <type_traits>

#include "edge_aggr.cuh"

namespace {

constexpr int FT = 32;                  // K7: feature tile, one warp wide
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / FT;
constexpr int MAX_SMEM = 232448;        // 227 KB: a block's most on the H100
constexpr int SORTED_BATCH = 8;         // K7: slots whose rows a warp loads at once

// Shared bytes of a K6 walk CTA: the block's tile, VEC features a lane,
// and the staging.
int walk_smem(int block_nodes, int vec) {
  return edge_aggr_smem(block_nodes, 0, vec, true, false, false);
}

int sorted_smem(int block_nodes, int block_edges) {
  return (3 * block_edges + 2 * block_nodes + 2) * (int)sizeof(int);
}

// K6's walk. Forward (src = x, out) by receiver: out_r = fmaf(w, x[s] +
// ee_e, out_r) over the row's slots in slot order. Backward (src = g,
// out = dx) by sender: dm = w * g[r] rounded, then dx_s = dx_s + dm, so
// that dx is the sum of the dmsg rows as written (a contraction into an
// FMA would differ from dmsg in its last bits); with dmsg, each slot's dm
// goes to its row of dmsg, and the slots that add nothing get exact zeros.
// Rows of type T; BF rounds as the note above says (forward out_r += bf(w
// (bf(x[s]) + ee)), backward dx_s += bf(w bf(g[r]))).
template <bool BWD, bool HAS_EE, int VEC, int MIN_CTAS, typename T = float,
          bool BF = false>
__global__ void __launch_bounds__(AGG_THREADS, MIN_CTAS)
spmm_ee_walk_kernel(const T* __restrict__ src, const T* __restrict__ ee,
                    const int* __restrict__ snd, const int* __restrict__ rcv,
                    const float* __restrict__ w, T* __restrict__ out,
                    T* __restrict__ dmsg, int F, int block_nodes,
                    int block_edges) {
  constexpr int FTV = AGG_FT * VEC;
  extern __shared__ float smem[];
  float *acc, *asum, *W_s;
  const Staged st =
      carve_walk(smem, block_nodes, 0, FTV, true, false, acc, asum, W_s);
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * FTV;
  const int lane = threadIdx.x % AGG_FT;
  const int warp = threadIdx.x / AGG_FT;
  const int c = lane * VEC;  // the lane's first column of the tile
  const int f = f0 + c;
  const bool fok = f < F;
  // a warp zeroes, fills and reads only the rows it owns
  for (int r = warp; r < block_nodes; r += AGG_WARPS)
    st_row(acc + r * FTV + c, zero_row<VEC>());

  const ll base = (ll)b * block_nodes;
  const ll e0 = (ll)b * block_edges;
  for (int p0 = 0; p0 < block_edges; p0 += AGG_STAGE) {
    const int n = min(AGG_STAGE, block_edges - p0);
    __syncthreads();  // the last pass's staging has been read
    stage_slots(st, snd, rcv, w, nullptr, e0, base, p0, n, block_nodes, 0);
    __syncthreads();
    if (BWD && dmsg && fok)
      for (int q = warp; q < n; q += AGG_WARPS)
        if (st.lr[q] < 0)
          st_row(dmsg + (e0 + p0 + q) * F + f, zero_row<VEC>());
    walk_staged<BWD>(
        st, n, lane, warp,
        [&](int q) {
          Slot<VEC> s;
          s.r = BWD ? st.ls[q] : st.lr[q];
          s.w = st.w[q];
          if (fok) {
            const int from = BWD ? st.lr[q] : st.ls[q];
            s.x = ld_row_bf<VEC, BF>(src + (base + from) * F + f);
            if (HAS_EE) s.e = ld_row<VEC>(ee + (e0 + p0 + q) * F + f);
          }
          return s;
        },
        [&](int q, const Slot<VEC>& s) {
          if (!fok) return;
          Row<VEC> a = ld_row<VEC>(acc + s.r * FTV + c), dm;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            if (BWD) {
              dm.v[j] = __fmul_rn(s.w, s.x.v[j]);
              a.v[j] = __fadd_rn(a.v[j], BF ? round_bf16(dm.v[j]) : dm.v[j]);
            } else {
              float v = s.x.v[j];
              if (HAS_EE) v += s.e.v[j];
              a.v[j] = BF ? a.v[j] + round_bf16(__fmul_rn(v, s.w))
                          : fmaf(s.w, v, a.v[j]);
            }
          }
          if (BWD && dmsg) st_row(dmsg + (e0 + p0 + q) * F + f, dm);
          st_row(acc + s.r * FTV + c, a);
        });
  }
  __syncwarp();

  if (!fok) return;
  for (int r = warp; r < block_nodes; r += AGG_WARPS)
    st_row(out + (base + r) * F + f, ld_row<VEC>(acc + r * FTV + c));
}

// dmsg [E, F] alone, one VEC-wide piece a thread, the array written front
// to back: w * g[rcv] (rounded as dx adds it; BF: w * bf(g[rcv])) or, for
// a slot that adds nothing (stage_slots' rule), exact zeros.
template <int VEC, typename T = float, bool BF = false>
__global__ void __launch_bounds__(AGG_THREADS)
spmm_ee_dmsg_kernel(const T* __restrict__ g, const int* __restrict__ snd,
                    const int* __restrict__ rcv, const float* __restrict__ w,
                    T* __restrict__ dmsg, int F, int block_nodes,
                    int block_edges, ll pieces) {
  const ll i = blockIdx.x * (ll)AGG_THREADS + threadIdx.x;
  if (i >= pieces) return;
  const int cols = F / VEC;
  const ll e = i / cols;
  const ll base = e / block_edges * block_nodes;
  const float we = w[e];
  const ll s = snd[e] - base, r = rcv[e] - base;
  Row<VEC> d = zero_row<VEC>();
  if (we != 0.f && s >= 0 && s < block_nodes && r >= 0 && r < block_nodes) {
    const Row<VEC> gr = ld_row_bf<VEC, BF>(g + (base + r) * F + i % cols * VEC);
#pragma unroll
    for (int j = 0; j < VEC; ++j) d.v[j] = __fmul_rn(we, gr.v[j]);
  }
  st_row(dmsg + i * VEC, d);
}

// K7, rows of type T; BF: the gathered x rows rounded, the messages
// w (bf(x[s]) + ee) summed unrounded (a product, then an add).
template <bool HAS_EE, int VEC, typename T = float, bool BF = false>
__global__ void __launch_bounds__(THREADS)
spmm_sorted_fwd_kernel(const T* __restrict__ x,
                       const T* __restrict__ ee,
                       const int* __restrict__ snd,
                       const int* __restrict__ rcv,
                       const float* __restrict__ w, T* __restrict__ out,
                       int F, int block_nodes, int block_edges) {
  // the block's slots, loaded once and coalesced: local receivers
  // (ascending), local senders (-1 for a slot that adds nothing), weights;
  // each node's run of slots, run0[n] .. run1[n] - 1 (none: run1 < run0);
  // and the span of slots whose receiver lies in the block
  extern __shared__ int slots[];  // [3][block_edges], [2][block_nodes], [2]
  int* rl = slots;
  int* sl = slots + block_edges;
  float* wl = reinterpret_cast<float*>(slots + 2 * block_edges);
  int* run0 = slots + 3 * block_edges;
  int* run1 = run0 + block_nodes;
  int* span = run1 + block_nodes;
  constexpr int FTV = FT * VEC;
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * FTV;
  const int lane = threadIdx.x % FT;
  const int warp = threadIdx.x / FT;
  const int c = lane * VEC;
  const int f = f0 + c;
  const bool fok = f < F;  // VEC = 2 needs F even: a pair lies wholly inside
  const ll base = (ll)b * block_nodes;
  const ll e0 = (ll)b * block_edges;
  for (int i = threadIdx.x; i < block_edges; i += THREADS) {
    const float we = w[e0 + i];
    const ll s = snd[e0 + i] - base;
    rl[i] = (int)(rcv[e0 + i] - base);
    sl[i] = (we != 0.f && s >= 0 && s < block_nodes) ? (int)s : -1;
    wl[i] = we;
  }
  for (int n = threadIdx.x; n < block_nodes; n += THREADS) {
    run0[n] = 0;
    run1[n] = -1;
  }
  if (threadIdx.x < 2) span[threadIdx.x] = 0;
  __syncthreads();
  // one pass marks where each run and the span start and end; padded
  // slots (negative receivers, sorted to the front) belong to no run
  const auto in_block = [&](int r) { return r >= 0 && r < block_nodes; };
  for (int i = threadIdx.x; i < block_edges; i += THREADS) {
    const int r = rl[i];
    if (!in_block(r)) continue;
    const int prev = i > 0 ? rl[i - 1] : -1;
    const int next = i + 1 < block_edges ? rl[i + 1] : -1;
    if (prev != r) run0[r] = i;
    if (next != r) run1[r] = i + 1;
    if (!in_block(prev)) span[0] = i;
    if (!in_block(next)) span[1] = i + 1;
  }
  __syncthreads();

  // nodes without a run, padded rows among them, are written as 0
  for (int n0 = warp * FT; n0 < block_nodes; n0 += FT * WARPS) {
    const int n = n0 + lane;
    unsigned m = __ballot_sync(FULL_MASK, n < block_nodes && run1[n] < run0[n]);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      if (fok) st_row(out + (base + n0 + src) * F + f, zero_row<VEC>());
    }
  }

  // The span splits into WARPS ranges of about equal length, each moved
  // to the next start of a run, so that every run lies in one range: a
  // warp sums whole runs in slot order, in a register, and writes each
  // node's row once.
  const auto split = [&](int v) {
    const int first = span[0], last = span[1];
    if (v >= WARPS) return last;
    const int t = first + (int)((ll)(last - first) * v / WARPS);
    const int r = t > first && t < last ? rl[t] : -1;
    if (!in_block(r) || run0[r] == t) return t;
    return min(max(run1[r], t), last);
  };
  const int lo = split(warp), hi = split(warp + 1);
  int cur = -1;  // the node whose run is being summed
  Row<VEC> sum = zero_row<VEC>();
  for (int e = lo; e < hi; e += FT) {  // the same in every lane
    // a slot a lane; the walk visits the slots that add and the first
    // slot of each run (a run of slots that add nothing still writes 0)
    const int i = e + lane;
    const int my_r = i < hi ? rl[i] : -1;
    const int my_s = i < hi ? sl[i] : -1;
    const float my_w = i < hi ? wl[i] : 0.f;
    const bool starts = i < hi && (i == 0 || rl[i - 1] != my_r);
    unsigned m = __ballot_sync(FULL_MASK,
                               in_block(my_r) && (my_s >= 0 || starts));
    while (m) {  // SORTED_BATCH visited slots at a time
      int src[SORTED_BATCH];
#pragma unroll
      for (int u = 0; u < SORTED_BATCH; ++u) {
        src[u] = m ? __ffs(m) - 1 : FT;  // FT: none
        m &= m - 1;
      }
      int sv[SORTED_BATCH];
      Row<VEC> xv[SORTED_BATCH], ev[SORTED_BATCH];
#pragma unroll
      for (int u = 0; u < SORTED_BATCH; ++u) {
        sv[u] = __shfl_sync(FULL_MASK, my_s, src[u] % FT);
        if (src[u] < FT && sv[u] >= 0 && fok) {
          xv[u] = ld_row_bf<VEC, BF>(x + (base + sv[u]) * F + f);
          if (HAS_EE) ev[u] = ld_row<VEC>(ee + (e0 + e + src[u]) * F + f);
        }
      }
#pragma unroll
      for (int u = 0; u < SORTED_BATCH; ++u) {
        const int r = __shfl_sync(FULL_MASK, my_r, src[u] % FT);
        const float wq = __shfl_sync(FULL_MASK, my_w, src[u] % FT);
        if (src[u] == FT) continue;
        if (r != cur) {
          if (cur >= 0 && fok) st_row(out + (base + cur) * F + f, sum);
          cur = r;
          sum = zero_row<VEC>();
        }
        if (sv[u] < 0 || !fok) continue;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float v = xv[u].v[j];
          if (HAS_EE) v += ev[u].v[j];
          sum.v[j] = BF ? sum.v[j] + __fmul_rn(wq, v) : fmaf(wq, v, sum.v[j]);
        }
      }
    }
  }
  if (cur >= 0 && fok) st_row(out + (base + cur) * F + f, sum);
}

// Calls fn(std::integral_constant<int, VEC>()) for vec = 4, 2 or 1.
template <typename Fn>
int with_vec(int vec, Fn fn) {
  if (vec == 4) return fn(std::integral_constant<int, 4>());
  if (vec == 2) return fn(std::integral_constant<int, 2>());
  return fn(std::integral_constant<int, 1>());
}

// Calls fn(Tag<T>(), integral_constant<bool, BF>()) for the rows' type
// (bfloat16 with rows) and the compute dtype (bfloat16 with bf).
template <typename T>
struct Tag {
  using type = T;
};

template <typename Fn>
int with_types(bool rows, bool bf, Fn fn) {
  using B0 = std::integral_constant<bool, false>;
  using B1 = std::integral_constant<bool, true>;
  if (rows) return bf ? fn(Tag<bf16>(), B1()) : fn(Tag<bf16>(), B0());
  return bf ? fn(Tag<float>(), B1()) : fn(Tag<float>(), B0());
}

// Launches K6's walk with VEC features a lane, the widest that the rows
// allow (row_vec) and whose tile fits shared memory; the float kernels two
// or three CTAs an SM (launch_two_or_three), the others two.
template <bool BWD, bool HAS_EE, typename T, bool BF>
int launch_walk(const T* src, const T* ee, const int* snd, const int* rcv,
                const float* w, T* out, T* dmsg, int N, int F,
                int block_nodes, int block_edges, cudaStream_t st) {
  int vec = row_vec(F, {src, ee, out, dmsg}, 4, (int)sizeof(T));
  while (vec > 1 && walk_smem(block_nodes, vec) > MAX_SMEM) vec /= 2;
  return with_vec(vec, [&](auto v) {
    constexpr int VEC = decltype(v)::value;
    if constexpr (std::is_same<T, float>::value && !BF)
      return launch_two_or_three(
          spmm_ee_walk_kernel<BWD, HAS_EE, VEC, 2>,
          spmm_ee_walk_kernel<BWD, HAS_EE, VEC, 3>,
          walk_smem(block_nodes, VEC), N / block_nodes, F, AGG_FT * VEC, st,
          src, ee, snd, rcv, w, out, dmsg, F, block_nodes, block_edges);
    else
      return launch_edge_aggr(
          spmm_ee_walk_kernel<BWD, HAS_EE, VEC, 2, T, BF>,
          walk_smem(block_nodes, VEC), N / block_nodes, F, AGG_FT * VEC, st,
          src, ee, snd, rcv, w, out, dmsg, F, block_nodes, block_edges);
  });
}

template <typename T, bool BF>
int launch_dmsg(const T* g, const int* snd, const int* rcv, const float* w,
                T* dmsg, int N, int F, int block_nodes, int block_edges,
                cudaStream_t st) {
  return with_vec(row_vec(F, {g, dmsg}, 4, (int)sizeof(T)), [&](auto v) {
    constexpr int VEC = decltype(v)::value;
    const ll pieces = (ll)(N / block_nodes) * block_edges * (F / VEC);
    const unsigned ctas = (unsigned)((pieces + AGG_THREADS - 1) / AGG_THREADS);
    spmm_ee_dmsg_kernel<VEC, T, BF><<<ctas, AGG_THREADS, 0, st>>>(
        g, snd, rcv, w, dmsg, F, block_nodes, block_edges, pieces);
    return (int)cudaGetLastError();
  });
}

// K7 with VEC features a lane (VEC = 2: F even, rows 2 * VEC-byte aligned).
template <bool HAS_EE, int VEC, typename T, bool BF>
int launch_sorted(const T* x, const T* ee, const int* snd, const int* rcv,
                  const float* w, T* out, int N, int F, int block_nodes,
                  int block_edges, cudaStream_t st) {
  return launch_edge_aggr(spmm_sorted_fwd_kernel<HAS_EE, VEC, T, BF>,
                          sorted_smem(block_nodes, block_edges),
                          N / block_nodes, F, FT * VEC, st, x, ee, snd, rcv,
                          w, out, F, block_nodes, block_edges);
}

bool bad_shape(int N, int F, int block_nodes, int block_edges, int smem) {
  return block_nodes <= 0 || block_edges <= 0 || N <= 0 || F <= 0 ||
         N % block_nodes != 0 || smem > MAX_SMEM;
}

}  // namespace

extern "C" {

int pgt_spmm_ee_max_smem() { return MAX_SMEM; }
// Shared bytes of a K6 launch with out or dx at least (one feature a lane).
int pgt_spmm_ee_smem(int block_nodes) { return walk_smem(block_nodes, 1); }
int pgt_spmm_sorted_smem(int block_nodes, int block_edges) {
  return sorted_smem(block_nodes, block_edges);
}

// Present since the entry points take (bf16_rows, bf16_compute).
int pgt_spmm_ee_bf16_flags() { return 1; }

// K6 forward: writes out [N, F] from x [N, F], ee [E, F] (read only with
// has_ee), snd, rcv [E] (global row indices) and w [E];
// E = (N / block_nodes) * block_edges. x, ee and out are bfloat16 with
// bf16_rows, else float; bf16_compute: the bfloat16 variant. Returns the
// first CUDA error, 0 if none.
int pgt_spmm_ee_fwd(const void* x, const void* ee, const int* snd,
                    const int* rcv, const float* w, void* out, int N, int F,
                    int block_nodes, int block_edges, int has_ee,
                    int bf16_rows, int bf16_compute, void* stream) {
  if (bad_shape(N, F, block_nodes, block_edges, walk_smem(block_nodes, 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return with_types(bf16_rows, bf16_compute, [&](auto t, auto b) {
    using T = typename decltype(t)::type;
    constexpr bool BF = decltype(b)::value;
    const T* xs = static_cast<const T*>(x);
    T* o = static_cast<T*>(out);
    if (has_ee)
      return launch_walk<false, true, T, BF>(
          xs, static_cast<const T*>(ee), snd, rcv, w, o, nullptr, N, F,
          block_nodes, block_edges, st);
    return launch_walk<false, false, T, BF>(xs, nullptr, snd, rcv, w, o,
                                            nullptr, N, F, block_nodes,
                                            block_edges, st);
  });
}

// K6 backward from g [N, F]: writes every row of dx [N, F] (need_dx) and of
// dmsg [E, F] (need_dmsg); at least one of the two. g, dx and dmsg are
// bfloat16 with bf16_rows, else float; bf16_compute: the bfloat16 variant.
int pgt_spmm_ee_bwd(const void* g, const int* snd, const int* rcv,
                    const float* w, void* dx, void* dmsg, int N, int F,
                    int block_nodes, int block_edges, int need_dx,
                    int need_dmsg, int bf16_rows, int bf16_compute,
                    void* stream) {
  if (bad_shape(N, F, block_nodes, block_edges,
                need_dx ? walk_smem(block_nodes, 1) : 0) ||
      !(need_dx || need_dmsg))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return with_types(bf16_rows, bf16_compute, [&](auto t, auto b) {
    using T = typename decltype(t)::type;
    constexpr bool BF = decltype(b)::value;
    const T* gs = static_cast<const T*>(g);
    T* dm = static_cast<T*>(dmsg);
    if (!need_dx)
      return launch_dmsg<T, BF>(gs, snd, rcv, w, dm, N, F, block_nodes,
                                block_edges, st);
    return launch_walk<true, false, T, BF>(
        gs, nullptr, snd, rcv, w, static_cast<T*>(dx),
        need_dmsg ? dm : nullptr, N, F, block_nodes, block_edges, st);
  });
}

// K7 forward: as pgt_spmm_ee_fwd, for receivers that ascend within each
// block of block_edges slots.
int pgt_spmm_sorted_fwd(const void* x, const void* ee, const int* snd,
                        const int* rcv, const float* w, void* out, int N,
                        int F, int block_nodes, int block_edges, int has_ee,
                        int bf16_rows, int bf16_compute, void* stream) {
  if (bad_shape(N, F, block_nodes, block_edges,
                sorted_smem(block_nodes, block_edges)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return with_types(bf16_rows, bf16_compute, [&](auto t, auto b) {
    using T = typename decltype(t)::type;
    constexpr bool BF = decltype(b)::value;
    const T* xs = static_cast<const T*>(x);
    const T* es = has_ee ? static_cast<const T*>(ee) : nullptr;
    T* o = static_cast<T*>(out);
    const bool two = row_vec(F, {xs, es, o}, 2, (int)sizeof(T)) == 2;
    if (has_ee)
      return two ? launch_sorted<true, 2, T, BF>(xs, es, snd, rcv, w, o, N, F,
                                                 block_nodes, block_edges, st)
                 : launch_sorted<true, 1, T, BF>(xs, es, snd, rcv, w, o, N, F,
                                                 block_nodes, block_edges, st);
    return two ? launch_sorted<false, 2, T, BF>(xs, nullptr, snd, rcv, w, o,
                                                N, F, block_nodes,
                                                block_edges, st)
               : launch_sorted<false, 1, T, BF>(xs, nullptr, snd, rcv, w, o,
                                                N, F, block_nodes,
                                                block_edges, st);
  });
}

}  // extern "C"
