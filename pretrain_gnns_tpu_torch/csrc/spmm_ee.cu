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
//   Here K6 gives one CTA a (node block, 32-wide feature tile) and keeps
//   the block's rows in a shared f32 tile, a lane per feature. Each warp
//   owns the rows r with r % WARPS == warp and is the only writer of those
//   rows: the warp reads 32 edge slots at a time (one per lane, coalesced),
//   ballots which of them touch a row it owns, and walks those in slot
//   order (slot_walk.cuh, shared with K1). So the sums need no atomics and
//   are taken in a fixed order: out and dx are the same bits from run to
//   run.
// - The backward walks the slots by sender in the same way; the owner of a
//   slot's sender row also writes the slot's dmsg row, and the slots that
//   add nothing get their zero row from the warp whose turn the chunk is.
//   dx and dmsg are each computed only when asked for (the concat form of
//   gather_scatter aggregates the edge embedding over an all-zero x that
//   needs no dx).
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
//   endpoint outside its block are skipped, so index 0 never reaches a row
//   of another block's tile; in a sorted block such slots sort to the
//   front (negative local receiver) or the back and add nothing. Every row
//   of out, dx and dmsg is written once, so padded rows and slots come out
//   exactly 0 and no output needs a zeroing pass.
// - The shared tile is sized from block_nodes at launch (dynamic shared
//   memory, opted in above 48 KB up to the 227 KB a block may use), since
//   block_layout grows block_nodes to the largest graph.

#include <cuda_runtime.h>

#include "edge_aggr.cuh"

namespace {

constexpr int FT = 32;                  // feature tile: one warp wide
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / FT;
constexpr int MAX_SMEM = 232448;        // 227 KB: a block's most on the H100
constexpr int DEFAULT_SMEM = 48 * 1024; // above this only after opting in
constexpr int SORTED_BATCH = 8;         // K7: slots whose rows a warp loads at once

int tile_smem(int block_nodes) {
  return block_nodes * FT * (int)sizeof(float);
}

int sorted_smem(int block_nodes, int block_edges) {
  return (3 * block_edges + 2 * block_nodes + 2) * (int)sizeof(int);
}

template <bool HAS_EE>
__global__ void __launch_bounds__(THREADS)
spmm_ee_fwd_kernel(const float* __restrict__ x, const float* __restrict__ ee,
                   const int* __restrict__ snd, const int* __restrict__ rcv,
                   const float* __restrict__ w, float* __restrict__ out,
                   int F, int block_nodes, int block_edges) {
  extern __shared__ float acc[];  // [block_nodes][FT]
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int lane = threadIdx.x % FT;
  const int warp = threadIdx.x / FT;
  const int f = f0 + lane;
  const bool fok = f < F;
  for (int i = threadIdx.x; i < block_nodes * FT; i += THREADS) acc[i] = 0.f;
  __syncthreads();

  const ll base = (ll)b * block_nodes;
  const ll e0 = (ll)b * block_edges;
  for (int q0 = 0; q0 < block_edges; q0 += FT) {
    int ls, lr;
    float we;
    load_slot(snd, rcv, w, e0, base, q0 + lane, block_nodes, block_edges, ls,
              lr, we);
    // this warp adds into the rows it owns, and no other warp does
    walk_owned(lr, ls, lr, we, warp, WARPS,
               [&](int src, int s, int r, float wq) {
                 if (!fok) return;
                 float v = x[(base + s) * F + f];
                 if (HAS_EE) v += ee[(e0 + q0 + src) * F + f];
                 acc[r * FT + lane] = fmaf(wq, v, acc[r * FT + lane]);
               });
  }
  __syncthreads();

  if (!fok) return;
  for (int r = warp; r < block_nodes; r += WARPS)
    out[(base + r) * F + f] = acc[r * FT + lane];
}

template <bool NEED_DX, bool NEED_DMSG>
__global__ void __launch_bounds__(THREADS)
spmm_ee_bwd_kernel(const float* __restrict__ g, const int* __restrict__ snd,
                   const int* __restrict__ rcv, const float* __restrict__ w,
                   float* __restrict__ dx, float* __restrict__ dmsg, int F,
                   int block_nodes, int block_edges) {
  extern __shared__ float acc[];  // [block_nodes][FT], with NEED_DX
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int lane = threadIdx.x % FT;
  const int warp = threadIdx.x / FT;
  const int f = f0 + lane;
  const bool fok = f < F;
  if (NEED_DX) {
    for (int i = threadIdx.x; i < block_nodes * FT; i += THREADS) acc[i] = 0.f;
    __syncthreads();
  }

  const ll base = (ll)b * block_nodes;
  const ll e0 = (ll)b * block_edges;
  for (int q0 = 0; q0 < block_edges; q0 += FT) {
    int ls, lr;
    float we;
    load_slot(snd, rcv, w, e0, base, q0 + lane, block_nodes, block_edges, ls,
              lr, we);
    if (NEED_DMSG) {
      // the slots that add nothing get exact zeros, from the warp whose
      // turn this chunk is
      unsigned z = __ballot_sync(FULL_MASK, q0 + lane < block_edges && ls < 0);
      if ((q0 / FT) % WARPS == warp && fok) {
        while (z) {
          const int src = __ffs(z) - 1;
          z &= z - 1;
          dmsg[(e0 + q0 + src) * F + f] = 0.f;
        }
      }
    }
    // the owner of a slot's sender row writes the slot's dmsg row too
    walk_owned(ls, ls, lr, we, warp, WARPS,
               [&](int src, int s, int r, float wq) {
                 if (!fok) return;
                 // rounded once as a product, then added: dx is the sum of
                 // the dmsg rows as written, the same bits whether dmsg is
                 // asked for or not (a contraction into an FMA would round
                 // the product only with dmsg)
                 const float dm = __fmul_rn(wq, g[(base + r) * F + f]);
                 if (NEED_DMSG) dmsg[(e0 + q0 + src) * F + f] = dm;
                 if (NEED_DX)
                   acc[s * FT + lane] = __fadd_rn(acc[s * FT + lane], dm);
               });
  }

  if (NEED_DX) {
    __syncthreads();
    if (!fok) return;
    for (int r = warp; r < block_nodes; r += WARPS)
      dx[(base + r) * F + f] = acc[r * FT + lane];
  }
}

template <bool HAS_EE, int VEC>
__global__ void __launch_bounds__(THREADS)
spmm_sorted_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ ee,
                       const int* __restrict__ snd,
                       const int* __restrict__ rcv,
                       const float* __restrict__ w, float* __restrict__ out,
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
          xv[u] = ld_row<VEC>(x + (base + sv[u]) * F + f);
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
          sum.v[j] = fmaf(wq, v, sum.v[j]);
        }
      }
    }
  }
  if (cur >= 0 && fok) st_row(out + (base + cur) * F + f, sum);
}

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  if (smem <= DEFAULT_SMEM) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, int N, int F, int block_nodes,
           cudaStream_t st, Args... args) {
  const int err = set_smem(kernel, smem);
  if (err) return err;
  dim3 grid(N / block_nodes, (F + FT - 1) / FT);
  kernel<<<grid, THREADS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// K7 with VEC features a lane (VEC = 2: F even, rows 8-byte aligned).
template <bool HAS_EE, int VEC>
int launch_sorted(const float* x, const float* ee, const int* snd,
                  const int* rcv, const float* w, float* out, int N, int F,
                  int block_nodes, int block_edges, cudaStream_t st) {
  return launch_edge_aggr(spmm_sorted_fwd_kernel<HAS_EE, VEC>,
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
int pgt_spmm_ee_smem(int block_nodes) { return tile_smem(block_nodes); }
int pgt_spmm_sorted_smem(int block_nodes, int block_edges) {
  return sorted_smem(block_nodes, block_edges);
}

// K6 forward: writes out [N, F] from x [N, F], ee [E, F] (read only with
// has_ee), snd, rcv [E] (global row indices) and w [E];
// E = (N / block_nodes) * block_edges. Returns the first CUDA error, 0 if
// none.
int pgt_spmm_ee_fwd(const float* x, const float* ee, const int* snd,
                    const int* rcv, const float* w, float* out, int N, int F,
                    int block_nodes, int block_edges, int has_ee,
                    void* stream) {
  const int smem = tile_smem(block_nodes);
  if (bad_shape(N, F, block_nodes, block_edges, smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (has_ee)
    return launch(spmm_ee_fwd_kernel<true>, smem, N, F, block_nodes, st, x,
                  ee, snd, rcv, w, out, F, block_nodes, block_edges);
  return launch(spmm_ee_fwd_kernel<false>, smem, N, F, block_nodes, st, x,
                ee, snd, rcv, w, out, F, block_nodes, block_edges);
}

// K6 backward from g [N, F]: writes every row of dx [N, F] (need_dx) and of
// dmsg [E, F] (need_dmsg); at least one of the two.
int pgt_spmm_ee_bwd(const float* g, const int* snd, const int* rcv,
                    const float* w, float* dx, float* dmsg, int N, int F,
                    int block_nodes, int block_edges, int need_dx,
                    int need_dmsg, void* stream) {
  const int smem = need_dx ? tile_smem(block_nodes) : 0;
  if (bad_shape(N, F, block_nodes, block_edges, smem) ||
      !(need_dx || need_dmsg))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (need_dx && need_dmsg)
    return launch(spmm_ee_bwd_kernel<true, true>, smem, N, F, block_nodes, st,
                  g, snd, rcv, w, dx, dmsg, F, block_nodes, block_edges);
  if (need_dx)
    return launch(spmm_ee_bwd_kernel<true, false>, smem, N, F, block_nodes,
                  st, g, snd, rcv, w, dx, dmsg, F, block_nodes, block_edges);
  return launch(spmm_ee_bwd_kernel<false, true>, smem, N, F, block_nodes, st,
                g, snd, rcv, w, dx, dmsg, F, block_nodes, block_edges);
}

// K7 forward: as pgt_spmm_ee_fwd, for receivers that ascend within each
// block of block_edges slots.
int pgt_spmm_sorted_fwd(const float* x, const float* ee, const int* snd,
                        const int* rcv, const float* w, float* out, int N,
                        int F, int block_nodes, int block_edges, int has_ee,
                        void* stream) {
  if (bad_shape(N, F, block_nodes, block_edges,
                sorted_smem(block_nodes, block_edges)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool two = row_vec(F, {x, has_ee ? ee : nullptr, out}, 2) == 2;
  if (has_ee)
    return two ? launch_sorted<true, 2>(x, ee, snd, rcv, w, out, N, F,
                                        block_nodes, block_edges, st)
               : launch_sorted<true, 1>(x, ee, snd, rcv, w, out, N, F,
                                        block_nodes, block_edges, st);
  return two ? launch_sorted<false, 2>(x, ee, snd, rcv, w, out, N, F,
                                       block_nodes, block_edges, st)
             : launch_sorted<false, 1>(x, ee, snd, rcv, w, out, N, F,
                                       block_nodes, block_edges, st);
}

}  // extern "C"
