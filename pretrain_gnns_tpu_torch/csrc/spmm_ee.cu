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
// Design (simple and right first; float4 rows and more loads in flight per
// warp are later work):
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
//   segmented reduction: K7 loads the block's slots (local receiver,
//   local sender, weight) into shared memory once, coalesced; a warp takes
//   a node, finds the node's run of slots by binary search, sums the run
//   in slot order in a register and writes the row once. No shared
//   accumulator, no atomics, the same bits every run, and no cancellation
//   between large prefix sums.
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

#include "slot_walk.cuh"

namespace {

constexpr int FT = 32;                  // feature tile: one warp wide
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / FT;
constexpr int MAX_SMEM = 232448;        // 227 KB: a block's most on the H100
constexpr int DEFAULT_SMEM = 48 * 1024; // above this only after opting in

int tile_smem(int block_nodes) {
  return block_nodes * FT * (int)sizeof(float);
}

int sorted_smem(int block_edges) {
  return 3 * block_edges * (int)sizeof(int);
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

template <bool HAS_EE>
__global__ void __launch_bounds__(THREADS)
spmm_sorted_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ ee,
                       const int* __restrict__ snd,
                       const int* __restrict__ rcv,
                       const float* __restrict__ w, float* __restrict__ out,
                       int F, int block_nodes, int block_edges) {
  // the block's slots, loaded once and coalesced: local receivers
  // (ascending), local senders (-1 for a slot that adds nothing), weights
  extern __shared__ int slots[];  // [3][block_edges]
  int* rl = slots;
  int* sl = slots + block_edges;
  float* wl = reinterpret_cast<float*>(slots + 2 * block_edges);
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int lane = threadIdx.x % FT;
  const int warp = threadIdx.x / FT;
  const int f = f0 + lane;
  const bool fok = f < F;
  const ll base = (ll)b * block_nodes;
  const ll e0 = (ll)b * block_edges;
  for (int i = threadIdx.x; i < block_edges; i += THREADS) {
    const float we = w[e0 + i];
    const ll s = snd[e0 + i] - base;
    rl[i] = (int)(rcv[e0 + i] - base);
    sl[i] = (we != 0.f && s >= 0 && s < block_nodes) ? (int)s : -1;
    wl[i] = we;
  }
  __syncthreads();

  for (int n = warp; n < block_nodes; n += WARPS) {
    // the node's run starts at the first slot whose receiver is >= n
    int lo = 0, hi = block_edges;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (rl[mid] < n) lo = mid + 1; else hi = mid;
    }
    float sum = 0.f;
    for (int e = lo; e < block_edges && rl[e] == n; ++e) {
      // every lane reads the same slot: the branch is warp-uniform
      const int s = sl[e];
      if (s < 0 || !fok) continue;
      float v = x[(base + s) * F + f];
      if (HAS_EE) v += ee[(e0 + e) * F + f];
      sum = fmaf(wl[e], v, sum);
    }
    if (fok) out[(base + n) * F + f] = sum;
  }
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

bool bad_shape(int N, int F, int block_nodes, int block_edges, int smem) {
  return block_nodes <= 0 || block_edges <= 0 || N <= 0 || F <= 0 ||
         N % block_nodes != 0 || smem > MAX_SMEM;
}

}  // namespace

extern "C" {

int pgt_spmm_ee_max_smem() { return MAX_SMEM; }
int pgt_spmm_ee_smem(int block_nodes) { return tile_smem(block_nodes); }
int pgt_spmm_sorted_smem(int block_edges) { return sorted_smem(block_edges); }

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
  const int smem = sorted_smem(block_edges);
  if (bad_shape(N, F, block_nodes, block_edges, smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (has_ee)
    return launch(spmm_sorted_fwd_kernel<true>, smem, N, F, block_nodes, st,
                  x, ee, snd, rcv, w, out, F, block_nodes, block_edges);
  return launch(spmm_sorted_fwd_kernel<false>, smem, N, F, block_nodes, st,
                x, ee, snd, rcv, w, out, F, block_nodes, block_edges);
}

}  // extern "C"
