// Blocked pair-dot scoring head (K3) for Hopper (sm_90a), forward and
// backward.
//
// Replaces the Pallas TPU kernel pretrain_gnns_tpu/ops/pallas_spmm.py
// (_edot_fwd_kernel and _edot_bwd_kernel via _edot_call, wrapped by the
// custom_vjp blocked_edge_dot). On the block-diagonal batch, for P =
// n_blocks * pairs_per_block pairs whose endpoints lie in their block:
//
//   score_p = w_p * <x[a_p], x[b_p]>
//
// Backward, with c_p = g_p * w_p:
//   dx_n = sum_{a_p = n} c_p * x[b_p] + sum_{b_p = n} c_p * x[a_p]
// and nothing for a, b and w.
//
// What bounds it on the card: at the edge-prediction path's shapes (chem
// N = 8,192 rows, F = 300, P = 24,576 or 12,288 pairs; bio N = 20,480,
// P = 61,440 or 30,720) a forward reads the x rows its valid pairs touch
// (7-18 MB) and a backward also writes dx [N, F] (10-25 MB), against at
// most 0.1 GFLOP: bytes, 2-13 us at 3.35 TB/s. A forward reads each row
// about three times over (once a pair), from L2, and about 2.4 us of it is
// the launch; a backward is set by how many dependent trips to memory a
// warp makes and how many row loads it keeps in flight, which registers
// bound.
//
// Design:
// - The TPU kernel gathered and scattered with one-hot matmuls on the MXU.
//   The forward gives a warp up to 32 consecutive pairs. Each lane loads
//   one pair's a, b and w in one coalesced trip, none waiting on another.
//   The warp then takes its pairs four a round, eight lanes a pair, and
//   loads the rows of FWD_DEPTH rounds (FWD_CHUNKS loads of VEC floats a
//   row and lane) before the first product; a shuffle tree over the eight
//   lanes sums each pair. A pair that mirrors the one before it (the
//   positive head's two directions of an edge, every valid odd slot of
//   the path's batches) reads no row and takes its partner's sum, the
//   same bits, so that head reads half the rows. The rounds a warp takes
//   follow P and the warps the card holds at once (every warp resident,
//   each as few trips as that allows). Loads are 16 B where F % 4 == 0 and
//   the rows 16-byte aligned, 8 B where F is even and the rows 8-byte
//   aligned, else 4 B (chosen on the host). The sum is taken in a fixed order, so the scores
//   are the same bits from run to run.
// - The backward is the row-owned, staged walk of edge_aggr.cuh: one CTA
//   per (node block, 32 * VEC-wide feature tile), VEC = 4, 2 or 1 as the
//   forward's loads where the block's tile fits shared memory; the
//   block's dx rows sit in a shared f32 tile, each warp the only writer
//   of the rows r with r % AGG_WARPS == warp. A pass stages AGG_STAGE / 2
//   pairs as two slots each, one a thread: slot 2i is pair i's a-side
//   (adds c * x[b] into row a), slot 2i + 1 its b-side (adds c * x[a] into
//   row b). Each warp lists the slots whose row it owns, in slot order,
//   and loads the x rows of up to AGG_BATCH of them, with their row and
//   c, before adding any. So every dx element is fmaf(c_p, x_other, acc)
//   over the same sides in pair order, the a-side first (a self-pair adds
//   twice into its row), starting from 0: no atomics, the same bits every
//   run, and the bits of the one-pair-a-time kernel this replaced. The
//   launch bound is two CTAs an SM (registers for the loads in flight)
//   where the grid fits the card at two, else three (unless three would
//   spill registers).
// - Padded pairs (w == 0, global index 0), pairs with a zero cotangent
//   (the odd edge slots of the positive head) and any pair with an
//   endpoint outside its block read no row and add nothing, so index 0
//   never reaches a row of another block's tile; a padded pair scores
//   exactly 0. Every row of the block is written once, so padded rows and
//   rows no live pair touches come out exactly 0 with no zeroing pass.
// - The shared tile is sized from block_nodes at launch (dynamic shared
//   memory, opted in above 48 KB up to the 227 KB a block may use), since
//   block_layout grows block_nodes to the largest graph; blocks too large
//   for a wider tile take a narrower one.
// - bfloat16: x and dx may be stored as bfloat16 (bf16_rows: 8-, 4- or
//   2-byte accesses by F and alignment), and with bf16_compute the kernels
//   round as the Pallas kernel at compute_dtype = bfloat16 does: the
//   forward multiplies the rows' bfloat16 values (exact in float32, summed
//   in float32; scores float32), the backward adds bf(c_p * bf(x_other))
//   for each side. These variants take the two-CTA launch only (one build
//   each, to keep nvcc's time down).

#include <cuda_runtime.h>

#include "edge_aggr.cuh"

namespace {

constexpr int FWD_THREADS = 64;  // two warps a CTA: the CTAs spread over all SMs
constexpr int FWD_WARPS = FWD_THREADS / AGG_FT;
constexpr int FWD_GROUP = 8;     // lanes a pair
constexpr int FWD_PAIRS = AGG_FT / FWD_GROUP;  // pairs a round
static_assert(FWD_PAIRS % 2 == 0, "a pair and its mirror share a round");
constexpr int FWD_CHUNKS = 5;    // loads of VEC floats a lane makes per row
constexpr int FWD_DEPTH = 2;     // rounds whose rows a warp loads at once
constexpr int MAX_SMEM = 232448; // 227 KB: a block's most on the H100

int bwd_smem(int block_nodes, int vec) {
  return edge_aggr_smem(block_nodes, 0, vec, true, false, false);
}

// A warp takes the per_warp = FWD_PAIRS * rounds pairs from p0, FWD_PAIRS a
// round and FWD_DEPTH rounds' rows in flight at once.
template <int VEC, typename T = float, bool BF = false>
__global__ void __launch_bounds__(FWD_THREADS)
edot_fwd_kernel(const T* __restrict__ x, const int* __restrict__ a,
                const int* __restrict__ b, const float* __restrict__ w,
                float* __restrict__ out, int P, int F, int block_nodes,
                int pairs_per_block, int rounds) {
  const int lane = threadIdx.x % AGG_FT;
  const int per_warp = FWD_PAIRS * rounds;
  const ll p0 = ((ll)blockIdx.x * FWD_WARPS + threadIdx.x / AGG_FT) * per_warp;
  if (p0 >= P) return;  // the whole warp leaves together
  // one pair a lane; ra = -1 marks a pair that reads no row
  const ll p = p0 + lane;
  int ra = -1, rb = -1;
  float wp = 0.f;
  if (lane < per_warp && p < P) {
    const int ai = a[p], bi = b[p];
    wp = w[p];
    const ll base = (p / pairs_per_block) * block_nodes;
    if (wp != 0.f && ai >= base && ai < base + block_nodes && bi >= base &&
        bi < base + block_nodes) {
      ra = ai;
      rb = bi;
    }
  }
  // A pair that mirrors the one before it (b, a after a, b: the positive
  // head's two directions of an edge) has the same dot product, bit for
  // bit, since fmaf is symmetric in its factors: it reads no row and takes
  // the sum of the group before it, which holds that pair in the same
  // round.
  const int pa = __shfl_up_sync(FULL_MASK, ra, 1);
  const int pb = __shfl_up_sync(FULL_MASK, rb, 1);
  const bool mirror = (lane & 1) && ra >= 0 && ra == pb && rb == pa;
  const int grp = lane / FWD_GROUP;
  const int gl = lane % FWD_GROUP;
#pragma unroll 1
  for (int q0 = 0; q0 < per_warp; q0 += FWD_PAIRS * FWD_DEPTH) {
    int src[FWD_DEPTH], qa[FWD_DEPTH], qb[FWD_DEPTH];
    bool mq[FWD_DEPTH];
    float s[FWD_DEPTH];
#pragma unroll
    for (int d = 0; d < FWD_DEPTH; ++d) {
      src[d] = q0 + d * FWD_PAIRS + grp;  // the lane that holds the pair
      qa[d] = __shfl_sync(FULL_MASK, ra, src[d] % AGG_FT);
      qb[d] = __shfl_sync(FULL_MASK, rb, src[d] % AGG_FT);
      mq[d] = __shfl_sync(FULL_MASK, mirror, src[d] % AGG_FT);
      if (src[d] >= per_warp || mq[d]) qa[d] = -1;
      s[d] = 0.f;
    }
    for (int f0 = gl * VEC; f0 < F; f0 += FWD_GROUP * VEC * FWD_CHUNKS) {
      Row<VEC> va[FWD_DEPTH][FWD_CHUNKS], vb[FWD_DEPTH][FWD_CHUNKS];
#pragma unroll
      for (int d = 0; d < FWD_DEPTH; ++d)
#pragma unroll
        for (int u = 0; u < FWD_CHUNKS; ++u) {
          const int f = f0 + u * FWD_GROUP * VEC;
          if (qa[d] >= 0 && f < F) {
            va[d][u] = ld_row_bf<VEC, BF>(x + (ll)qa[d] * F + f);
            vb[d][u] = ld_row_bf<VEC, BF>(x + (ll)qb[d] * F + f);
          }
        }
#pragma unroll
      for (int d = 0; d < FWD_DEPTH; ++d)
#pragma unroll
        for (int u = 0; u < FWD_CHUNKS; ++u)
          if (qa[d] >= 0 && f0 + u * FWD_GROUP * VEC < F)
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              s[d] = fmaf(va[d][u].v[j], vb[d][u].v[j], s[d]);
    }
#pragma unroll
    for (int d = 0; d < FWD_DEPTH; ++d) {
#pragma unroll
      for (int o = FWD_GROUP / 2; o > 0; o >>= 1)
        s[d] += __shfl_xor_sync(FULL_MASK, s[d], o);
      const float sp = __shfl_sync(FULL_MASK, s[d], (lane - FWD_GROUP) % AGG_FT);
      if (mq[d]) s[d] = sp;
      const float wq = __shfl_sync(FULL_MASK, wp, src[d] % AGG_FT);
      if (gl == 0 && src[d] < per_warp && p0 + src[d] < P)
        out[p0 + src[d]] = wq * s[d];
    }
  }
}

// Stages the two sides of pairs q0 .. q0 + n - 1 of the block whose first
// pair is e0, one side a thread: slot 2i is pair q0 + i's a-side (local
// sender b, local receiver a), slot 2i + 1 its b-side; both carry
// c = g * w, and -1 marks a side that adds nothing (c == 0 or an endpoint
// outside the block). Between two __syncthreads of the caller.
__device__ __forceinline__ void stage_sides(
    const Staged& s, const int* __restrict__ a, const int* __restrict__ b,
    const float* __restrict__ w, const float* __restrict__ g, ll e0, ll base,
    int q0, int n, int block_nodes) {
  const int t = threadIdx.x;
  const int i = t >> 1;
  int ls = -1, lr = -1;
  float c = 0.f;
  if (i < n) {
    const ll p = e0 + q0 + i;
    const float gp = g[p], wp = w[p];
    const ll ia = a[p] - base;
    const ll ib = b[p] - base;
    c = gp * wp;
    if (c != 0.f && ia >= 0 && ia < block_nodes && ib >= 0 &&
        ib < block_nodes) {
      ls = (int)((t & 1) ? ia : ib);
      lr = (int)((t & 1) ? ib : ia);
    }
  }
  s.ls[t] = ls;
  s.lr[t] = lr;
  s.w[t] = c;
}

template <int VEC, int MIN_CTAS, typename T = float, bool BF = false>
__global__ void __launch_bounds__(AGG_THREADS, MIN_CTAS)
edot_bwd_kernel(const T* __restrict__ x, const int* __restrict__ a,
                const int* __restrict__ b, const float* __restrict__ w,
                const float* __restrict__ g, T* __restrict__ dx, int F,
                int block_nodes, int pairs_per_block) {
  constexpr int FTV = AGG_FT * VEC;
  extern __shared__ float smem[];
  float *acc, *asum, *W_s;
  const Staged st = carve_walk(smem, block_nodes, 0, FTV, true, false, acc,
                               asum, W_s);
  const int blk = blockIdx.x;
  const int f0 = blockIdx.y * FTV;
  const int lane = threadIdx.x % AGG_FT;
  const int warp = threadIdx.x / AGG_FT;
  const int c = lane * VEC;  // the lane's first column of the tile
  const int f = f0 + c;
  const bool fok = f < F;
  // a warp zeroes, fills and reads only the rows it owns
  for (int r = warp; r < block_nodes; r += AGG_WARPS)
    st_row(acc + r * FTV + c, zero_row<VEC>());

  const ll base = (ll)blk * block_nodes;
  const ll e0 = (ll)blk * pairs_per_block;
  for (int q0 = 0; q0 < pairs_per_block; q0 += AGG_STAGE / 2) {
    const int n = min(AGG_STAGE / 2, pairs_per_block - q0);
    __syncthreads();  // the last pass's staging has been read
    stage_sides(st, a, b, w, g, e0, base, q0, n, block_nodes);
    __syncthreads();
    walk_staged<false>(
        st, 2 * n, lane, warp,
        [&](int q) {  // the other row, and the side's row and c = g * w
          return Slot<VEC>{
              fok ? ld_row_bf<VEC, BF>(x + (base + st.ls[q]) * F + f)
                  : zero_row<VEC>(),
              st.lr[q], st.w[q]};
        },
        [&](int, const Slot<VEC>& sd) {
          if (!fok) return;
          Row<VEC> s = ld_row<VEC>(acc + sd.r * FTV + c);
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            s.v[j] = BF ? s.v[j] + round_bf16(sd.w * sd.x.v[j])
                        : fmaf(sd.w, sd.x.v[j], s.v[j]);
          st_row(acc + sd.r * FTV + c, s);
        });
  }
  __syncwarp();

  if (!fok) return;
  for (int r = warp; r < block_nodes; r += AGG_WARPS)
    st_row(dx + (base + r) * F + f, ld_row<VEC>(acc + r * FTV + c));
}

bool bad_shape(int N, int F, int P, int block_nodes, int pairs_per_block) {
  return N <= 0 || F <= 0 || block_nodes <= 0 || pairs_per_block <= 0 ||
         N % block_nodes != 0 ||
         (ll)P != (ll)(N / block_nodes) * pairs_per_block;
}

// The forward's warps the card holds at once (one query a process and
// variant).
template <int VEC, typename T, bool BF>
ll fwd_resident_warps() {
  static ll warps = 0;
  if (warps == 0) {
    int ctas = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, edot_fwd_kernel<VEC, T, BF>, FWD_THREADS, 0);
    warps = (ll)sm_count() * ctas * FWD_WARPS;
  }
  return warps;
}

// Rounds a warp takes: as few as let every warp be resident at once (each
// round one dependent trip to memory), at most AGG_FT / FWD_PAIRS (one
// index load a lane).
template <int VEC, typename T = float, bool BF = false>
int launch_fwd(const T* x, const int* a, const int* b, const float* w,
               float* out, int F, int P, int block_nodes,
               int pairs_per_block, cudaStream_t st) {
  const ll cap = fwd_resident_warps<VEC, T, BF>() * FWD_PAIRS;
  int rounds = cap > 0 ? (int)((P + cap - 1) / cap) : AGG_FT / FWD_PAIRS;
  rounds = (rounds + FWD_DEPTH - 1) / FWD_DEPTH * FWD_DEPTH;
  rounds = max(FWD_DEPTH, min(rounds, AGG_FT / FWD_PAIRS));
  const ll per_warp = (ll)FWD_PAIRS * rounds;
  const ll warps = (P + per_warp - 1) / per_warp;
  const int grid = (int)((warps + FWD_WARPS - 1) / FWD_WARPS);
  edot_fwd_kernel<VEC, T, BF><<<grid, FWD_THREADS, 0, st>>>(
      x, a, b, w, out, P, F, block_nodes, pairs_per_block, rounds);
  return (int)cudaGetLastError();
}

// Registers against CTAs: two CTAs an SM (up to 128 registers a thread)
// or three (up to 85), as the header's launch_two_or_three chooses; the
// bfloat16 variants two.
template <int VEC, typename T = float, bool BF = false>
int launch_bwd(const T* x, const int* a, const int* b, const float* w,
               const float* g, T* dx, int N, int F, int block_nodes,
               int pairs_per_block, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value && !BF)
    return launch_two_or_three(edot_bwd_kernel<VEC, 2>,
                               edot_bwd_kernel<VEC, 3>,
                               bwd_smem(block_nodes, VEC), N / block_nodes,
                               F, AGG_FT * VEC, st, x, a, b, w, g, dx, F,
                               block_nodes, pairs_per_block);
  else
    return launch_edge_aggr(edot_bwd_kernel<VEC, 2, T, BF>,
                            bwd_smem(block_nodes, VEC), N / block_nodes, F,
                            AGG_FT * VEC, st, x, a, b, w, g, dx, F,
                            block_nodes, pairs_per_block);
}

template <typename T, bool BF>
int fwd_t(const void* x_, const int* a, const int* b, const float* w,
          float* out, int F, int P, int block_nodes, int pairs_per_block,
          cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  switch (row_vec(F, {x}, 4, sizeof(T))) {
    case 4:
      return launch_fwd<4, T, BF>(x, a, b, w, out, F, P, block_nodes,
                                  pairs_per_block, st);
    case 2:
      return launch_fwd<2, T, BF>(x, a, b, w, out, F, P, block_nodes,
                                  pairs_per_block, st);
    default:
      return launch_fwd<1, T, BF>(x, a, b, w, out, F, P, block_nodes,
                                  pairs_per_block, st);
  }
}

template <typename T, bool BF>
int bwd_t(const void* x_, const int* a, const int* b, const float* w,
          const float* g, void* dx_, int N, int F, int block_nodes,
          int pairs_per_block, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  T* dx = static_cast<T*>(dx_);
  const int vec = row_vec(F, {x, dx}, 4, sizeof(T));
  if (vec == 4 && bwd_smem(block_nodes, 4) <= MAX_SMEM)
    return launch_bwd<4, T, BF>(x, a, b, w, g, dx, N, F, block_nodes,
                                pairs_per_block, st);
  if (vec >= 2 && bwd_smem(block_nodes, 2) <= MAX_SMEM)
    return launch_bwd<2, T, BF>(x, a, b, w, g, dx, N, F, block_nodes,
                                pairs_per_block, st);
  return launch_bwd<1, T, BF>(x, a, b, w, g, dx, N, F, block_nodes,
                              pairs_per_block, st);
}

}  // namespace

extern "C" {

// Present since the entry points take (bf16_rows, bf16_compute).
int pgt_bf16_flags() { return 1; }

int pgt_edot_max_smem() { return MAX_SMEM; }
// Shared bytes of a backward launch at least (one feature a lane).
int pgt_edot_bwd_smem(int block_nodes) { return bwd_smem(block_nodes, 1); }

// Forward: writes out [P] (float) from x [N, F], a, b [P] (global row
// indices) and w [P]; P = (N / block_nodes) * pairs_per_block. x is
// bfloat16 with bf16_rows; bf16_compute rounds as the note above says.
// Returns the first CUDA error, 0 if none.
int pgt_edot_fwd(const void* x, const int* a, const int* b, const float* w,
                 float* out, int N, int F, int P, int block_nodes,
                 int pairs_per_block, int bf16_rows, int bf16_compute,
                 void* stream) {
  if (bad_shape(N, F, P, block_nodes, pairs_per_block))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto fn = bf16_rows ? (bf16_compute ? fwd_t<bf16, true> : fwd_t<bf16, false>)
                      : (bf16_compute ? fwd_t<float, true> : fwd_t<float, false>);
  return fn(x, a, b, w, out, F, P, block_nodes, pairs_per_block, st);
}

// Backward from the cotangent g [P] (float): writes every row of dx [N, F],
// stored as x is.
int pgt_edot_bwd(const void* x, const int* a, const int* b, const float* w,
                 const float* g, void* dx, int N, int F, int P,
                 int block_nodes, int pairs_per_block, int bf16_rows,
                 int bf16_compute, void* stream) {
  if (bad_shape(N, F, P, block_nodes, pairs_per_block) ||
      bwd_smem(block_nodes, 1) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto fn = bf16_rows ? (bf16_compute ? bwd_t<bf16, true> : bwd_t<bf16, false>)
                      : (bf16_compute ? bwd_t<float, true> : bwd_t<float, false>);
  return fn(x, a, b, w, g, dx, N, F, block_nodes, pairs_per_block, st);
}

}  // extern "C"
