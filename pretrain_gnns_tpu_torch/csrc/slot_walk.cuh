// Row ownership over a block's edge slots, shared by the blocked SpMM on a
// precomputed edge embedding (spmm_ee.cu, K6) and the fused GIN conv's
// aggregations (gin_conv.cu, K1).
//
// A CTA holds one node block's rows in shared memory. Each warp owns the
// rows r with r % warps == warp and is the only one to write them: the
// warp reads 32 edge slots at a time (one per lane, coalesced), ballots
// which of them touch a row it owns, and visits those in slot order. So a
// sum over a row's slots needs no atomics and is taken in the same order
// on every run. Everything here has internal linkage (an anonymous
// namespace), so each including source gets its own copy.

#pragma once

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

typedef long long ll;

// One slot per lane: the local sender and receiver of slot q of the block
// and its weight; ls = lr = -1 marks a slot that adds nothing (padded,
// w == 0, or an endpoint outside the block, so that a padded slot's global
// index 0 never reaches a row of another block's tile).
__device__ __forceinline__ void load_slot(
    const int* __restrict__ snd, const int* __restrict__ rcv,
    const float* __restrict__ w, ll e0, ll base, int q, int block_nodes,
    int block_edges, int& ls, int& lr, float& we) {
  ls = -1;
  lr = -1;
  we = 0.f;
  if (q >= block_edges) return;
  we = w[e0 + q];
  if (we == 0.f) return;
  const ll s = snd[e0 + q] - base;
  const ll r = rcv[e0 + q] - base;
  if (s < 0 || s >= block_nodes || r < 0 || r >= block_nodes) return;
  ls = (int)s;
  lr = (int)r;
}

// Calls visit(src, s, r, wq) in every lane, in slot order, for each slot of
// the 32-slot chunk whose row ``key`` (this lane's ls or lr; -1 for none)
// the warp owns; src is the slot's lane, s, r and wq its local sender,
// local receiver and weight. The loop is the same in every lane.
template <typename Visit>
__device__ __forceinline__ void walk_owned(int key, int ls, int lr, float we,
                                           int warp, int warps,
                                           Visit visit) {
  unsigned m = __ballot_sync(FULL_MASK, key >= 0 && key % warps == warp);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const int s = __shfl_sync(FULL_MASK, ls, src);
    const int r = __shfl_sync(FULL_MASK, lr, src);
    const float wq = __shfl_sync(FULL_MASK, we, src);
    visit(src, s, r, wq);
  }
}

}  // namespace
