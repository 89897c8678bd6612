// NegativeEdge rejection sampling for one packed batch: the port's own
// copy of splitmix64 and sample_negatives_blocked of
// pretrain_gnns_tpu/native/packer.cpp, with the same streams and outputs.
// (That file's compact sample_negatives waits for a caller in the port.)
//
// Per graph: draw up to 5 * E uniform (a, b) node pairs and keep the first
// E / 2 that are not self-loops, not existing directed edges and not
// repeats; emit them as batch rows (nstarts + local index).
//
// RNG: splitmix64 seeded per (batch seed, graph id), so a graph's stream
// does not depend on the order in which the batch is assembled.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

// Open-addressing set over int64 keys (a * n + b), reset for each graph.
class KeySet {
 public:
  void reset(int64_t need) {
    std::size_t c = 16;
    while ((int64_t)c < need) c <<= 1;
    table_.assign(c, -1);
    mask_ = (uint64_t)(c - 1);
  }
  bool insert(int64_t key) {  // false if already present
    uint64_t h = (uint64_t)key * 0x9e3779b97f4a7c15ull;
    uint64_t p = (h ^ (h >> 29)) & mask_;
    while (table_[p] != -1) {
      if (table_[p] == key) return false;
      p = (p + 1) & mask_;
    }
    table_[p] = key;
    return true;
  }

 private:
  std::vector<int64_t> table_;
  uint64_t mask_ = 0;
};

// Samples graph i's negatives and hands each accepted (row_a, row_b) to
// emit, which returns false when its output is full. Returns the number
// accepted, or -1 if emit refused one.
template <typename Emit>
int64_t sample_graph(const int32_t* send, const int32_t* recv,
                     const int64_t* edge_off, int64_t gid, int64_t n,
                     int64_t base, uint64_t seed, KeySet* set, Emit emit) {
  const int64_t e0 = edge_off[gid], e1 = edge_off[gid + 1];
  const int64_t e = e1 - e0;
  const int64_t want = e / 2;
  if (want <= 0 || n <= 1) return 0;
  set->reset(2 * (e + want) + 8);  // the edges plus the accepted pairs
  for (int64_t k = e0; k < e1; ++k) set->insert((int64_t)send[k] * n + recv[k]);
  uint64_t st = seed ^ (0xd1342543de82ef95ull * (uint64_t)(gid + 1));
  int64_t got = 0;
  for (int64_t d = 0; d < 5 * e && got < want; ++d) {
    const uint64_t r = splitmix64(&st);
    const int64_t a = (int64_t)((r >> 32) % (uint64_t)n);
    const int64_t b = (int64_t)((r & 0xffffffffull) % (uint64_t)n);
    if (a == b) continue;
    if (!set->insert(a * n + b)) continue;  // existing edge or repeat
    if (!emit(base + a, base + b)) return -1;
    ++got;
  }
  return got;
}

}  // namespace

extern "C" {

// Block-aligned layout. send/recv hold the graph-local endpoints of every
// graph's edges, graph g's at [edge_off[g], edge_off[g + 1]); graph_ids
// [n_graphs] index edge_off; lens_n and nstarts [n_graphs] give each listed
// graph's node count and first batch row. Graph i's pairs go to the region
// of block_edges / 2 slots of its block, estarts[i] / block_edges (estarts =
// the graph's first edge slot), so that a kernel can treat the pairs block
// by block. A block's graphs never need more than block_edges / 2 slots.
// out_pairs [n_blocks * (block_edges / 2), 2] and out_mask are zeroed by the
// caller.
// Returns the number of pairs, or -1 on a block out of range or overflow.
int64_t sample_negatives_blocked(
    const int32_t* send, const int32_t* recv, const int64_t* edge_off,
    const int64_t* graph_ids, int64_t n_graphs, const int64_t* lens_n,
    const int64_t* nstarts, const int64_t* estarts, int64_t block_edges,
    int64_t n_blocks, uint64_t seed, int32_t* out_pairs, uint8_t* out_mask) {
  const int64_t half = block_edges / 2;
  std::vector<int64_t> cursor((std::size_t)n_blocks, 0);
  KeySet set;
  int64_t total = 0;
  for (int64_t i = 0; i < n_graphs; ++i) {
    const int64_t gid = graph_ids[i];
    if (edge_off[gid + 1] - edge_off[gid] < 2 || lens_n[i] <= 1) continue;
    const int64_t bk = estarts[i] / block_edges;
    if (bk < 0 || bk >= n_blocks) return -1;
    auto emit = [&](int64_t a, int64_t b) {
      if (cursor[bk] >= half) return false;
      const int64_t slot = bk * half + cursor[bk]++;
      out_pairs[2 * slot] = (int32_t)a;
      out_pairs[2 * slot + 1] = (int32_t)b;
      out_mask[slot] = 1;
      return true;
    };
    const int64_t got = sample_graph(send, recv, edge_off, gid, lens_n[i],
                                     nstarts[i], seed, &set, emit);
    if (got < 0) return -1;
    total += got;
  }
  return total;
}

}  // extern "C"
