// Host-side C++ of the port's input pipeline: the batch packer, the epoch
// planner and the block-aligned NegativeEdge rejection sampler. The port's
// own copy of pack_batch, pack_batch_blocked, plan_epoch, splitmix64,
// sample_negatives and sample_negatives_blocked of
// pretrain_gnns_tpu/native/packer.cpp, with the same outputs, and plan_pair_epoch, context prediction's two-stream walk
// (the JAX package walks it in Python, DeviceContextLoader._iter_blocked).
//
// The dataset is stored flat: graph i's nodes are rows [node_off[i],
// node_off[i + 1]) of the node arrays and its edges rows [edge_off[i],
// edge_off[i + 1]) of the edge arrays, with graph-local endpoints. Features
// are copied as raw bytes, whatever their dtype.
//
// The Python side (native/__init__.py) checks every length and dtype: the
// functions here trust their pointers.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Outputs of one packed batch; the caller allocates them.
struct Out {
  uint8_t* node_feat;
  uint8_t* edge_feat;
  int32_t* send;
  int32_t* recv;
  int32_t* node_graph;
  uint8_t* node_mask;
  uint8_t* edge_mask;
  uint8_t* graph_mask;
};

void zero(const Out& o, int64_t max_nodes, int64_t max_edges,
          int64_t max_graphs, int64_t fn_bytes, int64_t fe_bytes) {
  std::memset(o.node_feat, 0, (size_t)(max_nodes * fn_bytes));
  std::memset(o.edge_feat, 0, (size_t)(max_edges * fe_bytes));
  std::memset(o.send, 0, (size_t)max_edges * sizeof(int32_t));
  std::memset(o.recv, 0, (size_t)max_edges * sizeof(int32_t));
  std::memset(o.node_graph, 0, (size_t)max_nodes * sizeof(int32_t));
  std::memset(o.node_mask, 0, (size_t)max_nodes);
  std::memset(o.edge_mask, 0, (size_t)max_edges);
  std::memset(o.graph_mask, 0, (size_t)max_graphs);
}

// Copies graph gi into batch slot g at node row n_cur and edge slot e_cur.
void place(const uint8_t* node_feat, const int64_t* node_off,
           const int32_t* recv, const int32_t* send,
           const uint8_t* edge_feat, const int64_t* edge_off, int64_t gi,
           int64_t g, int64_t n_cur, int64_t e_cur, int64_t fn_bytes,
           int64_t fe_bytes, const Out& o) {
  const int64_t n0 = node_off[gi], nn = node_off[gi + 1] - n0;
  const int64_t e0 = edge_off[gi], ne = edge_off[gi + 1] - e0;
  std::memcpy(o.node_feat + n_cur * fn_bytes, node_feat + n0 * fn_bytes,
              (size_t)(nn * fn_bytes));
  std::memcpy(o.edge_feat + e_cur * fe_bytes, edge_feat + e0 * fe_bytes,
              (size_t)(ne * fe_bytes));
  const int32_t off = (int32_t)n_cur;
  for (int64_t e = 0; e < ne; ++e) {
    o.recv[e_cur + e] = recv[e0 + e] + off;
    o.send[e_cur + e] = send[e0 + e] + off;
  }
  for (int64_t n = 0; n < nn; ++n) {
    o.node_graph[n_cur + n] = (int32_t)g;
    o.node_mask[n_cur + n] = 1;
  }
  std::memset(o.edge_mask + e_cur, 1, (size_t)ne);
  o.graph_mask[g] = 1;
}

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

// NegativeEdge for graph gid (n nodes): draw up to 5 * E uniform (a, b)
// node pairs and keep the first E / 2 that are not self-loops, not existing
// directed edges and not repeats, handing each kept (base + a, base + b) to
// emit, which returns false when its output is full. The stream is
// splitmix64 seeded per (batch seed, graph id), so a graph's pairs do not
// depend on the order in which the batch is assembled. Returns the number
// kept, or -1 if emit refused one.
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

// Packs graphs graph_ids[0 .. n_graphs) contiguously, in that order, into
// buffers of max_nodes rows, max_edges slots and max_graphs graph slots,
// which it zeroes first. fn_bytes / fe_bytes: bytes of one node / edge
// feature row. Returns 0, or -1 if the graphs overflow the buffers.
int pack_batch(const uint8_t* node_feat, const int64_t* node_off,
               const int32_t* recv, const int32_t* send,
               const uint8_t* edge_feat, const int64_t* edge_off,
               const int64_t* graph_ids, int64_t n_graphs, int64_t fn_bytes,
               int64_t fe_bytes, int64_t max_nodes, int64_t max_edges,
               int64_t max_graphs, uint8_t* out_node_feat,
               uint8_t* out_edge_feat, int32_t* out_send, int32_t* out_recv,
               int32_t* out_node_graph, uint8_t* out_node_mask,
               uint8_t* out_edge_mask, uint8_t* out_graph_mask) {
  if (n_graphs > max_graphs) return -1;
  const Out o{out_node_feat,  out_edge_feat, out_send,      out_recv,
              out_node_graph, out_node_mask, out_edge_mask, out_graph_mask};
  zero(o, max_nodes, max_edges, max_graphs, fn_bytes, fe_bytes);
  int64_t n_cur = 0, e_cur = 0;
  for (int64_t g = 0; g < n_graphs; ++g) {
    const int64_t gi = graph_ids[g];
    const int64_t nn = node_off[gi + 1] - node_off[gi];
    const int64_t ne = edge_off[gi + 1] - edge_off[gi];
    if (n_cur + nn > max_nodes || e_cur + ne > max_edges) return -1;
    place(node_feat, node_off, recv, send, edge_feat, edge_off, gi, g, n_cur,
          e_cur, fn_bytes, fe_bytes, o);
    n_cur += nn;
    e_cur += ne;
  }
  return 0;
}

// Block-diagonal layout: graph g goes into node and edge block block_of[g]
// (n_blocks blocks of block_nodes rows and block_edges slots), its rows
// after those of the block's earlier graphs. block_fill_n / block_fill_e
// [n_blocks] are scratch. Returns 0, or -1 on a block out of range or
// overflowed.
int pack_batch_blocked(
    const uint8_t* node_feat, const int64_t* node_off, const int32_t* recv,
    const int32_t* send, const uint8_t* edge_feat, const int64_t* edge_off,
    const int64_t* graph_ids, const int64_t* block_of, int64_t n_graphs,
    int64_t fn_bytes, int64_t fe_bytes, int64_t n_blocks,
    int64_t block_nodes, int64_t block_edges, int64_t max_graphs,
    uint8_t* out_node_feat, uint8_t* out_edge_feat, int32_t* out_send,
    int32_t* out_recv, int32_t* out_node_graph, uint8_t* out_node_mask,
    uint8_t* out_edge_mask, uint8_t* out_graph_mask, int64_t* block_fill_n,
    int64_t* block_fill_e) {
  if (n_graphs > max_graphs) return -1;
  const Out o{out_node_feat,  out_edge_feat, out_send,      out_recv,
              out_node_graph, out_node_mask, out_edge_mask, out_graph_mask};
  zero(o, n_blocks * block_nodes, n_blocks * block_edges, max_graphs,
       fn_bytes, fe_bytes);
  std::memset(block_fill_n, 0, (size_t)n_blocks * sizeof(int64_t));
  std::memset(block_fill_e, 0, (size_t)n_blocks * sizeof(int64_t));
  for (int64_t g = 0; g < n_graphs; ++g) {
    const int64_t gi = graph_ids[g];
    const int64_t b = block_of[g];
    if (b < 0 || b >= n_blocks) return -1;
    const int64_t nn = node_off[gi + 1] - node_off[gi];
    const int64_t ne = edge_off[gi + 1] - edge_off[gi];
    if (block_fill_n[b] + nn > block_nodes ||
        block_fill_e[b] + ne > block_edges)
      return -1;
    place(node_feat, node_off, recv, send, edge_feat, edge_off, gi, g,
          b * block_nodes + block_fill_n[b], b * block_edges + block_fill_e[b],
          fn_bytes, fe_bytes, o);
    block_fill_n[b] += nn;
    block_fill_e[b] += ne;
  }
  return 0;
}

// Plans an epoch: walks the graphs in order[0 .. n) once and gives each its
// batch and its first node row and edge slot in that batch, by greedy
// first-fit over n_blocks blocks of (block_nodes, block_edges). A graph
// that fits no block closes the batch early; batch_size graphs close it
// too. The standard layout is one block of (max_nodes, max_edges).
// lens_n / lens_e are indexed by graph id. Returns the number of batches,
// or -1 if one graph alone exceeds a block.
int64_t plan_epoch(const int64_t* lens_n, const int64_t* lens_e,
                   const int64_t* order, int64_t n, int64_t batch_size,
                   int64_t n_blocks, int64_t block_nodes, int64_t block_edges,
                   int32_t* out_batch, int32_t* out_nstart,
                   int32_t* out_estart) {
  std::vector<int64_t> fill_n((std::size_t)n_blocks, 0);
  std::vector<int64_t> fill_e((std::size_t)n_blocks, 0);
  auto reset = [&]() {
    std::fill(fill_n.begin(), fill_n.end(), 0);
    std::fill(fill_e.begin(), fill_e.end(), 0);
  };
  int64_t batch = 0, in_batch = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t nn = lens_n[order[i]], ne = lens_e[order[i]];
    int64_t placed = -1;
    for (int64_t b = 0; b < n_blocks; ++b) {
      if (fill_n[b] + nn <= block_nodes && fill_e[b] + ne <= block_edges) {
        placed = b;
        break;
      }
    }
    if (placed < 0) {  // the graph starts the next batch
      if (in_batch == 0 || nn > block_nodes || ne > block_edges) return -1;
      ++batch;
      in_batch = 0;
      reset();
      placed = 0;
    }
    out_batch[i] = (int32_t)batch;
    out_nstart[i] = (int32_t)(placed * block_nodes + fill_n[placed]);
    out_estart[i] = (int32_t)(placed * block_edges + fill_e[placed]);
    fill_n[placed] += nn;
    fill_e[placed] += ne;
    if (++in_batch == batch_size) {
      ++batch;
      in_batch = 0;
      reset();
    }
  }
  return in_batch ? batch + 1 : batch;
}

// Context prediction's joint first-fit over two streams (substructures and
// contexts), each with its own blocks: graph order[i] goes into the first
// block of each stream with room for it; when either stream has none, it
// starts the next batch (and a batch closes at batch_size graphs). lens_*
// are indexed by graph id; out_start holds, per ordered graph, its first
// node row and edge slot in the substructure stream, then in the context
// stream (4 values). Returns the number of batches, or -1 if a graph fits
// no empty block of a stream.
int64_t plan_pair_epoch(const int64_t* lens_n_s, const int64_t* lens_e_s,
                        const int64_t* lens_n_c, const int64_t* lens_e_c,
                        const int64_t* order, int64_t n, int64_t batch_size,
                        int64_t n_blocks_s, int64_t block_nodes_s,
                        int64_t block_edges_s, int64_t n_blocks_c,
                        int64_t block_nodes_c, int64_t block_edges_c,
                        int32_t* out_batch, int32_t* out_start) {
  struct Stream {
    const int64_t *lens_n, *lens_e;
    int64_t block_nodes, block_edges;
    std::vector<int64_t> fill_n, fill_e;
    int64_t fit(int64_t g) const {
      for (std::size_t b = 0; b < fill_n.size(); ++b)
        if (fill_n[b] + lens_n[g] <= block_nodes &&
            fill_e[b] + lens_e[g] <= block_edges)
          return (int64_t)b;
      return -1;
    }
  };
  Stream st[2] = {
      {lens_n_s, lens_e_s, block_nodes_s, block_edges_s,
       std::vector<int64_t>((std::size_t)n_blocks_s, 0),
       std::vector<int64_t>((std::size_t)n_blocks_s, 0)},
      {lens_n_c, lens_e_c, block_nodes_c, block_edges_c,
       std::vector<int64_t>((std::size_t)n_blocks_c, 0),
       std::vector<int64_t>((std::size_t)n_blocks_c, 0)}};
  auto reset = [&]() {
    for (Stream& s : st) {
      std::fill(s.fill_n.begin(), s.fill_n.end(), 0);
      std::fill(s.fill_e.begin(), s.fill_e.end(), 0);
    }
  };
  int64_t batch = 0, in_batch = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t g = order[i];
    int64_t b[2] = {st[0].fit(g), st[1].fit(g)};
    if (b[0] < 0 || b[1] < 0) {  // the graph starts the next batch
      if (in_batch == 0) return -1;
      ++batch;
      in_batch = 0;
      reset();
      b[0] = st[0].fit(g);
      b[1] = st[1].fit(g);
      if (b[0] < 0 || b[1] < 0) return -1;
    }
    out_batch[i] = (int32_t)batch;
    for (int k = 0; k < 2; ++k) {
      Stream& s = st[k];
      out_start[4 * i + 2 * k] =
          (int32_t)(b[k] * s.block_nodes + s.fill_n[(std::size_t)b[k]]);
      out_start[4 * i + 2 * k + 1] =
          (int32_t)(b[k] * s.block_edges + s.fill_e[(std::size_t)b[k]]);
      s.fill_n[(std::size_t)b[k]] += s.lens_n[g];
      s.fill_e[(std::size_t)b[k]] += s.lens_e[g];
    }
    if (++in_batch == batch_size) {
      ++batch;
      in_batch = 0;
      reset();
    }
  }
  return in_batch ? batch + 1 : batch;
}

// The compact layout: the pairs of every listed graph, in list order, into
// out_pairs [budget, 2] and out_mask [budget], which the caller zeroes.
// send/recv/edge_off/graph_ids/lens_n/nstarts as for the block-aligned
// layout below. Returns the number of pairs, or -1 when they overflow the
// budget.
int64_t sample_negatives(
    const int32_t* send, const int32_t* recv, const int64_t* edge_off,
    const int64_t* graph_ids, int64_t n_graphs, const int64_t* lens_n,
    const int64_t* nstarts, uint64_t seed, int64_t budget,
    int32_t* out_pairs, uint8_t* out_mask) {
  KeySet set;
  int64_t out = 0;
  auto emit = [&](int64_t a, int64_t b) {
    if (out >= budget) return false;
    out_pairs[2 * out] = (int32_t)a;
    out_pairs[2 * out + 1] = (int32_t)b;
    out_mask[out] = 1;
    ++out;
    return true;
  };
  for (int64_t i = 0; i < n_graphs; ++i) {
    if (sample_graph(send, recv, edge_off, graph_ids[i], lens_n[i],
                     nstarts[i], seed, &set, emit) < 0)
      return -1;
  }
  return out;
}

// The block-aligned layout: the pairs of graph i go to the region of
// block_edges / 2 slots of its block, estarts[i] / block_edges (estarts =
// the graph's first edge slot), so that a kernel can treat the pairs block
// by block. send/recv hold the graph-local endpoints of every graph's edges,
// graph g's at [edge_off[g], edge_off[g + 1]); graph_ids [n_graphs] index
// edge_off; lens_n and nstarts [n_graphs] give each listed graph's node
// count and first batch row. A block's graphs never need more than
// block_edges / 2 slots. out_pairs [n_blocks * (block_edges / 2), 2] and
// out_mask are zeroed by the caller. Returns the number of pairs, or -1 on
// a block out of range or overflow.
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
