// Fused GIN conv (K1) for Hopper (sm_90a), forward and backward.
//
// Replaces the Pallas TPU kernel pretrain_gnns_tpu/ops/pallas_gin.py
// (_fwd_kernel via _call_fwd, _bwd_kernel via _call_bwd, wrapped by the
// custom_vjp fused_gin_conv). One GIN layer on the block-diagonal batch:
//
//   msg_e  = w_e * (x[snd_e] + ein_e @ We)
//   aggr_i = sum_{rcv_e = i} msg_e + (x_i + e_self) * nm_i
//   z      = relu(aggr @ W1 + b1)          (saved for the backward)
//   out    = z @ W2 + b2
//
// Backward from the saved aggr and z (not recomputed):
//   dzr = (g @ W2^T) * (z > 0); dW2 = z^T g; db2 = sum g;
//   dW1 = aggr^T dzr; db1 = sum dzr; da = dzr @ W1^T;
//   dx_n = sum_{snd_e = n} w_e * da[rcv_e] + da_n * nm_n;
//   dWe  = sum_e (w_e * ein_e)^T da[rcv_e];  de_self = sum_n da_n * nm_n.
//
// What bounds it on the card: at the main path's shapes (N = 8192 rows,
// F = 300, 2F = 600, about 14 k valid edges) the two forward and four
// backward products are about 5.9 and 11.8 GFLOP per layer against
// about 50-60 MB of device-memory traffic per direction, so in float32 on
// the CUDA cores the layer is bound by operations (67 TFLOP/s peak), not
// by bytes (3.35 TB/s). The aggregation is a small share of the work.
//
// Design:
// - The TPU kernel gathered and scattered with one-hot matmuls on the MXU.
//   Here the aggregations are the row-owned walks of edge_aggr.cuh (with
//   the self term; K2 instantiates the same templates without it): one CTA
//   per (node block, 32-wide feature tile), each warp the only writer of
//   the rows it owns, the block's slots staged in shared memory, no
//   atomics, every sum in slot order. The edge term is reassociated:
//   aggr_r = sum_{rcv_e = r} w_e x[snd_e] + A_r @ We with A_r =
//   sum_{rcv_e = r} w_e ein_e, K FMAs a row, not a slot; in the backward
//   dWe = sum_r A_r^T da_r per block, A rebuilt by a receiver walk (one
//   add a slot, and nothing kept from the forward).
// - The MLP products go through the GEMM of gemm.cuh (register-tiled,
//   double-buffered cp.async, full float32, no TF32) with a
//   bias/ReLU/(z > 0) epilogue. Operand strides are arguments, so
//   transposed operands need no copies. Weight gradients contract over
//   all N rows; they split K into partial products that a second pass
//   sums in a fixed order.
// - The TPU carried the cross-block sums (dWe, de_self) in VMEM across a
//   sequential grid. Hopper's blocks run in no order, so each node block
//   writes its partial and a second pass sums the partials in block order.
// - bfloat16: x, out, g and dx may be stored as bfloat16 (bf16_rows), and
//   with bf16_compute the layer rounds where the Pallas kernel at
//   compute_dtype = bfloat16 does: the aggregation's operands and each
//   message (edge_aggr.cuh's BF walk), every product's operands, db2 from
//   the rounded g; aggr and z are saved as bfloat16, dzr, da and the
//   weight gradients stay float32. The six products then run on the
//   tensor cores (gemm.cuh's gemm_bf16, float32 sums), every operand
//   bfloat16 in device memory first: W1 and W2 rounded into scratch once a
//   call (in the orientation of their contiguous dimension, pitch a
//   multiple of 8 elements), a float32 g rounded into scratch, and dzr's
//   product writing a bfloat16 copy beside the float32 dzr (db1 and the
//   self term take the float32 one), its roundings to bfloat16 decided as
//   under the k-ordered float32 chain. With bfloat16 rows at compute_dtype
//   = float32 there is nothing to round: the float kernels run on the
//   stored values (g widened into float32 scratch, out rounded on the
//   store). Without either flag the float kernels run, their bits
//   unchanged.
// Every output is summed in a fixed order: the kernels give the same bits
// on every run.

#include <cuda_runtime.h>

#include "edge_aggr.cuh"
#include "gemm.cuh"

namespace {

constexpr int MAX_BN = 256;               // node rows per block
constexpr int MAX_K = AGG_MAX_K;          // edge input width

// Scratch cut from ``base`` (null: sizes only), in float32 elements, each
// piece 16-byte aligned.
struct Carver {
  float* base;
  ll off = 0;
  float* take(ll n) {
    float* p = base ? base + off : nullptr;
    off += (n + 3) / 4 * 4;
    return p;
  }
  bf16* take16(ll n) { return reinterpret_cast<bf16*>(take((n + 1) / 2)); }
};

// W1 and W2 rounded to bfloat16 (see round_weight)
struct Weights16 {
  bf16* W1;
  bf16* W2;
};

Weights16 carve_weights(Carver& c, int F, int F2) {
  return {c.take16(pad8(F) * pad8(F2)), c.take16(pad8(F) * pad8(F2))};
}

// The forward's scratch: the rounded weights under bf16_compute, else none.
Weights16 carve_fwd(float* base, int F, int F2, bool c, ll* total) {
  Carver cv{base};
  Weights16 w{nullptr, nullptr};
  if (c) w = carve_weights(cv, F, F2);
  *total = cv.off;
  return w;
}

struct BwdWork {
  float* dzr;       // [N, F2]
  float* da;        // [N, F]
  float* part;      // split-K partials of dW1 / dW2
  float* cpart;     // column-sum partials of db1 / db2
  float* dWe_part;  // [n_blocks, K, F]
  float* des_part;  // [n_blocks, F]
  Weights16 w16;    // bf16_compute: W1, W2 rounded
  bf16* dzr16;      // bf16_compute: dzr rounded, [N, pad8(F2)]
  bf16* g16;        // float rows at bf16_compute: g rounded, [N, pad8(F)]
  float* g32;       // bfloat16 rows at float32 compute: g widened, [N, F]
  ll total;
};

BwdWork carve(float* base, int N, int F, int F2, int K, int n_blocks,
              bool rows, bool c) {
  BwdWork w{};
  Carver cv{base};
  const ll s2 = (ll)wgrad_splits(F2, F, N) * F2 * F;
  const ll s1 = (ll)wgrad_splits(F, F2, N) * F * F2;
  const ll chunks = (N + COLSUM_ROWS - 1) / COLSUM_ROWS;
  w.dzr = cv.take((ll)N * F2);
  w.da = cv.take((ll)N * F);
  w.part = cv.take(s1 > s2 ? s1 : s2);
  w.cpart = cv.take(chunks * (F2 > F ? F2 : F));
  w.dWe_part = cv.take((ll)n_blocks * K * F);
  w.des_part = cv.take((ll)n_blocks * F);
  if (c) {
    w.w16 = carve_weights(cv, F, F2);
    w.dzr16 = cv.take16((ll)N * pad8(F2));
    if (!rows) w.g16 = cv.take16((ll)N * pad8(F));
  } else if (rows) {
    w.g32 = cv.take((ll)N * F);
  }
  w.total = cv.off;
  return w;
}

bool bad_shape(int N, int K, int block_nodes, int block_edges) {
  return block_nodes <= 0 || block_nodes > MAX_BN || block_edges <= 0 ||
         K > MAX_K || N % block_nodes != 0;
}

// The aggregation of the forward with x stored as TI, aggr as TA.
template <typename TI, typename TA, bool BF>
int aggr_fwd(const void* x, const float* ein, const float* We,
             const float* e_self, const int* snd, const int* rcv,
             const float* w, const float* nm, void* aggr, int n_blocks, int F,
             int K, int block_nodes, int block_edges, cudaStream_t st) {
  return edge_aggr_fwd<true, true, true, 1, TI, TA, BF>(
      static_cast<const TI*>(x), ein, We, e_self, snd, rcv, w, nm,
      static_cast<TA*>(aggr), n_blocks, F, K, block_nodes, block_edges, st);
}

// The aggregation of the backward from da (float), dx stored as TO.
template <typename TO, bool BF>
int aggr_bwd(const float* da, const float* ein, const int* snd,
             const int* rcv, const float* w, const float* nm, void* dx,
             float* dWe_part, float* des_part, int n_blocks, int F, int K,
             int block_nodes, int block_edges, cudaStream_t st) {
  return edge_aggr_bwd<true, true, true, 1, float, TO, BF>(
      da, ein, snd, rcv, w, nm, static_cast<TO*>(dx), dWe_part, des_part,
      n_blocks, F, K, block_nodes, block_edges, st);
}

// The forward's products in float32: z = relu(aggr @ W1 + b1), out = z @ W2
// + b2, out rounded to bfloat16 on the store with out_bf16.
int fwd_products(const float* aggr, const float* W1, ll w1s0, ll w1s1,
                 const float* b1, const float* W2, ll w2s0, ll w2s1,
                 const float* b2, float* z, void* out, bool out_bf16, int N,
                 int F, int F2, cudaStream_t st) {
  int err = gemm(aggr, F, 1, W1, w1s0, w1s1, z, N, F2, F, 1, nullptr, b1, nullptr, 1, st);
  if (err) return err;
  return gemm(z, F2, 1, W2, w2s0, w2s1, out, N, F, F2, 1, nullptr, b2, nullptr, 0, st, out_bf16);
}

// The backward's products and column sums in float32, into wk.dzr, dW2,
// db2, dW1, db1 and wk.da.
int bwd_products(const float* g, const float* aggr, const float* z,
                 const float* W1, ll w1s0, ll w1s1, const float* W2, ll w2s0,
                 ll w2s1, float* dW1, float* db1, float* dW2, float* db2,
                 const BwdWork& wk, int N, int F, int F2, cudaStream_t st) {
  int err;
  // dzr = (g @ W2^T) * (z > 0): B(k = f, j = c) = W2[c, f]
  err = gemm(g, F, 1, W2, w2s1, w2s0, wk.dzr, N, F2, F, 1, nullptr, nullptr, z, 0, st);
  if (err) return err;
  // dW2 = z^T g: A(i = c, k = n) = z[n, c]
  err = gemm(z, 1, F2, g, F, 1, dW2, F2, F, N, wgrad_splits(F2, F, N), wk.part, nullptr, nullptr, 0, st);
  if (err) return err;
  err = colsum(g, N, F, wk.cpart, db2, st);
  if (err) return err;
  // dW1 = aggr^T dzr
  err = gemm(aggr, 1, F, wk.dzr, F2, 1, dW1, F, F2, N, wgrad_splits(F, F2, N), wk.part, nullptr, nullptr, 0, st);
  if (err) return err;
  err = colsum(wk.dzr, N, F2, wk.cpart, db1, st);
  if (err) return err;
  // da = dzr @ W1^T: B(k = c, j = f) = W1[f, c]
  return gemm(wk.dzr, F2, 1, W1, w1s1, w1s0, wk.da, N, F, F2, 1, nullptr, nullptr, nullptr, 0, st);
}

// The bfloat16 forward (see the note above): rows = bf16_rows, c =
// bf16_compute, not both false; ``work`` holds the scratch of carve_fwd.
int fwd_bf16(const void* x, const float* ein, const float* We,
             const float* e_self, const float* W1, ll w1s0, ll w1s1,
             const float* b1, const float* W2, ll w2s0, ll w2s1,
             const float* b2, const int* snd, const int* rcv, const float* w,
             const float* nm, void* out, void* aggr, void* z, float* work,
             int N, int F, int F2, int K, int block_nodes, int block_edges,
             bool rows, bool c, cudaStream_t st) {
  const int n_blocks = N / block_nodes;
  int err;
  if (rows)
    err = c ? aggr_fwd<bf16, bf16, true>(x, ein, We, e_self, snd, rcv, w, nm, aggr, n_blocks, F, K, block_nodes, block_edges, st)
            : aggr_fwd<bf16, float, false>(x, ein, We, e_self, snd, rcv, w, nm, aggr, n_blocks, F, K, block_nodes, block_edges, st);
  else
    err = aggr_fwd<float, bf16, true>(x, ein, We, e_self, snd, rcv, w, nm, aggr, n_blocks, F, K, block_nodes, block_edges, st);
  if (err) return err;
  if (!c)  // float32 compute: the float products, out rounded on the store
    return fwd_products(static_cast<const float*>(aggr), W1, w1s0, w1s1, b1,
                        W2, w2s0, w2s1, b2, static_cast<float*>(z), out,
                        true, N, F, F2, st);
  ll total, u0, u1, v0, v1;
  const Weights16 wr = carve_fwd(work, F, F2, true, &total);
  err = round_weight(W1, w1s0, w1s1, F, F2, wr.W1, &u0, &u1, st);
  if (err) return err;
  err = round_weight(W2, w2s0, w2s1, F2, F, wr.W2, &v0, &v1, st);
  if (err) return err;
  // z = relu(aggr @ W1 + b1), bfloat16
  err = gemm_bf16(static_cast<const bf16*>(aggr), F, 1, wr.W1, u0, u1, z, true, nullptr, 0, N, F2, F, 1, nullptr, b1, nullptr, 1, false, st);
  if (err) return err;
  // out = z @ W2 + b2, in the rows' dtype
  return gemm_bf16(static_cast<const bf16*>(z), F2, 1, wr.W2, v0, v1, out, rows, nullptr, 0, N, F, F2, 1, nullptr, b2, nullptr, 0, false, st);
}

// The bfloat16 backward, flags as fwd_bf16's; ``wk`` carved with them.
int bwd_bf16(const void* g, const void* aggr, const void* z, const float* ein,
             const float* W1, ll w1s0, ll w1s1, const float* W2, ll w2s0,
             ll w2s1, const int* snd, const int* rcv, const float* w,
             const float* nm, void* dx, float* dWe, float* des, float* dW1,
             float* db1, float* dW2, float* db2, const BwdWork& wk, int N,
             int F, int F2, int K, int block_nodes, int block_edges,
             bool rows, bool c, cudaStream_t st) {
  const int n_blocks = N / block_nodes;
  int err;
  if (!c) {  // bfloat16 rows at float32 compute: the float products on g
    err = convert(static_cast<const bf16*>(g), F, 1, N, F, wk.g32, F, 1, st);
    if (err) return err;
    err = bwd_products(wk.g32, static_cast<const float*>(aggr),
                       static_cast<const float*>(z), W1, w1s0, w1s1, W2,
                       w2s0, w2s1, dW1, db1, dW2, db2, wk, N, F, F2, st);
    if (err) return err;
    err = aggr_bwd<bf16, false>(wk.da, ein, snd, rcv, w, nm, dx, wk.dWe_part, wk.des_part, n_blocks, F, K, block_nodes, block_edges, st);
  } else {
    ll u0, u1, v0, v1;
    err = round_weight(W1, w1s0, w1s1, F, F2, wk.w16.W1, &u0, &u1, st);
    if (err) return err;
    err = round_weight(W2, w2s0, w2s1, F2, F, wk.w16.W2, &v0, &v1, st);
    if (err) return err;
    // g as a bfloat16 operand: stored so (rows), else rounded into scratch
    const bf16* gb = static_cast<const bf16*>(g);
    ll ldg = F;
    if (!rows) {
      ldg = pad8(F);
      err = convert(static_cast<const float*>(g), F, 1, N, F, wk.g16, ldg, 1, st);
      if (err) return err;
      gb = wk.g16;
    }
    const bf16* z16 = static_cast<const bf16*>(z);
    const bf16* a16 = static_cast<const bf16*>(aggr);
    const ll ldd = pad8(F2);
    // dzr = (g @ W2^T) * (z > 0), float32 and a bfloat16 copy: B(k = f,
    // j = c) = W2[c, f]. Its roundings as the ordered chain's (gemm.cuh):
    // one flipped entry of the copy would move a whole row of da, and
    // de_self sums da unrounded over the rows.
    err = gemm_bf16(gb, ldg, 1, wk.w16.W2, v1, v0, wk.dzr, false, wk.dzr16, ldd, N, F2, F, 1, nullptr, nullptr, z16, 0, true, st);
    if (err) return err;
    // dW2 = z^T g: A(i = c, k = n) = z[n, c]
    err = gemm_bf16(z16, 1, F2, gb, ldg, 1, dW2, false, nullptr, 0, F2, F, N, wgrad_splits(F2, F, N), wk.part, nullptr, nullptr, 0, false, st);
    if (err) return err;
    err = colsum(g, N, F, wk.cpart, db2, st, rows, !rows);
    if (err) return err;
    // dW1 = aggr^T dzr
    err = gemm_bf16(a16, 1, F, wk.dzr16, ldd, 1, dW1, false, nullptr, 0, F, F2, N, wgrad_splits(F, F2, N), wk.part, nullptr, nullptr, 0, false, st);
    if (err) return err;
    err = colsum(wk.dzr, N, F2, wk.cpart, db1, st);
    if (err) return err;
    // da = dzr @ W1^T: B(k = c, j = f) = W1[f, c]
    err = gemm_bf16(wk.dzr16, ldd, 1, wk.w16.W1, u1, u0, wk.da, false, nullptr, 0, N, F, F2, 1, nullptr, nullptr, nullptr, 0, false, st);
    if (err) return err;
    if (rows)
      err = aggr_bwd<bf16, true>(wk.da, ein, snd, rcv, w, nm, dx, wk.dWe_part, wk.des_part, n_blocks, F, K, block_nodes, block_edges, st);
    else
      err = aggr_bwd<float, true>(wk.da, ein, snd, rcv, w, nm, dx, wk.dWe_part, wk.des_part, n_blocks, F, K, block_nodes, block_edges, st);
  }
  if (err) return err;
  err = sum_partials(wk.dWe_part, n_blocks, (ll)K * F, F, dWe, nullptr, nullptr, 0, st);
  if (err) return err;
  return sum_partials(wk.des_part, n_blocks, F, F, des, nullptr, nullptr, 0, st);
}

}  // namespace

extern "C" {

// Present since the entry points take (bf16_rows, bf16_compute).
int pgt_bf16_flags() { return 1; }

// Float32 elements of scratch that pgt_gin_conv_fwd needs (0 unless
// bf16_compute).
long long pgt_gin_conv_fwd_workspace(int F, int F2, int bf16_compute) {
  ll total;
  carve_fwd(nullptr, F, F2, bf16_compute, &total);
  return total;
}

// Float32 elements of scratch that pgt_gin_conv_bwd needs.
long long pgt_gin_conv_bwd_workspace(int N, int F, int F2, int K,
                                     int n_blocks, int bf16_rows,
                                     int bf16_compute) {
  return carve(nullptr, N, F, F2, K, n_blocks, bf16_rows, bf16_compute)
      .total;
}

int pgt_gin_conv_max_block_nodes() { return MAX_BN; }
int pgt_gin_conv_max_k() { return MAX_K; }

// Forward: writes out [N, F], aggr [N, F] and z [N, F2]. W1 is [F, F2] and
// W2 [F2, F] with any strides. x and out are bfloat16 with bf16_rows, aggr
// and z with bf16_compute, else float. ``work`` holds
// pgt_gin_conv_fwd_workspace floats. Returns the first CUDA error, 0 if
// none.
int pgt_gin_conv_fwd(const void* x, const float* ein, const float* We,
                     const float* e_self, const float* W1, ll w1s0, ll w1s1,
                     const float* b1, const float* W2, ll w2s0, ll w2s1,
                     const float* b2, const int* snd, const int* rcv,
                     const float* w, const float* nm, void* out, void* aggr,
                     void* z, float* work, int N, int F, int F2, int K,
                     int block_nodes, int block_edges, int bf16_rows,
                     int bf16_compute, void* stream) {
  if (bad_shape(N, K, block_nodes, block_edges)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16_rows || bf16_compute)
    return fwd_bf16(x, ein, We, e_self, W1, w1s0, w1s1, b1, W2, w2s0, w2s1,
                    b2, snd, rcv, w, nm, out, aggr, z, work, N, F, F2, K,
                    block_nodes, block_edges, bf16_rows, bf16_compute, st);
  const int n_blocks = N / block_nodes;
  int err = edge_aggr_fwd<true, true, true, 1>(
      static_cast<const float*>(x), ein, We, e_self, snd, rcv, w, nm,
      static_cast<float*>(aggr), n_blocks, F, K, block_nodes, block_edges,
      st);
  if (err) return err;
  return fwd_products(static_cast<const float*>(aggr), W1, w1s0, w1s1, b1, W2,
                      w2s0, w2s1, b2, static_cast<float*>(z), out, false, N, F,
                      F2, st);
}

// Backward: writes dx [N, F], dWe [K, F], des [F], dW1 [F, F2], db1 [F2],
// dW2 [F2, F], db2 [F]. ``work`` holds pgt_gin_conv_bwd_workspace floats.
// g and dx are bfloat16 with bf16_rows, aggr and z with bf16_compute; the
// weight gradients are float.
int pgt_gin_conv_bwd(const void* g_, const void* aggr_, const void* z_,
                     const float* ein, const float* W1, ll w1s0, ll w1s1,
                     const float* W2, ll w2s0, ll w2s1, const int* snd,
                     const int* rcv, const float* w, const float* nm,
                     void* dx_, float* dWe, float* des, float* dW1,
                     float* db1, float* dW2, float* db2, float* work, int N,
                     int F, int F2, int K, int block_nodes, int block_edges,
                     int bf16_rows, int bf16_compute, void* stream) {
  if (bad_shape(N, K, block_nodes, block_edges)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_blocks = N / block_nodes;
  const BwdWork wk = carve(work, N, F, F2, K, n_blocks, bf16_rows,
                           bf16_compute);
  if (bf16_rows || bf16_compute)
    return bwd_bf16(g_, aggr_, z_, ein, W1, w1s0, w1s1, W2, w2s0, w2s1, snd,
                    rcv, w, nm, dx_, dWe, des, dW1, db1, dW2, db2, wk, N, F,
                    F2, K, block_nodes, block_edges, bf16_rows, bf16_compute,
                    st);
  float* dx = static_cast<float*>(dx_);
  int err = bwd_products(static_cast<const float*>(g_),
                         static_cast<const float*>(aggr_),
                         static_cast<const float*>(z_), W1, w1s0, w1s1, W2,
                         w2s0, w2s1, dW1, db1, dW2, db2, wk, N, F, F2, st);
  if (err) return err;
  err = edge_aggr_bwd<true, true, true, 1>(wk.da, ein, snd, rcv, w, nm, dx,
                                        wk.dWe_part, wk.des_part, n_blocks, F,
                                        K, block_nodes, block_edges, st);
  if (err) return err;
  err = sum_partials(wk.dWe_part, n_blocks, (ll)K * F, F, dWe, nullptr, nullptr, 0, st);
  if (err) return err;
  return sum_partials(wk.des_part, n_blocks, F, F, des, nullptr, nullptr, 0, st);
}

// The GEMMs of gemm.cuh alone, for tests and timing: C [M, N] =
// epilogue(A @ B) with A(i, k) = A[i*sa0 + k*sa1], B(k, j) = B[k*sb0 +
// j*sb1]; bias [N] and pos_mask [M, N] may be null. With splits > 1,
// ``part`` holds pgt_gemm_workspace floats (enough for either GEMM).
// The splits of K that K1's (and K4's) weight gradients take.
int pgt_gemm_wgrad_splits(int M, int N, int K) {
  return wgrad_splits(M, N, K);
}

long long pgt_gemm_workspace(int M, int N, int K, int splits) {
  const int k_chunk = ((K + splits - 1) / splits + TK - 1) / TK * TK;
  const int s = (K + k_chunk - 1) / k_chunk;
  return s > 1 ? (ll)s * M * N : 0;
}

int pgt_gemm(const float* A, ll sa0, ll sa1, const float* B, ll sb0, ll sb1,
             float* C, int M, int N, int K, int splits, float* part,
             const float* bias, const float* pos_mask, int relu,
             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  return gemm(A, sa0, sa1, B, sb0, sb1, C, M, N, K, splits, part, bias,
              pos_mask, relu, (cudaStream_t)stream);
}

// The tensor-core GEMM (gemm_bf16) alone: A and B bfloat16, one stride of
// each 1; C float32, or bfloat16 with c_bf16; pos_mask bfloat16. A split
// product takes no bfloat16 C and no mask.
int pgt_gemm_bf16(const void* A, ll sa0, ll sa1, const void* B, ll sb0,
                  ll sb1, void* C, int c_bf16, int M, int N, int K,
                  int splits, float* part, const float* bias,
                  const void* pos_mask, int relu, int exact, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  return gemm_bf16(static_cast<const bf16*>(A), sa0, sa1,
                   static_cast<const bf16*>(B), sb0, sb1, C, c_bf16, nullptr,
                   0, M, N, K, splits, part, bias,
                   static_cast<const bf16*>(pos_mask), relu, exact,
                   (cudaStream_t)stream);
}

}  // extern "C"
