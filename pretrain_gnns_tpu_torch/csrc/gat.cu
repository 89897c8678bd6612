// GAT attention for Hopper (sm_90a), forward and backward: the whole-layer
// fused GAT conv (K4) and the blocked GAT attention (K5) from one source.
//
// Replaces two Pallas TPU kernels:
//   K4  pretrain_gnns_tpu/ops/pallas_gat_conv.py (_fwd_kernel via _call_fwd,
//       _bwd_kernel via _call_bwd, wrapped by the custom_vjp fused_gat_conv)
//   K5  pretrain_gnns_tpu/ops/pallas_attention.py (_fwd_kernel via
//       blocked_gat_forward, _bwd_kernel via blocked_gat_backward)
//
// Both compute, per head h on the block-diagonal batch (s = snd_e, r = rcv_e):
//
//   raw_e  = x[r]·a_i + (x[s] + e_e)·a_j        logit_e = LeakyReLU(raw_e)
//   sraw_n = x[n]·a_i + (x[n] + e_self)·a_j     sl_n    = LeakyReLU(sraw_n)
//   m_n    = max(max_{e -> n} logit_e, sl_n)
//   p_e    = exp(logit_e - m_r) * w_e           p_self_n = exp(sl_n - m_n)
//   den_n  = sum_{e -> n} p_e + p_self_n
//   out_n  = sum_{e -> n} alpha_e (x[s] + e_e) + aself_n (x[n] + e_self)
//            alpha_e = p_e / den_r, aself_n = p_self_n / den_n
//
// K5 takes x [N, H, D] and e [E, H, D] ready-made and returns out [N, H, D].
// K4 forms x = h @ Wl + bl itself (saved for the backward) and never forms
// e: e_e = ein_e @ We (K <= 16 terms) is recomputed wherever it is needed,
// and e_e·a_j = ein_e · (We a_j). It returns mean_h out + bias, [N, D].
//
// Backward (g the cotangent of a head's out; K4: g / H for every head):
//   dalpha_e = g[r]·(x[s] + e_e)     daself_n = g[n]·(x[n] + e_self)
//   c_n   = sum_{e -> n} alpha_e dalpha_e + aself_n daself_n
//   dz_e  = alpha_e (dalpha_e - c_r) LeakyReLU'(raw_e)
//   dzs_n = aself_n (daself_n - c_n) LeakyReLU'(sraw_n)
//   u_n = sum_{e -> n} dz_e + dzs_n  (on a_i)   v_n = sum_{s_e = n} dz_e + dzs_n
//   dx_n  = sum_{s_e = n} alpha_e g[r] + aself_n g[n] + u_n a_i + v_n a_j
//   de_e  = alpha_e g[r] + dz_e a_j               (K5; K4: dWe = ein^T de)
//   de_self = sum_n aself_n g[n] + (sum_n dzs_n) a_j
//   da_i = sum_n u_n x[n]
//   da_j = sum_n v_n x[n] + (sum_n dzs_n) e_self + sum_e dz_e e_e
//   K4 only: dbias = sum_n g_n (all rows, before the 1/H), dWl = h^T dx,
//   dbl = sum_n dx_n, dh = dx Wl^T.
// LeakyReLU' is 1 where raw >= 0, else the slope (as the TPU kernels).
//
// What bounds it on the card: at the GAT paths' shapes (chem N = 8,192 rows,
// 24,576 edge slots, about 14 k valid; bio N = 20,480, 61,440 slots; H = 2,
// D = 300, float32) K4 is bound by operations, the [N, 300] x [300, 600]
// projection and its two backward products on the CUDA cores (67 TFLOP/s,
// gemm.cuh); its attention, and all of K5, by bytes: x (and g) read, out
// (dx, de) written once, 10-60 MB at 3.35 TB/s, 0.01-0.04 ms. What keeps a
// simple kernel far from that is latency (chains of dependent loads, too
// few warps in flight when registers run short) and repeated work, not
// arithmetic. Tensor cores do not apply to the attention (sparse, bound by
// bytes and latency), nor, in float32, to K4's products: TF32 would break
// the float32 parity the port is held to (they stay on gemm.cuh's float
// GEMM). Under bfloat16 K4's three products run on the tensor cores
// (gemm.cuh's gemm_bf16, 989 TFLOP/s), which leaves K4 bound by bytes too.
//
// Design (the attention of K4 and K5, forward and backward):
// - Row ownership, row by row. One CTA per (node block, group of RPC rows,
//   feature chunk of CH = 320 features); each warp owns RPW consecutive rows
//   and is their only writer. The CTA stages the block's slots in shared
//   memory (local sender, local receiver, weight; -1 for a padded slot, a
//   slot with w <= 0 or with an endpoint outside the block), and each warp
//   lists, by ballot, the slots of each of its rows in slot order: every
//   sum below is taken in a fixed order, with no atomics, so every output is
//   the same bits on every run. A lane holds NV = 10 features of a row in
//   registers, two adjacent ones (float2) where D is even, the row fits one
//   chunk and the rows are 8-byte aligned. Staging loops issue all their
//   loads before the first store (stage, stage_we).
// - Forward, one kernel: for each row and head the warp forms x_r·a_i and
//   the self logit, then walks the row's slots B at a time (the x[s] rows of
//   a batch, and K5's e rows, loaded before any is used), takes the sender
//   term of each logit by a warp sum and runs an online softmax: a running
//   max and denominator, the accumulated message rescaled when the max
//   grows. The self loop starts it (max = its logit, denominator 1,
//   accumulator x_r + e_self). So the softmax needs no scan of the block,
//   and K5 reads e once. alpha is written after the walk from the logits
//   kept in shared memory. K4 reassociates its edge term: the logit's is
//   ein_e · (We_h a_j) (We_h a_j formed once a call, gat_edge_vec_kernel),
//   and the message's A_r = sum p_e ein_e is summed with one add a slot
//   (lanes k < K) and multiplied by We_h once a row: out_r = acc / den +
//   (A_r / den) @ We_h.
// - Backward, two walks. By receiver: dalpha_e = g_r·(x[s] + e_e) (K4:
//   g_r·x[s] + ein_e · q_r, with q_r = We_h g_r formed once a row and head
//   from We_h's chunk in shared memory and a reduce-scatter over the warp),
//   c_r and K4's A_r = sum alpha_e ein_e in the same pass; then dz, dzs, u
//   lane-parallel over the row's slots; K5 writes de and takes da_j's e
//   term re-reading the row's e rows, which the first pass has just brought
//   to L1; K4 writes A_r and S_r = sum dz_e ein_e. By sender: v_n and dx_n
//   = sum alpha_e g_r + aself g_n + u a_i + v a_j. e is read from device
//   memory once in each direction. K4's dWe = sum_r A_r^T g_r + S a_j^T and
//   da_j's e term S @ We_h come from A and S (gat_dwe_kernel), never from a
//   per-slot ein_e @ We.
// - Parameter gradients: each walk CTA (and each dWe CTA) writes its partial
//   sums of de_self, da_i, da_j (and dWe), its warps' shares added in warp
//   order; gat_finish_kernel sums them in CTA order.
// - Rows wider than a chunk (D > 320) take one CTA per chunk and one
//   feature a lane (no path has them: they are kept correct, not fast);
//   the full-row dot products are then summed chunk by chunk in the same
//   order in every CTA, so all chunks see the same logits.
// - Padded slots and slots with an endpoint outside their block get alpha
//   = 0 and dlr = 0, and K5 writes their de rows as exact zeros. Padded
//   node rows and all-padding blocks are computed like any other: their
//   only logit is the self loop, so aself = 1 and out = x + e_self.
// - K4's three products and its two column sums go through gemm.cuh
//   (shared with gin_conv.cu). edge_aggr.cuh's walk does not fit here:
//   the softmax needs each row's slots together, and a GAT slot counts only
//   with w > 0 (the header's with w != 0).

//
// bfloat16 (BF, compute_dtype = bfloat16): each variant computes the Pallas
// body's function at that dtype, bfloat16 operands and float32 sums, and
// rounds (bf(v), to nearest) exactly where the body rounds; the one-hot
// products stay gathers and ordered sums.
// - K5 (pallas_attention.py): the logit scalars come from the unrounded x
//   and e, as the body's ps, pd, pe, sl; the feature tiles x, e, the self
//   message x + e_self and g are rounded. Forward: out_n = (sum_{e -> n}
//   bf(p_e (bf(x[s]) + bf(e_e))) + p_self_n bf(x[n] + e_self)) / den_n.
//   Backward: dalpha_e = bf(g[r])·(bf(x[s]) + bf(e_e)), daself_n =
//   bf(g_n)·bf(x_n + e_self), de_e = alpha_e bf(g[r]) + dz_e a_j, dx_n =
//   sum_{s_e = n} bf(alpha_e bf(g[r])) + aself_n bf(g_n) + u a_i + v a_j;
//   de_self, da_i and da_j take the unrounded g, x and e.
// - K4 (pallas_gat_conv.py): x = bf(h) @ bf(Wl) + bl on the tensor cores
//   (gemm.cuh's gemm_bf16), float32, with a bfloat16 copy xb = bf(x), the
//   saved residual; e_e = bf(ein_e) @ bf(We). Forward: the logits from the
//   float32 x (the edge term bf(ein_e) · (bf(We_h) a_j)), out_n = mean_h
//   (sum_{e -> n} bf(p_e (xb[s] + e_e)) + p_self_n (x_n + e_self)) / den_n
//   + bias. Backward: alpha, aself and the LeakyReLU slopes of the body's
//   softmax recomputed from xb (the body recomputes it from the residual,
//   not from the forward's float32 x; the kernel's forward computes it
//   beside its own and saves it, with bf(h) and bf(Wl)); g_r = bf(g[r] /
//   H); dalpha, c, dz, dzs as above with the unrounded g / H in daself and
//   de_self; dx_n = sum bf(alpha_e g_r) + aself_n g_n / H + u a_i + v a_j,
//   float32 and a bfloat16 copy; dWe = sum_e bf(ein_e)^T bf(de_e), de_e =
//   alpha_e g_r + dz_e a_j formed and rounded per slot (the rounding leaves
//   no room for gat_dwe_kernel's row sums), da_j's e term (sum_e dz_e
//   bf(ein_e)) @ bf(We); dWl = bf(h)^T bf(dx) and dh = bf(dx) @ bf(Wl)^T
//   on the tensor cores, dbl the unrounded dx summed.
// - The messages' rounding needs p_e at the row's final max, so the
//   bfloat16 forwards take a row's logits, max and denominator before its
//   rounded messages. K5 walks the slots twice. K4's design (gat_bf16.cu):
//   no row read for the logits (their row scalars x·a_i, x·a_j and (x +
//   e_self)·a_j, of x and of xb, come from one kernel), the slots' logits a
//   lane a slot, the message's e_e a slot and feature from every head's
//   rounded We in shared memory, K FMAs a feature but for the zero
//   bf(ein_ek).

// Sources: the walks and their helpers live in gat_walks.cuh; this file
// instantiates the float32 kernels and holds the library's C interface,
// gat_bf16.cu the bfloat16 variants behind it (two sources compiled in
// parallel, linked into one library).

#include "gat_walks.cuh"

extern "C" {

int pgt_gat_max_k() { return MAX_K; }
int pgt_gat_max_smem() { return MAX_SMEM; }
// Dynamic shared memory, in bytes, of the largest kernel at this layout.
int pgt_gat_smem(int block_nodes, int block_edges) {
  return max_smem(block_nodes, block_edges);
}
// Present since the entry points take bf16_compute.
int pgt_gat_bf16_flags() { return 1; }

// Float32 elements of scratch for each entry point.
long long pgt_gat_attn_fwd_workspace(int N, int E, int H) {
  (void)N; (void)E; (void)H;
  return 4;  // K5's forward needs none
}
long long pgt_gat_conv_fwd_workspace(int N, int Din, int H, int D,
                                     int bf16_compute) {
  if (bf16_compute) return pgt_gat_conv_fwd_workspace_bf16(N, Din, H, D);
  return carve_conv_fwd(nullptr, H).total;
}
long long pgt_gat_attn_bwd_workspace(int N, int E, int H, int D,
                                     int block_nodes) {
  Graph a{};
  a.N = N; a.E = E; a.H = H; a.D = D; a.bn = block_nodes;
  Carver cv{nullptr};
  carve_attn(cv, a, false);
  return cv.off;
}
long long pgt_gat_conv_bwd_workspace(int N, int E, int Din, int H, int D,
                                     int K, int block_nodes,
                                     int bf16_compute) {
  if (bf16_compute)
    return pgt_gat_conv_bwd_workspace_bf16(N, E, Din, H, D, K, block_nodes);
  Graph a{};
  a.N = N; a.E = E; a.H = H; a.D = D; a.K = K; a.bn = block_nodes;
  return carve_conv_bwd(nullptr, a, Din).total;
}
// bfloat16 elements of K4's saved rounded operands (``r16``): h and Wl
// rounded by the bfloat16 forward for its backward; 0 at float32.
long long pgt_gat_conv_r16_elems(int N, int Din, int H, int D,
                                 int bf16_compute) {
  return bf16_compute ? pgt_gat_conv_r16_elems_bf16(N, Din, H, D) : 0;
}

// K5 forward: out [N, H*D] from x [N, H*D], e [E, H*D], es, ai, aj [H*D],
// snd, rcv (global rows), w [E]. Also writes alpha, dlr [E, H] and aself,
// dls [N, H] for the backward. bf16_compute: the bfloat16 variant (the
// softmax scalars from the unrounded x and e, as the Pallas body's).
// Returns the first CUDA error, 0 if none.
int pgt_gat_attn_fwd(const float* x, const float* e, const float* es,
                     const float* ai, const float* aj, const int* snd,
                     const int* rcv, const float* w, float* out, float* alpha,
                     float* aself, float* dlr, float* dls, float* work, int N,
                     int E, int H, int D, int block_nodes, int block_edges,
                     float slope, int bf16_compute, void* stream) {
  (void)work;
  if (bf16_compute)
    return pgt_gat_attn_fwd_bf16(x, e, es, ai, aj, snd, rcv, w, out, alpha,
                                 aself, dlr, dls, N, E, H, D, block_nodes,
                                 block_edges, slope, stream);
  const Graph a{x, e, nullptr, nullptr, es, ai, aj, snd, rcv, w,
                N, E, H, D, 0, block_nodes, block_edges, slope, nullptr};
  if (bad_shape(a, false)) return (int)cudaErrorInvalidValue;
  return attention_fwd<false, false>(a, nullptr, nullptr, alpha, aself, dlr,
                                     dls, out, (cudaStream_t)stream);
}

// K5 backward from the cotangent g [N, H*D] and the forward's alpha, aself,
// dlr, dls: writes dx [N, H*D], de [E, H*D] (every row) and dpar [3, H*D]
// = de_self, da_i, da_j.
int pgt_gat_attn_bwd(const float* g, const float* x, const float* e,
                     const float* es, const float* ai, const float* aj,
                     const int* snd, const int* rcv, const float* w,
                     const float* alpha, const float* aself, const float* dlr,
                     const float* dls, float* dx, float* de, float* dpar,
                     float* work, int N, int E, int H, int D, int block_nodes,
                     int block_edges, float slope, int bf16_compute,
                     void* stream) {
  if (bf16_compute)
    return pgt_gat_attn_bwd_bf16(g, x, e, es, ai, aj, snd, rcv, w, alpha,
                                 aself, dlr, dls, dx, de, dpar, work, N, E, H,
                                 D, block_nodes, block_edges, slope, stream);
  const Graph a{x, e, nullptr, nullptr, es, ai, aj, snd, rcv, w,
                N, E, H, D, 0, block_nodes, block_edges, slope, nullptr};
  if (bad_shape(a, false)) return (int)cudaErrorInvalidValue;
  Carver cv{work};
  const AttnWork wk = carve_attn(cv, a, false);
  const Cot c{g, (ll)H * D, (ll)D, 1.f};
  return attention_bwd<false, false>(a, c, alpha, aself, dlr, dls, wk, dx, de,
                                     nullptr, dpar, (cudaStream_t)stream);
}

// K4 forward: out [N, D] and the saved projection x [N, H*D] from h
// [N, Din], Wl [Din, H*D] (any strides), bl [H*D], ein [E, K], We
// [K, H*D], es, ai, aj [H*D], bias [D]; alpha, dlr [E, H] and aself, dls
// [N, H] are written for the backward. Float32: x is float (r16 unused).
// bf16_compute: gat_bf16.cu's pgt_gat_conv_fwd_bf16 (x the bfloat16
// residual, the softmax scalars the residual's, h and Wl rounded into
// r16). ``work`` holds pgt_gat_conv_fwd_workspace floats.
int pgt_gat_conv_fwd(const float* h, const float* Wl, ll wls0, ll wls1,
                     const float* bl, const float* ein, const float* We,
                     const float* es, const float* ai, const float* aj,
                     const float* bias, const int* snd, const int* rcv,
                     const float* w, float* out, void* x, float* alpha,
                     float* aself, float* dlr, float* dls, void* r16,
                     float* work, int N, int E, int Din, int H, int D, int K,
                     int block_nodes, int block_edges, float slope,
                     int bf16_compute, void* stream) {
  if (bf16_compute)
    return pgt_gat_conv_fwd_bf16(h, Wl, wls0, wls1, bl, ein, We, es, ai, aj,
                                 bias, snd, rcv, w, out, x, alpha, aself, dlr,
                                 dls, r16, work, N, E, Din, H, D, K,
                                 block_nodes, block_edges, slope, stream);
  const Graph a{x, nullptr, ein, We, es, ai, aj, snd, rcv, w,
                N, E, H, D, K, block_nodes, block_edges, slope, nullptr};
  if (bad_shape(a, true) || Din <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const ConvFwdWork wk = carve_conv_fwd(work, H);
  const int err = gemm(h, Din, 1, Wl, wls0, wls1, static_cast<float*>(x), N,
                       H * D, Din, 1, nullptr, bl, nullptr, 0, st);
  if (err) return err;
  return attention_fwd<true, false>(a, bias, wk.va, alpha, aself, dlr, dls,
                                    out, st);
}

// K4 backward from g [N, D] and what the forward saved (x, alpha, aself,
// dlr, dls and, bf16_compute, r16): writes dh [N, Din], dWl [Din, H*D],
// dbl [H*D], dWe [K, H*D], dpar [3, H*D] = de_self, da_i, da_j, and dbias
// [D]. bf16_compute: gat_bf16.cu's pgt_gat_conv_bwd_bf16. ``work`` holds
// pgt_gat_conv_bwd_workspace floats.
int pgt_gat_conv_bwd(const float* g, const float* h, const float* Wl, ll wls0,
                     ll wls1, const void* x, const float* ein,
                     const float* We, const float* es, const float* ai,
                     const float* aj, const int* snd, const int* rcv,
                     const float* w, const float* alpha, const float* aself,
                     const float* dlr, const float* dls, const void* r16,
                     float* dh, float* dWl, float* dbl, float* dWe,
                     float* dpar, float* dbias, float* work, int N, int E,
                     int Din, int H, int D, int K, int block_nodes,
                     int block_edges, float slope, int bf16_compute,
                     void* stream) {
  if (bf16_compute)
    return pgt_gat_conv_bwd_bf16(g, h, Wl, wls0, wls1, x, ein, We, es, ai, aj,
                                 snd, rcv, w, alpha, aself, dlr, dls, r16, dh,
                                 dWl, dbl, dWe, dpar, dbias, work, N, E, Din,
                                 H, D, K, block_nodes, block_edges, slope,
                                 stream);
  const Graph a{x, nullptr, ein, We, es, ai, aj, snd, rcv, w,
                N, E, H, D, K, block_nodes, block_edges, slope, nullptr};
  if (bad_shape(a, true) || Din <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * D;
  const ConvBwdWork wk = carve_conv_bwd(work, a, Din);
  // dbias sums g over all rows, before the head mean's 1/H
  int err = colsum(g, N, D, wk.cpart, dbias, st);
  if (err) return err;
  const Cot c{g, (ll)D, 0, 1.f / (float)H};
  err = attention_bwd<true, false>(a, c, alpha, aself, dlr, dls, wk.attn,
                                   wk.dx, nullptr, dWe, dpar, st);
  if (err) return err;
  // dWl = h^T dx: A(i = d, k = n) = h[n, d]
  err = gemm(h, 1, Din, wk.dx, HD, 1, dWl, Din, HD, N,
             wgrad_splits(Din, HD, N), wk.gpart, nullptr, nullptr, 0, st);
  if (err) return err;
  err = colsum(wk.dx, N, HD, wk.cpart, dbl, st);
  if (err) return err;
  // dh = dx @ Wl^T: B(k = c, j = d) = Wl[d, c]
  return gemm(wk.dx, HD, 1, Wl, wls1, wls0, dh, N, Din, HD, 1, nullptr,
              nullptr, nullptr, 0, st);
}

}  // extern "C"
