// Fused ReLU-SAE and Matryoshka-SAE kernels for Hopper (sm_90a): the C entry
// points of the ops' forward, backward and input gradient (dx), and the input
// centring they start with.
//
// Replaces the Pallas TPU kernels of sparse_vision_tpu/ops/fused_sae.py and
// sparse_vision_tpu/ops/fused_matryoshka_sae.py:
//   svt_sae_fwd         <- fused_sae.py _fwd_kernel (:43), pallas_call :321
//   svt_sae_bwd         <- fused_sae.py _bwd_kernel (:96), pallas_call :391
//   svt_sae_dx          <- fused_sae.py _dx_kernel (:168), pallas_call :422
//   svt_matryoshka_fwd  <- fused_matryoshka_sae.py _fwd_kernel (:99), pallas_call :292
//   svt_matryoshka_bwd  <- fused_matryoshka_sae.py _bwd_kernel (:155), pallas_call :371
//   svt_matryoshka_dx   <- fused_matryoshka_sae.py _dx_kernel (:227), pallas_call :404
//   svt_sae_sweep_fwd / _bwd, svt_matryoshka_sweep_fwd / _bwd <- the forward and
//       backward kernels above under jax.vmap (train/sweep_vmap.py:138-175,
//       :213-215), one launch for all combos
//
// All six run the coder body family (coder.cuh: wgmma/TMA bodies in bf16, SIMT
// bodies in f32, any width) with Cin = Cout = C; the bf16 backwards at C <= 256
// the cluster pair, coder_bwd_pair<Act::Relu>, where ops/fused_sae.bwd_route
// says "pair" (their ``pair`` argument; sae_bwd). The SAE is that dictionary on
// the centred input: the forward entry points first launch center_kernel
// (coder.cuh), x_cent = round_T(x - round_T(b_dec)), which the autograd
// function saves for the backward and dx, so those entry points take x_cent and
// never centre again. The rest of the SAE's differences are the bodies'
// template flags (coder.cuh header note): the scalar c_l1 arrives as a
// per-latent cotangent (the caller broadcasts it), the L1 sum is the total of
// the zsum partials, the Matryoshka forward snapshots prefix_recon [P, T, C] at
// each prefix boundary (kPrefix), the backward (kSae) reads S[level] and writes
// db_dec's centring term -round_T(db_enc tile) @ W_enc tile^T as one partial
// row per 64-latent block after the direct rows, and dx is the forward bodies'
// dx route (kDx), which reads S[level] too.
//
// Matryoshka (nested latent prefixes, boundaries b_0 < .. < b_{P-1} = H, each a
// multiple of 128): latent tile j of level q (b_{q-1} <= j < b_q) is read by
// every prefix p >= q, so its reconstruction cotangent is the suffix-weighted
// error S_q = sum_{p>=q} c_p err_p, computed by the caller; the backward and dx
// read S[level(j)] where the ReLU ops read c_rec * err (c_rec = 1), and the ReLU
// op is the case P = 1.
//
// dx, at the training shape (T = 32,768, C = 256, H = 16,384), is 6*T*C*H =
// 0.82 TFLOP (the encode, dpost = round_T(c_rec*err) @ W_dec^T and round_T(dpre)
// @ W_enc^T) against ~50 MB of operands and 32 MB of output: 0.83 ms at 989
// TFLOP/s of bf16 tensor cores, bounded by arithmetic as long as the [T, H]
// latent matrix never reaches device memory. A block owns a token tile and
// sweeps the latents, as the forward does: dx stays in registers for the
// whole sweep to C 256 and is updated in place wider (coder.cuh, "Tiling").
//
// Numerics follow the Pallas kernels' cast points exactly. The operand type T
// (float or bf16) is the compute dtype; x, W_enc, W_dec and the saved error
// arrive already cast to T:
//   x_cent = round_T(x - round_T(b_dec))              (a T-typed difference)
//   pre    = x_cent @ W_enc (f32 sum) + b_enc          (b_enc added in f32)
//   post   = max(pre, 0); the decode reads round_T(post)
//   recon  = sum_j round_T(post_j) @ W_dec_j + b_dec   (b_dec added in f32)
//   dx     = sum_j round_T(dpre_j) @ W_enc_j^T - c_rec * err_0   (f32; the
//            direct term not rounded)
// Every cross-block sum leaves as a per-block partial that the caller reduces
// (activity counts, the L1 sum, both terms of db_dec): no float atomics, so
// two runs on the same inputs give the same bits.
//
// The sweep's entry points (svt_sae_sweep_fwd / _bwd, svt_matryoshka_sweep_fwd /
// _bwd) run n_combo stacked dictionaries of one shape on one shared x [T, C]
// in one launch of each body, the combo as the grid's y dimension (coder.cuh,
// "Combos"; the Pallas kernels under jax.vmap in train/sweep_vmap.py, whose
// batching rule adds the combo as the outer grid dimension): every operand
// but x and every output gains a leading [n_combo] axis, center_kernel writes
// each combo's x_cent [n_combo, T, C] from its own b_dec. The one-dictionary
// entry points are their n_combo = 1 calls.
//
// n_split (every forward and backward entry point; coder.cuh, "Splits") cuts
// the bf16 in-place forward's latent sweep (C > 512) or the bf16 backward's
// token sweep into that many parts on the grid's z dimension. The forward's
// recon (prefix_recon) and row_active gain a leading [n_split] axis of
// partials that the wrapper sums; the backward takes split_ws, whose partials
// the last split of each latent block adds into the outputs. n_split = 1 is
// the launch without a split; the dx entry points do not split.
//
// Entry points use a plain C interface (pointers, sizes, stream) and return the
// cudaError_t of the launch; the Python wrappers (ops/fused_sae.py,
// ops/fused_matryoshka_sae.py) raise on a non-zero value. Supported shapes:
// coder.cuh's (T and H multiples of 128, bf16 widths multiples of 8, prefix
// boundaries multiples of 128), at most kMaxLevels prefixes (can_fuse,
// can_fuse_matryoshka).

#include "coder.cuh"

namespace {

// The forward: center_kernel into x_cent, then the coder forward on x_cent.
// n_combo dictionaries (stacked operands; x shared) in one launch of each;
// n_split as coder_fwd's (coder.cuh, "Splits").
template <bool kPrefix>
cudaError_t sae_fwd(int bf16, const void* x, const void* w_enc, const float* b_enc,
                    const void* w_dec, const float* b_dec, void* x_cent, float* recon,
                    float* act_part, float* row_active, float* zsum_part, int n_tokens, int C,
                    int H, const svt::Levels& lv, int n_combo, int n_split,
                    cudaStream_t stream) {
  if (bad_shape(n_tokens, C, C, H) || bad_combos(n_combo, H) ||
      (bf16 && bad_tc_operands(C, C, x, x_cent, x_cent, x_cent)))
    return cudaErrorInvalidValue;
  cudaError_t e = launch_center(bf16, x, b_dec, x_cent, n_tokens, C, stream, n_combo);
  if (e != cudaSuccess) return e;
  return coder_fwd<kPrefix>(bf16, x_cent, w_enc, b_enc, w_dec, b_dec, recon, act_part,
                            row_active, zsum_part, n_tokens, C, C, H, lv, stream, n_combo,
                            n_split);
}

// The backward on x_cent: db_dec_part holds the direct rows (coder_bwd's) and
// then H / 64 rows of the centring term.
// n_combo dictionaries as sae_fwd's: a combo's db_dec_part is [direct rows + H /
// 64, C], whose centring rows SaeBwd::db_cent points into (combo 0's); n_split
// and split_ws as coder_bwd's. ``pair`` non-zero (the caller's route,
// ops/fused_sae.bwd_route, decides; bf16 and C <= kPairCmax, else
// cudaErrorInvalidValue) runs the cluster pair instead, coder_bwd_pair<Act::
// Relu>, after scale_err_kernel on the bf16 err: with err_s (an [n_combo,
// n_tokens, C] bf16 workspace; one level, the ReLU SAE) round_bf16(c_rec *
// err) into it and the direct rows, which the pair then reads; without it
// (the Matryoshka SAE, c_rec 1) the direct rows of S_0 only, the pair reading
// S [P * n_tokens, C] as it is. split_ws as bwd_pair's.
cudaError_t sae_bwd(int bf16, const void* x_cent, const void* w_enc, const float* b_enc,
                    const void* w_dec, const void* err, const float* coeffs, const float* ct,
                    float* dw_enc, float* db_enc, float* dw_dec, float* db_dec_part,
                    void* split_ws, void* err_s, int n_tokens, int C, int H,
                    const svt::Levels& lv, int n_combo, int pair, int n_split,
                    cudaStream_t stream) {
  const long direct_rows = bf16 ? (n_tokens + kTcBwdTS - 1) / kTcBwdTS : 2;
  const SaeBwd sae{lv, w_enc, db_dec_part + direct_rows * C};
  if (!pair)
    return coder_bwd<true>(bf16, x_cent, w_enc, b_enc, w_dec, err, coeffs, ct, dw_enc, db_enc,
                           dw_dec, db_dec_part, n_tokens, C, C, H, sae, stream, n_combo,
                           n_split, split_ws);
  if (!bf16 || bad_shape(n_tokens, C, C, H) || bad_combos(n_combo, H) || C > kPairCmax ||
      (err_s != nullptr && lv.n != 1))
    return cudaErrorInvalidValue;
  const long n = static_cast<long>(n_tokens) * C;
  const cudaError_t e = launch_scale_err(static_cast<const __nv_bfloat16*>(err), coeffs, err_s,
                                         db_dec_part, n_tokens, C, stream, n_combo, n,
                                         (direct_rows + H / kTcBwdTH) * C, 2, lv.n * n);
  if (e != cudaSuccess) return e;
  return bwd_pair<Act::Relu>(x_cent, w_enc, b_enc, w_dec, err_s ? err_s : err,
                             err_s ? n_tokens : lv.n * n_tokens, coeffs, ct, dw_enc, db_enc,
                             dw_dec, n_tokens, C, H, sae, stream, n_combo, n_split, split_ws);
}

// The dx route of the forward bodies (kDx, coder.cuh), c_in = c_out = C: dx
// [n_tokens, C] f32 = sum_j round_T(dpre_j) @ W_enc_j^T - c_rec * err_0, with
// pre on x [n_tokens, C] (the centred input) and dpost from err [lv.n *
// n_tokens, C] in the operand type (level q's rows from q * n_tokens; prefix
// boundaries multiples of 128), coeffs = (c_rec, c_l1) on the device. bf16:
// coder_fwd_tc_hold<256> for C <= 256, else coder_fwd_tc (coder.cuh, kDx: the
// held 512 columns spill); float: coder_fwd_kernel.
cudaError_t sae_dx(int bf16, const void* x, const void* w_enc, const float* b_enc,
                   const void* w_dec, const void* err, const float* coeffs, float* dx,
                   int n_tokens, int C, int H, const svt::Levels& lv, cudaStream_t stream) {
  if (bad_shape(n_tokens, C, C, H)) return cudaErrorInvalidValue;
  DxFwd<true> d{};
  d.coeffs = coeffs;
  d.err = err;
  if (!bf16)
    return svt::launch(coder_fwd_kernel<float, false, true>, n_tokens / kFwdTT, fwd_smem_bytes(),
                       stream, static_cast<const float*>(x), static_cast<const float*>(w_enc),
                       b_enc, static_cast<const float*>(w_dec), nullptr, dx, nullptr, nullptr,
                       nullptr, C, C, H, lv, d, ActFwd{});
  if (bad_tc_operands(C, C, x, w_enc, w_dec, err)) return cudaErrorInvalidValue;
  CUtensorMap mx, mwe, mwd;
  cudaError_t e;
  if ((e = bf16_map(&mx, x, n_tokens, C, 64)) != cudaSuccess ||
      (e = bf16_map(&mwe, w_enc, C, H, 64)) != cudaSuccess ||
      (e = bf16_map(&mwd, w_dec, H, C, 64)) != cudaSuccess ||
      (e = bf16_map(&d.m_err, err, lv.n * n_tokens, C, 64)) != cudaSuccess)
    return e;
  if (C <= 256)
    return svt::launch(coder_fwd_tc_hold<256, false, Act::Relu, true>, n_tokens / kHoldTT,
                       hold_smem_bytes(), stream, mx, mwe, mwd, b_enc, nullptr, dx, nullptr,
                       nullptr, nullptr, C, C, H, lv, ActFwd{}, d);
  TcFwd a{};  // coder_fwd_tc takes the dx operands in its TcFwd (coder.cuh)
  a.m_err = d.m_err;
  a.coeffs = coeffs;
  a.err = err;
  return svt::launch(coder_fwd_tc<false, Act::Relu, true>, n_tokens / kTcFwdTT,
                     fwd_tc_smem_bytes(), stream, mx, mwe, mwd, b_enc, nullptr, dx, nullptr,
                     nullptr, nullptr, C, C, H, lv, a);
}

}  // namespace

// ---------------------------------------------------------------------------
// ReLU SAE (ops/fused_sae.py). bf16 != 0 selects __nv_bfloat16 operands, else
// float.
// ---------------------------------------------------------------------------

// x is the [T, C] input shared by the n_combo combos, w_enc [n_combo, C, H],
// b_enc [n_combo, H], w_dec [n_combo, H, C], b_dec [n_combo, C]; x_cent is
// [n_combo, T, C] in the operand type; recon [n_split, n_combo, T, C] f32;
// act_part and zsum_part [n_combo, T / 64, H] (per-64-token partials),
// row_active [n_split, n_combo, T] (n_split: coder.cuh, "Splits"; 1 but in
// bf16 above C 512).
extern "C" int svt_sae_sweep_fwd(int bf16, const void* x, const void* w_enc,
                                 const float* b_enc, const void* w_dec, const float* b_dec,
                                 void* x_cent, float* recon, float* act_part, float* row_active,
                                 float* zsum_part, int n_tokens, int C, int H, int n_combo,
                                 int n_split, cudaStream_t stream) {
  return sae_fwd<false>(bf16, x, w_enc, b_enc, w_dec, b_dec, x_cent, recon, act_part,
                        row_active, zsum_part, n_tokens, C, H, svt::one_level(H), n_combo,
                        n_split, stream);
}

// one dictionary: the sweep's entry point at n_combo = 1
extern "C" int svt_sae_fwd(int bf16, const void* x, const void* w_enc, const float* b_enc,
                           const void* w_dec, const float* b_dec, void* x_cent, float* recon,
                           float* act_part, float* row_active, float* zsum_part, int n_tokens,
                           int C, int H, int n_split, cudaStream_t stream) {
  return svt_sae_sweep_fwd(bf16, x, w_enc, b_enc, w_dec, b_dec, x_cent, recon, act_part,
                           row_active, zsum_part, n_tokens, C, H, 1, n_split, stream);
}

// err is the [n_combo, T, C] residual recon - x; coeffs is a [n_combo, 2] device
// array (c_rec, c_l1), ct the [n_combo, H] L1 cotangent (c_l1 broadcast);
// db_dec_part is [n_combo, direct rows + H / 64, C] (direct rows: ceil(T / 512)
// in bf16, 2 in f32); x_cent, the weights and the gradients [n_combo, ...],
// n_split and split_ws as coder.cuh's bwd_tc takes them (bwd_pair's where
// ``pair`` is non-zero: the cluster pair, sae_bwd, with err_s its [n_combo, T,
// C] bf16 workspace; null otherwise).
extern "C" int svt_sae_sweep_bwd(int bf16, const void* x_cent, const void* w_enc,
                                 const float* b_enc, const void* w_dec, const void* err,
                                 const float* coeffs, const float* ct, float* dw_enc,
                                 float* db_enc, float* dw_dec, float* db_dec_part,
                                 void* split_ws, void* err_s, int n_tokens, int C, int H,
                                 int n_combo, int pair, int n_split, cudaStream_t stream) {
  return sae_bwd(bf16, x_cent, w_enc, b_enc, w_dec, err, coeffs, ct, dw_enc, db_enc, dw_dec,
                 db_dec_part, split_ws, pair ? err_s : nullptr, n_tokens, C, H,
                 svt::one_level(H), n_combo, pair, n_split, stream);
}

extern "C" int svt_sae_bwd(int bf16, const void* x_cent, const void* w_enc, const float* b_enc,
                           const void* w_dec, const void* err, const float* coeffs,
                           const float* ct, float* dw_enc, float* db_enc, float* dw_dec,
                           float* db_dec_part, void* split_ws, void* err_s, int n_tokens,
                           int C, int H, int pair, int n_split, cudaStream_t stream) {
  return svt_sae_sweep_bwd(bf16, x_cent, w_enc, b_enc, w_dec, err, coeffs, ct, dw_enc, db_enc,
                           dw_dec, db_dec_part, split_ws, err_s, n_tokens, C, H, 1, pair,
                           n_split, stream);
}

// The clusters of two coder_bwd_pair<Act::Relu> CTAs that the card holds at
// once, into *out (-1 where the query fails): a query, no launch.
extern "C" int svt_sae_pair_clusters(int* out) {
  *out = pair_clusters<Act::Relu>();
  return *out < 0 ? cudaErrorInvalidValue : cudaSuccess;
}

// dx is [T, C] f32; x_cent is the forward's centred input, err the [T, C]
// residual in the operand type, coeffs = (c_rec, c_l1). One dictionary.
extern "C" int svt_sae_dx(int bf16, const void* x_cent, const void* w_enc, const float* b_enc,
                          const void* w_dec, const void* err, const float* coeffs, float* out,
                          int n_tokens, int C, int H, cudaStream_t stream) {
  return sae_dx(bf16, x_cent, w_enc, b_enc, w_dec, err, coeffs, out, n_tokens, C, H,
                svt::one_level(H), stream);
}

// ---------------------------------------------------------------------------
// Matryoshka SAE (ops/fused_matryoshka_sae.py): ``bounds`` is a host array of
// the n_levels prefix latent counts, shared by the combos. s is the [n_combo,
// P, T, C] suffix-weighted error and coeffs [n_combo, 2] = (1, c_l1).
// ---------------------------------------------------------------------------

// prefix_recon is [n_split, n_combo, P, T, C] f32; x_cent, act_part,
// zsum_part and row_active as for svt_sae_sweep_fwd.
extern "C" int svt_matryoshka_sweep_fwd(int bf16, const void* x, const void* w_enc,
                                        const float* b_enc, const void* w_dec,
                                        const float* b_dec, void* x_cent, float* prefix_recon,
                                        float* act_part, float* row_active, float* zsum_part,
                                        int n_tokens, int C, int H, const int* bounds,
                                        int n_levels, int n_combo, int n_split,
                                        cudaStream_t stream) {
  svt::Levels lv;
  if (!svt::make_levels(bounds, n_levels, H, kFwdLG, &lv)) return cudaErrorInvalidValue;
  return sae_fwd<true>(bf16, x, w_enc, b_enc, w_dec, b_dec, x_cent, prefix_recon, act_part,
                       row_active, zsum_part, n_tokens, C, H, lv, n_combo, n_split, stream);
}

extern "C" int svt_matryoshka_fwd(int bf16, const void* x, const void* w_enc,
                                  const float* b_enc, const void* w_dec, const float* b_dec,
                                  void* x_cent, float* prefix_recon, float* act_part,
                                  float* row_active, float* zsum_part, int n_tokens, int C,
                                  int H, const int* bounds, int n_levels, int n_split,
                                  cudaStream_t stream) {
  return svt_matryoshka_sweep_fwd(bf16, x, w_enc, b_enc, w_dec, b_dec, x_cent, prefix_recon,
                                  act_part, row_active, zsum_part, n_tokens, C, H, bounds,
                                  n_levels, 1, n_split, stream);
}

// db_dec_part as for svt_sae_sweep_bwd; the direct rows sum S_0. ``pair``
// non-zero runs the cluster pair on S as it is (sae_bwd, no err_s).
extern "C" int svt_matryoshka_sweep_bwd(int bf16, const void* x_cent, const void* w_enc,
                                        const float* b_enc, const void* w_dec, const void* s,
                                        const float* coeffs, const float* ct, float* dw_enc,
                                        float* db_enc, float* dw_dec, float* db_dec_part,
                                        void* split_ws, int n_tokens, int C, int H,
                                        const int* bounds, int n_levels, int n_combo, int pair,
                                        int n_split, cudaStream_t stream) {
  svt::Levels lv;
  if (!svt::make_levels(bounds, n_levels, H, kFwdLG, &lv)) return cudaErrorInvalidValue;
  return sae_bwd(bf16, x_cent, w_enc, b_enc, w_dec, s, coeffs, ct, dw_enc, db_enc, dw_dec,
                 db_dec_part, split_ws, nullptr, n_tokens, C, H, lv, n_combo, pair, n_split,
                 stream);
}

extern "C" int svt_matryoshka_bwd(int bf16, const void* x_cent, const void* w_enc,
                                  const float* b_enc, const void* w_dec, const void* s,
                                  const float* coeffs, const float* ct, float* dw_enc,
                                  float* db_enc, float* dw_dec, float* db_dec_part,
                                  void* split_ws, int n_tokens, int C, int H, const int* bounds,
                                  int n_levels, int pair, int n_split, cudaStream_t stream) {
  return svt_matryoshka_sweep_bwd(bf16, x_cent, w_enc, b_enc, w_dec, s, coeffs, ct, dw_enc,
                                  db_enc, dw_dec, db_dec_part, split_ws, n_tokens, C, H, bounds,
                                  n_levels, 1, pair, n_split, stream);
}

// dx as for svt_sae_dx, from the suffix-weighted error S [P, T, C]. One
// dictionary.
extern "C" int svt_matryoshka_dx(int bf16, const void* x_cent, const void* w_enc,
                                 const float* b_enc, const void* w_dec, const void* s,
                                 const float* coeffs, float* out, int n_tokens, int C, int H,
                                 const int* bounds, int n_levels, cudaStream_t stream) {
  svt::Levels lv;
  if (!svt::make_levels(bounds, n_levels, H, kFwdLG, &lv)) return cudaErrorInvalidValue;
  return sae_dx(bf16, x_cent, w_enc, b_enc, w_dec, s, coeffs, out, n_tokens, C, H, lv, stream);
}
