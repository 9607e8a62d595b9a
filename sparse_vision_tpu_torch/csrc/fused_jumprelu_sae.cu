// Fused JumpReLU-SAE training kernels for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels of sparse_vision_tpu/ops/fused_jumprelu_sae.py:
//   svt_jumprelu_fwd <- _fwd_kernel (:30), launched by pallas_call :192
//   svt_jumprelu_bwd <- _bwd_kernel (:80), launched by pallas_call :248
//   svt_jumprelu_sweep_fwd / _bwd <- both under jax.vmap (train/sweep_vmap.py
//       :150-157, :213-215): n_combo stacked dictionaries on one shared x in
//       one launch of each body (coder.cuh, "Combos"); the one-dictionary
//       entry points are their n_combo = 1 calls
//
// What bounds them. At the training shape (T = 32,768 tokens, C = 256 channels,
// H = 16,384 latents) the forward is 4*T*C*H = 0.55 TFLOP and the backward
// 8*T*C*H = 1.1 TFLOP against ~100 MB of operands: both are bounded by
// arithmetic as long as the [T, H] latent matrix (2 GB in f32) never reaches
// device memory.
//
// In bf16 (the training path) both run the coder body family's tensor-core
// bodies (coder.cuh: wgmma/TMA, any width, T and H multiples of 128, C of 8)
// with the JumpReLU epilogues (Act::Jump), after center_kernel (x_cent; the
// backward recomputes it from the saved x: ~0.01 ms):
//   forward:  fwd_tc<false, Act::Jump>, the ReLU forward's width route
//             (coder_fwd_tc_hold<256> for C <= 256, <512> to 512, coder_fwd_tc
//             above) with post = pre > theta ? pre : 0, activity counted where
//             post != 0 and the per-latent sums of post as zsum partials (the
//             L1 sum is their total: post >= 0 since theta > 0);
//   backward: coder_bwd_tc<true, Act::Jump> after scale_err_kernel
//             (round_bf16(c_rec * err) from the saved f32 err, the Pallas cast
//             point, and the direct db_dec rows): the strict mask, no L1
//             cotangent, and the STE window's dtheta; or, where
//             ops/fused_sae.bwd_route says "pair" (C <= 256), coder_bwd_pair<
//             Act::Jump> after the same pre-passes: two CTAs of a cluster a
//             latent block, one holding dW_enc and one dW_dec in registers
//             for the whole sweep, trading post and dpre through distributed
//             shared memory (coder.cuh).
//
// In f32 (the check path: TF32 would miss its tolerances) both run the coder
// family's SIMT bodies with the same epilogues (coder_fwd_kernel<float, false,
// false, Act::Jump>, coder_bwd_kernel<float, true, Act::Jump>; any width, T
// and H multiples of 128) after center_kernel; the backward reads the saved f32
// error itself (c_rec applied in the body, no pre-pass).
//
// Numerics follow the Pallas kernels' cast points. The operand type T (float or
// bf16) is the compute dtype; x, W_enc and W_dec arrive already cast to T,
// theta = exp(log_theta) and the saved error arrive in f32. Inside:
//   x_cent = round_T(x - round_T(b_dec))       pre = x_cent @ W_enc (f32) + b_enc
//   post   = pre > theta ? pre : 0 (strict)    recon = round_T(post) @ W_dec + b_dec
//   backward: drecon = c_rec * err (f32), dpost = round_T(drecon) @ W_dec^T,
//   dpre = pre > theta ? dpost : 0 (no sparsity term: the L0 moves only theta),
//   win = |pre - theta| <= eps/2 (inclusive),
//   dtheta = sum_t win * (dpost * (-theta/eps) + c_l0 * (-1/eps)).
// eps is a runtime argument (static in the Pallas kernel). Cross-block sums leave
// as per-block partials that the caller reduces; within a block every partial
// has a fixed summation order and no float atomics are used, so two runs on the
// same inputs give the same bits.
//
// Entry points have a plain C interface (pointers, sizes, stream) and return the
// cudaError_t of the launch; ops/fused_jumprelu_sae.py raises on a non-zero
// value. Supported shapes (ops/fused_jumprelu_sae.py can_fuse, the coder
// bodies' rule): T and H multiples of 128, in bf16 C a multiple of 8.

#include "coder.cuh"

// x is the [n_tokens, C] input shared by the n_combo combos; every other
// operand and output has a leading [n_combo] axis: thr is exp(log_threshold)
// [n_combo, H] in f32; x_cent an [n_combo, n_tokens, C] workspace in the
// operand type (center_kernel's output); act_part and l1_part (the zsum
// partials of post, whose total is the L1 sum) [n_combo, n_tokens / 64, H].
// bf16 != 0: __nv_bfloat16 operands (fwd_tc), else float (fwd_simt). recon and
// row_active gain a leading [n_split] axis (coder.cuh, "Splits": bf16 above C
// 512 only).
extern "C" int svt_jumprelu_sweep_fwd(int bf16, const void* x, const void* w_enc,
                                      const float* b_enc, const float* thr, const void* w_dec,
                                      const float* b_dec, float* recon, float* act_part,
                                      float* row_active, float* l1_part, void* x_cent,
                                      int n_tokens, int C, int H, int n_combo, int n_split,
                                      cudaStream_t stream) {
  if (bad_shape(n_tokens, C, C, H) || bad_combos(n_combo, H) ||
      (bf16 && bad_tc_operands(C, C, x, x_cent, w_enc, w_dec)) || (!bf16 && n_split != 1))
    return cudaErrorInvalidValue;
  const cudaError_t e = launch_center(bf16, x, b_dec, x_cent, n_tokens, C, stream, n_combo);
  if (e != cudaSuccess) return e;
  ActFwd af{};
  af.theta = thr;
  const svt::Levels lv = svt::one_level(H);
  if (bf16)
    return fwd_tc<false, Act::Jump>(x_cent, w_enc, b_enc, w_dec, b_dec, recon, act_part,
                                    row_active, l1_part, n_tokens, C, C, H, lv, af, stream,
                                    n_combo, n_split);
  return fwd_simt<false, Act::Jump>(x_cent, w_enc, b_enc, w_dec, b_dec, recon, act_part,
                                    row_active, l1_part, n_tokens, C, C, H, lv, af, stream,
                                    n_combo);
}

extern "C" int svt_jumprelu_fwd(int bf16, const void* x, const void* w_enc,
                                const float* b_enc, const float* thr, const void* w_dec,
                                const float* b_dec, float* recon, float* act_part,
                                float* row_active, float* l1_part, void* x_cent, int n_tokens,
                                int C, int H, int n_split, cudaStream_t stream) {
  return svt_jumprelu_sweep_fwd(bf16, x, w_enc, b_enc, thr, w_dec, b_dec, recon, act_part,
                                row_active, l1_part, x_cent, n_tokens, C, H, 1, n_split, stream);
}

// err is the f32 residual recon - x [n_combo, n_tokens, C]; coeffs is an
// [n_combo, 2] device array (c_rec, c_l0); eps, eps/2 and -1/eps come from the
// host in f32 (shared). x_cent is an [n_combo, n_tokens, C] workspace in the
// operand type (center_kernel's output) and db_dec_part [n_combo, rows, C]
// holds a combo's direct rows of db_dec, then one centring row per 64 latents
// (H / 64 rows). bf16: err_s is an [n_combo, n_tokens, C] bf16 workspace
// (scale_err_kernel's round_bf16(c_rec * err), with the ceil(n_tokens / 512)
// direct rows), then coder_bwd_tc<true, Act::Jump>, or coder_bwd_pair<Act::Jump>
// where ``pair`` is non-zero (the caller's route, ops/fused_sae.bwd_route, decides;
// C <= 256, else cudaErrorInvalidValue) (n_split and split_ws: coder.cuh, bwd_tc
// and bwd_pair); float: err_s unused, 2 direct rows, coder_bwd_kernel<float,
// true, Act::Jump> on err, never split or paired.
extern "C" int svt_jumprelu_sweep_bwd(int bf16, const void* x, const void* w_enc,
                                      const float* b_enc, const float* thr, const void* w_dec,
                                      const float* b_dec, const float* err,
                                      const float* coeffs, float eps, float half_eps,
                                      float neg_inv_eps, float* dw_enc, float* db_enc,
                                      float* dthr, float* dw_dec, float* db_dec_part,
                                      void* x_cent, void* err_s, void* split_ws, int n_tokens,
                                      int C, int H, int n_combo, int pair, int n_split,
                                      cudaStream_t stream) {
  if (bad_shape(n_tokens, C, C, H) || bad_combos(n_combo, H) ||
      (bf16 && bad_tc_operands(C, C, x, x_cent, w_enc, w_dec)) ||
      (!bf16 && (n_split != 1 || pair)) || (pair && C > kPairCmax))
    return cudaErrorInvalidValue;
  const long direct = bf16 ? (n_tokens + kTcBwdTS - 1) / kTcBwdTS : 2;
  const long part = (direct + H / kTcBwdTH) * C;  // a combo's db_dec_part
  cudaError_t e;
  if ((e = launch_center(bf16, x, b_dec, x_cent, n_tokens, C, stream, n_combo)) !=
          cudaSuccess ||
      (bf16 && (e = launch_scale_err(err, coeffs, err_s, db_dec_part, n_tokens, C, stream,
                                     n_combo, static_cast<long>(n_tokens) * C, part, 2)) !=
                   cudaSuccess))
    return e;
  SaeBwd sae{svt::one_level(H), w_enc, db_dec_part + direct * C};
  sae.act.theta = thr;
  sae.act.dtheta = dthr;
  sae.act.eps = eps;
  sae.act.half_eps = half_eps;
  sae.act.neg_inv_eps = neg_inv_eps;
  if (pair)
    return bwd_pair<Act::Jump>(x_cent, w_enc, b_enc, w_dec, err_s, n_tokens, coeffs, nullptr,
                               dw_enc, db_enc, dw_dec, n_tokens, C, H, sae, stream, n_combo,
                               n_split, split_ws);
  if (bf16)
    return bwd_tc<true, Act::Jump>(x_cent, w_enc, b_enc, w_dec, err_s, n_tokens, coeffs,
                                   nullptr, dw_enc, db_enc, dw_dec, nullptr, n_tokens, C, C, H,
                                   sae, stream, n_combo, n_split, split_ws);
  return bwd_simt<true, Act::Jump>(x_cent, w_enc, b_enc, w_dec, err, coeffs, nullptr, dw_enc,
                                   db_enc, dw_dec, db_dec_part, n_tokens, C, C, H, sae, stream,
                                   n_combo);
}

extern "C" int svt_jumprelu_bwd(int bf16, const void* x, const void* w_enc,
                                const float* b_enc, const float* thr, const void* w_dec,
                                const float* b_dec, const float* err, const float* coeffs,
                                float eps, float half_eps, float neg_inv_eps,
                                float* dw_enc, float* db_enc, float* dthr, float* dw_dec,
                                float* db_dec_part, void* x_cent, void* err_s, void* split_ws,
                                int n_tokens, int C, int H, int pair, int n_split,
                                cudaStream_t stream) {
  return svt_jumprelu_sweep_bwd(bf16, x, w_enc, b_enc, thr, w_dec, b_dec, err, coeffs, eps,
                                half_eps, neg_inv_eps, dw_enc, db_enc, dthr, dw_dec,
                                db_dec_part, x_cent, err_s, split_ws, n_tokens, C, H, 1, pair,
                                n_split, stream);
}

// The clusters of two coder_bwd_pair<Act::Jump> CTAs that the card holds at
// once, into *out (-1 where the query fails): a query, no launch.
extern "C" int svt_jumprelu_pair_clusters(int* out) {
  *out = pair_clusters<Act::Jump>();
  return *out < 0 ? cudaErrorInvalidValue : cudaSuccess;
}
