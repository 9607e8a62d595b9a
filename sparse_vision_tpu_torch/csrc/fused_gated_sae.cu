// Fused Gated-SAE training kernels for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels of sparse_vision_tpu/ops/fused_gated_sae.py:
//   svt_gated_fwd <- _fwd_kernel (:42), launched by pallas_call :234
//   svt_gated_bwd <- _bwd_kernel (:98), launched by pallas_call :292
//   svt_gated_sweep_fwd / _bwd <- both under jax.vmap (train/sweep_vmap.py
//       :144-149, :213-215): n_combo stacked dictionaries on one shared x in
//       one launch of each body (coder.cuh, "Combos"; the forward above C 256
//       two, each for all combos); the one-dictionary entry points are their
//       n_combo = 1 calls
//
// What bounds them. At the training shape (T = 32,768 tokens, C = 256 channels,
// H = 16,384 latents) the forward is 6*T*C*H = 0.82 TFLOP (one gate product
// feeding gate and magnitude, then two decodes: recon and via_gate) and the
// backward 10*T*C*H = 1.4 TFLOP (the gate product again, two products with
// W_dec^T, dW_gate and dW_dec), against ~130 MB of operands: bounded by
// arithmetic as long as no [T, H] matrix (2 GB in f32) reaches device memory.
//
// In bf16 (the training path) both run the coder body family's tensor-core
// bodies (coder.cuh: wgmma/TMA, any width, T and H multiples of 128, C of 8)
// with the gated epilogues, after center_kernel (x_cent; the backward
// recomputes it from the saved x):
//   forward, C <= 256: coder_fwd_tc_hold<256, false, Act::Gated>. One gate
//     product g feeds both paths; the epilogue writes round_bf16(enc) and
//     round_bf16(relu_pi) into two post blocks, counts enc != 0 and sums
//     relu_pi (the L1 statistic), and every W_dec tile feeds both decodes,
//     recon and via held in registers together (6*T*C*H FLOP);
//   forward, C > 256: two held outputs would need 256 accumulator floats a
//     thread, and coder_fwd_tc's post buffer cannot double in shared memory,
//     so the route is two launches of the ReLU forward's width route
//     (fwd_tc): Act::GatedEnc writes recon and the counts, Act::GatedPi via
//     and the zsum partials. The gate product runs twice (8*T*C*H);
//   backward: scale_err_kernel twice (round_bf16(c_rec * err_rec) with the
//     direct db_dec rows, and round_bf16(c_aux * err_via), which gives b_dec
//     no gradient) into one [2, T, C] workspace, then at C <= 256 where the
//     caller's route (ops/fused_sae.bwd_route) says "pair" the cluster pair
//     coder_bwd_pair<Act::Gated> (E holds dW_gate and sends g in f32, D runs
//     the gated epilogue and its three products, holds dW_dec and sends
//     round_bf16(dg) back), else coder_bwd_tc<true, Act::Gated>, whose third
//     phase-A product reads the workspace's second half.
//
// In f32 (the check path) both run the coder family's SIMT bodies with the
// same epilogues (any width, T and H multiples of 128) after center_kernel:
// the forward is two launches at every width, coder_fwd_kernel<float, false,
// false, Act::GatedEnc> (recon and the counts) then <..., Act::GatedPi> (via
// and the sums), because the SIMT body updates its output in place and holds
// no second one; the backward, coder_bwd_kernel<float, true, Act::Gated>,
// reads both saved f32 errors from one [2, T, C] workspace (copies of them)
// and scales them itself.
//
// Numerics follow the Pallas kernels' cast points. The operand type T (float or
// bf16) is the compute dtype; x, W_gate and W_dec arrive already cast to T;
// er = exp(r_mag) and both saved errors arrive in f32. Inside:
//   x_cent = round_T(x - round_T(b_dec))   g = x_cent @ W_gate (f32 sum)
//   pre_gate = g + b_gate                  pre_mag = g * er + b_mag
//   gate = 1 / 0.5 / 0 at pre_gate > / == / < 0     enc = gate * relu(pre_mag)
//   recon = round_T(enc) @ W_dec + b_dec   via = round_T(relu(pre_gate)) @ W_dec + b_dec
//   backward: drecon = c_rec * err_rec, dvia = c_aux * err_via (f32),
//   denc = round_T(drecon) @ W_dec^T, d_relu_pi = round_T(dvia) @ W_dec^T + c_l1,
//   d_premag = denc * gate * [pre_mag > 0], d_pregate = pre_gate > 0 ? d_relu_pi : 0,
//   dg = d_premag * er + d_pregate,
//   dW_gate = x_cent^T @ round_T(dg), dW_dec = round_T(enc)^T @ round_T(drecon),
//   db_gate = sum d_pregate, db_mag = sum d_premag, dr_mag = (sum d_premag * g) * er,
//   db_dec = sum drecon - round_T(sum dg) @ W_gate^T (via_gate gives W_dec and
//   b_dec no gradient).
// Products and sums that the Pallas body writes as separate operations are kept
// separate (__fmul_rn / __fadd_rn), not contracted to FMAs. Cross-block sums
// leave as per-block partials that the caller reduces; no float atomics, so two
// runs on the same inputs give the same bits.
//
// Entry points have a plain C interface (pointers, sizes, stream) and return the
// cudaError_t of the launch; ops/fused_gated_sae.py raises on a non-zero value.
// Supported shapes (ops/fused_gated_sae.py can_fuse, the coder bodies' rule):
// T and H multiples of 128, in bf16 C a multiple of 8.

#include "coder.cuh"

// x is the [n_tokens, C] input shared by the n_combo combos; every other
// operand and output has a leading [n_combo] axis: er is exp(r_mag) [n_combo,
// H] in f32; x_cent an [n_combo, n_tokens, C] workspace in the operand type
// (center_kernel's output); act_part and l1_part (the zsum partials of
// relu_pi, whose total is the L1 sum) [n_combo, n_tokens / 64, H]. bf16 != 0:
// __nv_bfloat16 operands (fwd_tc: one launch to C = 256, two wider), else
// float (fwd_simt: two launches). recon, via and row_active gain a leading
// [n_split] axis (coder.cuh, "Splits": bf16 above C 512 only, both launches).
extern "C" int svt_gated_sweep_fwd(int bf16, const void* x, const void* w_gate,
                                   const float* b_gate, const float* b_mag, const float* er,
                                   const void* w_dec, const float* b_dec, float* recon,
                                   float* via, float* act_part, float* row_active,
                                   float* l1_part, void* x_cent, int n_tokens, int C, int H,
                                   int n_combo, int n_split, cudaStream_t stream) {
  if (bad_shape(n_tokens, C, C, H) || bad_combos(n_combo, H) ||
      (bf16 && bad_tc_operands(C, C, x, x_cent, w_gate, w_dec)) || (!bf16 && n_split != 1))
    return cudaErrorInvalidValue;
  cudaError_t e = launch_center(bf16, x, b_dec, x_cent, n_tokens, C, stream, n_combo);
  if (e != cudaSuccess) return e;
  const svt::Levels lv = svt::one_level(H);
  ActFwd af{};
  af.b_mag = b_mag;
  af.er = er;
  if (bf16 && C <= 256) {  // recon and via held together
    af.via = via;
    return fwd_tc<false, Act::Gated>(x_cent, w_gate, b_gate, w_dec, b_dec, recon, act_part,
                                     row_active, l1_part, n_tokens, C, C, H, lv, af, stream,
                                     n_combo, n_split);
  }
  if (bf16) {
    if ((e = fwd_tc<false, Act::GatedEnc>(x_cent, w_gate, b_gate, w_dec, b_dec, recon, act_part,
                                          row_active, nullptr, n_tokens, C, C, H, lv, af,
                                          stream, n_combo, n_split)) != cudaSuccess)
      return e;
    return fwd_tc<false, Act::GatedPi>(x_cent, w_gate, b_gate, w_dec, b_dec, via, nullptr,
                                       nullptr, l1_part, n_tokens, C, C, H, lv, af, stream,
                                       n_combo, n_split);
  }
  if ((e = fwd_simt<false, Act::GatedEnc>(x_cent, w_gate, b_gate, w_dec, b_dec, recon, act_part,
                                          row_active, nullptr, n_tokens, C, C, H, lv, af,
                                          stream, n_combo)) != cudaSuccess)
    return e;
  return fwd_simt<false, Act::GatedPi>(x_cent, w_gate, b_gate, w_dec, b_dec, via, nullptr,
                                       nullptr, l1_part, n_tokens, C, C, H, lv, af, stream,
                                       n_combo);
}

extern "C" int svt_gated_fwd(int bf16, const void* x, const void* w_gate,
                             const float* b_gate, const float* b_mag, const float* er,
                             const void* w_dec, const float* b_dec, float* recon, float* via,
                             float* act_part, float* row_active, float* l1_part, void* x_cent,
                             int n_tokens, int C, int H, int n_split, cudaStream_t stream) {
  return svt_gated_sweep_fwd(bf16, x, w_gate, b_gate, b_mag, er, w_dec, b_dec, recon, via,
                             act_part, row_active, l1_part, x_cent, n_tokens, C, H, 1, n_split,
                             stream);
}

// err_rec and err_via are the f32 residuals recon - x and via - x [n_combo,
// n_tokens, C]; coeffs is an [n_combo, 3] device array (c_rec, c_l1, c_aux).
// x_cent [n_combo, n_tokens, C] and err_s [n_combo, 2, n_tokens, C] are
// workspaces in the operand type, and db_dec_part [n_combo, rows, C] holds a
// combo's direct rows of db_dec, then one centring row per 64 latents (H / 64
// rows). bf16: err_s gets scale_err_kernel's round_bf16(c_rec * err_rec)
// (with the ceil(n_tokens / 512) direct rows) and round_bf16(c_aux *
// err_via), then coder_bwd_tc<true, Act::Gated>, or coder_bwd_pair<Act::Gated>
// where ``pair`` is non-zero (the caller's route, ops/fused_sae.bwd_route,
// decides; C <= 256, else cudaErrorInvalidValue) (n_split and split_ws:
// coder.cuh, bwd_tc and bwd_pair); float: err_s gets copies of err_rec and
// err_via, then coder_bwd_kernel<float, true, Act::Gated> (2 direct rows),
// never split or paired.
extern "C" int svt_gated_sweep_bwd(int bf16, const void* x, const void* w_gate,
                                   const float* b_gate, const float* b_mag, const float* er,
                                   const void* w_dec, const float* b_dec, const float* err_rec,
                                   const float* err_via, const float* coeffs, float* dw_gate,
                                   float* db_gate, float* db_mag, float* dr_mag, float* dw_dec,
                                   float* db_dec_part, void* x_cent, void* err_s,
                                   void* split_ws, int n_tokens, int C, int H, int n_combo,
                                   int pair, int n_split, cudaStream_t stream) {
  if (bad_shape(n_tokens, C, C, H) || bad_combos(n_combo, H) ||
      (bf16 && bad_tc_operands(C, C, x, x_cent, w_gate, w_dec)) ||
      (!bf16 && (n_split != 1 || pair)) || (pair && C > kPairCmax))
    return cudaErrorInvalidValue;
  const long n = static_cast<long>(n_tokens) * C;
  const long direct = bf16 ? (n_tokens + kTcBwdTS - 1) / kTcBwdTS : 2;
  const long part = (direct + H / kTcBwdTH) * C;  // a combo's db_dec_part
  cudaError_t e;
  if ((e = launch_center(bf16, x, b_dec, x_cent, n_tokens, C, stream, n_combo)) != cudaSuccess)
    return e;
  if (bf16) {
    if ((e = launch_scale_err(err_rec, coeffs, err_s, db_dec_part, n_tokens, C, stream, n_combo,
                              2 * n, part, 3)) != cudaSuccess ||
        (e = launch_scale_err(err_via, coeffs + 2, static_cast<__nv_bfloat16*>(err_s) + n,
                              nullptr, n_tokens, C, stream, n_combo, 2 * n, 0, 3)) !=
            cudaSuccess)
      return e;
  } else {
    float* es = static_cast<float*>(err_s);
    const size_t row = n * sizeof(float);  // one combo's error, into its half of err_s
    if ((e = cudaMemcpy2DAsync(es, 2 * row, err_rec, row, row, n_combo,
                               cudaMemcpyDeviceToDevice, stream)) != cudaSuccess ||
        (e = cudaMemcpy2DAsync(es + n, 2 * row, err_via, row, row, n_combo,
                               cudaMemcpyDeviceToDevice, stream)) != cudaSuccess)
      return e;
  }
  SaeBwd sae{svt::one_level(H), w_gate, db_dec_part + direct * C};
  sae.act.b_mag = b_mag;
  sae.act.er = er;
  sae.act.db_mag = db_mag;
  sae.act.dr_mag = dr_mag;
  if (pair)
    return bwd_pair<Act::Gated>(x_cent, w_gate, b_gate, w_dec, err_s, 2 * n_tokens, coeffs,
                                nullptr, dw_gate, db_gate, dw_dec, n_tokens, C, H, sae, stream,
                                n_combo, n_split, split_ws);
  if (bf16)
    return bwd_tc<true, Act::Gated>(x_cent, w_gate, b_gate, w_dec, err_s, 2 * n_tokens, coeffs,
                                    nullptr, dw_gate, db_gate, dw_dec, nullptr, n_tokens, C, C,
                                    H, sae, stream, n_combo, n_split, split_ws);
  return bwd_simt<true, Act::Gated>(x_cent, w_gate, b_gate, w_dec, err_s, coeffs, nullptr,
                                    dw_gate, db_gate, dw_dec, db_dec_part, n_tokens, C, C, H, sae,
                                    stream, n_combo);
}

extern "C" int svt_gated_bwd(int bf16, const void* x, const void* w_gate,
                             const float* b_gate, const float* b_mag, const float* er,
                             const void* w_dec, const float* b_dec, const float* err_rec,
                             const float* err_via, const float* coeffs, float* dw_gate,
                             float* db_gate, float* db_mag, float* dr_mag, float* dw_dec,
                             float* db_dec_part, void* x_cent, void* err_s, void* split_ws,
                             int n_tokens, int C, int H, int pair, int n_split,
                             cudaStream_t stream) {
  return svt_gated_sweep_bwd(bf16, x, w_gate, b_gate, b_mag, er, w_dec, b_dec, err_rec,
                             err_via, coeffs, dw_gate, db_gate, db_mag, dr_mag, dw_dec,
                             db_dec_part, x_cent, err_s, split_ws, n_tokens, C, H, 1, pair,
                             n_split, stream);
}

// The clusters of two coder_bwd_pair<Act::Gated> CTAs that the card holds at
// once, into *out (-1 where the query fails): a query, no launch.
extern "C" int svt_gated_pair_clusters(int* out) {
  *out = pair_clusters<Act::Gated>();
  return *out < 0 ? cudaErrorInvalidValue : cudaSuccess;
}
