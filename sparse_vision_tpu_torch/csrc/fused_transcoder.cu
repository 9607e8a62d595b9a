// Fused transcoder and crosscoder kernels for Hopper (sm_90a): the C entry
// points of the coder body family (coder.cuh, which holds the bodies, their
// header note and what they replace: sparse_vision_tpu/ops/fused_transcoder.py
// _fwd_kernel :41 / _bwd_kernel :91 and fused_crosscoder.py _fwd_kernel :68 /
// _bwd_kernel :109). The bodies' SAE additions are off here (kPrefix, kSae
// false). Entry points use a plain C interface (pointers, sizes, stream) and
// return the cudaError_t of the launch; the Python wrappers
// (ops/fused_transcoder.py, ops/fused_crosscoder.py) raise on a non-zero value.

#include "coder.cuh"

// act_part and zsum_part are [n_tokens / 64, H] (per-64-token partials), recon
// [n_split, n_tokens, c_out] f32, row_active [n_split, n_tokens] (coder_fwd;
// n_split > 1 in bf16 above c_out 512 only: coder.cuh, "Splits").
extern "C" int svt_coder_fwd(int bf16, const void* x, const void* w_enc, const float* b_enc,
                             const void* w_dec, const float* b_dec, float* recon,
                             float* act_part, float* row_active, float* zsum_part,
                             int n_tokens, int c_in, int c_out, int H, int n_split,
                             cudaStream_t stream) {
  return coder_fwd<false>(bf16, x, w_enc, b_enc, w_dec, b_dec, recon, act_part, row_active,
                          zsum_part, n_tokens, c_in, c_out, H, svt::one_level(H), stream, 1,
                          n_split);
}

// err is [n_tokens, c_out] in the operand type; coeffs is a 1-float device array
// (c_rec), ct the [H] per-latent L1 cotangent; outputs as coder_bwd's; n_split
// and split_ws as bwd_tc's (n_split > 1 in bf16 only); held != 0 runs the held
// route's passes (coder.cuh bwd_held; ops/fused_sae.bwd_route decides).
extern "C" int svt_coder_bwd(int bf16, const void* x, const void* w_enc, const float* b_enc,
                             const void* w_dec, const void* err, const float* coeffs,
                             const float* ct, float* dw_enc, float* db_enc, float* dw_dec,
                             float* db_dec_part, void* split_ws, int n_tokens, int c_in,
                             int c_out, int H, int held, int n_split, cudaStream_t stream) {
  return coder_bwd<false>(bf16, x, w_enc, b_enc, w_dec, err, coeffs, ct, dw_enc, db_enc, dw_dec,
                          db_dec_part, n_tokens, c_in, c_out, H,
                          SaeBwd{svt::one_level(H), nullptr, nullptr}, stream, 1, n_split,
                          split_ws, held);
}
