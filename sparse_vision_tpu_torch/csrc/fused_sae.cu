// Fused ReLU-SAE and Matryoshka-SAE kernels for Hopper (sm_90a): the C entry
// points of the ops' forward and backward, the input centring they start with,
// and the input-gradient (dx) kernel.
//
// Replaces the Pallas TPU kernels of sparse_vision_tpu/ops/fused_sae.py and
// sparse_vision_tpu/ops/fused_matryoshka_sae.py:
//   svt_sae_fwd         <- fused_sae.py _fwd_kernel (:43), pallas_call :321
//   svt_sae_bwd         <- fused_sae.py _bwd_kernel (:96), pallas_call :391
//   sae_dx_kernel       <- fused_sae.py _dx_kernel (:168), pallas_call :422
//   svt_matryoshka_fwd  <- fused_matryoshka_sae.py _fwd_kernel (:99), pallas_call :292
//   svt_matryoshka_bwd  <- fused_matryoshka_sae.py _bwd_kernel (:155), pallas_call :371
//   sae_dx_kernel (P levels) <- fused_matryoshka_sae.py _dx_kernel (:227), pallas_call :404
//
// The forward and backward run the coder body family (coder.cuh: wgmma/TMA
// bodies in bf16, SIMT bodies in f32, any width) with Cin = Cout = C. The SAE
// is that dictionary on the centred input: the forward entry points first
// launch center_kernel (coder.cuh), x_cent = round_T(x - round_T(b_dec)), which the
// autograd function saves for the backward, so the backward entry points take
// x_cent and never centre again. The rest of the SAE's differences are the
// bodies' template flags (coder.cuh header note): the scalar c_l1 arrives as
// a per-latent cotangent (the caller broadcasts it), the L1 sum is the total
// of the zsum partials, the Matryoshka forward snapshots prefix_recon [P, T, C]
// at each prefix boundary (kPrefix), and the backward (kSae) reads S[level]
// and writes db_dec's centring term -round_T(db_enc tile) @ W_enc tile^T as one
// partial row per 64-latent block after the direct rows.
//
// Matryoshka (nested latent prefixes, boundaries b_0 < .. < b_{P-1} = H, each a
// multiple of 128 for the forward and backward, of kTH for dx): latent tile j
// of level q (b_{q-1} <= j < b_q) is read by every prefix p >= q, so its
// reconstruction cotangent is the suffix-weighted error S_q = sum_{p>=q} c_p
// err_p, computed by the caller; the backward and dx read S[level(j)] where the
// ReLU kernels read c_rec * err (c_rec = 1), and the ReLU op is the case P = 1.
//
// dx still runs the SIMT FMA body of the first port (f32 accumulation from
// shared memory, a template on C in {64, 128, 256}): it is on no training path.
// At the training shape (T = 32,768, C = 256, H = 16,384) it is 6*T*C*H =
// 0.82 PFLOP against ~50 MB of operands, bounded by arithmetic as long as the
// [T, H] latent matrix never reaches device memory; it holds one token tile's
// dx in registers while it sweeps every latent tile.
//
// Numerics follow the Pallas kernels' cast points exactly. The operand type T
// (float or bf16) is the compute dtype; x, W_enc, W_dec and the saved error
// arrive already cast to T:
//   x_cent = round_T(x - round_T(b_dec))              (a T-typed difference)
//   pre    = x_cent @ W_enc (f32 sum) + b_enc          (b_enc added in f32)
//   post   = max(pre, 0); the decode reads round_T(post)
//   recon  = sum_j round_T(post_j) @ W_dec_j + b_dec   (b_dec added in f32)
// Every cross-block sum leaves as a per-block partial that the caller reduces
// (activity counts, the L1 sum, both terms of db_dec): no float atomics, so
// two runs on the same inputs give the same bits.
//
// Entry points use a plain C interface (pointers, sizes, stream) and return the
// cudaError_t of the launch; the Python wrappers (ops/fused_sae.py,
// ops/fused_matryoshka_sae.py) raise on a non-zero value. Supported shapes:
// forward and backward as coder.cuh's (T and H multiples of 128, bf16 widths
// multiples of 8); dx C in {64, 128, 256}, T a multiple of kDxTT, H of kTH; at
// most kMaxLevels prefixes (can_fuse, can_fuse_matryoshka).

#include "coder.cuh"

namespace {

constexpr int kDxTT = 32;  // dx: tokens per block
constexpr int kTH = 64;    // dx: latents per tile

// The forward: center_kernel into x_cent, then the coder forward on x_cent.
template <bool kPrefix>
cudaError_t sae_fwd(int bf16, const void* x, const void* w_enc, const float* b_enc,
                    const void* w_dec, const float* b_dec, void* x_cent, float* recon,
                    float* act_part, float* row_active, float* zsum_part, int n_tokens, int C,
                    int H, const svt::Levels& lv, cudaStream_t stream) {
  if (bad_shape(n_tokens, C, C, H) || (bf16 && bad_tc_operands(C, C, x, x_cent, x_cent, x_cent)))
    return cudaErrorInvalidValue;
  cudaError_t e = launch_center(bf16, x, b_dec, x_cent, n_tokens, C, stream);
  if (e != cudaSuccess) return e;
  return coder_fwd<kPrefix>(bf16, x_cent, w_enc, b_enc, w_dec, b_dec, recon, act_part,
                            row_active, zsum_part, n_tokens, C, C, H, lv, stream);
}

// The backward on x_cent: db_dec_part holds the direct rows (coder_bwd's) and
// then H / 64 rows of the centring term.
cudaError_t sae_bwd(int bf16, const void* x_cent, const void* w_enc, const float* b_enc,
                    const void* w_dec, const void* err, const float* coeffs, const float* ct,
                    float* dw_enc, float* db_enc, float* dw_dec, float* db_dec_part,
                    int n_tokens, int C, int H, const svt::Levels& lv, cudaStream_t stream) {
  const long direct_rows = bf16 ? (n_tokens + kTcBwdTS - 1) / kTcBwdTS : 2;
  return coder_bwd<true>(bf16, x_cent, w_enc, b_enc, w_dec, err, coeffs, ct, dw_enc, db_enc,
                         dw_dec, db_dec_part, n_tokens, C, C, H,
                         SaeBwd{lv, w_enc, db_dec_part + direct_rows * C}, stream);
}

template <int C>
constexpr size_t dx_smem_bytes() {
  return sizeof(float) * (2 * kDxTT * (C + 1)  // xc_s, dr_s
                          + 2 * C * (kTH + 1)  // wenc_s, wdecT_s
                          + kDxTT * (kTH + 1)  // dpre_s
                          + kTH);              // benc_s
}

// dx, the gradient with respect to the input activations. One block owns
// kDxTT tokens and sweeps all H latents in kTH tiles, as the forward does;
// dx [kDxTT, C] stays in registers (rows ty*2+i, columns tx+16*j). Per tile of
// level q:
//   drecon = c_rec * err[q]              (f32; the products read round_T(drecon))
//   pre    = x_cent @ W_enc tile + b_enc
//   dpost  = round_T(drecon) @ W_dec tile^T + c_l1
//   dpre   = pre > 0 ? dpost : 0
//   dx    += round_T(dpre) @ W_enc tile^T
// starting from -drecon of level 0 (the direct path of rec = mean (recon - x)^2).
// The weight tiles are kept with a padded row (kTH + 1), so both the products
// that read them along the latents and the one that reads them along the
// channels are free of bank conflicts.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
sae_dx_kernel(const T* __restrict__ x, const T* __restrict__ w_enc,
              const float* __restrict__ b_enc, const T* __restrict__ w_dec,
              const float* __restrict__ b_dec, const T* __restrict__ err,
              const float* __restrict__ coeffs, float* __restrict__ dx, int H,
              const svt::Levels lv) {
  constexpr int TT = kDxTT, TH = kTH;
  constexpr int XS = C + 1;
  constexpr int WS = TH + 1;
  constexpr int CJ = C / 16;  // dx columns per thread
  extern __shared__ float smem[];
  float* xc_s = smem;                // [TT][XS]  centred input tile
  float* dr_s = xc_s + TT * XS;      // [TT][XS]  round_T(drecon) of the current level
  float* wenc_s = dr_s + TT * XS;    // [C][WS]   W_enc[:, h0:h0+TH]
  float* wdecT_s = wenc_s + C * WS;  // [C][WS]   W_dec[h0:h0+TH, :], transposed
  float* dpre_s = wdecT_s + C * WS;  // [TT][WS]  round_T(dpre)
  float* benc_s = dpre_s + TT * WS;  // [TH]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long t0 = static_cast<long>(blockIdx.x) * TT;
  const long level_stride = static_cast<long>(gridDim.x) * TT * C;
  const float c_rec = coeffs[0], c_l1 = coeffs[1];

  for (int i = tid; i < TT * C; i += kThreads) {
    const int r = i / C, k = i % C;
    xc_s[r * XS + k] = round_cd<T>(to_f(x[(t0 + r) * C + k]) - round_cd<T>(b_dec[k]));
  }
  float acc[2][CJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      acc[i][j] = -c_rec * to_f(err[(t0 + ty * 2 + i) * C + tx + 16 * j]);

  int level = -1;
  for (int h0 = 0; h0 < H; h0 += TH) {
    __syncthreads();  // the previous tile is done with every shared array
    const int q = svt::level_of(lv, h0);
    if (q != level) {  // the same for the whole block
      level = q;
      const T* e = err + q * level_stride;
      for (int i = tid; i < TT * C; i += kThreads) {
        const int r = i / C, k = i % C;
        dr_s[r * XS + k] = round_cd<T>(c_rec * to_f(e[(t0 + r) * C + k]));
      }
    }
    for (int i = tid; i < C * TH; i += kThreads) {
      const int k = i / TH, l = i % TH;
      wenc_s[k * WS + l] = to_f(w_enc[static_cast<long>(k) * H + h0 + l]);
    }
    for (int i = tid; i < TH * C; i += kThreads) {
      const int l = i / C, k = i % C;
      wdecT_s[k * WS + l] = to_f(w_dec[static_cast<long>(h0) * C + i]);
    }
    for (int i = tid; i < TH; i += kThreads) benc_s[i] = b_enc[h0 + i];
    __syncthreads();

    // pre and dpost [TT, TH]: rows ty*2+i, columns tx+16*j
    float pre[2][4], dpo[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pre[i][j] = dpo[i][j] = 0.f;
    for (int k = 0; k < C; ++k) {
      float a1[2], a2[2], b1[4], b2[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a1[i] = xc_s[(ty * 2 + i) * XS + k];
        a2[i] = dr_s[(ty * 2 + i) * XS + k];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1[j] = wenc_s[k * WS + tx + 16 * j];
        b2[j] = wdecT_s[k * WS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pre[i][j] = fmaf(a1[i], b1[j], pre[i][j]);
          dpo[i][j] = fmaf(a2[i], b2[j], dpo[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = pre[i][j] + benc_s[col];
        dpre_s[(ty * 2 + i) * WS + col] = round_cd<T>(p > 0.f ? dpo[i][j] + c_l1 : 0.f);
      }
    __syncthreads();

    // dx[r, k] += sum_l dpre[r, l] * W_enc[k, l]
    for (int l = 0; l < TH; ++l) {
      float a[2], b[CJ];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = dpre_s[(ty * 2 + i) * WS + l];
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = wenc_s[(tx + 16 * j) * WS + l];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dx[(t0 + ty * 2 + i) * C + tx + 16 * j] = acc[i][j];
}

cudaError_t launch_dx(int bf16, const void* x, const void* w_enc, const float* b_enc,
               const void* w_dec, const float* b_dec, const void* err, const float* coeffs,
               float* out, int n_tokens, int C, int H, const svt::Levels& lv,
               cudaStream_t stream) {
  if (n_tokens <= 0 || H <= 0 || n_tokens % kDxTT || H % kTH) return cudaErrorInvalidValue;
  return svt::dispatch(bf16, C, [&](auto t, auto c) {
    using T = decltype(t);
    constexpr int CC = decltype(c)::value;
    return svt::launch(sae_dx_kernel<T, CC>, n_tokens / kDxTT, dx_smem_bytes<CC>(), stream,
                       static_cast<const T*>(x), static_cast<const T*>(w_enc), b_enc,
                       static_cast<const T*>(w_dec), b_dec, static_cast<const T*>(err),
                       coeffs, out, H, lv);
  });
}


}  // namespace

// ---------------------------------------------------------------------------
// ReLU SAE (ops/fused_sae.py). bf16 != 0 selects __nv_bfloat16 operands, else
// float.
// ---------------------------------------------------------------------------

// x_cent is [n_tokens, C] in the operand type; recon [n_tokens, C] f32;
// act_part and zsum_part [n_tokens / 64, H] (per-64-token partials),
// row_active [n_tokens].
extern "C" int svt_sae_fwd(int bf16, const void* x, const void* w_enc, const float* b_enc,
                           const void* w_dec, const float* b_dec, void* x_cent, float* recon,
                           float* act_part, float* row_active, float* zsum_part, int n_tokens,
                           int C, int H, cudaStream_t stream) {
  return sae_fwd<false>(bf16, x, w_enc, b_enc, w_dec, b_dec, x_cent, recon, act_part,
                        row_active, zsum_part, n_tokens, C, H, svt::one_level(H), stream);
}

// err is the [T, C] residual recon - x; coeffs is a 2-float device array (c_rec,
// c_l1), ct the [H] L1 cotangent (c_l1 broadcast); db_dec_part is [direct rows +
// H / 64, C] (direct rows: ceil(T / 512) in bf16, 2 in f32).
extern "C" int svt_sae_bwd(int bf16, const void* x_cent, const void* w_enc, const float* b_enc,
                           const void* w_dec, const void* err, const float* coeffs,
                           const float* ct, float* dw_enc, float* db_enc, float* dw_dec,
                           float* db_dec_part, int n_tokens, int C, int H,
                           cudaStream_t stream) {
  return sae_bwd(bf16, x_cent, w_enc, b_enc, w_dec, err, coeffs, ct, dw_enc, db_enc, dw_dec,
                 db_dec_part, n_tokens, C, H, svt::one_level(H), stream);
}

// dx is [T, C] f32; x is the input before centring; coeffs = (c_rec, c_l1).
extern "C" int svt_sae_dx(int bf16, const void* x, const void* w_enc, const float* b_enc,
                          const void* w_dec, const float* b_dec, const void* err,
                          const float* coeffs, float* out, int n_tokens, int C, int H,
                          cudaStream_t stream) {
  return launch_dx(bf16, x, w_enc, b_enc, w_dec, b_dec, err, coeffs, out, n_tokens, C, H,
                   svt::one_level(H), stream);
}

// ---------------------------------------------------------------------------
// Matryoshka SAE (ops/fused_matryoshka_sae.py): ``bounds`` is a host array of
// the n_levels prefix latent counts. s is the [P, T, C] suffix-weighted error
// and coeffs = (1, c_l1).
// ---------------------------------------------------------------------------

// prefix_recon is [P, T, C] f32; x_cent, act_part, zsum_part and row_active as
// for svt_sae_fwd.
extern "C" int svt_matryoshka_fwd(int bf16, const void* x, const void* w_enc,
                                  const float* b_enc, const void* w_dec, const float* b_dec,
                                  void* x_cent, float* prefix_recon, float* act_part,
                                  float* row_active, float* zsum_part, int n_tokens, int C,
                                  int H, const int* bounds, int n_levels, cudaStream_t stream) {
  svt::Levels lv;
  if (!svt::make_levels(bounds, n_levels, H, kFwdLG, &lv)) return cudaErrorInvalidValue;
  return sae_fwd<true>(bf16, x, w_enc, b_enc, w_dec, b_dec, x_cent, prefix_recon, act_part,
                       row_active, zsum_part, n_tokens, C, H, lv, stream);
}

// db_dec_part as for svt_sae_bwd; the direct rows sum S_0.
extern "C" int svt_matryoshka_bwd(int bf16, const void* x_cent, const void* w_enc,
                                  const float* b_enc, const void* w_dec, const void* s,
                                  const float* coeffs, const float* ct, float* dw_enc,
                                  float* db_enc, float* dw_dec, float* db_dec_part,
                                  int n_tokens, int C, int H, const int* bounds, int n_levels,
                                  cudaStream_t stream) {
  svt::Levels lv;
  if (!svt::make_levels(bounds, n_levels, H, kFwdLG, &lv)) return cudaErrorInvalidValue;
  return sae_bwd(bf16, x_cent, w_enc, b_enc, w_dec, s, coeffs, ct, dw_enc, db_enc, dw_dec,
                 db_dec_part, n_tokens, C, H, lv, stream);
}

extern "C" int svt_matryoshka_dx(int bf16, const void* x, const void* w_enc,
                                 const float* b_enc, const void* w_dec, const float* b_dec,
                                 const void* s, const float* coeffs, float* out,
                                 int n_tokens, int C, int H, const int* bounds,
                                 int n_levels, cudaStream_t stream) {
  svt::Levels lv;
  if (!svt::make_levels(bounds, n_levels, H, kTH, &lv)) return cudaErrorInvalidValue;
  return launch_dx(bf16, x, w_enc, b_enc, w_dec, b_dec, s, coeffs, out, n_tokens, C, H, lv,
                   stream);
}
