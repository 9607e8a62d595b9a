// Fused JumpReLU-SAE training kernels for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels of sparse_vision_tpu/ops/fused_jumprelu_sae.py:
//   svt_jumprelu_fwd <- _fwd_kernel (:30), launched by pallas_call :192
//   svt_jumprelu_bwd <- _bwd_kernel (:80), launched by pallas_call :248
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
//             cotangent, and the STE window's dtheta.
//
// In f32 (the check path: TF32 would miss its tolerances) both run the SIMT
// bodies below (namespace simt, instantiated for float only), C in {64, 128,
// 256}: the forward holds a token tile's reconstruction in registers while it
// sweeps every latent tile; the backward holds a latent tile's weight gradients
// in registers while it sweeps every token, recomputing pre-activations per
// token step. Plain FMA loops from shared memory (the f32 SIMT rate).
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
// value. Supported shapes (ops/fused_jumprelu_sae.py fwd_takes, bwd_takes): in
// bf16 coder.cuh's rule; in f32 the SIMT bodies' C in {64, 128, 256}, T a
// multiple of kFwdTT and kBwdTT, H of kTH.

#include "coder.cuh"

namespace {
namespace simt {  // the SIMT bodies: the f32 forward and backward (the check path)

constexpr int kFwdTT = 64;  // forward: tokens per block
constexpr int kBwdTT = 32;  // backward: tokens per inner step
constexpr int kTH = 64;     // latents per tile (both kernels)

template <int C>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (kFwdTT * (C + 1)      // xc_s
                          + C * kTH             // wenc_s
                          + kTH * C             // wdec_s
                          + kFwdTT * (kTH + 1)  // post_s
                          + 2 * kTH             // benc_s, thr_s
                          + kThreads)           // red_s
         + sizeof(int) * (kTH + kFwdTT);        // colcnt_s, rowcnt_s
}

// Forward. One block owns kFwdTT tokens and sweeps all H latents in kTH tiles.
// Thread (ty, tx) holds recon rows ty*4 .. ty*4+3, columns tx + 16*j.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
jumprelu_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_enc,
                    const float* __restrict__ b_enc, const float* __restrict__ thr,
                    const T* __restrict__ w_dec, const float* __restrict__ b_dec,
                    float* __restrict__ recon, float* __restrict__ act_part,
                    float* __restrict__ row_active, float* __restrict__ l1_part, int H) {
  constexpr int TT = kFwdTT, TH = kTH;
  constexpr int XS = C + 1;  // padded row stride: rows 4 apart hit other banks
  constexpr int PS = TH + 1;
  constexpr int CJ = C / 16;  // recon columns per thread
  extern __shared__ float smem[];
  float* xc_s = smem;               // [TT][XS]  centred input tile
  float* wenc_s = xc_s + TT * XS;   // [C][TH]   W_enc[:, h0:h0+TH]
  float* wdec_s = wenc_s + C * TH;  // [TH][C]   W_dec[h0:h0+TH, :]
  float* post_s = wdec_s + TH * C;  // [TT][PS]  round_T(post) of this tile
  float* benc_s = post_s + TT * PS; // [TH]
  float* thr_s = benc_s + TH;       // [TH]
  float* red_s = thr_s + TH;        // [kThreads]
  int* colcnt_s = reinterpret_cast<int*>(red_s + kThreads);  // [TH]
  int* rowcnt_s = colcnt_s + TH;                             // [TT]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long t0 = static_cast<long>(blockIdx.x) * TT;

  for (int i = tid; i < TT * C; i += kThreads) {
    const int r = i / C, k = i % C;
    xc_s[r * XS + k] = round_cd<T>(to_f(x[(t0 + r) * C + k]) - round_cd<T>(b_dec[k]));
  }
  for (int i = tid; i < TT; i += kThreads) rowcnt_s[i] = 0;

  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  int rowcnt[4] = {0, 0, 0, 0};
  float l1 = 0.f;

  for (int h0 = 0; h0 < H; h0 += TH) {
    __syncthreads();  // the previous tile is done with wenc_s, wdec_s, post_s
    for (int i = tid; i < C * TH; i += kThreads) {
      const int k = i / TH, l = i % TH;
      wenc_s[i] = to_f(w_enc[static_cast<long>(k) * H + h0 + l]);
    }
    for (int i = tid; i < TH * C; i += kThreads)
      wdec_s[i] = to_f(w_dec[static_cast<long>(h0) * C + i]);
    for (int i = tid; i < TH; i += kThreads) {
      benc_s[i] = b_enc[h0 + i];
      thr_s[i] = thr[h0 + i];
      colcnt_s[i] = 0;
    }
    __syncthreads();

    // encode: pre[TT, TH] = xc @ W_enc tile, rows ty*4+i, columns tx+16*j
    float pre[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pre[i][j] = 0.f;
    for (int k = 0; k < C; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xc_s[(ty * 4 + i) * XS + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wenc_s[k * TH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pre[i][j] = fmaf(a[i], b[j], pre[i][j]);
    }
    int colc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = pre[i][j] + benc_s[col];
        const float post = p > thr_s[col] ? p : 0.f;
        l1 += post;
        const int on = post != 0.f;
        colc[j] += on;
        rowcnt[i] += on;
        post_s[(ty * 4 + i) * PS + col] = round_cd<T>(post);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (colc[j]) atomicAdd(&colcnt_s[tx + 16 * j], colc[j]);  // integer: exact
    __syncthreads();
    for (int i = tid; i < TH; i += kThreads)
      act_part[static_cast<long>(blockIdx.x) * H + h0 + i] =
          static_cast<float>(colcnt_s[i]);

    // decode: recon[TT, C] += round_T(post) @ W_dec tile
    for (int l = 0; l < TH; ++l) {
      float a[4], b[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = post_s[(ty * 4 + i) * PS + l];
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = wdec_s[l * C + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int col = tx + 16 * j;
      recon[(t0 + ty * 4 + i) * C + col] = acc[i][j] + b_dec[col];
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) atomicAdd(&rowcnt_s[ty * 4 + i], rowcnt[i]);
  red_s[tid] = l1;
  __syncthreads();
  for (int i = tid; i < TT; i += kThreads)
    row_active[t0 + i] = static_cast<float>(rowcnt_s[i]);
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads; ++w) s += red_s[w];  // fixed order
    l1_part[blockIdx.x] = s;
  }
}

template <int C>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (C * kTH              // wenc_s
                          + C * kTH            // wdecT_s
                          + kBwdTT * (C + 1)   // xc_s
                          + kBwdTT * (C + 1)   // dr_s
                          + kBwdTT * kTH       // post_s
                          + kBwdTT * kTH       // dpre_s
                          + 2 * 16 * kTH       // gbe_s, gth_s
                          + 3 * kTH);          // benc_s, thr_s, bcd_s
}

// Backward. One block owns kTH latents and sweeps all T tokens in kBwdTT steps,
// recomputing pre/post for each step; dW_enc[:, tile] and dW_dec[tile, :] stay
// in registers (64 + 64 floats a thread at C = 256). The per-latent sums db_enc
// and dtheta accumulate in shared-memory slots that only their thread touches
// (gbe_s / gth_s [16][TH]), then reduce over the 16 row groups in fixed order.
//   dW_enc += xc^T @ round_T(dpre)      dW_dec += round_T(post)^T @ round_T(drecon)
// db_dec leaves as one partial row per block: -round_T(db_enc tile) @ W_enc^T,
// and block 0 adds the direct term sum_t drecon once.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
jumprelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w_enc,
                    const float* __restrict__ b_enc, const float* __restrict__ thr,
                    const T* __restrict__ w_dec, const float* __restrict__ b_dec,
                    const float* __restrict__ err, const float* __restrict__ coeffs,
                    float eps, float half_eps, float neg_inv_eps,
                    float* __restrict__ dw_enc, float* __restrict__ db_enc,
                    float* __restrict__ dthr, float* __restrict__ dw_dec,
                    float* __restrict__ db_dec_part, int n_tokens, int H) {
  constexpr int TT = kBwdTT, TH = kTH;
  constexpr int XS = C + 1;
  constexpr int CI = C / 16;  // dW_enc rows (channels) per thread
  constexpr int CJ = C / 16;  // dW_dec columns (channels) per thread
  extern __shared__ float smem[];
  float* wenc_s = smem;              // [C][TH]
  float* wdecT_s = wenc_s + C * TH;  // [C][TH]  W_dec tile, transposed
  float* xc_s = wdecT_s + C * TH;    // [TT][XS]
  float* dr_s = xc_s + TT * XS;      // [TT][XS] round_T(drecon)
  float* post_s = dr_s + TT * XS;    // [TT][TH] round_T(post)
  float* dpre_s = post_s + TT * TH;  // [TT][TH] round_T(dpre)
  float* gbe_s = dpre_s + TT * TH;   // [16][TH] db_enc slots, one thread each
  float* gth_s = gbe_s + 16 * TH;    // [16][TH] dtheta slots, one thread each
  float* benc_s = gth_s + 16 * TH;   // [TH]
  float* thr_s = benc_s + TH;        // [TH]
  float* bcd_s = thr_s + TH;         // [TH] round_T(db_enc)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h0 = blockIdx.x * TH;
  const float c_rec = coeffs[0], c_l0 = coeffs[1];
  const float l0_term = __fmul_rn(c_l0, neg_inv_eps);  // c_l0 * (-1/eps)

  for (int i = tid; i < C * TH; i += kThreads) {
    const int k = i / TH, l = i % TH;
    wenc_s[i] = to_f(w_enc[static_cast<long>(k) * H + h0 + l]);
  }
  for (int i = tid; i < TH * C; i += kThreads) {
    const int l = i / C, k = i % C;
    wdecT_s[k * TH + l] = to_f(w_dec[static_cast<long>(h0) * C + i]);
  }
  for (int i = tid; i < TH; i += kThreads) {
    benc_s[i] = b_enc[h0 + i];
    thr_s[i] = thr[h0 + i];
  }
  for (int i = tid; i < 16 * TH; i += kThreads) gbe_s[i] = gth_s[i] = 0.f;

  float gwe[CI][4], gwd[4][CJ];
#pragma unroll
  for (int i = 0; i < CI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gwe[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) gwd[i][j] = 0.f;
  float direct = 0.f;  // block 0, thread k < C: sum_t drecon[t, k]

  for (int t0 = 0; t0 < n_tokens; t0 += TT) {
    __syncthreads();  // the previous step is done with xc_s, dr_s, post_s, dpre_s
    for (int i = tid; i < TT * C; i += kThreads) {
      const int r = i / C, k = i % C;
      const long g = static_cast<long>(t0 + r) * C + k;
      xc_s[r * XS + k] = round_cd<T>(to_f(x[g]) - round_cd<T>(b_dec[k]));
      dr_s[r * XS + k] = round_cd<T>(__fmul_rn(c_rec, err[g]));
    }
    if (blockIdx.x == 0 && tid < C)
      for (int r = 0; r < TT; ++r)
        direct = __fadd_rn(direct, __fmul_rn(c_rec, err[static_cast<long>(t0 + r) * C + tid]));
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
        b1[j] = wenc_s[k * TH + tx + 16 * j];
        b2[j] = wdecT_s[k * TH + tx + 16 * j];
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
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const float th = thr_s[col];
      const float th_term = __fdiv_rn(-th, eps);  // -theta / eps
      float sb = 0.f, st = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = ty * 2 + i;
        const float p = pre[i][j] + benc_s[col];
        const bool mask = p > th;
        const float dp = mask ? dpo[i][j] : 0.f;
        sb += dp;
        if (fabsf(p - th) <= half_eps)
          st += __fadd_rn(__fmul_rn(dpo[i][j], th_term), l0_term);
        post_s[row * TH + col] = round_cd<T>(mask ? p : 0.f);
        dpre_s[row * TH + col] = round_cd<T>(dp);
      }
      gbe_s[ty * TH + col] += sb;  // this thread's own slot
      gth_s[ty * TH + col] += st;
    }
    __syncthreads();

    // dW_enc[k, l] += sum_r xc[r, k] * dpre[r, l]: rows k = ty*CI+i, cols tx+16*j
    for (int r = 0; r < TT; ++r) {
      float a[CI], b[4];
#pragma unroll
      for (int i = 0; i < CI; ++i) a[i] = xc_s[r * XS + ty * CI + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = dpre_s[r * TH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < CI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gwe[i][j] = fmaf(a[i], b[j], gwe[i][j]);
    }
    // dW_dec[l, k] += sum_r post[r, l] * drecon[r, k]: rows l = ty*4+i, cols tx+16*j
    for (int r = 0; r < TT; ++r) {
      float a[4], b[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = post_s[r * TH + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = dr_s[r * XS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) gwd[i][j] = fmaf(a[i], b[j], gwd[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < CI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dw_enc[static_cast<long>(ty * CI + i) * H + h0 + tx + 16 * j] = gwe[i][j];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      dw_dec[static_cast<long>(h0 + ty * 4 + i) * C + tx + 16 * j] = gwd[i][j];
  __syncthreads();
  for (int l = tid; l < TH; l += kThreads) {
    float sb = 0.f, st = 0.f;
    for (int g = 0; g < 16; ++g) {  // fixed order
      sb += gbe_s[g * TH + l];
      st += gth_s[g * TH + l];
    }
    db_enc[h0 + l] = sb;
    dthr[h0 + l] = st;
    bcd_s[l] = round_cd<T>(sb);
  }
  __syncthreads();
  for (int k = tid; k < C; k += kThreads) {
    float s = 0.f;
    for (int l = 0; l < TH; ++l) s = fmaf(bcd_s[l], wenc_s[k * TH + l], s);
    float v = -s;
    if (blockIdx.x == 0) v += direct;  // C <= kThreads: thread k summed column k
    db_dec_part[static_cast<long>(blockIdx.x) * C + k] = v;
  }
}

}  // namespace simt
}  // namespace

// thr is exp(log_threshold) [H] in f32; act_part is [n_tokens / 64, H]
// (per-64-token activity counts). bf16 != 0: __nv_bfloat16 operands, x_cent an
// [n_tokens, C] bf16 workspace (center_kernel's output) and l1_part the zsum
// partials [n_tokens / 64, H] (T and H multiples of 128, C of 8). float:
// jumprelu_fwd_kernel, x_cent unused, l1_part [n_tokens / 64]. The L1 sum is
// the total of l1_part either way.
extern "C" int svt_jumprelu_fwd(int bf16, const void* x, const void* w_enc,
                                const float* b_enc, const float* thr, const void* w_dec,
                                const float* b_dec, float* recon, float* act_part,
                                float* row_active, float* l1_part, void* x_cent, int n_tokens,
                                int C, int H, cudaStream_t stream) {
  if (bf16) {
    if (bad_shape(n_tokens, C, C, H) || bad_tc_operands(C, C, x, x_cent, w_enc, w_dec))
      return cudaErrorInvalidValue;
    const cudaError_t e = launch_center(1, x, b_dec, x_cent, n_tokens, C, stream);
    if (e != cudaSuccess) return e;
    ActFwd af{};
    af.theta = thr;
    return fwd_tc<false, Act::Jump>(x_cent, w_enc, b_enc, w_dec, b_dec, recon, act_part,
                                    row_active, l1_part, n_tokens, C, C, H, svt::one_level(H),
                                    af, stream);
  }
  if (n_tokens <= 0 || H <= 0 || n_tokens % simt::kFwdTT || H % simt::kTH)
    return cudaErrorInvalidValue;
  return svt::dispatch_width(C, [&](auto c) {
    constexpr int CC = decltype(c)::value;
    return svt::launch(simt::jumprelu_fwd_kernel<float, CC>, n_tokens / simt::kFwdTT,
                       simt::fwd_smem_bytes<CC>(), stream, static_cast<const float*>(x),
                       static_cast<const float*>(w_enc), b_enc, thr,
                       static_cast<const float*>(w_dec), b_dec, recon, act_part, row_active,
                       l1_part, H);
  });
}

// err is the f32 residual recon - x [n_tokens, C]; coeffs is a 2-float device
// array (c_rec, c_l0); eps, eps/2 and -1/eps come from the host in f32.
// bf16: x_cent and err_s are [n_tokens, C] bf16 workspaces (center_kernel's
// and scale_err_kernel's outputs) and db_dec_part is [ceil(n_tokens / 512) +
// H / 64, C], the pre-pass's direct rows, then coder_bwd_tc<true, Act::Jump>'s
// centring rows (T and H multiples of 128, C of 8). float: jumprelu_bwd_kernel,
// the workspaces unused, db_dec_part [H / 64, C].
extern "C" int svt_jumprelu_bwd(int bf16, const void* x, const void* w_enc,
                                const float* b_enc, const float* thr, const void* w_dec,
                                const float* b_dec, const float* err, const float* coeffs,
                                float eps, float half_eps, float neg_inv_eps,
                                float* dw_enc, float* db_enc, float* dthr, float* dw_dec,
                                float* db_dec_part, void* x_cent, void* err_s, int n_tokens,
                                int C, int H, cudaStream_t stream) {
  if (bf16) {
    if (bad_shape(n_tokens, C, C, H) || bad_tc_operands(C, C, x, x_cent, w_enc, w_dec))
      return cudaErrorInvalidValue;
    const long direct = (n_tokens + kTcBwdTS - 1) / kTcBwdTS;
    cudaError_t e;
    if ((e = launch_center(1, x, b_dec, x_cent, n_tokens, C, stream)) != cudaSuccess ||
        (e = launch_scale_err(err, coeffs, err_s, db_dec_part, n_tokens, C, stream)) !=
            cudaSuccess)
      return e;
    SaeBwd sae{svt::one_level(H), w_enc, db_dec_part + direct * C};
    sae.act.theta = thr;
    sae.act.dtheta = dthr;
    sae.act.eps = eps;
    sae.act.half_eps = half_eps;
    sae.act.neg_inv_eps = neg_inv_eps;
    return bwd_tc<true, Act::Jump>(x_cent, w_enc, b_enc, w_dec, err_s, n_tokens, coeffs,
                                   nullptr, dw_enc, db_enc, dw_dec, nullptr, n_tokens, C, C, H,
                                   sae, stream);
  }
  if (n_tokens <= 0 || H <= 0 || n_tokens % simt::kBwdTT || H % simt::kTH)
    return cudaErrorInvalidValue;
  return svt::dispatch_width(C, [&](auto c) {
    constexpr int CC = decltype(c)::value;
    return svt::launch(simt::jumprelu_bwd_kernel<float, CC>, H / simt::kTH,
                       simt::bwd_smem_bytes<CC>(), stream, static_cast<const float*>(x),
                       static_cast<const float*>(w_enc), b_enc, thr,
                       static_cast<const float*>(w_dec), b_dec, err, coeffs, eps, half_eps,
                       neg_inv_eps, dw_enc, db_enc, dthr, dw_dec, db_dec_part, n_tokens, H);
  });
}
